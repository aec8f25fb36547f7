"""Transformer layers of the port.

Mirrors the JAX package's `nn/layer/transformer.py` (MultiHeadAttention,
TransformerEncoder/Decoder, Transformer): same module tree and parameter
names, head-batched (B, H, S, D) attention through `ops.attention`,
which reaches the flash-forward kernel for prefill, the encoder and
every cross-attention, the split-K flash-decode kernel for decode steps,
the flash-verify kernel for speculative verify blocks (inside
`ops.attention.kv_verify_scope`), the paged decode and verify kernels
for a `PagedKVCache`, and in training the flash forward with in-kernel
attention dropout and the two flash-backward kernels.

Where JAX was pure, the port updates in place: a `StaticKVCache` step
writes the new K/V into the preallocated buffers it was given (the
returned cache holds the same buffers with the advanced index), instead
of returning updated copies.
"""
from __future__ import annotations

import collections
import copy

import torch
from torch import nn

from ...core.device import resolve_device
from ...ops import attention as A
from ...serving import paging as PG
from .. import functional as F
from .common import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise ValueError(f"activation {name!r} is not ported yet "
                         f"({sorted(_ACTIVATIONS)} are)")
    return _ACTIVATIONS[name]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    # decode cache: preallocated [B, H, max_len, D] K/V buffers written in
    # place, plus per-row int32 write indices [B]
    StaticKVCache = collections.namedtuple("StaticKVCache",
                                           ["k", "v", "index"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device=None,
                 generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        #: CPU torch.Generator of the per-call attention-dropout seeds
        #: (None: torch's default CPU generator); SpmdTrainer binds its own
        self.seed_generator = None
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, s, d = x.shape
        return x.transpose(1, 2).reshape(b, s, h * d)

    def _attend(self, q, k, v, attn_mask, is_causal, segment_ids=None):
        """Attention with in-kernel dropout in training: each call draws
        its own seed."""
        seed = None
        if self.training and self.dropout:
            seed = F.draw_seed(self.seed_generator)
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask, self.dropout, is_causal, self.training,
            dropout_seed=seed, segment_ids=segment_ids)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, is_causal=False, segment_ids=None):
        """Without a cache: attention over `key`/`value` (default: self);
        segment_ids ([B, S] integer, packed rows) restrict it to
        same-segment tokens. StaticCache: the precomputed cross-attention
        K/V (returns the output only). Cache: the concat-grown eager
        cache (returns (out, cache)). StaticKVCache: the in-place decode
        cache (returns (out, cache))."""
        if segment_ids is not None and cache is not None:
            raise ValueError("segment_ids apply to the no-cache path only "
                             "(packed training and encoding)")
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            out = self._attend(q, cache.k, cache.v, attn_mask, is_causal)
            return self.out_proj(self._merge_heads(out))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if isinstance(cache, PG.PagedKVCache):
            out, cache = self._paged_kv_attention(q, k, v, attn_mask, cache)
            return self.out_proj(self._merge_heads(out)), cache
        if isinstance(cache, self.StaticKVCache):
            out, cache = self._static_kv_attention(q, k, v, attn_mask,
                                                   cache)
            return self.out_proj(self._merge_heads(out)), cache
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=2)
            v = torch.cat([cache.v, v], dim=2)
            cache = self.Cache(k, v)
        out = self._attend(q, k, v, attn_mask, is_causal, segment_ids)
        out = self.out_proj(self._merge_heads(out))
        return out if cache is None else (out, cache)

    def _static_kv_attention(self, q, k, v, attn_mask, cache):
        """Preallocated-cache attention (inference only). S == 1 is a
        decode step: each row's new K/V lands at its own write index in
        place and the query attends over the written positions through
        the split-K flash decode. S > 1 is the prefill of an EMPTY
        cache: the block lands at positions [0, S) in place and attends
        causally within itself through the flash forward. Inside
        `ops.attention.kv_verify_scope` an S > 1 block is instead a
        speculative VERIFY block: the S tokens land at each row's own
        write offset and attend causally within the block through the
        flash verify (rolling the index back is the caller's acceptance
        logic). `attn_mask`: optional [B, max_len] (or [B, 1, 1,
        max_len]) key bias for the pad hole."""
        kbuf, vbuf, idx = cache.k, cache.v, cache.index
        b, h, s, d = q.shape
        verify = s > 1 and A.in_kv_verify_scope()
        if s == 1 or verify:
            # per-ROW write positions (a block that would run past the
            # buffer starts at L - s, as the JAX dynamic_update_slice
            # clamps)
            rows = torch.arange(b, device=kbuf.device)[:, None]
            start = torch.clamp(idx.long(), max=kbuf.shape[2] - s)
            pos = start[:, None] + torch.arange(s, device=kbuf.device)[None]
            kbuf[rows, :, pos] = k.transpose(1, 2).to(kbuf.dtype)
            vbuf[rows, :, pos] = v.transpose(1, 2).to(vbuf.dtype)
        else:
            kbuf[:, :, :s] = k.to(kbuf.dtype)
            vbuf[:, :, :s] = v.to(vbuf.dtype)
        new_cache = self.StaticKVCache(kbuf, vbuf, idx + s)
        mask = attn_mask
        if mask is not None and mask.dim() > 2:
            mask = mask.reshape(mask.shape[0], mask.shape[-1])
        if s == 1:
            out = A.decode_attention(q, kbuf, vbuf, idx + 1, bias=mask)
        elif verify:
            out = A.verify_attention(q, kbuf, vbuf, idx + s, bias=mask)
        else:
            bias4 = None if mask is None else mask.float()[:, None, None, :]
            out = A.sdpa(q, k, v, bias4, is_causal=True)
        return out, new_cache

    def _paged_kv_attention(self, q, k, v, attn_mask, cache):
        """Attention through a paged pool (serving only): the S == 1
        decode token, or inside `kv_verify_scope` an S-token verify block,
        is written (quantized when the pages are int8, rescaling a page
        its token outranges) into the physical pages the slot's table
        maps for its write positions, in place; then the queries attend
        over the pages through the paged decode or verify dispatch. A
        multi-token call outside the verify scope raises: prompt prefill
        runs into a dense batch-1 cache that the serving join scatters
        into pages (`paged_prompt_splice`)."""
        b, h, s, d = q.shape
        verify = s > 1 and A.in_kv_verify_scope()
        if s != 1 and not verify:
            raise ValueError(
                "PagedKVCache attention is decode-only (one query token per "
                "slot); prefill goes through the join path, and a "
                "multi-token speculative verify block rides "
                "ops.attention.kv_verify_scope")
        idx, table = cache.index, cache.table
        PG.write_tokens(cache.k, cache.k_scale, table, idx, k)
        PG.write_tokens(cache.v, cache.v_scale, table, idx, v)
        new_cache = cache._replace(index=idx + s)
        mask = attn_mask
        if mask is not None and mask.dim() > 2:
            mask = mask.reshape(mask.shape[0], mask.shape[-1])
        read = A.paged_verify_attention if verify else \
            A.paged_decode_attention
        out = read(q, cache.k, cache.v, cache.k_scale, cache.v_scale, table,
                   idx + s, bias=mask)
        return out, new_cache

    def gen_paged_cache(self, num_pages, page_size, num_slots, max_pages,
                        dtype, kv_dtype=None):
        """Per-layer paged pool: zeroed [num_pages + 1, H, page_size, D]
        K and V page tensors (the +1 row is the trash page inactive
        slots' masked writes land on), per-(page, head) scales when
        kv_dtype is int8, an unmapped (trash-clipped) table and zero
        write indices. K and V are separate tensors, since steps write
        them in place. The serving engine owns the host-side
        PageAllocator and page table; this only shapes the device
        state."""
        dev = self.q_proj.device
        storage, quantized = PG.resolve_kv_dtype(kv_dtype, dtype)
        shape = (int(num_pages) + 1, self.num_heads, int(page_size),
                 self.head_dim)

        def scales():
            return torch.zeros((int(num_pages) + 1, self.num_heads, 1, 1),
                               dtype=torch.float32, device=dev)

        return PG.PagedKVCache(
            torch.zeros(shape, dtype=storage, device=dev),
            torch.zeros(shape, dtype=storage, device=dev),
            scales() if quantized else None, scales() if quantized else None,
            torch.full((int(num_slots), int(max_pages)), int(num_pages),
                       dtype=torch.int32, device=dev),
            torch.zeros((int(num_slots),), dtype=torch.int32, device=dev))

    @staticmethod
    def paged_prompt_splice(cache, page_ids, k_new, v_new):
        """Slot JOIN for paged pools: scatter a prefilled [1, H, P, D] K/V
        block into the physical pages `page_ids` ([ceil(P / page_size)]),
        quantizing per page when the pages are int8, in place. Returns
        the cache."""
        quantized = cache.k_scale is not None
        PG.write_prompt_pages(cache.k, cache.k_scale, page_ids, k_new,
                              quantized)
        PG.write_prompt_pages(cache.v, cache.v_scale, page_ids, v_new,
                              quantized)
        return cache

    def gen_cache(self, key, value=None, type=None, max_length=None,
                  batch_size=None, dtype=None):
        """type=StaticCache: the cross-attention K/V of `key`.
        max_length=N: a zeroed StaticKVCache [B, H, N, D] (separate K and
        V buffers, since steps write them in place) with zero indices.
        Otherwise an empty concat-grown Cache."""
        dev = self.q_proj.device
        if max_length is not None:
            b = batch_size if batch_size is not None else key.shape[0]
            dtype = dtype or self.q_proj.param_dtype
            shape = (int(b), self.num_heads, int(max_length), self.head_dim)
            return self.StaticKVCache(
                torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros((int(b),), dtype=torch.int32, device=dev))
        if type == MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return self.StaticCache(self._split_heads(self.k_proj(key)),
                                    self._split_heads(self.v_proj(value)))
        empty = torch.zeros((key.shape[0], self.num_heads, 0, self.head_dim),
                            dtype=key.dtype, device=dev)
        return self.Cache(empty, empty)


class TransformerEncoderLayer(nn.Module):
    """Encoder layer (the JAX `TransformerEncoderLayer`): post-norm by
    default, pre-norm with `normalize_before`. `attn_dropout` (default
    `dropout`) drops attention probabilities in-kernel; `act_dropout`
    (default `dropout`) follows the activation."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout if attn_dropout is None else attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(dropout if act_dropout is None
                                   else act_dropout)
        self.activation = _activation(activation)

    def forward(self, src, src_mask=None, segment_ids=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(
            src, src, src, src_mask, segment_ids=segment_ids))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None, segment_ids=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask, segment_ids=segment_ids)
        return out


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer (the reference's normalize_before=False)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(dropout)
        self.activation = _activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, tgt_is_causal=False):
        """cache: (self-attention cache, cross-attention StaticCache) or
        None. `tgt_is_causal` adds causal masking to the self-attention,
        on top of `tgt_mask` (which may then be a per-key bias)."""
        if cache is None:
            attn = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                  is_causal=tgt_is_causal)
            incremental = static = None
        else:
            attn, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                               cache[0],
                                               is_causal=tgt_is_causal)
            static = cache[1]
        tgt = self.norm1(tgt + self.dropout1(attn))
        attn = self.cross_attn(tgt, memory, memory, memory_mask, static)
        tgt = self.norm2(tgt + self.dropout2(attn))
        ffn = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = self.norm3(tgt + self.dropout3(ffn))
        if cache is None:
            return tgt
        return tgt, (incremental, static)

    def gen_cache(self, memory, max_length=None, batch_size=None,
                  dtype=None):
        if max_length is not None:
            incremental = self.self_attn.gen_cache(
                memory, max_length=max_length, batch_size=batch_size,
                dtype=dtype)
        else:
            incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None, tgt_is_causal=False):
        out = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask, memory_mask,
                            tgt_is_causal=tgt_is_causal)
            else:
                out, c = layer(out, memory, tgt_mask, memory_mask, cache[i],
                               tgt_is_causal=tgt_is_causal)
                new_caches.append(c)
        return out if cache is None else (out, new_caches)

    def gen_cache(self, memory, max_length=None, batch_size=None,
                  dtype=None):
        return [layer.gen_cache(memory, max_length=max_length,
                                batch_size=batch_size, dtype=dtype)
                for layer in self.layers]

    def generate(self, memory, embed, project, *, device=None, **kwargs):
        """Static-cache generation with this decoder stack between the
        token embedding `embed` and the logits projection `project`, on
        `device` (None: the CUDA card): greedy, beam or speculative, as
        `paddle_tpu_torch.text.generation.DecodeEngine.generate`, which
        documents the keywords (prompt, lengths, max_new_tokens,
        beam_size, spec_k, ...). The engine is kept on the layer for the
        next call with the same embed, project and device."""
        from ...text.generation import DecodeEngine

        dev = resolve_device(device)
        eng = getattr(self, "_decode_engine", None)
        if eng is None or eng.embed_ref is not embed or \
                eng.project_ref is not project or eng.device != dev:
            eng = DecodeEngine(self, embed, project, device=dev)
            self._decode_engine = eng
        return eng.generate(memory, **kwargs)


class Transformer(nn.Module):
    """Encoder-decoder with the reference defaults: Transformer-base
    (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, ReLU, post-norm)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.d_model = d_model
        self.nhead = nhead
        self.encoder = TransformerEncoder(TransformerEncoderLayer(
            d_model, nhead, dim_feedforward, dropout, activation, **kw),
            num_encoder_layers)
        self.decoder = TransformerDecoder(TransformerDecoderLayer(
            d_model, nhead, dim_feedforward, dropout, activation, **kw),
            num_decoder_layers)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None, tgt_is_causal=False):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask,
                            tgt_is_causal=tgt_is_causal)
