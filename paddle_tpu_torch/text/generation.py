"""The decoder step net shared by the serving engine's join and step, the
static-cache `DecodeEngine` (greedy, beam and speculative generation of
whole batches) and the eager greedy oracle.

Position and masking conventions are the JAX package's
(`text/generation.py`): a prompt pads with eos to its power-of-two
bucket Pb, the pad hole [len, Pb) keeps a -1e30 key bias for the whole
generation, and generated tokens occupy absolute cache positions Pb,
Pb + 1, ... That is what makes every serving slot comparable token for
token with a solo `generate_eager` run.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch
from torch import nn

from ..core.bucketing import bucket_size
from ..core.device import resolve_device
from ..nn.layer.transformer import MultiHeadAttention

__all__ = ["NEG", "DecodeEngine", "generate_eager", "pad_bias_row"]

NEG = -1e30


def _takes_positions(fn):
    """Does the embed callable accept (tokens, positions)?"""
    try:
        target = fn.forward if isinstance(fn, nn.Module) else fn
        params = [p for p in inspect.signature(target).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        return len(params) >= 2
    except (TypeError, ValueError):
        return False


def pad_bias_row(lengths, Pb, L, device):
    """[B, L] float32 key bias: -1e30 over each row's pad hole
    [lengths[b], Pb), 0 elsewhere."""
    lengths = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    kpos = torch.arange(L, device=device)[None, :]
    hole = (kpos >= lengths) & (kpos < Pb)
    return torch.where(hole, NEG, 0.0).float()


class _StepNet(nn.Module):
    """decoder + embed + project as one unit: the prefill of a prompt
    (which also computes the cross-attention K/V of the memory) and the
    decode step over the caches."""

    def __init__(self, decoder, embed, project):
        super().__init__()
        self.decoder = decoder
        self.embed = embed
        self.project = project
        self._embed_pos = _takes_positions(embed)

    def _embed(self, tokens, positions):
        if self._embed_pos:
            return self.embed(tokens, positions)
        return self.embed(tokens)

    def cross_kv(self, memory):
        """Per-layer cross-attention (K, V) of `memory` [B, M, D]: the
        only model compute of a prefix-hit attach."""
        return [tuple(layer.cross_attn.gen_cache(
            memory, type=MultiHeadAttention.StaticCache))
            for layer in self.decoder.layers]

    def forward(self, tokens, positions, memory, tgt_mask=None,
                memory_mask=None, inc=None, static_kv=None, prefill=False):
        """One pass over `tokens` with the self-attention caches `inc`
        (StaticKVCache or PagedKVCache per layer) and the cross-attention
        K/V `static_kv`. prefill=True computes the cross K/V from
        `memory` first and returns them too."""
        if prefill:
            static_kv = self.cross_kv(memory)
        x = self._embed(tokens, positions)
        cache = [(inc[i], MultiHeadAttention.StaticCache(sk, sv))
                 for i, (sk, sv) in enumerate(static_kv)]
        out, new_caches = self.decoder(x, memory, tgt_mask, memory_mask,
                                       cache)
        logits = self.project(out)
        new_inc = [c[0] for c in new_caches]
        if prefill:
            return logits, new_inc, static_kv
        return logits, new_inc

    def prefill(self, prompt, length, memory, inc, L):
        """Prefill one bucketed prompt row [1, Pb] of true length
        `length` (an int) into the empty batch-1 caches `inc`. Returns
        (logits [1, Pb, V], new caches, cross K/V, key-bias row [1, L])."""
        Pb = prompt.shape[1]
        bias_row = pad_bias_row([length], Pb, L, prompt.device)
        positions = torch.arange(Pb, device=prompt.device)[None]
        logits, inc, static_kv = self(
            prompt, positions, memory, tgt_mask=bias_row[:, :Pb],
            inc=inc, prefill=True)
        return logits, inc, static_kv, bias_row


def _pad_rows(x, n):
    """Pad the leading dim to n by repeating the last row (the padded
    rows are sliced off the results)."""
    b = x.shape[0]
    if b == n:
        return x
    return torch.cat([x, x[-1:].expand((n - b,) + tuple(x.shape[1:]))], 0)


class DecodeEngine:
    """Whole-batch generation over preallocated StaticKVCaches, one engine
    per (decoder, embed, project) triple on `device` (None: the CUDA card;
    the model must already live there). `generate()` pads the prompt with
    eos to its power-of-two bucket Pb and the batch to a power of two,
    prefills the prompt once through the flash forward (`ops.attention.
    sdpa`), then decodes: greedy and beam steps through the flash decode
    (`decode_attention`), speculative rounds through the flash verify
    (`verify_attention`). The cache holds Pb + max_new_tokens (+ spec_k)
    positions; each row's pad hole [length, Pb) keeps a -1e30 key bias for
    the whole generation and generated tokens sit at Pb, Pb + 1, ..., the
    layout `generate_eager` and the serving engines use.

    The JAX engine's compile counter (`trace_counts`) and `cost_hint`
    belong to its profiler, which the port has not yet."""

    def __init__(self, decoder, embed, project, *, device=None):
        self.embed_ref = embed
        self.project_ref = project
        self.device = resolve_device(device)
        self._net = _StepNet(decoder, embed, project)
        for name, p in [*self._net.named_parameters(),
                        *self._net.named_buffers()]:
            if p.device != self.device:
                raise ValueError(f"parameter {name} lives on {p.device}, "
                                 f"the engine runs on {self.device}")

    def _as_tensor(self, x, dtype=None):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return x.to(self.device, dtype) if dtype is not None else \
            x.to(self.device)

    @staticmethod
    def _caches(net, L, B, dtype):
        return [layer.self_attn.gen_cache(None, max_length=L, batch_size=B,
                                          dtype=dtype)
                for layer in net.decoder.layers]

    @torch.inference_mode()
    def generate(self, memory, prompt=None, prompt_lengths=None, *,
                 bos_id=0, eos_id=1, max_new_tokens=32, beam_size=1,
                 length_penalty=0.0, memory_mask=None, bucket_batch=True,
                 spec_k=None, spec_ngram=2, draft_model=None,
                 return_spec_stats=False):
        """Generate max_new_tokens per row. memory [B, M, D]; prompt [B, P]
        (a bos column by default), right-padded, with true lengths
        `prompt_lengths`. Greedy (beam_size 1) returns (tokens [B,
        max_new_tokens], lengths [B]); beam returns (tokens [B, K,
        max_new_tokens] best-first, scores [B, K], lengths [B, K]); numpy
        arrays.

        spec_k >= 2 makes greedy generation speculative: each round drafts
        spec_k - 1 tokens (the row's own suffix n-grams, `spec_ngram`, or a
        `DraftModel` with its own caches) and one spec_k-token verify
        accepts the matching prefix. The tokens equal spec_k=None's;
        `return_spec_stats=True` appends a {rounds, proposed, accepted}
        dict."""
        from .decode import beam_search, greedy_search

        if spec_k is not None:
            spec_k = int(spec_k)
            if spec_k < 2:
                raise ValueError("spec_k must be >= 2 (the pending token "
                                 "plus at least one draft)")
            if beam_size != 1:
                raise ValueError("speculative decoding is greedy-only "
                                 "(beam_size must be 1)")
        dev = self.device
        memory = self._as_tensor(memory)
        B0 = memory.shape[0]
        if prompt is None:
            prompt = torch.full((B0, 1), bos_id, dtype=torch.long)
        prompt = self._as_tensor(prompt, torch.long)
        P0 = prompt.shape[1]
        lengths = (torch.full((B0,), P0, dtype=torch.long, device=dev)
                   if prompt_lengths is None else
                   self._as_tensor(prompt_lengths, torch.long))
        Pb = bucket_size(P0)
        Bb = bucket_size(B0) if bucket_batch else B0
        prompt_b = _pad_rows(torch.cat(
            [prompt, torch.full((B0, Pb - P0), eos_id, dtype=torch.long,
                                device=dev)], 1), Bb)
        lengths_b = _pad_rows(lengths, Bb)
        memory_b = _pad_rows(memory, Bb)
        mm_b = None if memory_mask is None else \
            _pad_rows(self._as_tensor(memory_mask), Bb)
        net = self._net
        nets = [net] + ([draft_model._net] if draft_model is not None
                        and spec_k else [])
        was = [n.training for n in nets]
        for n in nets:
            n.eval()
        try:
            L = Pb + int(max_new_tokens) + (spec_k or 0)
            pad_bias = pad_bias_row(lengths_b, Pb, L, dev)
            # a one-token prompt prefills through the decode branch, which
            # reads the key bias of the whole cache row
            pre_bias = pad_bias if Pb == 1 else pad_bias[:, :Pb]
            positions = torch.arange(Pb, device=dev)[None].expand(Bb, Pb)
            logits, inc1, static_kv = net(
                prompt_b, positions, memory_b, tgt_mask=pre_bias,
                memory_mask=mm_b, inc=self._caches(net, L, Bb,
                                                   memory.dtype),
                prefill=True)
            # the next token conditions on each row's LAST REAL position
            last = logits[torch.arange(Bb, device=dev), lengths_b - 1]
            if spec_k:
                out = self._speculate(
                    draft_model, prompt_b, lengths_b, positions, memory_b,
                    mm_b, pad_bias, pre_bias, inc1, static_kv, last, L, Pb,
                    Bb, eos_id, int(max_new_tokens), spec_k, spec_ngram)
                toks, lens, stats = out
                toks, lens = toks[:B0].cpu().numpy(), lens[:B0].cpu().numpy()
                if return_spec_stats:
                    return toks, lens, stats
                return toks, lens
            K = int(beam_size)

            def tile(t):
                return t if K == 1 or t is None else \
                    t.repeat_interleave(K, dim=0)

            bias_t, mm_t = tile(pad_bias), tile(mm_b)
            static_t = [(tile(sk), tile(sv)) for sk, sv in static_kv]

            def step_fn(tok, inc):
                posn = inc[0].index[:, None].long()
                lg, inc2 = net(tok[:, None], posn, None, tgt_mask=bias_t,
                               memory_mask=mm_t, inc=inc,
                               static_kv=static_t)
                return lg[:, 0], inc2

            if K == 1:
                toks, lens = greedy_search(step_fn, inc1, Bb, bos_id, eos_id,
                                           int(max_new_tokens),
                                           init_logits=last)
                return toks[:B0].cpu().numpy(), lens[:B0].cpu().numpy()
            toks, scores, lens = beam_search(
                step_fn, inc1, Bb, bos_id, eos_id, K, int(max_new_tokens),
                length_penalty=length_penalty, init_logits=last)
            return (toks[:B0].cpu().numpy(), scores[:B0].cpu().numpy(),
                    lens[:B0].cpu().numpy())
        finally:
            for n, w in zip(nets, was):
                n.train(w)

    def _speculate(self, draft, prompt_b, lengths_b, positions, memory_b,
                   mm_b, pad_bias, pre_bias, inc1, static_kv, last, L, Pb,
                   Bb, eos_id, max_new, spec_k, ngram):
        """The draft-verify rounds of `generate(spec_k=...)`: the target's
        verify block through `kv_verify_scope`, the n-gram or the draft
        model's proposals, both caches' write indices rolled back to the
        accepted length."""
        from ..ops import attention as A
        from . import speculative as SP
        from .decode import spec_greedy_search

        dev = self.device
        net = self._net
        iota_k = torch.arange(spec_k, device=dev)[None]
        hist = torch.zeros((Bb, L), dtype=torch.int32, device=dev)
        hist[:, :Pb] = prompt_b.to(torch.int32)
        state0 = {"inc": inc1, "hist": hist}
        if draft is not None:
            dnet = draft._net
            _, dinc1, dstatic = dnet(
                prompt_b, positions, memory_b, tgt_mask=pre_bias,
                memory_mask=mm_b, inc=self._caches(dnet, L, Bb,
                                                   memory_b.dtype),
                prefill=True)
            state0["dinc"] = dinc1

        def verify_fn(fed, st):
            idx = st["inc"][0].index
            with A.kv_verify_scope():
                lg, inc2 = net(fed, idx[:, None].long() + iota_k, None,
                               tgt_mask=pad_bias, memory_mask=mm_b,
                               inc=st["inc"], static_kv=static_kv)
            SP.write_hist(st["hist"], fed, idx)
            return lg, dict(st, inc=inc2)

        def draft_step(t, dinc):
            return dnet(t[:, None], dinc[0].index[:, None].long(), None,
                        tgt_mask=pad_bias, memory_mask=mm_b, inc=dinc,
                        static_kv=dstatic)

        if draft is not None:
            def draft_fn(pending, cnt, st):
                dinc, t, out = st["dinc"], pending, []
                # k - 1 proposals, then one write-only step so the draft
                # cache covers the verify's k positions
                for _ in range(spec_k - 1):
                    lgd, dinc = draft_step(t, dinc)
                    t = lgd[:, 0].argmax(-1)
                    out.append(t)
                _, dinc = draft_step(t, dinc)
                return torch.stack(out, 1), dict(st, dinc=dinc)
        else:
            def draft_fn(pending, cnt, st):
                return SP.ngram_propose(st["hist"], pending, lengths_b, Pb,
                                        spec_k - 1, cnt - 1, ngram), st

        def rollback_fn(st, n_match, active):
            def back(caches):
                return [c._replace(index=SP.rollback_index(
                    c.index, spec_k, n_match, active)) for c in caches]

            out = dict(st, inc=back(st["inc"]))
            if draft is not None:
                out["dinc"] = back(st["dinc"])
            return out

        return spec_greedy_search(verify_fn, draft_fn, rollback_fn, state0,
                                  Bb, eos_id, max_new, spec_k, last,
                                  return_stats=True)


@torch.inference_mode()
def generate_eager(decoder, embed, project, memory, prompt=None,
                   prompt_lengths=None, *, bos_id=0, eos_id=1,
                   max_new_tokens=32, pad_prompt_to=None,
                   return_logits=False):
    """Greedy token-by-token generation on the concat-grown Cache path:
    the solo oracle the serving engine is held to. Runs where the
    decoder's parameters live. memory [B, M, D]; prompt [B, P] (a bos
    column by default), right-padded, with true lengths
    `prompt_lengths`. Returns (tokens [B, max_new_tokens], lengths [B])
    as numpy arrays, plus the per-step logits [B, max_new_tokens, V]
    (float32, CPU) when `return_logits`."""
    dev = next(decoder.parameters()).device
    takes_pos = _takes_positions(embed)

    def run_embed(tokens, positions):
        if takes_pos:
            return embed(tokens, positions)
        return embed(tokens)

    was_training = decoder.training
    decoder.eval()
    try:
        memory = torch.as_tensor(memory, device=dev)
        B = memory.shape[0]
        if prompt is None:
            prompt = torch.full((B, 1), bos_id, dtype=torch.long)
        prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
        P0 = prompt.shape[1]
        Pb = pad_prompt_to or bucket_size(P0)
        lengths = (torch.full((B,), P0, dtype=torch.long, device=dev)
                   if prompt_lengths is None else
                   torch.as_tensor(np.asarray(prompt_lengths),
                                   device=dev).long())
        prompt = torch.cat([prompt, torch.full((B, Pb - P0), eos_id,
                                               dtype=torch.long,
                                               device=dev)], 1)
        L = Pb + max_new_tokens
        pad_bias = pad_bias_row(lengths, Pb, L, dev)
        caches = decoder.gen_cache(memory)
        positions = torch.arange(Pb, device=dev)[None].expand(B, Pb)
        out, caches = decoder(run_embed(prompt, positions), memory,
                              pad_bias[:, None, None, :Pb], None, caches,
                              tgt_is_causal=True)
        lg = project(out)
        last = lg[torch.arange(B, device=dev), lengths - 1]
        tok = last.argmax(-1)
        done = tok == eos_id
        lens = torch.ones((B,), dtype=torch.long, device=dev)
        toks, step_logits = [tok], [last]
        for t in range(1, max_new_tokens):
            pos = torch.full((B, 1), Pb + t - 1, dtype=torch.long,
                             device=dev)
            out, caches = decoder(run_embed(tok[:, None], pos), memory,
                                  pad_bias[:, None, None, :Pb + t], None,
                                  caches)
            lg2 = project(out)[:, 0]
            nxt = lg2.argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            lens = lens + (~done).long()
            done = done | (nxt == eos_id)
            tok = nxt
            toks.append(tok)
            step_logits.append(lg2)
        toks = torch.stack(toks, 1).cpu().numpy()
        lens = lens.cpu().numpy()
        if return_logits:
            return toks, lens, torch.stack(step_logits, 1).float().cpu()
        return toks, lens
    finally:
        decoder.train(was_training)
