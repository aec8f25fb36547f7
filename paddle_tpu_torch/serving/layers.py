"""The serving pool as the JAX package composes it (`serving/layers.py`):
three independent axes, one object each.

  * A cache layout owns the pool's device state and every body that
    touches it: `DenseLayout` (contiguous [S, H, pool_len, D] rows per
    slot, write indices on the device) or `PagedLayout` (a global pool of
    fixed-size pages with a host-owned page table and write indices,
    shipped to the device every step). Each has its join, its plain
    batched step and its speculative verify step; the paged layout adds
    the prefix-hit attach, the copy-on-write page copy and the partial
    attach (`pattach`), which prefills only a radix hit's divergent tail
    as one verify block through the pages.
  * A placement says where a body runs (`SinglePlacement`: one card, the
    calling thread, inference mode; `ShardedPlacement`: one rank of a
    sharded engine's mesh, which holds its dp shard of the slot axis and
    gathers the shards' tokens over the world).
  * A stepper owns the per-iteration decode dispatch: `PlainStepper` (one
    token per slot) or `SpecStepper` (an n-gram draft plus one k-token
    verify, with the adaptive effective-k controller).

Where the JAX bodies donated the pool carry so XLA could alias it, the
port writes in place: a dense join prefills through a batch-1 view of
the slot's rows, a paged join scatters the prefilled prompt into its
pages, and every step writes each slot's new K/V at its own positions.
Every write is slot-local (or lands on the paged pool's trash page), so
a join never touches another slot's rows or pages.

With an AdapterPool every body that runs the decoder's self-attention and
FFN (join, pattach, step, spec step) runs under the engine's
`_lora_ctx`, whose ids are per batch row: a join's one bank row, a
step's [S] slot rows (a verify block's T tokens share their row's). The
prefix-hit attach and the page copy run no adapter target.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..profiler import trace as _trace
from . import tracing as _rt

__all__ = ["CacheLayout", "DenseLayout", "PagedLayout", "SinglePlacement",
           "ShardedPlacement", "ShardedDenseLayout", "ShardedPagedLayout",
           "PlainStepper", "SpecStepper"]


def _neg_hole(length, Pb, L, device):
    """[1, L] float32 key bias: -1e30 over the pad hole [length, Pb)."""
    from ..text.generation import pad_bias_row

    return pad_bias_row([length], Pb, L, device)


def _feedable(tokens):
    """Force-rejected draft lanes carry -1 (never a vocabulary token, so
    they never match); the embedding gets token 0 there instead. What a
    rejected lane computes never reaches an accepted token: the lanes
    before it are causal, and its K/V sit past the rolled-back index."""
    return torch.clamp(tokens, min=0).long()


class CacheLayout:
    """Base: the layout-independent pieces (the n-gram draft over the
    token history, the speculation rows a join writes) and the host
    hooks the steppers drive."""

    def __init__(self, eng):
        self.eng = eng

    # ---- program keys (the JAX engine's, `ServingEngine._program`) ----
    def step_key(self):
        raise NotImplementedError

    def spec_step_key(self):
        raise NotImplementedError

    def draft_key(self):
        return ("draft",) + self.eng._pool_key

    # ---- host hooks the steppers drive ----
    def map_step_pages(self, active, width):
        """Make the next `width` write positions of every occupied slot
        physically backed (paged: map pages, evicting a starved slot
        when the pool runs dry). Returns the possibly-updated active
        mask."""
        return active

    def row_index(self):
        """Per-slot written-token counts [S] on the device."""
        raise NotImplementedError

    def advance_rows(self, n_emit):
        """Advance host-owned write indices after a step delivered
        `n_emit` tokens per slot (the dense pool keeps its indices on the
        device: no-op)."""

    # ---- speculation state ----
    def _spec_state(self, state):
        eng = self.eng
        if eng.spec_k:
            # the n-gram draft's token mirror of the cache, and each
            # slot's true prompt length and bucket for the logical
            # (hole-skipping) history view
            S, L, dev = eng.num_slots, eng._pool_len, eng.device
            state["hist"] = torch.zeros((S, L), dtype=torch.int32,
                                        device=dev)
            state["plen"] = torch.zeros((S,), dtype=torch.int32, device=dev)
            state["pbk"] = torch.zeros((S,), dtype=torch.int32, device=dev)
        return state

    def _spec_join_rows(self, slot, prompt, length, Pb):
        """The speculation rows a join writes beside the K/V: the slot's
        history (the prompt row [1, Pb] at [0, Pb), zeros after), its true
        prompt length and its bucket."""
        st = self.eng._state
        if "hist" not in st:
            return
        st["hist"][slot].zero_()
        st["hist"][slot, :Pb] = prompt[0, :Pb].to(torch.int32)
        st["plen"][slot] = int(length)
        st["pbk"][slot] = int(Pb)

    def draft(self):
        """The n-gram proposal of spec_k - 1 tokens per slot ([S, k-1]
        int32), from each slot's history, pending token and written
        count."""
        from ..text import speculative as SP

        eng = self.eng
        st = eng._state
        index = self.row_index()
        return SP.ngram_propose(st["hist"], st["tok"], st["plen"],
                                st["pbk"], eng.spec_k - 1,
                                index.long() - st["pbk"].long(),
                                eng.spec_ngram)

    def _verify_block(self, drafts, spec_on, k_eff):
        """(drafts with the dead lanes set to -1, the fed block [S, k]):
        a spec_on=False slot's drafts and the lanes past the adaptive
        effective k are force-rejected, so a k change never changes a
        shape."""
        st = self.eng._state
        k = self.eng.spec_k
        lane = torch.arange(k - 1, device=drafts.device)[None, :]
        live = spec_on[:, None] & (lane < k_eff - 1)
        drafts = torch.where(live, drafts, -1)
        fed = torch.cat([st["tok"][:, None].to(torch.int32), drafts], 1)
        return drafts, fed

    def _accept(self, preds, drafts, active):
        """Greedy acceptance of one verify round: (n_match, emit, n_emit,
        the next pending token per slot)."""
        from ..text.decode import greedy_accept

        st = self.eng._state
        n_match, emit = greedy_accept(drafts, preds)
        n_emit = torch.where(active, n_match + 1, 0).to(torch.int32)
        corr = preds.gather(1, n_match[:, None].long())[:, 0]
        nxt = torch.where(active, corr, st["tok"])
        return n_match, emit, n_emit, nxt

    @staticmethod
    def _cross_rows(st, slot, static1):
        for (pk, pv), (sk, sv) in zip(st["static"], static1):
            pk[slot].copy_(sk[0])
            pv[slot].copy_(sv[0])

    def _cross_state(self, memory):
        eng = self.eng
        M, S, dev = memory.shape[0], eng.num_slots, eng.device
        static = []
        for layer in eng._net.decoder.layers:
            ca = layer.cross_attn
            shape = (S, ca.num_heads, M, ca.head_dim)
            static.append((torch.zeros(shape, dtype=memory.dtype, device=dev),
                           torch.zeros(shape, dtype=memory.dtype, device=dev)))
        return {"tok": torch.zeros((S,), dtype=torch.long, device=dev),
                "bias": torch.zeros((S, eng._pool_len), dtype=torch.float32,
                                    device=dev),
                "static": static}


class DenseLayout(CacheLayout):
    """The contiguous [S, H, pool_len, D] StaticKVCache pool: every slot
    owns its worst-case rows, write indices live on the device."""

    def step_key(self):
        return ("step",) + self.eng._pool_key

    def spec_step_key(self):
        return ("sstep",) + self.eng._pool_key

    def row_index(self):
        return self.eng._state["inc"][0].index

    def build_state(self, memory):
        """Zeroed pool for memories shaped like `memory` [M, D]."""
        eng = self.eng
        state = self._cross_state(memory)
        state["inc"] = [layer.self_attn.gen_cache(
            None, max_length=eng._pool_len, batch_size=eng.num_slots,
            dtype=memory.dtype) for layer in eng._net.decoder.layers]
        return self._spec_state(state)

    def join(self, slot, prompt, length, memory, row=0):
        """Prefill `prompt` [1, Pb] (true length `length`) with `memory`
        [1, M, D] into pool slot `slot`, in place, under adapter bank row
        `row`. Returns token 0 as a device scalar (the caller syncs once
        per admission round)."""
        from ..nn.layer.transformer import MultiHeadAttention as MHA

        eng = self.eng
        st = eng._state
        Pb = prompt.shape[1]
        # batch-1 [1, H, Pb, D] views of the slot's first Pb positions
        # (a one-token prompt prefills through the decode branch, which
        # reads the whole view)
        views = [MHA.StaticKVCache(
            c.k[slot:slot + 1, :, :Pb], c.v[slot:slot + 1, :, :Pb],
            torch.zeros((1,), dtype=torch.int32, device=eng.device))
            for c in st["inc"]]
        with eng._lora_ctx([row]):
            logits, _, static1, bias_row = eng._net.prefill(
                prompt, length, memory, views, eng._pool_len)
        # token 0 conditions on the row's LAST REAL prompt position
        tok0 = logits[0, length - 1].argmax(-1)
        for c in st["inc"]:
            c.index[slot] = Pb
        self._cross_rows(st, slot, static1)
        st["bias"][slot] = bias_row[0]
        st["tok"][slot] = tok0
        self._spec_join_rows(slot, prompt, length, Pb)
        return tok0

    def chunk(self, slot, rows, seed, length, Pb, memory, prompt, row=0):
        """Chunked prefill: one chunk `rows` [1, Cb] of the bucketed prompt
        `prompt` [1, Pb] (true length `length`) lands at positions [seed,
        seed + Cb) of pool slot `slot`, under adapter bank row `row`. A
        batch-1 view of the slot's row runs it in verify mode (the flash
        verify at T = Cb): the chunk's K/V are written in place and it
        attends causally over what the earlier chunks wrote. Every row it
        splices (bias, cross-attention K/V, speculation rows) comes from
        the true final (length, Pb), so re-running a chunk is idempotent.
        Returns the token after the last real prompt position, read from
        the clamped lane: only the final chunk's is meaningful."""
        from ..nn.layer.transformer import MultiHeadAttention as MHA
        from ..ops import attention as A

        eng = self.eng
        st = eng._state
        Cb = rows.shape[1]
        static1 = eng._net.cross_kv(memory)
        bias_row = _neg_hole(length, Pb, eng._pool_len, eng.device)
        views = [MHA.StaticKVCache(
            c.k[slot:slot + 1], c.v[slot:slot + 1],
            torch.full((1,), int(seed), dtype=torch.int32, device=eng.device))
            for c in st["inc"]]
        posn = int(seed) + torch.arange(Cb, device=eng.device)[None]
        with A.kv_verify_scope(), eng._lora_ctx([row]):
            logits, _ = eng._net(rows, posn, memory, tgt_mask=bias_row,
                                 inc=views, static_kv=static1)
        tok0 = logits[0, min(max(int(length) - 1 - int(seed), 0),
                             Cb - 1)].argmax(-1)
        self._cross_rows(st, slot, static1)
        st["bias"][slot] = bias_row[0]
        st["tok"][slot] = tok0
        self._spec_join_rows(slot, prompt, length, Pb)
        return tok0

    def step(self, active):
        """One batched decode step over all S slots; `active` [S] bool on
        the device. Returns the next token per slot (inactive slots
        repeat their pending token). Inactive slots write garbage K/V at
        their index, never visible, and keep the index where it is."""
        eng = self.eng
        st = eng._state
        inc = st["inc"]
        posn = inc[0].index[:, None].long()
        with eng._lora_ctx(eng._adapter_rows):
            logits, inc2 = eng._net(st["tok"][:, None], posn, None,
                                    tgt_mask=st["bias"], inc=inc,
                                    static_kv=st["static"])
        nxt = torch.where(active, logits[:, 0].argmax(-1), st["tok"])
        for c, c2 in zip(inc, inc2):
            c.index.copy_(torch.where(active, c2.index, c.index))
        st["tok"].copy_(nxt)
        return nxt

    def spec_step(self, drafts, active, spec_on, k_eff):
        """The speculative verify step: the pending token plus the k - 1
        drafts run as one verify block at each slot's offset, greedy
        acceptance, the write index rolled back to the accepted length
        (inactive slots keep theirs). Returns (emit [S, k], n_emit [S])
        on the device."""
        from ..ops import attention as A
        from ..text import speculative as SP

        eng = self.eng
        st = eng._state
        k = eng.spec_k
        inc = st["inc"]
        idx0 = inc[0].index.clone()     # the rollback rewrites it in place
        drafts, fed = self._verify_block(drafts, spec_on, k_eff)
        posn = idx0[:, None].long() + torch.arange(k, device=eng.device)[None]
        with A.kv_verify_scope(), eng._lora_ctx(eng._adapter_rows):
            logits, inc2 = eng._net(_feedable(fed), posn, None,
                                    tgt_mask=st["bias"], inc=inc,
                                    static_kv=st["static"])
        n_match, emit, n_emit, nxt = self._accept(logits.argmax(-1), drafts,
                                                  active)
        new_idx = SP.rollback_index(inc2[0].index, k, n_match, active)
        for c in inc:
            c.index.copy_(new_idx)
        SP.write_hist(st["hist"], fed, idx0)
        st["tok"].copy_(nxt)
        return emit, n_emit


class PagedLayout(CacheLayout):
    """The global fixed-size page pool with host-owned indirection: write
    indices and the page table ride in as device tensors every step, so
    mapping and rollback are host index arithmetic."""

    def step_key(self):
        return ("pstep",) + self.eng._pool_key

    def spec_step_key(self):
        return ("pverify",) + self.eng._pool_key

    def row_index(self):
        eng = self.eng
        return torch.as_tensor(eng._index.astype(np.int32), device=eng.device)

    def map_step_pages(self, active, width):
        from .paging import OutOfPages

        eng = self.eng
        psz = eng.page_size
        now = eng.clock()
        # map the page(s) the next `width` write positions need; under
        # oversubscription a dry pool evicts the starved slot with its
        # partial tokens (the pool itself keeps serving). A speculative
        # step writes the FULL fixed-k block (force-rejected tail
        # included), so every page the block touches must be mapped.
        # Pending slots (mid chunked prefill) are skipped: their index
        # sits mid-prompt, their pages are the chunks' to map, and a dry
        # pool must not evict a half-prefilled slot for a step it sits out.
        for s, r in enumerate(list(eng.slots)):
            if r is None or s in eng._pending:
                continue
            i0 = int(eng._index[s])
            for pi in range(i0 // psz, (i0 + width - 1) // psz + 1):
                if eng._table[s, pi] < 0:
                    try:
                        eng._table[s, pi] = eng._alloc_pages(1)[0]
                    except OutOfPages as e:
                        eng._evict_oom(s, e, now)
                        break
        return np.asarray([r is not None and s not in eng._pending
                           for s, r in enumerate(eng.slots)], bool)

    def advance_rows(self, n_emit):
        eng = self.eng
        eng._index += np.asarray(n_emit, np.int64).astype(eng._index.dtype)

    def _caches(self, table, index):
        from .paging import PagedKVCache

        return [PagedKVCache(pc["k"], pc["v"], pc["ks"], pc["vs"], table,
                             index) for pc in self.eng._state["paged"]]

    def build_state(self, memory):
        eng = self.eng
        state = self._cross_state(memory)
        paged = []
        for layer in eng._net.decoder.layers:
            c = layer.self_attn.gen_paged_cache(
                eng.num_pages, eng.page_size, eng.num_slots, eng.max_pages,
                memory.dtype, eng.kv_dtype)
            paged.append({"k": c.k, "v": c.v, "ks": c.k_scale,
                          "vs": c.v_scale})
        state["paged"] = paged
        return self._spec_state(state)

    def join(self, slot, prompt, length, memory, page_ids, row=0):
        """Prefill `prompt` [1, Pb] into a batch-1 dense cache under
        adapter bank row `row`, then scatter its K/V into the physical
        pages `page_ids` (quantized per page for int8 pools). Returns
        token 0 as a device scalar."""
        from ..nn.layer.transformer import MultiHeadAttention as MHA

        eng = self.eng
        st = eng._state
        Pb = prompt.shape[1]
        inc0 = [layer.self_attn.gen_cache(None, max_length=Pb, batch_size=1,
                                          dtype=memory.dtype)
                for layer in eng._net.decoder.layers]
        with eng._lora_ctx([row]):
            logits, inc1, static1, bias_row = eng._net.prefill(
                prompt, length, memory, inc0, eng._pool_len)
        tok0 = logits[0, length - 1].argmax(-1)
        for cache, c in zip(self._caches(None, None), inc1):
            MHA.paged_prompt_splice(cache, page_ids, c.k, c.v)
        self._cross_rows(st, slot, static1)
        st["bias"][slot] = bias_row[0]
        st["tok"][slot] = tok0
        self._spec_join_rows(slot, prompt, length, Pb)
        return tok0

    def attach(self, slot, tok0, length, Pb, memory, prompt):
        """Whole prefix hit: the shared prompt pages are already mapped;
        splice only the per-request rows (the joiner's own cross-attention
        K/V, the pad-hole bias, the cached token 0, the speculation rows).
        Zero self-attention prefill. Returns token 0 as a device scalar."""
        eng = self.eng
        st = eng._state
        self._cross_rows(st, slot, eng._net.cross_kv(memory))
        st["bias"][slot] = _neg_hole(length, Pb, eng._pool_len,
                                     eng.device)[0]
        st["tok"][slot] = int(tok0)
        self._spec_join_rows(slot, prompt, length, Pb)
        return st["tok"][slot].clone()

    def cow(self, src, dst):
        """Copy-on-write: physical page `src` into `dst`, every layer."""
        from . import paging as PG

        for pc in self.eng._state["paged"]:
            PG.copy_page(pc["k"], pc["ks"], src, dst)
            PG.copy_page(pc["v"], pc["vs"], src, dst)

    def pattach(self, slot, trow, tail, seed_len, length, Pb, memory,
                prompt, row=0):
        """Radix partial hit: prefill ONLY the prompt's divergent tail
        [1, Tb], seeded by the matched pages, as one verify block through
        the pool itself (under adapter bank row `row`): the tail K/V land
        at positions [seed_len, seed_len + Tb) through the width-clipped
        table row `trow` [1, W] and the verify read sees the seed K/V
        through the same row (bias clipped to W pages), so the attention
        reads only the hit, not the whole pool. A chunk of a chunked
        prefill is the same block (seed = the chunk frontier). Returns, as
        a device scalar, the token after the last real prompt position,
        read from the clamped lane (a mid-prompt chunk's is discarded)."""
        from ..ops import attention as A

        eng = self.eng
        st = eng._state
        W = trow.shape[1]
        static1 = eng._net.cross_kv(memory)
        bias_row = _neg_hole(length, Pb, eng._pool_len, eng.device)
        index = torch.full((1,), int(seed_len), dtype=torch.int32,
                           device=eng.device)
        posn = int(seed_len) + torch.arange(tail.shape[1],
                                            device=eng.device)[None]
        with A.kv_verify_scope(), eng._lora_ctx([row]):
            logits, _ = eng._net(tail, posn, memory,
                                 tgt_mask=bias_row[:, :W * eng.page_size],
                                 inc=self._caches(trow, index),
                                 static_kv=static1)
        # token 0 conditions on the LAST REAL prompt position, which sits
        # at tail lane (length - 1 - seed_len)
        lane = min(max(int(length) - 1 - int(seed_len), 0), tail.shape[1] - 1)
        tok0 = logits[0, lane].argmax(-1)
        self._cross_rows(st, slot, static1)
        st["bias"][slot] = bias_row[0]
        st["tok"][slot] = tok0
        self._spec_join_rows(slot, prompt, length, Pb)
        return tok0

    def _step_inputs(self):
        eng = self.eng
        return eng._device_table(), self.row_index()

    def step(self, active):
        """One batched decode step through the page table (inactive
        slots write to the trash page)."""
        eng = self.eng
        st = eng._state
        table, index = self._step_inputs()
        with eng._lora_ctx(eng._adapter_rows):
            logits, _ = eng._net(st["tok"][:, None], index[:, None].long(),
                                 None, tgt_mask=st["bias"],
                                 inc=self._caches(table, index),
                                 static_kv=st["static"])
        nxt = torch.where(active, logits[:, 0].argmax(-1), st["tok"])
        st["tok"].copy_(nxt)
        return nxt

    def spec_step(self, drafts, active, spec_on, k_eff):
        """The paged verify step. Rollback is host index arithmetic (the
        stepper advances each index by n_emit): rejected tokens sit
        masked past it and their already-mapped pages are rewritten next
        round; no page frees on reject."""
        from ..ops import attention as A
        from ..text import speculative as SP

        eng = self.eng
        st = eng._state
        k = eng.spec_k
        table, index = self._step_inputs()
        drafts, fed = self._verify_block(drafts, spec_on, k_eff)
        posn = index[:, None].long() + torch.arange(k, device=eng.device)[None]
        with A.kv_verify_scope(), eng._lora_ctx(eng._adapter_rows):
            logits, _ = eng._net(_feedable(fed), posn, None,
                                 tgt_mask=st["bias"],
                                 inc=self._caches(table, index),
                                 static_kv=st["static"])
        _, emit, n_emit, nxt = self._accept(logits.argmax(-1), drafts, active)
        SP.write_hist(st["hist"], fed, index)
        st["tok"].copy_(nxt)
        return emit, n_emit


class SinglePlacement:
    """One card: bodies run on the calling thread under inference mode,
    launching on that thread's current CUDA stream."""

    def __init__(self, eng):
        self.eng = eng

    def run(self, body, *args):
        with torch.inference_mode():
            return body(*args)


def _slot_rows(state, lo, hi):
    """The per-slot rows [lo, hi) of a pool state, as views (the pages and
    the dense caches, whose rows a shard already holds alone, stay)."""
    out = dict(state)
    for k in ("tok", "bias", "hist", "plen", "pbk"):
        if k in out:
            out[k] = out[k][lo:hi]
    if "static" in out:
        out["static"] = [(k[lo:hi], v[lo:hi]) for k, v in out["static"]]
    return out


class _SlotView:
    """The engine as one dp shard's bodies see it: `num_slots` is the
    shard's, the pool state and the per-slot host arrays (adapter rows,
    the paged write indices and page table) are sliced to its rows; the
    rest is the engine's."""

    def __init__(self, eng, lo, hi, state):
        self._eng = eng
        self.num_slots = hi - lo
        self._state = state
        self._adapter_rows = eng._adapter_rows[lo:hi]
        if hasattr(eng, "_table"):
            self._table = eng._table[lo:hi]
            self._index = eng._index[lo:hi]

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _device_table(self):
        eng = self._eng
        return torch.as_tensor(
            np.where(self._table < 0, eng.num_pages, self._table)
            .astype(np.int32), device=eng.device)


class ShardedPlacement(SinglePlacement):
    """One rank of a sharded engine (`serving/sharded.py`): bodies run as
    on one card, on this rank's own tensors (the decode kernels see only
    its slots, so the JAX `decode_shardings` scope is a no-op here). The
    slot axis splits over the decode slice's dp rows: shard g owns slots
    [g * per, (g + 1) * per). The placement holds this rank's shard, the
    local views the steps run on, and the exchange of the shards' tokens
    over the world (each dp row's first rank speaks for its row)."""

    def __init__(self, eng):
        super().__init__(eng)
        self._leaders = None

    def run(self, body, *args):
        from ..ops import attention as A

        with torch.inference_mode(), A.decode_shardings():
            return body(*args)

    # ---- the dp shard of the slot axis ----
    @property
    def per(self):
        eng = self.eng
        return eng.num_slots // eng._pool_dp

    def bounds(self):
        """[lo, hi) of this rank's slots (empty on a prefill rank)."""
        eng = self.eng
        if not eng._decodes:
            return 0, 0
        g = eng._dp_row
        return g * self.per, (g + 1) * self.per

    def owns(self, s):
        lo, hi = self.bounds()
        return lo <= s < hi

    def state_bounds(self):
        """The slot rows of this rank's pool state that its shard's views
        take: the dense pool holds only its shard ([0, per)); the paged
        pool's slot rows are whole ([lo, hi))."""
        lo, hi = self.bounds()
        return (0, hi - lo) if self.eng._local_pool else (lo, hi)

    def view(self):
        lo, hi = self.bounds()
        a, b = self.state_bounds()
        return _SlotView(self.eng, lo, hi, _slot_rows(self.eng._state, a, b))

    # ---- the shards' tokens over the world ----
    def _collective_tensor(self, t):
        import torch.distributed as dist

        return t if dist.get_backend() == "nccl" else t.cpu()

    def leaders(self):
        """The global rank that speaks for each decode dp row."""
        if self._leaders is None:
            mesh = self.eng._mesh
            idx = [0] * mesh.ranks.ndim
            ax = mesh.axis_names.index("dp") if "dp" in mesh.axis_names \
                else None
            out = []
            for g in range(self.eng._pool_dp):
                if ax is not None:
                    idx[ax] = g
                out.append(int(mesh.ranks[tuple(idx)]))
            self._leaders = out
        return self._leaders

    def gather(self, local, tail=(), dtype=torch.int64):
        """Every shard's rows of a per-slot result ([per, *tail] here; a
        prefill rank gives none), concatenated in slot order on every rank
        of the world, as `dtype` on the engine's device."""
        import torch.distributed as dist

        from .. import distributed as D

        eng = self.eng
        if local is None:
            local = torch.zeros((self.per,) + tuple(tail), dtype=torch.int64,
                                device=eng.device)
        local = local.to(torch.int64)
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return local.to(dtype)
        parts = D.all_gather([], self._collective_tensor(local.contiguous()))
        return torch.cat([parts[r] for r in self.leaders()], 0).to(
            device=eng.device, dtype=dtype)

    def agree(self, err):
        """Raise on every rank when the step failed on any (`err`: this
        rank's exception or None): one all-reduce of the flag."""
        flag = torch.tensor([0 if err is None else 1], dtype=torch.int64,
                            device=self.eng.device)
        if int(self.max_over_world(flag).reshape(-1)[0]):
            raise err if err is not None else RuntimeError(
                "the step failed on another rank of the mesh")

    def max_over_world(self, t):
        """The elementwise max of an int64 tensor over every rank (the
        owners' values; the others give -1)."""
        import torch.distributed as dist

        from .. import distributed as D

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return t
        t = self._collective_tensor(t.to(torch.int64).contiguous())
        return D.all_reduce(t, op=D.ReduceOp.MAX)


class _ShardedSteps:
    """The per-iteration bodies on a dp shard: each runs the one-card body
    on this rank's local view and hands the stepper the whole slot axis,
    gathered over the world (a prefill rank computes nothing and gives
    nothing, but takes part in the exchange)."""

    def _local(self, fn, agree=False):
        """`fn()` with `self.eng` this rank's shard view (None on a
        prefill rank). With `agree`, a failure on any rank raises on all
        of them (after every rank's part of the exchange)."""
        eng = self.eng
        if not eng._decodes:
            out = None
        else:
            self.eng = eng.placement.view()
            try:
                out = fn()
            except Exception as e:
                if not agree:
                    raise
                out = e
            finally:
                self.eng = eng
        return out

    def _gathered(self, local, parts):
        """The exchange of a step's per-slot results ([(tail, dtype)] a
        part), then the agreement that no rank failed."""
        pl = self.eng.placement
        err = local if isinstance(local, Exception) else None
        vals = (None,) * len(parts) if err is not None or local is None \
            else (local if isinstance(local, tuple) else (local,))
        out = tuple(pl.gather(v, tail, dt)
                    for v, (tail, dt) in zip(vals, parts))
        pl.agree(err)
        return out if len(out) > 1 else out[0]

    def _lo_hi(self):
        return self.eng.placement.bounds()

    def step(self, active):
        lo, hi = self._lo_hi()
        local = self._local(lambda: super(_ShardedSteps, self).step(
            active[lo:hi]), agree=True)
        return self._gathered(local, [((), torch.int64)])

    def draft(self):
        local = self._local(lambda: super(_ShardedSteps, self).draft(),
                            agree=True)
        return self._gathered(local, [((self.eng.spec_k - 1,),
                                       torch.int32)])

    def spec_step(self, drafts, active, spec_on, k_eff):
        lo, hi = self._lo_hi()
        local = self._local(lambda: super(_ShardedSteps, self).spec_step(
            drafts[lo:hi], active[lo:hi], spec_on[lo:hi], k_eff),
            agree=True)
        return self._gathered(local, [((self.eng.spec_k,), torch.int64),
                                      ((), torch.int32)])


class ShardedDenseLayout(_ShardedSteps, DenseLayout):
    """The dense pool over a dp-sharded slot axis: a rank of dp row g
    holds the rows of its shard only ([per, H, pool_len, D] a layer), a
    join runs on the owner row's ranks alone (the others give -1 for
    token 0, and the engine takes the owner's over the world), and the
    steps run on the shard's rows. The disaggregated prefill's two
    halves: `prefill` (a prefill rank: the prompt into batch-1 caches,
    no pool) and `splice` (an owner rank: the travelled K/V into the
    slot's rows)."""

    def build_state(self, memory):
        eng = self.eng
        if not eng._decodes:
            return {}
        self.eng = _SlotView(eng, 0, eng.placement.per, None)
        try:
            return DenseLayout.build_state(self, memory)
        finally:
            self.eng = eng

    def join(self, slot, prompt, length, memory, row=0):
        eng = self.eng
        if not eng.placement.owns(slot):
            return torch.full((), -1, dtype=torch.int64, device=eng.device)
        lo, _ = eng.placement.bounds()
        return self._local(lambda: DenseLayout.join(
            self, slot - lo, prompt, length, memory, row))

    def prefill(self, prompt, length, memory, row=0):
        """The prompt [1, Pb] (true length `length`) with `memory` [1, M,
        D] into batch-1 caches under adapter bank row `row`: (token 0,
        [(K, V)] per layer [1, H, Pb, D], the cross-attention [(K, V)],
        the key-bias row [1, L])."""
        eng = self.eng
        Pb = prompt.shape[1]
        inc0 = [layer.self_attn.gen_cache(None, max_length=Pb, batch_size=1,
                                          dtype=memory.dtype)
                for layer in eng._net.decoder.layers]
        with eng._lora_ctx([row]):
            logits, inc1, static1, bias_row = eng._net.prefill(
                prompt, length, memory, inc0, eng._pool_len)
        tok0 = logits[0, length - 1].argmax(-1)
        return tok0, [(c.k, c.v) for c in inc1], list(static1), bias_row

    def splice(self, slot, tok0, bias_row, kvs, statics, prompt, length):
        """Land one travelled prefill in global slot `slot` (its owner's
        rows; a no-op elsewhere): the rows the inline join writes, the
        same values."""
        eng = self.eng
        if not eng.placement.owns(slot):
            return None
        lo, _ = eng.placement.bounds()
        Pb = prompt.shape[1]

        def land():
            s = slot - lo
            st = self.eng._state
            for c, (k, v) in zip(st["inc"], kvs):
                c.k[s, :, :Pb] = k[0]
                c.v[s, :, :Pb] = v[0]
                c.index[s] = Pb
            self._cross_rows(st, s, statics)
            st["bias"][s] = bias_row[0]
            st["tok"][s] = tok0
            self._spec_join_rows(s, prompt, length, Pb)

        self._local(land)
        return None


class ShardedPagedLayout(_ShardedSteps, PagedLayout):
    """The paged pool on a sharded engine: the pages and the slot rows stay
    whole on every rank, so every join, attach, copy-on-write and partial
    attach runs on every rank alike (the radix prefix cache shares prompt
    pages between slots of any dp row, and a rank cannot read another's
    memory); the steps run on this rank's dp shard of the slots and write
    only their pages."""


class PlainStepper:
    """One token per slot per iteration: one batched step over the
    active mask, one host sync for the tokens."""

    def __init__(self, eng):
        self.eng = eng

    def decode(self, active):
        eng = self.eng
        lay = eng.layout
        active = lay.map_step_pages(active, 1)
        if not active.any():
            return np.zeros((eng.num_slots,), np.int64)
        mask = torch.as_tensor(active, device=eng.device)
        toks = eng.placement.run(eng._program(lay.step_key(), lay.step),
                                 mask).cpu().numpy()
        lay.advance_rows(active.astype(np.int64))
        return toks


class SpecStepper:
    """Draft-verify: two dispatches deliver up to k tokens per slot, plus
    the adaptive effective-k controller (batch-wide, driven by the
    acceptance-rate EMA with hysteresis). Lanes past the effective k are
    force-rejected inside the fixed-k verify block, so k changes never
    change a shape."""

    def __init__(self, eng):
        self.eng = eng
        self.k_eff = eng.spec_k
        self.k_shrink_events = 0
        self.k_grow_events = 0
        self._ema = None
        self._low_rounds = 0
        self._high_rounds = 0

    def _adapt(self, on_count, accepted):
        """Hysteresis: the acceptance-rate EMA must sit below / above the
        band for `spec_adapt_patience` consecutive rounds before k
        shrinks / regrows one step."""
        eng = self.eng
        if not eng.spec_adapt or not on_count:
            return
        lanes = on_count * max(1, self.k_eff - 1)
        rate = accepted / lanes
        a = eng.spec_adapt_alpha
        self._ema = rate if self._ema is None else \
            (1 - a) * self._ema + a * rate
        if self._ema < eng.spec_adapt_low and self.k_eff > 2:
            self._low_rounds += 1
            self._high_rounds = 0
            if self._low_rounds >= eng.spec_adapt_patience:
                self.k_eff -= 1
                self.k_shrink_events += 1
                self._low_rounds = 0
                self._ema = None   # fresh window at the new k
        elif self._ema > eng.spec_adapt_high and self.k_eff < eng.spec_k:
            self._high_rounds += 1
            self._low_rounds = 0
            if self._high_rounds >= eng.spec_adapt_patience:
                self.k_eff += 1
                self.k_grow_events += 1
                self._high_rounds = 0
                self._ema = None
        else:
            self._low_rounds = self._high_rounds = 0

    def decode(self, active):
        eng = self.eng
        lay = eng.layout
        S, k = eng.num_slots, eng.spec_k
        # the verify write is the FULL fixed-k block (force-rejected tail
        # included), so the paged pool maps every page it touches
        active = lay.map_step_pages(active, k)
        if not active.any():
            return np.zeros((S, k), np.int64), np.zeros((S,), np.int64)
        spec_on = np.asarray([r is not None and r.spec for r in eng.slots],
                             bool)
        t0 = time.perf_counter()
        drafts = eng.placement.run(eng._program(lay.draft_key(), lay.draft))
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)   # the draft's own time
        t1 = time.perf_counter()
        emit, n_emit = eng.placement.run(
            eng._program(lay.spec_step_key(), lay.spec_step), drafts,
            torch.as_tensor(active, device=eng.device),
            torch.as_tensor(spec_on, device=eng.device), self.k_eff)
        emit = emit.cpu().numpy()
        n_emit = n_emit.cpu().numpy()
        t2 = time.perf_counter()
        lay.advance_rows(n_emit)
        on = active & spec_on
        on_count = int(on.sum())
        proposed = on_count * (self.k_eff - 1)
        accepted = int(np.maximum(n_emit[on] - 1, 0).sum()) \
            if on_count else 0
        self._adapt(on_count, accepted)
        eng.metrics.record_spec_step(
            int(active.sum()), proposed, accepted, t1 - t0, t2 - t1,
            k_eff=self.k_eff, variant=eng._pool_variant(),
            k_shrinks=self.k_shrink_events, k_grows=self.k_grow_events)
        if _trace._SESSION is not None:
            _rt.on_spec_step(t0, t1, t2, int(active.sum()), proposed,
                             accepted)
        return emit, n_emit
