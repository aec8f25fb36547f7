"""The dense slot pool as the JAX package composes it: a cache layout
(`DenseLayout`: pool state, join, batched step), a placement
(`SinglePlacement`: where and how a body runs) and a stepper
(`PlainStepper`: one batched step per iteration). The paged layout,
the sharded placement and the speculative stepper are later slices.

Where the JAX join family donated the pool carry so XLA could alias it,
the port writes in place: a join prefills the prompt through a batch-1
view of the slot's rows of the preallocated [S, H, L, D] pool, so the
K/V land in the pool with no copy, and the slot's write index, key-bias
row, cross-attention K/V rows and pending token are overwritten in
place; the batched step writes each active slot's new K/V at its own
index. Every write is slot-local, so a join never touches another
slot's rows.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DenseLayout", "SinglePlacement", "PlainStepper"]


class DenseLayout:
    """The contiguous [S, H, pool_len, D] StaticKVCache pool: every slot
    owns its worst-case rows, write indices live on the device."""

    def __init__(self, eng):
        self.eng = eng

    def build_state(self, memory):
        """Zeroed pool for memories shaped like `memory` [M, D]."""
        eng = self.eng
        decoder = eng._net.decoder
        M = memory.shape[0]
        S, L, dev = eng.num_slots, eng._pool_len, eng.device
        inc = [layer.self_attn.gen_cache(None, max_length=L, batch_size=S,
                                         dtype=memory.dtype)
               for layer in decoder.layers]
        static = []
        for layer in decoder.layers:
            ca = layer.cross_attn
            shape = (S, ca.num_heads, M, ca.head_dim)
            static.append((torch.zeros(shape, dtype=memory.dtype, device=dev),
                           torch.zeros(shape, dtype=memory.dtype, device=dev)))
        return {"tok": torch.zeros((S,), dtype=torch.long, device=dev),
                "bias": torch.zeros((S, L), dtype=torch.float32, device=dev),
                "inc": inc, "static": static}

    def join(self, slot, prompt, length, memory):
        """Prefill `prompt` [1, Pb] (true length `length`) with `memory`
        [1, M, D] into pool slot `slot`, in place. Returns token 0 as a
        device scalar (the caller syncs once per admission round)."""
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
        logits, _, static1, bias_row = eng._net.prefill(
            prompt, length, memory, views, eng._pool_len)
        # token 0 conditions on the row's LAST REAL prompt position
        tok0 = logits[0, length - 1].argmax(-1)
        for c in st["inc"]:
            c.index[slot] = Pb
        for (pk, pv), (sk, sv) in zip(st["static"], static1):
            pk[slot].copy_(sk[0])
            pv[slot].copy_(sv[0])
        st["bias"][slot] = bias_row[0]
        st["tok"][slot] = tok0
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
        logits, inc2 = eng._net(st["tok"][:, None], posn, None,
                                tgt_mask=st["bias"], inc=inc,
                                static_kv=st["static"])
        nxt = torch.where(active, logits[:, 0].argmax(-1), st["tok"])
        for c, c2 in zip(inc, inc2):
            c.index.copy_(torch.where(active, c2.index, c.index))
        st["tok"].copy_(nxt)
        return nxt


class SinglePlacement:
    """One card: bodies run on the calling thread under inference mode,
    launching on that thread's current CUDA stream."""

    def __init__(self, eng):
        self.eng = eng

    def run(self, body, *args):
        with torch.inference_mode():
            return body(*args)


class PlainStepper:
    """One token per slot per iteration: one batched step over the
    active mask, one host sync for the tokens."""

    def __init__(self, eng):
        self.eng = eng

    def decode(self, active):
        eng = self.eng
        if not active.any():
            return np.zeros((eng.num_slots,), np.int64)
        mask = torch.as_tensor(active, device=eng.device)
        toks = eng.placement.run(eng.layout.step, mask)
        return toks.cpu().numpy()
