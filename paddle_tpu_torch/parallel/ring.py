"""Ring attention: context parallelism over a mesh axis (the JAX
package's `parallel/ring.py`).

Each rank of the axis holds a shard of the sequence of q, k and v
([b, h, S / n, d]); K/V pass round the ring (send / recv to the next
rank, `collectives.ppermute`) while each rank folds every block into an
online softmax (`_block`, `_combine`: the JAX block math in plain
torch, float32). The backward goes through the same ring in reverse
(the gradient of a shift is the opposite shift), so `backward()` works
as on one device. The JAX ring calls no Pallas kernel, and neither does
this one.

Layouts: "contiguous" (rank j holds chunk j of the sequence; under the
causal mask the shards after a rank's own skip their products) and, for
causal attention only, "zigzag" (rank j holds chunks j and 2n - 1 - j of
2n, concatenated, so that every rank does the same causal work each
step). The JAX function takes the global arrays inside `shard_map`; the
port's takes this rank's shard, as a rank's code already runs on it:
with `pre_striped=True` the zigzag shard itself, else the contiguous
shard, which the call stripes (one all-gather of q, k and v) and whose
output it returns in contiguous order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .collectives import gather_dim, ppermute
from .mesh import get_mesh

__all__ = ["ring_attention", "zigzag_permutation"]

NEG = -1e30


def _block(qf, kb, vb, masked):
    """One block's (m, l, o) online-softmax pieces for the scaled float32
    queries against one K/V block; `masked`: the diagonal block of the
    causal order (its global offsets coincide)."""
    logits = torch.matmul(qf, kb.float().transpose(-1, -2))
    if masked:
        s_q, s_k = logits.shape[-2:]
        keep = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=qf.device).tril()
        logits = logits.masked_fill(~keep, NEG)
    m_b = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m_b)
    l_b = p.sum(-1, keepdim=True)
    return m_b, l_b, torch.matmul(p, vb.float())


def _combine(carry, m_b, l_b, o_b):
    acc, m_prev, l_prev = carry
    m_new = torch.maximum(m_prev, m_b)
    alpha = torch.exp(m_prev - m_new)
    beta = torch.exp(m_b - m_new)
    return acc * alpha + o_b * beta, m_new, l_prev * alpha + l_b * beta


def _ring(q, k, v, group, n, ax, is_causal, scale, zigzag):
    """This rank's attention output over the ring. Chunks: contiguous,
    one per rank at global offset `ax`; zigzag, two per rank at `ax` and
    `2n - 1 - ax`."""
    b, h, s, d = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * sc
    parts = 2 if zigzag else 1
    cs = s // parts

    def offsets(r):
        return (r, 2 * n - 1 - r) if zigzag else (r,)

    q_chunks = qf.split(cs, 2)
    q_offs = offsets(ax)
    carry = [(torch.zeros((b, h, cs, d), dtype=torch.float32,
                          device=q.device),
              torch.full((b, h, cs, 1), NEG, dtype=torch.float32,
                         device=q.device),
              torch.zeros((b, h, cs, 1), dtype=torch.float32,
                          device=q.device)) for _ in range(parts)]
    # K and V travel as one tensor: one shift a step, forward and back
    kv = torch.cat([k, v], 0)
    for i in range(n):
        if i:
            kv = ppermute(kv, group, 1)
        src = (ax - i) % n
        kr, vr = kv[:b], kv[b:]
        k_chunks, v_chunks = kr.split(cs, 2), vr.split(cs, 2)
        for qi, qo in enumerate(q_offs):
            for ki, ko in enumerate(offsets(src)):
                if is_causal and qo < ko:
                    continue          # a future chunk: nothing to add
                carry[qi] = _combine(carry[qi], *_block(
                    q_chunks[qi], k_chunks[ki], v_chunks[ki],
                    is_causal and qo == ko))
    out = torch.cat([acc / torch.clamp(l_f, min=1e-30)
                     for acc, _, l_f in carry], 2)
    if n > 1 and kv.requires_grad:
        # the last shift's output joins the graph on every rank (a rank
        # whose last blocks are all in its future adds no product of
        # it), so that every rank's backward makes the same shifts
        out = out + 0.0 * kv.sum()
    return out.to(q.dtype)


def zigzag_permutation(S, n):
    """(forward, inverse) int64 gather indices between the natural order
    of a length-S sequence and the zigzag shard order over n ranks (rank
    j holds chunks j and 2n - 1 - j of 2n); stripe token streams once in
    the data pipeline and call with pre_striped=True."""
    if S % (2 * n):
        raise ValueError(f"zigzag needs seq {S} divisible by 2*{n}")
    cs = S // (2 * n)
    order = []
    for j in range(n):
        order.extend(range(j * cs, (j + 1) * cs))
        order.extend(range((2 * n - 1 - j) * cs, (2 * n - j) * cs))
    fwd = np.asarray(order, np.int64)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(S, dtype=np.int64)
    return fwd, inv


def ring_attention(q, k, v, axis_name="sp", mesh=None, is_causal=False,
                   scale=None, layout="contiguous", pre_striped=False):
    """Attention of this rank's sequence shard of q against the whole
    sequence of k / v over the ring of `axis_name` ([b, h, S / n, d]
    each; see the module's docstring for the layouts). An axis of size
    one is plain attention (`ops.attention.sdpa_reference`)."""
    from ..ops.attention import sdpa_reference

    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}: expected "
                         f"'contiguous' or 'zigzag'")
    if layout == "zigzag" and not is_causal:
        raise ValueError("layout='zigzag' balances CAUSAL work; use the "
                         "contiguous layout for bidirectional attention")
    m = mesh or get_mesh()
    n = m.axis_size(axis_name)
    if n == 1:
        return sdpa_reference(q, k, v, None, is_causal, scale)
    group, ax = m.group_of(axis_name), m.coord(axis_name)
    s = q.shape[2]
    if layout == "contiguous":
        return _ring(q, k, v, group, n, ax, is_causal, scale, False)
    if pre_striped:
        if s % 2:
            raise ValueError(f"zigzag ring needs seq {s * n} divisible by "
                             f"2*{n}")
        return _ring(q, k, v, group, n, ax, True, scale, True)
    S = s * n
    fwd, inv = zigzag_permutation(S, n)
    ranks = m.ranks_of(axis_name)
    qkv = gather_dim(torch.stack([q, k, v]), group, -2, ranks)  # [3,b,h,S,d]
    mine = torch.as_tensor(fwd[ax * s:(ax + 1) * s], device=q.device)
    qz, kz, vz = qkv.index_select(3, mine).unbind(0)
    out = _ring(qz, kz, vz, group, n, ax, True, scale, True)
    full = gather_dim(out, group, -2, ranks)                    # zigzag
    rows = torch.as_tensor(inv[ax * s:(ax + 1) * s], device=q.device)
    return full.index_select(-2, rows)
