"""Limits that hold the port's kernels to their plain versions.

`judge_bf16_grad` is the limit for the bf16 gradients (dq, dk, dv) of
the flash backward kernels against `flash_attention_bwd_plain`, and for
the bf16 output of the flash forward against `flash_fwd_tiled`: the
end-to-end script's phases 9 and 21, the card tests in
tests/test_torch_kernels.py, and tools/check_bwd_limit.py, which
prints the evidence behind it on the card.

The forward's own rounding points: the kernels (as the TPU kernel) run
the online softmax key tile by key tile, so p is rounded to the operand
type at the running max of its tile and scaled by exp(m_old - m_new)
later, where `flash_attention_fwd_plain` rounds it at the row's final
max. Wherever a row's max moves after its first tile the two round p
differently, and a third of the bf16 outputs differ by a few ulps (on an
H100 at the ERNIE shape): no limit on the share of differing elements
can hold a forward to the plain version. `flash_fwd_tiled` is the plain
version computed as the kernel computes it, 64 keys a tile; against it a
correct kernel differs only by the float32 order of its sums.

The tensor-core kernels sum the same bf16-rounded operands (round(ds),
round(pd), the scaled q and k) in float32 in another order, so a sum
within its reordering error of a rounding midpoint lands on the
neighbouring bf16 (0.07-0.14% of the elements at the ERNIE shape). Their
p also differs from the plain version's in its last float32 bits (the
logits are summed in another order), so now and then a large p or ds
rounds the other way, and that one term moves a small element by many
of its own ulps: up to 0.5 ulp of the largest entry on an H100, where a
per-element limit of one ulp of each element, or 1e-3 of the largest
entry if that is larger, reads up to 1.19 (above 1 breaks it). A kernel
that skipped the rounding of ds or pd moves 30-40% of the elements
(relative L2 ~2.6e-3).

`judge_bf16_sum` is the limit for the bf16 z of the fused 1x1-conv + BN
forward and the bf16 dx of its backward against their plain versions
(`ops.fused_conv.fused_fwd_reference` / `fused_bwd_reference`): the
end-to-end script's phase 17 and the card tests. Both sides round a
float32 sum of the same products (exact products of bf16 operands) to
bf16; the plain version on the card is a float32 GEMM that adds them in
one order, the tensor-core kernels add them in another. Where the
products cancel, a float32 sum in another order moves the element by
many of its own ulps (up to 270 on an H100 at ResNet-50's shapes), so a
per-element limit of one ulp of each element holds a kernel to one
order, not to the function. Any two float32 orders of n products differ
by at most 2 (n - 1) u sum |products| (u = 2^-24; Higham), 2^-17 of the
sum of |products| at n = 64; the limit's term 2^-20 of it is 8x inside
that and 6.8x above the worst a tensor-core dx read (2^-22.8). A kernel
that skips the bf16 rounding of an operand moves each product by up to
2^-9 of itself, which the term and the share refuse.

`tf32_round`, `split_matmul`, `flash_fwd_split`, `bf16_pieces` and
`int8_matmul_split` are the float32 kernels' tensor-core arithmetic in
plain PyTorch, with the number of pieces as an argument. The float32
flash forward splits each operand into a TF32 big part and a TF32
remainder and takes three TF32 products (3xTF32, `csrc/tf32_mma.cuh`):
its output stays within the float32 limit of the plain version (atol
2e-5), one TF32 pass (pieces=1) does not. The tiled int8 matmul splits x
into three bf16 pieces, each exact against an int8 weight, so its only
error is the float32 order of the sum (1e-5 of the largest entry); one
bf16 piece is a bf16 x, which that limit refuses.
The skinny int8 route (m <= 32) takes the same three pieces on
`mma.sync`, so the same limit and the same mutant hold it.
tests/test_torch_split_limit.py holds both limits to both readings on
the CPU; `chip_smoke.py` phases 2 and 13 compute the one-piece mutants on
the card beside the kernels.

`merge_in_kernel` is the arithmetic of the in-kernel split merge
(`csrc/attn_merge.cuh`: the dense and the paged decode, the paged
verify's split route) in numpy float32, in the kernels' order: a row's
keys split as the plan gives, each split's keys in tiles whose keys go
to 16 groups, an online softmax a group and query row, the groups merged
in group order and the splits in rank order, with the -1e30 convention
(a split with no key visible to a row contributes m -1e30, l 0, acc 0; a
row with no visible key gives 0). `flash_decode_in_kernel` (q * scale
and p rounded to a bf16 q's type), `paged_verify_in_kernel` and
`paged_decode_in_kernel` (the pages read through the table) are its
callers; `paged_read_case` and `dense_decode_case` make their operands
from numpy's seeded generator. tests/test_torch_routes.py and
tests/test_torch_merge.py hold them to the plain versions'
split-and-combine and to the JAX kernels in interpret mode.

`faults` is the deterministic fault-injection harness the serving
engine's fault points read (`testing/faults.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import faults  # noqa: F401

__all__ = ["ULP_BF16_GRAD", "SHARE_BF16_GRAD", "L2_BF16_GRAD",
           "FWD_KEY_TILE", "ULP_FC_BF16", "SUM_FC_BF16", "SHARE_FC_BF16",
           "bf16_ulp", "per_element_error", "judge_bf16_grad",
           "judge_bf16_sum", "fused_conv_abs_sums", "fused_conv_mutants",
           "flash_fwd_tiled", "tf32_round", "split_matmul",
           "flash_fwd_split", "bf16_pieces", "int8_matmul_split",
           "bf16_round", "merge_in_kernel", "paged_verify_in_kernel",
           "paged_decode_in_kernel", "flash_decode_in_kernel",
           "flash_verify_in_kernel", "paged_read_case",
           "dense_decode_case", "dense_verify_case", "nan_past_lengths",
           "faults"]

#: bf16 dq, dk and dv: every element within one bf16 ulp of the plain
#: version's largest entry (2^-8 to 2^-7 of that entry), at most 1% of
#: the elements differing at all, a relative L2 error of at most 1e-3
ULP_BF16_GRAD, SHARE_BF16_GRAD, L2_BF16_GRAD = 1.0, 1e-2, 1e-3
#: keys a tile of the flash forward kernel (`BK`, csrc/flash_common.cuh)
FWD_KEY_TILE = 64
#: bf16 z and dx of the fused 1x1-conv + BN kernels: every element within
#: one bf16 ulp (at the larger of the two values) plus 2^-20 of its sum of
#: |products|, at most 1% of the elements differing at all
ULP_FC_BF16, SUM_FC_BF16, SHARE_FC_BF16 = 1.0, 2.0 ** -20, 1e-2


def bf16_ulp(x):
    """The spacing of bf16 numbers at each |x| (float64; 0 where x is 0)."""
    m = x.double().abs()
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m),
                                          torch.frexp(m).exponent - 8), 0.0)


def per_element_error(got, want, floor):
    """The largest |got - want| over the per-element limit "one bf16 ulp
    of the plain element, or `floor` of the largest plain entry, whichever
    is larger" (above 1 breaks that limit)."""
    a, w = got.double(), want.double()
    top = float(w.abs().max())
    lim = torch.clamp(bf16_ulp(w), min=max(floor * top, 2.0 ** -133))
    return float(((a - w).abs() / lim).max())


def judge_bf16_grad(got, want):
    """A bf16 gradient (dq, dk or dv) against its plain version: (numbers,
    misses). Numbers: the largest |got - want|, the same in bf16 ulps of
    the largest plain entry, the share of elements that differ and the
    relative L2 error; misses lists each limit the gradient breaks (none:
    it passes)."""
    a, w = got.double(), want.double()
    err = (a - w).abs()
    top = float(w.abs().max())
    ulp = 2.0 ** (torch.frexp(torch.tensor(top)).exponent.item() - 8) \
        if top > 0 else 2.0 ** -133
    nums = {"max_abs_err": float(err.max()),
            "ulps_of_largest": float(err.max()) / ulp,
            "share": float((a != w).double().mean()),
            "rel_l2": float(err.norm() / w.norm().clamp_min(1e-30))}
    misses = []
    if not nums["ulps_of_largest"] <= ULP_BF16_GRAD:
        misses.append(f"an element off by {nums['ulps_of_largest']:.3g} "
                      f"ulps of the largest entry (limit {ULP_BF16_GRAD})")
    if not nums["share"] <= SHARE_BF16_GRAD:
        misses.append(f"{nums['share']:.3g} of the elements differ "
                      f"(limit {SHARE_BF16_GRAD})")
    if not nums["rel_l2"] <= L2_BF16_GRAD:
        misses.append(f"relative L2 {nums['rel_l2']:.3g} (limit "
                      f"{L2_BF16_GRAD})")
    return nums, misses


def judge_bf16_sum(got, want, abs_sum):
    """A bf16 z or dx of the fused 1x1-conv + BN kernels against its plain
    version, with each element's sum of |products| (`fused_conv_abs_sums`):
    (numbers, misses). Numbers: the largest |got - want|, the largest in
    bf16 ulps of the element (at max(|got|, |want|)), the largest
    (|got - want| - ulp) / abs_sum in units of 2^-20 (0 when every element
    is within its ulp; inf when an element with abs_sum 0 is not), and
    the share of elements that differ; misses lists each limit the output
    breaks (none: it passes)."""
    a, w = got.double(), want.double()
    s = abs_sum.double()
    err = (a - w).abs()
    ulp = bf16_ulp(torch.maximum(a.abs(), w.abs()))
    over = (err - ULP_FC_BF16 * ulp).clamp_min(0.0)
    term = torch.where(over > 0, over / s, 0.0)     # inf where s is 0
    nums = {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "ulps": float(torch.where(ulp > 0, err / ulp, 0.0).max())
            if err.numel() else 0.0,
            "sum_units": float(term.max()) / SUM_FC_BF16
            if err.numel() else 0.0,
            "share": float((a != w).double().mean()) if err.numel() else 0.0}
    misses = []
    bad = int((err > ULP_FC_BF16 * ulp + SUM_FC_BF16 * s).sum())
    if bad:
        misses.append(f"{bad} elements off by more than {ULP_FC_BF16:g} ulp "
                      f"+ 2^-20 of their sum of |products| (worst "
                      f"{nums['sum_units']:.3g} units of 2^-20)")
    if not nums["share"] <= SHARE_FC_BF16:
        misses.append(f"{nums['share']:.3g} of the elements differ "
                      f"(limit {SHARE_FC_BF16})")
    return nums, misses


def fused_conv_abs_sums(x, scale, shift, w, z, dz, ds, dss, relu=True):
    """Each element's sum of |products| for the fused op's z and dx, in
    float64 from the plain versions' operands: (abs_z [B, Co, HW],
    abs_dx [B, Ci, HW]).

    abs_z[b, o, p] = sum_c |W[o, c]| |xn[b, c, p]|, with xn the plain
    version's normalized activation (rounded to x's type);
    abs_dx[b, c, p] = |scale[c]| sum_o |W[o, c]| |dzb[b, o, p]|, with dzb
    dz_eff rounded as `fused_bwd_reference` rounds it (from the stored
    z), scale 1 without a norm, and 0 where the ReLU masks the element
    (its dx is 0 on both sides)."""
    from ..ops.fused_conv import _act_in, _bcol

    xn, mask = _act_in(x, scale, shift, relu)
    wa = w.double().abs()
    abs_z = torch.matmul(wa, xn.double().abs())
    dzb = (dz.float() + _bcol(ds) + 2.0 * z.float() * _bcol(dss)).to(x.dtype)
    abs_dx = torch.matmul(wa.t(), dzb.double().abs())
    if scale is not None:
        abs_dx = abs_dx * scale.double().abs().reshape(-1, 1)
    if mask is not None:
        abs_dx = torch.where(mask, abs_dx, 0.0)
    return abs_z, abs_dx


def fused_conv_mutants(x, scale, shift, w, z, dz, ds, dss, relu=True):
    """The faults `judge_bf16_sum` exists to refuse: (the plain z with xn
    left in float32, the plain dx with dz_eff left in float32), what a
    kernel that skipped either bf16 rounding computes (the plain versions
    with rounded=False)."""
    from ..ops.fused_conv import fused_bwd_reference, fused_fwd_reference

    return (fused_fwd_reference(x, scale, shift, w, relu, rounded=False)[0],
            fused_bwd_reference(x, scale, shift, w, z, dz, ds, dss, relu,
                                rounded=False)[0])


def flash_fwd_tiled(q, k, v, bias=None, is_causal=False, scale=None,
                    dropout=None, segment_ids=None, kv_segment_ids=None,
                    tile=FWD_KEY_TILE, acc_dtype=None, round_p=True):
    """The flash forward's output as the kernels compute it: the logits
    of `flash_attention_fwd_plain`, then the online softmax over key
    tiles of `tile` (running max from -1e30, normaliser of the unrounded
    p, p dropped and rounded to the operand type at its tile's running
    max, the accumulator rescaled by exp(m_old - m_new)), divided by
    max(l, 1e-30). acc_dtype: the type of the softmax and the sums
    (default the logits'); round_p=False skips the rounding of p (the
    fault the limit must refuse). Tiles the kernel skips (past the causal
    or segment range) hold only -1e30 logits: before a row's first
    visible key they add exp(0) terms that its first visible key wipes
    (alpha = 0), after it they add nothing, so visiting them changes
    nothing."""
    from ..ops import attention as A

    b, h, sq, d = q.shape
    sk = k.shape[2]
    segs = A._segments(segment_ids, kv_segment_ids, q, k)
    logits = A._logits(q, k, bias, is_causal, A._scale(d, scale), segs)
    acc = acc_dtype or logits.dtype
    logits = logits.to(acc)
    keep = None if dropout is None else A._keep4(dropout, b, h, sq, sk,
                                                 q.device)
    inv_keep = None if dropout is None else A._drop_consts(dropout.p)[1]
    vv = v.to(acc)
    m = torch.full((b, h, sq, 1), A.NEG, dtype=acc, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((b, h, sq, d), dtype=acc, device=q.device)
    for j in range(0, sk, tile):
        lg = logits[..., j:j + tile]
        m_new = torch.maximum(m, lg.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., j:j + tile], p * inv_keep, 0.0)
        if round_p:
            p = p.to(q.dtype).to(acc)
        o = o * alpha + torch.matmul(p, vv[:, :, j:j + tile])
        m = m_new
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def tf32_round(x):
    """float32 x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to
    nearest on the top 10 stored mantissa bits, ties away from zero, the
    low 13 bits cleared. Done on the bit pattern (a carry out of the
    mantissa moves the exponent, as rounding up does)."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    r = (b + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split_matmul(a, b, pieces=3):
    """a @ b in float32 as the float32 flash kernels take it on the tensor
    cores: each operand split into a TF32 big part and a TF32 remainder,
    and `pieces` TF32 products, each exact in float32: 3 adds small_a.big_b
    and big_a.small_b to big_a.big_b (3xTF32, the kernels), 1 takes
    big_a.big_b alone (one TF32 pass: the mutant)."""
    if pieces not in (1, 3):
        raise ValueError(f"split_matmul: pieces must be 1 or 3, got "
                         f"{pieces}")
    ab, bb = tf32_round(a), tf32_round(b)
    out = torch.matmul(ab, bb)
    if pieces == 3:
        a_s = tf32_round(a.float() - ab)
        b_s = tf32_round(b.float() - bb)
        out = torch.matmul(a_s, bb) + torch.matmul(ab, b_s) + out
    return out


def flash_fwd_split(q, k, v, bias=None, is_causal=False, scale=None,
                    pieces=3):
    """The float32 flash forward's function with both products taken as
    the tensor-core kernels take them (`split_matmul` with `pieces`), the
    softmax as `flash_attention_fwd_plain` takes it: (out [b, h, sq, d],
    lse [b*h, sq, 1]). No dropout or segment ids: those keep the float32
    forward on the CUDA cores."""
    from ..ops import attention as A

    b, h, sq, d = q.shape
    mm = lambda x, y: split_matmul(x, y, pieces)      # noqa: E731
    logits = A._logits(q, k, bias, is_causal, A._scale(d, scale), mm=mm)
    m = logits.amax(-1, keepdim=True).clamp_min(A.NEG)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = mm(p, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).reshape(b * h, sq, 1)


def bf16_pieces(x, pieces=3):
    """float32 x as `pieces` bf16 values, largest first: bf16(x), then the
    bf16 of each float32 remainder (exact in float32). Three pieces sum to
    x exactly for |x| >= 2^-110 (below, the last remainder's low bits
    fall under bf16's smallest step, 2^-133), and each is exact times an
    int8 weight in float32 (8 x 7 significant bits)."""
    out, r = [], x.float()
    for _ in range(pieces):
        p = r.to(torch.bfloat16)
        out.append(p)
        r = r - p.float()
    return out


def int8_matmul_split(x, q, scale, pieces=3):
    """The tiled int8 kernel's function: ``sum_pieces(piece @ f32(q)) *
    scale`` in float32 over x's `bf16_pieces`, the smallest first as the
    kernel adds them. pieces=3 is the kernel (x exactly); pieces=1 is a
    bf16 x (the mutant)."""
    w = q.float()
    acc = None
    for p in reversed(bf16_pieces(x, pieces)):
        t = torch.matmul(p.float(), w)
        acc = t if acc is None else acc + t
    return acc * scale.float()


#: groups of 8 lanes a block of the in-kernel split merge
#: (`amerge::GROUPS`, csrc/attn_merge.cuh)
DECODE_GROUPS = 16


def bf16_round(x):
    """A float32 numpy array rounded to bfloat16 (to nearest, ties to
    even, as `__float2bfloat16`), as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _np32(t):
    return None if t is None else t.detach().cpu().float().numpy()


def merge_in_kernel(q, k, v, length, bias=None, scale=None, plan=None,
                    k_scale=None, v_scale=None, rounded=False):
    """The in-kernel split merge of `csrc/attn_merge.cuh` in numpy
    float32, in the kernel's order of arithmetic. q [S, h, T, d]; k, v
    [S, h, L, d] the logical keys as the kernel reads them (int8 pages as
    their bytes), k_scale / v_scale [S, h, L] their dequant scales or
    None; length [S] written keys after the block's write (row t sees key
    j while j <= length - T + t, j < L); bias [S, L] or None; plan = (C
    splits, keys a split). rounded: q * scale and p rounded to bf16 (the
    dense kernels at a bf16 q; a no-op at float32).

    Keys of a split come in tiles of 2048 / D (D = 64 or 128, the
    kernel's width); key kl of a tile goes to group kl % 16, whose online
    softmax of a row takes one step for the row's keys of the tile: x =
    (q . k) * k_scale (+ bias), m_new the max of m and them, l and acc
    scaled by exp(m - m_new) once, then p = exp(x - m_new), l += p, and
    (p * v_scale) * v added key by key (p rounded first when `rounded`).
    The groups merge in group order, the splits in rank order; a row
    with no visible key gives 0. Returns [S, h, T, d] float32."""
    from ..ops import attention as A

    S, h, T, d = q.shape
    L = k.shape[2]
    C, split = plan
    D = 64 if d <= 64 else 128
    KT, G = 2048 // D, DECODE_GROUPS
    kpg = KT // G
    f32 = np.float32
    sc = f32(A._scale(d, scale))
    qn, kn, vn = _np32(q), _np32(k), _np32(v)
    ksn, vsn, bn = _np32(k_scale), _np32(v_scale), _np32(bias)
    lens = np.asarray(length.cpu()).reshape(-1)
    neg = f32(A.NEG)
    lanes = np.arange(G)[:, None] + G * np.arange(kpg)[None, :]
    out = np.zeros((S, h, T, d), np.float32)
    for b in range(S):
        for hh in range(h):
            for t in range(T):
                qs = (qn[b, hh, t] * sc).astype(f32)
                if rounded:
                    qs = bf16_round(qs)
                lim = max(0, min(L, int(lens[b]) - T + t + 1))
                x = (kn[b, hh, :lim] @ qs).astype(f32)
                if ksn is not None:
                    x = (x * ksn[b, hh, :lim]).astype(f32)
                if bn is not None:
                    x = (x + bn[b, :lim]).astype(f32)
                ranks = []
                for r in range(C):
                    start = r * split
                    end = min(start + split, lim)
                    gm = np.full(G, -np.inf, f32)
                    gl = np.zeros(G, f32)
                    ga = np.zeros((G, d), f32)
                    for j0 in range(start, end, KT):
                        jj = np.minimum(j0 + lanes, end - 1)
                        vis = j0 + lanes < end          # [G, kpg]
                        has = vis[:, 0]
                        xs = np.where(vis, x[jj], f32(-np.inf))
                        m_new = np.where(has, np.maximum(gm, xs.max(1)), gm)
                        with np.errstate(invalid="ignore"):
                            alpha = np.where(
                                has, np.exp(np.where(has, gm - m_new, 0)),
                                1).astype(f32)
                            p = np.where(vis, np.exp(xs - m_new[:, None]),
                                         0).astype(f32)
                        gl = (gl * alpha).astype(f32)
                        ga = (ga * alpha[:, None]).astype(f32)
                        gm = m_new.astype(f32)
                        for kk in range(kpg):
                            gl = (gl + p[:, kk]).astype(f32)
                        if rounded:
                            p = bf16_round(p)
                        for kk in range(kpg):
                            pv = p[:, kk]
                            if vsn is not None:
                                pv = (pv * vsn[b, hh, jj[:, kk]]).astype(f32)
                            ga = (ga + pv[:, None] * vn[b, hh, jj[:, kk]]) \
                                .astype(f32)
                    ms = gm.max()
                    if ms == -np.inf:                   # no visible key
                        ms = neg
                    w = np.exp(gm - ms).astype(f32)
                    den, num = f32(0), np.zeros(d, f32)
                    for g in range(G):
                        den = f32(den + gl[g] * w[g])
                        num = (num + ga[g] * w[g]).astype(f32)
                    ranks.append((f32(ms), den, num))
                mstar = max(m for m, _, _ in ranks)
                den, num = f32(0), np.zeros(d, f32)
                for m, l_, a_ in ranks:
                    w = f32(np.exp(f32(m - mstar)))
                    den = f32(den + l_ * w)
                    num = (num + a_ * w).astype(f32)
                out[b, hh, t] = num / max(den, f32(1e-30))
    return torch.from_numpy(out)


def _logical(pages, scales, table):
    """Paged keys as the kernel reads them: the [S, h, mp * psz, d] raw
    logical rows (int8 bytes as float) through the trash-clipped table,
    and their [S, h, mp * psz] per-key scales (None without scales)."""
    from ..ops import attention as A

    S, mp = table.shape
    _, h, psz, d = pages.shape
    rows = A._table_rows(table.cpu(), pages.shape[0]).numpy()
    g = _np32(pages)[rows]                          # [S, mp, h, psz, d]
    keys = g.transpose(0, 2, 1, 3, 4).reshape(S, h, mp * psz, d)
    if scales is None:
        return torch.from_numpy(keys), None
    sg = _np32(scales)[:, :, 0, 0][rows]            # [S, mp, h]
    per_key = np.repeat(sg.transpose(0, 2, 1), psz, axis=2)
    return torch.from_numpy(keys), torch.from_numpy(per_key)


def paged_verify_in_kernel(q, k_pages, v_pages, k_scale, v_scale, table,
                           length, bias=None, scale=None, plan=None):
    """The paged verify's split route (and, at T 1, the paged decode) as
    the kernel computes it (`merge_in_kernel`, float32 throughout after
    the dequant): q [S, h, T, d], pages [N+1, h, psz, d] (int8 with
    [N+1, h, 1, 1] scales), table [S, mp], length [S] after the block's
    write, bias [S, mp * psz] or None; `plan` (splits, pages a split)
    defaults to `ops.attention.paged_decode_plan` on an H100. Returns
    [S, h, T, d] float32."""
    from ..ops import attention as A

    S, h = q.shape[:2]
    psz, mp = k_pages.shape[2], table.shape[1]
    C, pps = plan or A.paged_decode_plan(S, h, mp)
    k, ks = _logical(k_pages, k_scale, table)
    v, vs = _logical(v_pages, v_scale, table)
    return merge_in_kernel(q, k, v, length, bias, scale, (C, pps * psz),
                           ks, vs)


def paged_decode_in_kernel(q, k_pages, v_pages, k_scale, v_scale, table,
                           length, bias=None, scale=None, plan=None):
    """The paged decode kernel's function as `csrc/paged_decode.cu`
    computes it: `paged_verify_in_kernel` at q [S, h, 1, d]. Returns
    [S, h, 1, d] float32."""
    return paged_verify_in_kernel(q, k_pages, v_pages, k_scale, v_scale,
                                  table, length, bias, scale, plan)


def flash_verify_in_kernel(q, k, v, length, bias=None, scale=None,
                           plan=None):
    """The dense verify kernel's function as `csrc/flash_verify.cu`
    computes it (`merge_in_kernel` at T query rows, with q * scale and p
    rounded to q's type): q [b, h, T, d], k / v [b, h, L, d], length [b]
    after the block's write, bias [b, L] or None; `plan` (splits, keys a
    split) defaults to `ops.attention.flash_decode_plan` on an H100 (the
    dense decode's plan, which the verify follows). Returns [b, h, T, d]
    float32."""
    from ..ops import attention as A

    b, h = q.shape[:2]
    L = k.shape[2]
    return merge_in_kernel(q, k, v, A._lengths(length, b, "cpu"), bias,
                           scale, plan or A.flash_decode_plan(b, h, L),
                           rounded=q.dtype == torch.bfloat16)


def flash_decode_in_kernel(q, k, v, length, bias=None, scale=None,
                           plan=None):
    """The dense decode kernel's function as `csrc/flash_decode.cu`
    computes it: `flash_verify_in_kernel` at q [b, h, 1, d]. Returns
    [b, h, 1, d] float32."""
    return flash_verify_in_kernel(q, k, v, length, bias, scale, plan)


def paged_read_case(S, h, psz, mp, d, T, lens, kv_dtype, hole, seed=60,
                    device="cpu"):
    """Operands of a paged read (decode at T 1, verify above) from numpy's
    seeded generator: pages of a shuffled pool, table entries past each
    slot's written pages on the trash row or unmapped (-1), int8 pages with
    per-(page, head) scales, q [S, h, T, d] viewed from an [S, T, h, d]
    projection (strided), a small random bias with a -1e30 hole over
    `hole`. Returns (q, k_pages, v_pages, k_scale, v_scale, table, length,
    bias)."""
    rs = np.random.RandomState(seed)
    N = S * mp + 3
    table = rs.permutation(N)[:S * mp].reshape(S, mp).astype(np.int32)
    for s, n in enumerate(lens):
        table[s, -(-n // psz):] = -1 if s % 2 else N
    raw = [rs.randn(N + 1, h, psz, d).astype(np.float32) for _ in range(2)]
    scales = [None, None]
    if kv_dtype == torch.int8:
        for i, x in enumerate(raw):
            sc = np.abs(x).max(axis=(2, 3), keepdims=True) / 127.0
            raw[i] = np.clip(np.round(x / sc), -127, 127)
            scales[i] = torch.from_numpy(sc.astype(np.float32)).to(device)
    kp, vp = (torch.from_numpy(x).to(kv_dtype).to(device) for x in raw)
    q = torch.from_numpy(rs.randn(S, T, h, d).astype(np.float32)) \
        .to(device).transpose(1, 2)
    bias = (rs.randn(S, mp * psz) * 0.1).astype(np.float32)
    bias[:, hole[0]:hole[1]] = -1e30
    return (q, kp, vp, scales[0], scales[1],
            torch.from_numpy(table).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device),
            torch.from_numpy(bias).to(device))


def dense_verify_case(b, h, T, L, d, lens, dtype, hole, seed=70,
                      device="cpu"):
    """Operands of a dense verify block from numpy's seeded generator: q
    [b, h, T, d] viewed from a [b, T, h, d] projection (strided), the
    cache k / v [b, h, L, d] in `dtype`, lengths after the block's write,
    a small random [b, L] bias with a -1e30 hole over `hole`. Returns (q,
    k, v, length, bias)."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(b, T, h, d).astype(np.float32)) \
        .transpose(1, 2)
    k, v = (torch.from_numpy(rs.randn(b, h, L, d).astype(np.float32))
            for _ in range(2))
    bias = (rs.randn(b, L) * 0.1).astype(np.float32)
    bias[:, hole[0]:hole[1]] = -1e30
    return (q.to(dtype).to(device), k.to(dtype).to(device),
            v.to(dtype).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device),
            torch.from_numpy(bias).to(device))


def dense_decode_case(b, h, L, d, lens, dtype, hole, seed=70, device="cpu"):
    """`dense_verify_case` at one query token: q [b, h, 1, d] viewed from
    a [b, 1, h, d] projection. Returns (q, k, v, length, bias)."""
    return dense_verify_case(b, h, 1, L, d, lens, dtype, hole, seed, device)


def nan_past_lengths(k, v, length):
    """Copies of a dense cache k / v [b, h, L, d] whose keys at or past
    each row's length are NaN: what a kernel would find there after a
    rejected draft is stale, and a read of it shows in the output."""
    kn, vn = k.clone(), v.clone()
    for i, n in enumerate(length.tolist()):
        kn[i, :, int(n):] = float("nan")
        vn[i, :, int(n):] = float("nan")
    return kn, vn