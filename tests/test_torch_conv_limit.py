"""The limit for the bf16 z and dx of the fused 1x1-conv + BN kernels
(`paddle_tpu_torch.testing.judge_bf16_sum`), on the CPU.

The tensor-core kernels sum the same exact products as the plain
versions (`fused_fwd_reference`, `fused_bwd_reference`) in another
float32 order. Here the plain outputs are recomputed as float32 sums in
three other orders (k-blocks of 16 with the partials added at the end,
the reversed order, a pairwise tree), on inputs built so that one output
channel of z and one input channel of dx are sums that cancel to a small
fraction of their terms: the judge must accept every order, and some
element must move by more than one bf16 ulp of itself (which a limit of
one ulp of each element would refuse, though the function is the same).
It must refuse the plain versions with the bf16 rounding of xn or of
dz_eff skipped. Inputs come from numpy seeds; sizes are small (widths
10-64, batch 2).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch.ops import fused_conv as TFC  # noqa: E402
from paddle_tpu_torch.testing import (SUM_FC_BF16, bf16_ulp,  # noqa: E402
                                      fused_conv_abs_sums,
                                      fused_conv_mutants, judge_bf16_sum)

BF = torch.bfloat16
H = 16            # cancelling pairs: channels (k, k + H), k < H
ORDERS = ("kblock16", "reversed", "pairwise")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _case(seed, cancel, B=2, HW=49, width=64, norm=True):
    """Inputs of one fused op (bf16 x, W, z, dz): cancel="z" makes output
    channel 0's z sum cancel (Ci = 2H + 1: x channels H..2H-1 repeat
    0..H-1, W[0, H:2H] = -W[0, :H], W[0, 2H] small); cancel="dx" makes
    input channel 0's dx sum cancel (Co = 2H + 1: z, dz, ds, dss rows
    H..2H-1 repeat 0..H-1, W[H:2H, 0] = -W[:H, 0], W[2H, 0] small); None
    draws everything at random (Ci = Co = 64)."""
    rng = np.random.RandomState(seed)
    k = 2 * H + 1
    Ci, Co = {"z": (k, width), "dx": (width, k), None: (64, 64)}[cancel]
    x = rng.randn(B, Ci, HW)
    w = rng.randn(Co, Ci) * Ci ** -0.5
    sc = rng.rand(Ci) + 0.5 if norm else None
    sh = rng.randn(Ci) * 0.1 if norm else None
    z = rng.randn(B, Co, HW)
    dz = rng.randn(B, Co, HW)
    ds = rng.randn(Co)
    dss = rng.randn(Co) * 0.01
    if cancel == "z":
        x[:, H:2 * H] = x[:, :H]
        if norm:
            sc[H:2 * H], sh[H:2 * H] = sc[:H], sh[:H]
        w[0, H:2 * H] = -w[0, :H]
        w[0, 2 * H] *= 2.0 ** -14
    elif cancel == "dx":
        for t in (z, dz):
            t[:, H:2 * H] = t[:, :H]
        ds[H:2 * H], dss[H:2 * H] = ds[:H], dss[:H]
        w[H:2 * H, 0] = -w[:H, 0]
        w[2 * H, 0] *= 2.0 ** -14
    args = [_t(x, BF), None if sc is None else _t(sc),
            None if sh is None else _t(sh), _t(w, BF), _t(z, BF), _t(dz, BF),
            _t(ds), _t(dss)]
    return args


def _sum(prod, order):
    """The float32 sum over dim 0 of prod, in one order."""
    k = prod.shape[0]
    if order == "kblock16":
        parts = []
        for b0 in range(0, k, 16):
            acc = torch.zeros_like(prod[0])
            for i in range(b0, min(k, b0 + 16)):
                acc = acc + prod[i]
            parts.append(acc)
        acc = torch.zeros_like(prod[0])
        for p in parts:
            acc = acc + p
        return acc
    if order == "reversed":
        acc = torch.zeros_like(prod[0])
        for i in range(k - 1, -1, -1):
            acc = acc + prod[i]
        return acc
    terms = list(prod)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _reordered(args, out, order, relu=True):
    """The plain z (out="z") or dx (out="dx") with its float32 sums taken
    in `order`: the same exact products, rounded at the same points."""
    x, sc, sh, w, z, dz, ds, dss = args
    xn, mask = TFC._act_in(x, sc, sh, relu)
    if out == "z":
        # prod[c, b, o, p] = W[o, c] xn[b, c, p]
        prod = w.float().t()[:, None, :, None] * xn.float().transpose(
            0, 1)[:, :, None, :]
        return _sum(prod, order).to(x.dtype)
    dzb = (dz.float() + TFC._bcol(ds) + 2.0 * z.float()
           * TFC._bcol(dss)).to(x.dtype)
    prod = w.float()[:, None, :, None] * dzb.float().transpose(
        0, 1)[:, :, None, :]
    dpre = _sum(prod, order)
    if relu:
        dpre = torch.where(mask, dpre, 0.0)
    if sc is None:
        return dpre.to(x.dtype)
    return (dpre * TFC._bcol(sc)).to(x.dtype)


def _plain(args, relu=True):
    x, sc, sh, w, z, dz, ds, dss = args
    zp = TFC.fused_fwd_reference(x, sc, sh, w, relu)[0]
    dxp = TFC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss, relu)[0]
    return {"z": zp, "dx": dxp}


@pytest.mark.parametrize("out", ["z", "dx"])
@pytest.mark.parametrize("order", ORDERS)
def test_judge_accepts_float32_sums_in_other_orders(out, order):
    args = _case(90, out)
    want = _plain(args)[out]
    abs_z, abs_dx = fused_conv_abs_sums(*args)
    got = _reordered(args, out, order)
    nums, misses = judge_bf16_sum(got, want, abs_z if out == "z"
                                  else abs_dx)
    assert not misses, (nums, misses)
    assert nums["sum_units"] < 0.5


@pytest.mark.parametrize("out", ["z", "dx"])
def test_a_reordered_sum_moves_a_cancelling_element_past_its_own_ulp(out):
    """Why one ulp of each element was a check of the order: on the
    cancelling channel some element of some order lands more than one
    bf16 ulp of itself from the plain version, well inside 2^-20 of its
    sum of |products|."""
    args = _case(90, out)
    want = _plain(args)[out].double()
    abs_z, abs_dx = fused_conv_abs_sums(*args)
    abs_sum = abs_z if out == "z" else abs_dx
    worst = 0.0
    for order in ORDERS:
        got = _reordered(args, out, order).double()
        err = (got - want).abs()
        ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
        ulps = torch.where(ulp > 0, err / ulp, 0.0)
        worst = max(worst, float(ulps.max()))
        assert float((err / abs_sum.clamp_min(1e-300)).max()) < SUM_FC_BF16
    assert worst > 1.0


@pytest.mark.parametrize("out", ["z", "dx"])
def test_judge_refuses_an_unrounded_operand(out):
    """The plain version with xn (z) or dz_eff (dx) left in float32, the
    fault the bf16 limit exists for."""
    args = _case(91, None)
    want = _plain(args)[out]
    abs_z, abs_dx = fused_conv_abs_sums(*args)
    bad_z, bad_dx = fused_conv_mutants(*args)
    bad, abs_sum = (bad_z, abs_z) if out == "z" else (bad_dx, abs_dx)
    nums, misses = judge_bf16_sum(bad, want, abs_sum)
    assert len(misses) == 2, nums
    assert nums["share"] > 0.1 and nums["sum_units"] > 10.0


@pytest.mark.parametrize("norm", [True, False])
def test_mutants_leave_the_operands_in_float32(norm):
    """`fused_conv_mutants` is the plain z from the float32 activation
    and the plain dx from the float32 dz_eff (masked and scaled as the
    plain version does), written out here in full."""
    x, sc, sh, w, z, dz, ds, dss = args = _case(94, None, norm=norm)
    relu = norm
    bad_z, bad_dx = fused_conv_mutants(*args, relu=relu)
    pre = x.float() * TFC._bcol(sc) + TFC._bcol(sh) if norm else x.float()
    xn = torch.clamp_min(pre, 0.0) if relu else pre
    dz_eff = dz.float() + TFC._bcol(ds) + 2.0 * z.float() * TFC._bcol(dss)
    dpre = torch.matmul(w.float().t(), dz_eff)
    if relu:
        dpre = torch.where(pre > 0, dpre, 0.0)
    if norm:
        dpre = dpre * TFC._bcol(sc)
    assert torch.equal(bad_z, torch.matmul(w.float(), xn).to(BF))
    assert torch.equal(bad_dx, dpre.to(BF))


def test_relu_masked_dx_elements_have_no_products_and_must_be_exact():
    args = _case(92, None)
    x, sc, sh = args[:3]
    _, mask = TFC._act_in(x, sc, sh, True)
    assert (~mask).any()
    _, abs_dx = fused_conv_abs_sums(*args)
    assert not abs_dx[~mask].any()
    assert abs_dx[mask].min() > 0
    want = _plain(args)["dx"]
    assert not want[~mask].any()
    got = want.clone()
    idx = (~mask).nonzero()[0].tolist()
    got[tuple(idx)] = 2.0 ** -126
    nums, misses = judge_bf16_sum(got, want, abs_dx)
    assert misses and nums["sum_units"] == float("inf")
    assert not judge_bf16_sum(want, want, abs_dx)[1]


@pytest.mark.parametrize("norm", [True, False])
def test_abs_sums_match_a_float64_loop_over_the_products(norm):
    x, sc, sh, w, z, dz, ds, dss = args = _case(93, None, HW=10,
                                                  norm=norm)
    relu = norm
    abs_z, abs_dx = fused_conv_abs_sums(*args, relu=relu)
    xn, mask = TFC._act_in(x, sc, sh, relu)
    dzb = (dz.float() + TFC._bcol(ds) + 2.0 * z.float()
           * TFC._bcol(dss)).to(BF).double()
    B, Ci, HW = x.shape
    Co = w.shape[0]
    wd, xd = w.double(), xn.double()
    want_z = torch.zeros(B, Co, HW, dtype=torch.float64)
    want_dx = torch.zeros(B, Ci, HW, dtype=torch.float64)
    for c in range(Ci):
        want_z += wd[:, c].abs()[None, :, None] * xd[:, c].abs()[:, None, :]
    for o in range(Co):
        want_dx += wd[o].abs()[None, :, None] * dzb[:, o].abs()[:, None, :]
    if norm:
        want_dx *= sc.double().abs()[None, :, None]
    if mask is not None:
        want_dx = torch.where(mask, want_dx, 0.0)
    torch.testing.assert_close(abs_z, want_z, rtol=1e-12, atol=0)
    torch.testing.assert_close(abs_dx, want_dx, rtol=1e-12, atol=0)
