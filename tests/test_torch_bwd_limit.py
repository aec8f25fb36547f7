"""The bf16 gradient limit of the flash backward kernels, on the CPU.

`paddle_tpu_torch.testing.judge_bf16_grad` holds the card's bf16 dq, dk
and dv to the plain version (`chip_smoke.py` phases 9 and 21, and the
`cuda` tests in test_torch_kernels.py): every element within one bf16
ulp of the plain version's largest entry, at most 1% of the elements
differing, relative L2 error at most 1e-3. Here it must accept a backward
that rounds the same operands to bf16 at the same points (round(q *
scale), round(k * scale), round(ds), round(pd)) but sums in float64, as
a kernel that sums in another order does (also with p, dp and ds in
float64: a kernel's p differs in the last bits, so a large p or ds may
round the other way), and refuse one that skips the rounding of ds (dq,
dk) or of the dropped p (dv). Inputs come from numpy at a small bf16
shape with a pad bias and dropout 0.1. The mutations with which
tools/check_bwd_limit.py shows the limit refusing such kernels on the
card must still apply to the kernels' sources.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tools"))
import check_bwd_limit  # noqa: E402
from paddle_tpu_torch.ops import attention as TA  # noqa: E402
from paddle_tpu_torch.testing import (judge_bf16_grad,  # noqa: E402
                                      per_element_error)

BF = torch.bfloat16


@pytest.fixture(scope="module")
def case():
    """(q, k, v, bias, dO, out, lse, dropout spec, scale) at b1 h2 s256
    d64 bf16, and the plain backward's (dq, dk, dv, dbias)."""
    b, h, s, d = 1, 2, 256, 64
    rs = np.random.RandomState(7)
    q, k, v, g = (torch.from_numpy(rs.standard_normal((b, h, s, d))
                                   .astype(np.float32)).to(BF)
                  for _ in range(4))
    bias = torch.where(torch.arange(s)[None] >= 200, -1e4, 0.0).float() \
        .contiguous()
    drop = TA.drop_spec(0.1, 5, s, s, 64, 64)
    out, lse = TA.flash_attention_fwd_plain(q, k, v, bias, False, None, drop)
    want = TA.flash_attention_bwd_plain(q, k, v, bias, out, lse, g, False,
                                        None, drop)
    return (q, k, v, bias, g, out, lse, drop, 1.0 / d ** 0.5), want


def _float64_backward(c, round_ds=True, round_pd=True, p64=False):
    """(dq, dk, dv) from the plain version's p, pd and ds, rounded to bf16
    where it rounds them, with the three products summed in float64 and
    then rounded: a backward that sums in another order. p64: p, dp and
    ds in float64 too. round_ds / round_pd False skip those roundings."""
    q, k, v, bias, g, out, lse, drop, s = c
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    acc = torch.float64 if p64 else torch.float32

    def r(x, on=True):
        return (x.to(BF) if on else x).double()
    qs, ks = r(q.float() * s), r(k.float() * s)
    logits = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2)) \
        + bias.to(acc)[:, None, None, :]
    p = torch.exp(logits - lse.to(acc).reshape(b, h, sq, 1))
    dp = torch.matmul(g.to(acc), v.to(acc).transpose(-1, -2))
    keep = TA._keep4(drop, b, h, sq, sk, q.device)
    inv_keep = TA._drop_consts(drop.p)[1]
    pd = torch.where(keep, p * inv_keep, 0.0)
    dp = torch.where(keep, dp * inv_keep, 0.0)
    ds = p * (dp - TA._delta(g, out).to(acc).reshape(b, h, sq, 1))
    dsr, pdr = r(ds, round_ds), r(pd, round_pd)
    return ((dsr @ ks).to(BF), (dsr.transpose(-1, -2) @ qs).to(BF),
            (pdr.transpose(-1, -2) @ g.double()).to(BF))


@pytest.mark.parametrize("p64", [False, True])
def test_bf16_limit_accepts_a_float64_sum_of_the_same_roundings(case, p64):
    c, want = case
    for name, got, w in zip(("dq", "dk", "dv"),
                            _float64_backward(c, p64=p64), want):
        nums, misses = judge_bf16_grad(got, w)
        assert not misses, f"{name}: {misses} ({nums})"
        assert nums["share"] > 0, f"{name}: the float64 sums changed nothing"


@pytest.mark.parametrize("skip", ["ds", "pd"])
def test_bf16_limit_refuses_a_backward_that_skips_a_rounding(case, skip):
    c, want = case
    got = _float64_backward(c, round_ds=skip != "ds", round_pd=skip != "pd")
    hit = ("dq", "dk") if skip == "ds" else ("dv",)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        nums, misses = judge_bf16_grad(a, w)
        if name in hit:
            assert misses, f"{name} without round({skip}) passed: {nums}"
        else:
            assert not misses, f"{name}: {misses} ({nums})"


def test_bf16_limit_is_one_ulp_of_the_largest_entry():
    """The per-element limit is the bf16 spacing at the largest plain
    entry (2^-7 for entries in [1, 2)), wherever the element lies."""
    want = torch.tensor([1.5, 0.01, 2.0 ** -20, 0.0, -1.0], dtype=BF)
    near = want.clone()
    near[1] += 2 ** -7                     # one ulp of 1.5, far from 0.01
    nums, misses = judge_bf16_grad(near, want)
    assert nums["ulps_of_largest"] == 1.0 and nums["share"] == 0.2
    assert not any(m.startswith("an element") for m in misses)
    assert any("differ" in m for m in misses)   # 20% of them differ
    far = want.clone()
    far[3] = 2 ** -6                       # two ulps of the largest entry
    nums, misses = judge_bf16_grad(far, want)
    assert nums["ulps_of_largest"] == 2.0
    assert any(m.startswith("an element") for m in misses)
    nums, misses = judge_bf16_grad(want, want)
    assert nums == {"max_abs_err": 0.0, "ulps_of_largest": 0.0,
                    "share": 0.0, "rel_l2": 0.0} and not misses


def test_per_element_error_reads_each_element_against_its_own_ulp():
    """One ulp of the element, or the floor times the largest entry,
    whichever is larger."""
    want = torch.tensor([1.5, 0.01, 0.0, -1.0], dtype=BF)
    got = want.clone()
    got[1] += 2 ** -14                     # one ulp of 0.01
    assert per_element_error(got, want, 1e-5) == 1.0
    got[1] += 2 ** -14                     # two
    assert per_element_error(got, want, 1e-5) == 2.0
    assert per_element_error(got, want, 1e-3) == pytest.approx(
        2 ** -13 / 1.5e-3)
    got = want.clone()
    got[2] = 2 ** -10                      # at 0 only the floor counts
    assert per_element_error(got, want, 1e-3) == pytest.approx(
        2 ** -10 / 1.5e-3)
    assert per_element_error(want, want, 1e-5) == 0.0


@pytest.mark.parametrize("name", sorted(check_bwd_limit.MUTATIONS))
def test_limit_mutations_still_apply_to_the_kernels(name):
    """Each edit of `check_bwd_limit.MUTATIONS` finds its anchor once in
    the kernel's source, and the mutant gains one more tensor-core
    product per edited product (dq: 1; dK/dV: dv and dk)."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    with open(os.path.join(csrc, name)) as f:
        src = f.read()
    mutant = check_bwd_limit.mutated_sources(csrc)[name]
    extra = {"flash_bwd_dq.cu": 1, "flash_bwd_dkv.cu": 2}[name]
    # the wgmma wrappers and roundings are templated on the operand type
    # since the kernels' float16 instances
    assert mutant.count("wgmma_rs<T>(") == src.count("wgmma_rs<T>(") + extra
    assert mutant.count("Half16<T>::pack(") > src.count("Half16<T>::pack(")
