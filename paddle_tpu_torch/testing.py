"""Limits that hold the port's kernels to their plain versions.

`judge_bf16_grad` is the limit for the bf16 gradients (dq, dk, dv) of
the flash backward kernels against `flash_attention_bwd_plain`: the
end-to-end script's phases 9 and 21, the card tests in
tests/test_torch_kernels.py, and tools/check_bwd_limit.py, which
prints the evidence behind it on the card.

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
"""
from __future__ import annotations

import torch

__all__ = ["ULP_BF16_GRAD", "SHARE_BF16_GRAD", "L2_BF16_GRAD",
           "bf16_ulp", "per_element_error", "judge_bf16_grad"]

#: bf16 dq, dk and dv: every element within one bf16 ulp of the plain
#: version's largest entry (2^-8 to 2^-7 of that entry), at most 1% of
#: the elements differing at all, a relative L2 error of at most 1e-3
ULP_BF16_GRAD, SHARE_BF16_GRAD, L2_BF16_GRAD = 1.0, 1e-2, 1e-3


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
