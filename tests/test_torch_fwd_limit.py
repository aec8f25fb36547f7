"""The bf16 output limit of the flash forward kernel, on the CPU.

The card's bf16 forward output is held to `testing.flash_fwd_tiled` (the
plain version computed as the kernel computes it, key tile by key tile)
by `testing.judge_bf16_grad`: every element within one bf16 ulp of the
largest entry, at most 1% of the elements differing, relative L2 error
at most 1e-3 (`chip_smoke.py` phases 9 and 21, the `cuda` tests in
test_torch_kernels.py, tools/check_bwd_limit.py). Here, with inputs from
numpy at a small bf16 shape with a pad bias and dropout 0.1: the tiled
reference is the plain version's function (float32 inputs agree to
float32 rounding), it must be the reference because the plain version
rounds p at the row's final max and so differs from any online-softmax
forward in a large share of the bf16 outputs, the judge accepts a
forward that rounds p where the kernel does but sums in float64, and it
refuses one that skips the rounding of p, which the older limit (1e-2
of the largest entry) passes. The mutation with which
tools/check_bwd_limit.py shows the limit refusing such a kernel on the
card must still apply to the kernel's source.
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
from paddle_tpu_torch.core.lod import pack_padded  # noqa: E402
from paddle_tpu_torch.ops import attention as TA  # noqa: E402
from paddle_tpu_torch.testing import (flash_fwd_tiled,  # noqa: E402
                                      judge_bf16_grad)

BF = torch.bfloat16
#: the limit phase 9 held the bf16 forward output to before: 1e-2 of the
#: plain output's largest entry
OLD_REL = 1e-2


def _inputs(dtype, s=256, seed=7):
    b, h, d = 1, 2, 64
    rs = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rs.standard_normal((b, h, s, d))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    bias = torch.where(torch.arange(s)[None] >= s - 56, -1e4, 0.0).float() \
        .contiguous()
    return q, k, v, bias, TA.drop_spec(0.1, 5, s, s, 64, 64)


@pytest.fixture(scope="module")
def case():
    """bf16 (q, k, v, bias, dropout spec) at b1 h2 s256 d64, the plain
    output and the tiled reference's."""
    q, k, v, bias, drop = _inputs(BF)
    plain = TA.flash_attention_fwd_plain(q, k, v, bias, False, None,
                                         drop)[0]
    return (q, k, v, bias, drop), plain, flash_fwd_tiled(q, k, v, bias,
                                                         False, None, drop)


@pytest.mark.parametrize("causal", [False, True])
def test_tiled_reference_is_the_plain_function_in_float32(causal):
    """Where rounding p to the operand type is exact (float32), the
    tile-by-tile online softmax equals the plain version to float32
    rounding, with causal masking, the key bias and dropout."""
    q, k, v, bias, drop = _inputs(torch.float32)
    want = TA.flash_attention_fwd_plain(q, k, v, bias, causal, None,
                                        drop)[0]
    got = flash_fwd_tiled(q, k, v, bias, causal, None, drop)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


def test_tiled_reference_with_segments_skips_nothing_that_counts():
    """Packed rows: the tiles the kernel skips hold only -1e30 logits, and
    visiting them (as the reference does) leaves the output equal to the
    plain version's in float32, a row whose first tiles lie in other
    segments included."""
    s = 320
    lens = np.array([[70, 130, 120], [200, 64, 56]])
    pk = pack_padded(np.ones((6, 200), np.int64), lens.reshape(-1),
                     row_len=s)
    ids = torch.as_tensor(pk.segment_ids[:2].astype(np.int32))
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.standard_normal((2, 2, s, 64))
                                .astype(np.float32)) for _ in range(3))
    drop = TA.drop_spec(0.1, 2, s, s, 64, 64)
    want = TA.flash_attention_fwd_plain(q, k, v, None, False, None, drop,
                                        ids)[0]
    got = flash_fwd_tiled(q, k, v, None, False, None, drop,
                          segment_ids=ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


def test_plain_version_rounds_p_elsewhere_than_an_online_forward(case):
    """In bf16 the plain version (p rounded at the row's final max) and
    the tile-by-tile forward (p rounded at its tile's running max) differ
    in a large share of the outputs, by at most half an ulp of the
    largest entry: no share limit could hold a kernel to the plain
    version, and the older limit cannot tell the two roundings apart."""
    _, plain, tiled = case
    nums, misses = judge_bf16_grad(tiled, plain)
    assert nums["share"] > 0.05 and misses
    assert nums["ulps_of_largest"] <= 0.5


@pytest.mark.parametrize("seed", [7, 8])
def test_limit_accepts_a_float64_sum_of_the_kernels_roundings(seed):
    """p rounded where the kernel rounds it, the softmax and the sums in
    float64: a kernel that sums in another order, with a p that differs
    in its last bits."""
    q, k, v, bias, drop = _inputs(BF, seed=seed)
    want = flash_fwd_tiled(q, k, v, bias, False, None, drop)
    got = flash_fwd_tiled(q, k, v, bias, False, None, drop,
                          acc_dtype=torch.float64)
    nums, misses = judge_bf16_grad(got, want)
    assert not misses, f"{misses} ({nums})"
    assert nums["share"] < 1e-3


def test_limit_refuses_a_forward_that_skips_the_rounding_of_p(case):
    """p left unrounded before the P.V product: refused by the share of
    differing elements and the L2 error, while the older limit passes
    it."""
    (q, k, v, bias, drop), plain, tiled = case
    got = flash_fwd_tiled(q, k, v, bias, False, None, drop, round_p=False)
    nums, misses = judge_bf16_grad(got, tiled)
    assert any("differ" in m for m in misses), nums
    assert nums["share"] > 0.1
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= OLD_REL * plain.float().abs().max().item()


@pytest.mark.parametrize("name", sorted(check_bwd_limit.FWD_MUTATIONS))
def test_fwd_limit_mutation_still_applies_to_the_kernel(name):
    """The edits of `check_bwd_limit.FWD_MUTATIONS` find their anchors
    once in the forward's source, and the mutant gains one more
    tensor-core P.V product, fed the residue of p's rounding."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    with open(os.path.join(csrc, name)) as f:
        src = f.read()
    mutant = check_bwd_limit.mutated_sources(
        csrc, check_bwd_limit.FWD_MUTATIONS)[name]
    # the wgmma wrappers are templated on the operand type since the
    # kernel's float16 instance
    assert mutant.count("wgmma_rs<T>(") == src.count("wgmma_rs<T>(") + 1
    assert mutant.count("to_a<T>(lo_,") == 1
