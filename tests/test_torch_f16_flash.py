"""The float16 instances of the three training kernels (flash forward,
dQ, dK / dV; `amp.auto_cast(dtype="float16")` feeds them f16 q, k, v).

On the CPU: the plain versions round where the kernels round (p to the
operand type in the forward, round(k * scale), ds and pd in the
backward, each now in f16), and the judge the card holds the kernels to
(`testing.judge_bf16_grad` with float16's ulp, 2^-11 of the binade, and
8x bf16's 1% share of differing elements: the same float32 discrepancy
crosses 8x as many f16 rounding boundaries) accepts a forward that
rounds p where the kernel does but sums in float64 and refuses one that
skips the rounding of p. On the card (`cuda`, skipped here): the f16
kernels against their plain versions under that judge, launching their
f16 instances (`F16_LAUNCHES`); the decode kernels, which have no f16
instance, refuse f16 operands.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.testing import flash_fwd_tiled, judge_bf16_grad

F16 = torch.float16


def _inputs(dtype, s=256, seed=7, dev="cpu"):
    b, h, d = 1, 2, 64
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.standard_normal((b, h, s, d))
                                    .astype(np.float32)).to(dev, dtype)
                   for _ in range(4))
    bias = torch.where(torch.arange(s)[None] >= s - 56, -1e4, 0.0).float() \
        .to(dev).contiguous()
    return q, k, v, bias, do, TA.drop_spec(0.1, 5, s, s, 64, 64)


def test_plain_versions_round_to_f16_where_the_kernels_do():
    """Each rounding point of the plain versions follows q's dtype: the
    f16 results are f16 (lse and dbias float32), and the forward differs
    from the same computation in float32 on the f16 operands (p is
    rounded to f16 inside) by a few f16 ulps."""
    q, k, v, bias, do, drop = _inputs(F16)
    out, lse = TA.flash_attention_fwd_plain(q, k, v, bias, False, None,
                                            drop)
    assert out.dtype == F16 and lse.dtype == torch.float32
    dq, dk, dv, db = TA.flash_attention_bwd_plain(
        q, k, v, bias, out, lse, do, False, None, drop)
    assert (dq.dtype, dk.dtype, dv.dtype, db.dtype) == (F16, F16, F16,
                                                         torch.float32)
    # the same in float32 on the f16 values: differs (the f16 roundings of
    # p and ds are part of the function), within a few f16 ulps
    f32 = [t.float() for t in (q, k, v, do)]
    out32, lse32 = TA.flash_attention_fwd_plain(*f32[:3], bias, False, None,
                                                drop)
    assert not torch.equal(out.float(), out32)
    nums, _ = judge_bf16_grad(out32.to(F16), out)
    assert nums["ulps_of_largest"] <= 4
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()


def test_f16_judge_accepts_a_float64_sum_and_refuses_an_unrounded_p():
    q, k, v, bias, _, drop = _inputs(F16)
    want = flash_fwd_tiled(q, k, v, bias, False, None, drop)
    got = flash_fwd_tiled(q, k, v, bias, False, None, drop,
                          acc_dtype=torch.float64)
    nums, misses = judge_bf16_grad(got, want)
    assert not misses, f"{misses} ({nums})"
    bad = flash_fwd_tiled(q, k, v, bias, False, None, drop, round_p=False)
    nums, misses = judge_bf16_grad(bad, want)
    assert misses, nums
    # refused by the share term alone: the unrounded p moves more than
    # f16's 8% of the elements
    assert nums["share"] > 0.08


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 320])
def test_f16_kernels_match_plain_versions(cuda, s):
    q, k, v, bias, do, drop = _inputs(F16, s=s, dev=cuda)
    TA.reset_launches()
    out, lse = TA.flash_attention_fwd(q, k, v, bias, False, None, drop)
    got = TA.flash_attention_bwd(q, k, v, bias, out, lse, do, False, None,
                                 drop)
    torch.cuda.synchronize()
    assert dict(TA.F16_LAUNCHES) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                     "flash_bwd_dkv": 1}
    nums, misses = judge_bf16_grad(out, flash_fwd_tiled(
        q, k, v, bias, False, None, drop))
    assert not misses, (misses, nums)
    want = TA.flash_attention_bwd_plain(q, k, v, bias, out, lse, do, False,
                                        None, drop)
    for a, w in zip(got[:3], want[:3]):
        assert a.dtype == F16
        nums, misses = judge_bf16_grad(a, w)
        assert not misses, (misses, nums)
    db, wdb = got[3], want[3]
    assert (db - wdb).abs().max() <= 1e-3 * wdb.abs().max()


@pytest.mark.cuda
def test_decode_kernels_refuse_f16(cuda):
    q = torch.zeros((1, 2, 1, 64), dtype=F16, device=cuda)
    k = torch.zeros((1, 2, 16, 64), dtype=F16, device=cuda)
    with pytest.raises(TypeError, match="q/k/v must share"):
        TA.flash_decode(q, k, k, torch.ones(1, dtype=torch.int32,
                                            device=cuda))
