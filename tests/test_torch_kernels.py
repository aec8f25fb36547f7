"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA card and skips without one; the
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Shapes go beyond the serving and training paths' (ragged and odd
lengths, end-aligned causal with sq != sk, head dims 40 and 128, bf16,
attention dropout, packed segment ids). Tolerances: fp32 rtol 1e-5 /
atol 2e-5 (reordered sums); bf16 rtol / atol 1e-2 (the two sides may round an output to
neighbouring bf16 values, 2^-7 apart at magnitude 1). The backward
kernels' fp32 gradients: rtol 1e-4 / atol 1e-4 (sums of up to sk
products of O(1) terms in another order); bf16 dq, dk and dv:
`paddle_tpu_torch.testing.judge_bf16_grad` (every element within one bf16 ulp of the
plain version's largest entry, at most 1% of the elements differing,
relative L2 error at most 1e-3: both sides round ds and p to bf16 at
the same points and accumulate in float32, the kernels on the tensor
cores in another order and from a p that differs in its last bits, so
a sum near a rounding midpoint, or a large p or ds near one, lands on
the neighbouring bf16; a kernel that skipped a rounding moves a large
share of the elements), bf16 dbias (float32) 1e-3 of its largest
entry.
The int8 matmul and gathered-LoRA kernels: the largest |kernel - plain|
at most 1e-5 of the plain version's largest entry in float32 (sums of up
to d products in another order) and 1e-2 of it for a bf16 x (the result
is rounded to bf16, 2^-8 relative). The fused 1x1-conv + BN kernels: in
float32 z and dx within 1e-5 of the plain version's largest entry (sums
of up to Ci or Co products), the stats, dW, dscale and dshift within 1e-4
(sums over B * HW positions, partials added in another order), in the
bf16 cases too, since those outputs are float32; a bf16 z or dx by
`paddle_tpu_torch.testing.judge_bf16_sum` (every element within one
bf16 ulp plus 2^-20 of its sum of |products|, at most 1% of them
differing: both sides round float32 sums of the same bf16-rounded
activation and dz_eff, the tensor-core kernels in another order, which
moves an element whose products cancel by many of its own ulps but
never by more than a float32 reordering can; a kernel that skipped that
rounding moves a large share of the elements). The bf16 flash
forward's output is also held to `testing.flash_fwd_tiled` (the plain
version rounding p at each 64-key tile's running max, as the kernel
does) by `judge_bf16_grad`.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from paddle_tpu_torch.ops import attention as TA  # noqa: E402
from paddle_tpu_torch.ops import fused_conv as TFC  # noqa: E402
from paddle_tpu_torch.ops import quant as TQ  # noqa: E402
from paddle_tpu_torch.testing import (flash_fwd_tiled,  # noqa: E402
                                      flash_verify_in_kernel,
                                      fused_conv_abs_sums,
                                      fused_conv_mutants, judge_bf16_grad,
                                      judge_bf16_sum, nan_past_lengths)

TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
GRAD_TOL = {torch.float32: (1e-4, 1e-4)}
REL_BF16_DBIAS = 1e-3    # of the plain dbias's largest entry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _rand(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _check_grads(got, want, dt):
    """The backward kernels' (dq, dk, dv, dbias) against the plain
    version's under the module's limits."""
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        if dt == torch.float32:
            rtol, atol = GRAD_TOL[dt]
            torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                       atol=atol,
                                       msg=lambda m: f"{name}: {m}")
        elif name == "dbias":
            err = (a - w).abs().max().item()
            limit = REL_BF16_DBIAS * w.abs().max().item()
            assert err <= limit, f"dbias: max_abs_err {err} > {limit}"
        else:
            nums, misses = judge_bf16_grad(a, w)
            assert not misses, f"{name}: {misses} ({nums})"


def _pad_bias(lens, sk, dev, neg=-1e30):
    kpos = torch.arange(sk)
    bias = torch.where(kpos[None] >= torch.tensor(lens)[:, None], neg, 0.0)
    return bias.float().contiguous().to(dev)


# b, h, sq, sk, d, causal, key lengths (None = no bias), dtype
_FWD = {
    "prefill_causal_bias": (2, 3, 200, 200, 64, True, [130, 200],
                            torch.float32),
    "end_aligned_sq_lt_sk": (1, 2, 77, 131, 32, True, [100],
                             torch.float32),
    "one_row_cross": (4, 2, 1, 300, 128, False, None, torch.float32),
    "d128_ragged": (2, 2, 130, 130, 128, True, [60, 130], torch.float32),
    "d40_pad_bias": (1, 2, 70, 70, 40, False, [50], torch.float32),
    "bf16": (2, 2, 200, 200, 64, True, [150, 200], torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FWD))
def test_flash_fwd_kernel_matches_plain(cuda, case):
    b, h, sq, sk, d, causal, lens, dt = _FWD[case]
    q = _rand((b, sq, h, d), 1, cuda, dt).transpose(1, 2)   # strided
    k = _rand((b, h, sk, d), 2, cuda, dt)
    v = _rand((b, h, sk, d), 3, cuda, dt)
    bias = None if lens is None else _pad_bias(lens, sk, cuda)
    before = TA.LAUNCHES["flash_fwd"]
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal)
    assert TA.LAUNCHES["flash_fwd"] == before + 1
    want, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)


# b, h, sq, sk, d, causal, key lengths (None = no bias), unaligned views:
# the float32 forward's short-query route (sq <= 16, 3xTF32 on the tensor
# cores, keys split over warps and a cluster's blocks): the decode step's
# 1 x 256 cross-attention and every query width to 16 rows, key counts
# off the 64-key tiles, one tile in all, clusters of 8, causal
# (end-aligned), a -1e30 hole over whole blocks' tiles, head dims 40 and
# 128, views whose rows do not start on 16 bytes (4-byte copies)
_FWD_SHORT = {
    "decode_cross_b8_h8_1x256": (8, 8, 1, 256, 64, False, None, False),
    "q2_sk256": (2, 4, 2, 256, 64, False, [256, 100], False),
    "q7_sk200_causal": (3, 2, 7, 200, 64, True, [200, 150, 64], False),
    "q16_sk1000_many_splits": (1, 2, 16, 1000, 64, False, [1000], False),
    "q16_sk37_one_tile": (4, 2, 16, 37, 64, True, None, False),
    "q1_hole_over_splits": (1, 1, 1, 1000, 64, False, [130], False),
    "q3_d40_unaligned": (2, 2, 3, 150, 40, False, [150, 99], True),
    "q1_d128": (2, 3, 1, 300, 128, False, [200, 300], False),
}


def _short_inputs(case, dev):
    b, h, sq, sk, d, causal, lens, odd = _FWD_SHORT[case]
    q = _rand((b, sq, h, d), 91, dev).transpose(1, 2)     # strided
    k = _rand((b, h, sk, d), 92, dev)
    v = _rand((b, h, sk, d), 93, dev)
    if odd:           # rows 4 bytes off 16 (a sliced head dim)
        k = _rand((b, h, sk, d + 1), 92, dev)[..., 1:]
        v = _rand((b, h, sk, d + 1), 93, dev)[..., 1:]
    bias = None if lens is None else _pad_bias(lens, sk, dev)
    return q, k, v, bias, causal


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FWD_SHORT))
def test_fp32_short_query_route_matches_plain(cuda, case):
    q, k, v, bias, causal = _short_inputs(case, cuda)
    before = dict(TA.ROUTE_LAUNCHES)
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal)
    assert TA.ROUTE_LAUNCHES == {
        **before, "flash_fwd:tf32x3_short":
        before["flash_fwd:tf32x3_short"] + 1}
    want, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal)
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode_cross_b8_h8_1x256",
                                  "q16_sk1000_many_splits"])
def test_fp32_short_query_split_merge_is_bitwise_repeatable(cuda, case):
    """The warps' partials merge in warp order and a cluster's blocks'
    partials in rank order: repeated launches give the same bits, at
    clusters of 4 and 8 blocks."""
    q, k, v, bias, causal = _short_inputs(case, cuda)
    assert TA.fwd_cluster(q, k.shape[2]) > 1
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal)
    for _ in range(3):
        out2, lse2 = TA.flash_attention_fwd(q, k, v, bias, causal)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_fp32_query_tiled_cluster_merge_is_bitwise_repeatable(cuda):
    """The serving prefill's shape splits its key tiles over clusters of
    2 (causal: a query tile's visible tiles interleaved over the ranks):
    repeated launches give the same bits, within the limit of the plain
    version."""
    q = _rand((1, 1024, 8, 64), 95, cuda).transpose(1, 2)
    k = _rand((1, 8, 1024, 64), 96, cuda)
    v = _rand((1, 8, 1024, 64), 97, cuda)
    bias = _pad_bias([700], 1024, cuda)
    assert TA.fwd_cluster(q, 1024) == 2
    out, lse = TA.flash_attention_fwd(q, k, v, bias, True)
    for _ in range(3):
        out2, lse2 = TA.flash_attention_fwd(q, k, v, bias, True)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
def test_fp32_forward_counts_launches_by_the_c_rule(cuda):
    """Query-tiled 3xTF32 above 16 rows, short-query at or below,
    float32 FMAs (SIMT) under dropout or segment ids."""
    q = _rand((2, 2, 100, 64), 94, cuda)
    TA.reset_launches()
    TA.flash_attention_fwd(q, q, q)
    TA.flash_attention_fwd(q[:, :, :16], q, q)
    TA.flash_attention_fwd(q, q, q, dropout=TA.drop_spec(0.1, 3, 100, 100))
    TA.flash_attention_fwd(q, q, q, segment_ids=_segment_ids(
        [[60, 40], [100]], cuda))
    assert TA.ROUTE_LAUNCHES == {"flash_fwd:wgmma": 0, "flash_fwd:tf32x3": 1,
                                 "flash_fwd:tf32x3_short": 1,
                                 "flash_fwd:simt": 2}
    assert TA.LAUNCHES["flash_fwd"] == 4


# b, h, sq, sk, d, causal, key lengths (None = no bias), scale (None =
# 1/sqrt(d)), dropout p, segment lengths per row (None = no ids),
# unaligned views: the bf16 forward on the tensor cores
_FWD_TC = {
    "d64_bias_dropout": (2, 3, 300, 300, 64, False, [300, 170], None, 0.1,
                         None, False),
    "d128_causal_sq_lt_sk": (2, 2, 130, 200, 128, True, [200, 120], None,
                             0.1, None, False),
    "d40_scale_not_a_power_of_two": (1, 2, 70, 90, 40, False, None, 0.1,
                                     0.0, None, False),
    "d36_unaligned": (2, 2, 150, 150, 36, True, [150, 99], None, 0.1, None,
                      True),
    "one_row_cross": (4, 2, 1, 300, 64, False, None, None, 0.0, None,
                      False),
    "segments_dropout": (2, 2, 320, 320, 64, False, None, None, 0.1,
                         [[100, 60, 160], [200, 120]], False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FWD_TC))
def test_bf16_forward_on_tensor_cores_matches_the_tiled_reference(cuda,
                                                                  case):
    """The bf16 forward runs the wgmma kernel (ROUTE_LAUNCHES), copies by
    element exactly where the views' rows do not start on 16 bytes, and
    its output is held to `testing.flash_fwd_tiled` (p rounded where the
    kernel rounds it) by `judge_bf16_grad`; its lse to the plain
    version's in float32."""
    b, h, sq, sk, d, causal, lens, scale, p, segl, odd = _FWD_TC[case]
    bf = torch.bfloat16
    q = _rand((b, sq, h, d), 41, cuda, bf).transpose(1, 2)   # strided
    k = _rand((b, h, sk, d), 42, cuda, bf)
    v = _rand((b, h, sk, d), 43, cuda, bf)
    bias = None if lens is None else _pad_bias(lens, sk, cuda, -1e4)
    drop = TA.drop_spec(p, 11, sq, sk, 64, 32) if p else None
    ids = {} if segl is None else dict(segment_ids=_segment_ids(segl, cuda))
    before = dict(TA.ROUTE_LAUNCHES)
    elem = TA.ELEMENT_LOAD_LAUNCHES["flash_fwd"]
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal, scale, drop,
                                      **ids)
    assert TA.ROUTE_LAUNCHES == {
        **before, "flash_fwd:wgmma": before["flash_fwd:wgmma"] + 1}
    assert TA.ELEMENT_LOAD_LAUNCHES["flash_fwd"] == elem + int(odd)
    want = flash_fwd_tiled(q, k, v, bias, causal, scale, drop, **ids)
    nums, misses = judge_bf16_grad(out, want)
    assert not misses, f"{misses} ({nums})"
    _, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal, scale,
                                               drop, **ids)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)


# b, h, L, d, lengths, dtype
_DEC = {
    "ragged_L": (3, 2, 300, 64, [1, 300, 129], torch.float32),
    "d128_short": (2, 2, 77, 128, [77, 3], torch.float32),
    "long_cache": (2, 4, 4100, 64, [4100, 2000], torch.float32),
    "bf16": (2, 2, 300, 64, [300, 10], torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_DEC))
def test_flash_decode_kernel_matches_plain(cuda, case):
    b, h, L, d, lens, dt = _DEC[case]
    q = _rand((b, h, 1, d), 4, cuda, dt)
    k = _rand((b, h, L, d), 5, cuda, dt)
    v = _rand((b, h, L, d), 6, cuda, dt)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    bias = torch.zeros(b, L, device=cuda)
    bias[:, 1:min(L, 40)] = -1e30            # a pad hole after key 0
    before = TA.LAUNCHES["flash_decode"]
    got = TA.flash_decode(q, k, v, length, bias)
    assert TA.LAUNCHES["flash_decode"] == before + 1
    want = TA.flash_decode_plain(q, k, v, length, bias)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# b, h, T, L, d, lengths after the write, dtype
_VER = {
    "spec_T4_ragged": (8, 8, 4, 1060, 64, [4, 1060, 700, 300, 129, 128,
                                            1000, 513], torch.float32),
    "spec_T4_bf16": (4, 2, 4, 300, 64, [300, 10, 4, 133], torch.bfloat16),
    "one_token": (3, 2, 1, 200, 64, [1, 200, 129], torch.float32),
    "T9_d128": (2, 2, 9, 390, 128, [390, 20], torch.float32),
    "T256_d40": (1, 2, 256, 600, 40, [555], torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_VER))
def test_flash_verify_kernel_matches_plain(cuda, case):
    """Against the plain version, the reference and the kernel-order
    emulation; then over a cache whose keys and values past each row's
    length are NaN (a rejected draft's stale block, rolled back): the
    output must still equal the plain version's on the clean cache (a
    kernel that read a key past n_valid would return NaN)."""
    b, h, T, L, d, lens, dt = _VER[case]
    q = _rand((b, T, h, d), 50, cuda, dt).transpose(1, 2)   # strided
    k = _rand((b, h, L, d), 51, cuda, dt)
    v = _rand((b, h, L, d), 52, cuda, dt)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    bias = torch.zeros(b, L, device=cuda)
    bias[:, 1:min(L, 40)] = -1e30            # a pad hole after key 0
    before = TA.LAUNCHES["flash_verify"]
    got = TA.flash_verify(q, k, v, length, bias)
    assert TA.LAUNCHES["flash_verify"] == before + 1
    want = TA.flash_verify_plain(q, k, v, length, bias)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    ref = TA.verify_attention_reference(q, k, v, length, bias)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    emu = flash_verify_in_kernel(q, k, v, length, bias,
                                 plan=TA.flash_decode_plan(b, h, L, sms))
    torch.testing.assert_close(got.float().cpu(), emu, rtol=rtol, atol=atol)
    stale = TA.flash_verify(q, *nan_past_lengths(k, v, length), length,
                            bias)
    torch.testing.assert_close(stale.float(), want.float(), rtol=rtol,
                               atol=atol)


def _paged_case(S, h, psz, mp, d, T, lens, q_dt, kv_dt, dev, seed=60,
                hole=(3, 9)):
    """Pages with a shuffled table: every slot maps pages from one
    permutation of the pool; some entries point at the trash row (N) or
    are unmapped (-1), past each slot's written length. Keys in `hole`
    carry a -1e30 bias."""
    N = S * mp + 3
    g = torch.Generator().manual_seed(seed)
    table = torch.randperm(N, generator=g)[:S * mp].reshape(S, mp) \
        .to(torch.int32)
    for s, n in enumerate(lens):
        first_dead = -(-n // psz)
        if first_dead < mp:
            table[s, first_dead:] = -1 if s % 2 else N
    raw = [torch.randn(N + 1, h, psz, d, generator=g) for _ in range(2)]
    scales = [None, None]
    if kv_dt == torch.int8:
        for i, x in enumerate(raw):
            sc = x.abs().amax((2, 3), keepdim=True) / 127.0
            raw[i] = torch.round(x / sc).clamp(-127, 127)
            scales[i] = sc.to(dev).contiguous()
    kp, vp = (x.to(kv_dt).to(dev) for x in raw)
    q = torch.randn(S, T, h, d, generator=g).to(q_dt).to(dev).transpose(1, 2)
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    bias = (torch.randn(S, mp * psz, generator=g) * 0.1).to(dev)
    bias[:, hole[0]:hole[1]] = -1e30
    return q, kp, vp, scales[0], scales[1], table.to(dev), length, bias


# S, h, psz, mp, d, T, lengths after the write, q dtype, page dtype
_PAGED = {
    "decode_f32": (8, 8, 16, 67, 64, 1, [1, 1072, 700, 300, 129, 128, 1000,
                                         513], torch.float32, torch.float32),
    "decode_int8": (4, 2, 16, 9, 64, 1, [5, 144, 17, 100], torch.float32,
                    torch.int8),
    "decode_bf16_pages": (4, 2, 16, 9, 64, 1, [5, 144, 17, 100],
                          torch.float32, torch.bfloat16),
    "decode_bf16_q_d128": (2, 2, 8, 30, 128, 1, [240, 31], torch.bfloat16,
                           torch.bfloat16),
    "verify_T4_f32": (8, 8, 16, 67, 64, 4, [4, 1072, 700, 300, 129, 128,
                                            1000, 513], torch.float32,
                      torch.float32),
    "verify_T4_int8": (4, 2, 16, 9, 64, 4, [5, 144, 17, 100], torch.float32,
                       torch.int8),
    "verify_T256_f32": (2, 8, 16, 67, 64, 256, [1000, 300], torch.float32,
                        torch.float32),
    "verify_T7_bf16_q": (3, 2, 16, 12, 40, 7, [7, 192, 60], torch.bfloat16,
                         torch.bfloat16),
    # the tiled route (T > 8): the tail prefills of `PagedLayout.pattach`
    # (S 1, h 8, a 512-token seed, the width-clipped row of W = 32 + T/16
    # pages, n_valid == W * 16), int8 and bf16 pages, a slot with no seed
    # (n_valid == T), head dims 40 (element loads for int8) and 128
    "tail_pattach_T64_f32": (1, 8, 16, 36, 64, 64, [576], torch.float32,
                             torch.float32),
    "tail_pattach_T512_f32": (1, 8, 16, 64, 64, 512, [1024],
                              torch.float32, torch.float32),
    "tail_T64_int8_no_seed": (2, 4, 16, 12, 64, 64, [150, 64],
                              torch.float32, torch.int8),
    "tail_T32_bf16_pages": (3, 2, 16, 10, 64, 32, [100, 32, 160],
                            torch.float32, torch.bfloat16),
    "tail_T16_bf16_q_d128": (2, 2, 8, 20, 128, 16, [16, 150],
                             torch.bfloat16, torch.bfloat16),
    "tail_T24_int8_d40": (3, 2, 16, 12, 40, 24, [124, 24, 190],
                          torch.float32, torch.int8),
    "tail_T9_f32_psz8": (2, 3, 8, 40, 64, 9, [9, 300], torch.float32,
                         torch.float32),
}
# a -1e30 bias over whole 64-key tiles, every row seeing keys past it:
# the hole's keys get zero weight once a finite key arrives, in the merge
# of one-tile splits (T32) and in a block's online softmax (T256's splits
# of 384 keys)
_PAGED_HOLE = {
    "tail_hole_first_tile_T32": ((2, 2, 16, 16, 64, 32, [200, 256],
                                  torch.float32, torch.float32), (0, 64)),
    "tail_hole_two_tiles_T256": ((8, 8, 16, 67, 64, 256,
                                  [384, 1072, 700, 384, 384, 384, 1000,
                                   513], torch.float32, torch.float32),
                                 (0, 128))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PAGED) + sorted(_PAGED_HOLE))
def test_paged_kernels_match_plain(cuda, case):
    shape, hole = _PAGED_HOLE.get(case, (_PAGED.get(case), (3, 9)))
    S, h, psz, mp, d, T, lens, q_dt, kv_dt = shape
    args = _paged_case(S, h, psz, mp, d, T, lens, q_dt, kv_dt, cuda,
                       hole=hole)
    name = "paged_flash_decode" if T == 1 else "paged_flash_verify"
    before = TA.LAUNCHES[name]
    routes = dict(TA.PAGED_ROUTE_LAUNCHES)
    got = getattr(TA, name)(*args)
    assert TA.LAUNCHES[name] == before + 1
    if T > 1:      # the verify counts its route: tiled past T 8
        route = f"{name}:{'tiled' if T > 8 else 'split'}"
        assert TA.PAGED_ROUTE_LAUNCHES[route] == routes[route] + 1
    want = getattr(TA, name + "_plain")(*args)
    rtol, atol = TOL[q_dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    # the dispatcher on the card is the kernel; the gather + dense plain
    # path (the CPU dispatch) agrees within the same limits
    q, kp, vp, ks, vs, table, length, bias = args
    kd = TA.paged_gather_kv(kp, ks, table, torch.float32)
    vd = TA.paged_gather_kv(vp, vs, table, torch.float32)
    ref = TA.verify_attention_reference(q.float(), kd, vd, length, bias)
    torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda):
    """The serving layers' call: decode against a pool view, the flash
    forward with the pad hole, both at the reference's semantics."""
    pool = _rand((4, 2, 64, 32), 7, cuda)
    view = pool[1:2, :, :48]                  # a slot's rows, strided
    q = _rand((1, 2, 1, 32), 8, cuda)
    got = TA.decode_attention(q, view, view, torch.tensor([20], device=cuda))
    want = TA.decode_attention_reference(q, view, view, 20)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    qq, kk = _rand((1, 2, 16, 32), 9, cuda), _rand((1, 2, 16, 32), 10, cuda)
    mask = _pad_bias([11], 16, cuda)[:, None, None, :]
    got = TA.sdpa(qq, kk, kk, mask, is_causal=True)
    want = TA.sdpa_reference(qq, kk, kk, mask, is_causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


def _rich_mask(b, s, dev):
    """Causal plus a pad hole as one [b, 1, s, s] float mask: it varies
    per query, so it does not reduce to a per-key bias."""
    causal = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), 0.0,
                         -1e30)
    return (causal[None, None] + _pad_bias([s - 3] * b, s, "cpu")
            [:, None, None, :]).to(dev)


def test_sdpa_refuses_a_per_query_mask_off_the_cpu():
    """Off the CPU a mask no kernel takes raises instead of running the
    plain composition (checked here on the meta device, which holds no
    data; the card case is below)."""
    q = torch.empty(2, 2, 16, 32, device="meta")
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="per query"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, "meta"))
    assert TA.LAUNCHES == before
    cpu = _rand((2, 2, 16, 32), 14, "cpu")
    got = TA.sdpa(cpu, cpu, cpu, _rich_mask(2, 16, "cpu"))
    want = TA.sdpa_reference(cpu, cpu, cpu, _rich_mask(2, 16, "cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sdpa_refuses_dropout_under_a_per_query_mask():
    """Attention dropout rides the flash kernels only: under a mask that
    no kernel takes, sdpa raises on the CPU too."""
    q = _rand((2, 2, 16, 32), 16, "cpu")
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="dropout"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, "cpu"), dropout_p=0.1,
                dropout_seed=3)
    assert TA.LAUNCHES == before


@pytest.mark.cuda
def test_sdpa_refuses_a_per_query_mask_on_card(cuda):
    q = _rand((2, 2, 16, 32), 15, cuda)
    before = dict(TA.LAUNCHES)
    with pytest.raises(NotImplementedError, match="per query"):
        TA.sdpa(q, q, q, _rich_mask(2, 16, cuda))
    assert TA.LAUNCHES == before


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = _rand((1, 2, 8, 32), 11, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TA.flash_attention_fwd(q.half(), q.half(), q.half())
    wide = _rand((1, 2, 8, 192), 12, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        TA.flash_attention_fwd(wide, wide, wide)
    strided = _rand((1, 2, 8, 64), 13, cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        TA.flash_attention_fwd(strided, strided, strided)
    with pytest.raises(ValueError, match="bias"):
        TA.flash_attention_fwd(q, q, q, torch.zeros(1, 8, device=cuda,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="on different devices"):
        TA.flash_attention_fwd(q, q.cpu(), q)


# b, h, sq, sk, d, causal, key lengths (None = no bias), dropout_p, dtype,
# scale (None = 1/sqrt(d)). bf16 runs the tensor-core kernels: a scale
# that is a power of two (d 64, 0.125) multiplies their float32 results,
# any other (d 32 and 128, an explicit 0.1) stages round(q * scale) and
# round(k * scale) tiles
_BWD = {
    "ernie_like_bias_dropout": (2, 3, 256, 256, 64, False, [256, 150],
                                0.1, torch.float32, None),
    "causal_bias_dropout": (1, 2, 200, 200, 64, True, [130], 0.1,
                            torch.float32, None),
    "end_aligned_sq_lt_sk": (1, 2, 77, 131, 32, True, None, 0.0,
                             torch.float32, None),
    "d128_ragged": (2, 2, 130, 130, 128, False, [60, 130], 0.2,
                    torch.float32, None),
    "bf16_bias_dropout": (2, 2, 192, 192, 64, False, [192, 100], 0.1,
                          torch.bfloat16, None),
    "bf16_causal_end_aligned_sq_lt_sk": (1, 2, 77, 131, 64, True, [100],
                                         0.0, torch.bfloat16, None),
    "bf16_d32_ragged": (2, 2, 130, 130, 32, False, [60, 130], 0.1,
                        torch.bfloat16, None),
    "bf16_d128_ragged_causal": (2, 2, 130, 130, 128, True, [60, 130], 0.2,
                                torch.bfloat16, None),
    "bf16_scale_not_a_power_of_two": (2, 2, 192, 160, 64, False, [160, 90],
                                      0.1, torch.bfloat16, 0.1),
    "bf16_dropout_half": (2, 2, 192, 192, 64, False, [192, 100], 0.5,
                          torch.bfloat16, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_backward_kernels_match_plain(cuda, case):
    b, h, sq, sk, d, causal, lens, p, dt, scale = _BWD[case]
    q = _rand((b, sq, h, d), 21, cuda, dt).transpose(1, 2)    # strided
    k = _rand((b, sk, h, d), 22, cuda, dt).transpose(1, 2)
    v = _rand((b, h, sk, d), 23, cuda, dt)
    g = _rand((b, sq, h, d), 24, cuda, dt).transpose(1, 2)
    bias = None if lens is None else _pad_bias(lens, sk, cuda, -1e4)
    drop = TA.drop_spec(p, -7, sq, sk, 64, 32)
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal, scale, drop)
    want_out, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal,
                                                      scale, drop)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)
    before = dict(TA.LAUNCHES)
    elem = dict(TA.ELEMENT_LOAD_LAUNCHES)
    got = TA.flash_attention_bwd(q, k, v, bias, want_out, want_lse, g,
                                 causal, scale, drop)
    assert TA.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert TA.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert TA.ELEMENT_LOAD_LAUNCHES == elem     # 16-byte rows throughout
    want = TA.flash_attention_bwd_plain(q, k, v, bias, want_out, want_lse,
                                        g, causal, scale, drop)
    _check_grads(got, want, dt)


@pytest.mark.cuda
def test_bf16_backward_is_bitwise_repeatable(cuda):
    """Two runs of the bf16 backward kernels on the same inputs (bias,
    dropout, packed segment ids) give the same bits: no atomics, a fixed
    order of every sum."""
    b, h, s, d = 2, 3, 320, 64
    seg = _segment_ids([[100, 60, 160], [200, 120]], cuda)
    q, k, v, g = (_rand((b, s, h, d), 90 + i, cuda, torch.bfloat16)
                  .transpose(1, 2) for i in range(4))
    bias = (_rand((b, s), 94, cuda) * 0.5).contiguous()
    drop = TA.drop_spec(0.1, 3, s, s)
    for ids in ({}, dict(segment_ids=seg)):
        out, lse = TA.flash_attention_fwd(q, k, v, bias, False, None, drop,
                                          **ids)
        runs = [TA.flash_attention_bwd(q, k, v, bias, out, lse, g, False,
                                       None, drop, **ids) for _ in range(2)]
        for a, w in zip(*runs):
            assert torch.equal(a, w)


@pytest.mark.cuda
def test_bf16_backward_copies_unaligned_views_by_element(cuda):
    """Views whose rows do not all start on 16 bytes (a head dim of 36; a
    row stride of 132 elements; a base 8 bytes past 16) run the same
    tensor-core kernels with element-by-element tile copies, counted in
    ELEMENT_LOAD_LAUNCHES (the C entry points' own rule,
    `pt_flash_bwd_vector_loads`), and match the plain version; aligned
    views (d 64 strided, d 32 contiguous) are not counted."""
    b, h, s = 2, 2, 150
    bf = torch.bfloat16
    odd_d = [_rand((b, h, s, 36), 100 + i, cuda, bf) for i in range(4)]
    wide = [_rand((b, s, 132), 110 + i, cuda, bf)[..., :128]
            .view(b, s, h, 64).transpose(1, 2) for i in range(4)]
    aligned = [_rand((b, s, h, 64), 120 + i, cuda, bf).transpose(1, 2)
               for i in range(4)]
    numel = b * h * s * 64
    shifted = aligned[:2] + [_rand((numel + 8,), 124, cuda, bf)
                             [4:4 + numel].view(b, h, s, 64), aligned[3]]
    assert shifted[2].data_ptr() % 16 == 8
    d32 = [_rand((b, h, s, 32), 130 + i, cuda, bf) for i in range(4)]
    bias = _pad_bias([150, 99], s, cuda, -1e4)
    drop = TA.drop_spec(0.1, 9, s, s)
    for views, counted in ((odd_d, 1), (wide, 1), (shifted, 1),
                           (aligned, 0), (d32, 0)):
        q, k, v, g = views
        out, lse = TA.flash_attention_fwd_plain(q, k, v, bias, True, None,
                                                drop)
        before = dict(TA.ELEMENT_LOAD_LAUNCHES)
        got = TA.flash_attention_bwd(q, k, v, bias, out, lse, g, True, None,
                                     drop)
        assert {n: TA.ELEMENT_LOAD_LAUNCHES[n] - before[n]
                for n in before} == {"flash_fwd": 0,
                                     "flash_bwd_dq": counted,
                                     "flash_bwd_dkv": counted}
        want = TA.flash_attention_bwd_plain(q, k, v, bias, out, lse, g,
                                            True, None, drop)
        _check_grads(got, want, bf)


def _segment_ids(lens_rows, dev):
    """[b, s] non-decreasing segment ids from per-row segment lengths."""
    rows = [torch.cat([torch.full((n,), i, dtype=torch.int32)
                       for i, n in enumerate(lens)]) for lens in lens_rows]
    return torch.stack(rows).to(dev)


# b, h, d, causal, key bias, dropout_p, dtype, query segment lengths per
# row, key segment lengths per row (None: the query's). Segments shorter
# than, straddling and spanning several 64-token tiles; a one-token
# segment; a trailing pad segment (the `pack_padded` layout)
_SEG = {
    "fp32_plain": (2, 2, 64, False, False, 0.0, torch.float32,
                   [[100, 60, 96], [200, 40, 16]], None),
    "fp32_causal_bias_dropout": (2, 3, 64, True, True, 0.1, torch.float32,
                                 [[1, 129, 70, 56], [64, 64, 128]], None),
    "d128_many_small": (1, 2, 128, False, True, 0.2, torch.float32,
                        [[7, 13, 30, 1, 64, 65, 20, 10]], None),
    "kv_ids_differ": (2, 2, 32, False, True, 0.0, torch.float32,
                      [[50, 40, 38], [70, 58]], [[60, 100, 32], [90, 102]]),
    "bf16_packed_rows_dropout": (2, 2, 64, False, False, 0.1,
                                 torch.bfloat16,
                                 [[300, 200, 400, 124], [700, 250, 74]],
                                 None),
    "bf16_kv_ids_differ_causal": (2, 2, 64, True, True, 0.1, torch.bfloat16,
                                  [[50, 40, 38], [70, 58]],
                                  [[60, 100, 32], [90, 102]]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SEG))
def test_flash_segment_branch_matches_plain(cuda, case):
    """The segment-id branch of the three flash kernels against their
    plain versions, forward and backward; each launch is counted as a
    segment-branch launch."""
    b, h, d, causal, has_bias, p, dt, qlens, klens = _SEG[case]
    seg = _segment_ids(qlens, cuda)
    kseg = None if klens is None else _segment_ids(klens, cuda)
    sq = seg.shape[1]
    sk = sq if kseg is None else kseg.shape[1]
    q = _rand((b, sq, h, d), 51, cuda, dt).transpose(1, 2)    # strided
    k = _rand((b, h, sk, d), 52, cuda, dt)
    v = _rand((b, sk, h, d), 53, cuda, dt).transpose(1, 2)
    g = _rand((b, h, sq, d), 54, cuda, dt)
    bias = (_rand((b, sk), 55, cuda) * 0.5).contiguous() if has_bias \
        else None
    drop = TA.drop_spec(p, 11, sq, sk)
    ids = dict(segment_ids=seg, kv_segment_ids=kseg)
    before = dict(TA.SEG_LAUNCHES)
    out, lse = TA.flash_attention_fwd(q, k, v, bias, causal, None, drop,
                                      **ids)
    want_out, want_lse = TA.flash_attention_fwd_plain(
        q, k, v, bias, causal, None, drop, **ids)
    rtol, atol = TOL[dt]
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=2e-5)
    got = TA.flash_attention_bwd(q, k, v, bias, want_out, want_lse, g,
                                 causal, None, drop, **ids)
    want = TA.flash_attention_bwd_plain(q, k, v, bias, want_out, want_lse,
                                        g, causal, None, drop, **ids)
    assert {n: TA.SEG_LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    _check_grads(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_segment_branch_has_no_cross_segment_leakage(cuda, dt):
    """Other segments' q, k, v and dO leave a segment's output, dq, dk
    and dv bitwise unchanged on the card."""
    b, h, d = 2, 2, 64
    seg = _segment_ids([[130, 300, 94], [64, 400, 60]], cuda)
    s = seg.shape[1]
    base = [_rand((b, h, s, d), 60 + i, cuda, dt) for i in range(4)]
    moved = [t.clone() for t in base]
    other = (seg != 1)[:, None, :, None]            # all but segment 1
    for i, t in enumerate(moved):
        t.copy_(torch.where(other, 50 * _rand(t.shape, 70 + i, cuda, dt), t))

    def run(q, k, v, g):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        out = TA.flash_attention(*ts, None, True, None, dropout_p=0.1,
                                 dropout_seed=5, segment_ids=seg)
        out.backward(g)
        return [out.detach()] + [t.grad for t in ts]

    keep = (seg == 1)[:, None, :, None].expand(b, h, s, d)
    for a, w in zip(run(*base), run(*moved)):
        assert torch.equal(a[keep], w[keep])


@pytest.mark.cuda
def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    """The autograd Function on the card against the same Function on
    the CPU (plain versions): outputs and every gradient, dropout on.
    The dropout bits are a hash, so both devices drop the same logits."""
    b, h, s, d = 2, 2, 160, 64
    lens = [160, 97]
    res = {}
    for dev in ("cpu", cuda):
        q, k, v, g = (_rand((b, h, s, d), 30 + i, dev).requires_grad_(i < 3)
                      for i in range(4))
        bias = _pad_bias(lens, s, dev, -1e4).requires_grad_()
        out = TA.flash_attention(q, k, v, bias, False, None, dropout_p=0.1,
                                 dropout_seed=123)
        (out * g).sum().backward()
        res[str(dev)] = [t.detach().cpu() for t in
                         (out, q.grad, k.grad, v.grad, bias.grad)]
    for a, w in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_card_paths_never_reach_a_plain_version(cuda, monkeypatch):
    """With every plain version (and torch's SDPA) made to raise, a bf16
    ERNIE train step with dropout and a decode step still run on the
    card: the wrappers launch the kernels and nothing else."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
                 "flash_decode_plain", "_decode_partials_plain",
                 "flash_verify_plain", "_verify_partials_plain",
                 "paged_flash_decode_plain", "paged_flash_verify_plain",
                 "_paged_partials_plain", "paged_gather_kv",
                 "sdpa_reference", "dropout_keep_reference",
                 "verify_attention_reference"):
        monkeypatch.setattr(TA, name, boom)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        boom)
    model = ErnieForSequenceClassification(
        ErnieConfig.tiny(), device=cuda,
        generator=torch.Generator().manual_seed(0))
    tr = SpmdTrainer(model, lambda out, y: torch.nn.functional.cross_entropy(
        out.float(), y), fopt.adamw(1e-3), compute_dtype="bfloat16",
        device=cuda)
    ids = torch.randint(1, 1024, (2, 96), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones(2, 96)
    mask[1, 60:] = 0
    TA.reset_launches()
    loss = tr.step((ids, torch.zeros_like(ids), mask), torch.tensor([0, 1]))
    assert torch.isfinite(loss).item()
    assert TA.LAUNCHES["flash_fwd"] == 2          # one per layer
    assert TA.LAUNCHES["flash_bwd_dq"] == 2
    assert TA.LAUNCHES["flash_bwd_dkv"] == 2
    q = _rand((2, 2, 1, 32), 40, cuda)
    kv = _rand((2, 2, 80, 32), 41, cuda)
    TA.decode_attention(q, kv, kv, torch.tensor([80, 7], device=cuda))
    assert TA.LAUNCHES["flash_decode"] == 1
    length = torch.tensor([80, 7], dtype=torch.int32, device=cuda)
    TA.verify_attention(_rand((2, 2, 3, 32), 42, cuda), kv, kv, length)
    assert TA.LAUNCHES["flash_verify"] == 1
    for T, name in ((1, "paged_flash_decode"), (3, "paged_flash_verify")):
        q, kp, vp, ks, vs, table, length, bias = _paged_case(
            2, 2, 16, 5, 32, T, [70, 9], torch.float32, torch.int8, cuda)
        fn = (TA.paged_decode_attention if T == 1 else
              TA.paged_verify_attention)
        fn(q, kp, vp, ks, vs, table, length, bias[:, None, None, :])
        assert TA.LAUNCHES[name] == 1


@pytest.mark.cuda
def test_packed_ernie_step_runs_the_segment_branch_only(cuda, monkeypatch):
    """A bf16 ERNIE train step on `pack_padded` rows (dropout on) with
    every plain version made to raise: each layer launches the three
    kernels once, all through the segment branch."""
    from paddle_tpu_torch.core.lod import pack_padded
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
                 "sdpa_reference", "dropout_keep_reference"):
        monkeypatch.setattr(TA, name, boom)
    model = ErnieForSequenceClassification(
        ErnieConfig.tiny(), device=cuda,
        generator=torch.Generator().manual_seed(0))
    tr = SpmdTrainer(model, lambda out, y: torch.nn.functional.cross_entropy(
        out.float(), y), fopt.adamw(1e-3), compute_dtype="bfloat16",
        device=cuda)
    lens = [90, 20, 64, 33, 120, 7]
    ids = torch.randint(1, 1024, (len(lens), 128),
                        generator=torch.Generator().manual_seed(2)).numpy()
    pk = pack_padded(ids, lens, row_len=128)
    inputs = (pk.data, None, None, pk.positions.astype("int64"),
              pk.segment_ids, pk.cls_flat_index().astype("int64"))
    TA.reset_launches()
    loss = tr.step(inputs, torch.tensor([0, 1, 1, 0, 1, 0]))
    assert torch.isfinite(loss).item()
    want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert TA.SEG_LAUNCHES == want
    assert {n: TA.LAUNCHES[n] for n in want} == want


# m, d, n, x dtype: decode and verify steps (the skinny path, m <= 32,
# d split across blocks where n gives few column strips), the vocabulary
# projection (n = 37000, rows 8- but not 16-byte aligned), prefill tiles
# with ragged edges on every side
_I8 = {
    "decode_m8_512x2048": (8, 512, 2048, torch.float32),
    "decode_m8_2048x512_split_d": (8, 2048, 512, torch.float32),
    "m1_ragged_n37": (1, 100, 37, torch.float32),
    "m17_odd_n1001": (17, 300, 1001, torch.float32),
    "verify_m32_vocab": (32, 512, 37000, torch.float32),
    "m33_tiled_edges": (33, 70, 130, torch.float32),
    "prefill_m1024_2048x512": (1024, 2048, 512, torch.float32),
    # the tiled path on the tensor cores: the vocabulary projection's
    # weight rows on 8 bytes (8-byte copies), n = 2048 (16-byte), n a
    # multiple of 4 only (4-byte), an odd n and d (byte and 4-byte
    # copies), a bf16 x at a prompt bucket
    "prefill_m1024_512x37000": (1024, 512, 37000, torch.float32),
    "prefill_m1024_512x2048": (1024, 512, 2048, torch.float32),
    "m130_n36_4byte_rows": (130, 256, 36, torch.float32),
    "m77_odd_d301_n1001": (77, 301, 1001, torch.float32),
    "bf16_m1024_512x2048": (1024, 512, 2048, torch.bfloat16),
    "d3_tiny_depth": (40, 3, 65, torch.float32),
    "bf16_m8": (8, 512, 512, torch.bfloat16),
    "bf16_m200": (200, 512, 512, torch.bfloat16),
}
REL_QUANT = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    limit = rel * want.float().abs().max().item()
    assert err <= limit, f"max |kernel - plain| {err} > {limit}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_I8))
def test_int8_matmul_kernel_matches_plain(cuda, case):
    m, d, n, dt = _I8[case]
    x = _rand((m, d), 50, cuda, dt)
    q, scale = TQ.quantize_int8_weight(_rand((d, n), 51, cuda) * 0.05)
    bias = _rand((n,), 52, cuda)
    before = TQ.LAUNCHES["int8_matmul"]
    got = TQ.int8_matmul(x, q, scale, bias)
    assert TQ.LAUNCHES["int8_matmul"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    _rel_close(got, TQ.int8_matmul_reference(x, q, scale, bias),
               REL_QUANT[dt])


# b, s, d, r, n, capacity, ids, x dtype
_LORA = {
    "decode_b8_s1": (8, 1, 512, 8, 2048, 5, [0, 1, 2, 3, 4, 0, 2, 4],
                     torch.float32),
    "verify_b8_s4": (8, 4, 2048, 8, 512, 5, [4, 3, 2, 1, 0, 1, 0, 3],
                     torch.float32),
    "prefill_b1_s1024": (1, 1024, 512, 8, 2048, 5, [3], torch.float32),
    "rank32_ragged": (3, 37, 100, 32, 300, 4, [1, 0, 3], torch.float32),
    "rank1": (2, 5, 64, 1, 33, 2, [1, 1], torch.float32),
    "bf16_b8_s4": (8, 4, 512, 8, 512, 5, [0, 1, 2, 3, 4, 4, 3, 2],
                   torch.bfloat16),
    # the cluster kernel: a ragged last row tile (1000 = 62 x 16 + 8), a d
    # that is no multiple of the clusters' d slices (1000 over 16 CTAs of
    # 64: the last gets 40), an odd d and n (element copies), the decode
    # join of the down projection
    "join_b1_s1000_ragged": (1, 1000, 512, 8, 2048, 5, [3], torch.float32),
    "d1000_ragged_slices": (2, 4, 1000, 8, 512, 3, [1, 2], torch.float32),
    "odd_d1001_n61": (3, 5, 1001, 8, 61, 4, [3, 0, 1], torch.float32),
    "decode_b8_s1_2048x512": (8, 1, 2048, 8, 512, 5,
                              [0, 1, 2, 3, 4, 0, 2, 4], torch.float32),
}


def _banks(cap, d, r, n, dev):
    A = _rand((cap, d, r), 60, dev) * 0.05
    B = _rand((cap, r, n), 61, dev) * 0.05
    A[0] = 0.0
    B[0] = 0.0
    return A, B


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_LORA))
def test_lora_gather_kernel_matches_plain(cuda, case):
    b, s, d, r, n, cap, ids, dt = _LORA[case]
    x = _rand((b, s, d), 62, cuda, dt)
    A, B = _banks(cap, d, r, n, cuda)
    before = TQ.LAUNCHES["lora_gather"]
    got = TQ.lora_delta(x, A, B, ids)
    assert TQ.LAUNCHES["lora_gather"] == before + 1
    assert got.dtype == dt and got.shape == (b, s, n)
    _rel_close(got, TQ.lora_delta_reference(x, A, B, ids), REL_QUANT[dt])
    for i, row in enumerate(ids):
        if row == 0:                     # the base row: an exact zero
            assert torch.count_nonzero(got[i]).item() == 0


@pytest.mark.cuda
def test_lora_gather_cluster_sum_is_bitwise_repeatable(cuda):
    """The clusters add their CTAs' partial xa in rank order (no atomics):
    two launches give the same bits, at a shape split over 16 CTAs."""
    x = _rand((8, 1, 2048), 63, cuda)
    A, B = _banks(5, 2048, 8, 512, cuda)
    ids = [0, 1, 2, 3, 4, 0, 2, 4]
    assert torch.equal(TQ.lora_delta(x, A, B, ids),
                       TQ.lora_delta(x, A, B, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail_pattach_T64_f32",
                                  "tail_T64_int8_no_seed"])
def test_tiled_paged_verify_is_bitwise_repeatable(cuda, case):
    """The last block of a query tile merges the key splits' partials in
    split order, whichever block arrives last: two launches give the same
    bits."""
    args = _paged_case(*_PAGED[case], cuda)
    assert torch.equal(TA.paged_flash_verify(*args),
                       TA.paged_flash_verify(*args))


@pytest.mark.cuda
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _rand((2, 3, 16), 70, cuda)
    A, B = _banks(3, 16, 4, 8, cuda)
    nan_x = x.clone()
    nan_x[1, 0, 0] = float("nan")
    out = TQ.lora_delta(nan_x, A, B, [1, 0])  # id 0 is computed, not skipped
    assert torch.isnan(out[1, 0]).all() and not torch.isnan(out[0]).any()
    for bad in ([0, 3], [-1, 0]):
        with pytest.raises(ValueError, match="outside"):
            TQ.lora_delta(x, A, B, bad)
    with pytest.raises(ValueError, match="outside"):
        TQ.lora_delta(x, A, B, torch.tensor([0, 5], device=cuda))
    wide = _rand((3, 16, 33), 71, cuda)
    with pytest.raises(ValueError, match="rank 33"):
        TQ.lora_delta(x, wide, _rand((3, 33, 8), 72, cuda), [0, 1])
    q, scale = TQ.quantize_int8_weight(_rand((16, 8), 73, cuda))
    with pytest.raises(ValueError, match="on different devices"):
        TQ.int8_matmul(x, q.cpu(), scale)
    with pytest.raises(ValueError, match="int8"):
        TQ.int8_matmul(x, q.float(), scale)


# B, Ci, Co, HW, relu, norm, x dtype, w dtype: a ResNet-50 conv1 shape,
# ragged HW (no multiple of the 64-column tile), Co / Ci not multiples of
# the 64-row tile, the identity, a mixed-type product, a dW split over
# many k-ranges, and a product smaller than one tile
_FC = {
    "resnet_conv1_b2_bf16": (2, 256, 64, 3136, True, True, torch.bfloat16,
                             torch.bfloat16),
    "hw49_f32": (3, 40, 70, 49, True, True, torch.float32, torch.float32),
    "identity_f32": (2, 16, 8, 200, False, False, torch.float32,
                     torch.float32),
    "relu_no_norm_bf16": (2, 33, 65, 77, True, False, torch.bfloat16,
                          torch.bfloat16),
    "mixed_bf16x_f32w": (2, 64, 32, 196, True, True, torch.bfloat16,
                         torch.float32),
    "split_dw_f32": (8, 64, 256, 784, True, True, torch.float32,
                     torch.float32),
    "tiny_f32": (1, 3, 5, 7, True, True, torch.float32, torch.float32),
}
# of the plain version's largest entry: float32 z and dx, then the float32
# stats, dW, dscale and dshift (in the bf16 cases too). A bf16 z or dx is
# held to `judge_bf16_sum` against its sums of |products|.
REL_FC = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (None, 1e-4)}


def _fc_close(got, want, near, abs_sum):
    if near is not None:
        _rel_close(got, want, near)
        return
    nums, misses = judge_bf16_sum(got, want, abs_sum)
    assert not misses, nums


def _fc_case(B, Ci, Co, HW, norm, xdt, wdt, dev, seed=80):
    x = _rand((B, Ci, HW), seed, dev, xdt)
    sc = (_rand((Ci,), seed + 1, dev).abs() + 0.5) if norm else None
    sh = _rand((Ci,), seed + 2, dev) * 0.1 if norm else None
    w = (_rand((Co, Ci), seed + 3, dev) * Ci ** -0.5).to(wdt)
    dz = _rand((B, Co, HW), seed + 4, dev, xdt)
    ds = _rand((Co,), seed + 5, dev)
    dss = _rand((Co,), seed + 6, dev) * 0.01
    return x, sc, sh, w, dz, ds, dss


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_FC))
def test_fused_conv_kernels_match_plain(cuda, case):
    B, Ci, Co, HW, relu, norm, xdt, wdt = _FC[case]
    x, sc, sh, w, dz, ds, dss = _fc_case(B, Ci, Co, HW, norm, xdt, wdt, cuda)
    before = dict(TFC.LAUNCHES)
    routes = dict(TFC.ROUTE_LAUNCHES)
    got = TFC._fwd_cuda(x, sc, sh, w, relu)
    want = TFC.fused_fwd_reference(x, sc, sh, w, relu)
    assert TFC.LAUNCHES["fused_conv_fwd"] == before["fused_conv_fwd"] + 1
    assert got[0].dtype == xdt and got[0].shape == (B, Co, HW)
    near, far = REL_FC[xdt]
    z = want[0]                  # both backward versions read one stored z
    abs_z, abs_dx = fused_conv_abs_sums(x, sc, sh, w, z, dz, ds, dss, relu)
    _fc_close(got[0], want[0], near, abs_z)
    _rel_close(got[1], want[1], far)
    _rel_close(got[2], want[2], far)
    got = TFC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss, relu)
    want = TFC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss, relu)
    assert TFC.LAUNCHES["fused_conv_bwd"] == before["fused_conv_bwd"] + 1
    dx_route, dw_route = TFC.bwd_routes(xdt, wdt)
    assert {k: TFC.ROUTE_LAUNCHES[k] - routes[k] for k in routes} == {
        f"{k}:{r}": int(r == route)
        for k, route in (("fused_conv_fwd", TFC.fwd_route(xdt, wdt)),
                         ("fused_conv_bwd_dx", dx_route),
                         ("fused_conv_bwd_dw", dw_route))
        for r in ("wgmma", "simt")}
    assert got[0].dtype == xdt and got[1].dtype == torch.float32
    _fc_close(got[0], want[0], near, abs_dx)
    for g, wv in zip(got[1:], want[1:]):
        if norm or g is got[1]:
            _rel_close(g, wv, far)
        else:
            assert not g.any()         # no norm: dscale = dshift = 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 64, 3136), (2, 512, 2048, 49),
                                   (3, 72, 136, 196), (2, 40, 70, 49)])
def test_fused_conv_wgmma_routes_meet_the_sum_limit(cuda, shape):
    """bf16 x and W: the forward's product and the backward's dx run on
    wgmma (the route counters say so) and their bf16 z and dx meet
    `judge_bf16_sum`; the plain versions with xn or dz_eff left
    unrounded do not (ResNet-50 conv shapes at batch 2, ragged ones)."""
    B, Ci, Co, HW = shape
    x, sc, sh, w, dz, ds, dss = _fc_case(B, Ci, Co, HW, True, torch.bfloat16,
                                         torch.bfloat16, cuda, seed=81)
    TFC.reset_launches()
    z = TFC._fwd_cuda(x, sc, sh, w)[0]
    dx = TFC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss)[0]
    assert TFC.ROUTE_LAUNCHES["fused_conv_fwd:wgmma"] == 1
    assert TFC.ROUTE_LAUNCHES["fused_conv_bwd_dx:wgmma"] == 1
    assert TFC.ROUTE_LAUNCHES["fused_conv_bwd_dw:wgmma"] == 1
    want_z = TFC.fused_fwd_reference(x, sc, sh, w)[0]
    want_dx = TFC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss)[0]
    abs_z, abs_dx = fused_conv_abs_sums(x, sc, sh, w, z, dz, ds, dss)
    for got, want, a in ((z, want_z, abs_z), (dx, want_dx, abs_dx)):
        nums, misses = judge_bf16_sum(got, want, a)
        assert not misses, nums
    bad_z, bad_dx = fused_conv_mutants(x, sc, sh, w, z, dz, ds, dss)
    for bad, want, a in ((bad_z, want_z, abs_z), (bad_dx, want_dx, abs_dx)):
        assert judge_bf16_sum(bad, want, a)[1]


@pytest.mark.cuda
def test_fused_conv_kernels_are_deterministic_and_checked(cuda):
    """Partials are added in a fixed order: two runs agree bit for bit.
    The wrapper refuses what the kernels do not take."""
    x, sc, sh, w, dz, ds, dss = _fc_case(4, 96, 80, 300, True,
                                         torch.float32, torch.float32, cuda)
    a = TFC._fwd_cuda(x, sc, sh, w) + TFC._bwd_cuda(x, sc, sh, w,
                                                    x[:, :80], dz, ds, dss)
    b = TFC._fwd_cuda(x, sc, sh, w) + TFC._bwd_cuda(x, sc, sh, w,
                                                    x[:, :80], dz, ds, dss)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="different devices"):
        TFC.fused_scale_act_mm_stats(x, sc.cpu(), sh.cpu(), w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFC.fused_scale_act_mm_stats(x.half(), sc, sh, w)


@pytest.mark.cuda
def test_fused_conv_on_card_launches_kernels_and_matches_cpu(cuda,
                                                             monkeypatch):
    """With the plain versions made to raise, the differentiable op runs
    forward and backward on the card through the two kernels, and its
    values and gradients equal the CPU's (float32)."""
    args = _fc_case(2, 48, 40, 196, True, torch.float32, torch.float32,
                    torch.device("cpu"))
    x, sc, sh, w, dz, ds, dss = args

    def run(dev):
        ts = [t.detach().to(dev).requires_grad_() for t in (x, sc, sh, w)]
        z, s, ss = TFC.fused_scale_act_mm_stats(*ts, relu=True)
        ((z * dz.to(dev)).sum() + (s * ds.to(dev)).sum()
         + (ss * dss.to(dev)).sum()).backward()
        return [t.detach().cpu() for t in (z, s, ss)] + [
            t.grad.cpu() for t in ts]

    cpu = run("cpu")

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(TFC, "fused_fwd_reference", boom)
    monkeypatch.setattr(TFC, "fused_bwd_reference", boom)
    TFC.reset_launches()
    card = run(cuda)
    assert TFC.LAUNCHES["fused_conv_fwd"] == 1
    assert TFC.LAUNCHES["fused_conv_bwd"] == 1
    for i, (g, wv) in enumerate(zip(card, cpu)):
        _rel_close(g, wv, 1e-5 if i in (0, 3) else 1e-4)
