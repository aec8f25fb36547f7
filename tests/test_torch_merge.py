"""The in-kernel split merge of the dense decode, the dense verify and the
paged verify's split route (`csrc/attn_merge.cuh`), on the CPU.

`testing.merge_in_kernel` is the kernels' order of arithmetic in numpy
(key tiles, 16 groups of keys a block each with its own online softmax a
query row, the groups merged in group order and the key splits in rank
order). Here it is held to the plain versions, which keep the JAX
kernels' split-and-combine (partials of 128 keys): the dense decode
(`flash_decode_in_kernel` against `flash_decode_plain`: 1e-6 of the
largest entry in float32, 1e-2 in bf16, where p is rounded at each
group's running max rather than at a 128-key split's), the dense verify
(`flash_verify_in_kernel` against `flash_verify_plain` at T 1 to 12, the
same limits) and the split route
(`paged_verify_in_kernel` against `paged_flash_verify_plain` at T 2, 4, 5
and 8, float32, bf16 and int8 pages: 1e-6); and to the JAX kernels in
interpret mode (1e-5). The plans: `flash_decode_plan` (the C rule
`pt_flash_decode_plan` written out) splits whole 32-key steps over at
most 8 ranks, and another plan moves the output by at most 1e-6 of its
largest entry. The kernels themselves are held to the same readings on
the card by tests/test_torch_routes.py's `cuda` tests.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.testing import (dense_decode_case,
                                      dense_verify_case,
                                      flash_decode_in_kernel,
                                      flash_verify_in_kernel,
                                      paged_read_case,
                                      paged_verify_in_kernel)

BF, F32 = torch.bfloat16, torch.float32
KV = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

#: b, h, L, d, lengths, bias hole: a row with no written key, L no
#: multiple of a key tile (32 keys at d <= 64, 16 above), a -1e30 hole
#: that every row sees keys past, rows ending inside a split; d 40, 64 and
#: 128; the plan splits each row over several ranks
DENSE = {
    "length0_ragged_L_d64": (4, 2, 300, 64, [0, 300, 37, 161], (5, 30)),
    "hole_over_split0_d64": (3, 2, 256, 64, [256, 200, 129], (0, 128)),
    "d40_ragged": (3, 2, 200, 40, [1, 199, 77], (50, 60)),
    "d128_ragged": (2, 2, 150, 128, [150, 17], (3, 9)),
}


def _rel_err(got, want):
    return (got.float() - want.float()).abs().max().item() / \
        want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_dense_decode_emulation_equals_the_plain_version(case, dtype):
    """The kernel's order against the JAX split-and-combine: 1e-6 of the
    largest entry in float32 (the same function summed in another order),
    1e-2 in bf16 (p rounded at another running max); a row with no
    written key is exactly 0 on both sides."""
    b, h, L, d, lens, hole = DENSE[case]
    args = dense_decode_case(b, h, L, d, lens, dtype, hole)
    want = TA.flash_decode_plain(*args)
    got = flash_decode_in_kernel(*args)
    assert got.shape == want.shape == (b, h, 1, d)
    assert _rel_err(got, want) <= (1e-6 if dtype == F32 else 1e-2)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any() and not want[i].any()


@pytest.mark.parametrize("case", sorted(DENSE))
def test_dense_decode_emulation_equals_the_jax_kernel(case):
    """... and against the JAX Pallas decode in interpret mode on the
    same inputs, within 1e-5."""
    import jax.numpy as jnp

    b, h, L, d, lens, hole = DENSE[case]
    q, k, v, length, bias = dense_decode_case(b, h, L, d, lens, F32, hole)
    want = JA.flash_decode(*(jnp.asarray(x.numpy()) for x in
                             (q.contiguous(), k, v, length, bias)),
                           interpret=True)
    got = flash_decode_in_kernel(q, k, v, length, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


#: b, h, L, d, lengths after the block's write (None: the block's own T),
#: bias hole: a row whose block is all it holds (n_valid == T), L 1060 (the
#: speculative pool's max_len + spec_k, no multiple of a key tile), a
#: -1e30 hole that the longer rows see keys past; d 40, 64 and 128; the
#: plan splits each row over several ranks
VERIFY = {
    "L1060_d64": (3, 2, 1060, 64, [None, 1060, 517], (20, 40)),
    "d40_ragged": (2, 2, 300, 40, [None, 263], (50, 60)),
    "d128_ragged": (2, 2, 200, 128, [150, None], (3, 9)),
}


def _dense_verify_args(case, T, dtype):
    b, h, L, d, lens, hole = VERIFY[case]
    lens = [T if n is None else n for n in lens]
    return dense_verify_case(b, h, T, L, d, lens, dtype, hole, seed=90 + T)


@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 2, 4, 5, 8, 12])
@pytest.mark.parametrize("case", sorted(VERIFY))
def test_dense_verify_emulation_equals_the_plain_version(case, T, dtype):
    """The dense verify kernel's order (R query rows a block, each row's
    own online softmax over the keys it sees, the decode's plan) against
    the JAX split-and-combine: 1e-6 of the largest entry in float32, 1e-2
    in bf16 (p rounded at each group's running max)."""
    args = _dense_verify_args(case, T, dtype)
    want = TA.flash_verify_plain(*args)
    got = flash_verify_in_kernel(*args)
    assert got.shape == want.shape == args[0].shape
    assert _rel_err(got, want) <= (1e-6 if dtype == F32 else 1e-2)


@pytest.mark.parametrize("T", [4, 8])
def test_dense_verify_emulation_equals_the_jax_kernel(T):
    """... and against the JAX Pallas verify in interpret mode at T 4 (the
    speculative step) and 8, float32, within 1e-5."""
    import jax.numpy as jnp

    q, k, v, length, bias = _dense_verify_args("L1060_d64", T, F32)
    want = JA.flash_verify(*(jnp.asarray(x.numpy()) for x in
                             (q.contiguous(), k, v, length, bias)),
                           interpret=True)
    got = flash_verify_in_kernel(q, k, v, length, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _verify_case(T, kv, seed=80):
    """S 4, h 2, page 8, 12 pages (the H100 plan: 6 ranks of 2 pages), d
    64; slot 1 holds just the block (n_valid == T), slot 2's block ends
    inside a page, slot 3 fills its pages; trash and unmapped table
    entries past each slot's pages; a -1e30 hole over keys 0-15 that
    every row but slot 1's sees keys past."""
    return paged_read_case(4, 2, 8, 12, 64, T, [T + 40, T, 53, 96], KV[kv],
                           (0, 16), seed=seed + T)


@pytest.mark.parametrize("kv", sorted(KV))
@pytest.mark.parametrize("T", [2, 4, 5, 8])
def test_split_route_emulation_equals_the_plain_version(T, kv):
    """The split route's order (R query rows a block, each row's own
    online softmax over the keys it sees) against the JAX split-and-
    combine in float32: within 1e-6 of the largest entry. Slot 1's block
    (n_valid == T) sees only itself and the hole, so its rows are held
    without the hole."""
    args = list(_verify_case(T, kv))
    args[-1][1, :16] = 0.0
    want = TA.paged_flash_verify_plain(*args)
    got = paged_verify_in_kernel(*args)
    assert got.shape == want.shape == args[0].shape
    assert _rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_split_route_emulation_equals_the_jax_kernel(kv):
    """... and against the JAX Pallas paged verify in interpret mode at
    T 4 (the speculative step), within 1e-5 (the JAX kernel takes a
    trash-clipped table)."""
    import jax.numpy as jnp

    args = list(_verify_case(4, kv))
    args[-1][1, :16] = 0.0
    q, kp, vp, ks, vs, table, length, bias = args
    jtable = torch.where(table < 0, kp.shape[0] - 1, table)
    jx = [None if x is None else jnp.asarray(x.contiguous().numpy())
          for x in (q, kp, vp, ks, vs, jtable, length, bias)]
    want = JA.paged_flash_verify(*jx, interpret=True)
    got = paged_verify_in_kernel(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


#: (b, h, L) -> (splits = blocks a cluster, keys a split) on an H100 (132
#: SMs): the dense pool's decode step (8 slots x 8 heads over max_len 1056,
#: and the speculative pool's 1060), and the edges
DECODE_PLANS = {(8, 8, 1056): (7, 160), (8, 8, 1060): (7, 160),
                (1, 8, 1056): (7, 160), (16, 8, 1056): (4, 288),
                (64, 16, 1056): (1, 1056), (8, 8, 1): (1, 32),
                (8, 8, 100): (4, 32), (4, 2, 300): (5, 64)}


@pytest.mark.parametrize("b,h,L", sorted(DECODE_PLANS))
def test_flash_decode_plan_at_the_serving_shapes(b, h, L):
    assert TA.flash_decode_plan(b, h, L) == DECODE_PLANS[(b, h, L)]


@pytest.mark.parametrize("rows", [(1, 1), (1, 8), (8, 8), (16, 8),
                                  (64, 16)])
@pytest.mark.parametrize("sms", [132, 114])
def test_flash_decode_plan_splits_whole_tiles_over_a_cluster(rows, sms):
    """For every L from 1 to 1100: every rank gets a nonempty run of whole
    32-key steps (whole key tiles at d 64 and d 128) and the ranks cover
    the cache; at most 8 ranks; a split only while the rows alone leave
    the card short of three blocks an SM."""
    b, h = rows
    for L in range(1, 1101):
        c, keys = TA.flash_decode_plan(b, h, L, sms)
        assert keys % 32 == 0 and 1 <= c <= 8
        assert (c - 1) * keys < L <= c * keys
        if c > 1:
            assert (c - 1) * b * h < 3 * sms


@pytest.mark.parametrize("b,h,L", [(-1, 8, 4), (2, 0, 4), (2, 8, 0)])
def test_flash_decode_plan_refuses_empty_rows(b, h, L):
    with pytest.raises(ValueError, match="no plan"):
        TA.flash_decode_plan(b, h, L)


@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_dense_merge_follows_the_plan(dtype):
    """One rank or eight (one of them past every key): the same output
    within 1e-6 of the largest entry in float32 (the plan moves the order
    of the sums, not the function); in bf16 within the bf16 limit, 1e-2
    (a split restarts its groups' running maxima, at which p is
    rounded)."""
    args = dense_decode_case(2, 2, 600, 64, [600, 250], dtype, (0, 40))
    one = flash_decode_in_kernel(*args, plan=(1, 608))
    eight = flash_decode_in_kernel(*args, plan=(8, 96))
    assert _rel_err(eight, one) <= (1e-6 if dtype == F32 else 1e-2)


def test_split_route_merge_follows_the_plan():
    args = _verify_case(4, "fp32")
    one = paged_verify_in_kernel(*args, plan=(1, 12))
    four = paged_verify_in_kernel(*args, plan=(4, 3))
    assert _rel_err(four, one) <= 1e-6
