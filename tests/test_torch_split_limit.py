"""The float32 limits against the tensor-core operand split, on the CPU.

The float32 flash forward on the serving path runs its two products on
the tensor cores as 3xTF32 (`csrc/tf32_mma.cuh`: each operand split into
a TF32 big part and a TF32 remainder, three TF32 products), and the tiled
int8 matmul splits x into three bf16 pieces, each exact against an int8
weight. `paddle_tpu_torch.testing` has that arithmetic in plain PyTorch
(`tf32_round`, `split_matmul`, `flash_fwd_split`, `bf16_pieces`,
`int8_matmul_split`) with the number of pieces as an argument. Here, on
numpy inputs from a seed at narrow widths (the serving shapes' head dim
64, a few heads, short sequences):

(a) the pieces are what the kernels take: TF32 rounding is
    `cvt.rna.tf32.f32`'s (ties away from zero on the bit pattern), three
    bf16 pieces sum to any float32 in [2^-110, 2^120) exactly and each
    times any int8 weight is exact in float32;
(b) the 3-piece forward is within the float32 kernel limit of the plain
    version (atol 2e-5 on out and lse: `chip_smoke.py` ATOL_KERNEL) at a
    causal prefill with a pad bias, the decode step's 1 x S
    cross-attention, an encoder with a pad bias, a longer cross-attention
    and a 16-row query, and of the JAX package's Pallas kernel in
    interpret mode; the 3-piece int8 product within 1e-5 of the plain
    version's largest entry (REL_F32_QUANT), and of the JAX kernel's;
(c) the 1-piece mutants (one TF32 pass; a bf16 x) are refused by the same
    limits at every case, so the limits tell the split from plain TF32 or
    bf16;
(d) the design-step variants of tools/probe_tf32_forward.py still find
    their anchors in the kernels' sources;
(e) the skinny int8 route (m <= 32: decode and verify steps, three bf16
    pieces on `mma.sync`) at every m 8 and m 32 shape of the serving
    stack (the decoder's 512x512, 512x2048 and 2048x512, the vocabulary's
    512x37000) and at the edges m 1, 16, 17: the three pieces within the
    limit, the one-piece mutant refused at every case.
"""
import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import quant as JQ
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import quant as TQ
from paddle_tpu_torch.testing import (bf16_pieces, flash_fwd_split,
                                      int8_matmul_split, split_matmul,
                                      tf32_round)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import probe_tf32_forward  # noqa: E402

torch.set_num_threads(2)
#: the float32 flash kernel's limit (absolute, out and lse) and the int8
#: matmul's (of the plain version's largest entry)
ATOL_FWD, REL_INT8 = 2e-5, 1e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pad_bias(b, sk, lens):
    bias = np.zeros((b, sk), np.float32)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e30
    return bias


# ------------------------------------------------------------ (a) pieces


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),        # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 2.0 ** -12, 1.0),                    # below the tie: down
    (1 + 3 * 2.0 ** -12, 1 + 2.0 ** -10),     # above it: up
    (2 - 2.0 ** -12, 2.0),                    # a carry into the exponent
    (float("inf"), float("inf")), (0.0, 0.0)])
def test_tf32_round_is_round_to_nearest_ties_away(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


#: float32 values whose pieces stay normal and whose products with an
#: int8 weight stay finite: below 2^-110 the last piece of either split
#: loses bits under the smallest normal's step, at 2^120 times 128 the
#: product reaches float32's largest binade
_NORMALS = st.floats(min_value=2.0 ** -110, max_value=2.0 ** 120,
                     exclude_max=True, width=32)


@settings(max_examples=300, deadline=None)
@given(_NORMALS, st.booleans())
def test_tf32_split_drops_at_most_2_to_the_minus_22(x, neg):
    """big + small (both TF32, low 13 bits clear) is within 2^-22 of x:
    the remainder x - big is exact, its own rounding drops at most half a
    TF32 step of it."""
    x = -x if neg else x
    t = torch.tensor([x], dtype=torch.float32)
    big = tf32_round(t)
    small = tf32_round(t - big)
    for p in (big, small):
        assert int(p.view(torch.int32).item()) & 0x1FFF == 0
    err = abs(big.double().item() + small.double().item() - t.item())
    assert err <= 2.0 ** -22 * abs(t.item())


@settings(max_examples=500, deadline=None)
@given(_NORMALS, st.booleans())
def test_three_bf16_pieces_are_x_and_exact_times_any_int8(x, neg):
    x = -x if neg else x
    t = torch.tensor([x], dtype=torch.float32)
    hi, mid, lo = bf16_pieces(t, 3)
    assert hi.double().item() + mid.double().item() + lo.double().item() \
        == float(t.double().item())
    w = torch.arange(-128, 128, dtype=torch.float32)
    for p in (hi, mid, lo):
        prod32 = (p.float() * w).double()
        assert torch.equal(prod32, p.double() * w.double())


# ------------------------------------------- (b), (c) the flash forward

# b, h, sq, sk, causal, key lengths (None = no bias); d = 64
_FWD = {
    "causal_prefill_pad_bias": (1, 2, 128, 128, True, [100]),
    "decode_cross_1xS": (4, 2, 1, 64, False, None),
    "encoder_pad_bias": (2, 2, 64, 64, False, [64, 40]),
    "cross_64x48": (1, 2, 64, 48, False, None),
    "short_q16_pad_bias": (2, 2, 16, 200, False, [150, 200]),
}
#: the JAX kernel's (block_q, block_k): blocks that tile each case
_JAX_BLOCKS = {"cross_64x48": (32, 16), "short_q16_pad_bias": (16, 40)}


def _fwd_inputs(case):
    b, h, sq, sk, causal, lens = _FWD[case]
    q, k, v = (_rand((b, h, sq, 64), 1), _rand((b, h, sk, 64), 2),
               _rand((b, h, sk, 64), 3))
    bias = None if lens is None else _pad_bias(b, sk, lens)
    return q, k, v, bias, causal


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _fwd_err(case, pieces):
    q, k, v, bias, causal = (_t(x) if isinstance(x, np.ndarray) or x is None
                             else x for x in _fwd_inputs(case))
    out, lse = flash_fwd_split(q, k, v, bias, causal, None, pieces)
    want, want_lse = TA.flash_attention_fwd_plain(q, k, v, bias, causal)
    return max((out - want).abs().max().item(),
               (lse - want_lse).abs().max().item())


@pytest.mark.parametrize("case", sorted(_FWD))
def test_three_piece_forward_is_within_the_float32_limit(case):
    assert _fwd_err(case, 3) <= ATOL_FWD


@pytest.mark.parametrize("case", sorted(_FWD))
def test_one_piece_forward_is_refused(case):
    """One TF32 pass moves out or lse past 2e-5 at every case (the limit
    has teeth against plain TF32)."""
    assert _fwd_err(case, 1) > ATOL_FWD


@pytest.mark.parametrize("case", sorted(_FWD))
def test_three_piece_forward_matches_the_jax_kernel(case):
    import jax.numpy as jnp

    q, k, v, bias, causal = _fwd_inputs(case)
    j = (lambda x: None if x is None else jnp.asarray(x))
    bq, bk = _JAX_BLOCKS.get(case, (32, 32))
    j_out, j_lse = JA.flash_attention_fwd(
        j(q), j(k), j(v), j(bias), causal, block_q=bq, block_k=bk,
        interpret=True)
    out, lse = flash_fwd_split(_t(q), _t(k), _t(v), _t(bias), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=ATOL_FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=0,
                               atol=ATOL_FWD)


def test_split_matmul_refuses_other_piece_counts():
    with pytest.raises(ValueError):
        split_matmul(torch.ones(2, 2), torch.ones(2, 2), 2)


# ------------------------------------------------ (b), (c) the int8 matmul

# m, d, n: prompt buckets through the decoder's and the vocabulary's
# shapes, ragged edges
_I8 = {
    "m64_512x300": (64, 512, 300),
    "m40_96x37": (40, 96, 37),
    "m200_2048x512": (200, 2048, 512),
    "m33_70x130": (33, 70, 130),
}


def _i8_inputs(case, seed=5):
    m, d, n = _I8[case]
    x = _rand((m, d), seed)
    w = _rand((d, n), seed + 1) * 0.05
    q, scale = TQ.quantize_int8_weight(torch.from_numpy(w))
    return torch.from_numpy(x), q, scale


def _i8_rel(case, pieces):
    x, q, scale = _i8_inputs(case)
    want = TQ.int8_matmul_reference(x, q, scale)
    got = int8_matmul_split(x, q, scale, pieces)
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("case", sorted(_I8))
def test_three_piece_int8_product_is_within_the_float32_limit(case):
    assert _i8_rel(case, 3) <= REL_INT8


@pytest.mark.parametrize("case", sorted(_I8))
def test_one_piece_int8_product_is_refused(case):
    """A bf16 x (one piece) moves the product past 1e-5 of its largest
    entry at every case."""
    assert _i8_rel(case, 1) > REL_INT8


@pytest.mark.parametrize("case", sorted(_I8))
def test_three_piece_int8_product_matches_the_jax_kernel(case):
    import jax.numpy as jnp

    x, q, scale = _i8_inputs(case)
    want = np.asarray(JQ.int8_matmul(
        jnp.asarray(x.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(scale.numpy()), None, interpret=True))
    got = int8_matmul_split(x, q, scale, 3).numpy()
    assert np.abs(got - want).max() <= REL_INT8 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(probe_tf32_forward.VARIANTS))
def test_probe_variants_still_apply_to_the_kernel(name):
    """tools/probe_tf32_forward.py builds each design-step variant from
    one anchored edit of the sources: every anchor is still found exactly
    once, and the edit changes the text."""
    texts = probe_tf32_forward.variant_sources(name)
    for fname, text in texts.items():
        with open(os.path.join(probe_tf32_forward.CSRC, fname)) as f:
            assert f.read() != text


# --------------------------------------- (e) the skinny int8 route (m <= 32)

#: m, d, n: the decode step (m 8) and the spec verify step (m 32) over the
#: serving stack's weights, and the route's edges
_I8_SKINNY = {
    **{f"m{m}_{d}x{n}": (m, d, n) for m in (8, 32)
       for d, n in ((512, 512), (512, 2048), (2048, 512), (512, 37000))},
    "m1_100x37": (1, 100, 37), "m16_300x1001": (16, 300, 1001),
    "m17_2048x130": (17, 2048, 130),
}


def _skinny_rel(case, pieces, seed=11):
    m, d, n = _I8_SKINNY[case]
    x = torch.from_numpy(_rand((m, d), seed))
    q, scale = TQ.quantize_int8_weight(torch.from_numpy(
        _rand((d, n), seed + 1) * 0.05))
    want = TQ.int8_matmul_reference(x, q, scale)
    got = int8_matmul_split(x, q, scale, pieces)
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("case", sorted(_I8_SKINNY))
def test_three_piece_skinny_product_is_within_the_float32_limit(case):
    assert _skinny_rel(case, 3) <= REL_INT8


@pytest.mark.parametrize("case", sorted(_I8_SKINNY))
def test_one_piece_skinny_product_is_refused(case):
    """A bf16 x moves every decode and verify shape past 1e-5 of its
    largest entry: the limit tells the skinny route's split from a bf16
    x."""
    assert _skinny_rel(case, 1) > REL_INT8
