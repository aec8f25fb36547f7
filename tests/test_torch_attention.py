"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs (float32, from a seed) go to the JAX Pallas kernels
in interpret mode and to their references, and to the port's kernel
wrappers, which run their plain PyTorch versions on CPU tensors. fp32
throughout; rtol 1e-5 / atol 2e-5 (reordered float32 sums only). The
kernels themselves need the card: `test_torch_kernels.py` holds them
against the plain versions there, and `chip_smoke.py` does the same at
the serving shapes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as TA

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 2e-5


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pad_bias(b, sk, lens):
    bias = np.zeros((b, sk), np.float32)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e30
    return bias


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x, jnp.float32)


# b, h, sq, sk, d, causal, key lengths (None = no bias)
_FWD_CASES = {
    # prefill: causal + pad bias; row 0's real keys end inside the first
    # 32-key tile and every later tile is fully masked for it
    "prefill_masked_tiles": (2, 2, 128, 128, 32, True, [30, 128]),
    "prefill_no_bias": (1, 2, 64, 64, 16, True, None),
    "encoder_pad_bias": (3, 2, 64, 64, 32, False, [64, 40, 9]),
    "cross_attention": (2, 2, 32, 96, 32, False, None),
}


@pytest.mark.parametrize("case", sorted(_FWD_CASES))
def test_flash_fwd_plain_matches_jax_kernel(case):
    b, h, sq, sk, d, causal, lens = _FWD_CASES[case]
    q, k, v = (_rand((b, h, sq, d), 1), _rand((b, h, sk, d), 2),
               _rand((b, h, sk, d), 3))
    bias = None if lens is None else _pad_bias(b, sk, lens)
    j_out, j_lse = JA.flash_attention_fwd(
        _j(q), _j(k), _j(v), _j(bias), causal, block_q=32, block_k=32,
        interpret=True)
    t_out, t_lse = TA.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias),
                                          causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               rtol=RTOL, atol=ATOL)
    mask = None if bias is None else _j(bias)[:, None, None, :]
    ref = JA.sdpa_reference(_j(q), _j(k), _j(v), mask, causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("sq,sk", [(5, 9), (9, 9), (1, 7)])
def test_causal_aligns_at_the_end_like_the_reference(sq, sk):
    """The port's flash forward takes any sq / sk and keeps the
    reference's end-aligned causal diagonal (the TPU kernel refuses
    sq != sk)."""
    q, k, v = (_rand((2, 3, sq, 8), 4), _rand((2, 3, sk, 8), 5),
               _rand((2, 3, sk, 8), 6))
    ref = JA.sdpa_reference(_j(q), _j(k), _j(v), None, True)
    out, _ = TA.flash_attention_fwd(_t(q), _t(k), _t(v), None, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    ref_t = TA.sdpa_reference(_t(q), _t(k), _t(v), None, True)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_sdpa_dispatch_routes_key_bias_and_rich_masks():
    """A [b, 1, 1, sk] mask rides the flash forward; a per-query mask
    goes to the reference composition; both match the JAX dispatcher."""
    b, h, s, d = 2, 2, 16, 8
    q, k, v = (_rand((b, h, s, d), 7), _rand((b, h, s, d), 8),
               _rand((b, h, s, d), 9))
    key_bias = _pad_bias(b, s, [16, 5])[:, None, None, :]
    rich = np.where(np.tril(np.ones((s, s), bool)), 0.0,
                    -1e30).astype(np.float32)[None, None] + key_bias
    for mask in (key_bias, rich):
        want = JA.sdpa(_j(q), _j(k), _j(v), _j(mask))
        got = TA.sdpa(_t(q), _t(k), _t(v), _t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _decode_inputs(b=4, h=2, L=256, d=32):
    q, k, v = (_rand((b, h, 1, d), 10), _rand((b, h, L, d), 11),
               _rand((b, h, L, d), 12))
    # row 0's length ends before split 1 (splits of 128 keys); row 2
    # ends exactly at a split boundary; row 3 has one key in split 1
    lengths = np.asarray([50, 256, 128, 129], np.int32)
    bias = np.zeros((b, L), np.float32)
    bias[1, 20:100] = -1e30        # a pad hole inside the written region
    return q, k, v, lengths, bias


def test_flash_decode_matches_jax_kernel_and_reference():
    import jax.numpy as jnp

    q, k, v, lengths, bias = _decode_inputs()
    j_out = JA.flash_decode(_j(q), _j(k), _j(v),
                            jnp.asarray(lengths, jnp.int32), _j(bias),
                            split_k=2, interpret=True)
    j_ref = JA.decode_attention_reference(
        _j(q), _j(k), _j(v), jnp.asarray(lengths, jnp.int32), _j(bias))
    t_out = TA.flash_decode(_t(q), _t(k), _t(v), _t(lengths), _t(bias))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_ref), rtol=RTOL,
                               atol=ATOL)
    t_ref = TA.decode_attention_reference(_t(q), _t(k), _t(v), _t(lengths),
                                          _t(bias))
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), rtol=RTOL,
                               atol=ATOL)


def test_flash_decode_skip_value_and_ragged_cache():
    """A split entirely past a row's length emits the TPU kernel's skip
    value (acc 0, m -1e30, l 0); a cache length that is no multiple of
    the split still matches the reference."""
    q, k, v, lengths, bias = _decode_inputs()
    acc, m, l = TA._decode_partials_plain(
        _t(q), _t(k), _t(v), _t(lengths), _t(bias), None, 128)
    # rows are (batch, head) major: batch 0's two heads come first
    assert torch.all(acc[:2, 1] == 0) and torch.all(m[:2, 1] == -1e30)
    assert torch.all(l[:2, 1] == 0) and torch.all(l[:2, 0] > 0)
    L = 200
    out = TA.flash_decode(_t(q), _t(k[:, :, :L]), _t(v[:, :, :L]),
                          _t(np.minimum(lengths, L)), _t(bias[:, :L]))
    ref = JA.decode_attention_reference(
        _j(q), _j(k[:, :, :L]), _j(v[:, :, :L]),
        np.minimum(lengths, L).astype(np.int32), _j(bias[:, :L]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_wrappers_count_no_launch_on_cpu():
    TA.reset_launches()
    q, k, v, lengths, bias = _decode_inputs()
    TA.flash_decode(_t(q), _t(k), _t(v), _t(lengths), _t(bias))
    out, lse = TA.flash_attention_fwd(_t(k), _t(k), _t(v), None, True)
    TA.flash_attention_bwd(_t(k), _t(k), _t(v), None, out, lse, out, True)
    assert TA.LAUNCHES == {"flash_fwd": 0, "flash_decode": 0,
                           "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
