"""The port's transformer layers against the JAX package's, on the CPU.

JAX layers are built at a small size (2 layers, d_model 64, 4 heads,
FFN 128), their `state_dict()` is loaded into the port through
`convert.from_jax_state`, and the same numpy inputs go through both.
Tolerance: rtol 1e-5 / atol 2e-5 (float32 with reordered sums).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import to_tensor
from paddle_tpu.nn.layer import transformer as JT
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.nn.layer import transformer as TT

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 2e-5
D, H, FF = 64, 4, 128


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _port(port_layer, jax_layer):
    port_layer.load_state_dict(from_jax_state(_np_state(jax_layer)))
    return port_layer.eval()


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _key_bias(lens, s):
    bias = np.zeros((len(lens), 1, 1, s), np.float32)
    for i, n in enumerate(lens):
        bias[i, ..., n:] = -1e30
    return bias


def _causal_plus(bias):
    s = bias.shape[-1]
    causal = np.where(np.tril(np.ones((s, s), bool)), 0.0, -1e30)
    return (causal[None, None] + bias).astype(np.float32)


def test_encoder_with_pad_bias_matches_jax():
    jenc = JT.TransformerEncoder(
        JT.TransformerEncoderLayer(D, H, FF, dropout=0.0), 2)
    jenc.eval()
    tenc = _port(TT.TransformerEncoder(
        TT.TransformerEncoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2),
        jenc)
    src, mask = _rand((3, 16, D), 1), _key_bias([16, 11, 3], 16)
    want = jenc(to_tensor(src), to_tensor(mask))
    with torch.inference_mode():
        got = tenc(torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal_flag", [False, True])
def test_decoder_matches_jax(causal_flag):
    """The JAX decoder under a dense causal + pad mask; the port under
    the same dense mask (reference path) or under `tgt_is_causal` with
    the pad mask as a key bias (the flash path)."""
    jdec = JT.TransformerDecoder(
        JT.TransformerDecoderLayer(D, H, FF, dropout=0.0), 2)
    jdec.eval()
    tdec = _port(TT.TransformerDecoder(
        TT.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2),
        jdec)
    tgt, mem = _rand((2, 12, D), 2), _rand((2, 7, D), 3)
    bias = _key_bias([12, 5], 12)
    want = jdec(to_tensor(tgt), to_tensor(mem), to_tensor(_causal_plus(bias)))
    with torch.inference_mode():
        if causal_flag:
            got = tdec(torch.from_numpy(tgt), torch.from_numpy(mem),
                       torch.from_numpy(bias), tgt_is_causal=True)
        else:
            got = tdec(torch.from_numpy(tgt), torch.from_numpy(mem),
                       torch.from_numpy(_causal_plus(bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=RTOL, atol=ATOL)


def test_transformer_state_dict_maps_name_for_name():
    jm = JT.Transformer(D, H, 2, 2, FF, dropout=0.0)
    jm.eval()
    tm = TT.Transformer(D, H, 2, 2, FF, dropout=0.0, device="cpu")
    assert set(_np_state(jm)) == set(tm.state_dict())
    _port(tm, jm)
    src, tgt = _rand((2, 9, D), 4), _rand((2, 6, D), 5)
    src_mask = _key_bias([9, 4], 9)
    tgt_mask = _causal_plus(np.zeros((2, 1, 1, 6), np.float32))
    want = jm(to_tensor(src), to_tensor(tgt), to_tensor(src_mask),
              to_tensor(tgt_mask))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
                 torch.from_numpy(src_mask), torch.from_numpy(tgt_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=RTOL, atol=ATOL)


def test_static_kv_prefill_then_decode_matches_full_recompute():
    """The in-place StaticKVCache path (prefill of an empty cache, then
    one decode step at each row's own index) gives the rows a full
    causal recompute over the same tokens gives."""
    tdec = TT.TransformerDecoder(
        TT.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"),
        2).eval()
    x, mem = torch.from_numpy(_rand((2, 9, D), 6)), \
        torch.from_numpy(_rand((2, 5, D), 7))
    with torch.inference_mode():
        full = tdec(x, mem, None, tgt_is_causal=True)
        caches = [(layer.self_attn.gen_cache(None, max_length=16,
                                             batch_size=2),
                   layer.cross_attn.gen_cache(
                       mem, type=TT.MultiHeadAttention.StaticCache))
                  for layer in tdec.layers]
        pre, caches = tdec(x[:, :8], mem, None, cache=caches)
        step, caches = tdec(x[:, 8:], mem, torch.zeros(2, 16), cache=caches)
    np.testing.assert_allclose(pre.numpy(), full[:, :8].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(step.numpy(), full[:, 8:].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert caches[0][0].index.tolist() == [9, 9]
