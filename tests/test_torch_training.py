"""The port's training attention and layers against the JAX package's,
on the CPU.

The same numpy inputs (from a seed) go to the JAX Pallas flash kernels
in interpret mode (forward, and both backward kernels through
`jax.grad`) and to the port's differentiable `flash_attention`, whose
wrappers run the kernels' plain PyTorch versions on CPU tensors.
Attention dropout is the JAX interpret-mode counter hash in both, so the
comparisons hold with dropout on, bit for bit in the keep masks.

Tolerances: float32 outputs rtol / atol 2e-5 and gradients atol 5e-5
(reordered float32 sums over up to 128 keys); bf16 operands rtol / atol
2e-2 for outputs and 6e-2 for gradients (p, ds and the outputs are
rounded to bf16, 2^-8 relative, at different points of two differently
ordered sums); float64 finite differences of the plain math at
`torch.autograd.gradcheck`'s defaults (atol 1e-5, rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import attention as JA
from paddle_tpu.parallel import functionalize
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import attention as TA

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _key_bias(b, s, seed):
    """A [b, s] key bias with a -1e4 pad tail (the ERNIE mask value) on
    row 1, plus small noise so its gradient is not trivially zero."""
    bias = _rand((b, s), seed) * 0.1
    bias[1, s * 3 // 4:] = -1e4
    return bias


# ------------------------------------------------------------ dropout bits

@pytest.mark.parametrize("seed", [17, -5])
@pytest.mark.parametrize("blocks", [(64, 32), (32, 64)])
def test_dropout_bits_equal_the_jax_reference(seed, blocks):
    """The port's keep mask equals the JAX `dropout_keep_reference`
    bit for bit (a negative int32 seed is read as its uint32, as the
    kernels' `seed.astype(uint32)` does), at non-square blocks."""
    bq, bk = blocks
    b, h, sq, sk, p = 2, 3, 128, 192, 0.1
    want = JA.dropout_keep_reference(seed & 0xFFFFFFFF, b, h, sq, sk, bq,
                                     bk, p)
    got = TA.dropout_keep_reference(seed, b, h, sq, sk, bq, bk, p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.88 < got.float().mean() < 0.92


def test_dropout_bits_equal_the_jax_kernel_hash_for_a_negative_seed():
    """The in-kernel JAX hash, fed an int32 seed of -5 as the kernels
    are, draws the bits the port draws for -5."""
    bq, bk = 16, 8
    bits = JA._hash_bits(jnp, jax, jnp.int32(-5), jnp.int32(3),
                         jnp.int32(1), jnp.int32(2), bq, bk)
    thresh, _ = TA._drop_consts(0.3)
    keep = TA.dropout_keep_reference(-5, 1, 4, 2 * bq, 3 * bk, bq, bk, 0.3)
    np.testing.assert_array_equal(
        keep[3, bq:2 * bq, 2 * bk:3 * bk].numpy(),
        np.asarray(bits) >= thresh)


def test_drop_grid_bound_and_logical_blocks():
    with pytest.raises(ValueError, match="4096"):
        TA.drop_spec(0.1, 0, 4097 * 2, 4097 * 2, 2, 2)
    # the logical blocks are the JAX ladder's, not the kernels' 64 tiles
    assert TA._pick_blocks_heuristic(1024, 1024) == (512, 512)
    assert TA._pick_blocks_heuristic(200, 200) == (200, 200)
    assert TA._pick_blocks_heuristic(768, 1280) == (384, 256)
    for sq, sk in [(1024, 1024), (200, 200), (768, 1280), (1000, 1000)]:
        assert TA._pick_blocks_heuristic(sq, sk) == \
            JA._pick_blocks_heuristic(sq, sk)
    assert TA.drop_spec(0.0, None, 8, 8) is None


# ------------------------------------------- flash fwd + bwd against JAX

def _jax_flash(q, k, v, bias, g, causal, p, seed, dtype):
    def loss(q, k, v, bias):
        out = JA.flash_attention(
            q, k, v, bias, causal, None, interpret=True, block_q=64,
            block_k=64, dropout_p=p,
            dropout_seed=jnp.array([seed], jnp.int32))
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum(), out

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias, jnp.float32)
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    (_, out), grads = jax.value_and_grad(loss, argnums, has_aux=True)(
        *args, jb)
    return [np.asarray(out.astype(jnp.float32))] + [
        np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_flash(q, k, v, bias, g, causal, p, seed, dtype):
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias).requires_grad_()
    out = TA.flash_attention(*ts, tb, causal, None, block_q=64, block_k=64,
                             dropout_p=p, dropout_seed=seed)
    (out.float() * torch.tensor(g)).sum().backward()
    grads = [t.grad for t in ts] + ([] if tb is None else [tb.grad])
    return [out.detach().float().numpy()] + [x.float().numpy()
                                             for x in grads]


_CASES = [(bias, causal, p) for bias in (False, True)
          for causal in (False, True) for p in (0.0, 0.1)]


def _case_inputs(b=2, h=2, s=128, d=32):
    q, k, v, g = (_rand((b, h, s, d), i) for i in range(4))
    return q, k, v, _key_bias(b, s, 4), g


@pytest.mark.parametrize("bias,causal,p", _CASES,
                         ids=[f"bias{int(b)}-causal{int(c)}-p{p}"
                              for b, c, p in _CASES])
def test_flash_fwd_bwd_fp32_match_jax_kernels(bias, causal, p):
    q, k, v, kb, g = _case_inputs()
    kb = kb if bias else None
    want = _jax_flash(q, k, v, kb, g, causal, p, 1234, jnp.float32)
    got = _port_flash(q, k, v, kb, g, causal, p, 1234, torch.float32)
    names = ["out", "dq", "dk", "dv", "dbias"]
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for name, a, w in zip(names[1:], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("causal,p", [(False, 0.1), (True, 0.1)])
def test_flash_fwd_bwd_bf16_match_jax_kernels(causal, p):
    q, k, v, kb, g = _case_inputs()
    want = _jax_flash(q, k, v, kb, g, causal, p, -99, jnp.bfloat16)
    got = _port_flash(q, k, v, kb, g, causal, p, -99, torch.bfloat16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)
    for name, a, w in zip(["dq", "dk", "dv", "dbias"], got[1:], want[1:]):
        np.testing.assert_allclose(a, w, rtol=6e-2, atol=6e-2,
                                   err_msg=name)


def test_dropout_changes_the_output_and_the_seed_addresses_it():
    q, k, v, _, _ = _case_inputs(2, 2, 64, 16)
    t = [torch.tensor(x) for x in (q, k, v)]
    base = TA.flash_attention(*t, None, False, None)
    a = TA.flash_attention(*t, None, False, None, dropout_p=0.2,
                           dropout_seed=7)
    b = TA.flash_attention(*t, None, False, None, dropout_p=0.2,
                           dropout_seed=7)
    c = TA.flash_attention(*t, None, False, None, dropout_p=0.2,
                           dropout_seed=8)
    assert torch.equal(a, b)
    assert not torch.equal(a, base) and not torch.equal(a, c)


def test_flash_attention_gradcheck_fp64_plain_path():
    """torch.autograd.gradcheck (float64 finite differences) of the
    autograd Function over the plain versions: bias, causal and
    dropout on, ragged lengths against small logical blocks."""
    rs = np.random.RandomState(5)
    q, k, v = (torch.tensor(rs.randn(1, 2, 11, 4), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    bias = torch.tensor(rs.randn(1, 11) * 0.3, dtype=torch.float64,
                        requires_grad=True)

    def f(q, k, v, bias):
        return TA.flash_attention(q, k, v, bias, True, None, block_q=4,
                                  block_k=3, dropout_p=0.25,
                                  dropout_seed=-3)

    assert torch.autograd.gradcheck(f, (q, k, v, bias))


def test_sdpa_training_dispatch_matches_jax_flash():
    """ops.sdpa with dropout routes a [b, 1, 1, sk] mask to the flash
    path with the same bits as JAX's flash_attention (the JAX
    dispatcher itself only reaches its kernels on a TPU)."""
    q, k, v, kb, _ = _case_inputs(2, 2, 128, 16)
    want = JA.flash_attention(
        *[jnp.asarray(x) for x in (q, k, v)], jnp.asarray(kb), False, None,
        interpret=True, dropout_p=0.1,
        dropout_seed=jnp.array([42], jnp.int32))
    got = TA.sdpa(*[torch.tensor(x) for x in (q, k, v)],
                  torch.tensor(kb)[:, None, None, :], dropout_p=0.1,
                  dropout_seed=42)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------ functional and layers

def test_gelu_tanh_match_jax():
    x = _rand((64,), 9) * 3
    np.testing.assert_allclose(
        TF.gelu(torch.tensor(x)).numpy(),
        np.asarray(JF.gelu(paddle.to_tensor(x))._data), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        TF.tanh(torch.tensor(x)).numpy(),
        np.asarray(JF.tanh(paddle.to_tensor(x))._data), rtol=1e-6,
        atol=1e-6)


def test_dropout_module_draws_from_its_generator():
    x = torch.ones(4096)
    d = tnn.Dropout(0.25, generator=torch.Generator().manual_seed(1))
    a = d(x)
    d.generator = torch.Generator().manual_seed(1)
    assert torch.equal(a, d(x))
    kept = a != 0
    assert 0.7 < kept.float().mean() < 0.8
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(TF.dropout(x, 0.25, training=False), x)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before):
    """TransformerEncoderLayer with gelu, pre- or post-norm, at dropout
    0, against the JAX layer with the same weights: output and every
    parameter gradient (rtol 1e-5 / atol 2e-5: the gradients of the
    squared-output loss reach ~1e2)."""
    paddle.seed(3)
    jl = jnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before)
    sd = {n: np.asarray(t) for n, t in jl.state_dict().items()}
    tl = tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before,
                                     device="cpu")
    tl.load_state_dict(convert.from_jax_state(sd), strict=True)
    x = _rand((2, 24, 32), 11)
    mask = np.zeros((2, 1, 1, 24), np.float32)
    mask[1, ..., 15:] = -1e4
    fm = functionalize(jl)

    def jloss(params):
        out, _ = fm.apply(params, fm.buffers(), None, jnp.asarray(x),
                          jnp.asarray(mask), training=True)
        return (out ** 2).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(fm.params())
    out = tl.train()(torch.tensor(x), torch.tensor(mask))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n]),
                                   rtol=1e-5, atol=2e-5, err_msg=n)


def test_encoder_layer_attention_dropout_uses_a_seed_per_call():
    """attn_dropout reaches the flash path with a seed drawn from the
    attention's seed generator per call; act_dropout and hidden dropout
    default to `dropout`."""
    layer = tnn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                        activation="gelu", attn_dropout=0.5,
                                        device="cpu")
    assert layer.dropout_act.p == 0.0 and layer.self_attn.dropout == 0.5
    x = torch.tensor(_rand((2, 8, 16), 12))
    layer.self_attn.seed_generator = torch.Generator().manual_seed(0)
    a, b = layer(x), layer(x)
    assert not torch.equal(a, b)          # a fresh seed each call
    layer.self_attn.seed_generator = torch.Generator().manual_seed(0)
    assert torch.equal(a, layer(x))
    assert torch.equal(layer.eval()(x), layer(x))
