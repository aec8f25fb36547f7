"""The port's ERNIE fine-tune against the JAX package's, on the CPU.

A tiny `ErnieForSequenceClassification` (2 layers, hidden 64, 4 heads)
is built in JAX; its `state_dict()` loads into the port's model through
`convert.from_jax_state` as it stands. The same numpy batch (ragged 1/0
attention mask, so the key-bias path runs) goes through both at dropout
0: hidden and attention dropout draw from different generators in the
two packages (jax.random against torch's), so whole-model parity holds
only without them; attention dropout is held to the JAX kernels bit for
bit in `test_torch_training.py`.

Tolerances, float32 throughout: logits and loss rtol 1e-5 / atol 1e-5,
every parameter gradient atol 2e-5 (the same math with reordered float32
sums). `SpmdTrainer` against the JAX `SpmdTrainer` with `adamw`, with
`adam` under coupled weight decay and with `adamw` under a `decay_mask`,
3 steps at lr 1e-3 and epsilon 1e-4: every step's loss rtol 1e-5, every
parameter after the last step atol 2e-5, while the steps move the
parameters by ~1e-3. Adam divides by sqrt(v_hat), so a gradient that is
zero in exact arithmetic (k_proj.bias: softmax ignores a shift shared by
a row's logits) would turn its rounding noise (up to ~1e-7) into a full
step of lr in a random direction; epsilon 1e-4 keeps such steps near
1e-6. Treating the coupled decay as decoupled, or ignoring the mask,
moves some parameter by 3e-4 or more in these 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu.parallel import SpmdTrainer as JaxTrainer
from paddle_tpu.parallel import functionalize, init_mesh
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForSequenceClassification as JaxErnie
from paddle_tpu_torch import convert
from paddle_tpu_torch.optimizer import functional as fopt
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.text import (ErnieConfig,
                                   ErnieForSequenceClassification)

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)


def _batch(b=3, s=48, vocab=1024, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    mask = np.ones((b, s), np.float32)
    mask[1, 30:] = 0.0
    mask[2, 10:] = 0.0
    labels = rs.randint(0, 2, (b,)).astype(np.int64)
    return ids, tt, mask, labels


def _jax_model(seed=0):
    paddle.seed(seed)
    return JaxErnie(JaxConfig.tiny(**NO_DROPOUT))


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _port_model(np_state):
    model = ErnieForSequenceClassification(ErnieConfig.tiny(**NO_DROPOUT),
                                           device="cpu")
    model.load_state_dict(convert.from_jax_state(np_state), strict=True)
    return model


def _jax_ce(logits, labels):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.take_along_axis(lp, labels[:, None], -1).mean()


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def test_from_jax_state_loads_ernie_as_it_stands():
    """Every name of the JAX model maps onto the port's model with the
    same shape and layout; nothing is missing or left over."""
    jm = _jax_model()
    sd = _np_state(jm)
    model = ErnieForSequenceClassification(ErnieConfig.tiny(**NO_DROPOUT),
                                           device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(convert.from_jax_state(sd), strict=True)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[name])


def test_ernie_logits_loss_and_every_gradient_match_jax():
    jm = _jax_model()
    sd = _np_state(jm)
    model = _port_model(sd)
    ids, tt, mask, labels = _batch()
    fm = functionalize(jm)
    params, buffers = fm.params(), fm.buffers()

    def jloss(params):
        out, _ = fm.apply(params, buffers, None, jnp.asarray(ids),
                          jnp.asarray(tt), jnp.asarray(mask), training=True)
        return _jax_ce(out, jnp.asarray(labels)), out

    (j_loss, j_out), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    model.train()
    out = model(torch.from_numpy(ids), torch.from_numpy(tt),
                torch.from_numpy(mask))
    loss = _ce(out, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5, atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(j_grads)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[n]),
                                   rtol=0, atol=2e-5, err_msg=n)


@pytest.fixture
def single_device_mesh():
    saved = jax_mesh._current[0]
    yield init_mesh(dp=1, devices=jax.devices("cpu")[:1])
    jax_mesh._current[0] = saved


def _no_decay(name):
    """Decay all but biases and LayerNorm scales. The JAX rule passes a
    key path ("['encoder.layers.0.norm1.weight']"), the port's the name;
    both contain the name."""
    return not (name.rstrip("']").endswith("bias") or "norm" in name)


# optimizer rules of the two packages, built alike from these arguments
_OPTIMIZERS = {
    "adamw": ("adamw", dict(epsilon=1e-4)),
    "adam_coupled_decay": ("adam", dict(epsilon=1e-4, weight_decay=0.01)),
    "adamw_decay_mask": ("adamw", dict(epsilon=1e-4, weight_decay=0.1,
                                       decay_mask=_no_decay)),
}


@pytest.mark.parametrize("rule", sorted(_OPTIMIZERS))
def test_trainer_matches_jax_trainer_for_three_adamw_steps(
        single_device_mesh, rule):
    jm = _jax_model(1)
    model = _port_model(_np_state(jm))
    ids, tt, mask, labels = _batch(seed=1)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    fn, kwargs = _OPTIMIZERS[rule]
    j_tr = JaxTrainer(jm, _jax_ce, getattr(jfopt, fn)(1e-3, **kwargs),
                      mesh=single_device_mesh)
    tr = SpmdTrainer(model, _ce, getattr(fopt, fn)(1e-3, **kwargs),
                     device="cpu")
    for step in range(3):
        j_loss = float(j_tr.step((ids, tt, mask), labels))
        loss = float(tr.step((ids, tt, mask), labels))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5,
                                   err_msg=f"step {step}")
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j_tr.params[n]), rtol=0,
                                   atol=2e-5, err_msg=n)
        moved += float((p.detach() - start[n]).abs().max()) > 1e-3
    assert moved >= len(start) // 2      # the check is not vacuous


def test_trainer_bf16_compute_keeps_fp32_masters_and_learns():
    """compute_dtype="bfloat16": the forward runs on bf16 casts, the
    parameters stay float32 and receive float32 updates, the loss is a
    float32 scalar and falls on a fixed batch (dropout on)."""
    torch.manual_seed(0)
    model = ErnieForSequenceClassification(
        ErnieConfig.tiny(), device="cpu",
        generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids, tt, mask, labels = _batch(b=4, s=32, seed=2)
    tr = SpmdTrainer(model, _ce, fopt.adamw(1e-3),
                     compute_dtype="bfloat16", device="cpu",
                     generator=torch.Generator().manual_seed(3))
    losses = [tr.step((ids, tt, mask), labels) for _ in range(12)]
    assert all(loss.dtype == torch.float32 for loss in losses)
    vals = [float(v) for v in losses]
    assert all(np.isfinite(vals))
    assert np.mean(vals[-3:]) < np.mean(vals[:3])
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert not torch.equal(p.detach(), before[n]), n


def test_trainer_randomness_comes_from_its_generator():
    """Two trainers whose generators share a seed take identical steps
    with dropout on (attention seeds and hidden masks both flow from the
    generator); another seed gives another loss."""
    def run(seed):
        model = ErnieForSequenceClassification(
            ErnieConfig.tiny(), device="cpu",
            generator=torch.Generator().manual_seed(0))
        tr = SpmdTrainer(model, _ce, fopt.adamw(1e-3), device="cpu",
                         generator=torch.Generator().manual_seed(seed))
        ids, tt, mask, labels = _batch(b=3, s=32, seed=4)
        return [float(tr.step((ids, tt, mask), labels)) for _ in range(2)]

    assert run(5) == run(5)
    assert run(5) != run(6)
