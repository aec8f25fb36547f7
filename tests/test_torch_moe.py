"""The port's mixture-of-experts layer and MoE ERNIE against the JAX
package's, on the CPU (the single-device cases of `tests/test_moe.py`,
ported, plus parity with JAX).

`MoELayer`: built in JAX and loaded into the port through
`convert.from_jax_state`, it gives the JAX outputs, aux loss, and
gradients with respect to x, the router and both expert weights within
rtol 1e-5 / atol 1e-6 (float32), with capacity to spare and with tokens
dropped, and routes every token alike (ties to the lower expert). The
forward equals a dense per-token expert; overflow tokens get zero
output and a zero gate gradient; the experts' gradients differ.

MoE ERNIE (tiny, 4 experts, dropout 0): logits, every aux loss, and the
gradients of loss + 0.01 * sum(aux) match JAX's within the pretraining
test's limits (logits 2e-5, gradients 5e-5); `SpmdTrainer` adds the
weighted aux losses to the objective (and ignores them at weight 0), as
the JAX trainer does, over three steps; `remat` changes neither the loss
nor any gradient (bit for bit), and `grad_accum=2` equals two
micro-batches stepped by hand (each with its own capacity) within 1e-6.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptorch
from paddle_tpu.parallel import SpmdTrainer as JaxTrainer
from paddle_tpu.parallel import functionalize, init_mesh
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForPretraining as JaxPretraining
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.optimizer import functional as fopt
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining
from _torch_parity import np_state

torch.set_num_threads(2)
NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0, moe_experts=4)
VOCAB = 1024


def _pair(d=8, f=16, e=3, cap=10_000.0, seed=5):
    paddle.seed(seed)
    jl = jnn.MoELayer(d, f, num_experts=e, capacity_factor=cap)
    pl = tnn.MoELayer(d, f, num_experts=e, capacity_factor=cap,
                      device="cpu")
    pl.load_state_dict(convert.from_jax_state(np_state(jl)), strict=True)
    return jl, pl


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cap", [10_000.0, 1.25, 0.5], ids=lambda c: str(c))
def test_moe_layer_matches_jax(cap):
    jl, pl = _pair(cap=cap)
    x = _x((2, 6, 8), 0)
    cot = _x((2, 6, 8), 1)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jl(jx)
    (jy * paddle.to_tensor(cot)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = pl(tx)
    (ty * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               **tol)
    np.testing.assert_allclose(float(pl.aux_loss), float(jl.aux_loss),
                               **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               **tol)
    for n, p in pl.named_parameters():
        jp = dict(jl.named_parameters())[n]
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jp.grad.numpy()), err_msg=n,
                                   **tol)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, 8)) @ jl.router._data, -1))
    np.testing.assert_array_equal(pl.last_route.numpy(), probs.argmax(-1))
    dropped = int(pl.last_dropped)
    if cap < 1.0:
        assert dropped > 0
    assert int(pl.last_load.sum()) == 12


def test_moe_aux_gradient_matches_jax():
    """The aux loss's own gradient reaches the router alike (f_e carries
    none, P_e does)."""
    jl, pl = _pair(cap=1.0)
    x = _x((2, 6, 8), 2)
    jl(paddle.to_tensor(x))
    jl.aux_loss.backward()
    pl(torch.from_numpy(x))
    pl.aux_loss.backward()
    np.testing.assert_allclose(pl.router.grad.numpy(),
                               np.asarray(jl.router.grad.numpy()),
                               rtol=1e-5, atol=1e-7)
    assert pl.experts.weight_in.grad is None


def test_router_ties_go_to_the_lower_expert():
    """A zero router ties every token across all experts: jnp.argmax and
    the port both send every token to expert 0, which keeps its
    capacity's worth and drops the rest."""
    jl, pl = _pair(e=4, cap=1.0)
    with torch.no_grad():
        pl.router.zero_()
    jl.router.set_value(np.zeros((8, 4), np.float32))
    x = _x((2, 6, 8), 3)
    jy = np.asarray(jl(paddle.to_tensor(x)).numpy())
    ty = pl(torch.from_numpy(x)).detach().numpy()
    assert pl.last_route.tolist() == [0] * 12
    assert int(pl.last_dropped) == 12 - pl.capacity(12) == 9
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pl.aux_loss), float(jl.aux_loss),
                               rtol=1e-6)


def test_moe_forward_matches_dense_per_token_expert():
    d, f, e = 8, 16, 3
    pl = tnn.MoELayer(d, f, num_experts=e, capacity_factor=10_000.0,
                      device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 5, d), 4))
    out = pl(x).detach().reshape(-1, d)
    xn = x.reshape(-1, d)
    probs = torch.softmax(xn @ pl.router.detach(), -1)
    want = torch.zeros_like(xn)
    for t in range(xn.shape[0]):
        ei = int(probs[t].argmax())
        h = torch.nn.functional.gelu(xn[t] @ pl.experts.weight_in[ei])
        want[t] = probs[t, ei] * (h @ pl.experts.weight_out[ei])
    torch.testing.assert_close(out, want.detach(), rtol=2e-5, atol=2e-6)
    assert float(pl.aux_loss) > 0.0


def test_moe_capacity_drops_overflow_tokens():
    pl = tnn.MoELayer(4, 8, num_experts=2, capacity_factor=0.0,
                      device="cpu", generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_x((1, 6, 4), 5)).requires_grad_(True)
    out = pl(x)
    zero_rows = int((out.detach().reshape(-1, 4).abs().max(-1)[0]
                     < 1e-7).sum())
    assert pl.capacity(6) == 1 and zero_rows >= 4
    # a dropped token's gate gets no gradient: its router row only feels
    # the kept tokens' gradient (and the aux loss, left out here)
    out.sum().backward()
    dropped = (out.detach().reshape(-1, 4).abs().max(-1)[0] < 1e-7)
    assert bool((x.grad.reshape(-1, 4)[dropped] == 0).all())


def test_moe_expert_grads_differ():
    pl = tnn.MoELayer(8, 16, num_experts=2, capacity_factor=10_000.0,
                      device="cpu", generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(_x((4, 6, 8), 6))
    (pl(x) * torch.from_numpy(_x((4, 6, 8), 7))).sum().backward()
    g = pl.experts.weight_in.grad
    assert float(g[0].abs().sum()) > 0 and float(g[1].abs().sum()) > 0
    assert not torch.allclose(g[0], g[1])
    assert float(pl.router.grad.abs().sum()) > 0


def test_moe_state_dict_roundtrip():
    pl = tnn.MoELayer(8, 16, num_experts=2, device="cpu",
                      generator=torch.Generator().manual_seed(31))
    x = torch.from_numpy(_x((2, 5, 8), 8))
    want = pl(x).detach()
    sd = pl.state_dict()
    assert set(sd) == {"router", "experts.weight_in", "experts.weight_out"}
    buf = io.BytesIO()
    torch.save(sd, buf)
    fresh = tnn.MoELayer(8, 16, num_experts=2, device="cpu",
                         generator=torch.Generator().manual_seed(99))
    assert not torch.allclose(fresh(x), want)
    buf.seek(0)
    fresh.set_state_dict(torch.load(buf))
    torch.testing.assert_close(fresh(x).detach(), want, rtol=0, atol=0)
    assert callable(ptorch.save) and callable(ptorch.load)


# ------------------------------------------------------------ MoE ERNIE

def batch(b=4, s=16, seed=0):
    """(ids, token types, attention mask), labels [b, s + 1] (masked-LM
    targets, -1 where unmasked, then the NSP label); the same number of
    targets in every row."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, VOCAB, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    mask = np.ones((b, s), np.float32)
    mask[1, s * 3 // 4:] = 0.0
    masked = np.zeros((b, s), bool)
    for row in range(b):
        masked[row, rs.choice(s * 3 // 4, 3, replace=False)] = True
    labels = np.full((b, s + 1), -1, np.int64)
    labels[:, :s][masked] = ids[masked]
    ids[masked] = 3
    labels[:, s] = rs.randint(0, 2, b)
    return (ids, tt, mask), labels


def port_loss(outs, labels):
    mlm, nsp = outs
    mlm_loss = torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, mlm.shape[-1]), labels[:, :-1].reshape(-1),
        ignore_index=-1)
    return mlm_loss + torch.nn.functional.cross_entropy(nsp.float(),
                                                        labels[:, -1])


def jax_loss(outs, labels):
    mlm, nsp = outs
    tgt = labels[:, :-1]
    lp = jax.nn.log_softmax(mlm.astype(jnp.float32), -1)
    hit = jnp.take_along_axis(lp, jnp.maximum(tgt, 0)[..., None], -1)[..., 0]
    sel = (tgt >= 0).astype(jnp.float32)
    nlp = jax.nn.log_softmax(nsp.astype(jnp.float32), -1)
    return -(hit * sel).sum() / sel.sum() - jnp.take_along_axis(
        nlp, labels[:, -1:], -1).mean()


def jax_model(seed=0, **kw):
    paddle.seed(seed)
    return JaxPretraining(JaxConfig.tiny(**{**NO_DROPOUT, **kw}))


def port_model(state=None, seed=0, **kw):
    model = ErnieForPretraining(
        ErnieConfig.tiny(**{**NO_DROPOUT, **kw}), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict(convert.from_jax_state(state), strict=True)
    return model


def _moe_layers(model):
    return [m for m in model.modules() if isinstance(m, tnn.MoELayer)]


def test_moe_ernie_logits_aux_and_gradients_match_jax():
    jm = jax_model()
    state = np_state(jm)
    # the JAX state_dict lets the nested MoE layers' non-persistable
    # aux-loss channel through; from_jax_state drops it
    aux_keys = {k for k in state if k.endswith("aux_loss_val")}
    assert len(aux_keys) == 2
    model = port_model(state)
    assert set(state) - aux_keys == set(model.state_dict())
    assert set(convert.from_jax_state(state)) == set(model.state_dict())
    (ids, tt, mask), labels = batch()
    fm = functionalize(jm)

    def jloss(params):
        out, new_buf = fm.apply(params, fm.buffers(), None, jnp.asarray(ids),
                                jnp.asarray(tt), jnp.asarray(mask),
                                training=True)
        aux = [v for n, v in sorted(new_buf.items())
               if n.endswith("aux_loss_val")]
        total = jax_loss(out, jnp.asarray(labels)) + jnp.float32(0.01) * sum(
            a.reshape(()) for a in aux)
        return total, (out, aux)

    (j_total, (j_out, j_aux)), j_grads = jax.value_and_grad(
        jloss, has_aux=True)(fm.params())
    outs = model.train()(torch.from_numpy(ids), torch.from_numpy(tt),
                         torch.from_numpy(mask))
    aux = [m.aux_loss for m in _moe_layers(model)]
    total = port_loss(outs, torch.from_numpy(labels)) + 0.01 * sum(aux)
    total.backward()
    for got, want in zip(outs, j_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert len(aux) == len(j_aux) == 2
    np.testing.assert_allclose([float(a) for a in aux],
                               [float(a) for a in j_aux], rtol=2e-5)
    np.testing.assert_allclose(float(total), float(j_total), rtol=2e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[n]),
                                   rtol=5e-5, atol=5e-5, err_msg=n)


@pytest.fixture
def single_device_mesh():
    saved = jax_mesh._current[0]
    yield init_mesh(dp=1, devices=jax.devices("cpu")[:1])
    jax_mesh._current[0] = saved


def test_trainer_aux_loss_matches_the_jax_trainer(single_device_mesh):
    """Three AdamW steps with moe_aux_weight 0.01: every loss (the
    weighted aux included, as the JAX trainer returns it) within rtol
    2e-5, every parameter within atol 2e-5. Epsilon 1e-4, as
    `tests/test_torch_pretraining.py` argues: the key biases' gradients
    are zero up to rounding, and a smaller epsilon turns that rounding
    into steps of the full rate."""
    jm = jax_model(1)
    model = port_model(np_state(jm))
    inputs, labels = batch(seed=1)
    j_tr = JaxTrainer(jm, jax_loss, jfopt.adamw(1e-3, epsilon=1e-4),
                      mesh=single_device_mesh, moe_aux_weight=0.01)
    tr = SpmdTrainer(model, port_loss, fopt.adamw(1e-3, epsilon=1e-4),
                     device="cpu", moe_aux_weight=0.01)
    for step in range(3):
        np.testing.assert_allclose(float(tr.step(inputs, labels)),
                                   float(j_tr.step(inputs, labels)),
                                   rtol=2e-5, err_msg=f"step {step}")
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j_tr.params[n]), rtol=0,
                                   atol=2e-5, err_msg=n)


def test_trainer_adds_the_weighted_aux_and_ignores_it_at_zero():
    inputs, labels = batch(seed=3)
    losses = {}
    for w in (0.0, 0.5):
        model = port_model(seed=21)
        tr = SpmdTrainer(model, port_loss, fopt.adamw(0.0), device="cpu",
                         moe_aux_weight=w)
        losses[w] = float(tr.step(inputs, labels))
        aux = [float(m.aux_loss) for m in _moe_layers(model)]
    model = port_model(seed=21)
    with torch.no_grad():
        plain = float(port_loss(model.train()(
            *(torch.from_numpy(x) for x in inputs)), torch.from_numpy(labels)))
    np.testing.assert_allclose(losses[0.0], plain, rtol=1e-6)
    np.testing.assert_allclose(losses[0.5] - losses[0.0], 0.5 * sum(aux),
                               rtol=1e-4)
    assert losses[0.5] - losses[0.0] > 0.2          # 2 layers x aux >= ~1


def _loss_and_grads(remat, accum=1, seed=7, inputs=None, labels=None,
                    weight=0.01):
    model = port_model(seed=seed)
    tr = SpmdTrainer(model, port_loss, fopt.adamw(1e-3), device="cpu",
                     remat=remat, grad_accum=accum, moe_aux_weight=weight)
    if inputs is None:
        inputs, labels = batch(b=4, seed=8)
    return tr.loss_and_grads(inputs, labels)


def test_remat_adds_the_aux_once_and_its_gradient_once():
    """The remat recompute sets every aux loss anew; the loss and
    every gradient (the routers' included) equal remat=False's bit for
    bit, with the aux weight large enough to matter."""
    l0, g0 = _loss_and_grads(False, weight=0.5)
    l1, g1 = _loss_and_grads(True, weight=0.5)
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    routers = [n for n in g0 if n.endswith("moe.router")]
    assert len(routers) == 2 and all(float(g0[n].abs().sum()) > 0
                                     for n in routers)
    l2, g2 = _loss_and_grads(False, weight=0.0)
    assert not torch.equal(g0[routers[0]], g2[routers[0]])


def test_remat_keeps_no_graph_of_the_recompute():
    """The recompute sets each aux loss anew; the trainer keeps it
    detached, so its graph (reaching back through every layer below)
    does not hold the recomputed activations through the backward."""
    model = port_model(seed=7)
    tr = SpmdTrainer(model, port_loss, fopt.adamw(1e-3), device="cpu",
                     remat=True)
    tr.loss_and_grads(*batch(b=4, seed=8))
    layers = _moe_layers(model)
    assert layers and all(m.aux_loss.grad_fn is None for m in layers)


def test_grad_accum_equals_two_micro_batches_by_hand():
    """grad_accum=2: each micro-batch routes with its own capacity and
    adds its own aux; the same as the two halves stepped by hand."""
    (ids, tt, mask), labels = batch(b=4, seed=9)
    loss, grads = _loss_and_grads(False, accum=2, inputs=(ids, tt, mask),
                                  labels=labels)
    parts = [_loss_and_grads(False, inputs=(ids[sl], tt[sl], mask[sl]),
                             labels=labels[sl])
             for sl in (slice(0, 2), slice(2, 4))]
    np.testing.assert_allclose(float(loss),
                               (float(parts[0][0]) + float(parts[1][0])) / 2,
                               rtol=1e-6)
    for n in grads:
        want = (parts[0][1][n] + parts[1][1][n]) / 2
        torch.testing.assert_close(grads[n], want, rtol=1e-6, atol=1e-7,
                                   msg=n)
