"""The port's vision slice against the JAX package's, on the CPU:
convolution, pooling and batch normalisation (`ops/kernels.py`), the
vision layers, the bottleneck block, `momentum`, and `SpmdTrainer`
carrying BatchNorm's running stats (ResNet-50 itself:
`tests/test_torch_resnet.py`).

The same numpy inputs (from a seed) go to both packages; a JAX model's
`state_dict()` (parameters and BN buffers) loads into the port's through
`convert.from_jax_state`. Tolerances:
  * convolutions, pooling and float32 batch norm: rtol / atol 1e-5
    (float32 sums over at most a few hundred terms in another order; the
    JAX stem conv at these small images is an im2col einsum, the port's
    `F.conv2d`);
  * bf16 batch norm: outputs and gradients within 2e-2 of the JAX one's
    largest entry (every elementwise op rounds to bf16, 2^-8 relative,
    and XLA may keep a fused chain in float32 where torch rounds each
    op), its float32 stats rtol 1e-5;
  * three momentum steps of a small bottleneck net in float32: losses
    rtol 1e-5, parameters and buffers atol 2e-5; one bf16 step: see
    `test_trainer_bf16_step_keeps_fp32_buffers_and_tracks_jax`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops import kernels as JK
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu.parallel import SpmdTrainer as JaxTrainer
from paddle_tpu.parallel import init_mesh
from paddle_tpu.parallel import mesh as jax_mesh
from paddle_tpu.vision.models.resnet import BottleneckBlock as JaxBottleneck
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import kernels as TK
from paddle_tpu_torch.optimizer import functional as fopt
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.vision.models import BottleneckBlock

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * scale + shift).astype(np.float32)


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _port_vjp(fn, args, cot):
    ts = [torch.tensor(a).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ------------------------------------------------------------- the ops

# x shape, w shape, stride, padding, dilation, groups
_CONVS = {
    "1x1": ((2, 16, 14, 14), (8, 16, 1, 1), 1, 0, 1, 1),
    "3x3_s2_p1": ((2, 8, 9, 9), (12, 8, 3, 3), 2, 1, 1, 1),
    "stem_7x7_s2_p3": ((2, 3, 32, 32), (8, 3, 7, 7), 2, 3, 1, 1),
    "same_dilated_grouped": ((1, 8, 10, 10), (6, 4, 3, 3), 1, "SAME", 2, 2),
    "asymmetric_pad": ((1, 4, 9, 8), (5, 4, 3, 2), (2, 1), [1, 2, 0, 1],
                       1, 1),
    "valid_s3": ((1, 4, 11, 11), (3, 4, 3, 3), 3, "VALID", 1, 1),
}


@pytest.mark.parametrize("case", sorted(_CONVS))
def test_conv2d_and_its_gradients_match_jax(case):
    xs, ws, stride, pad, dil, groups = _CONVS[case]
    x, w = _rand(xs, 1), _rand(ws, 2, 0.3)
    want = JK.conv2d(jnp.asarray(x), jnp.asarray(w), stride, pad, dil,
                     groups)
    cot = _rand(np.asarray(want).shape, 3)
    _close(_port_vjp(lambda a, b: TK.conv2d(a, b, stride, pad, dil, groups),
                     (x, w), cot),
           _jax_vjp(lambda a, b: JK.conv2d(a, b, stride, pad, dil, groups),
                    (x, w), cot))


@pytest.mark.parametrize("k,s,p,shape", [
    (3, 2, 1, (2, 4, 9, 9)),            # the ResNet stem's pool
    (2, 2, 0, (1, 3, 8, 8)),
    (3, 2, "SAME", (1, 2, 7, 7)),
])
def test_max_pool2d_pads_with_minus_inf_as_jax(k, s, p, shape):
    x = _rand(shape, 4, shift=-3.0)     # all negative: a zero pad would win
    want = JK.max_pool2d(jnp.asarray(x), k, s, p)
    cot = _rand(np.asarray(want).shape, 5)
    _close(_port_vjp(lambda a: TK.max_pool2d(a, k, s, p), (x,), cot),
           _jax_vjp(lambda a: JK.max_pool2d(a, k, s, p), (x,), cot))


@pytest.mark.parametrize("shape,out", [
    ((2, 3, 7, 7), (1, 1)),             # divisible: the reshape path
    ((1, 2, 4, 6), (2, 3)),
    ((1, 2, 7, 5), (3, 2)),             # the general windows
])
def test_adaptive_avg_pool2d_matches_jax(shape, out):
    x = _rand(shape, 6)
    want = JK.adaptive_avg_pool2d(jnp.asarray(x), out)
    cot = _rand(np.asarray(want).shape, 7)
    _close(_port_vjp(lambda a: TK.adaptive_avg_pool2d(a, out), (x,), cot),
           _jax_vjp(lambda a: JK.adaptive_avg_pool2d(a, out), (x,), cot))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
def test_batch_norm_matches_jax(dtype, training):
    """Outputs, the gradients of x, gamma and beta, and (training) the
    new running stats: momentum 0.9, biased variance."""
    x = _rand((4, 6, 5, 5), 8, 2.0, 0.7)
    gamma, beta = _rand((6,), 9, 0.2, 1.0), _rand((6,), 10, 0.3)
    rm, rv = _rand((6,), 11, 0.1), np.abs(_rand((6,), 12)) + 0.5
    cot = _rand(x.shape, 13)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfn(x, g, b):
        if training:
            return JK.batch_norm_train(x, g, b, jnp.asarray(rm),
                                       jnp.asarray(rv), 0.9, 1e-5)
        return (JK.batch_norm_infer(x, g, b, jnp.asarray(rm),
                                    jnp.asarray(rv), 1e-5),)

    def tfn(x, g, b):
        if training:
            return TK.batch_norm_train(x, g, b, torch.tensor(rm),
                                       torch.tensor(rv), 0.9, 1e-5)
        return (TK.batch_norm_infer(x, g, b, torch.tensor(rm),
                                    torch.tensor(rv), 1e-5),)

    jargs = [jnp.asarray(a, jdt) for a in (x, gamma, beta)]
    jouts, vjp = jax.vjp(lambda *a: jfn(*a)[0], *jargs)
    jgrads = vjp(jnp.asarray(cot, jdt))
    jstats = jfn(*jargs)[1:3]
    targs = [torch.tensor(a).to(tdt).requires_grad_() for a in
             (x, gamma, beta)]
    touts = tfn(*targs)
    touts[0].backward(torch.tensor(cot).to(tdt))
    pairs = [(touts[0], jouts)] + [(t.grad, j) for t, j in zip(targs,
                                                                jgrads)]
    for t, j in pairs:
        got, want = t.detach().float().numpy(), np.asarray(
            j.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    for t, j in zip(touts[1:3], jstats):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------- layers, models

def test_vision_layers_keep_the_reference_names_and_initialisers():
    g = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(64, 128, 3, bias_attr=False, device="cpu",
                      generator=g)
    assert list(conv.state_dict()) == ["weight"]
    std = float(conv.weight.detach().std())
    assert abs(std - (2.0 / (64 * 9)) ** 0.5) < 0.02 * std   # MSRA
    assert list(tnn.Conv2D(3, 4, 1, device="cpu").state_dict()) == \
        ["weight", "bias"]
    bn = tnn.BatchNorm2D(5, device="cpu")
    assert list(bn.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert bn._mean.dtype == torch.float32 and bn._variance.eq(1).all()
    seq = tnn.Sequential(tnn.ReLU(), bn)
    assert list(seq.state_dict()) == [f"1.{k}" for k in bn.state_dict()]
    x = torch.randn(3, 5, 4, 4, generator=g) * 2 + 1
    seq(x)                                   # training: stats move
    want = 0.9 * 0 + 0.1 * torch.relu(x).mean((0, 2, 3))
    torch.testing.assert_close(bn._mean, want, rtol=1e-5, atol=1e-6)


class _JaxNet(jnn.Layer):
    """A small bottleneck net: stem, two blocks (the first with a
    downsample), pool, classifier."""

    def __init__(self):
        super().__init__()
        self.conv1 = jnn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
        self.bn1 = jnn.BatchNorm2D(8)
        self.relu = jnn.ReLU()
        self.pool = jnn.MaxPool2D(3, 2, 1)
        down = jnn.Sequential(jnn.Conv2D(8, 16, 1, stride=2,
                                         bias_attr=False),
                              jnn.BatchNorm2D(16))
        self.block1 = JaxBottleneck(8, 4, 2, down)
        self.block2 = JaxBottleneck(16, 4)
        self.avgpool = jnn.AdaptiveAvgPool2D((1, 1))
        self.fc = jnn.Linear(16, 5)

    def forward(self, x):
        x = self.pool(self.relu(self.bn1(self.conv1(x))))
        x = self.avgpool(self.block2(self.block1(x)))
        return self.fc(x.flatten(1))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.conv1 = tnn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw)
        self.bn1 = tnn.BatchNorm2D(8, **kw)
        self.relu = tnn.ReLU()
        self.pool = tnn.MaxPool2D(3, 2, 1)
        down = tnn.Sequential(tnn.Conv2D(8, 16, 1, stride=2,
                                         bias_attr=False, **kw),
                              tnn.BatchNorm2D(16, **kw))
        self.block1 = BottleneckBlock(8, 4, 2, down, **kw)
        self.block2 = BottleneckBlock(16, 4, **kw)
        self.avgpool = tnn.AdaptiveAvgPool2D((1, 1))
        self.fc = tnn.Linear(16, 5, **kw)

    def forward(self, x):
        x = self.pool(self.relu(self.bn1(self.conv1(x))))
        x = self.avgpool(self.block2(self.block1(x)))
        return self.fc(x.flatten(1))


def _jax_ce(logits, labels):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.take_along_axis(lp, labels[:, None], -1).mean()


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


@pytest.fixture
def single_device_mesh():
    saved = jax_mesh._current[0]
    yield init_mesh(dp=1, devices=jax.devices("cpu")[:1])
    jax_mesh._current[0] = saved


def _trainers(mesh, compute_dtype, seed=0):
    paddle.seed(seed)
    jm = _JaxNet()
    model = _Net()
    model.load_state_dict(convert.from_jax_state(_np_state(jm)),
                          strict=True)
    j_tr = JaxTrainer(jm, _jax_ce, jfopt.momentum(0.1, 0.9), mesh=mesh,
                      compute_dtype=compute_dtype)
    tr = SpmdTrainer(model, _ce, fopt.momentum(0.1, 0.9),
                     compute_dtype=compute_dtype, device="cpu")
    rs = np.random.RandomState(seed)
    imgs = rs.randn(4, 3, 16, 16).astype(np.float32)
    labels = rs.randint(0, 5, (4,)).astype(np.int64)
    return j_tr, tr, imgs, labels


def test_trainer_tracks_jax_for_three_momentum_steps(single_device_mesh):
    j_tr, tr, imgs, labels = _trainers(single_device_mesh, None)
    for step in range(3):
        j_loss = float(j_tr.step((imgs,), labels))
        loss = float(tr.step((imgs,), labels))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5,
                                   err_msg=f"step {step}")
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j_tr.params[n]), rtol=0,
                                   atol=2e-5, err_msg=n)
    assert set(tr.buffers) == set(j_tr.buffers)
    for n, b in tr.buffers.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(j_tr.buffers[n]),
                                   rtol=0, atol=2e-5, err_msg=n)
    np.testing.assert_allclose(tr.eval_step((imgs,)).numpy(),
                               np.asarray(j_tr.eval_step((imgs,))),
                               rtol=1e-4, atol=1e-5)


def test_trainer_bf16_step_keeps_fp32_buffers_and_tracks_jax(
        single_device_mesh):
    """One bf16 step of each package against the float32 step from the
    same weights: bf16 rounding alone (BN's analytic backward is a
    difference of bf16 terms) moves the JAX package's update by about 9%
    of the float32 one (relative L2 over all parameters); the port's must
    move by at most twice as much, the loss agree within 1e-2 and the
    float32 buffers within 3e-2 of their largest entry."""
    j_tr, tr, imgs, labels = _trainers(single_device_mesh, "bfloat16")
    _, ref, _, _ = _trainers(single_device_mesh, None)
    start = {n: p.detach().clone() for n, p in tr.params.items()}
    j_loss = float(j_tr.step((imgs,), labels))
    loss = tr.step((imgs,), labels)
    ref.step((imgs,), labels)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-2)
    err = {"port": 0.0, "jax": 0.0}
    den = 0.0
    for n, p in tr.params.items():
        assert p.dtype == torch.float32
        want = (ref.params[n] - start[n]).detach().numpy()
        for side, got in (("port", p.detach().numpy()),
                          ("jax", np.asarray(j_tr.params[n]))):
            err[side] += float(((got - start[n].numpy() - want) ** 2).sum())
        den += float((want ** 2).sum())
    port, jax_side = (err["port"] / den) ** 0.5, (err["jax"] / den) ** 0.5
    assert port <= 2 * jax_side and port <= 0.25, (port, jax_side)
    for n, b in tr.buffers.items():
        want = np.asarray(j_tr.buffers[n])
        assert b.dtype == torch.float32 and want.dtype == np.float32
        assert np.abs(b.numpy() - want).max() <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("wd,nesterov", [(0.0, False), (1e-3, True)])
def test_momentum_matches_jax(wd, nesterov):
    shapes = {"a": (3, 4), "b": (5,)}
    params = {n: _rand(s, i) for i, (n, s) in enumerate(shapes.items())}
    jtx = jfopt.momentum(0.1, 0.9, weight_decay=wd, use_nesterov=nesterov)
    ttx = fopt.momentum(0.1, 0.9, weight_decay=wd, use_nesterov=nesterov)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.tensor(v) for n, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        grads = {n: _rand(s, 10 * step + i)
                 for i, (n, s) in enumerate(shapes.items())}
        jp, js = jtx.update(jp, {n: jnp.asarray(g) for n, g in
                                 grads.items()}, js)
        tp, ts = ttx.update(tp, {n: torch.tensor(g) for n, g in
                                 grads.items()}, ts)
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.velocity[n].numpy(),
                                   np.asarray(js.velocity[n]), rtol=1e-6,
                                   atol=1e-6)
    assert ts.count == 3
