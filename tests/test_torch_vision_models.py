"""The rest of the port's vision slice against the JAX package, on the
CPU: the layers and functions `hapi.Model` and the vision models need
(ReLU6, Flatten, Identity, the pools, Conv2DTranspose, the batch norms
beyond 2-D NCHW, the losses), then LeNet, VGG (`make_layers` on a short
configuration), MobileNet V1 and V2 (scale 0.25, 32 x 32 images), and
weights carried through the shared `.pdparams` file format both ways.

The same numpy inputs (from a seed) go to both packages; a JAX model's
`state_dict()` loads into the port's through `convert.from_jax_state`.
Tolerances:
  * ops and layers: outputs and gradients rtol / atol 1e-5 (float32 sums
    over at most a few hundred terms in another order);
  * whole models at dropout 0 (train mode: BN on batch stats): logits,
    loss and every gradient within 1e-4 of the JAX tensor's largest
    entry, at least 1e-2 (one forward and backward through up to 52
    convolutions and BNs in another order of summation; a convolution
    bias before a BN has a zero gradient in exact arithmetic, so its
    float32 noise is held to 1e-6 absolute), running stats within 1e-5
    of theirs; the MobileNets 5e-4, 1e-2 and 5e-5, from their measured
    conditioning (see their test);
  * weights carried through the files: equal bit for bit, and so the
    outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import kernels as JK
from paddle_tpu.vision.models import LeNet as JaxLeNet
from paddle_tpu.vision.models import mobilenet_v1 as jax_mobilenet_v1
from paddle_tpu.vision.models import mobilenet_v2 as jax_mobilenet_v2
from paddle_tpu.vision.models.vgg import VGG as JaxVGG
from paddle_tpu.vision.models.vgg import make_layers as jax_make_layers
from paddle_tpu_torch import convert
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels as TK
from paddle_tpu_torch.vision.models import (VGG, LeNet, make_layers,
                                            mobilenet_v1, mobilenet_v2)

torch.set_num_threads(2)
TOL = 1e-5


def _rand(shape, seed, scale=1.0, shift=0.0):
    rs = np.random.RandomState(seed)
    return np.asarray(rs.randn(*shape) * scale + shift, np.float32)


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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got[0], want[0], rtol=tol, atol=tol)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _both(jfn, tfn, args, seed=50):
    want = jfn(*[jnp.asarray(a) for a in args])
    cot = _rand(np.asarray(want).shape, seed)
    _close(_port_vjp(tfn, args, cot), _jax_vjp(jfn, args, cot))


# ---------------------------------------------------------------- pools

_AVG = {
    "k2": ((1, 3, 8, 8), 2, None, 0, True),
    "k3_s2_p1_exclusive": ((2, 2, 9, 9), 3, 2, 1, True),
    "k3_s2_p1_inclusive": ((2, 2, 9, 9), 3, 2, 1, False),
    "same_odd": ((1, 2, 7, 6), 3, 2, "SAME", True),       # pad after
    "same_inclusive": ((1, 2, 7, 6), 2, 2, "SAME", False),
    "asymmetric": ((1, 2, 8, 9), (3, 2), (2, 1), [1, 2, 0, 1], True),
    "valid": ((1, 2, 9, 9), 3, 3, "VALID", True),
}


@pytest.mark.parametrize("case", sorted(_AVG))
def test_avg_pool2d_and_its_gradient_match_jax(case):
    shape, k, s, p, exclusive = _AVG[case]
    _both(lambda a: JK.avg_pool2d(a, k, s, p, False, exclusive),
          lambda a: TK.avg_pool2d(a, k, s, p, False, exclusive),
          (_rand(shape, 1),))


@pytest.mark.parametrize("shape,out", [((2, 3, 8, 8), (2, 2)),
                                       ((1, 4, 6, 9), (3, 3)),
                                       ((1, 2, 7, 7), 1)])
def test_adaptive_max_pool2d_matches_jax(shape, out):
    _both(lambda a: JK.adaptive_max_pool2d(a, out),
          lambda a: TK.adaptive_max_pool2d(a, out), (_rand(shape, 2),))


@pytest.mark.parametrize("k,s,p", [(2, None, 0), (3, 2, 1), (3, 1, 1)])
def test_pool1d_layers_match_jax(k, s, p):
    x = _rand((2, 3, 11), 3, shift=-2.0)
    for jcls, tcls in ((jnn.MaxPool1D, tnn.MaxPool1D),
                       (jnn.AvgPool1D, tnn.AvgPool1D)):
        jl, tl = jcls(k, s, p), tcls(k, s, p)
        _both(lambda a: jl(paddle.Tensor._wrap(a))._data, tl, (x,))


def test_ceil_mode_raises_everywhere():
    """The JAX pools accept ceil_mode and apply nothing; the port
    refuses it, its existing max_pool2d included."""
    x = torch.zeros(1, 1, 5, 5)
    x1 = torch.zeros(1, 1, 5)
    calls = [
        lambda: TK.max_pool2d(x, 2, 2, 0, True),
        lambda: TK.avg_pool2d(x, 2, 2, 0, True),
        lambda: TF.max_pool2d(x, 2, ceil_mode=True),
        lambda: TF.avg_pool2d(x, 2, ceil_mode=True),
        lambda: TF.max_pool1d(x1, 2, ceil_mode=True),
        lambda: TF.avg_pool1d(x1, 2, ceil_mode=True),
        lambda: tnn.MaxPool2D(2, ceil_mode=True)(x),
        lambda: tnn.AvgPool2D(2, ceil_mode=True)(x),
        lambda: tnn.MaxPool1D(2, ceil_mode=True)(x1),
        lambda: tnn.AvgPool1D(2, ceil_mode=True)(x1),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ceil_mode"):
            call()
    # floor mode is the JAX result
    assert tnn.MaxPool2D(2)(x).shape == (1, 1, 2, 2)


# ------------------------------------------------------ conv transpose

# x shape, in, out, k, stride, padding, output_padding, dilation, groups
_CONVT = {
    "k3_s2_p1_op1": ((2, 4, 5, 5), 4, 6, 3, 2, 1, 1, 1, 1),
    "k4_s2_p1": ((1, 3, 6, 6), 3, 2, 4, 2, 1, 0, 1, 1),
    "grouped_dilated": ((1, 4, 5, 4), 4, 6, 3, 1, 2, 0, 2, 2),
    "asymmetric": ((1, 2, 4, 5), 2, 3, (3, 2), (2, 1), [1, 0, 0, 1], 0, 1,
                   1),
    "op_at_stride": ((1, 2, 4, 4), 2, 2, 3, 2, 0, (1, 0), 1, 1),
}


@pytest.mark.parametrize("case", sorted(_CONVT))
def test_conv2d_transpose_layer_matches_jax(case):
    xs, ci, co, k, s, p, op, d, g = _CONVT[case]
    paddle.seed(3)
    jl = jnn.Conv2DTranspose(ci, co, k, s, p, op, d, g)
    tl = tnn.Conv2DTranspose(ci, co, k, s, p, op, d, g, device="cpu")
    sd = _np_state(jl)
    assert sd["weight"].shape == tuple(tl.weight.shape)
    tl.load_state_dict(convert.from_jax_state(sd))
    x = _rand(xs, 4)
    want = jl(paddle.to_tensor(x))
    cot = _rand(np.asarray(want._data).shape, 5)
    want.backward(paddle.to_tensor(cot))
    xt = torch.tensor(x, requires_grad=True)
    got = tl(xt)
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.weight.grad.numpy(),
                               np.asarray(jl.weight.grad._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.bias.grad.numpy(),
                               np.asarray(jl.bias.grad._data),
                               rtol=TOL, atol=TOL)


def test_conv2d_transpose_init_draws_the_jax_xavier_range():
    w = tnn.Conv2DTranspose(6, 8, 3, groups=2, device="cpu",
                            generator=torch.Generator().manual_seed(0)
                            ).weight.detach()
    lim = np.sqrt(6.0 / ((6 + 4) * 9))       # fans of [in, out/g, kh, kw]
    assert w.shape == (6, 4, 3, 3)
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.9 * lim


# ------------------------------------------------------------ batch norm

_BN = {
    "1d_nc": (jnn.BatchNorm1D, tnn.BatchNorm1D, (8, 4), {}),
    "1d_ncl": (jnn.BatchNorm1D, tnn.BatchNorm1D, (4, 3, 5), {}),
    "1d_nlc": (jnn.BatchNorm1D, tnn.BatchNorm1D, (4, 5, 3),
               {"data_format": "NLC"}),
    "2d_nhwc": (jnn.BatchNorm2D, tnn.BatchNorm2D, (2, 4, 5, 3),
                {"data_format": "NHWC"}),
    "3d_ncdhw_default": (jnn.BatchNorm3D, tnn.BatchNorm3D, (2, 3, 2, 4, 4),
                         {}),
    "3d_ndhwc": (jnn.BatchNorm3D, tnn.BatchNorm3D, (2, 2, 3, 3, 4),
                 {"data_format": "NDHWC"}),
    "2d_global_stats": (jnn.BatchNorm2D, tnn.BatchNorm2D, (2, 3, 4, 4),
                        {"use_global_stats": True}),
}


@pytest.mark.parametrize("case", sorted(_BN))
def test_batch_norm_layers_match_jax_in_train_and_eval(case):
    """Outputs, gradients and the running stats a train forward leaves
    (untouched under use_global_stats); then the eval forward."""
    jcls, tcls, shape, kw = _BN[case]
    c = shape[1] if kw.get("data_format", "NC")[:2] == "NC" else shape[-1]
    jl, tl = jcls(c, **kw), tcls(c, device="cpu", **kw)
    stats = {"_mean": _rand((c,), 6, 0.1), "_variance": np.abs(
        _rand((c,), 7)) + 0.5, "weight": _rand((c,), 8), "bias":
        _rand((c,), 9)}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in stats.items()})
    tl.load_state_dict(convert.from_jax_state(stats))
    x = _rand(shape, 10, 2.0, 1.0)
    for mode in ("train", "eval"):
        getattr(jl, mode)()
        getattr(tl, mode)()
        jx = paddle.to_tensor(x)
        jx.stop_gradient = False
        want = jl(jx)
        cot = _rand(shape, 11)
        want.backward(paddle.to_tensor(cot))
        xt = torch.tensor(x, requires_grad=True)
        got = tl(xt)
        got.backward(torch.tensor(cot))
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want._data), rtol=TOL,
                                   atol=TOL, err_msg=mode)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx.grad._data),
                                   rtol=1e-4, atol=1e-4, err_msg=mode)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tl, name).numpy(),
                np.asarray(getattr(jl, name)._data), rtol=TOL, atol=TOL,
                err_msg=f"{mode} {name}")
    if kw.get("use_global_stats"):
        np.testing.assert_array_equal(tl._mean.numpy(), stats["_mean"])


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_fluid_batch_norm_with_act_matches_jax(act):
    jl = jnn.BatchNorm(3, act=act)
    tl = tnn.BatchNorm(3, act=act, device="cpu")
    x = _rand((2, 3, 4, 4), 12, 4.0)
    want = np.asarray(jl(paddle.to_tensor(x))._data)
    got = tl(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fluid_batch_norm_use_global_stats_keeps_the_buffers():
    tl = tnn.BatchNorm(3, use_global_stats=True, device="cpu")
    tl.train()
    y = tl(torch.tensor(_rand((2, 3, 4, 4), 13, 3.0, 2.0)))
    assert torch.equal(tl._mean, torch.zeros(3))
    assert torch.equal(tl._variance, torch.ones(3))
    assert y.shape == (2, 3, 4, 4)


# -------------------------------------------------- activations, flatten

def test_relu6_flatten_identity_match_jax():
    x = _rand((2, 3, 4, 5), 14, 5.0)
    _both(lambda a: JK.relu6(a), TF.relu6, (x,))
    jf, tf = jnn.Flatten(1, 2), tnn.Flatten(1, 2)
    assert tuple(tf(torch.tensor(x)).shape) == tuple(
        jf(paddle.to_tensor(x)).shape) == (2, 12, 5)
    assert tuple(TF.flatten(torch.tensor(x)).shape) == (120,)
    t = torch.tensor(x)
    assert tnn.Identity()(t) is t
    np.testing.assert_array_equal(
        tnn.ReLU6()(torch.tensor(x)).numpy(),
        np.asarray(jnn.ReLU6()(paddle.to_tensor(x))._data))


# ---------------------------------------------------------------- losses

_CE = {
    "hard_n1": dict(shape=(6, 5), label="n1"),
    "hard_n": dict(shape=(6, 5), label="n"),
    "sum": dict(shape=(6, 5), label="n1", reduction="sum"),
    "none": dict(shape=(6, 5), label="n", reduction="none"),
    "weight_mean": dict(shape=(6, 5), label="n1", weight=True),
    "weight_sum": dict(shape=(6, 5), label="n", weight=True,
                       reduction="sum"),
    "ignore_index": dict(shape=(6, 5), label="n1", ignore_index=2),
    "soft": dict(shape=(6, 5), label="soft", soft_label=True),
    "axis1": dict(shape=(3, 5, 4), label="axis1", axis=1),
    "no_softmax": dict(shape=(6, 5), label="n1", use_softmax=False),
}


def _ce_case(case):
    cfg = dict(_CE[case])
    shape, kind = cfg.pop("shape"), cfg.pop("label")
    rs = np.random.RandomState(15)
    logits = rs.randn(*shape).astype(np.float32)
    if cfg.get("use_softmax") is False:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    n, c = shape[0], shape[-1] if cfg.get("axis", -1) == -1 else shape[1]
    if kind == "soft":
        label = rs.rand(n, c).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    elif kind == "axis1":
        label = rs.randint(0, c, (n, 1, shape[2])).astype(np.int64)
    else:
        label = rs.randint(0, c, (n, 1) if kind == "n1" else (n,)).astype(
            np.int64)
        if "ignore_index" in cfg:
            label[[0, 3]] = cfg["ignore_index"]
    if cfg.pop("weight", False):
        cfg["weight"] = rs.rand(c).astype(np.float32) + 0.5
    return logits, label, cfg


@pytest.mark.parametrize("case", sorted(_CE))
def test_cross_entropy_matches_jax_with_gradient(case):
    logits, label, cfg = _ce_case(case)
    jw = cfg.pop("weight", None)
    jkw = dict(cfg, weight=None if jw is None else paddle.to_tensor(jw))
    tkw = dict(cfg, weight=None if jw is None else torch.tensor(jw))
    jx = paddle.to_tensor(logits)
    jx.stop_gradient = False
    want = JF.cross_entropy(jx, paddle.to_tensor(label), **jkw)
    cot = _rand(np.asarray(want._data).shape, 16)
    want.backward(paddle.to_tensor(cot))
    xt = torch.tensor(logits, requires_grad=True)
    got = tnn.CrossEntropyLoss(**tkw)(xt, torch.tensor(label))
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=TOL, atol=TOL)


def test_softmax_with_cross_entropy_and_mse_match_jax():
    logits, label, _ = _ce_case("ignore_index")
    want = JF.softmax_with_cross_entropy(paddle.to_tensor(logits),
                                         paddle.to_tensor(label),
                                         ignore_index=2, return_softmax=True)
    got = TF.softmax_with_cross_entropy(torch.tensor(logits),
                                        torch.tensor(label), ignore_index=2,
                                        return_softmax=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), rtol=TOL,
                                   atol=TOL)
    a, b = _rand((4, 3), 17), _rand((4, 3), 18)
    for red in ("mean", "sum", "none"):
        want = JF.mse_loss(paddle.to_tensor(a), paddle.to_tensor(b), red)
        got = tnn.MSELoss(red)(torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- models

def _no_dropout(*nets):
    for net in nets:
        for m in net.sublayers() if hasattr(net, "sublayers") else \
                net.modules():
            if type(m).__name__ == "Dropout":
                m.p = 0.0


def _model_parity(jnet, tnet, x, classes, out_tol=1e-4, grad_tol=1e-4,
                  stats_tol=1e-5):
    """One train-mode forward and backward of both, at dropout 0: logits
    and the cross-entropy loss within `out_tol`, every gradient within
    `grad_tol` of the JAX tensor's largest entry; BN running stats
    within `stats_tol` of theirs."""
    sd = _np_state(jnet)
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(convert.from_jax_state(sd), strict=True)
    _no_dropout(jnet, tnet)
    label = np.random.RandomState(19).randint(0, classes, (x.shape[0], 1))
    jnet.train()
    tnet.train()
    jout = jnet(paddle.to_tensor(x))
    jloss = JF.cross_entropy(jout, paddle.to_tensor(label))
    jloss.backward()
    tout = tnet(torch.tensor(x))
    tloss = TF.cross_entropy(tout, torch.tensor(label))
    tloss.backward()

    def near(got, want, what, tol=1e-4):
        # a convolution bias before a BN has a zero gradient in exact
        # arithmetic: a scale floor of 1e-2 holds it to 1e-6 absolute
        scale = max(np.abs(want).max(), 1e-2)
        err = np.abs(got - want).max() / scale
        assert err <= tol, (what, err)

    near(tout.detach().numpy(), np.asarray(jout._data), "logits", out_tol)
    near(tloss.detach().numpy(), np.asarray(jloss._data), "loss", out_tol)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jnet.named_parameters()}
    for n, p in tnet.named_parameters():
        near(p.grad.numpy(), jgrads[n], n, grad_tol)
    jsd = _np_state(jnet)
    for n, b in tnet.named_buffers():
        near(b.numpy(), jsd[n], n, stats_tol)


def test_lenet_matches_jax():
    paddle.seed(20)
    _model_parity(JaxLeNet(), LeNet(device="cpu"),
                  _rand((4, 1, 28, 28), 21), 10)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg_make_layers_short_cfg_matches_jax(batch_norm):
    """VGG at the published classifier width (25088 -> 4096 -> 4096) over a
    short feature stack: 16 x 16 images pooled to 2 x 2, then the 7 x 7
    adaptive pool's uneven windows."""
    cfg = [8, "M", 16, 16, "M", 512, "M", "M"]
    paddle.seed(22)
    jnet = JaxVGG(jax_make_layers(cfg, batch_norm), num_classes=6)
    tnet = VGG(make_layers(cfg, batch_norm, device="cpu"), num_classes=6,
               device="cpu")
    _model_parity(jnet, tnet, _rand((2, 3, 16, 16), 23), 6)


@pytest.mark.parametrize("version", [1, 2])
def test_mobilenet_scale_quarter_matches_jax(version):
    """Batch 8 of 32 x 32: the last stage's BN normalizes over 8 values,
    which makes the step ill-conditioned. Against the port's float64 step
    on the same weights, the JAX float32 gradients lie up to 6.8e-3 of
    the largest entry away (V2's features.0.bn.weight; 1.6e-3 in V1) and
    the port's float32 ones up to 1.2e-3; the logits 2.3e-5. So the
    limits are 5e-4 (logits, loss), 1e-2 (gradients) and 5e-5 (running
    stats, 1.5e-5 read)."""
    paddle.seed(24)
    jfn, tfn = ((jax_mobilenet_v1, mobilenet_v1) if version == 1
                else (jax_mobilenet_v2, mobilenet_v2))
    jnet = jfn(scale=0.25, num_classes=10)
    tnet = tfn(scale=0.25, num_classes=10, device="cpu")
    _model_parity(jnet, tnet, _rand((8, 3, 32, 32), 25), 10, 5e-4, 1e-2,
                  5e-5)


def test_vision_model_constructors_build_the_published_trees():
    g = torch.Generator().manual_seed(0)
    net = mobilenet_v2(device="cpu", generator=g)
    n = sum(p.numel() for p in net.parameters())
    assert n == 3504872           # MobileNetV2 1.0, 1000 classes
    groups = [m._groups for m in net.modules() if isinstance(m, tnn.Conv2D)]
    assert groups.count(1) < len(groups)    # the depthwise convolutions
    with pytest.raises(ValueError, match="pretrained"):
        mobilenet_v1(pretrained=True, device="cpu")


# --------------------------------------------- weights through the files

def test_pdparams_carry_weights_between_the_packages_both_ways(tmp_path):
    """JAX paddle.save(state_dict) -> port load -> load_state_dict gives
    the JAX model's outputs, and port save -> JAX paddle.load ->
    set_state_dict gives the port model's: every tensor bit for bit."""
    paddle.seed(26)
    jnet = jax_mobilenet_v2(scale=0.25, num_classes=5)
    jnet.eval()
    paddle.save(jnet.state_dict(), str(tmp_path / "jax.pdparams"))
    tnet = mobilenet_v2(scale=0.25, num_classes=5, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    tnet.eval()
    tnet.load_state_dict(tio.load(str(tmp_path / "jax.pdparams")))
    jsd = _np_state(jnet)
    for k, v in tnet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)
    x = _rand((2, 3, 32, 32), 27)
    with torch.no_grad():
        got = tnet(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet(paddle.to_tensor(x))._data),
                               rtol=1e-4, atol=1e-5)

    tnet2 = LeNet(device="cpu", generator=torch.Generator().manual_seed(2))
    tio.save(tnet2.state_dict(), str(tmp_path / "port.pdparams"))
    jnet2 = JaxLeNet()
    jnet2.set_state_dict(paddle.load(str(tmp_path / "port.pdparams")))
    jsd2 = _np_state(jnet2)
    for k, v in tnet2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd2[k], err_msg=k)
