"""The port's new layers and `Layer` against the JAX package's, on the
CPU.

Each layer is built in JAX (seeded), its `state_dict()` loaded into the
port's through `convert.from_jax_state` (the parameter and buffer names
and layouts match), and both run forward and backward on the same
float32 inputs: the outputs and the gradients with respect to the
inputs and to every parameter (of <output, a fixed random cotangent>)
agree within rtol 1e-5 / atol 1e-6 (float32 sums in another order).
`Layer` itself: `state_dict()` leaves non-persistable buffers out, the
forward pre- and post-hooks fire and come off again, and the traversal,
`set_state_dict` and `clear_gradients` behave as Paddle's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from _torch_parity import np_state

torch.set_num_threads(2)
CPU = {"device": "cpu"}


def _cot(shape, seed):
    return np.random.RandomState(seed).uniform(0.5, 1.5, shape).astype(
        np.float32)


def _run_jax(layer, xs, diff):
    ts = [paddle.to_tensor(x, stop_gradient=not d) for x, d in zip(xs, diff)]
    out = layer(*ts)
    y = np.asarray(out.numpy())
    (out * paddle.to_tensor(_cot(y.shape, 1))).sum().backward()
    gx = [np.asarray(t.grad.numpy()) for t, d in zip(ts, diff) if d]
    gp = {}
    for n, p in layer.named_parameters():
        gp[n] = None if p.grad is None else np.asarray(p.grad.numpy())
    return y, gx, gp


def _run_port(layer, xs, diff):
    ts = [torch.from_numpy(x.copy()).requires_grad_(d)
          for x, d in zip(xs, diff)]
    out = layer(*ts)
    y = out.detach().numpy()
    (out * torch.from_numpy(_cot(y.shape, 1))).sum().backward()
    gx = [t.grad.numpy() for t, d in zip(ts, diff) if d]
    gp = {n: None if p.grad is None else p.grad.numpy()
          for n, p in layer.named_parameters()}
    return y, gx, gp


L = []


def layer_case(name, make, xs, diff=None, rtol=1e-5, atol=1e-6):
    """make(nn, kw): the layer in either package (kw: the port's device
    for layers with parameters or buffers)."""
    diff = diff or [np.asarray(x).dtype.kind == "f" for x in xs]
    L.append(pytest.param(make, xs, diff, rtol, atol, id=name))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


x23 = _x((2, 3, 8), 0)
img = _x((2, 4, 5, 6), 1)
for nm in ("Sigmoid", "Softsign", "Mish", "Hardswish", "Hardsigmoid",
           "Silu", "Swish", "LogSigmoid", "Tanhshrink"):
    layer_case(nm, lambda m, kw, _n=nm: getattr(m, _n)(), [x23])
layer_case("GELU", lambda m, kw: m.GELU(), [x23])
layer_case("GELU_tanh", lambda m, kw: m.GELU(True), [x23])
layer_case("LeakyReLU", lambda m, kw: m.LeakyReLU(0.1), [x23])
layer_case("ELU", lambda m, kw: m.ELU(0.5), [x23])
layer_case("SELU", lambda m, kw: m.SELU(), [x23])
layer_case("PReLU", lambda m, kw: m.PReLU(4, 0.2, **kw), [img])
layer_case("PReLU_shared", lambda m, kw: m.PReLU(**kw), [x23])
layer_case("Softmax", lambda m, kw: m.Softmax(1), [x23])
layer_case("LogSoftmax", lambda m, kw: m.LogSoftmax(), [x23])
layer_case("Softplus", lambda m, kw: m.Softplus(2.0, 5.0), [x23 * 4])
layer_case("Hardtanh", lambda m, kw: m.Hardtanh(-0.5, 0.5), [x23])
layer_case("Hardshrink", lambda m, kw: m.Hardshrink(0.3), [x23])
layer_case("Softshrink", lambda m, kw: m.Softshrink(0.3), [x23])
layer_case("Maxout", lambda m, kw: m.Maxout(2), [img])
layer_case("Upsample_nearest", lambda m, kw: m.Upsample(scale_factor=2),
           [img])
layer_case("Upsample_bilinear", lambda m, kw: m.Upsample(
    size=[7, 9], mode="bilinear"), [img], rtol=1e-5, atol=2e-6)
layer_case("UpsamplingBilinear2D",
           lambda m, kw: m.UpsamplingBilinear2D(size=[8, 4]), [img])
layer_case("UpsamplingNearest2D",
           lambda m, kw: m.UpsamplingNearest2D(scale_factor=2), [img])
layer_case("PixelShuffle", lambda m, kw: m.PixelShuffle(2), [img])
layer_case("Pad2D", lambda m, kw: m.Pad2D([1, 2, 0, 1], "reflect"), [img])
layer_case("Pad2D_int", lambda m, kw: m.Pad2D(1, value=0.5), [img])
layer_case("Unfold", lambda m, kw: m.Unfold([2, 3], 1, 1), [img])
layer_case("CosineSimilarity", lambda m, kw: m.CosineSimilarity(2),
           [x23, _x((2, 3, 8), 2)])
layer_case("Bilinear", lambda m, kw: m.Bilinear(5, 6, 3, **kw),
           [_x((4, 5), 3), _x((4, 6), 4)])
layer_case("Conv1D", lambda m, kw: m.Conv1D(3, 5, 3, padding="SAME", **kw),
           [_x((2, 3, 9), 5)])
# the JAX conv1d takes string paddings only (an int one raises there)
layer_case("Conv1D_groups", lambda m, kw: m.Conv1D(4, 6, 2, stride=2,
                                                   padding="VALID",
                                                   groups=2, **kw),
           [_x((2, 4, 9), 6)])
layer_case("GroupNorm", lambda m, kw: m.GroupNorm(2, 4, **kw), [img])
layer_case("InstanceNorm2D", lambda m, kw: m.InstanceNorm2D(4, **kw), [img])
layer_case("LocalResponseNorm", lambda m, kw: m.LocalResponseNorm(3), [img])
layer_case("RMSNorm", lambda m, kw: m.RMSNorm(8, **kw), [x23])
layer_case("L1Loss", lambda m, kw: m.L1Loss(), [x23, _x((2, 3, 8), 7)])
layer_case("SmoothL1Loss", lambda m, kw: m.SmoothL1Loss("sum", 0.5),
           [x23, _x((2, 3, 8), 8)])
layer_case("NLLLoss", lambda m, kw: m.NLLLoss(),
           [np.log(np.random.RandomState(9).dirichlet(np.ones(4), 5)).astype(
               np.float32), np.array([1, 0, 3, 2, 1])])
layer_case("BCELoss", lambda m, kw: m.BCELoss(),
           [np.random.RandomState(10).uniform(0.1, 0.9, (3, 4)).astype(
               np.float32), (np.arange(12).reshape(3, 4) % 2).astype(
                   np.float32)], [True, False])
layer_case("BCEWithLogitsLoss", lambda m, kw: m.BCEWithLogitsLoss(),
           [_x((3, 4), 11), (np.arange(12).reshape(3, 4) % 2).astype(
               np.float32)], [True, False])
layer_case("KLDivLoss", lambda m, kw: m.KLDivLoss("sum"),
           [np.log(np.random.RandomState(12).dirichlet(np.ones(4), 3)).astype(
               np.float32), np.random.RandomState(13).dirichlet(
                   np.ones(4), 3).astype(np.float32)], [True, False])
layer_case("MarginRankingLoss", lambda m, kw: m.MarginRankingLoss(0.2),
           [_x((3, 4), 14), _x((3, 4), 15),
            np.sign(_x((3, 4), 16)).astype(np.float32)], [True, True, False])


@pytest.mark.parametrize("make,xs,diff,rtol,atol", L)
def test_layer_matches_jax(make, xs, diff, rtol, atol):
    paddle.seed(3)
    jl = make(jnn, {})
    pl = make(tnn, CPU)
    state = np_state(jl)
    assert set(state) == set(pl.state_dict())
    pl.load_state_dict(convert.from_jax_state(state), strict=True)
    jy, jgx, jgp = _run_jax(jl, xs, diff)
    py, pgx, pgp = _run_port(pl, xs, diff)
    np.testing.assert_allclose(py, jy, rtol=rtol, atol=atol)
    for a, b in zip(pgx, jgx):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    assert set(pgp) == set(jgp)
    for n in pgp:
        np.testing.assert_allclose(pgp[n], jgp[n], rtol=rtol, atol=atol,
                                   err_msg=n)


@pytest.mark.parametrize("power_iters", [1, 3])
def test_spectral_norm_matches_jax_and_updates_its_buffers(power_iters):
    """SpectralNorm's u / v start as the JAX layer's (unit draws of
    numpy's RandomState(0)); two forwards update them the same way."""
    from paddle_tpu.nn.layer.common import SpectralNorm

    w = _x((6, 4, 3), 17)
    jl = SpectralNorm([6, 4, 3], dim=1, power_iters=power_iters)
    pl = tnn.SpectralNorm([6, 4, 3], dim=1, power_iters=power_iters, **CPU)
    for k, v in np_state(jl).items():
        np.testing.assert_array_equal(pl.state_dict()[k].numpy(), v)
    for _ in range(2):
        jy = np.asarray(jl(paddle.to_tensor(w)).numpy())
        py = pl(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-6)
    for k, v in np_state(jl).items():
        np.testing.assert_allclose(pl.state_dict()[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6)
    wt = torch.from_numpy(w).requires_grad_(True)
    pl(wt).sum().backward()
    assert wt.grad is not None and bool(torch.isfinite(wt.grad).all())


def test_containers_match_jax_names():
    paddle.seed(4)
    jl = jnn.LayerList([jnn.Linear(3, 4), jnn.Linear(4, 2)])
    jl.append(jnn.Conv1D(2, 2, 1))
    pl = tnn.LayerList([tnn.Linear(3, 4, **CPU), tnn.Linear(4, 2, **CPU)])
    pl.append(tnn.Conv1D(2, 2, 1, **CPU))
    assert set(np_state(jl)) == set(pl.state_dict())
    pl.load_state_dict(convert.from_jax_state(np_state(jl)))
    assert len(pl) == 3 and isinstance(pl[-1], tnn.Conv1D)
    assert len(pl[1:]) == 2
    pl.insert(0, tnn.Identity())
    assert [type(m).__name__ for m in pl] == ["Identity", "Linear", "Linear",
                                              "Conv1D"]
    d = tnn.LayerDict({"a": tnn.Sigmoid(), "b": tnn.ReLU()})
    d["c"] = tnn.GELU()
    assert list(d.keys()) == ["a", "b", "c"] and "b" in d and len(d) == 3
    plist = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    plist.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(plist) == 2 and list(dict(plist.named_parameters())) == [
        "0", "1"]


class _Net(tnn.Layer):
    def __init__(self, device=None):
        super().__init__(device=device,
                         generator=torch.Generator().manual_seed(0))
        self.w = self.create_parameter([4, 3])
        self.b = self.create_parameter([3], is_bias=True)
        self.register_buffer("steps", torch.zeros(()), persistable=True)
        self.register_buffer("scratch", torch.zeros(3), persistable=False)
        self.inner = tnn.LayerList([tnn.RMSNorm(3, device=device)])

    def forward(self, x):
        return self.inner[0](x @ self.w + self.b)


def test_layer_state_dict_leaves_non_persistable_buffers_out():
    net = _Net("cpu")
    assert list(net.state_dict()) == ["w", "b", "steps", "inner.0.weight"]
    assert "scratch" in dict(net.named_buffers())
    missing, unexpected = net.set_state_dict(
        {"w": np.ones((4, 3), np.float32), "b": torch.full((3,), 2.0),
         "bogus": np.zeros(1)})
    assert missing == ["steps", "inner.0.weight"] and unexpected == ["bogus"]
    assert torch.equal(net.w.detach(), torch.ones(4, 3))
    assert torch.equal(net.b.detach(), torch.full((3,), 2.0))


def test_layer_hooks_fire_and_come_off():
    net = _Net("cpu")
    seen = []
    pre = net.register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2.0,))
    post = net.register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.shape) or out + 1.0)
    x = torch.ones(2, 4)
    base = net.inner[0](x * 2.0 @ net.w + net.b)
    torch.testing.assert_close(net(x), base + 1.0)
    assert seen == [torch.Size([2, 3])]
    pre.remove()
    post.remove()
    torch.testing.assert_close(net(x), net.inner[0](x @ net.w + net.b))
    assert len(seen) == 1


def test_jax_hooks_and_state_dict_agree_with_the_port():
    """The same hooks on a JAX Layer give the same numbers."""
    paddle.seed(5)
    jl = jnn.Linear(4, 3)
    pl = tnn.Linear(4, 3, **CPU)
    pl.load_state_dict(convert.from_jax_state(np_state(jl)))
    wrapper = tnn.LayerList([pl])
    h = wrapper.register_forward_post_hook(lambda l, i, o: o)
    assert isinstance(h, tnn.HookRemoveHelper)
    jl.register_forward_pre_hook(lambda layer, inputs: (inputs[0] * 3.0,))
    x = _x((2, 4), 18)
    want = np.asarray(jl(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(pl(torch.from_numpy(x) * 3.0).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_layer_traversal_names_and_gradients():
    net = _Net("cpu")
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 3
    assert len(net.parameters(include_sublayers=False)) == 2
    names = [n for n, _ in net.named_sublayers()]
    assert names == ["inner", "inner.0"]
    assert net.sublayers(include_self=True)[0] is net
    assert net.full_name().startswith("_net_")
    net(torch.ones(2, 4)).sum().backward()
    assert all(p.grad is not None for p in net.parameters())
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.add_sublayer("extra", tnn.Sigmoid())
    net.add_parameter("gain", torch.nn.Parameter(torch.ones(1)))
    assert "gain" in net.state_dict() and hasattr(net, "extra")


def test_layer_parameters_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    tnn.LayerList([tnn.Sigmoid()])        # no parameter: no device asked
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _Net()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.GroupNorm(2, 4)


def test_dropout_layers_are_identity_in_eval():
    x = torch.randn(4, 6, 3, 3)
    for layer in (tnn.Dropout2D(0.5), tnn.AlphaDropout(0.5)):
        assert torch.equal(layer.eval()(x), x)
        y = layer.train()(x)
        assert y.shape == x.shape and not torch.equal(y, x)


def test_every_jax_layer_is_ported_or_listed():
    """Every JAX `nn` class is ported (SyncBatchNorm, the last one, came
    with the multi-GPU training slice)."""
    import inspect

    jax_names = {n for n, v in vars(jnn).items()
                 if not n.startswith("_") and inspect.isclass(v)}
    missing = sorted(jax_names - set(tnn.__all__))
    assert missing == [], missing


#: names of the port's `nn.functional` and `nn` before the library came
#: (their own slices test them) and the library's non-layer exports
_BEFORE = {
    "functional": ["relu", "relu6", "gelu", "tanh", "flatten", "dropout",
                   "draw_seed", "scaled_dot_product_attention",
                   "linear_int8", "embedding_int8", "lora_delta", "conv2d",
                   "conv2d_transpose", "max_pool2d", "avg_pool2d",
                   "adaptive_avg_pool2d", "adaptive_max_pool2d",
                   "max_pool1d", "avg_pool1d", "batch_norm", "cross_entropy",
                   "softmax_with_cross_entropy", "mse_loss"],
    "nn": ["functional", "initializer", "Parameter", "Layer", "ParamAttr",
           "HookRemoveHelper", "RNNCellBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "AvgPool1D", "AvgPool2D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "Conv2D",
           "Conv2DTranspose", "CrossEntropyLoss", "Dropout", "Embedding",
           "Flatten", "Identity", "LayerNorm", "Linear", "MaxPool1D",
           "MaxPool2D", "MSELoss", "MultiHeadAttention", "ReLU", "ReLU6",
           "Sequential", "Tanh", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]}


def test_library_sweep_covers_every_new_name_and_runs():
    """`testing.sweep` (chip_smoke phase 34 a) holds a case for every
    tensor function, every new `nn.functional` entry and every new
    layer, or names it in EXCLUDED with its reason; each case runs on the
    CPU and repeats bit for bit."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.testing import sweep

    cases = sweep.cases()
    covered = {c.name.split(".", 1)[-1] for c in cases}
    new = (set(T.tensor.__all__)
           | (set(TF.__all__) - set(_BEFORE["functional"]))
           | (set(tnn.__all__) - set(_BEFORE["nn"])))
    assert sorted(new - covered - set(sweep.EXCLUDED)) == []
    assert len({c.name for c in cases}) == len(cases)
    for c in cases:
        a, b = sweep.run(c, "cpu"), sweep.run(c, "cpu")
        assert sweep.compare(a, b) == (0.0, True), c.name
        assert c.creates or a[1] or not c.wrt, c.name   # gradients made
