"""The port's top-level autograd names, `autograd/`, `seed`, the places
and `device/` against the JAX package's, on the CPU (the counterpart of
`tests/test_grad_api.py`'s eager cases).

The same numpy inputs go through `paddle_tpu.grad` and
`paddle_tpu_torch.grad`: intermediate inputs, `grad_outputs` seeding and
its length check, several outputs in one pass, `allow_unused`, repeated
inputs, `.grad` left untouched, and a double grad (a gradient penalty
through a conv + linear stack), all equal within 1e-6 relative; a
`PyLayer` gives the JAX PyLayer's output and gradient; the grad modes,
`seed`, `set_device` / `get_device` and the places behave as JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core.device import resolve_device

torch.set_num_threads(1)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


def _j(a):
    return jp.to_tensor(a, stop_gradient=False)


def _t(a):
    return torch.tensor(a, requires_grad=True)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x._data)


def test_grad_intermediate_outputs_seeds_and_untouched_grads():
    x0 = np.array([1., 2., 3.], np.float32)
    got = {}
    for lib, mk in (("jax", _j), ("port", _t)):
        m = jp if lib == "jax" else tp
        x = mk(x0)
        y = x * x
        z = (y * 3.0).sum()
        gy, gx = m.grad(z, [y, x])
        # seeded, and two outputs in one reverse pass
        w = mk(np.array([1., 2.], np.float32))
        (gw,) = m.grad([w * 2.0, w * w], [w], grad_outputs=[
            np.array([10., 20.], np.float32), None])
        # the same input twice
        g1, g2 = m.grad((x * x).sum(), [x, x])
        got[lib] = [_np(v) for v in (gy, gx, gw, g1, g2)]
        assert (x.grad is None) if lib == "port" else (x._grad is None)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_allow_unused_and_length_check_as_jax():
    for m, mk in ((jp, _j), (tp, _t)):
        x, y = mk(np.ones(1, np.float32)), mk(np.ones(1, np.float32))
        with pytest.raises(RuntimeError):
            m.grad(x * 2.0, [y])
        gx, gy = m.grad(x * 2.0, [x, y], allow_unused=True)
        assert gy is None and np.allclose(_np(gx), 2.0)
        with pytest.raises(ValueError, match="length of grad_outputs"):
            m.grad([x * 2.0], [x], grad_outputs=[None, None])


def _penalty_stack(lib, w_conv, w_lin, x0):
    """A WGAN-GP style penalty: ||d out / d x||^2 through conv + linear,
    differentiated again with respect to the weights."""
    if lib == "jax":
        import paddle_tpu.nn.functional as F

        x, wc, wl = _j(x0), _j(w_conv), _j(w_lin)
        h = F.conv2d(x, wc, padding=1)
        out = (jp.tanh(h).reshape([x0.shape[0], -1]) @ wl).sum()
        (gx,) = jp.grad(out, [x], create_graph=True)
        pen = (gx * gx).sum()
        pen.backward()
        return [_np(v) for v in (pen, wc.grad, wl.grad)]
    x, wc, wl = _t(x0), _t(w_conv), _t(w_lin)
    h = tp.nn.functional.conv2d(x, wc, padding=1)
    out = (torch.tanh(h).reshape(x0.shape[0], -1) @ wl).sum()
    (gx,) = tp.grad(out, [x], create_graph=True)
    pen = (gx * gx).sum()
    pen.backward()
    return [_np(v) for v in (pen, wc.grad, wl.grad)]


def test_double_grad_gradient_penalty_matches_jax():
    rs = np.random.RandomState(0)
    w_conv = (rs.randn(3, 2, 3, 3) * 0.3).astype(np.float32)
    w_lin = (rs.randn(3 * 5 * 5, 1) * 0.1).astype(np.float32)
    x0 = rs.randn(2, 2, 5, 5).astype(np.float32)
    got = _penalty_stack("port", w_conv, w_lin, x0)
    want = _penalty_stack("jax", w_conv, w_lin, x0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_grad_modes_and_backward():
    x = _t(np.ones(2, np.float32))
    with tp.no_grad():
        assert not tp.is_grad_enabled()
        y = x * 2
        with tp.enable_grad():
            assert tp.is_grad_enabled()
    assert not y.requires_grad and tp.is_grad_enabled()
    a, b = _t(np.ones(2, np.float32)), _t(np.ones(2, np.float32))
    tp.autograd.backward([(a * 3).sum(), (b * b).sum()])
    np.testing.assert_array_equal(a.grad.numpy(), 3.0)
    np.testing.assert_array_equal(b.grad.numpy(), 2.0)


def _pylayers():
    class JCube(jp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3.0 * x * x * ctx.scale

    class TCube(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor
            return g * 3.0 * x * x * ctx.scale

    return JCube, TCube


def test_pylayer_matches_jax():
    JCube, TCube = _pylayers()
    x0 = np.array([0.5, -1.5, 2.0], np.float32)
    jx, tx = _j(x0), _t(x0)
    jy, ty = JCube.apply(jx, scale=2.0), TCube.apply(tx, scale=2.0)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-6)
    with tp.no_grad():
        assert not TCube.apply(tx).requires_grad


def test_seed_repeats_draws():
    for m in (jp, tp):
        assert m.seed(123) == 123
    assert tp.core.random.get_seed() == tp.get_seed() == 123
    a = tp.rand([4], device="cpu")
    tp.seed(123)
    np.testing.assert_array_equal(a.numpy(),
                                  tp.rand([4], device="cpu").numpy())


def test_places_and_set_device():
    assert tp.CPUPlace() == tp.CPUPlace() and repr(tp.CPUPlace()) == \
        repr(jp.CPUPlace())
    assert tp.CUDAPlace(1).get_device_id() == 1
    assert tp.is_compiled_with_xpu() is jp.is_compiled_with_xpu() is False
    assert tp.is_compiled_with_tpu() is False
    assert isinstance(tp.is_compiled_with_cuda(), bool)
    assert tp.device.device_count() == torch.cuda.device_count()
    assert tp.get_device() == "gpu:0"          # device=None: the card
    try:
        for m in (jp, tp):
            assert isinstance(m.set_device("cpu"), m.CPUPlace)
            assert m.get_device() == "cpu"
        assert resolve_device(None) == torch.device("cpu")
        emb = tp.nn.Embedding(4, 2)               # device=None now asks
        assert emb.weight.device.type == "cpu"    # for the CPU
        tp.device.synchronize()
        with pytest.raises(ValueError):
            tp.set_device("npu")
        assert isinstance(tp.set_device("gpu:0"), tp.CUDAPlace)
        assert tp.get_device() == "gpu:0"
    finally:
        tp.set_device("gpu")
        jp.set_device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_top_level_names():
    assert tp.Tensor is torch.Tensor
    assert tp.complex64 is torch.complex64 and tp.complex128 is \
        torch.complex128
    for name in ("grad", "no_grad", "enable_grad", "is_grad_enabled", "seed",
                 "set_device", "get_device", "get_flags", "set_flags",
                 "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
                 "XPUPlace", "autograd", "distribution", "sparse", "utils",
                 "slim", "dataset", "device", "text"):
        assert hasattr(jp, name) and hasattr(tp, name), name
    try:
        for m in (jp, tp):
            assert m.in_dynamic_mode()
            m.enable_static()
            assert not m.in_dynamic_mode()
    finally:
        jp.disable_static()
        tp.disable_static()
    assert tp.in_dynamic_mode()
    for m in (jp, tp):
        with pytest.raises(NotImplementedError):
            m.nn.utils_spectral_norm(None)
