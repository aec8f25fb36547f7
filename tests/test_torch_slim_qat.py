"""The port's eager QAT (`slim/quant.py`) against the JAX package's, on the
CPU (the counterpart of `tests/test_quantization.py:116`-:175).

`fake_quant` quantizes to the JAX grid and passes the straight-through
gradient where the JAX one does; `ImperativeQuantAware` keeps the
state-dict keys; a Linear stack and a small conv net, quantized in both
packages and loaded with the same weights (`convert.from_jax_state`),
train 2-3 Adam steps to the JAX losses and weights within 1e-5 relative
(the fake-quant grid is exact; the float32 products around it are summed
in another order), with the moving activation max a float64 tensor equal
to the JAX Python float. The QAT export and PTQ wait for item 8.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import nn as jnn
from paddle_tpu.slim import ImperativeQuantAware as JQAT
from paddle_tpu.slim.quant import fake_quant as jfake
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.slim import ImperativeQuantAware
from paddle_tpu_torch.slim.quant import (QuantedConv2D, QuantedLinear,
                                         fake_quant)

torch.set_num_threads(1)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


def test_fake_quant_grid_and_straight_through_gradient():
    import jax

    x = np.linspace(-2, 2, 9).astype("float32")
    s = 1.5 / 127
    xt = torch.tensor(x, requires_grad=True)
    q = fake_quant(xt, s)
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(jfake(x, s)))
    q.sum().backward()
    g = np.asarray(jax.grad(lambda v: jfake(v, s).sum())(x))
    np.testing.assert_array_equal(xt.grad.numpy(), g)
    assert set(np.unique(g)) == {0.0, 1.0}


def _nets(kind):
    jp.seed(3)
    if kind == "linear":
        jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                              jnn.Linear(16, 1))
        tnet = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                              tnn.Linear(16, 1, device="cpu"))
    else:
        jnet = jnn.Sequential(jnn.Conv2D(1, 2, 3, padding=1), jnn.ReLU(),
                              jnn.Flatten(), jnn.Linear(2 * 6 * 6, 1))
        tnet = tnn.Sequential(tnn.Conv2D(1, 2, 3, padding=1, device="cpu"),
                              tnn.ReLU(), tnn.Flatten(),
                              tnn.Linear(2 * 6 * 6, 1, device="cpu"))
    keys = sorted(tnet.state_dict())
    JQAT(quantizable_layer_type=("Linear", "Conv2D")).quantize(jnet)
    ImperativeQuantAware().quantize(tnet)
    assert sorted(tnet.state_dict()) == keys
    tnet.load_state_dict(from_jax_state(
        {k: np.asarray(v) for k, v in jnet.state_dict().items()}))
    return jnet, tnet


@pytest.mark.parametrize("kind,steps", [("linear", 3), ("conv", 2)])
def test_qat_steps_match_jax(kind, steps):
    jnet, tnet = _nets(kind)
    want_cls = QuantedLinear if kind == "linear" else QuantedConv2D
    assert any(isinstance(m, want_cls) for m in tnet.modules())
    jopt = jp.optimizer.Adam(0.01, parameters=jnet.parameters())
    topt = tp.optimizer.Adam(0.01, parameters=list(tnet.parameters()))
    rs = np.random.RandomState(5)
    shape = (16, 8) if kind == "linear" else (4, 1, 6, 6)
    for _ in range(steps):
        x = rs.randn(*shape).astype("float32")
        y = rs.randn(shape[0], 1).astype("float32")
        jl = ((jnet(jp.to_tensor(x)) - jp.to_tensor(y)) ** 2).mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = ((tnet(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-5)
    jstate = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    for k, v in tnet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jstate[k], rtol=1e-5,
                                   atol=1e-6)
    # the moving max: a float64 device tensor with the JAX float's value
    jq = [m for m in jnet.sublayers() if hasattr(m, "_act_max")]
    tq = [m for m in tnet.modules() if hasattr(m, "_act_max")]
    assert len(jq) == len(tq) > 0
    for a, b in zip(jq, tq):
        assert b._act_max.dtype == torch.float64
        np.testing.assert_allclose(float(b._act_max), a._act_max, rtol=1e-6)


def test_qat_eval_freezes_the_scale_and_export_waits():
    _, tnet = _nets("linear")
    tnet.eval()
    q = [m for m in tnet.modules() if isinstance(m, QuantedLinear)][0]
    before = q._act_max.clone()
    tnet(torch.randn(4, 8))
    assert torch.equal(q._act_max, before)
    with pytest.raises(NotImplementedError, match="item 8"):
        ImperativeQuantAware().save_quantized_model(tnet, "p")
    from paddle_tpu_torch import slim

    with pytest.raises(NotImplementedError, match="item 8"):
        slim.PostTrainingQuantization(None, "d")
    with pytest.raises(NotImplementedError, match="item 8"):
        slim.quant_post_static(None, "d", "q")
