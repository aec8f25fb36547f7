"""The port's initializers against the JAX package's, on the CPU.

Only JAX's PRNG gives JAX's numbers, so the deterministic initializers
(`Constant`, `Assign`, `Dirac`), `calculate_gain` and the fans are held
exactly, and the random ones to their bounds and moments: every draw
inside the JAX bound, the sample mean and standard deviation of 200,000
draws within 1.5% of the distribution's (about 5 standard errors),
`Orthogonal` orthonormal to 1e-12 (float64). The stacked expert weight
keeps the JAX reading of a 3-D shape as OIHW: XavierUniform on [8, 768,
3072] has the limit sqrt(6 / (768 * 3072 + 8 * 3072)) = 1.5865e-3,
against 3.9528e-2 for one expert's [768, 3072].
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu.nn.initializer as JI
import paddle_tpu_torch.nn.initializer as TI
from paddle_tpu_torch import nn as tnn

SHAPES = [(5,), (7, 3), (4, 6, 3, 3), (8, 16, 32), (2, 3, 4, 5, 6)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fans_match_jax(shape):
    assert TI._fan(shape) == tuple(JI.Initializer()._fan(shape))


@pytest.mark.parametrize("nl,param", [("tanh", None), ("relu", None),
                                      ("leaky_relu", None),
                                      ("leaky_relu", 0.2), ("selu", None),
                                      ("linear", None), ("sigmoid", None)])
def test_calculate_gain_matches_jax(nl, param):
    assert TI.calculate_gain(nl, param) == JI.calculate_gain(nl, param)


@pytest.mark.parametrize("make,shape,dtype", [
    (lambda m: m.Constant(0.37), (3, 4), "float32"),
    (lambda m: m.Constant(-2.0), (5,), "float64"),
    (lambda m: m.Assign(np.arange(12.0).reshape(3, 4)), (3, 4), "float32"),
    (lambda m: m.Assign(np.arange(12.0)), (4, 3), "float64"),
    (lambda m: m.Assign([[1, 2], [3, 4]]), (2, 2), "float32"),
    (lambda m: m.Dirac(), (4, 4, 3, 3), "float32"),
    (lambda m: m.Dirac(groups=2), (6, 3, 3), "float32"),
    (lambda m: m.Dirac(), (3, 5, 3, 3, 3), "float64"),
], ids=["constant", "constant_f64", "assign", "assign_reshaped",
        "assign_list", "dirac", "dirac_groups", "dirac_3d"])
def test_deterministic_initializers_equal_jax(make, shape, dtype):
    want = np.asarray(make(JI)(list(shape), dtype))
    got = make(TI)(shape, dtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _bound_and_moments(jax_init, port_init, shape, lo, hi, mean, std):
    """The JAX draw lies in [lo, hi]; the port's too, with moments
    within 1.5% of the distribution's."""
    want = np.asarray(jax_init(list(shape), "float32"))
    assert want.min() >= lo and want.max() <= hi
    got = port_init(shape, "float32",
                    torch.Generator().manual_seed(0)).numpy()
    assert got.shape == tuple(shape) and got.dtype == np.float32
    assert got.min() >= lo and got.max() <= hi
    assert abs(got.mean() - mean) <= 0.015 * std
    assert abs(got.std() - std) <= 0.015 * std


BIG = (400, 500)


@pytest.mark.parametrize("name", ["uniform", "normal", "truncated",
                                  "xavier_uniform", "xavier_normal",
                                  "kaiming_uniform", "kaiming_normal"])
def test_random_initializers_bounds_and_moments(name):
    fi, fo = BIG
    u = 1.0 / math.sqrt(3.0)
    xl = math.sqrt(6.0 / (fi + fo))
    xs = math.sqrt(2.0 / (fi + fo))
    kl = math.sqrt(6.0 / fi)
    ks = math.sqrt(2.0 / fi)
    # std of N(0, 1) cut at +-2
    tstd = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                     / math.erf(2 / math.sqrt(2)))
    inf = float("inf")
    spec = {
        "uniform": (lambda m: m.Uniform(-0.5, 1.5), -0.5, 1.5, 0.5, u),
        "normal": (lambda m: m.Normal(0.3, 2.0), -inf, inf, 0.3, 2.0),
        "truncated": (lambda m: m.TruncatedNormal(1.0, 0.5), 0.0, 2.0, 1.0,
                      0.5 * tstd),
        "xavier_uniform": (lambda m: m.XavierUniform(), -xl, xl, 0.0,
                           xl * u),
        "xavier_normal": (lambda m: m.XavierNormal(), -inf, inf, 0.0, xs),
        "kaiming_uniform": (lambda m: m.KaimingUniform(), -kl, kl, 0.0,
                            kl * u),
        "kaiming_normal": (lambda m: m.KaimingNormal(), -inf, inf, 0.0, ks),
    }[name]
    make, lo, hi, mean, std = spec
    _bound_and_moments(make(JI), make(TI), BIG, lo, hi, mean, std)


def test_random_initializers_follow_their_generator():
    for init in (TI.Uniform(), TI.Normal(), TI.TruncatedNormal(),
                 TI.XavierUniform(), TI.XavierNormal(), TI.KaimingUniform(),
                 TI.KaimingNormal(), TI.Orthogonal()):
        a = init((6, 5), "float32", torch.Generator().manual_seed(3))
        b = init((6, 5), "float32", torch.Generator().manual_seed(3))
        c = init((6, 5), "float32", torch.Generator().manual_seed(4))
        assert torch.equal(a, b) and not torch.equal(a, c), init


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (4, 2, 3), (5, 5)],
                         ids=str)
def test_orthogonal_is_orthonormal(shape):
    q = TI.Orthogonal(gain=1.5)(shape, "float64",
                                torch.Generator().manual_seed(0))
    m = q.reshape(shape[0], -1) / 1.5
    small = min(m.shape)
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    torch.testing.assert_close(gram, torch.eye(small, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    j = np.asarray(JI.Orthogonal(gain=1.5)(list(shape), "float64"))
    assert j.shape == tuple(shape)


def test_stacked_expert_xavier_limits():
    """A stacked [E, D, F] weight is read as OIHW by both
    packages, which shrinks its Xavier limit ~25x against one expert's."""
    stacked = TI.XavierUniform().limit([8, 768, 3072])
    one = TI.XavierUniform().limit([768, 3072])
    assert math.isclose(stacked, math.sqrt(6.0 / (768 * 3072 + 8 * 3072)))
    assert math.isclose(stacked, 1.5865e-3, rel_tol=1e-4)
    assert math.isclose(one, 3.9528e-2, rel_tol=1e-4)
    assert TI._fan([8, 768, 3072]) == (768 * 3072, 8 * 3072)
    w = TI.XavierUniform()([8, 768, 64], "float32",
                           torch.Generator().manual_seed(0))
    lim = TI.XavierUniform().limit([8, 768, 64])
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.99 * lim
    jw = np.asarray(JI.XavierUniform()([8, 768, 64], "float32"))
    assert np.abs(jw).max() <= lim and np.abs(jw).max() > 0.99 * lim
    moe = tnn.MoELayer(768, 64, num_experts=8, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert float(moe.experts.weight_in.abs().max()) <= lim


def test_create_parameter_defaults_and_attrs():
    layer = tnn.Layer(device="cpu", generator=torch.Generator().manual_seed(0))
    w = layer.create_parameter([30, 40])
    b = layer.create_parameter([40], is_bias=True)
    lim = math.sqrt(6.0 / 70)
    assert 0.9 * lim < float(w.abs().max()) <= lim      # XavierUniform
    assert torch.equal(b, torch.zeros(40))
    p = layer.create_parameter(
        [3], attr=tnn.ParamAttr(name="gamma", initializer=TI.Constant(2.0),
                                learning_rate=0.5, trainable=False),
        dtype="float64")
    assert p.dtype == torch.float64 and torch.equal(p, torch.full((3,), 2.0,
                                                    dtype=torch.float64))
    assert p.param_name == "gamma" and not p.requires_grad
    assert p.optimize_attr == {"learning_rate": 0.5}
    assert layer.create_parameter([2], attr=False) is None
    q = layer.create_parameter([2, 2], attr=TI.Constant(1.0),
                               default_initializer=TI.Constant(3.0))
    assert torch.equal(q, torch.ones(2, 2))
    q = layer.create_parameter([2], default_initializer=TI.Constant(3.0))
    assert torch.equal(q, torch.full((2,), 3.0))
