"""The port's `distribution/` against the JAX package's, on the CPU.

`log_prob`, `entropy`, `probs` and `kl_divergence` of Uniform, Normal,
Categorical, Bernoulli and MultivariateNormalDiag, on the same numpy
parameters and values, equal the JAX package's within 1e-6 relative
(float32 formulas in the same order). Samples match only in
distribution (jax.random's bits are not torch's): shapes and dtypes
equal, and the moments of 20000 draws of each side lie within 5 standard
errors of the distribution's own. `paddle.seed` repeats the draws.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import distribution as JD
import paddle_tpu_torch as tp
from paddle_tpu_torch import distribution as TD

torch.set_num_threads(1)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")
RS = np.random.RandomState(0)
LOC = RS.randn(3).astype("float32")
SCALE = (RS.rand(3) + 0.5).astype("float32")
LOGITS = RS.randn(2, 4).astype("float32")
PROBS = RS.rand(3).astype("float32")
COV = np.diag(RS.rand(3) + 0.5).astype("float32")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x._data)


def _pairs():
    lo, hi = LOC - 1.0, LOC + SCALE
    return {
        "uniform": (JD.Uniform(lo, hi), TD.Uniform(_t(lo), _t(hi)),
                    (LOC + 0.2).astype("float32")),
        "normal": (JD.Normal(LOC, SCALE), TD.Normal(_t(LOC), _t(SCALE)),
                   RS.randn(3).astype("float32")),
        "categorical": (JD.Categorical(LOGITS), TD.Categorical(_t(LOGITS)),
                        np.array([1, 3])),
        "bernoulli": (JD.Bernoulli(PROBS), TD.Bernoulli(_t(PROBS)),
                      np.array([1., 0., 1.], "float32")),
        "mvn": (JD.MultivariateNormalDiag(LOC, COV),
                TD.MultivariateNormalDiag(_t(LOC), _t(COV)),
                RS.randn(3).astype("float32")),
    }


@pytest.mark.parametrize("name", ["uniform", "normal", "categorical",
                                  "bernoulli", "mvn"])
def test_densities_and_entropy_match_jax(name):
    j, t, v = _pairs()[name]
    for fn in ("log_prob", "probs"):
        np.testing.assert_allclose(_np(getattr(t, fn)(_t(v))),
                                   _np(getattr(j, fn)(v)), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(_np(t.entropy()), _np(j.entropy()),
                               rtol=1e-6)


def test_kl_divergence_matches_jax():
    loc2, scale2 = LOC[::-1].copy(), SCALE[::-1].copy()
    cov2 = COV[::-1, ::-1].copy()
    cases = [
        (JD.Normal(LOC, SCALE), JD.Normal(loc2, scale2),
         TD.Normal(_t(LOC), _t(SCALE)), TD.Normal(_t(loc2), _t(scale2))),
        (JD.MultivariateNormalDiag(LOC, COV),
         JD.MultivariateNormalDiag(loc2, cov2),
         TD.MultivariateNormalDiag(_t(LOC), _t(COV)),
         TD.MultivariateNormalDiag(_t(loc2), _t(cov2)))]
    for jp_, jq, tp_, tq in cases:
        np.testing.assert_allclose(_np(TD.kl_divergence(tp_, tq)),
                                   _np(JD.kl_divergence(jp_, jq)),
                                   rtol=1e-6)
    with pytest.raises(TypeError):
        cases[1][2].kl_divergence(cases[0][2])


def test_samples_match_in_distribution():
    n = 20000
    jp.seed(1)
    g = torch.Generator().manual_seed(1)
    for name, (j, t, _) in _pairs().items():
        a, b = _np(j.sample([n])), _np(t.sample([n], generator=g))
        assert a.shape == b.shape, name
        assert a.dtype.kind == b.dtype.kind, name
        if name == "categorical":
            p = np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
            for x in (a, b):
                freq = np.stack([(x == k).mean(0) for k in range(4)], -1)
                se = np.sqrt(p * (1 - p) / n)
                assert (np.abs(freq - p) < 5 * se + 1e-9).all(), name
            continue
        for x in (a, b):
            m, sd = x.mean(0), x.std(0)
            if name == "uniform":
                mu, var = (2 * LOC - 1 + SCALE) / 2, \
                    (SCALE + 1) ** 2 / 12
            elif name == "normal":
                mu, var = LOC, SCALE ** 2
            elif name == "bernoulli":
                mu, var = PROBS, PROBS * (1 - PROBS)
            else:
                mu, var = LOC, np.diag(COV)
            assert (np.abs(m - mu) < 5 * np.sqrt(var / n)).all(), name
            np.testing.assert_allclose(sd, np.sqrt(var), rtol=0.05)


def test_seed_repeats_samples_on_the_default_generator():
    t = TD.Normal(_t(LOC), _t(SCALE))
    tp.seed(7)
    a = t.sample([5])
    tp.seed(7)
    np.testing.assert_array_equal(a.numpy(), t.sample([5]).numpy())
    # numbers go where a tensor parameter lives
    assert TD.Normal(0.0, _t(SCALE)).loc.dtype == torch.float32
