"""paddle.distribution (the JAX package's `distribution/`; reference:
fluid/layers/distributions.py): `Uniform`, `Normal`, `Categorical`,
`Bernoulli`, `MultivariateNormalDiag` and `kl_divergence`.

`log_prob`, `entropy`, `probs` and `kl_divergence` compute the JAX
package's formulas in its order of operations. `sample` draws from a
`torch.Generator` (`generator=`; None: torch's default generator of the
parameters' device, which `paddle.seed` seeds), so samples match the JAX
package's in distribution only: jax.random's bits are not torch's.
Parameters given as numbers or arrays become float32 tensors on the
device of a tensor parameter, else on `device=None`'s device (the card
unless `paddle.set_device("cpu")`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["Distribution", "Uniform", "Normal", "Categorical", "Bernoulli",
           "MultivariateNormalDiag", "kl_divergence"]


def _params(*xs):
    """Tensors of the parameters, numbers and arrays put on the device of
    the first tensor among them (else the default device); a Python
    float becomes float32, an array keeps its dtype."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    out = []
    for x in xs:
        if not isinstance(x, torch.Tensor):
            arr = np.asarray(x)
            if arr.dtype == np.float64 and not isinstance(
                    x, (np.ndarray, np.generic)):
                arr = arr.astype(np.float32)
            x = torch.as_tensor(arr, device=dev or resolve_device(None))
        out.append(x)
    return out


def _float_dtype(t):
    return t.dtype if t.is_floating_point() else torch.float32


def _value(v, like):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v), device=like.device)


class Distribution:
    def sample(self, shape=(), generator=None):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _params(low, high)

    def sample(self, shape=(), seed=0, generator=None):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.low.shape, self.high.shape))
        u = torch.rand(shape, generator=generator, device=self.low.device,
                       dtype=_float_dtype(self.low))
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        v = _value(value, self.low)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    def sample(self, shape=(), seed=0, generator=None):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))
        z = torch.randn(shape, generator=generator, device=self.loc.device,
                        dtype=_float_dtype(self.loc))
        return self.loc + z * self.scale

    def log_prob(self, value):
        v = _value(value, self.loc)
        var = self.scale ** 2
        return (-((v - self.loc) ** 2) / (2 * var) - torch.log(self.scale)
                - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        (self.logits,) = _params(logits)

    def sample(self, shape=(), generator=None):
        """Gumbel-max over the last axis (jax.random.categorical's
        method): shape + the logits' batch shape, int64."""
        lg = self.logits
        u = torch.rand(tuple(shape) + tuple(lg.shape), generator=generator,
                       device=lg.device, dtype=_float_dtype(lg))
        tiny = torch.finfo(u.dtype).tiny
        g = -torch.log(-torch.log(u.clamp(min=tiny)))
        return torch.argmax(lg + g, -1)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, -1)
        idx = _value(value, self.logits).long()
        return torch.take_along_dim(logp, idx[..., None], -1)[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, -1)
        p = torch.exp(logp)
        return -(p * logp).sum(-1)


class Bernoulli(Distribution):
    def __init__(self, probs):
        (self.p,) = _params(probs)

    def sample(self, shape=(), generator=None):
        u = torch.rand(tuple(shape) + tuple(self.p.shape),
                       generator=generator, device=self.p.device,
                       dtype=_float_dtype(self.p))
        return (u < self.p).to(self.p.dtype)

    def log_prob(self, value):
        v = _value(value, self.p)
        p = torch.clamp(self.p, 1e-7, 1 - 1e-7)
        return v * torch.log(p) + (1 - v) * torch.log(1 - p)

    def entropy(self):
        p = torch.clamp(self.p, 1e-7, 1 - 1e-7)
        return -(p * torch.log(p) + (1 - p) * torch.log(1 - p))


class MultivariateNormalDiag(Distribution):
    """loc [k] and a diagonal COVARIANCE matrix `scale` [k, k] (the
    reference's MultivariateNormalDiag reads `scale` as the covariance, as
    its closed forms do); `entropy` and `kl_divergence` are the
    reference's, `sample` and `log_prob` the diagonal normal's."""

    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _params(loc, scale)

    def _var(self):
        return torch.diagonal(self.scale, dim1=-2, dim2=-1)

    def sample(self, shape=(), seed=0, generator=None):
        std = torch.sqrt(self._var())
        shape = tuple(shape) + tuple(self.loc.shape)
        z = torch.randn(shape, generator=generator, device=self.loc.device,
                        dtype=_float_dtype(self.loc))
        return self.loc + z * std

    def log_prob(self, value):
        v = _value(value, self.loc)
        var = self._var()
        k = self.loc.shape[-1]
        y = (v - self.loc) ** 2 / var
        return (-0.5 * y.sum(-1) - 0.5 * torch.log(var).sum(-1)
                - 0.5 * k * math.log(2 * math.pi))

    def entropy(self):
        var = self._var()
        k = self.loc.shape[-1]
        return (0.5 * k * (1.0 + math.log(2 * math.pi))
                + 0.5 * torch.log(var).sum(-1)).reshape(1)

    def kl_divergence(self, other):
        if not isinstance(other, MultivariateNormalDiag):
            raise TypeError(
                "MultivariateNormalDiag.kl_divergence expects another "
                f"MultivariateNormalDiag, got {type(other).__name__}")
        v1, v2 = self._var(), other._var()
        mu1, mu2 = self.loc, other.loc
        k = mu1.shape[-1]
        return (0.5 * ((v1 / v2).sum(-1) - k
                       + ((mu2 - mu1) ** 2 / v2).sum(-1)
                       + torch.log(v2).sum(-1)
                       - torch.log(v1).sum(-1))).reshape(1)


def kl_divergence(p, q):
    return p.kl_divergence(q)
