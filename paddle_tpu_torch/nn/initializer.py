"""Weight initializers (the JAX package's `nn/initializer`).

An initializer is a callable ``init(shape, dtype="float32",
generator=None)`` that returns a new CPU tensor; `Layer.create_parameter`
moves it to the layer's device. Random initializers draw from
`generator`, a CPU `torch.Generator` (None: torch's default CPU
generator), so one seed gives the same weights on every device. Only
JAX's PRNG gives JAX's numbers: the port draws from the same
distributions, not the same samples (weights carry across through
`convert.from_jax_state`).

`_fan` reads the shape as the JAX package does: [in, out] for a matrix,
and any weight of three or more dimensions as OIHW (fan_in = shape[1] *
prod(shape[2:]), fan_out = shape[0] * prod(shape[2:])). A stacked
[experts, d_model, d_ff] expert weight is therefore read as a
convolution kernel too, which makes its Xavier limit far smaller than
one expert's [d_model, d_ff] would give; the port keeps that, so the
two packages draw from the same distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtypes import convert_dtype, get_default_dtype

__all__ = ["Initializer", "Constant", "Uniform", "Normal",
           "TruncatedNormal", "XavierUniform", "XavierNormal",
           "KaimingUniform", "KaimingNormal", "Assign", "Orthogonal",
           "Dirac", "calculate_gain", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "NumpyArrayInitializer"]


def _fan(shape):
    """(fan_in, fan_out) of a weight shape, the JAX package's rule."""
    shape = [int(s) for s in shape]
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


def _draw_dtype(dtype):
    """Draws happen in float64 for a float64 weight, else in float32 and
    are then cast (bf16 / fp16 weights)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class Initializer:
    def __call__(self, shape, dtype="float32", generator=None):
        raise NotImplementedError

    def _fan(self, shape):
        return _fan(shape)

    @staticmethod
    def _dtype(dtype):
        return convert_dtype(dtype) or get_default_dtype()

    def _uniform(self, shape, dtype, low, high, generator):
        dt = self._dtype(dtype)
        t = torch.empty(tuple(int(s) for s in shape), dtype=_draw_dtype(dt))
        return t.uniform_(low, high, generator=generator).to(dt)

    def _normal(self, shape, dtype, mean, std, generator):
        dt = self._dtype(dtype)
        t = torch.empty(tuple(int(s) for s in shape), dtype=_draw_dtype(dt))
        return t.normal_(mean, std, generator=generator).to(dt)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=self._dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", generator=None):
        return self._uniform(shape, dtype, self.low, self.high, generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, seed=0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None):
        return self._normal(shape, dtype, self.mean, self.std, generator)


class TruncatedNormal(Initializer):
    """N(mean, std) cut at two standard deviations (the JAX package's
    `truncated_normal(-2, 2)`), drawn by the inverse CDF."""

    def __init__(self, mean=0.0, std=1.0, seed=0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None):
        dt = self._dtype(dtype)
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = torch.empty(tuple(int(s) for s in shape), dtype=torch.float64)
        u.uniform_(lo, 1.0 - lo, generator=generator)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return (z.clamp(-2.0, 2.0) * self.std + self.mean).to(dt)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fan(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return self.gain * math.sqrt(6.0 / (fi + fo))

    def __call__(self, shape, dtype="float32", generator=None):
        lim = self.limit(shape)
        return self._uniform(shape, dtype, -lim, lim, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fan(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return self.gain * math.sqrt(2.0 / (fi + fo))

    def __call__(self, shape, dtype="float32", generator=None):
        return self._normal(shape, dtype, 0.0, self.std(shape), generator)


class KaimingUniform(Initializer):
    """U(-sqrt(6 / fan_in), sqrt(6 / fan_in)); `negative_slope` and
    `nonlinearity` are taken and not applied, as in the JAX package."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def limit(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fan(shape)[0]
        return math.sqrt(6.0 / fi)

    def __call__(self, shape, dtype="float32", generator=None):
        lim = self.limit(shape)
        return self._uniform(shape, dtype, -lim, lim, generator)


class KaimingNormal(Initializer):
    """N(0, 2 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in

    def std(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fan(shape)[0]
        return math.sqrt(2.0 / fi)

    def __call__(self, shape, dtype="float32", generator=None):
        return self._normal(shape, dtype, 0.0, self.std(shape), generator)


class Assign(Initializer):
    """The given value (an array, a list or a tensor), reshaped to
    `shape` when its own shape differs."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        t = torch.as_tensor(np.array(v), dtype=self._dtype(dtype))
        shape = tuple(int(s) for s in shape)
        return t.reshape(shape) if tuple(t.shape) != shape else t


class Orthogonal(Initializer):
    """`gain` times a matrix with orthonormal rows or columns (the QR of
    a Gaussian matrix, signs fixed by R's diagonal), reshaped: rows are
    shape[0], columns the product of the rest."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", generator=None):
        rows = int(shape[0])
        cols = int(np.prod(shape[1:]))
        a = torch.empty((max(rows, cols), min(rows, cols)),
                        dtype=torch.float64).normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        out = (self.gain * q[:rows, :cols]).reshape(
            tuple(int(s) for s in shape))
        return out.to(self._dtype(dtype))


class Dirac(Initializer):
    """Identity convolution kernels: a 1 at the spatial centre of
    (g * out / groups + k, k) for each group g and k < min(out / groups,
    in)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", generator=None):
        shape = tuple(int(s) for s in shape)
        arr = np.zeros(shape, dtype=np.float32)
        o, i = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        per = o // self.groups
        for g in range(self.groups):
            for k in range(min(per, i)):
                arr[(g * per + k, k) + mid] = 1.0
        return torch.from_numpy(arr).to(self._dtype(dtype))


# fluid-era aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign


def _to_initializer(attr, default):
    """An initializer from a ParamAttr-like spec: an Initializer or any
    callable as it is, anything else the default."""
    if attr is None:
        return default
    if isinstance(attr, Initializer) or callable(attr):
        return attr
    return default


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    return 1.0
