"""Static-graph initializers: emit init ops into the startup program.

Reference parity: fluid/initializer.py (each initializer appends a
fill_constant / uniform_random / gaussian_random op to the startup program
targeting the parameter var).
"""
from __future__ import annotations

import math

import numpy as np

from .dtypes import dtype_name


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan(shape):
        if len(shape) <= 1:
            return (shape[0] if shape else 1,) * 2
        if len(shape) == 2:
            return shape[0], shape[1]
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": [var]},
            attrs={"shape": var.shape, "dtype": dtype_name(var.dtype),
                   "value": float(self.value)})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high = low, high

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": [var]},
            attrs={"shape": var.shape, "dtype": dtype_name(var.dtype),
                   "min": self.low, "max": self.high})


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std = loc, scale

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": [var]},
            attrs={"shape": var.shape, "dtype": dtype_name(var.dtype),
                   "mean": self.mean, "std": self.std})


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std = loc, scale

    def __call__(self, var, block):
        block.append_op(
            type="truncated_gaussian_random", outputs={"Out": [var]},
            attrs={"shape": var.shape, "dtype": dtype_name(var.dtype),
                   "mean": self.mean, "std": self.std})


class Xavier(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, var, block):
        fi, fo = self._fan(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            Uniform(-limit, limit)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / (fi + fo)))(var, block)


class MSRA(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in

    def __call__(self, var, block):
        fi, _ = self._fan(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            Uniform(-limit, limit)(var, block)
        else:
            Normal(0.0, math.sqrt(2.0 / fi))(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value", outputs={"Out": [var]},
            attrs={"shape": list(self.value.shape),
                   "dtype": dtype_name(var.dtype),
                   "values": self.value.reshape(-1).tolist()})


ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
