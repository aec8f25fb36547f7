"""Paddle's dtype names on torch dtypes.

A dtype argument of the port takes Paddle's forms: a name ("float32",
"int64", "bool", "bfloat16", ...), a numpy dtype, or a torch dtype.
The default float type is float32, as in the JAX package. Integer
results default to int64: the JAX package runs with x64 enabled, so its
integer defaults are 64-bit too.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "get_default_dtype", "set_default_dtype",
           "is_floating"]

_NAMES = {
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "int": torch.int64,
    "bool": torch.bool, "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_DEFAULT = [torch.float32]


def convert_dtype(dtype):
    """A torch dtype for Paddle's dtype forms; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.lower().replace("paddle.", "")
    else:
        name = np.dtype(dtype).name
    if name not in _NAMES:
        raise TypeError(f"unknown dtype {dtype!r}")
    return _NAMES[name]


def get_default_dtype():
    return _DEFAULT[0]


def set_default_dtype(dtype):
    dt = convert_dtype(dtype)
    if dt not in (torch.float16, torch.bfloat16, torch.float32,
                  torch.float64):
        raise TypeError(f"the default dtype must be a float type, got "
                        f"{dtype!r}")
    _DEFAULT[0] = dt


def is_floating(dtype):
    return convert_dtype(dtype).is_floating_point
