"""The static graph's dtype names (the JAX package's `core/dtypes.py` as
the fluid layers use it).

A static var's dtype is a numpy scalar type, as in the JAX package, so
programs built here carry the same attrs and serialize to the same bytes
("int" is int32 there, unlike the eager port's int64 default).
`bfloat16`, which numpy lacks, is the class of that name below. The
Executor turns these into torch dtypes (`to_torch`).
"""
from __future__ import annotations

import numpy as np
import torch


class bfloat16:  # noqa: N801 (the dtype's name)
    """The bfloat16 dtype of a static var."""


_STR_TO_DTYPE = {
    "float16": np.float16, "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": np.float32, "float64": np.float64, "float": np.float32,
    "double": np.float64, "int8": np.int8, "int16": np.int16,
    "int32": np.int32, "int64": np.int64, "int": np.int32,
    "uint8": np.uint8, "bool": np.bool_, "complex64": np.complex64,
    "complex128": np.complex128,
}


def convert_dtype(dtype):
    """Any dtype spec (a name, a numpy or torch dtype) as the numpy
    scalar type of a static var (`bfloat16` for bfloat16)."""
    if dtype is None:
        return None
    if dtype is bfloat16:
        return bfloat16
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        if dtype not in _STR_TO_DTYPE:
            raise TypeError(f"unsupported dtype string: {dtype!r}")
        return _STR_TO_DTYPE[dtype]
    try:
        dt = np.dtype(dtype)
    except TypeError:
        raise TypeError(f"unsupported dtype: {dtype!r}")
    return bfloat16 if dt.name == "bfloat16" else dt.type


def dtype_name(dtype) -> str:
    if dtype is None:
        return "None"
    if dtype is bfloat16:
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def to_torch(dtype):
    """The torch dtype of a static var's dtype (None stays None)."""
    if dtype is None:
        return None
    name = dtype_name(dtype)
    return getattr(torch, name if name != "bool" else "bool")
