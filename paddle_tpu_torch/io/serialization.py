"""`save` / `load` in the JAX package's file format
(`paddle_tpu/io/serialization.py`), so `.pdparams` / `.pdopt` files
cross between the two packages in both directions.

The format is a pickle of nested dicts, lists and tuples in which each
tensor is a dict ``{"__tensor__": numpy array, "__dtype__": dtype name,
"__name__": name}``; bfloat16 is stored as float32 under the dtype
``"bfloat16"``. Anything else (ints, strings, numpy arrays such as the
numpy RNG state) is pickled as it is.

A torch tensor has no name of its own: a tensor that is a dict value
(a `state_dict()` entry, an optimizer slot) is written under its key,
the structured name (``features.0.weight``, ``fc.weight__moment1``);
any other tensor under "". The JAX package gives each parameter its
own name (``param_12``); its `load` keeps whichever name the file
holds.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _pack_tensor(t, name):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return {"__tensor__": t.float().numpy(), "__dtype__": "bfloat16",
                "__name__": name}
    arr = t.numpy()
    return {"__tensor__": arr, "__dtype__": arr.dtype.name,
            "__name__": name}


def _pack(obj, name=""):
    """The file form of `obj`: every torch tensor becomes a tagged numpy
    array (a copy on the host, so a device tensor is snapshotted)."""
    if isinstance(obj, torch.Tensor):
        return _pack_tensor(obj, name)
    if isinstance(obj, dict):
        return {k: _pack(v, k if isinstance(k, str) else "")
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    """The inverse of `_pack`: tagged arrays become CPU tensors (bfloat16
    restored from its tag), or numpy arrays when `return_numpy` (a
    bfloat16 one stays float32 there: numpy has no bfloat16)."""
    if isinstance(obj, dict):
        if "__tensor__" in obj:
            arr = np.asarray(obj["__tensor__"])
            if return_numpy:
                return arr
            t = torch.from_numpy(np.array(arr))
            if obj.get("__dtype__") == "bfloat16":
                t = t.to(torch.bfloat16)
            return t
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The object `save` wrote (by either package): tensors as CPU torch
    tensors, or numpy arrays when `return_numpy`. Only load files this
    program or the JAX package wrote: unpickling runs code."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _unpack(data, return_numpy)
