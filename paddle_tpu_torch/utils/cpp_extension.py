"""Custom C++ ops (the JAX package's `utils/cpp_extension.py`; reference:
utils/cpp_extension, tests/custom_op).

The user writes a plain C kernel over float arrays; `load()` compiles it
with g++ into a shared library and opens it; `register_custom_op` binds
its elementwise symbol as an eager op. The kernel runs on the host: the
op copies its input to a float32 host array, runs the kernel and puts
the result back on the input's device, as the JAX package's
`pure_callback` does. The op is opaque to autograd, as reference custom
ops are without a registered gradient kernel. `register_custom_op` also
registers the op's static lowering (op type `op_name`, inputs {X},
outputs {Out}) and its fluid layer, `op.static_layer(x)`, as the JAX
package does.

Expected C symbol:  void <name>(const float* x, float* out, long long n)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np
import torch

__all__ = ["load", "register_custom_op"]

_LOADED = {}


def load(name, sources, extra_cxx_cflags=None, build_directory=None,
         verbose=False):
    """Compile `sources` (.cc / .cpp) into <build>/<name>_<hash>.so and
    open it; returns the ctypes CDLL. The default build directory is
    under the temporary directory."""
    flags = tuple(extra_cxx_cflags or [])
    key = (name, tuple(sources), flags, build_directory)
    if key in _LOADED:
        return _LOADED[key]
    build = build_directory or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_extensions")
    os.makedirs(build, exist_ok=True)
    h = hashlib.md5()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("|".join(flags).encode())
    so = os.path.join(build, f"{name}_{h.hexdigest()[:10]}.so")
    if not os.path.exists(so):
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
               *list(sources), *flags, "-o", so]
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"custom op build failed:\n{proc.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    _LOADED[key] = lib
    return lib


def register_custom_op(op_name, lib, symbol=None):
    """Bind lib.<symbol> (the elementwise float contract) as an eager op:
    fn(tensor) -> float32 tensor of the input's shape, on its device."""
    fn_c = getattr(lib, symbol or op_name)
    fn_c.restype = None
    fn_c.argtypes = [ctypes.POINTER(ctypes.c_float),
                     ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]

    def eager(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x))
        host = np.ascontiguousarray(t.detach().to("cpu", torch.float32))
        out = np.empty_like(host)
        fn_c(host.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), host.size)
        return torch.from_numpy(out).to(t.device)

    # static lowering: the same host kernel on the op's input
    from ..fluid import lowering

    @lowering.register(op_name)
    def _lower(ctx, op):
        ctx.out(op, "Out", eager(ctx.inp(op, "X")))

    # fluid layer sugar
    def static_layer(x, name=None):
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper(op_name, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(type=op_name, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={})
        return out

    eager.static_layer = static_layer
    return eager
