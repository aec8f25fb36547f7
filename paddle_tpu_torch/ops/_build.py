"""Build and bind the port's hand-written CUDA kernels.

Every `paddle_tpu_torch/csrc/*.cu` file is one shared library with a
plain C interface. At first use the sources are compiled with `nvcc`
for Hopper (`-gencode arch=compute_90a,code=sm_90a`), one `nvcc`
process per source and all of them started together, into
`paddle_tpu_torch/_build/<hash>/`, where the hash covers every source
in `csrc/` and the compiler flags: an edited source builds anew, an
unchanged one is loaded as it is. The libraries are loaded with
`ctypes` (no PyTorch headers are compiled, which keeps a build to
seconds). Nothing here runs at import time: the CPU tests import every
module on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "kernels", "build_info", "counter", "reset_launches",
           "launches", "raise_on"]

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the H100 SXM's streaming multiprocessors: the default card of the
#: kernels' plan rules as the Python mirrors write them out
H100_SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_INTS = ctypes.POINTER(ctypes.c_int)
#: the dropout arguments of the flash kernels: seed, keep threshold,
#: 1/keep, logical block_q, block_k
_DROP = [_U, _U, _F, _I, _I]
#: argtypes of each library's C entry point (see the .cu sources)
_SIGNATURES = {
    "flash_fwd": ("pt_flash_fwd",
                  [_I, _I, *[_P] * 8, _I, _I, _I, _I, _I, _STRIDES, _F, _I,
                   *_DROP, _P]),
    "flash_decode": ("pt_flash_decode",
                     [_I, _I, *[_P] * 6, *[_I] * 4, _STRIDES, _F, _P]),
    "flash_bwd_dq": ("pt_flash_bwd_dq",
                     [_I, _I, *[_P] * 10, _I, _I, _I, _I, _I, _STRIDES, _F,
                      _I, *_DROP, _P]),
    "flash_bwd_dkv": ("pt_flash_bwd_dkv",
                      [_I, _I, *[_P] * 12, _I, _I, _I, _I, _I, _STRIDES, _F,
                       _I, *_DROP, _P]),
    "flash_verify": ("pt_flash_verify",
                     [_I, _I, *[_P] * 6, *[_I] * 5, _STRIDES, _F, _P]),
    "paged_decode": ("pt_paged_decode",
                     [_I, _I, _I, *[_P] * 9, *[_I] * 6, _STRIDES, _F, _P]),
    "paged_verify": ("pt_paged_verify",
                     [_I, _I, _I, *[_P] * 13, *[_I] * 7, _STRIDES, _F, _P]),
    "int8_matmul": ("pt_int8_matmul",
                    [_I, *[_P] * 5, _I, _I, _I, _I, _P]),
    "lora_gather": ("pt_lora_gather",
                    [_I, *[_P] * 5, _I, _I, _I, _I, _I, _I, _P]),
    "fused_conv_fwd": ("pt_fused_conv_fwd", [_I, _I, _I, *[_P] * 8,
                                             *[_I] * 7, _P]),
    "fused_conv_bwd": ("pt_fused_conv_bwd", [_I, _I, _I, *[_P] * 14,
                                             *[_I] * 8, _P]),
}
#: other C functions of a library, bound beside its entry point as an
#: attribute named without the `pt_` prefix
_HELPERS = {
    "flash_fwd": [("pt_flash_fwd_route", [_I] * 4),
                  ("pt_flash_fwd_cluster", [_I] * 4),
                  ("pt_flash_fwd_vector_loads", [_P, _P, _P, _STRIDES, _I])],
    "flash_bwd_dq": [("pt_flash_bwd_vector_loads",
                      [_P, _P, _P, _P, _STRIDES, _I])],
    "flash_decode": [("pt_flash_decode_plan", [*[_I] * 4, _INTS])],
    "paged_decode": [("pt_paged_decode_plan", [*[_I] * 4, _INTS])],
    "paged_verify": [("pt_paged_verify_route", [_I, _I]),
                     ("pt_paged_verify_plan", [*[_I] * 5, _INTS])],
    "lora_gather": [("pt_lora_gather_plan", [*[_I] * 4, _INTS])],
    "int8_matmul": [("pt_int8_matmul_skinny_plan", [*[_I] * 4, _INTS])],
    "fused_conv_fwd": [("pt_fused_conv_fwd_tensor_cores", [_I, _I])],
    "fused_conv_bwd": [("pt_fused_conv_bwd_tensor_cores", [_I, _I, _I]),
                       ("pt_fused_conv_bwd_splits", [_I] * 5)],
}

#: the launch counters of the kernel wrappers, one dict per ops module
_COUNTERS = []
#: counters of one branch of kernels that `_COUNTERS` already count
_BRANCHES = []


def counter(names, branch=False):
    """A launch-count dict {kernel: 0} for one ops module's wrappers. Each
    wrapper adds one where it launches its kernel and nowhere else (plain
    CPU runs do not count). branch=True: the launches of one branch of
    kernels counted elsewhere (zeroed by `reset_launches`, left out of
    `launches()`)."""
    d = {name: 0 for name in names}
    (_BRANCHES if branch else _COUNTERS).append(d)
    return d


def reset_launches():
    """Zero the launch counts of every kernel and branch."""
    for d in _COUNTERS + _BRANCHES:
        for name in d:
            d[name] = 0


def launches():
    """{kernel: launches} over every ops module."""
    out = {}
    for d in _COUNTERS:
        out.update(d)
    return out


def raise_on(name, err):
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        import torch

        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


_lock = threading.Lock()
_kernels = None
_info = {}


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile every missing library (in parallel) and return
    {stem: path}. Records the wall time and the compiler's resource
    report (`-Xptxas -v`) in `build_info()`."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    paths, procs = {}, []
    for src in _sources():
        stem = src[:-3]
        lib = os.path.join(out_dir, f"lib{stem}.so")
        paths[stem] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        _info.setdefault("logs", {})[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log[-4000:]}")
            continue
        os.replace(tmp, lib)     # atomic: concurrent builders never see
        #                          a half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    _info["seconds"] = time.perf_counter() - t0
    _info["compiled"] = [p[0] for p in procs]
    _info["dir"] = out_dir
    return paths


class _Kernels:
    """The loaded C entry points, one attribute per library stem, and
    the `_HELPERS` beside them."""

    def __init__(self, paths):
        self._libs = {}
        for stem, path in paths.items():
            lib = ctypes.CDLL(path)
            self._libs[stem] = lib   # keep the handle alive
            for attr, (name, argtypes) in [(stem, _SIGNATURES[stem])] + [
                    (n[3:], (n, a)) for n, a in _HELPERS.get(stem, [])]:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, attr, fn)


def kernels():
    """The bound kernels, building them on the first call."""
    global _kernels
    with _lock:
        if _kernels is None:
            _kernels = _Kernels(build())
        return _kernels


def build_info():
    """{seconds, compiled, dir, logs} of this process's build (empty
    before the first `kernels()` call)."""
    return dict(_info)


def strides_arg(values):
    """A C array of element strides for the entry points."""
    return (ctypes.c_longlong * len(values))(*[int(x) for x in values])


def ints_out(n):
    """A C int array of n entries for a helper to fill."""
    return (ctypes.c_int * n)()
