"""Build and bind the port's hand-written CUDA kernels.

Every `paddle_tpu_torch/csrc/*.cu` file is one shared library with a
plain C interface. A library is compiled with `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) when one of its functions is
first asked for (`kernels().<name>`), or, with `load()`, every library
asked for at once, one `nvcc` process per source and all of them started
together. Libraries land in `<build root>/<hash>/` (the build root is
`paddle_tpu_torch/_build`, or `$PT_BUILD_ROOT`), where the hash covers
every source in `csrc/`, the compiler flags, and the toolchain: nvcc's
version, the CUDA driver's and torch's. An edited source or another
toolchain builds anew; an unchanged one is loaded as it is.

With an `AotCompileCache` (`build(cache=)`, `load(cache=)`), a library the
cache holds valid (CRC-checked) is copied out instead of compiled, a
library that is compiled is stored, and a library already in the build
directory is checked against the manifest's CRC: a torn or corrupt file
is rebuilt (from the cache when it can be, else by nvcc). Either way an
`OSError` from `ctypes.CDLL` (a truncated file) rebuilds that library
once, and a second failure raises. `build_info()` records which
libraries this process loaded from the cache and which it compiled.

The libraries are loaded with `ctypes` (no PyTorch headers are compiled,
which keeps a build to seconds). Nothing here runs at import time: the CPU
tests import every module on machines with no `nvcc` and no card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load", "kernels", "build_info", "counter",
           "reset_launches", "launches", "raise_on", "build_root",
           "library_key", "launched_stems", "toolchain", "use_cache",
           "persist", "loaded_stems"]

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
#: 1/keep, logical block_q, block_k, and the shard's address in the
#: whole call (batch offset, head offset, the call's head count)
_DROP = [_U, _U, _F, _I, _I, _I, _I, _I]
#: argtypes of each library's C entry point (see the .cu sources;
#: tests/test_torch_signatures.py holds them against the sources' text).
#: The tunable kernels take their plan's override (0 = the rule) before
#: the stream.
_SIGNATURES = {
    "flash_fwd": ("pt_flash_fwd",
                  [_I, _I, *[_P] * 8, _I, _I, _I, _I, _I, _STRIDES, _F, _I,
                   *_DROP, _P]),
    "flash_decode": ("pt_flash_decode",
                     [_I, _I, *[_P] * 6, *[_I] * 4, _STRIDES, _F, _I, _P]),
    "flash_bwd_dq": ("pt_flash_bwd_dq",
                     [_I, _I, *[_P] * 10, _I, _I, _I, _I, _I, _STRIDES, _F,
                      _I, *_DROP, _P]),
    "flash_bwd_dkv": ("pt_flash_bwd_dkv",
                      [_I, _I, *[_P] * 12, _I, _I, _I, _I, _I, _STRIDES, _F,
                       _I, *_DROP, _P]),
    "flash_verify": ("pt_flash_verify",
                     [_I, _I, *[_P] * 6, *[_I] * 5, _STRIDES, _F, _I, _P]),
    "paged_decode": ("pt_paged_decode",
                     [_I, _I, _I, *[_P] * 9, *[_I] * 6, _STRIDES, _F, _I,
                      _P]),
    "paged_verify": ("pt_paged_verify",
                     [_I, _I, _I, *[_P] * 13, *[_I] * 7, _STRIDES, _F, _I,
                      _I, _P]),
    "int8_matmul": ("pt_int8_matmul",
                    [_I, *[_P] * 5, _I, _I, _I, _I, _I, _P]),
    "lora_gather": ("pt_lora_gather",
                    [_I, *[_P] * 5, *[_I] * 6, _I, _P]),
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
    "flash_decode": [("pt_flash_decode_plan", [*[_I] * 5, _INTS])],
    "paged_decode": [("pt_paged_decode_plan", [*[_I] * 5, _INTS])],
    "paged_verify": [("pt_paged_verify_route", [_I, _I]),
                     ("pt_paged_verify_plan", [*[_I] * 6, _INTS])],
    "lora_gather": [("pt_lora_gather_plan", [*[_I] * 6, _INTS])],
    "int8_matmul": [("pt_int8_matmul_skinny_plan", [*[_I] * 5, _INTS])],
    "fused_conv_fwd": [("pt_fused_conv_fwd_tensor_cores", [_I, _I])],
    "fused_conv_bwd": [("pt_fused_conv_bwd_tensor_cores", [_I, _I, _I]),
                       ("pt_fused_conv_bwd_splits", [_I] * 5)],
}
#: the library of each bound attribute (its stem, or a helper's name
#: without the `pt_` prefix)
_STEM_OF = {stem: stem for stem in _SIGNATURES}
_STEM_OF.update({n[3:]: stem for stem, fns in _HELPERS.items()
                 for n, _ in fns})
#: the library behind each launch counter that is not named as its stem
_COUNTER_STEMS = {"paged_flash_decode": "paged_decode",
                  "paged_flash_verify": "paged_verify"}

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


def launched_stems(before, after):
    """The libraries whose kernels launched between two `launches()`
    readings, sorted."""
    return sorted({_COUNTER_STEMS.get(k, k) for k, n in after.items()
                   if n != before.get(k, 0)})


def raise_on(name, err):
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        import torch

        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


_lock = threading.RLock()
_info = {}
_toolchain = None


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


def _driver_version():
    """The CUDA driver's version (cuDriverGetVersion), or None without a
    driver."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return v.value
    except (OSError, AttributeError):
        pass
    return None


def toolchain():
    """{nvcc, driver, torch}: what a built library is only valid for
    besides its sources and flags (nvcc's release line, None without one;
    the driver's version; torch's version). Read once a process."""
    global _toolchain
    if _toolchain is None:
        import torch

        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            nv = [ln for ln in out.splitlines() if "release" in ln]
            nvcc = nv[-1].strip() if nv else out.strip()[-80:]
        except (RuntimeError, OSError, subprocess.SubprocessError):
            nvcc = None
        _toolchain = {"nvcc": nvcc, "driver": _driver_version(),
                      "torch": torch.__version__}
    return dict(_toolchain)


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _digest():
    """The build directory's name: the sources, the flags and the
    toolchain."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(toolchain().items())).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_root():
    """Where build directories live: `$PT_BUILD_ROOT`, or
    `paddle_tpu_torch/_build`."""
    return os.environ.get("PT_BUILD_ROOT") or BUILD_ROOT


def library_key(stem):
    """The cache key of one built library: its stem and the build digest
    (the cache's manifest carries the environment fingerprint)."""
    return f"lib|{stem}|{_digest()}"


def _nvcc_compile(src, out):
    """Start one nvcc process compiling `src` into `out`."""
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _write_atomic(path, blob):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)   # concurrent builders never see a half file


def build(stems=None, cache=None, compiler=None):
    """Make the libraries `stems` (every library when None) present in the
    build directory and return {stem: path}. Each comes from the build
    directory when its file is there (and matches the cache's CRC when a
    cache holds it), else from the cache when it holds a valid copy, else
    from `compiler` (nvcc by default: `compiler(src, out)` returns a
    process whose `communicate()` gives the log), all compiles started
    together. Records in `build_info()` the compile wall time, the
    compiler's resource report (`-Xptxas -v`), and the libraries loaded
    from the cache and compiled."""
    compiler = compiler or _nvcc_compile
    want = _sources() if stems is None else [f"{s}.cu" for s in stems]
    out_dir = os.path.join(build_root(), _digest())
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    paths, procs, loaded = {}, [], []
    for src in want:
        stem = src[:-3]
        lib = os.path.join(out_dir, f"lib{stem}.so")
        paths[stem] = lib
        key = library_key(stem)
        if os.path.exists(lib):
            ok = True if cache is None else cache.check_file(key, lib)
            if ok is None:          # the cache lacks it: keep a copy there
                with open(lib, "rb") as f:
                    cache.store(key, f.read())
            if ok is not False:
                continue
            os.remove(lib)          # torn or corrupt against the manifest
        if cache is not None:
            blob = cache.load(key)
            if blob is not None:
                _write_atomic(lib, blob)
                loaded.append(stem)
                continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((stem, lib, tmp, compiler(os.path.join(CSRC, src),
                                               tmp)))
    failed = []
    for stem, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        _info.setdefault("logs", {})[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{(log or '')[-4000:]}")
            continue
        os.replace(tmp, lib)
        if cache is not None:
            with open(lib, "rb") as f:
                cache.store(library_key(stem), f.read())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if procs:
        _info["seconds"] = _info.get("seconds", 0.0) + \
            time.perf_counter() - t0
    _info.setdefault("compiled", []).extend(p[0] for p in procs)
    _info.setdefault("loaded", []).extend(loaded)
    _info["dir"] = out_dir
    return paths


#: how a library file is opened (tests stand a stub in)
_open_library = ctypes.CDLL


class _Kernels:
    """The bound C entry points, one attribute per library stem, and the
    `_HELPERS` beside them. A library is built and bound when one of its
    attributes is first asked for."""

    def __init__(self):
        self._libs = {}

    def __getattr__(self, attr):
        stem = _STEM_OF.get(attr)
        if stem is None or attr.startswith("_"):
            raise AttributeError(attr)
        load([stem], cache=_ACTIVE_CACHE[0])
        return self.__dict__[attr]

    def _bind(self, stem, lib):
        self._libs[stem] = lib   # keep the handle alive
        for attr, (name, argtypes) in [(stem, _SIGNATURES[stem])] + [
                (n[3:], (n, a)) for n, a in _HELPERS.get(stem, [])]:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.__dict__[attr] = fn


_kernels = _Kernels()
#: the cache a library built on first use goes through (`use_cache`)
_ACTIVE_CACHE = [None]


@contextlib.contextmanager
def use_cache(cache):
    """Build the libraries first used inside the block through `cache`
    (an `AotCompileCache`): copied out when it holds them, stored when
    they are compiled."""
    with _lock:
        prev, _ACTIVE_CACHE[0] = _ACTIVE_CACHE[0], cache
    try:
        yield cache
    finally:
        with _lock:
            _ACTIVE_CACHE[0] = prev


def persist(stems, cache):
    """Store each bound library of `stems` into `cache` where the cache
    lacks it or holds another copy (a library this process built before
    the cache was given)."""
    with _lock:
        for stem in stems:
            lib = _kernels._libs.get(stem)
            path = getattr(lib, "_name", None)
            if path is None or not os.path.exists(path):
                continue
            key = library_key(stem)
            if cache.check_file(key, path) is not True:
                with open(path, "rb") as f:
                    cache.store(key, f.read())


def load(stems=None, cache=None, compiler=None):
    """Build (`build`) and bind the libraries `stems` (every library when
    None) that this process has not bound yet; returns `kernels()`. A
    library file that `ctypes` cannot open is rebuilt once (without the
    cache's copy, which may be the torn one) before the error stands."""
    with _lock:
        missing = [s for s in (sorted(_SIGNATURES) if stems is None
                               else stems) if s not in _kernels._libs]
        if not missing:
            return _kernels
        paths = build(missing, cache=cache, compiler=compiler)
        for stem in missing:
            try:
                lib = _open_library(paths[stem])
            except OSError:
                os.remove(paths[stem])
                _info.setdefault("reopened", []).append(stem)
                lib = _open_library(build([stem], compiler=compiler)[stem])
                if cache is not None:
                    with open(paths[stem], "rb") as f:
                        cache.store(library_key(stem), f.read())
            _kernels._bind(stem, lib)
        return _kernels


def kernels():
    """The bound kernels: each library builds and binds at the first use
    of one of its functions (`load()` builds a set at once)."""
    return _kernels


def loaded_stems():
    """The libraries this process has bound, sorted."""
    with _lock:
        return sorted(_kernels._libs)


def build_info():
    """{seconds, compiled, loaded, dir, logs} of this process's builds:
    nvcc's wall time, the libraries compiled and those copied out of an
    AOT cache (empty before the first build)."""
    out = dict(_info)
    for k in ("compiled", "loaded", "reopened"):
        if k in out:
            out[k] = list(out[k])
    return out


def strides_arg(values):
    """A C array of element strides for the entry points."""
    return (ctypes.c_longlong * len(values))(*[int(x) for x in values])


def ints_out(n):
    """A C int array of n entries for a helper to fill."""
    return (ctypes.c_int * n)()
