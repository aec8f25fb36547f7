"""The parameter server's native library: `csrc/ptcore/ps_server.cc`,
bound, not ported. The file includes only libc and the C++ standard
library, so it builds on its own with `g++ -O2 -shared -fPIC` at first
use, into `paddle_tpu_torch/_build/ps_<hash>/` (or under
`$PT_BUILD_ROOT`), where the hash covers the source, the flags and the
compiler's version line, as `ops/_build.py` does for the CUDA kernels. A
failed build raises with the compiler's output; there is no other
library to fall back to (the JAX package's native core needs protoc and
libprotobuf, and the port never loads it).
"""
from __future__ import annotations

import ctypes as c
import hashlib
import os
import subprocess
import threading

__all__ = ["load", "source", "build_info"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
SOURCE = os.path.join(_ROOT, "csrc", "ptcore", "ps_server.cc")
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_LIB = [None]
_INFO = {}

#: the C API (ps_server.cc's extern "C" block): name -> (restype, argtypes)
SIGNATURES = {
    "pt_ps_server_start": (c.c_void_p, [c.c_int, c.c_int, c.c_char_p,
                                        c.c_double]),
    "pt_ps_server_port": (c.c_int, [c.c_void_p]),
    "pt_ps_server_stop": (None, [c.c_void_p]),
    "pt_ps_server_destroy": (None, [c.c_void_p]),
    "pt_ps_server_stale": (c.c_int, [c.c_void_p, c.c_int64]),
    "pt_ps_server_shutdown_requested": (c.c_int, [c.c_void_p]),
    "pt_ps_connect": (c.c_void_p, [c.c_char_p, c.c_int]),
    "pt_ps_disconnect": (None, [c.c_void_p]),
    "pt_ps_client_error": (c.c_char_p, [c.c_void_p]),
    "pt_ps_init_dense": (c.c_int, [c.c_void_p, c.c_char_p,
                                   c.POINTER(c.c_float), c.c_uint64]),
    "pt_ps_push_dense": (c.c_int, [c.c_void_p, c.c_char_p,
                                   c.POINTER(c.c_float), c.c_uint64,
                                   c.c_int]),
    "pt_ps_pull_dense": (c.c_int, [c.c_void_p, c.c_char_p,
                                   c.POINTER(c.c_float), c.c_uint64]),
    "pt_ps_pull_dense_if_newer": (c.c_int, [c.c_void_p, c.c_char_p,
                                            c.POINTER(c.c_float),
                                            c.c_uint64,
                                            c.POINTER(c.c_uint64)]),
    "pt_ps_push_sparse": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32,
                                    c.POINTER(c.c_int64), c.c_uint64,
                                    c.POINTER(c.c_float)]),
    "pt_ps_pull_sparse": (c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32,
                                    c.POINTER(c.c_int64), c.c_uint64,
                                    c.POINTER(c.c_float)]),
    "pt_ps_push_sparse_bf16": (c.c_int, [c.c_void_p, c.c_char_p,
                                         c.c_uint32, c.POINTER(c.c_int64),
                                         c.c_uint64,
                                         c.POINTER(c.c_uint16)]),
    "pt_ps_pull_sparse_bf16": (c.c_int, [c.c_void_p, c.c_char_p,
                                         c.c_uint32, c.POINTER(c.c_int64),
                                         c.c_uint64,
                                         c.POINTER(c.c_uint16)]),
    "pt_ps_barrier": (c.c_int, [c.c_void_p, c.c_uint32]),
    "pt_ps_heartbeat": (c.c_int, [c.c_void_p, c.c_uint32]),
    "pt_ps_shutdown": (c.c_int, [c.c_void_p]),
    "pt_ps_save": (c.c_int, [c.c_void_p, c.c_char_p]),
    "pt_ps_load": (c.c_int, [c.c_void_p, c.c_char_p]),
}


def source():
    return SOURCE


def _compiler():
    return os.environ.get("CXX", "g++")


def _digest():
    """The build directory's name: the source, the flags and the
    compiler."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    try:
        ver = subprocess.run([_compiler(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[:1]
    except OSError as e:
        raise RuntimeError(f"the parameter server's library needs a C++ "
                           f"compiler ({_compiler()!r}): {e}") from e
    h.update(repr(ver).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _build_root():
    from ...ops._build import build_root

    return build_root()


def build_info():
    """{path, digest, built (this process compiled it), seconds}."""
    return dict(_INFO)


def load():
    """The bound library (built on first use; raises when it cannot be)."""
    if _LIB[0] is not None:
        return _LIB[0]
    with _LOCK:
        if _LIB[0] is not None:
            return _LIB[0]
        import time

        digest = _digest()
        out_dir = os.path.join(_build_root(), f"ps_{digest}")
        path = os.path.join(out_dir, "libptps.so")
        built, t0 = False, time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            r = subprocess.run([_compiler(), *FLAGS, "-o", tmp, SOURCE],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building the parameter server ({SOURCE}) failed:\n"
                    f"{r.stdout}{r.stderr}")
            os.replace(tmp, path)        # concurrent builders: last wins
            built = True
        lib = c.CDLL(path)
        for name, (res, args) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _INFO.update(path=path, digest=digest, built=built,
                     seconds=time.perf_counter() - t0)
        _LIB[0] = lib
        return lib
