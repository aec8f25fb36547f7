"""Every C entry point and helper the port binds with ctypes, held against
its declaration in `paddle_tpu_torch/csrc/*.cu`, with no nvcc.

ctypes checks nothing: a Python argtypes list one argument short, or a
pointer declared where the C function takes an int, passes every call
and corrupts the launch. This test parses each `extern "C" int pt_...(`
parameter list out of the sources and compares its length and each
argument's kind (pointer, integer, float) with `_build._SIGNATURES` and
`_build._HELPERS`, and checks that every exported function is bound.
"""
import ctypes
import os
import re

import pytest

from paddle_tpu_torch.ops import _build

_DECL = re.compile(r'extern\s+"C"\s+int\s+(pt_\w+)\s*\(([^)]*)\)', re.S)


def _declarations():
    out = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, name)) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for fn, params in _DECL.findall(text):
            out[fn] = (name, [p.strip() for p in params.split(",")
                              if p.strip()])
    return out


DECLS = _declarations()
BOUND = {name: (stem, argtypes)
         for stem, (name, argtypes) in _build._SIGNATURES.items()}
BOUND.update({name: (stem, argtypes)
              for stem, fns in _build._HELPERS.items()
              for name, argtypes in fns})


def _c_kind(param):
    if "*" in param:
        return "pointer"
    base = param.split()[-2] if len(param.split()) > 1 else param
    if base in ("float", "double"):
        return "float"
    return "int"


def _ctypes_kind(t):
    if t in (ctypes.c_void_p,) or hasattr(t, "contents") or \
            getattr(t, "_type_", None) is not None and \
            isinstance(getattr(t, "_type_"), type):
        return "pointer"
    if t in (ctypes.c_float, ctypes.c_double):
        return "float"
    return "int"


@pytest.mark.parametrize("name", sorted(BOUND))
def test_bound_argtypes_match_the_c_declaration(name):
    stem, argtypes = BOUND[name]
    assert name in DECLS, f"{name} is bound but no .cu declares it"
    src, params = DECLS[name]
    assert src == f"{stem}.cu", (name, src, stem)
    assert len(argtypes) == len(params), (name, params)
    got = [_ctypes_kind(t) for t in argtypes]
    want = [_c_kind(p) for p in params]
    assert got == want, list(zip(params, got))


def test_every_exported_function_is_bound():
    assert sorted(DECLS) == sorted(BOUND)


def test_the_kind_rules():
    assert _c_kind("const long long* strides") == "pointer"
    assert _c_kind("void* stream") == "pointer"
    assert _c_kind("int split_k") == "int"
    assert _c_kind("unsigned seed") == "int"
    assert _c_kind("float scale") == "float"
    assert _ctypes_kind(ctypes.c_void_p) == "pointer"
    assert _ctypes_kind(ctypes.POINTER(ctypes.c_int)) == "pointer"
    assert _ctypes_kind(ctypes.c_uint32) == "int"
    assert _ctypes_kind(ctypes.c_float) == "float"
