"""Op version registry.

Reference parity: framework/op_version_registry.h (+ framework.proto
OpVersionMap) — every op carries a semantic version; saved programs embed
the versions they were built against, and the loader refuses (or warns on)
programs whose ops are NEWER than this runtime understands. That is the
whole durable-format compatibility contract, kept deliberately small.

All ops default to version 1. Bump an op's version here (with a note)
whenever its attributes/semantics change incompatibly.
"""
from __future__ import annotations

import warnings

_DEFAULT_VERSION = 1

# op_type -> (version, [change notes, oldest first])
_REGISTRY: dict[str, tuple[int, list[str]]] = {}


def register_op_version(op_type: str, version: int, note: str = ""):
    """Declare that `op_type` is at `version` (>=2 implies a change)."""
    cur_ver, notes = _REGISTRY.get(op_type, (_DEFAULT_VERSION, []))
    if version < cur_ver:
        raise ValueError(
            f"op {op_type!r} version can only move forward "
            f"({cur_ver} -> {version})")
    _REGISTRY[op_type] = (version, notes + ([note] if note else []))


def get_op_version(op_type: str) -> int:
    return _REGISTRY.get(op_type, (_DEFAULT_VERSION, []))[0]


def version_notes(op_type: str) -> list[str]:
    return list(_REGISTRY.get(op_type, (_DEFAULT_VERSION, []))[1])


def program_op_versions(program) -> dict[str, int]:
    """The {op_type: version} map for every op type used by `program`."""
    out: dict[str, int] = {}
    for block in program.blocks:
        for op in block.ops:
            out[op.type] = get_op_version(op.type)
    return out


def check_compatible(saved: dict[str, int], strict: bool = False):
    """Validate a loaded program's op_version_map against this runtime.

    Ops saved at a NEWER version than we implement are incompatible (their
    semantics may have changed); `strict=True` raises, default warns —
    matching the reference's pass-through behavior for forward-compatible
    loads.
    """
    problems = [
        f"op {name!r}: saved version {ver} > supported "
        f"{get_op_version(name)}"
        for name, ver in (saved or {}).items()
        if ver > get_op_version(name)]
    if not problems:
        return True
    msg = ("program was saved by a newer op definition: "
           + "; ".join(problems))
    if strict:
        raise RuntimeError(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return False


# ---------------------------------------------------------------------------
# Seeded registrations: ops whose semantics already evolved in this tree.
# ---------------------------------------------------------------------------
register_op_version(
    "dropout", 2,
    "mask RNG draws are f32 (rbg-backed) rather than x64-promoted f64")
register_op_version(
    "recv", 2, "async PS dense pulls are version-gated (stale pulls skip)")
