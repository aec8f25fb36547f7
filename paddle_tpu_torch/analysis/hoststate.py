"""AST half of the static checker: host-state concurrency and program-body
hygiene over the port's serving/, tuning/, profiler/ and
optimizer/fused.py (the JAX package's `analysis/hoststate.py`).

PTA201 — lock discipline. The checker LEARNS each class's lock
attributes (any ``self.<name> = threading.Lock()/RLock()/Condition()``)
and then requires every mutation of ``self.<attr>`` in that class —
plain/aug/subscript assignment and mutating container calls
(``self._q.append(...)``) — to sit inside a ``with self.<lock>:``
block. Classes with no lock attribute are skipped entirely: the
engines are single-threaded by contract and say so in their
docstrings; the rule targets exactly the objects that CLAIM thread
safety by owning a lock.

Escape hatch (the ``# analysis:`` annotation grammar):

    def _read_manifest(self):   # analysis: single-threaded
        ...                     # whole function exempt

    self._hint = x              # analysis: single-threaded
                                # one statement exempt

A trailing ``# analysis: single-threaded`` comment on the ``def`` line
(or on the line directly above it) exempts the function; on a statement
line it exempts that statement. ``__init__``/``__new__`` are exempt by
construction (no second thread can hold an object mid-construction).

PTA204 — host calls in program bodies. The port's programs are the
bodies the engines cache under a program key: the functions handed to
``<engine>._program(key, body)`` (a local def passed by name), the cache
layouts' body methods (`BODY_METHODS` of any class named ``*Layout``:
what `serving/engine.py` hands to `_program`), and every def nested in a
``*_body`` method (the JAX engines' convention). They must not call
``np.*``, ``numpy.*`` or ``time.*``, nor ``.item()``, ``.tolist()`` or
``.cpu()``: a host call inside a program either bakes a host value into
every dispatch or syncs the device once a dispatch.
"""
from __future__ import annotations

import ast
import os

from .findings import Finding

__all__ = ["check_source", "check_paths", "ANNOTATION",
           "LOCK_FACTORIES", "MUTATOR_METHODS", "BODY_METHODS",
           "HOST_METHODS"]

ANNOTATION = "# analysis: single-threaded"

LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

#: method names whose call on a self attribute mutates it in place
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "setdefault",
})

_HOST_MODULES = ("np", "numpy", "time")
#: tensor methods that move a value to the host (a device sync)
HOST_METHODS = frozenset({"item", "tolist", "cpu"})
#: the cache layouts' methods the engines run as programs
BODY_METHODS = frozenset({"join", "step", "spec_step", "draft", "attach",
                          "cow", "pattach", "chunk"})


def _is_lock_factory(node):
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in LOCK_FACTORIES and \
            isinstance(f.value, ast.Name) and f.value.id == "threading":
        return True
    return isinstance(f, ast.Name) and f.id in LOCK_FACTORIES


def _self_attr(node):
    """'x' for `self.x`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _annotated(lines, lineno):
    """True when `lineno` (1-based) or the line above carries the
    single-threaded annotation."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and ANNOTATION in lines[ln - 1]:
            return True
    return False


class _LockScopeVisitor(ast.NodeVisitor):
    """Walks one method body tracking whether the current statement is
    inside a `with self.<lock>:` block; collects unguarded mutations."""

    def __init__(self, lock_attrs, lines, hits):
        self.lock_attrs = lock_attrs
        self.lines = lines
        self.hits = hits          # [(lineno, attr)]
        self._guarded = 0

    # ---- guard tracking ----
    def visit_With(self, node):
        locked = any(
            _self_attr(item.context_expr) in self.lock_attrs
            for item in node.items)
        if locked:
            self._guarded += 1
        self.generic_visit(node)
        if locked:
            self._guarded -= 1

    def _record(self, node, attr):
        if attr is None or attr in self.lock_attrs or self._guarded:
            return
        if _annotated(self.lines, node.lineno):
            return
        self.hits.append((node.lineno, attr))

    def _target_attr(self, t):
        a = _self_attr(t)
        if a is not None:
            return a
        if isinstance(t, ast.Subscript):      # self.stats["x"] = ...
            return _self_attr(t.value)
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                a = self._target_attr(el)
                if a is not None:
                    return a
        return None

    # ---- mutation sites ----
    def visit_Assign(self, node):
        for t in node.targets:
            self._record(node, self._target_attr(t))
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._record(node, self._target_attr(node.target))
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._record(node, self._target_attr(node.target))
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATOR_METHODS:
            self._record(node, _self_attr(f.value))
        self.generic_visit(node)

    # nested defs keep the surrounding guard state deliberately: a
    # closure defined under the lock usually RUNS under it too, and
    # the conservative alternative drowned real findings in noise
    def visit_FunctionDef(self, node):
        self.generic_visit(node)


def _check_locks(tree, lines, path):
    findings = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        lock_attrs = set()
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and \
                    _is_lock_factory(sub.value):
                for t in sub.targets:
                    a = _self_attr(t)
                    if a is not None:
                        lock_attrs.add(a)
        if not lock_attrs:
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in ("__init__", "__new__"):
                continue
            if _annotated(lines, meth.lineno):
                continue
            hits = []
            v = _LockScopeVisitor(lock_attrs, lines, hits)
            for stmt in meth.body:
                v.visit(stmt)
            for lineno, attr in hits:
                lock = sorted(lock_attrs)[0]
                findings.append(Finding(
                    "PTA201", f"{path}:{lineno}",
                    f"{cls.name}.{meth.name} mutates self.{attr} "
                    f"outside `with self.{lock}:` (class owns a lock "
                    f"=> every mutation is guarded, or annotated "
                    f"'{ANNOTATION}')",
                    baseline_key=f"{os.path.basename(path)}:"
                                 f"{cls.name}.{meth.name}:{attr}"))
    return findings


def _program_bodies(tree):
    """FunctionDef nodes that run as programs: the body methods of a
    ``*Layout`` class, local defs handed to ``<x>._program(key, <name>)``,
    and every def nested inside a ``*_body`` method."""
    bodies = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name.endswith("Layout"):
            bodies.extend(m for m in node.body
                          if isinstance(m, ast.FunctionDef)
                          and m.name in BODY_METHODS)
        if isinstance(node, ast.FunctionDef) and \
                node.name.endswith("_body"):
            for sub in ast.walk(node):
                if isinstance(sub, ast.FunctionDef) and sub is not node:
                    bodies.append(sub)
        if isinstance(node, ast.FunctionDef):
            local_defs = {n.name: n for n in ast.walk(node)
                          if isinstance(n, ast.FunctionDef)}
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "_program" and \
                        len(sub.args) >= 2 and \
                        isinstance(sub.args[1], ast.Name):
                    target = local_defs.get(sub.args[1].id)
                    if target is not None:
                        bodies.append(target)
    uniq = []
    seen = set()
    for b in bodies:
        if id(b) not in seen:
            seen.add(id(b))
            uniq.append(b)
    return uniq


def _host_call(call):
    """'np.asarray' / '.item()' for a host call, else None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if isinstance(f.value, ast.Name) and f.value.id in _HOST_MODULES:
        return f"{f.value.id}.{f.attr}"
    if f.attr in HOST_METHODS and not call.args and not call.keywords:
        return f".{f.attr}()"
    return None


def _check_jit_bodies(tree, lines, path):
    findings = []
    for body in _program_bodies(tree):
        for sub in ast.walk(body):
            if not isinstance(sub, ast.Call):
                continue
            name = _host_call(sub)
            if name is None or _annotated(lines, sub.lineno):
                continue
            findings.append(Finding(
                "PTA204", f"{path}:{sub.lineno}",
                f"program body `{body.name}` calls {name}(...) — host "
                f"work inside a program (bakes a host value in, or syncs "
                f"the device per dispatch); use torch ops on the device "
                f"or hoist it out",
                baseline_key=f"{os.path.basename(path)}:{body.name}:"
                             f"{name.rstrip('()')}"))
    return findings


def check_source(source, path="<source>"):
    """All AST findings for one module's source text."""
    tree = ast.parse(source)
    lines = source.splitlines()
    return _check_locks(tree, lines, path) + \
        _check_jit_bodies(tree, lines, path)


def check_paths(paths):
    """All AST findings across files/directories (``.py`` only)."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for base, _dirs, names in os.walk(p):
                if "__pycache__" in base:
                    continue
                files.extend(os.path.join(base, n)
                             for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings = []
    for fp in sorted(set(files)):
        with open(fp) as f:
            src = f.read()
        findings.extend(check_source(src, fp))
    return findings
