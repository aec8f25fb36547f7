"""Repo-convention rules: invariants that span modules (the JAX package's
`analysis/repo_rules.py`, over the port).

PTA202 — snapshot/doc sync. `ServingMetrics.snapshot()` is the metric
surface of record and `SNAPSHOT_DOCS` its documented schema; the two
must never drift. This rule extracts the key set snapshot() PRODUCES
straight from its AST (dict literals, the ``**({} if .. else {..})``
conditional sections, one level of local-variable indirection, and, in
the port's style, ``**self.<method>(...)`` sections that the method
builds as ``out["<section>"] = {...}`` assignments or returns) and diffs
it against the `SNAPSHOT_DOCS` keys, statically, so a key added to one
side fails before any runtime path renders it. The dynamic half (a
fully-populated snapshot flattening to exactly the documented keys)
lives in tests/test_torch_shaping.py.

PTA203 — fault-point registry. `faults.point(name)` registers points
idempotently, which means `faults.inject("typo.name")` self-registers
a fresh point that NO production code ever hits: the plan silently
never fires. This rule collects every literal `faults.point("...")`
(the registry) and checks every literal `faults.inject("...")` against
it.
"""
from __future__ import annotations

import ast
import os

from .findings import Finding

__all__ = ["RULE_SNAPSHOT_DOC", "RULE_FAULT_POINT",
           "snapshot_keys_from_source", "snapshot_doc_findings",
           "fault_point_findings", "collect_fault_names"]

RULE_SNAPSHOT_DOC = "PTA202"
RULE_FAULT_POINT = "PTA203"


# ----------------------------------------------------------------------
# PTA202: snapshot() AST key extraction vs SNAPSHOT_DOCS
# ----------------------------------------------------------------------

def _flatten_dict_node(node, prefix, local_dicts, out):
    """Collect dotted key paths produced by a dict-literal AST node.
    Values that are themselves dict literals (directly, via a local
    variable, or behind the `**({} if c else {...})` section idiom)
    recurse; anything else is a leaf."""
    for k, v in zip(node.keys, node.values):
        if k is None:                       # **expansion (a section)
            for branch in _dict_branches(v, local_dicts):
                _flatten_dict_node(branch, prefix, local_dicts, out)
            continue
        if not isinstance(k, ast.Constant) or \
                not isinstance(k.value, str):
            continue
        key = prefix + k.value
        v = _resolve(v, local_dicts)
        if isinstance(v, ast.Dict):
            _flatten_dict_node(v, key + ".", local_dicts, out)
        else:
            out.add(key)


def _resolve(node, local_dicts):
    if isinstance(node, ast.Name) and node.id in local_dicts:
        return local_dicts[node.id]
    return node


def _dict_branches(node, local_dicts):
    """Dict-literal branches of a `**`-expanded expression: handles
    `{...}`, a local name, and `{} if cond else {...}` (both arms)."""
    node = _resolve(node, local_dicts)
    if isinstance(node, ast.Dict):
        return [node]
    if isinstance(node, ast.IfExp):
        return _dict_branches(node.body, local_dicts) + \
            _dict_branches(node.orelse, local_dicts)
    return []


def _self_call_method(node):
    """'m' for a `self.m(...)` call node, else None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Name) and \
            node.func.value.id == "self":
        return node.func.attr
    return None


def _local_dicts(fn):
    out = {}
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = sub.value
    return out


def _method_keys(meth, methods, prefix, out, seen):
    """Keys a section method produces: its returned dict literals and its
    ``out["name"] = {...}`` assignments (the port's `_sections`)."""
    if meth.name in seen:
        return
    seen = seen | {meth.name}
    local = _local_dicts(meth)
    for sub in ast.walk(meth):
        if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Dict):
            _flatten_sections(sub.value, prefix, local, methods, out, seen)
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
            t = sub.targets[0]
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and \
                    isinstance(t.slice, ast.Constant) and \
                    isinstance(t.slice.value, str):
                key = prefix + t.slice.value
                v = _resolve(sub.value, local)
                if isinstance(v, ast.Dict):
                    _flatten_sections(v, key + ".", local, methods, out,
                                      seen)
                else:
                    out.add(key)


def _flatten_sections(node, prefix, local_dicts, methods, out, seen):
    """`_flatten_dict_node`, following ``**self.m(...)`` sections into
    the method m of the same class."""
    for k, v in zip(node.keys, node.values):
        if k is None:
            m = _self_call_method(v)
            if m is not None and m in methods:
                _method_keys(methods[m], methods, prefix, out, seen)
                continue
            for branch in _dict_branches(v, local_dicts):
                _flatten_sections(branch, prefix, local_dicts, methods, out,
                                  seen)
            continue
        if not isinstance(k, ast.Constant) or \
                not isinstance(k.value, str):
            continue
        key = prefix + k.value
        v = _resolve(v, local_dicts)
        if isinstance(v, ast.Dict):
            _flatten_sections(v, key + ".", local_dicts, methods, out, seen)
        else:
            out.add(key)


def snapshot_keys_from_source(source):
    """The dotted key set `ServingMetrics.snapshot()` can emit,
    extracted statically from the module source."""
    tree = ast.parse(source)
    fn, methods = None, {}
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name == "ServingMetrics":
            for meth in cls.body:
                if isinstance(meth, ast.FunctionDef):
                    methods[meth.name] = meth
                    if meth.name == "snapshot":
                        fn = meth
    if fn is None:
        raise ValueError("ServingMetrics.snapshot() not found")
    local_dicts = _local_dicts(fn)
    keys = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Dict):
            _flatten_sections(sub.value, "", local_dicts, methods, keys,
                              frozenset({"snapshot"}))
    return keys


def snapshot_doc_findings(metrics_path=None, docs=None):
    """PTA202 findings (empty = in sync). Defaults to the real
    serving.metrics module + its SNAPSHOT_DOCS; fixture tests pass a
    synthetic module path and doc set."""
    if metrics_path is None:
        from ..serving import metrics as _m

        metrics_path = _m.__file__
    if docs is None:
        from ..serving.metrics import SNAPSHOT_DOCS as docs

    with open(metrics_path) as f:
        src = f.read()
    produced = snapshot_keys_from_source(src)
    documented = set(docs)
    findings = []
    where = os.path.basename(metrics_path)
    for key in sorted(produced - documented):
        findings.append(Finding(
            RULE_SNAPSHOT_DOC, where,
            f"snapshot() emits `{key}` but SNAPSHOT_DOCS does not "
            f"document it — add the doc row (the schema of record)",
            baseline_key=f"snapshot:undocumented:{key}"))
    for key in sorted(documented - produced):
        findings.append(Finding(
            RULE_SNAPSHOT_DOC, where,
            f"SNAPSHOT_DOCS documents `{key}` but snapshot() never "
            f"emits it — dead doc row (or a dropped metric)",
            baseline_key=f"snapshot:unemitted:{key}"))
    return findings


# ----------------------------------------------------------------------
# PTA203: fault-point registry coverage
# ----------------------------------------------------------------------

def _literal_fault_calls(tree, attr):
    """(name, lineno) for every `faults.<attr>("literal", ...)` or bare
    `<attr>("literal", ...)` call in a module."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        named = (isinstance(f, ast.Attribute) and f.attr == attr) or \
            (isinstance(f, ast.Name) and f.id == attr)
        if not named:
            continue
        a0 = node.args[0]
        if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
            out.append((a0.value, node.lineno))
    return out


def _py_files(paths):
    for p in paths:
        if os.path.isdir(p):
            for base, _dirs, names in os.walk(p):
                if "__pycache__" in base:
                    continue
                for n in sorted(names):
                    if n.endswith(".py"):
                        yield os.path.join(base, n)
        elif p.endswith(".py"):
            yield p


def collect_fault_names(paths, attr="point"):
    """{name: [file:line, ...]} of literal faults.<attr>() calls."""
    out = {}
    for fp in sorted(set(_py_files(paths))):
        with open(fp) as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                continue
        for name, lineno in _literal_fault_calls(tree, attr):
            out.setdefault(name, []).append(f"{fp}:{lineno}")
    return out


def fault_point_findings(point_paths, inject_paths):
    """PTA203 findings: inject() names with no point() registration
    anywhere in `point_paths` + `inject_paths` (tests register ad-hoc
    points next to their injections — that counts)."""
    registry = set(collect_fault_names(
        list(point_paths) + list(inject_paths), attr="point"))
    findings = []
    injected = collect_fault_names(inject_paths, attr="inject")
    for name, sites in sorted(injected.items()):
        if name in registry:
            continue
        findings.append(Finding(
            RULE_FAULT_POINT, sites[0],
            f"faults.inject({name!r}) names a point no faults.point() "
            f"registers — inject() self-registers it, so the plan "
            f"silently never fires",
            baseline_key=f"faults:{name}"))
    return findings
