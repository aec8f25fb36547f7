"""Finding/rule vocabulary + the committed-baseline ratchet (the JAX
package's `analysis/findings.py`, the port's own copy).

Every check in `paddle_tpu_torch.analysis` reports `Finding`s: a stable
rule id (the `PTA...` codes below, the JAX package's ids and slugs: tools,
tests and the baseline all key on them), a `where` (file:line for AST
findings, program key for program findings), a human message, and a
`baseline_key`: the STABLE identity a committed baseline entry matches
against (`fnmatch`-style wildcards allowed), deliberately free of line
numbers and array shapes so refactors don't churn the baseline.

Baseline semantics (the ratchet): the gate starts green by committing
today's justified findings; every entry carries a one-line
`justification`; a finding with no matching entry fails the gate; an
entry matching no finding is reported `stale` so dead allowlist rows
get deleted, never accumulated. The port's baseline is
`paddle_tpu_torch/analysis/baseline.json`.

The program rules keep their JAX ids and slugs; on the port they read
the aten ops one program run dispatches (`analysis.program`): PTA102 a
large pool carry replaced instead of written in place, PTA103 float
widening beyond the engine's dtype and any float64, PTA104 a host
transfer (`.item()`, a copy to the CPU) inside a program. PTA101 (baked-in
constants) has no eager counterpart and PTA105 (sharded carries) waits
for the port's multi-card serving; their ids stay reserved.
"""
from __future__ import annotations

import fnmatch
import json

__all__ = ["RULES", "Finding", "Baseline", "render_text"]

#: rule id -> (slug, one-line description). The id is the STABLE
#: contract: tests, the baseline, README's rule table and the CI gate
#: all reference these strings verbatim.
RULES = {
    "PTA101": ("jaxpr-baked-const",
               "large constant baked into a compiled program (no eager "
               "counterpart in the port: reserved)"),
    "PTA102": ("jaxpr-undonated-carry",
               "large pool carry the program replaces instead of "
               "updating in place (its storage changes across the run: "
               "a copy of the pool every dispatch)"),
    "PTA103": ("jaxpr-dtype-promotion",
               "float widening beyond the engine's dtype inside a "
               "program (a mixed-precision upcast), or any float64"),
    "PTA104": ("jaxpr-host-callback",
               "host transfer inside a program (.item(), a copy to the "
               "CPU): a device sync on the hot path"),
    "PTA105": ("jaxpr-unsharded-carry",
               "sharded program carry without a layout constraint (waits "
               "for the port's multi-card serving: reserved)"),
    "PTA201": ("lock-unguarded-mutation",
               "attribute of a lock-owning class mutated outside a "
               "`with self.<lock>:` scope"),
    "PTA202": ("snapshot-doc-drift",
               "ServingMetrics.snapshot() keys and SNAPSHOT_DOCS "
               "disagree (schema of record drifted)"),
    "PTA203": ("unregistered-fault-point",
               "faults.inject() names a point no faults.point() "
               "registers — the plan would never fire"),
    "PTA204": ("host-call-in-jit-body",
               "np./time./.item()/.tolist()/.cpu() call inside a program "
               "body (host work or a device sync in every dispatch)"),
}


class Finding:
    """One analyzer result. `where` is display-oriented (file:line or
    program key); `baseline_key` is the stable matching identity."""

    __slots__ = ("rule", "where", "message", "baseline_key")

    def __init__(self, rule, where, message, baseline_key=None):
        if rule not in RULES:
            raise ValueError(f"unknown rule id {rule!r}")
        self.rule = rule
        self.where = str(where)
        self.message = str(message)
        self.baseline_key = (str(baseline_key) if baseline_key
                             is not None else self.where)

    @property
    def slug(self):
        return RULES[self.rule][0]

    def as_dict(self):
        return {"rule": self.rule, "slug": self.slug,
                "where": self.where, "message": self.message,
                "baseline_key": self.baseline_key}

    def __repr__(self):
        return f"Finding({self.rule} {self.where}: {self.message})"


class Baseline:
    """The committed allowlist: `{"version": 1, "entries": [{"rule",
    "match", "justification"}, ...]}`. `match` is fnmatch'd against
    each finding's `baseline_key` (rule must equal exactly)."""

    VERSION = 1

    def __init__(self, entries=()):
        self.entries = [dict(e) for e in entries]
        for e in self.entries:
            if not e.get("rule") or not e.get("match") or \
                    not e.get("justification"):
                raise ValueError(
                    f"baseline entry needs rule/match/justification: "
                    f"{e!r}")

    @classmethod
    def load(cls, path):
        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, dict) or \
                raw.get("version") != cls.VERSION:
            raise ValueError(f"baseline {path} version "
                             f"{raw.get('version')!r} != {cls.VERSION}")
        return cls(raw.get("entries", ()))

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"version": self.VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def _matches(self, entry, finding):
        return entry["rule"] == finding.rule and fnmatch.fnmatchcase(
            finding.baseline_key, entry["match"])

    def split(self, findings):
        """(new, baselined, stale_entries): findings with no entry,
        findings an entry justifies, and entries justifying nothing
        (dead rows the ratchet wants deleted)."""
        new, baselined = [], []
        used = [False] * len(self.entries)
        for f in findings:
            hit = None
            for i, e in enumerate(self.entries):
                if self._matches(e, f):
                    hit = i
                    break
            if hit is None:
                new.append(f)
            else:
                used[hit] = True
                baselined.append(f)
        stale = [e for e, u in zip(self.entries, used) if not u]
        return new, baselined, stale


def render_text(findings, *, prefix="  "):
    lines = []
    for f in findings:
        lines.append(f"{prefix}{f.rule} [{f.slug}] {f.where}")
        lines.append(f"{prefix}    {f.message}")
    return "\n".join(lines)
