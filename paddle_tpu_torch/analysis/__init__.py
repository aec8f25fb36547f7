"""Static analyzer for the port's serving stack: program + host-state
lints (the JAX package's `analysis/`).

Every load-bearing guarantee of the serving stack — programs that update
their pool in place, documented metric schema, registered fault points,
lock-guarded shared state, no host sync inside a program — is otherwise
enforced only dynamically. This package checks the same contracts at the
source and aten-op level, so a whole defect class fails before any
runtime path exercises it.

Two halves (the rule table is `findings.RULES`):

  * **Program analyzer** (`analysis.program`) — runs every program
    `ServingEngine.precompile()` would ready (dense / paged / spec /
    tenant / chunked engines, plus the multi-tensor optimizer step) once
    on a scratch pool under a recording `TorchDispatchMode`: pool carries
    replaced instead of updated in place (PTA102), float widening beyond
    the engine's dtype and float64 (PTA103), host transfers inside a
    program (PTA104).
  * **Host-state + repo lints** (`analysis.hoststate`,
    `analysis.repo_rules`) — AST checks over serving/, tuning/,
    profiler/ and optimizer/fused.py: mutations of lock-owning classes
    outside their lock (PTA201, with the `# analysis: single-threaded`
    escape), snapshot()/SNAPSHOT_DOCS drift (PTA202), unregistered fault
    points (PTA203), host calls inside program bodies (PTA204).

`python -m paddle_tpu_torch.analysis` is the CLI gate; findings carry
stable rule ids and baseline keys matched against the committed
`analysis/baseline.json` allowlist (start green, ratchet down).
"""
from .findings import RULES, Baseline, Finding, render_text
from .hoststate import check_paths, check_source
from .program import analyze_engine, analyze_fused_optimizer, analyze_program
from .repo_rules import (RULE_FAULT_POINT, RULE_SNAPSHOT_DOC,
                         fault_point_findings, snapshot_doc_findings)
from .runner import (build_check_engines, program_findings, repo_root, run,
                     static_findings)

__all__ = [
    "RULES", "Finding", "Baseline", "render_text",
    "check_source", "check_paths",
    "analyze_program", "analyze_engine", "analyze_fused_optimizer",
    "snapshot_doc_findings", "fault_point_findings",
    "RULE_SNAPSHOT_DOC", "RULE_FAULT_POINT",
    "run", "static_findings", "program_findings",
    "build_check_engines", "repo_root",
]
