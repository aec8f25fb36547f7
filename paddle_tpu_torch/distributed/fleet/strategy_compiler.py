"""StrategyCompiler: meta-optimizer selection, ordering, conflicts (the
JAX package's `fleet/strategy_compiler.py`, the port's own copy).

Reference parity: fleet/base/strategy_compiler.py +
meta_optimizer_factory.py — each meta optimizer declares what it can
apply to and which others it disables; the compiler picks a valid
ordered subset or raises. What each strategy becomes lives in
meta_optimizers.py; this module owns the selection logic.
"""
from __future__ import annotations

from .meta_optimizers import _ORDER

# strategy -> strategies it DISABLES when applied (mirrors the
# meta-optimizers' self._meta_optimizers_black_list declarations)
_CONFLICTS = {
    "lamb": {"lars", "dgc"},
    "lars": {"lamb", "dgc"},
    "dgc": {"lamb", "lars"},
    "localsgd": {"dgc", "pipeline", "gradient_merge"},
    "pipeline": {"localsgd"},
}

# strategy -> predicate(inner_optimizer_name) it requires
_REQUIRES = {
    "dgc": lambda opt: opt in ("momentum", "sgd", None),
}


class StrategyCompiler:
    """generate_optimizer parity: validate + order the applied set."""

    def __init__(self):
        self._applied = []

    def generate_optimizer(self, strategy, inner_optimizer=None):
        requested = [k for k in _ORDER
                     if k != "graph_execution" and
                     getattr(strategy, k, False)]
        inner_name = None
        if inner_optimizer is not None:
            inner_name = type(inner_optimizer).__name__.lower().replace(
                "optimizer", "")
        # conflict check: a requested strategy may not be disabled by an
        # earlier (higher-priority) requested strategy
        applied = []
        for k in requested:
            blockers = [a for a in applied
                        if k in _CONFLICTS.get(a, ()) or
                        a in _CONFLICTS.get(k, ())]
            if blockers:
                raise ValueError(
                    f"DistributedStrategy conflict: {k!r} cannot be "
                    f"combined with {blockers} (reference strategy "
                    f"compiler black-list)")
            req = _REQUIRES.get(k)
            if req and not req(inner_name):
                raise ValueError(
                    f"strategy {k!r} requires a momentum/sgd inner "
                    f"optimizer, got {inner_name!r}")
            applied.append(k)
        self._applied = applied + ["graph_execution"]
        return self._applied

    @property
    def applied_meta_list(self):
        return [k + "_optimizer" for k in self._applied]
