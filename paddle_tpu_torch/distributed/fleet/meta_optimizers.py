"""The meta-optimizer stack: DistributedStrategy -> the mesh trainer (the
JAX package's `fleet/meta_optimizers.py`).

Reference parity: python/paddle/distributed/fleet/meta_optimizers/
(amp, recompute, gradient_merge, localsgd, dgc, lars, lamb, pipeline,
graph_execution) ordered by base/strategy_compiler.py.

Instead of rewriting programs, each strategy knob maps onto the port's
`parallel.SpmdTrainer`, as the JAX package maps it onto its own:
  amp            -> bfloat16 compute dtype on float32 masters
  recompute      -> remat (activations recomputed in the backward)
  gradient_merge -> grad_accum micro-batches (k_steps)
  dgc            -> top-k sparsified gradients with error feedback
                    (`optimizer.functional.dgc`)
  lars / lamb    -> the rule swapped (`functional.lars_momentum` /
                    `functional.lamb`)
  localsgd       -> periodic averaging of the replicas' parameters
                    (`LocalSGDSync`)
  pipeline       -> GPipe stages (`parallel.pipeline`)
  sharding       -> the optimizer slots take their parameters' blocks
  graph exec     -> the trainer's step itself (always on)
"""
from __future__ import annotations

from ...optimizer import functional as fopt

__all__ = ["applied_meta_list", "transform_from_strategy",
           "spmd_trainer_kwargs", "build_spmd_trainer", "LocalSGDSync"]

_ORDER = ["amp", "recompute", "gradient_merge", "localsgd", "dgc",
          "lars", "lamb", "pipeline", "graph_execution"]


def applied_meta_list(strategy):
    """Which meta-optimizers the compiler would apply, in order
    (StrategyCompiler ordering parity)."""
    out = []
    for k in _ORDER:
        if k == "graph_execution" or getattr(strategy, k, False):
            out.append(k + "_optimizer")
    return out


def transform_from_strategy(strategy, base_tx=None, learning_rate=None):
    """The functional optimizer Transform implied by the strategy (the
    lars / lamb swap and the dgc wrap), from base_tx or SGD."""
    lr = learning_rate if learning_rate is not None else 0.01
    tx = base_tx or fopt.sgd(lr)
    if getattr(strategy, "lamb", False):
        wd = strategy.lamb_configs.get("lamb_weight_decay", 0.01)
        tx = fopt.lamb(lr, weight_decay=wd)
    if getattr(strategy, "lars", False):
        cfg = strategy.lars_configs
        tx = fopt.lars_momentum(
            lr, lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 5e-4))
    if getattr(strategy, "dgc", False):
        tx = fopt.dgc(tx)
    return tx


def spmd_trainer_kwargs(strategy):
    """SpmdTrainer constructor kwargs implied by the strategy."""
    kw = {}
    if getattr(strategy, "amp", False):
        # bf16 AMP: the products accumulate in float32 and the masters
        # stay float32, so no loss scaling is needed (amp_configs' loss
        # scaling is an fp16 setting kept for API parity)
        kw["compute_dtype"] = "bfloat16"
    if getattr(strategy, "recompute", False):
        kw["remat"] = True
    if getattr(strategy, "gradient_merge", False):
        kw["grad_accum"] = int(
            strategy.gradient_merge_configs.get("k_steps", 1))
    return kw


def build_spmd_trainer(layer, loss_fn, strategy, base_optimizer=None,
                       learning_rate=None, mesh=None, rules=None, **kw):
    """GraphExecutionOptimizer's counterpart: the strategy-configured mesh
    train step. `base_optimizer`: a Transform or an eager optimizer of
    the port; extra `kw` (device, generator, batch_axes, ...) go to
    `SpmdTrainer`."""
    from ...parallel import SpmdTrainer

    base_tx = None
    if base_optimizer is not None:
        base_tx = base_optimizer if isinstance(
            base_optimizer, fopt.Transform) else fopt.from_eager(
                base_optimizer)
    tx = transform_from_strategy(strategy, base_tx, learning_rate)
    return SpmdTrainer(layer, loss_fn, tx, mesh=mesh, rules=rules,
                       **spmd_trainer_kwargs(strategy), **kw)


class LocalSGDSync:
    """localsgd_optimizer.py capability: train locally, every k_steps
    average the parameters across the data-parallel replicas."""

    def __init__(self, k_steps=1):
        self.k = max(1, int(k_steps))
        self._step = 0

    def maybe_sync(self, params):
        """params: {name: tensor}. Returns them, averaged over the
        replicas every k-th call."""
        self._step += 1
        if self._step % self.k != 0:
            return params
        from .. import all_reduce_mean_tree

        return all_reduce_mean_tree(params)
