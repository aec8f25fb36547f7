"""Fleet: the distributed-training facade (the JAX package's
`distributed/fleet`).

Reference parity: python/paddle/distributed/fleet/: Fleet
(base/fleet_base.py:63), DistributedStrategy
(base/distributed_strategy.py over framework/distributed_strategy.proto),
the meta-optimizer stack picked by base/strategy_compiler.py, the role
makers, the distributed metrics, the file systems and the
parameter-server runtime.

Collective mode runs on the port's mesh (`parallel`): the strategy's
knobs map onto the mesh trainer (`meta_optimizers.build_spmd_trainer`:
amp -> bfloat16 compute, recompute -> remat, gradient_merge ->
grad_accum, lars / lamb / dgc -> the functional rules) instead of
program rewrites. The parameter-server mode runs on `distributed.ps`
(`init_server` / `run_server` / `init_worker` / `stop_worker`).
`save_inference_model` and `save_persistables` delegate to the static
graph's `fluid.io`, and `MetaOptimizer.minimize` on a static program's
loss to the inner fluid optimizer (with the recompute checkpoints), as
the JAX package's do.
"""
from __future__ import annotations

import os

from . import metrics  # noqa: F401  (fleet.metrics.sum/max/auc/...)
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         UserDefinedRoleMaker)
from .strategy import DistributedStrategy  # noqa: F401

__all__ = ["Fleet", "MetaOptimizer", "UtilBase", "fleet", "util",
           "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "Role", "metrics"]


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._user_defined_optimizer = None
        self._is_initialized = False

    # ----------------- init / role ----------------
    def init(self, role_maker=None, is_collective=True, strategy=None,
             device=None):
        """Collective mode brings up (or adopts) the world's process group
        (`init_parallel_env(device)`: None is the card)."""
        from .. import init_parallel_env

        self._role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        self._strategy = strategy or DistributedStrategy()
        self._is_collective = is_collective
        if is_collective:
            init_parallel_env(device)
        self._is_initialized = True
        return self

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        from .. import get_rank

        return get_rank()

    def worker_num(self):
        from .. import get_world_size

        return get_world_size()

    def is_worker(self):
        return self._role_maker is None or self._role_maker._is_worker()

    def is_server(self):
        return self._role_maker is not None and self._role_maker._is_server()

    def server_num(self):
        return self._role_maker._server_num() if self._role_maker else 0

    def worker_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_PSERVER_ENDPOINTS", "").split(",")
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from .. import barrier

        barrier()

    # ----------------- optimizer path ----------------
    def distributed_optimizer(self, optimizer, strategy=None):
        from .strategy_compiler import StrategyCompiler

        if strategy is not None:
            self._strategy = strategy
        self._user_defined_optimizer = optimizer
        st = self._strategy or DistributedStrategy()
        # validate and order the strategy set (raises on conflicts: the
        # reference StrategyCompiler's black-list behaviour)
        compiler = StrategyCompiler()
        compiler.generate_optimizer(st, optimizer)
        self._strategy_compiler = compiler
        return MetaOptimizer(optimizer, st, self)

    def distributed_model(self, model):
        from ..parallel import DataParallel

        return DataParallel(model)

    # ----------------- PS runtime ----------------
    def init_worker(self):
        from .parameter_server import runtime

        return runtime.init_worker(self)

    def init_server(self, *args, **kwargs):
        from .parameter_server import runtime

        return runtime.init_server(self, *args)

    def run_server(self):
        from .parameter_server import runtime

        runtime.run_server(self)

    def stop_worker(self):
        from .parameter_server import runtime

        runtime.stop_worker(self)

    # ----------------- save ----------------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from ...fluid.io import save_inference_model

        return save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from ...fluid.io import save_persistables

        return save_persistables(executor, dirname, main_program)


class MetaOptimizer:
    """The strategy-compiler stack (base/strategy_compiler.py parity):
    wraps the user optimizer per the DistributedStrategy's knobs. The
    eager path steps the inner optimizer; the collective step with every
    knob applied is `meta_optimizers.build_spmd_trainer`."""

    def __init__(self, inner, strategy, fleet_obj):
        self._inner = inner
        self._strategy = strategy
        self._fleet = fleet_obj

    def step(self):
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()

    @property
    def _parameters(self):
        return getattr(self._inner, "_parameters", [])

    def state_dict(self):
        return self._inner.state_dict()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Eager: backward, then the inner optimizer's step. A static
        graph's loss: the inner fluid optimizer's `minimize`, wrapped in a
        `RecomputeOptimizer` with the strategy's checkpoints when
        recompute is on (the JAX package's order)."""
        if hasattr(loss, "block"):  # static graph program
            from ...fluid.optimizer import RecomputeOptimizer

            s, opt = self._strategy, self._inner
            if s.recompute:
                opt = RecomputeOptimizer(opt)
                opt._set_checkpoints(s.recompute_configs.get(
                    "checkpoints", []))
            return opt.minimize(loss, startup_program, parameter_list,
                                no_grad_set)
        loss.backward()
        self.step()
        return None, None


fleet = Fleet()

# module-level convenience mirroring `from paddle.distributed import fleet`
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
is_server = fleet.is_server
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
barrier_worker = fleet.barrier_worker
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
worker_endpoints = fleet.worker_endpoints
server_endpoints = fleet.server_endpoints


class UtilBase:
    def all_reduce(self, input, mode="sum"):
        from . import metrics as _m

        return _m._all_reduce(_m._resolve(input), mode)

    def barrier(self):
        fleet.barrier_worker()


util = UtilBase()
