"""fluid 1.x namespace (reference: python/paddle/fluid/__init__.py; the JAX
package's `fluid/`).

The static graph's main path is ported (ROADMAP item 8a): Program and the
layers, `append_backward` / `minimize`, the Executor (op by op on torch
tensors, on the card unless given `CPUPlace()`), the IR passes and
`save_inference_model` / `load_inference_model`. Still to come, each
raising with its sub-item: the control-flow, sequence and detection
builders and the rest of the op lowerings (8b); the readers, datasets,
transpiler, pipeline and data-parallel `CompiledProgram` (8c).
"""
import torch

from ..core.lod import (LoDTensor, create_lod_tensor,  # noqa: F401
                        create_random_int_lodtensor)
from ..core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa
                          TPUPlace, XPUPlace)
from ..regularizer import L1Decay, L2Decay  # noqa: F401
from ..utils.flags import get_flags, set_flags  # noqa: F401
from . import initializer, io, ir, layers, nets, optimizer  # noqa: F401
from .backward import append_backward, calc_gradient, gradients  # noqa
from .executor import Executor, Scope, global_scope, scope_guard  # noqa
from .framework import (Program, Variable, default_main_program,  # noqa
                        default_startup_program, device_guard, name_scope,
                        program_guard, unique_name)
from .io import EOFException, PyReader  # noqa: F401
from .layer_helper import LayerHelper, ParamAttr  # noqa: F401
from .layers.tensor import data  # noqa: F401

ITEM_8C = "ROADMAP item 8c"


def _transpiler_waits(*args, **kwargs):
    raise NotImplementedError(
        f"fluid.DistributeTranspiler: the transpiler comes with {ITEM_8C}")


DistributeTranspiler = _transpiler_waits
DistributeTranspilerConfig = _transpiler_waits


class CompiledProgram:
    """fluid/compiler.py:87 parity: the Executor runs it as its program.
    Data parallelism over more than one rank comes with ROADMAP item 8c."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._data_parallel = False
        self._loss_name = None
        self.build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        ranks = torch.distributed.get_world_size() if (
            torch.distributed.is_available()
            and torch.distributed.is_initialized()) else 1
        if ranks > 1 or (places is not None and len(places) > 1):
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel over more than one "
                f"rank comes with {ITEM_8C}")
        self._data_parallel = True
        self._loss_name = loss_name
        return self

    def __getattr__(self, item):
        return getattr(self._program, item)


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.num_trainers = 1
        self.trainer_id = 0


def is_compiled_with_cuda():
    return torch.version.cuda is not None
