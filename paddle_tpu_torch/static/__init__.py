"""paddle.static 2.0 namespace (reference: python/paddle/static/; the JAX
package's `static/`), over the port's fluid stack."""
from __future__ import annotations

import pickle

from ..fluid import BuildStrategy, CompiledProgram  # noqa: F401
from ..fluid import ExecutionStrategy  # noqa: F401
from ..fluid.backward import append_backward, gradients  # noqa: F401
from ..fluid.dtypes import convert_dtype
from ..fluid.executor import Executor, Scope, global_scope, scope_guard  # noqa
from ..fluid.framework import (Program, Variable,  # noqa: F401
                               default_main_program,
                               default_startup_program, device_guard,
                               name_scope, program_guard)
from ..fluid.io import (load_inference_model, save_inference_model,  # noqa
                        load_persistables, save_persistables)
from ..fluid.layers.tensor import data as _fluid_data
from . import nn  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data: no implicit batch dim."""
    return _fluid_data(name, shape, dtype, lod_level,
                       append_batch_size=False)


class InputSpec:
    """paddle.static.InputSpec parity."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"


def save(program, model_path, protocol=4):
    """`<path>.pdparams` (the persistables' (dtype, array) pickle) and
    `<path>.pdmodel` (the program desc), as the JAX package writes them."""
    from ..fluid.io import _collect_persistables

    vals = _collect_persistables(program, global_scope())
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(vals, f, protocol=protocol)
    with open(model_path + ".pdmodel", "wb") as f:
        f.write(program.desc_bytes())


def load(program, model_path, executor=None, var_list=None):
    from ..fluid.io import _restore

    with open(model_path + ".pdparams", "rb") as f:
        vals = pickle.load(f)
    _restore(vals, global_scope(), getattr(executor, "device", None))
