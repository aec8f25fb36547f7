"""Static-graph save/load (the JAX package's `fluid/io.py`).

Reference parity: fluid/io.py — save_persistables :598, load_persistables
:966, save_inference_model :1164 (prunes to feed/fetch subgraph, writes
`__model__` + params), load_inference_model :1374.

`__model__` is the InferenceModel message of
`csrc/proto/ptframework.proto`, written and read by the port's own codec
(`core/program_pb.py`); `__params__` is the PTC1 combined tensor file,
written and read by `core/ptc_format.py`. Both are byte for byte the JAX
package's files for the same program and values; no protobuf library and
no native library is involved. `save_persistables` / `static.save` write
the JAX package's pickle of (dtype name, numpy array) pairs.
`DataLoader.from_generator` / `PyReader` come with ROADMAP item 8c.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core import program_pb, ptc_format
from .dtypes import dtype_name
from .executor import _to_numpy, global_scope
from .framework import default_main_program

ITEM_8C = "ROADMAP item 8c"


class EOFException(Exception):
    """The reader's end-of-data signal (fluid.core.EOFException)."""


def _reader_waits(name):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"fluid.io.{name}: the static data readers come with {ITEM_8C}")
    return make


class DataLoader:
    """fluid.io.DataLoader namespace (reader.py:392): `from_generator`
    comes with ROADMAP item 8c; the eager loader is `paddle.io.DataLoader`."""

    from_generator = staticmethod(_reader_waits("DataLoader.from_generator"))


PyReader = _reader_waits("PyReader")
GeneratorLoader = _reader_waits("GeneratorLoader")


def _collect_persistables(program, scope, predicate=None):
    """{name: (dtype name, numpy array)} of the program's persistables in
    the scope; bf16 values as float32 arrays tagged "bfloat16"."""
    out = {}
    for v in program.global_block().vars.values():
        if not v.persistable:
            continue
        if predicate is not None and not predicate(v):
            continue
        val = scope._values.get(v.name)
        if val is None:
            continue
        if torch.is_tensor(val) and val.dtype == torch.bfloat16:
            out[v.name] = ("bfloat16", _to_numpy(val))
        else:
            arr = _to_numpy(val)
            out[v.name] = (arr.dtype.name, arr)
    return out


def _restore(values, scope, device=None):
    """Put (dtype name, array) pairs into the scope as tensors on
    `device` (the CPU when None)."""
    for name, (dt, arr) in values.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dt == "bfloat16":
            t = t.to(torch.bfloat16)
        scope._values[name] = t.to(device) if device is not None else t


def _executor_device(executor):
    return getattr(executor, "device", None)


def save_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    vals = _collect_persistables(main_program, global_scope())
    with open(os.path.join(dirname, filename or "__params__"), "wb") as f:
        pickle.dump(vals, f)


save_params = save_persistables


def load_persistables(executor, dirname, main_program=None, filename=None):
    with open(os.path.join(dirname, filename or "__params__"), "rb") as f:
        vals = pickle.load(f)
    _restore(vals, global_scope(), _executor_device(executor))


load_params = load_persistables


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Writes the deployable artifact: `__model__` = InferenceModel
    message and `__params__` = PTC1 combined tensor file."""
    main_program = main_program or default_main_program()
    pruned = main_program._prune(target_vars)
    pruned = pruned.clone(for_test=True)
    needed = {v.name for v in pruned.global_block().vars.values()
              if v.persistable}
    return _write_model_artifact(
        dirname, pruned, feeded_var_names, target_vars,
        params_from=main_program,
        param_filter=(lambda k: k in needed),
        model_filename=model_filename, params_filename=params_filename,
        program_only=program_only)


def model_bytes(program, feed_names, fetch_names):
    """The `__model__` bytes of a program with its feeds and fetches."""
    model = program_pb.InferenceModel(
        program=program_pb.program_to_proto(program),
        feed_names=list(feed_names), fetch_names=list(fetch_names))
    return model.SerializeToString()


def _write_model_artifact(dirname, program, feed_names, fetch_vars,
                          params_from=None, param_filter=None,
                          model_filename=None, params_filename=None,
                          program_only=False):
    """Shared __model__ + __params__ (PTC1) writer behind
    save_inference_model and save_train_model."""
    os.makedirs(dirname, exist_ok=True)
    fetch_names = [t.name if hasattr(t, "name") else t
                   for t in fetch_vars]
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(model_bytes(program, feed_names, fetch_names))
    if not program_only:
        vals = _collect_persistables(params_from or program,
                                     global_scope())
        # PTC1 stores bf16 payloads as f32 (the dtype tag comes back from
        # the var's dtype in the program on load)
        arrays = {k: arr for k, (dt, arr) in vals.items()
                  if param_filter is None or param_filter(k)}
        ptc_format.save_combine(
            os.path.join(dirname, params_filename or "__params__"), arrays)
    return fetch_names


def save_train_model(dirname, feeded_var_names, fetch_vars, executor,
                     main_program=None):
    """The TRAINING artifact (reference: fluid/train/
    test_train_recognize_digits.cc): same __model__ + __params__ format as
    save_inference_model but WITHOUT pruning or for_test cloning — the
    jax_autodiff backward op and the update ops stay in the block."""
    main_program = main_program or default_main_program()
    return _write_model_artifact(dirname, main_program,
                                 feeded_var_names, fetch_vars)


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars) of an artifact; its parameters go
    into the global scope on the executor's device."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        model = program_pb.InferenceModel.FromString(f.read())
    program = program_pb.proto_to_program(model.program)
    program._model_dir = os.path.abspath(dirname)
    params_path = os.path.join(dirname, params_filename or "__params__")
    if os.path.exists(params_path):
        arrays = ptc_format.load_combine(params_path)
        blk = program.global_block()
        vals = {}
        for name, arr in arrays.items():
            dt = arr.dtype.name
            if blk.has_var(name):
                vdt = getattr(blk.var(name), "dtype", None)
                if vdt is not None and dtype_name(vdt) == "bfloat16":
                    dt = "bfloat16"
            vals[name] = (dt, arr)
        _restore(vals, global_scope(), _executor_device(executor))
    feed_names = list(model.feed_names)
    fetch_vars = [program.global_block().var(n)
                  for n in model.fetch_names]
    return program, feed_names, fetch_vars
