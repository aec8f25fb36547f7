"""Helpers of the static-graph parity tests: the same program built by
both packages' fluid layers, run by both Executors on the CPU, and the
JAX side's wire bytes composed from `paddle_tpu.core.program_pb` and
`paddle_tpu.core.ptc_format` only (never through `paddle_tpu.fluid.io`,
whose save and load build the JAX package's native library). The static
ERNIE encoder is `chip_smoke.py`'s (phase 41), at small widths."""
import numpy as np
import pytest
import torch

# phase 41's programs: the static ERNIE encoder (with its seeded weights
# and feeds) and LeNet
from chip_smoke import (static_ernie, static_feed, static_lenet,  # noqa
                        static_params)


def fluids():
    import paddle_tpu.fluid as jf
    import paddle_tpu_torch.fluid as tf

    return jf, tf


# ----------------------------------------------------------------- wire


def jax_program_bytes(program):
    from paddle_tpu.core import program_pb

    return program_pb.program_to_proto(program).SerializeToString()


def port_program_bytes(program):
    from paddle_tpu_torch.core import program_pb

    return program_pb.program_to_proto(program).SerializeToString()


def jax_model_bytes(program, feed_names, fetch_names):
    from paddle_tpu.core import program_pb

    m = program_pb.messages()
    model = m.InferenceModel()
    model.program.CopyFrom(program_pb.program_to_proto(program))
    model.feed_names.extend(list(feed_names))
    model.fetch_names.extend(list(fetch_names))
    return model.SerializeToString()


def jax_program_from_bytes(data):
    """A JAX Program from `__model__` bytes (an InferenceModel)."""
    from paddle_tpu.core import program_pb

    model = program_pb.messages().InferenceModel()
    model.ParseFromString(data)
    return (program_pb.proto_to_program(model.program),
            list(model.feed_names), list(model.fetch_names))


def jax_load_inference_model(dirname, executor, model_filename=None,
                             params_filename=None):
    """`paddle_tpu.fluid.io.load_inference_model` with its params read by
    the pure-Python `ptc_format` (the same file; no native library)."""
    import os

    from paddle_tpu.core import ptc_format
    from paddle_tpu.fluid.executor import global_scope
    from paddle_tpu.fluid.io import _restore

    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        program, feeds, fetches = jax_program_from_bytes(f.read())
    program._model_dir = os.path.abspath(dirname)
    path = os.path.join(dirname, params_filename or "__params__")
    if os.path.exists(path):
        arrays = ptc_format.load_combine(path)
        _restore({k: (a.dtype.name, a) for k, a in arrays.items()},
                 global_scope())
    return program, feeds, [program.global_block().var(n) for n in fetches]


@pytest.fixture
def jax_predictor_loader(monkeypatch):
    """Make the JAX Predictor read artifacts through
    `jax_load_inference_model` (its own pass pipeline still runs)."""
    import paddle_tpu.fluid.io as jio

    monkeypatch.setattr(jio, "load_inference_model",
                        jax_load_inference_model)


# ----------------------------------------------------------- execution


def scope_values(scope):
    return {n: np.asarray(v) for n, v in scope._values.items()
            if v is not None}


def carry(jax_scope, port_scope):
    """The JAX scope's values into the port's scope (CPU tensors)."""
    from paddle_tpu_torch.convert import from_jax_scope

    return from_jax_scope(scope_values(jax_scope), port_scope, "cpu")


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def run_pair(jprog, tprog, feed, fetch, jscope, tscope, steps=1):
    """Both Executors (CPU) over `steps` runs; fetches of each step."""
    jf, tf = fluids()
    jexe, texe = jf.Executor(), tf.Executor(tf.CPUPlace())
    outs = []
    for _ in range(steps):
        a = jexe.run(jprog, feed=dict(feed), fetch_list=list(fetch),
                     scope=jscope)
        b = texe.run(tprog, feed=dict(feed), fetch_list=list(fetch),
                     scope=tscope)
        outs.append((a, b))
    return outs


def assert_close(got, want, rtol=1e-5, atol=1e-6, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


# ------------------------------------------------------------ programs


def op_program(fluid, op_type, inputs, attrs, outputs):
    """One op over data vars: inputs {slot: [array, ...]}, outputs
    {slot: count}. Returns (program, feed, fetch names)."""
    main = fluid.Program()
    blk = main.global_block()
    ins, feed = {}, {}
    for slot, arrs in inputs.items():
        names = []
        for j, a in enumerate(arrs):
            name = f"in_{slot}_{j}"
            a = np.asarray(a)
            blk.create_var(name=name, shape=list(a.shape),
                           dtype=a.dtype.name, is_data=True)
            feed[name] = a
            names.append(name)
        ins[slot] = names
    outs, fetch = {}, []
    for slot, n in outputs.items():
        names = [f"out_{slot}_{j}" for j in range(n)]
        for name in names:
            blk.create_var(name=name)
        outs[slot] = names
        fetch += names
    blk.append_op(type=op_type, inputs=ins, outputs=outs,
                  attrs=dict(attrs))
    return main, feed, fetch


def lenet(fluid, optimizer="adam"):
    """`bench.py`'s static LeNet (phase 41's) under Adam 1e-3, SGD 0.05 or
    Momentum 0.05 / 0.9."""
    opt = {"adam": None,
           "sgd": lambda f: f.optimizer.SGD(0.05),
           "momentum": lambda f: f.optimizer.Momentum(0.05, 0.9)}
    return static_lenet(fluid, opt[optimizer])


def no_cuda():
    return not torch.cuda.is_available()
