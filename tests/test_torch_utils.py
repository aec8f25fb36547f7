"""The port's `utils/` against the JAX package's, on the CPU (the
counterpart of `tests/test_aux_subsystems.py:134` (custom C++ ops) and
:353 (the stat registry)).

The flag registry holds the JAX keys and defaults and coerces as JAX
does; `FLAGS_check_nan_inf` raises at the op that made a NaN or an Inf
(forward and backward) and stops when cleared; `FLAGS_cudnn_deterministic`
turns torch's deterministic algorithms on and off; the stat registry
counts as JAX's does under four threads; a g++-built custom op gives the
JAX op's output eagerly and through its static lowering.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch as tp
from paddle_tpu_torch.utils import flags as tflags

torch.set_num_threads(1)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


def test_flag_registry_matches_jax():
    assert set(tflags._FLAGS) == set(jflags._FLAGS)
    names = ["FLAGS_benchmark", "FLAGS_rpc_deadline",
             "FLAGS_fraction_of_gpu_memory_to_use", "FLAGS_no_such_flag"]
    assert tp.get_flags(names) == jp.get_flags(names)
    saved = tp.get_flags(names[:3])
    try:
        for m in (jp, tp):
            m.set_flags({"FLAGS_benchmark": "yes", "FLAGS_rpc_deadline": "7",
                         "FLAGS_fraction_of_gpu_memory_to_use": "0.5"})
        assert tp.get_flags(names) == jp.get_flags(names)
        assert tp.get_flags("FLAGS_benchmark") == {"FLAGS_benchmark": True}
    finally:
        tp.set_flags(saved)
        jp.set_flags(saved)


def test_check_nan_inf_raises_at_the_op():
    x = torch.tensor([1.0, 0.0], requires_grad=True)
    try:
        tp.set_flags({"FLAGS_check_nan_inf": True})
        y = x * 2.0                                   # finite: passes
        with pytest.raises(FloatingPointError, match="div"):
            torch.ones(2) / torch.tensor([1.0, 0.0])  # inf at the division
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0]))           # nan at the log
        with pytest.raises(FloatingPointError):
            # a finite forward whose backward makes an Inf (d sqrt at 0)
            torch.sqrt(x).sum().backward()
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})
    assert tflags._NAN_MODE[0] is None
    assert torch.isinf(torch.ones(1) / torch.zeros(1)).all()
    assert not torch.is_anomaly_enabled()
    assert float(y.sum()) == 2.0


def test_cudnn_deterministic_maps_to_torch():
    try:
        tp.set_flags({"FLAGS_cudnn_deterministic": 1})
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
    finally:
        tp.set_flags({"FLAGS_cudnn_deterministic": False})
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.backends.cudnn.deterministic


def test_stat_registry_matches_jax():
    from paddle_tpu.utils import monitor as jm
    from paddle_tpu_torch.utils import monitor as tm

    snaps = []
    for m in (jm, tm):
        m.StatRegistry.instance().reset()
        m.stat_update("reader.bytes", 100)
        m.stat_update("reader.bytes", 50)
        m.stat_set("mem.peak", 4096)
        with m.Timer("step"):
            pass

        def w(mod=m):
            for _ in range(1000):
                mod.stat_update("concurrent")

        ts = [threading.Thread(target=w) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        s = m.get_stats()
        assert s["step.count"] == 1 and s["step.total_us"] >= 0
        snaps.append({k: v for k, v in s.items() if k != "step.total_us"})
    assert snaps[0] == snaps[1]
    assert snaps[1]["concurrent"] == 4000


CUSTOM_OP_SRC = r"""
extern "C" void relu_clip(const float* x, float* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    float v = x[i] > 0.f ? x[i] : 0.f;
    out[i] = v > 1.f ? 1.f : v;
  }
}
"""


def test_custom_cpp_op_eager(tmp_path):
    from paddle_tpu.utils import cpp_extension as jce
    from paddle_tpu_torch.utils import cpp_extension as tce

    src = tmp_path / "relu_clip.cc"
    src.write_text(CUSTOM_OP_SRC)
    x = np.array([[-1.0, 0.5], [2.0, 0.25]], "float32")
    jop = jce.register_custom_op("relu_clip", jce.load(
        "relu_clip", [str(src)], build_directory=str(tmp_path / "j")))
    top = tce.register_custom_op("relu_clip", tce.load(
        "relu_clip", [str(src)], build_directory=str(tmp_path / "t")))
    got = top(torch.from_numpy(x))
    assert got.shape == (2, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  jop(jp.to_tensor(x)).numpy())
    # the static lowering: the op in a fluid program, run by the Executor
    import paddle_tpu_torch.fluid as tfluid

    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        xv = tfluid.layers.data("x", [2, 2], dtype="float32",
                                append_batch_size=False)
        yv = top.static_layer(xv)
    static, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, {"x": x}, [yv], scope=tfluid.Scope())
    np.testing.assert_array_equal(static, got.numpy())
    with pytest.raises(RuntimeError, match="build failed"):
        bad = tmp_path / "bad.cc"
        bad.write_text("not c++")
        tce.load("bad", [str(bad)], build_directory=str(tmp_path / "t"))


def test_try_import_and_unique_name():
    from paddle_tpu_torch import utils

    assert utils.try_import("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="not available"):
        utils.try_import("no_such_module_xyz")
    a, b = utils.unique_name("pt_util_probe"), \
        utils.unique_name("pt_util_probe")
    assert a != b and a.startswith("pt_util_probe_")
