"""The port stands alone: `paddle_tpu_torch` and `chip_smoke.py` import
neither JAX nor the JAX package (nor `ml_dtypes` or `orbax`, which the
card's machine lacks), the port never loads the JAX package's native
library (`csrc/build/libptcore.so`), and the port's entry points run on
the CUDA card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes", "orbax")


def _forbidden(module):
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_patches_no_torch_tensor_method():
    """The JAX package attaches its tensor functions to its Tensor class;
    the port leaves torch.Tensor as it found it."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "cls = (torch.Tensor, torch._C.TensorBase)\n"
        "before = [dict(vars(c)) for c in cls]\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "after = [dict(vars(c)) for c in cls]\n"
        "bad = sorted(n for b, a in zip(before, after)\n"
        "             for n in set(b) | set(a) if b.get(n) is not a.get(n))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_without_device_raise_on_a_box_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.serving import ServingEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn.Linear(4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn.Transformer(16, 2, 1, 1, 32)
    dec = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(16, 2, 32, device="cpu"), 1)
    emb, proj = nn.Embedding(11, 16, device="cpu"), nn.Linear(16, 11,
                                                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(dec, emb, proj)
    ServingEngine(dec, emb, proj, device="cpu")   # asked for: fine


def test_tooling_slice_is_scanned_and_imports_alone():
    """tuning/ and analysis/ (the tooling slice) are among the scanned
    sources, and importing them, their CLIs included, loads no JAX."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("tuning/__init__.py", "tuning/table.py",
                 "tuning/autotune.py", "tuning/aot_cache.py",
                 "analysis/__init__.py", "analysis/__main__.py",
                 "analysis/findings.py", "analysis/hoststate.py",
                 "analysis/program.py", "analysis/repo_rules.py",
                 "analysis/runner.py"):
        assert name in rel, name
    code = (
        "import sys\n"
        "import paddle_tpu_torch.tuning.autotune\n"
        "import paddle_tpu_torch.analysis.__main__\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_multi_gpu_slice_is_scanned_and_imports_alone():
    """parallel/ and distributed/ (the multi-GPU training slice) are among
    the scanned sources, and importing them, the launcher's CLI module
    included, loads no JAX."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("parallel/__init__.py", "parallel/mesh.py",
                 "parallel/sharding.py", "parallel/functional.py",
                 "parallel/collectives.py", "parallel/layers.py",
                 "parallel/spmd.py", "parallel/ring.py",
                 "parallel/pipeline.py", "distributed/__init__.py",
                 "distributed/collective.py", "distributed/parallel.py",
                 "distributed/launch.py", "distributed/rendezvous.py"):
        assert name in rel, name
    code = (
        "import sys\n"
        "import paddle_tpu_torch.parallel\n"
        "import paddle_tpu_torch.distributed.launch\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_second_multi_gpu_slice_is_scanned_and_loads_no_libptcore():
    """serving/sharded.py, distributed/fleet and distributed/ps are among
    the scanned sources; importing them and running a parameter-server
    round trip (the server built from ps_server.cc alone) loads no
    forbidden module and maps no `libptcore`; no port source names it."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("serving/sharded.py", "distributed/fleet/__init__.py",
                 "distributed/fleet/strategy.py",
                 "distributed/fleet/strategy_compiler.py",
                 "distributed/fleet/meta_optimizers.py",
                 "distributed/fleet/role_maker.py",
                 "distributed/fleet/metrics.py",
                 "distributed/fleet/utils/fs.py",
                 "distributed/fleet/parameter_server/runtime.py",
                 "distributed/ps/__init__.py", "distributed/ps/__main__.py",
                 "distributed/ps/_native.py"):
        assert name in rel, name
    for path in _port_files():
        with open(path) as f:
            assert "libptcore" not in f.read(), path
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch.serving.sharded\n"
        "import paddle_tpu_torch.distributed.fleet\n"
        "from paddle_tpu_torch.distributed import ps\n"
        "srv = ps.PsServer(port=0)\n"
        "c = ps.PsClient('127.0.0.1', srv.port)\n"
        "c.init_dense('w', np.ones(3, np.float32))\n"
        "assert c.pull_dense('w', (3,)).sum() == 3\n"
        "c.pull_sparse_bf16('e', np.arange(4), 2)\n"
        "c.close(); srv.stop()\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad += ['libptcore'] if 'libptcore' in maps else []\n"
        "bad += [] if 'libptps' in maps else ['no libptps']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_eager_remainder_slice_is_scanned_and_imports_alone():
    """sparse/, autograd/, distribution/, slim/, utils/, device/,
    dataset/, text/datasets and the places are among the scanned
    sources; importing them (and the top level's new names) loads no
    forbidden module, and nothing of the slice asks for the CPU on its
    own: device=None stays the card until `set_device("cpu")`."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("sparse/__init__.py", "autograd/__init__.py",
                 "distribution/__init__.py", "slim/__init__.py",
                 "slim/quant.py", "utils/__init__.py", "utils/flags.py",
                 "utils/monitor.py", "utils/cpp_extension.py",
                 "device/__init__.py", "core/place.py", "core/random.py",
                 "dataset/__init__.py", "dataset/common.py",
                 "dataset/mnist.py", "text/datasets/__init__.py",
                 "text/datasets/wmt.py", "text/datasets/conll05.py"):
        assert name in rel, name
    code = (
        "import sys\n"
        "import paddle_tpu_torch as p\n"
        "import paddle_tpu_torch.sparse, paddle_tpu_torch.distribution\n"
        "import paddle_tpu_torch.slim, paddle_tpu_torch.utils\n"
        "import paddle_tpu_torch.dataset, paddle_tpu_torch.text.datasets\n"
        "assert p.get_device() == 'gpu:0', p.get_device()\n"
        "assert p.get_flags('FLAGS_check_nan_inf') == "
        "{'FLAGS_check_nan_inf': False}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_static_slice_is_scanned_and_imports_alone():
    """fluid/, static/, inference/, the wire codec and ptc_format are
    among the scanned sources; importing them (and building a program)
    loads no forbidden module and no protobuf, and the Executor and the
    Predictor default to the card."""
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("fluid/__init__.py", "fluid/framework.py",
                 "fluid/lowering.py", "fluid/executor.py", "fluid/ir.py",
                 "fluid/io.py", "fluid/backward.py", "fluid/optimizer.py",
                 "fluid/layers/nn.py", "static/__init__.py",
                 "inference/__init__.py", "core/program_pb.py",
                 "core/ptc_format.py", "framework.py"):
        assert name in rel, name
    code = (
        "import sys\n"
        "import paddle_tpu_torch.fluid as fluid\n"
        "import paddle_tpu_torch.static, paddle_tpu_torch.inference\n"
        "main = fluid.Program()\n"
        "with fluid.program_guard(main, fluid.Program()):\n"
        "    x = fluid.layers.data('x', [3])\n"
        "    fluid.layers.fc(x, 2)\n"
        "fluid.io.model_bytes(main, ['x'], [])\n"
        "assert fluid.executor.place_device(fluid.CPUPlace()).type == "
        "'cpu'\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} or m.startswith('google.protobuf'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
