"""The port stands alone: `paddle_tpu_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, and the port's entry points run on the
CUDA card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


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
