"""Time the optimizer step of two or more checkouts on one card, in turns:
`chip_smoke.optimizer_kernels` (phase 25 c) on the parameters of
ERNIE-base pretraining (`ErnieConfig.base()`, 205 float32 tensors, ~100M
parameters) with seeded random gradients, for the trainer's update
(`from_eager`), the eager AdamW recipe's multi-tensor step and its
per-parameter path: the device kernels and device ms of one step
(torch.profiler) and the host ms a step over `--steps` steps. No flash
kernel runs, so nothing is built.

Each ROOT is a directory holding a `paddle_tpu_torch/` package (a
checkout, or `git archive <tree> | tar -x -C ROOT`); `chip_smoke.py`
is always this checkout's. Every ROOT runs in a process of its own;
list them in the order to run, e.g. parent, change, change, parent.
Prints one JSON line per run with the card's name and power limit.

    python tools/ab_optimizer_step.py [--steps 10] PARENT . . PARENT
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_root(root, steps):
    """{path: {kernels, device_ms, host_ms}} with the package under
    `root`."""
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch
    from paddle_tpu_torch.parallel import SpmdTrainer

    model = cs.pretrain_model("cuda", cs.E_LAYERS, (0.0, 0.0), 0)
    g = torch.Generator(device="cuda").manual_seed(1)
    grads = {n: torch.randn(p.shape, generator=g, device="cuda") * 1e-2
             for n, p in model.named_parameters()}
    tr = SpmdTrainer(model, cs.pretrain_loss, cs.pretrain_recipe(model),
                     device="cuda")
    out = cs.optimizer_kernels(tr, grads, steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"root": root, "package": os.path.dirname(
        paddle_tpu_torch.__file__), "card": card, "steps": steps, **out}


def main(argv):
    steps = 10
    if len(argv) > 2 and argv[1] == "--steps":
        steps = int(argv[2])
        argv = argv[:1] + argv[3:]
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(time_root(os.path.abspath(argv[2]), steps)),
              flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--steps", str(steps), "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
