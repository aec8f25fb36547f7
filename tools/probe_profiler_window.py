"""Probe how often torch.profiler loses a training kernel's record on the
card: eager ERNIE-base under bf16 O1 at chip_smoke phase 36's size (12
layers, b8 s1024), each step profiled by `chip_smoke.
profiled_kernel_counts`, which logs where the step's device events fall
in the window against the host's clock.

    python tools/probe_profiler_window.py --steps 12 --sessions 600

Profiles `--steps` steps, then opens `--sessions` short profiler
sessions around a few matmuls (as a long process does), then profiles
`--steps` more. Prints one line a window and a last JSON line with the
count of windows that read short of 12 launches of a kernel. Needs one
card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--sessions", type=int, default=600)
    ap.add_argument("--pad", type=float, default=0.0,
                    help="idle host seconds at each edge of a window")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler_window: needs a CUDA card")
    _build.load(list(C.TRAIN_KERNELS))
    model = C.ernie("cuda", C.E_LAYERS, (C.E_DROPOUT, C.E_DROPOUT),
                    args.seed)
    model.train()
    opt = optimizer.AdamW(C.E_LR, parameters=model.named_parameters(),
                          weight_decay=0.01)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    (ids, tt, mask), labels = C.ernie_batch(args.seed, C.E_BATCH, C.E_SEQ)
    ins = [torch.as_tensor(a, device="cuda") for a in (ids, tt, mask)]
    lab = torch.as_tensor(labels, device="cuda")

    def step():
        with amp.auto_cast(dtype=torch.bfloat16):
            loss = F.cross_entropy(model(*ins), lab)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()

    for _ in range(4):
        step()
    short = []

    def windows(tag):
        for i in range(args.steps):
            got = C.profiled_kernel_counts(step, args.pad)
            print(f"{tag} {i}: {got}", flush=True)
            if any(got.get((k, "bf16"), 0) != C.E_LAYERS
                   for k in C.TRAIN_KERNELS):
                short.append(f"{tag} {i}")

    windows("fresh")
    x = torch.randn(1024, 1024, device="cuda")
    for _ in range(args.sessions):
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(20):
                x = torch.tanh(x @ x * 1e-3)
            torch.cuda.synchronize()
    windows(f"after {args.sessions} sessions")
    print(json.dumps({"windows": 2 * args.steps, "short": short,
                      "pad_s": args.pad}))


if __name__ == "__main__":
    main()
