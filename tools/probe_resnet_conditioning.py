"""Probe how well conditioned one float32 training step of the port's
ResNet-50 is at random init, on the CPU, independently of any
convolution algorithm.

For each (batch, image size) it builds `resnet50(num_classes=10)` from
`--seed` and images and labels as `chip_smoke.py`'s card-vs-CPU step
makes them, then computes one training-mode forward + backward (the
float32 log-softmax cross entropy of the bench) three ways:

  * in float64: the reference gradient and running stats;
  * in float64 again, with every weight and image entry perturbed by a
    random relative amount of at most 2**-24 (half a float32 ulp): how
    far the function alone moves the result for input errors of the
    size float32 rounding makes, whatever the arithmetic;
  * in float32 on the CPU.

It prints, per size, the relative L2 distance of the gradients and the
largest error of the running stats (of each buffer's largest entry)
from the float64 reference, for the perturbed float64 run and for the
float32 run, and the gradient's condition estimate (perturbed distance
over 2**-24).

    python tools/probe_resnet_conditioning.py
    python tools/probe_resnet_conditioning.py --sizes 2x64 8x128
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.vision.models import resnet50  # noqa: E402

HALF_ULP = 2.0 ** -24


def softmax_ce(logits, labels):
    lp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                         torch.float32)), -1)
    return -lp.gather(1, labels[:, None]).mean()


def step(seed, imgs, labels, dtype, perturb=None):
    """(loss, {name: gradient}, {name: running stat}) of one training
    forward + backward in `dtype`; `perturb` a numpy RandomState that
    scales every weight and image entry by (1 + u * 2**-24), |u| <= 1."""
    model = resnet50(num_classes=10, device="cpu",
                     generator=torch.Generator().manual_seed(seed)).to(dtype)
    x = torch.from_numpy(imgs).to(dtype)
    if perturb is not None:
        def jitter(t):
            u = torch.from_numpy(perturb.uniform(-1, 1, t.shape))
            return t * (1 + u.to(t.dtype) * HALF_ULP)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(jitter(p))
        x = jitter(x)
    model.train()
    loss = softmax_ce(model(x), torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    stats = {n: b.double() for n, b in model.named_buffers()}
    return float(loss.detach()), grads, stats


def rel_l2(a, b):
    num = sum(float((a[n] - b[n]).pow(2).sum()) for n in b)
    return (num / sum(float(b[n].pow(2).sum()) for n in b)) ** 0.5


def stats_err(a, b):
    return max(float((a[n] - b[n]).abs().max() / b[n].abs().max())
               for n in b)


def worst_param(a, b):
    rel = {n: float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-300))
           for n in b}
    n = max(rel, key=rel.get)
    return n, rel[n]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sizes", nargs="+", default=["2x64", "8x64", "2x128",
                                                   "8x128"])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for size in args.sizes:
        b, s = (int(v) for v in size.split("x"))
        rs = np.random.RandomState(args.seed + 1)
        imgs = rs.randn(b, 3, s, s).astype(np.float32)
        labels = rs.randint(0, 10, (b,)).astype(np.int64)
        l64, g64, s64 = step(args.seed, imgs, labels, torch.float64)
        lp, gp, sp = step(args.seed, imgs, labels, torch.float64,
                          np.random.RandomState(args.seed + 2))
        l32, g32, s32 = step(args.seed, imgs, labels, torch.float32)
        d_pert, d32 = rel_l2(gp, g64), rel_l2(g32, g64)
        print(json.dumps({
            "batch": b, "image": s, "loss_f64": l64,
            "loss_rel_perturbed": abs(lp - l64) / abs(l64),
            "loss_rel_f32": abs(l32 - l64) / abs(l64),
            "grad_rel_l2_perturbed": d_pert, "grad_rel_l2_f32": d32,
            "grad_condition_estimate": d_pert / HALF_ULP,
            "worst_param_perturbed": worst_param(gp, g64),
            "stats_err_perturbed": stats_err(sp, s64),
            "stats_err_f32": stats_err(s32, s64),
            "worst_stat_f32": worst_param(s32, s64)}), flush=True)


if __name__ == "__main__":
    main()
