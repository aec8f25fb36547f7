#!/usr/bin/env python3
"""Time the MoE layer's dispatch two ways on one card, in turns.

    python3 tools/ab_moe_dispatch.py [--runs 25]

One `MoELayer` at the MoE ERNIE-base shape (d_model 768, d_ff 3072, 8
experts, capacity factor 1.25; a micro-batch of 8 x 512 tokens, bf16),
forward and backward:
  * "indexing": the queue positions by a scan down the token axis of a
    [tokens, experts] one-hot, the gathers by tensor indexing (whose
    backward sorts the indices);
  * "index_select": the layer as it is (a scan along each expert's row
    of an [experts, tokens] one-hot, `index_select` gathers).
Both must give the same outputs and gradients bit for bit. Device ms
(CUDA events, median of --runs, each queued behind a device sleep) in
the order indexing, index_select, index_select, indexing, then one
profiled pass of each (device ms by kernel). Prints one JSON line with
the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def indexing_forward(layer, x):
    """The layer's function with the first dispatch's gathers."""
    from paddle_tpu_torch.nn import functional as F

    b, s, d = x.shape
    e = layer.num_experts
    tokens = b * s
    cap = layer.capacity(tokens)
    xf = x.reshape(tokens, d)
    probs = torch.softmax(xf @ layer.router, -1)
    route = torch.argmax(probs, -1)
    gate = probs.gather(1, route[:, None])[:, 0]
    onehot = F.one_hot(route, e)
    pos = torch.cumsum(onehot.long(), 0).gather(1, route[:, None])[:, 0] - 1
    keep = pos < cap
    slot = torch.where(keep, route * cap + pos, e * cap)
    token_of_slot = torch.full((e * cap + 1,), tokens, dtype=torch.long,
                               device=x.device).scatter(
        0, slot, torch.arange(tokens, device=x.device))[:e * cap]
    zero = xf.new_zeros(1, d)
    expert_in = torch.cat([xf, zero])[token_of_slot].reshape(e, cap, d)
    h = F.gelu(torch.bmm(expert_in, layer.experts.weight_in))
    expert_out = torch.bmm(h, layer.experts.weight_out)
    rows = torch.cat([expert_out.reshape(e * cap, d), zero])[slot]
    out = rows * (gate * keep.to(gate.dtype))[:, None]
    aux = (onehot.mean(0) * probs.mean(0).float()).sum() * float(e)
    return out.reshape(b, s, d), aux


def device_ms(fn, runs):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernels(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((round(us / 1e3, 4), ev.count, ev.key[:60]))
    return sorted(rows, reverse=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_moe_dispatch: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import nn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    layer = nn.MoELayer(768, 3072, num_experts=8, capacity_factor=1.25,
                        device="cuda",
                        generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 512, 768, device="cuda", generator=g,
                    dtype=torch.bfloat16, requires_grad=True)
    cot = torch.randn(x.shape, device="cuda", generator=g,
                      dtype=torch.bfloat16)
    params = [x] + list(layer.parameters())

    def run(name):
        def fn():
            if name == "indexing":
                out, aux = indexing_forward(layer, x)
            else:
                out, aux = layer(x), layer.aux_loss
            return torch.autograd.grad((out, aux), params,
                                       (cot, torch.ones_like(aux)))
        return fn

    got = {name: [t.clone() for t in run(name)()]
           for name in ("indexing", "index_select")}
    equal = all(torch.equal(a, b) for a, b in zip(got["indexing"],
                                                   got["index_select"]))
    order = ("indexing", "index_select", "index_select", "indexing")
    times = [(name, device_ms(run(name), args.runs)) for name in order]
    for name, ms in times:
        print(f"{name}: {ms:.4f} device ms a forward + backward", flush=True)
    profiles = {name: kernels(run(name))[:6]
                for name in ("indexing", "index_select")}
    for name, rows in profiles.items():
        print(f"{name} kernels (ms, count, name): {rows}", flush=True)
    print(json.dumps({"card": card, "bitwise_equal": equal,
                      "ms": times, "runs": args.runs}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
