#!/usr/bin/env python3
"""chip_smoke.py's phase 39 alone: multi-GPU serving, fleet, checkpoints
and the parameter server. (a) NCCL at world size 1: the sharded engines
against the one-card engines, a fleet collective step against the mesh
trainer, bit for bit; kernels #8 and #9 at the shard shapes; (b) four
ranks sharing the card over gloo serving Transformer-base (2 decoder
layers, full width) in both layouts, dense, paged, spec_k, int8 + LoRA
and disaggregated, against one rank; (c) tp pretraining's tied decoder
against one rank; (d) async and sharded checkpoints; (e) launch_ps. Each
part judged as in the full script.

    python3 tools/sharded_phases.py [--seed 0]

Builds the kernels first (one nvcc a source, in parallel, before any rank
starts: the ranks load the built libraries).
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import quant as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    out = cs.sharded_phase(A, Q, g, args.seed, card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "sharded_phases.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"seconds": out["seconds"], "card": card}))
