#!/usr/bin/env python3
"""chip_smoke.py's phase 38 alone: multi-GPU training. (a) NCCL at world
size 1 against the one-device trainer and eager step, bit for bit, and
whether NCCL takes two ranks on one card; (b) four ranks sharing the card
over gloo: ERNIE-base at dp=2, tp=2 and dp=2 x tp=2 against one rank, a
bf16 dropout step on dp=2 x tp=2 (the main path's kernel launches), MoE
ERNIE-base at ep=2, SyncBatchNorm at dp=2, the causal sp=4 ring at s4096,
a 2-stage GPipe ERNIE-base; (c) the flash kernels' dropout address on
(batch, head) shards, bit for bit. Each part judged as in the full script.
Part p is (b)'s float32 dp / tp / dp x tp steps alone.

    python3 tools/mesh_phases.py [--seed 0] [--only a,b,c]
    python3 tools/mesh_phases.py --device cpu --layers 2 --only p

Builds the kernels first (one nvcc a source, in parallel, before any rank
starts: the ranks load the built libraries), then about three minutes of
command time on one H100. `--device cpu` rehearses part p on the host's
cores (no kernel runs; `--layers` cuts the encoder's depth): its errors
are the readings a fault in the mesh code gives, not a device metric.
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
    ap.add_argument("--only", default="a,b,c")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=None,
                    help="encoder layers of part p (ERNIE-base's 12)")
    args = ap.parse_args()
    parts = set(args.only.split(","))
    if args.device == "cpu" and parts != {"p"}:
        ap.error("--device cpu rehearses part p alone")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    out = {}
    if args.device == "cuda":
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.ops import attention as A

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = out["card"] = cs.card_line()
        print(card, torch.__version__, torch.version.cuda, flush=True)
        t0 = time.perf_counter()
        _build.load()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc "
              f"{_build.build_info().get('seconds', 0.0):.1f} s)",
              flush=True)
    if "a" in parts:
        t0 = time.perf_counter()
        out["a"] = cs.nccl_world_one(A, args.seed)
        out["nccl_two_ranks_one_card"] = cs.nccl_refusal_probe()
        print(f"phase 38 (a) {json.dumps(out['a'])}; NCCL, two ranks on "
              f"cuda:0: {out['nccl_two_ranks_one_card']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "b" in parts:
        out["b"] = cs.mesh_phase(A, args.seed, card, nccl=False)
    if "p" in parts:
        pool = cs.MeshPool(cs.MESH_RANKS, args.device)
        try:
            base = cs.mesh_base(args.seed, args.layers)
            pool.run(1, "mesh_train_task", dict(base, mesh=None))
            out["p"] = cs.mesh_parity(pool, base)
        finally:
            pool.close()
    if "c" in parts:
        t0 = time.perf_counter()
        out["c"] = cs.dropout_address_kernels(A, args.seed)
        print(f"phase 38 (c) {json.dumps(out['c'])} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print("multi-GPU summary " + json.dumps(out, default=str), flush=True)
