#!/usr/bin/env python3
"""chip_smoke.py's phase 37 alone: the tooling. (a) the tunable kernels'
plan overrides against their plain versions and the table-off launch,
(b) the plan sweep beside the committed card tier, (c) cold, warm and
corrupt starts of Transformer-base serving through the AOT cache, each in
a fresh process, (d) the program lints on the card; each judged as in
the full script.

    python3 tools/tooling_phases.py [--seed 0] [--only a,b,c,d]

Builds the kernels first (about a minute), then a few minutes of command
time on one H100, most of it (c)'s cold starts (nvcc in each).
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
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant as Q

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="a,b,c,d")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tooling_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_info().get('seconds', 0.0):.1f} s)", flush=True)
    parts = set(args.only.split(","))
    out = {"card": card}
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    steps = (("a", lambda: cs.check_overrides(Q, g)),
             ("b", cs.sweep_phase),
             ("c", lambda: cs.cold_warm_phase(args.seed)),
             ("d", cs.lint_phase))
    for name, fn in steps:
        if name not in parts:
            continue
        t0 = time.perf_counter()
        print(f"phase 37 ({name})", flush=True)
        out[name] = fn()
        print(f"  ({name}) took {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("tooling summary " + json.dumps(out, default=str), flush=True)
