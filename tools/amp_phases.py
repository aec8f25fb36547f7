#!/usr/bin/env python3
"""chip_smoke.py's phase 36 alone: mixed precision and observability
(ERNIE-base under amp.auto_cast O1 in bf16 and f16 with a GradScaler,
the f16 flash kernels against their plain versions and their times, a
2-layer card-against-CPU O1 step, traced and costed Transformer-base
serving, the lockstep profile, fit_report's MFU), each judged as in the
full script.

    python3 tools/amp_phases.py [--seed 0]

Builds the kernels first (about a minute), then about two to three
minutes of command time on one H100.
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
    from paddle_tpu_torch.ops import attention as A

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("amp_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out, rows = cs.amp_observability_phase(A, args.seed)
    print("amp and observability summary " + json.dumps(
        {"card": card, **out, "f16_rows": rows}), flush=True)
    print(f"phase 36 took {time.perf_counter() - t0:.1f} s", flush=True)
