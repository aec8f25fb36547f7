#!/usr/bin/env python3
"""chip_smoke.py's phase 35 alone: the op library's sequence,
structured-loss and detection ops (LAC, CRNN + CTC, SSD300, YOLOv3,
Faster R-CNN R50-C4, the op sweep), each judged as in the full script.

    python3 tools/op_phases.py [--seed 0]

Builds no kernel (none of these ops has one). About two minutes of
command time on one H100.
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
        print("op_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    out = cs.op_library_phase(args.seed)
    print("op library summary " + json.dumps({"card": card, **out}),
          flush=True)
    print(f"phase 35 took {time.perf_counter() - t0:.1f} s", flush=True)
