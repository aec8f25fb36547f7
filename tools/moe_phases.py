#!/usr/bin/env python3
"""chip_smoke.py's phases 33-34 alone, beside phase 25 (a)'s dense run.

    python3 tools/moe_phases.py

Builds the kernels, runs phase 25 (a) with remat off and profiles one of
its updates (the dense numbers phase 33 prints beside its own), then
phase 33 (MoE ERNIE-base pretraining, remat on and off, the MoE layer's
split, the 2-layer float32 card-against-CPU step) and phase 34 (the
library sweep and the RNN stacks), each judged as in the full script.
About 2.5 minutes of command time on one H100, the build included.
"""
import gc
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

    if not torch.cuda.is_available():
        print("moe_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dense, tr, batch = cs.pretrain(A, 0, False)
    prof = cs.profile_training(tr, batch, steps=1)
    print("phase 25 (a) dense:", dense["seq_per_s"], dense["peak_bytes"],
          flush=True)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cs.moe_phase(A, 0, {False: dense}, prof)
    print("phase 33 s", time.perf_counter() - t1, flush=True)
    t1 = time.perf_counter()
    print(cs.library_sweep(), flush=True)
    print(cs.rnn_stacks(0), flush=True)
    print("phase 34 s", time.perf_counter() - t1, flush=True)
    print("total s", time.perf_counter() - t0, flush=True)
