#!/usr/bin/env python3
"""chip_smoke.py's phase 41 alone: the static graph. (a) A post-LN ERNIE
encoder at `ErnieConfig.base` width built from the port's fluid layers,
saved with `save_inference_model` and served by
`inference.create_predictor` through `fused_sdpa` on the flash forward
kernel (12 launches a run on the float32 tensor-core route, card against
CPU and against the unfused program within 1e-4, the valid rows bitwise,
latency, seq/s, host against device time, beside the eager
`ernie_base()`); (b) `bench.py`'s static LeNet training (200 steps,
`run_n`, card against CPU within 1e-5, images/s); (c) the wire format
(the card's and the CPU's load -> save byte-identical). Each part judged
as in the full script.

    python3 tools/static_phases.py [--seed 0] [--threads N]

`--threads N` sets torch's intra-op CPU threads first (the default is
torch's own: one a core). The one kernel phase 41 runs (flash_fwd) is
built at its first use.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if not torch.cuda.is_available():
        print("static_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from paddle_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda,
          f"intra-op threads {torch.get_num_threads()}", flush=True)
    out, launches = cs.static_phase(A, args.seed, card)
    out["launches"] = launches
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "static_phases.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"seconds": out["seconds"], "card": card}))
