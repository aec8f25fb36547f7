#!/usr/bin/env python3
"""chip_smoke.py's phase 40 alone: the eager remainder. (a) CTR-DNN at
`bench.py:678`'s width through `nn.Embedding(sparse=True)` and lazy Adam
(the sparse gradient's rows, the loss, untouched rows, one step's peak
memory growth, two runs bitwise, 3 steps against the CPU, examples/s
beside the dense yardstick); (b) the sparse rules against the dense
ones; (c) `Communicator.push` of the gradient's rows to a `PsServer`;
(d) a `paddle.grad` double-grad penalty with a `PyLayer`; (e)
`ernie_base()` forward; (f) eager QAT; (g) serving callbacks, the eager
fallback and `paddle.seed`. Each part judged as in the full script.

    python3 tools/eager_phases.py [--seed 0] [--only a,b,...] [--threads N]

`--threads N` sets torch's intra-op CPU threads first (the default is
torch's own: one a core).

The one kernel these parts run (flash_fwd, in (e) and (g)) is built at
its first use.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARTS = {"a": "ctr_phase", "b": "sparse_rules_phase", "c": "ps_push_phase",
         "d": "grad_api_phase", "e": "ernie_base_phase", "f": "qat_phase",
         "g": "callbacks_phase"}

if __name__ == "__main__":
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(PARTS))
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if not torch.cuda.is_available():
        print("eager_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from paddle_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, torch.__version__, torch.version.cuda,
          f"intra-op threads {torch.get_num_threads()}", flush=True)
    out = {"card": card}
    t0 = time.perf_counter()
    for part in args.only.split(","):
        name = PARTS[part]
        fn = getattr(cs, name)
        t1 = time.perf_counter()
        if name == "ctr_phase":
            out[part] = fn(args.seed, card)
        elif name in ("ernie_base_phase", "callbacks_phase"):
            out[part] = fn(A, args.seed)
        else:
            out[part] = fn(args.seed)
        print(f"  ({part}) took {time.perf_counter() - t1:.1f} s",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "eager_phases.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"seconds": out["seconds"], "card": card}))
