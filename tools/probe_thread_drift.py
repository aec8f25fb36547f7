"""Probe whether the port's plain flash forward depends on torch's
intra-op thread count on this CPU.

Each probe is a fresh Python process that computes
`ops.attention.flash_attention_fwd_plain` on the inputs of
`tests/test_torch_training.py::test_flash_fwd_bwd_fp32_match_jax_kernels`
(b2 h2 s128 d32, float32, no bias, not causal) first on `--threads`
intra-op threads, then again on one, and reports by how much the two
differ: the logits, their row max, the exponentials and the output.
Probes start `--batch` at a time beside `--burners` busy processes,
since the drift shows (if at all) on the first calls of a fresh process
on a loaded CPU.

    python tools/probe_thread_drift.py --probes 24 --threads 2
    python tools/probe_thread_drift.py --probes 24 --threads 1

Prints one line per probe and a final count of probes that drifted.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(int(sys.argv[1]))
from paddle_tpu_torch.ops import attention as TA
q, k, v = (torch.tensor(np.random.RandomState(i).randn(2, 2, 128, 32)
                        .astype(np.float32)) for i in range(3))


def steps():
    logits = TA._logits(q, k, None, False, 32 ** -0.5)
    m = logits.amax(-1, keepdim=True).clamp_min(TA.NEG)
    p = torch.exp(logits - m)
    return {"logits": logits, "max": m, "exp": p,
            "out": TA.flash_attention_fwd_plain(q, k, v)[0]}


first = steps()
torch.set_num_threads(1)
again = steps()
diff = {n: float((first[n] - again[n]).abs().max()) for n in first}
rows = sorted({int(b) for b in (first["out"] - again["out"]).abs()
               .amax(dim=(1, 2, 3)).nonzero().flatten()})
print(json.dumps({"max_abs_diff": diff, "batch_rows": rows}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", type=int, default=24)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--burners", type=int, default=6)
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=ROOT)
    burners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range(args.burners)]
    drifted = 0
    try:
        done = 0
        while done < args.probes:
            n = min(args.batch, args.probes - done)
            procs = [subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(args.threads)], env=env,
                cwd=ROOT, stdout=subprocess.PIPE, text=True)
                for _ in range(n)]
            for p in procs:
                out, _ = p.communicate(timeout=300)
                res = json.loads(out.strip().splitlines()[-1])
                drifted += any(d > 0 for d in res["max_abs_diff"].values())
                print(f"probe {done}: {res}", flush=True)
                done += 1
    finally:
        for b in burners:
            b.kill()
            b.wait()
    print(f"{drifted} of {args.probes} probes on {args.threads} intra-op "
          f"threads differed from a one-thread recompute")
    return 0


if __name__ == "__main__":
    sys.exit(main())
