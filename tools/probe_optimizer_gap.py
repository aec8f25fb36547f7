"""The card's eager optimizers against the CPU's: for every rule of
`tests/test_torch_optimizer_cuda.py`, with and without the global-norm
clip, 4 multi-tensor steps on the card and on the CPU from the same
parameters and gradients. Prints, a rule and clip a line, the largest
absolute difference of the parameters, the relative L2 of that
difference against the CPU's update, and whether the two are equal bit
for bit; the test's limits are argued from these numbers.

    python3 tools/probe_optimizer_gap.py

Needs an NVIDIA card.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_optimizer_cuda as T  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    worst = {}
    for rule in sorted(T.RULES):
        for clip in (False, True):
            pa, _ = T._run(rule, cuda, True, clip)
            pc, _ = T._run(rule, cpu, True, clip)
            start = [p for _, p in T._params(cpu)]
            big = num = den = 0.0
            equal = True
            for a, c, s in zip(pa, pc, start):
                a = a.detach().cpu()
                equal &= torch.equal(a, c.detach())
                a, c, s = a.double(), c.detach().double(), s.detach().double()
                big = max(big, float((a - c).abs().max()))
                num += float((a - c).pow(2).sum())
                den += float((c - s).pow(2).sum())
            row = {"rule": rule, "clip": clip, "max_abs": big,
                   "rel_l2_of_update": (num / den) ** 0.5, "bitwise": equal}
            worst["max_abs"] = max(worst.get("max_abs", 0.0), big)
            worst["rel_l2_of_update"] = max(worst.get("rel_l2_of_update",
                                                      0.0),
                                            row["rel_l2_of_update"])
            print(json.dumps(row), flush=True)
    print(json.dumps({"worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
