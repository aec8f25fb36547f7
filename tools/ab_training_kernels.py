"""Time the port's training kernels of two or more checkouts on one card,
in turns: the three attention kernels (flash_fwd, flash_bwd_dq,
flash_bwd_dkv) at `chip_smoke.py` phase 12's shapes (ERNIE-base b8 h12
s1024 d64, bf16, a -1e4 pad bias, attention dropout 0.1; the padded
path, no segment ids), the float32 flash_fwd at phase 4's prefill shape
(b1 h8 s1024 d64, causal, pad bias), and fused_conv_fwd and
fused_conv_bwd at phase 20's eight ResNet-50 shapes (bf16, batch 128,
norm and ReLU), with the backward's profiled split into its dx and dW
halves (`chip_smoke.bwd_split_ms`); and two serving kernels:
paged_flash_verify at phase 8's shapes (the S8 h8 T4 speculative step,
the S8 h8 T256 tail prefill, the S1 h8 T64 / T256 / T512 tail prefills
of `PagedLayout.pattach`; fp32 pages), alone (the split route's
partials, or the tiled route's output) and with the combine, and
lora_gather at phase 16's nine shapes (rank 8).

Each ROOT is a directory holding a `paddle_tpu_torch/` package (a
checkout, or `git archive <commit> paddle_tpu_torch | tar -x -C ROOT`).
Every ROOT runs in a process of its own, so each builds and loads its
own kernels; list them in the order to run, e.g. parent, change,
change, parent, to see the spread beside the difference. Prints one
JSON line per run: the root and each kernel's median device ms over 25
runs (`chip_smoke.device_ms`), with the card's name and power limit.

    python tools/ab_training_kernels.py PARENT . . PARENT
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_root(root):
    """The kernels' device ms with the package under `root`."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import fused_conv as FC

    if not os.path.abspath(A.__file__).startswith(root):
        raise RuntimeError(f"imported {A.__file__}, not the package under "
                           f"{root}")
    A._build.kernels()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, bias, do, drop = cs.train_case(g, torch.bfloat16)
    b, h, s, _ = q.shape
    out, lse = A.flash_attention_fwd(q, k, v, bias, False, None, drop)
    delta = A._delta(do, out)
    lse2 = lse.reshape(b * h, s)
    res = {
        "root": root, "card": cs.card_line(),
        "flash_fwd": cs.device_ms(lambda: A._flash_fwd_cuda(
            q, k, v, bias, False, None, drop)),
        "flash_bwd_dq": cs.device_ms(lambda: A._flash_bwd_dq_cuda(
            q, k, v, bias, do, lse2, delta, False, None, drop)),
        "flash_bwd_dkv": cs.device_ms(lambda: A._flash_bwd_dkv_cuda(
            q, k, v, bias, do, lse2, delta, False, None, drop, False))}
    del q, k, v, bias, do, out, lse, delta, lse2
    fq, fk, fv, fb, causal = cs.fwd_case(g, 1, cs.HEADS, 1024, 1024, 64,
                                         True, [700])
    res["flash_fwd_fp32_prefill"] = cs.device_ms(lambda: A._flash_fwd_cuda(
        fq, fk, fv, fb, causal, None))
    res["fused_conv_fwd"], res["fused_conv_bwd"] = [], []
    res["fused_conv_bwd_split"] = []
    g20 = torch.Generator(device="cuda").manual_seed(20)
    for ci, co, hw in cs.FC_SHAPES:
        x, sc, sh, w, dz, ds, dss = cs.fc_case(g20, cs.FC_BATCH, ci, co, hw,
                                               torch.bfloat16)
        z = FC._fwd_cuda(x, sc, sh, w)[0]
        res["fused_conv_fwd"].append(cs.device_ms(
            lambda: FC._fwd_cuda(x, sc, sh, w)))
        res["fused_conv_bwd"].append(cs.device_ms(
            lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss)))
        res["fused_conv_bwd_split"].append(cs.bwd_split_ms(
            lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss)))
        del x, z, dz
    res.update(serving_ms(cs, A))
    return res


#: phase 8's timed paged verify cases (chip_smoke.new_kernel_cases)
VERIFY_CASES = ("spec step S8 h8 T4 mp67 pages fp32",
                "tail prefill S8 h8 T256 mp67 pages fp32",
                "tail prefill S1 h8 T64 W36 pages fp32",
                "tail prefill S1 h8 T256 W48 pages fp32",
                "tail prefill S1 h8 T512 W64 pages fp32")


def serving_ms(cs, A):
    """paged_flash_verify [alone, with the combine] and lora_gather ms at
    phases 8 and 16's shapes, with whichever entry the package has (the
    split partials before the tiled route existed)."""
    import torch

    from paddle_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(8)
    cases = cs.new_kernel_cases(g)["paged_flash_verify"]
    alone = getattr(A, "_paged_verify_cuda", None)
    out = {"paged_flash_verify": {}, "lora_gather": {}}
    for name in VERIFY_CASES:
        args = cases[name]
        if alone is not None:
            fn = lambda: alone(*args, None)                  # noqa: E731
        else:
            fn = lambda: A._paged_partials_cuda(             # noqa: E731
                "paged_flash_verify", *args, None)
        out["paged_flash_verify"][name] = [
            cs.device_ms(fn), cs.device_ms(lambda: A.paged_flash_verify(
                *args))]
    del cases
    for name, (x, a, b, ids) in cs.lora_cases(g).items():
        dev = ids.to("cuda")
        out["lora_gather"][name] = cs.device_ms(
            lambda: Q._lora_gather_cuda(x, a, b, dev))
    return out


def main(argv):
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(time_root(os.path.abspath(argv[2]))), flush=True)
        return 0
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
