"""Time the port's kernels of two or more checkouts on one card, in
turns. Groups (all by default; `--groups a,b` picks some):

  train     the three attention kernels (flash_fwd, flash_bwd_dq,
            flash_bwd_dkv) at `chip_smoke.py` phase 12's shapes
            (ERNIE-base b8 h12 s1024 d64, bf16, a -1e4 pad bias,
            attention dropout 0.1; the padded path, no segment ids);
  fwd_fp32  the float32 flash_fwd at phase 4's four serving shapes (the
            b1 h8 s1024 causal prefill with a pad bias, the b1 h8
            1024x256 cross-attention, the decode step's b8 h8 1x256
            cross-attention, the b16 h8 s256 encoder with pad biases);
  conv      fused_conv_fwd and fused_conv_bwd at phase 20's eight
            ResNet-50 shapes (bf16, batch 128, norm and ReLU), with the
            backward's profiled split into its dx and dW halves
            (`chip_smoke.bwd_split_ms`);
  verify    paged_flash_verify at phase 8's shapes (the S8 h8 T4
            speculative step, the S8 h8 T256 tail prefill, the S1 h8 T64
            / T256 / T512 tail prefills of `PagedLayout.pattach`; fp32
            pages), alone (the split route's partials, or the tiled
            route's output) and with the combine; paged_flash_decode at
            phase 8's S8 h8 mp67 decode step (fp32 and int8 pages), alone
            (the kernel's entry: partials where a combine follows, else
            the output) and the whole call;
  lora      lora_gather at phase 16's nine shapes (rank 8);
  int8      int8_matmul at phase 16's float32 shapes (m 8, 32 and 1024
            on 512x512, 512x2048, 2048x512 and 512x37000).

Each ROOT is a directory holding a `paddle_tpu_torch/` package (a
checkout, or `git archive <commit> paddle_tpu_torch | tar -x -C ROOT`).
Every ROOT runs in a process of its own, so each builds and loads its
own kernels; list them in the order to run, e.g. parent, change,
change, parent, to see the spread beside the difference. Prints one
JSON line per run: the root and each kernel's median device ms over 25
runs (`chip_smoke.device_ms`), with the card's name and power limit.

    python tools/ab_training_kernels.py [--groups train,int8] PARENT . . PARENT
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


GROUPS = ("train", "fwd_fp32", "conv", "verify", "lora", "int8")


def time_root(root, groups=GROUPS):
    """The kernels' device ms with the package under `root`, for the
    named groups."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import fused_conv as FC

    if not os.path.abspath(A.__file__).startswith(root):
        raise RuntimeError(f"imported {A.__file__}, not the package under "
                           f"{root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    A._build.kernels()
    res = {"root": root, "card": cs.card_line()}
    g = torch.Generator(device="cuda").manual_seed(0)
    if "train" in groups:
        q, k, v, bias, do, drop = cs.train_case(g, torch.bfloat16)
        b, h, s, _ = q.shape
        out, lse = A.flash_attention_fwd(q, k, v, bias, False, None, drop)
        delta = A._delta(do, out)
        lse2 = lse.reshape(b * h, s)
        res.update({
            "flash_fwd": cs.device_ms(lambda: A._flash_fwd_cuda(
                q, k, v, bias, False, None, drop)),
            "flash_bwd_dq": cs.device_ms(lambda: A._flash_bwd_dq_cuda(
                q, k, v, bias, do, lse2, delta, False, None, drop)),
            "flash_bwd_dkv": cs.device_ms(lambda: A._flash_bwd_dkv_cuda(
                q, k, v, bias, do, lse2, delta, False, None, drop, False))})
        del q, k, v, bias, do, out, lse, delta, lse2
    if "fwd_fp32" in groups:
        res["flash_fwd_fp32"] = {}
        for name, shape in FWD_FP32_CASES.items():
            fq, fk, fv, fb, causal = cs.fwd_case(g, *shape)
            res["flash_fwd_fp32"][name] = cs.device_ms(
                lambda: A._flash_fwd_cuda(fq, fk, fv, fb, causal, None))
        del fq, fk, fv, fb
    if "conv" in groups:
        res["fused_conv_fwd"], res["fused_conv_bwd"] = [], []
        res["fused_conv_bwd_split"] = []
        g20 = torch.Generator(device="cuda").manual_seed(20)
        for ci, co, hw in cs.FC_SHAPES:
            x, sc, sh, w, dz, ds, dss = cs.fc_case(g20, cs.FC_BATCH, ci, co,
                                                   hw, torch.bfloat16)
            z = FC._fwd_cuda(x, sc, sh, w)[0]
            res["fused_conv_fwd"].append(cs.device_ms(
                lambda: FC._fwd_cuda(x, sc, sh, w)))
            res["fused_conv_bwd"].append(cs.device_ms(
                lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss)))
            res["fused_conv_bwd_split"].append(cs.bwd_split_ms(
                lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss)))
            del x, z, dz
    res.update(serving_ms(cs, A, groups))
    return res


#: phase 4's float32 forward serving shapes (chip_smoke.fwd_case
#: arguments after the generator)
FWD_FP32_CASES = {
    "prefill b1 h8 s1024 causal+pad bias": (1, 8, 1024, 1024, 64, True,
                                            [700]),
    "cross b1 h8 1024x256": (1, 8, 1024, 256, 64, False, None),
    "decode cross b8 h8 1x256": (8, 8, 1, 256, 64, False, None),
    "encoder b16 h8 s256 pad bias": (16, 8, 256, 256, 64, False,
                                     [256 - 9 * i for i in range(16)]),
}


#: phase 8's timed paged decode cases (chip_smoke.new_kernel_cases)
DECODE_CASES = ("decode S8 h8 mp67 pages fp32", "decode S8 h8 mp67 pages int8")
#: phase 8's timed paged verify cases (chip_smoke.new_kernel_cases)
VERIFY_CASES = ("spec step S8 h8 T4 mp67 pages fp32",
                "tail prefill S8 h8 T256 mp67 pages fp32",
                "tail prefill S1 h8 T64 W36 pages fp32",
                "tail prefill S1 h8 T256 W48 pages fp32",
                "tail prefill S1 h8 T512 W64 pages fp32")


def serving_ms(cs, A, groups):
    """paged_flash_verify and paged_flash_decode [alone, the whole call],
    lora_gather and int8_matmul ms at phases 8 and 16's shapes, for the
    named groups, with whichever entry the package has (the split
    partials before a kernel wrote its output itself)."""
    import torch

    from paddle_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    if "verify" in groups:
        new_cases = cs.new_kernel_cases(g)
        out["paged_flash_decode"] = {}
        for name in DECODE_CASES:
            args = new_cases["paged_flash_decode"][name]
            if hasattr(A, "_paged_decode_cuda"):
                fn = lambda: A._paged_decode_cuda(*args, None)  # noqa: E731
            else:
                fn = lambda: A._paged_partials_cuda(             # noqa: E731
                    "paged_flash_decode", *args, None)
            out["paged_flash_decode"][name] = [
                cs.device_ms(fn), cs.device_ms(lambda: A.paged_flash_decode(
                    *args))]
        cases = new_cases["paged_flash_verify"]
        del new_cases
        alone = getattr(A, "_paged_verify_cuda", None)
        out["paged_flash_verify"] = {}
        for name in VERIFY_CASES:
            args = cases[name]
            if alone is not None:
                fn = lambda: alone(*args, None)              # noqa: E731
            else:
                fn = lambda: A._paged_partials_cuda(         # noqa: E731
                    "paged_flash_verify", *args, None)
            out["paged_flash_verify"][name] = [
                cs.device_ms(fn), cs.device_ms(lambda: A.paged_flash_verify(
                    *args))]
        del cases
    if "lora" in groups:
        out["lora_gather"] = {}
        for name, (x, a, b, ids) in cs.lora_cases(g).items():
            dev = ids.to("cuda")
            out["lora_gather"][name] = cs.device_ms(
                lambda: Q._lora_gather_cuda(x, a, b, dev))
    if "int8" in groups:
        out["int8_matmul"] = {}
        for name, (x, q, scale) in cs.int8_cases(Q, g).items():
            if "bf16" not in name:
                out["int8_matmul"][name] = cs.device_ms(
                    lambda: Q._int8_matmul_cuda(x, q, scale))
    return out


def main(argv):
    groups = GROUPS
    if len(argv) > 2 and argv[1] == "--groups":
        groups = tuple(argv[2].split(","))
        unknown = set(groups) - set(GROUPS)
        if unknown:
            print(f"unknown groups {sorted(unknown)}; known {GROUPS}",
                  file=sys.stderr)
            return 2
        argv = argv[:1] + argv[3:]
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(time_root(os.path.abspath(argv[2]), groups)),
              flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--groups", ",".join(groups), "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
