"""The evidence behind the bf16 limits of the flash kernels
(`paddle_tpu_torch.testing.judge_bf16_grad`), on one card: the backward's
gradients and the forward's output.

    python tools/check_bwd_limit.py [--against ROOT] [--mutate]

For three bf16 cases (`chip_smoke.train_case`, phase 9's ERNIE-base
shape with its pad bias and dropout, from two seeds; phase 21's packed
12-row case) it runs `flash_attention_bwd` and `flash_attention_fwd` on
the card and their plain versions (for the forward's output
`testing.flash_fwd_tiled`, which rounds p where the kernel does), and
prints, for dq, dk, dv and out, the judge's numbers (the largest error,
in bf16 ulps of the largest plain entry too, the share of differing
elements, the relative L2 error) and the readings of the alternative
per-element limits "one ulp of the element, or 1e-4 / 1e-3 of the
largest entry, whichever is larger" (above 1 breaks them). Exits
nonzero if the judge refuses an output.

--against ROOT: also run the kernels of the package under ROOT (a
checkout, or `git archive <commit> paddle_tpu_torch | tar -x -C ROOT`) on
the same inputs, print the same numbers for them and whether each output
is bitwise equal.

--mutate: copy the package into a temporary directory, add the bf16
rounding residue of ds (to the dq and dk products), of pd (to the dv
product) and of the forward's p (to its P.V product) as a second
tensor-core product, so none of them is rounded to bf16 any more
(`MUTATIONS`, `FWD_MUTATIONS`), and hold that copy to the limit on the
first case: each of dq, dk, dv and out must be refused. Exits nonzero if
one is not.

Prints the card's name and power limit first. Each package runs in a
process of its own (each builds its kernels).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the floors of the alternative per-element limits printed beside the
#: judge's numbers ("one ulp of the element, or this much of the largest
#: entry, whichever is larger")
ALTERNATIVE_FLOORS = (1e-4, 1e-3)
#: the outputs judged: the backward's gradients and the forward's output
OUTPUTS = ("dq", "dk", "dv", "out")



def _residue(src, dst):
    """C lines: dst[i] = the rounding residue src[i] - round(src[i]) in the
    kernel's operand type T (bf16 or f16) of a 32-value accumulator
    fragment."""
    return (f"\n    float {dst}[32];\n#pragma unroll\n"
            f"    for (int i = 0; i < 32; ++i)\n"
            f"      {dst}[i] = {src}[i] - "
            f"Half16<T>::unpack(Half16<T>::pack({src}[i], 0.f)).x;\n")


# (anchor, replacement) edits that feed the rounding residue of ds (dq and
# dk) and of pd (dv) to the same products as a second tensor-core
# product, so none of them is rounded to the operand type any more
MUTATIONS = {
    "flash_bwd_dq.cu": [
        ("    uint32_t a[4][4];\n#pragma unroll\n"
         "    for (int kk = 0; kk < 4; ++kk) to_a<T>(p, kk, a[kk]);",
         _residue("p", "lo_") +
         "    uint32_t a[4][4], alo[4][4];\n#pragma unroll\n"
         "    for (int kk = 0; kk < 4; ++kk) {\n"
         "      to_a<T>(p, kk, a[kk]);\n      to_a<T>(lo_, kk, alo[kk]);\n"
         "    }"),
        ("        wgmma_rs<T>(acc[n], a[kk], desc(kdq, mn_major_step(kk, n)),\n"
         "                    t > 0 || kk > 0);\n",
         "      {\n"
         "        wgmma_rs<T>(acc[n], a[kk], desc(kdq, mn_major_step(kk, n)),\n"
         "                    t > 0 || kk > 0);\n"
         "        wgmma_rs<T>(acc[n], alo[kk], desc(kdq, mn_major_step(kk, n)),"
         " 1);\n      }\n")],
    "flash_bwd_dkv.cu": [
        ("    uint32_t apd[4][4], adl[4][4];",
         _residue("s", "lo_") + _residue("dp", "lo2_") +
         "    uint32_t apd[4][4], adl[4][4], alo[4][4], alo2[4][4];"),
        ("      to_a<T>(s, kk, apd[kk]);",
         "      to_a<T>(s, kk, apd[kk]);\n      to_a<T>(lo_, kk, alo[kk]);\n"
         "      to_a<T>(lo2_, kk, alo2[kk]);"),
        ("        wgmma_rs<T>(dv_acc[n], apd[kk], desc(gb, mn_major_step(kk, n)),"
         "\n                    1);",
         "        wgmma_rs<T>(dv_acc[n], apd[kk], desc(gb, mn_major_step(kk, n)),"
         "\n                    1);\n        wgmma_rs<T>(dv_acc[n], alo[kk], "
         "desc(gb, mn_major_step(kk, n)), 1);"),
        ("        wgmma_rs<T>(dk_acc[n], adl[kk], desc(qb, mn_major_step(kk, n)),"
         "\n                    1);",
         "        wgmma_rs<T>(dk_acc[n], adl[kk], desc(qb, mn_major_step(kk, n)),"
         "\n                    1);\n        wgmma_rs<T>(dk_acc[n], alo2[kk], "
         "desc(qb, mn_major_step(kk, n)), 1);")],
}


# the same for the forward: the rounding residue of p as a second P.V
# product, so p is not rounded to the operand type any more
FWD_MUTATIONS = {
    "flash_fwd.cu": [
        ("    uint32_t a[4][4];\n#pragma unroll\n"
         "    for (int kk = 0; kk < 4; ++kk) to_a<T>(s, kk, a[kk]);",
         _residue("s", "lo_") +
         "    uint32_t a[4][4], alo[4][4];\n#pragma unroll\n"
         "    for (int kk = 0; kk < 4; ++kk) {\n"
         "      to_a<T>(s, kk, a[kk]);\n      to_a<T>(lo_, kk, alo[kk]);\n"
         "    }"),
        ("        wgmma_rs<T>(acc[n], a[kk],\n"
         "                    desc(vs + buf * TB, mn_major_step(kk, n)),\n"
         "                    t > 0 || kk > 0);\n",
         "      {\n"
         "        wgmma_rs<T>(acc[n], a[kk],\n"
         "                    desc(vs + buf * TB, mn_major_step(kk, n)),\n"
         "                    t > 0 || kk > 0);\n"
         "        wgmma_rs<T>(acc[n], alo[kk], desc(vs + buf * TB, "
         "mn_major_step(kk, n)), 1);\n      }\n")],
}


def mutated_sources(csrc, mutations=MUTATIONS):
    """{file name: the mutated text} of the `mutations` files under the
    directory `csrc`; raises if an anchor is not found exactly once."""
    out = {}
    for name, edits in mutations.items():
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the mutation's anchor is gone; "
                                   f"update MUTATIONS:\n{old}")
            src = src.replace(old, new)
        out[name] = src
    return out


def _cases(cs, torch):
    """{name: ((q, k, v, bias, dO, dropout), segment-id keywords)}."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    out["ernie b8 h12 s1024 bias dropout 0.1, seed 0"] = (
        cs.train_case(g, torch.bfloat16), {})
    g = torch.Generator(device="cuda").manual_seed(1)
    out["ernie b8 h12 s1024 bias dropout 0.1, seed 1"] = (
        cs.train_case(g, torch.bfloat16), {})
    _, _, _, pk = cs.packed_batch(0)
    segs = torch.as_tensor(pk.segment_ids, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    out["packed 12 rows h12 s1024"] = (
        cs.seg_case(g, segs.shape[0], cs.E_HEADS, cs.E_SEQ, cs.E_SEQ,
                    cs.E_HIDDEN // cs.E_HEADS, torch.bfloat16, False,
                    cs.E_DROPOUT), dict(segment_ids=segs))
    return out


def _run(root, path, plain, first_only=False):
    """Child process: the backward of the package under `root` on every
    case (and the plain version's, with `plain`), saved to `path`."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import attention as A

    if not os.path.abspath(A.__file__).startswith(root):
        raise RuntimeError(f"imported {A.__file__}, not the package under "
                           f"{root}")
    res = {}
    for name, (case, ids) in _cases(cs, torch).items():
        q, k, v, bias, do, drop = case
        out, lse = A.flash_attention_fwd_plain(q, k, v, bias, False, None,
                                               drop, **ids)
        res[name] = [t.cpu() for t in A.flash_attention_bwd(
            q, k, v, bias, out, lse, do, False, None, drop, **ids)[:3]] + [
            A.flash_attention_fwd(q, k, v, bias, False, None, drop,
                                  **ids)[0].cpu()]
        if plain:
            from paddle_tpu_torch.testing import flash_fwd_tiled

            res[name + " plain"] = [t.cpu() for t in
                                    A.flash_attention_bwd_plain(
                                        q, k, v, bias, out, lse, do, False,
                                        None, drop, **ids)[:3]] + [
                flash_fwd_tiled(q, k, v, bias, False, None, drop,
                                **ids).cpu()]
        if first_only:
            break
    torch.save(res, path)


def _numbers(got, want):
    """`judge_bf16_grad`'s numbers and misses, with the per-element
    readings of the alternative limits "one ulp of the element, or 1e-4 /
    1e-3 of the largest entry, whichever is larger" beside them."""
    from paddle_tpu_torch.testing import judge_bf16_grad, per_element_error

    nums, misses = judge_bf16_grad(got, want)
    for floor in ALTERNATIVE_FLOORS:
        nums[f"of_ulp_or_{floor:g}"] = per_element_error(got, want, floor)
    return nums, misses


def _child(root, tmp, tag, plain, first_only=False):
    path = os.path.join(tmp, f"{tag}.pt")
    args = [sys.executable, os.path.abspath(__file__), "--child", root,
            path] + (["--plain"] if plain else []) + \
        (["--first"] if first_only else [])
    subprocess.run(args, check=True)
    return path


def _mutant(tmp):
    root = os.path.join(tmp, "mutant")
    shutil.copytree(os.path.join(HERE, "paddle_tpu_torch"),
                    os.path.join(root, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(root, "paddle_tpu_torch", "csrc")
    for name, src in {**mutated_sources(csrc),
                      **mutated_sources(csrc, FWD_MUTATIONS)}.items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(src)
    return root


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against")
    ap.add_argument("--mutate", action="store_true")
    ap.add_argument("--child", nargs=2)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--first", action="store_true")
    args = ap.parse_args(argv[1:])
    if args.child:
        _run(os.path.abspath(args.child[0]), args.child[1], args.plain,
             args.first)
        return 0
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("check_bwd_limit: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    tmp = tempfile.mkdtemp()
    try:
        failed = False
        res = torch.load(_child(HERE, tmp, "this", True))
        other = None if args.against is None else torch.load(
            _child(os.path.abspath(args.against), tmp, "other", False))
        for name in [n for n in res if not n.endswith(" plain")]:
            print(name)
            for i, out in enumerate(OUTPUTS):
                want = res[name + " plain"][i]
                for tag, got in [("", res[name][i])] + (
                        [] if other is None else
                        [(f" ({args.against})", other[name][i])]):
                    nums, misses = _numbers(got, want)
                    line = "  ".join(f"{k} {v:.3g}" for k, v in nums.items())
                    if misses:
                        line += f"  REFUSED: {'; '.join(misses)}"
                        failed = failed or not tag
                    print(f"  {out}{tag}: {line}", flush=True)
                if other is not None:
                    print(f"  {out} bitwise equal: "
                          f"{torch.equal(res[name][i], other[name][i])}")
        if args.mutate:
            mut = torch.load(_child(_mutant(tmp), tmp, "mutant", False,
                                    True))
            name = next(iter(mut))
            print(f"mutant (ds, pd and the forward's p left unrounded), "
                  f"{name}")
            for i, out in enumerate(OUTPUTS):
                nums, misses = _numbers(mut[name][i],
                                        res[name + " plain"][i])
                print(f"  {out}: " + "  ".join(
                    f"{k} {v:.3g}" for k, v in nums.items()) +
                    (f"  refused: {'; '.join(misses)}" if misses else ""))
                if not misses:
                    print(f"the mutant's {out} passed the limit",
                          file=sys.stderr)
                    failed = True
        if failed:
            return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
