"""The design steps of the float32 kernels on the tensor cores, measured on
one card: what the operand split, the TF32 rounding and the key-split
clusters of the float32 flash forward each cost, and what the tiled int8
path's k-splits do to its time and error.

    python tools/probe_tf32_forward.py

Each forward variant is `csrc/flash_fwd.cu` with one edit (`VARIANTS`,
anchored on the source's text; tests/test_torch_split_limit.py checks
that every anchor is still found exactly once), built with nvcc into
`paddle_tpu_torch/_build/probe/<name>/`, all at once, and its
`pt_flash_fwd` swapped into the loaded kernels; each is timed
(`chip_smoke.device_ms`, median of 25) at the four serving shapes of
`chip_smoke.py` phase 4 and a 64 x 1024 row, in turns with the
unedited kernel:

  cvt           TF32 rounding by `cvt.rna.tf32.f32` (the integer form's
                result, as a conversion)
  no_cluster    one block a (query tile, b*h): no key splits
  one_pass      only big.big (the split computed, two products dropped)
  no_split      three products on raw float32 bits (no split arithmetic)
  raw_one_pass  one product on raw bits

The diagnostic variants (the last three) compute another function; only
their times are printed. Then int8_matmul at phase 13's m 1024 shapes
(the tiled route), with the wrapper's k-splits and with none: device
ms and the largest |kernel - plain| over 4 seeds, of the plain version's
largest entry. Prints one JSON line per case with the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "paddle_tpu_torch", "csrc")

_PASS_SMALL_BIG = ("    for (int j = 0; j < NT; ++j) tf32::mma(s[j], as, bb[j][0], "
                   "bb[j][1]);\n")
_PASS_BIG_SMALL = ("    for (int j = 0; j < NT; ++j) tf32::mma(s[j], ab, bs[j][0], "
                   "bs[j][1]);\n")
_PV_SMALL_BIG = "        tf32::mma(st.o[c0 + c], ps, vb[c][0], vb[c][1]);\n"
_PV_BIG_SMALL = "        tf32::mma(st.o[c0 + c], pb, vs[c][0], vs[c][1]);\n"
_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_SPLIT = "  big = rna(x);\n  small = rna(x - __uint_as_float(big));"
_PLAN = "  return f32tc::plan(f32tc::sm_count(device), pairs, sk, short_q);"

_ONE_PASS = [(_PASS_SMALL_BIG, ""), (_PASS_BIG_SMALL, ""),
             (_PV_SMALL_BIG, "        {}\n"), (_PV_BIG_SMALL, "        {}\n")]
_NO_SPLIT = [(_SPLIT, "  big = __float_as_uint(x);\n  small = big;")]
#: {variant: {file: [(anchor, replacement)]}}
VARIANTS = {
    "cvt": {"tf32_mma.cuh": [(_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 '
                                    '%0, %1;\\n" : "=r"(r) : "f"(x));\n'
                                    '  return r;')]},
    "no_cluster": {"flash_fwd.cu": [(_PLAN, "  return 1;")]},
    "one_pass": {"flash_fwd.cu": _ONE_PASS},
    "no_split": {"tf32_mma.cuh": _NO_SPLIT},
    "raw_one_pass": {"flash_fwd.cu": _ONE_PASS, "tf32_mma.cuh": _NO_SPLIT},
}
#: the variants whose function is the kernel's (their output is checked)
EXACT = ("cvt", "no_cluster")
#: chip_smoke.fwd_case arguments after the generator
FWD_CASES = {
    "prefill b1 h8 s1024 causal+pad bias": (1, 8, 1024, 1024, 64, True,
                                            [700]),
    "cross b1 h8 1024x256": (1, 8, 1024, 256, 64, False, None),
    "decode cross b8 h8 1x256": (8, 8, 1, 256, 64, False, None),
    "encoder b16 h8 s256 pad bias": (16, 8, 256, 256, 64, False,
                                     [256 - 9 * i for i in range(16)]),
    "row b1 h1 64x1024": (1, 1, 64, 1024, 64, False, None),
}
#: the tiled route's shapes (the skinny route, m <= 32, plans its own
#: k-splits in the kernel: tools/probe_decode_merge.py)
INT8_SHAPES = ((1024, 512, 512), (1024, 2048, 512), (1024, 512, 2048),
               (1024, 512, 37000))


def variant_sources(name):
    """{file: text} of the csrc files a variant edits; raises if an
    anchor is not found exactly once."""
    out = {}
    for fname, edits in VARIANTS[name].items():
        with open(os.path.join(CSRC, fname)) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once in "
                                   f"{fname}: {old!r}")
            text = text.replace(old, new)
        out[fname] = text
    return out


def build_variants(nvcc, flags):
    """Build every variant's flash_fwd library at once; {name: path}."""
    root = os.path.join(HERE, "paddle_tpu_torch", "_build", "probe")
    procs = {}
    for name in VARIANTS:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        texts = variant_sources(name)
        for fname in os.listdir(CSRC):
            if fname.endswith(".cuh") or fname == "flash_fwd.cu":
                text = texts.get(fname)
                if text is None:
                    with open(os.path.join(CSRC, fname)) as f:
                        text = f.read()
                with open(os.path.join(d, fname), "w") as f:
                    f.write(text)
        so = os.path.join(d, "libflash_fwd.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", so, os.path.join(d, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        paths[name] = so
    return paths


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import quant as Q

    if not torch.cuda.is_available():
        print("probe_tf32_forward: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    lib = _build.kernels()
    fns = {"kernel": lib.flash_fwd}
    for name, path in build_variants(_build._nvcc(),
                                     _build.NVCC_FLAGS).items():
        fn = ctypes.CDLL(path).pt_flash_fwd
        fn.argtypes = _build._SIGNATURES["flash_fwd"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cuda").manual_seed(0)
    try:
        for cname, shape in FWD_CASES.items():
            q, k, v, bias, causal = cs.fwd_case(g, *shape)
            want = A.flash_attention_fwd_plain(q, k, v, bias, causal)
            row = {"case": cname, "card": card,
                   "cluster": A.fwd_cluster(q, k.shape[2])}
            for name in ["kernel", *VARIANTS, "kernel", *VARIANTS]:
                lib.flash_fwd = fns[name]
                row.setdefault(name + "_ms", []).append(cs.device_ms(
                    lambda: A._flash_fwd_cuda(q, k, v, bias, causal, None)))
                if name == "kernel" or name in EXACT:
                    out, lse = A._flash_fwd_cuda(q, k, v, bias, causal, None)
                    row[name + "_err"] = max(
                        (out - want[0]).abs().max().item(),
                        (lse - want[1]).abs().max().item())
            lib.flash_fwd = fns["kernel"]
            print(json.dumps(row), flush=True)
    finally:
        lib.flash_fwd = fns["kernel"]

    def raw(x, w, s, splits):
        m, d = x.shape
        n = w.shape[1]
        out = torch.empty(m, n, device="cuda")
        work = (torch.empty(splits, m, n, device="cuda") if splits > 1
                else None)
        _build.raise_on("int8_matmul", lib.int8_matmul(
            0, x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), m, d, n, splits, 0,
            torch.cuda.current_stream().cuda_stream))
        return out

    for m, d, n in INT8_SHAPES:
        splits = Q._int8_splits(m, d, n)
        row = {"case": f"int8 m{m} {d}x{n}", "card": card, "splits": splits,
               "err": 0.0, "err_no_split": 0.0}
        for seed in range(4):
            gg = torch.Generator(device="cuda").manual_seed(100 + seed)
            w, s = Q.quantize_int8_weight(
                torch.randn(d, n, generator=gg, device="cuda")
                * (6.0 / (d + n)) ** 0.5)
            x = torch.randn(m, d, generator=gg, device="cuda")
            want = Q.int8_matmul_reference(x, w, s)
            top = want.abs().max().item()
            for key, k in (("err", splits), ("err_no_split", 1)):
                row[key] = max(row[key], (raw(x, w, s, k) - want).abs()
                               .max().item() / top)
        row["ms"] = cs.device_ms(lambda: raw(x, w, s, splits))
        row["ms_no_split"] = cs.device_ms(lambda: raw(x, w, s, 1))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
