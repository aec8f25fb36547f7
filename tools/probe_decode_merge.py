"""The design steps of the kernels that merge their key splits in the
kernel, measured on one card: the int8 matmul's skinny route (m <= 32,
`csrc/int8_matmul.cu`) and the four kernels on `csrc/attn_merge.cuh`
(the paged decode, `csrc/paged_decode.cu`; the dense decode,
`csrc/flash_decode.cu`; the paged verify's split route, T <= 8,
`csrc/paged_verify.cu`; the dense verify, `csrc/flash_verify.cu`).

    python tools/probe_decode_merge.py [--only fv,pv]
    python tools/probe_decode_merge.py --ab PARENT . . PARENT

Each variant is one of the sources, with anchored edits of it or of
`attn_merge.cuh` (`VARIANTS`; tests/test_torch_routes.py checks that
every anchor is still found exactly once), built with nvcc into
`paddle_tpu_torch/_build/probe_dm/<name>/`, all at once, and its entry
point swapped into the loaded kernels; each is timed
(`chip_smoke.device_ms`, median of 25) in turns with the unedited kernel,
at the serving shapes: int8_matmul at m 8 and 32 on 512x512, 512x2048,
2048x512 and 512x37000 (`chip_smoke.int8_cases`), the paged decode at S8
h8 page 16 mp67 over fp32 and int8 pages and the split route at the same
pages, T 4 (`chip_smoke.new_kernel_cases`), the dense decode at b8 h8
L1056 (`chip_smoke.dec_case`, phase 2's lengths), fp32 and bf16, and the
dense verify at b8 h8 T4 L1060 (`chip_smoke.new_kernel_cases`), fp32 and
bf16.

  i8_stages8     the skinny ring of 8 stages, not 4
  i8_target8     the skinny plan aims at 8 blocks an SM, not 2 (more
                 k-splits)
  i8_warps4      blocks of 4 warps and 64-row stages at every shape (the
                 plan takes 8 warps and 128-row stages for a grid short of
                 a block an SM)
  i8_warps8      8 warps wherever a split holds whole 128-row stages
  i8_piece_major the products ordered by piece (lo of every 8-row tile of
                 m, then mid, then hi), not by tile
  i8_no_cluster_alone  a plan of one rank launched without the cluster
                 attribute (m 512x37000)
  i8_no_mma      no product (the copies and the merge only: a diagnostic)
  i8_no_merge    ranks of a cluster write nothing (a diagnostic)
  pd_stages3     the ring of 3 tiles, not 2 (PR 12's)
  pd_stages6     ... of 6 tiles
  pd_kt16        16-key tiles at d 64 (as at d 128), not 32
  pd_kt64        64-key tiles at d 64 (32 at d 128)
  pd_target2     the merge plan aims at 2 blocks an SM, not 3
  pd_target4     ... at 4 blocks an SM
  pd_no_cluster  one block a slot-head row: no key splits
  pd_no_cluster_attr  ... and launched without the cluster attribute
  pd_no_compute  no arithmetic on the keys (copies and merge only: a
                 diagnostic)
  fd_* and pv_*  the dense decode and the split route: as built, a ring
                 of 3 or 6 tiles, no key splits, no arithmetic (the last
                 a diagnostic)
  fv_*           the dense verify: as built, a ring of 3 tiles, no key
                 splits, no arithmetic (a diagnostic), and fv_free_regs:
                 its T 4 instance without the 4-blocks-an-SM register
                 budget

A variant that keeps the kernel's function has its output checked
against the plain version (`EXACT`); the diagnostic ones print only
their times. A launch the card refuses (a ring past its shared memory)
is printed in place of the times. Each library also reports, through a
function the probe appends, how many clusters of the plan's size the card
holds at once (`cudaOccupancyMaxActiveClusters`), and an empty kernel
launched as they launch (blocks, cluster size, or no cluster attribute)
gives the floor of a launch. Prints one JSON line per case with the
card's name and power limit. `--only fv,pv` builds and times only the
variants of those prefixes (and the empty kernel).

`--ab ROOT ...` times the whole calls of the dense decode (b8 h8 L1056,
fp32 and bf16), the dense verify's T 4 step (b8 h8 L1060, fp32 and bf16)
and the paged verify's T 4 step (fp32 and int8 pages) of each ROOT's
package in a process of its own, in the order given (e.g.
parent, change, change, parent; a ROOT holds a `paddle_tpu_torch/`, e.g.
`git archive <commit> paddle_tpu_torch | tar -x -C ROOT`). Prints one
JSON line a ROOT.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "paddle_tpu_torch", "csrc")

_I8_STAGES = "constexpr int STAGES = 4;               // the cp.async ring"
_I8_TARGET = ("constexpr int TARGET_PER_SM = 2;        // blocks an SM the "
              "plan aims for")
_I8_MMA = ("        mma(acc[i][j], a, bl[i]);\n        mma(acc[i][j], a, "
           "bm[i]);\n        mma(acc[i][j], a, bh[i]);\n")
_I8_MERGE = "  if (C == 1) return;\n  // rank `rank` finishes a slice"
_PD_STAGES = ("constexpr int STAGES = 2;                   // the cp.async "
              "ring")
_PD_KT = "  static constexpr int KT = 2048 / D;"
_PD_PLAN = ("  const int split = legal_split(tuned, n)\n"
            "                        ? tuned\n"
            "                        : max(1, min(min(MAX_CLUSTER, n), "
            "want));")
_PD_TARGET = ("constexpr int TARGET_PER_SM = 3;            // blocks an SM "
              "the plan aims for")
_I8_LOOP = ("#pragma unroll\n      for (int i = 0; i < MT; ++i) {\n" + _I8_MMA
            + "      }\n")
_I8_PIECE_MAJOR = "".join(
    f"#pragma unroll\n      for (int i = 0; i < MT; ++i) "
    f"mma(acc[i][j], a, {p}[i]);\n" for p in ("bl", "bm", "bh"))
_I8_WARPS = ("  *warps = strips * *c < sms && *kps % (2 * KC4) == 0 ? 8 : "
             "4;")
_FV_MIN = "(D == 64 && R == 4) ? 4 : 1)"
_PD_KEY = ("    if (j0 + gi >= end) continue;         // the same for the "
           "whole group")

# how many clusters of the kernel at the plan's size fit on the card
_I8_OCC = '''
extern "C" int probe_clusters(int device, int m, int d, int n) {
  int mt, c, kps, w;
  skinny::plan(sm_count(device), m, d, n, &mt, &c, &kps, &w, 0);
  auto run = [&](auto kernel, int bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, (n + skinny::COLS - 1) / skinny::COLS);
    cfg.blockDim = dim3(32 * w);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int k = -1;
    cudaOccupancyMaxActiveClusters(&k, kernel, &cfg);
    return k;
  };
  if (w == 8)
    return mt == 1 ? run(skinny::int8_matmul_skinny_mma<1, 8>,
                         skinny::Layout<1, 8>::BYTES)
         : mt == 2 ? run(skinny::int8_matmul_skinny_mma<2, 8>,
                         skinny::Layout<2, 8>::BYTES)
                   : run(skinny::int8_matmul_skinny_mma<4, 8>,
                         skinny::Layout<4, 8>::BYTES);
  return mt == 1 ? run(skinny::int8_matmul_skinny_mma<1, 4>,
                       skinny::Layout<1, 4>::BYTES)
       : mt == 2 ? run(skinny::int8_matmul_skinny_mma<2, 4>,
                       skinny::Layout<2, 4>::BYTES)
                 : run(skinny::int8_matmul_skinny_mma<4, 4>,
                       skinny::Layout<4, 4>::BYTES);
}
'''
# the same for the kernels on attn_merge.cuh: `run` launches one of them
# at the plan's cluster size over rows x tiles blocks
_MERGE_RUN = '''
template <class K>
static int probe_run(K kernel, int bytes, int C, int rows, int tiles) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows, tiles);
  cfg.blockDim = dim3(amerge::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int k = -1;
  cudaOccupancyMaxActiveClusters(&k, kernel, &cfg);
  return k;
}
'''
# (rows b * H or S * H, n the keys (dense) or pages (paged), kv 2 = int8)
_PD_OCC = _MERGE_RUN + '''
extern "C" int probe_clusters(int device, int S, int H, int mp, int kv) {
  int plan[2];
  pt_paged_decode_plan(device, S, H, mp, 0, plan);
  amerge::Args a = {};
  a.psz = 16;
  a.split = plan[1] * 16;
  using amerge::PagedKeys;
  return kv == 2
      ? probe_run(pdec::paged_decode_kernel<float, signed char, 64>,
                  amerge::smem_bytes<signed char, 64, 1,
                                     PagedKeys<signed char>>(a),
                  plan[0], S * H, 1)
      : probe_run(pdec::paged_decode_kernel<float, float, 64>,
                  amerge::smem_bytes<float, 64, 1, PagedKeys<float>>(a),
                  plan[0], S * H, 1);
}
'''
_FD_OCC = _MERGE_RUN + '''
extern "C" int probe_clusters(int device, int B, int H, int L, int kv) {
  int plan[2];
  pt_flash_decode_plan(device, B, H, L, 0, plan);
  amerge::Args a = {};
  a.split = plan[1];
  using amerge::DenseKeys;
  return kv == 1
      ? probe_run(flash_decode_kernel<__nv_bfloat16, 64>,
                  amerge::smem_bytes<__nv_bfloat16, 64, 1,
                                     DenseKeys<__nv_bfloat16>>(a),
                  plan[0], B * H, 1)
      : probe_run(flash_decode_kernel<float, 64>,
                  amerge::smem_bytes<float, 64, 1, DenseKeys<float>>(a),
                  plan[0], B * H, 1);
}
'''
_PV_OCC = _MERGE_RUN + '''
extern "C" int probe_clusters(int device, int S, int H, int mp, int kv) {
  int C = 0, pps = 0;
  amerge::plan(amerge::sm_count(device), S * H, mp, &C, &pps, 0);
  amerge::Args a = {};
  a.psz = 16;
  a.split = pps * 16;
  using amerge::PagedKeys;
  return kv == 2
      ? probe_run(split::paged_split_kernel<float, signed char, 64, 4>,
                  amerge::smem_bytes<signed char, 64, 4,
                                     PagedKeys<signed char>>(a),
                  C, S * H, 1)
      : probe_run(split::paged_split_kernel<float, float, 64, 4>,
                  amerge::smem_bytes<float, 64, 4, PagedKeys<float>>(a),
                  C, S * H, 1);
}
'''
# the dense verify at T 4 (R 4 rows, one tile of rows), kv 1 = bf16
_FV_OCC = _MERGE_RUN + '''
extern "C" int probe_clusters(int device, int B, int H, int L, int kv) {
  int C = 0, split = 0;
  amerge::dense_plan(amerge::sm_count(device), B * H, L, &C, &split, 0);
  amerge::Args a = {};
  a.split = split;
  using amerge::DenseKeys;
  return kv == 1
      ? probe_run(flash_verify_kernel<__nv_bfloat16, 64, 4>,
                  amerge::smem_bytes<__nv_bfloat16, 64, 4,
                                     DenseKeys<__nv_bfloat16>>(a),
                  C, B * H, 1)
      : probe_run(flash_verify_kernel<float, 64, 4>,
                  amerge::smem_bytes<float, 64, 4, DenseKeys<float>>(a),
                  C, B * H, 1);
}
'''
#: the probe functions appended to each source
_OCC = {"int8_matmul.cu": _I8_OCC, "paged_decode.cu": _PD_OCC,
        "flash_decode.cu": _FD_OCC, "paged_verify.cu": _PV_OCC,
        "flash_verify.cu": _FV_OCC}

_ATTRS = "  cfg.numAttrs = 1;"
_NO_ATTR_ALONE = "  cfg.numAttrs = C > 1 ? 1 : 0;"

# an empty kernel, launched as the kernels launch (grid, cluster size):
# the floor of a launch
_FLOOR = '''
__global__ void probe_empty_kernel() {}
extern "C" int probe_empty(int blocks, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster > 0 ? cluster : 1, blocks);
  cfg.blockDim = dim3(128);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster > 0 ? cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, probe_empty_kernel);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
'''

_HDR = "attn_merge.cuh"
#: the attn_merge.cuh edits shared by the three call sites
_MERGE_EDITS = {
    "stages3": [(_HDR, _PD_STAGES, "constexpr int STAGES = 3;")],
    "stages6": [(_HDR, _PD_STAGES, "constexpr int STAGES = 6;")],
    "no_cluster": [(_HDR, _PD_PLAN, "  const int split = 1;")],
    "no_compute": [(_HDR, _PD_KEY, "    continue;")],
}
#: {variant: (source, [(file, anchor, replacement)])}
VARIANTS = {
    "i8_base": ("int8_matmul.cu", []),
    "i8_stages8": ("int8_matmul.cu", [("int8_matmul.cu", _I8_STAGES,
                                       "constexpr int STAGES = 8;")]),
    "i8_target8": ("int8_matmul.cu", [("int8_matmul.cu", _I8_TARGET,
                                       "constexpr int TARGET_PER_SM = 8;")]),
    "i8_warps4": ("int8_matmul.cu", [("int8_matmul.cu", _I8_WARPS,
                                      "  *warps = 4;")]),
    "i8_warps8": ("int8_matmul.cu", [("int8_matmul.cu", _I8_WARPS,
                                      "  *warps = *kps % (2 * KC4) == 0 ? 8 "
                                      ": 4;")]),
    "i8_piece_major": ("int8_matmul.cu", [("int8_matmul.cu", _I8_LOOP,
                                           _I8_PIECE_MAJOR)]),
    "i8_no_cluster_alone": ("int8_matmul.cu", [("int8_matmul.cu", _ATTRS,
                                                _NO_ATTR_ALONE)]),
    "i8_no_mma": ("int8_matmul.cu", [("int8_matmul.cu", _I8_MMA, "")]),
    "i8_no_merge": ("int8_matmul.cu", [("int8_matmul.cu", _I8_MERGE,
                                        "  return;\n  //")]),
    "pd_base": ("paged_decode.cu", []),
    "pd_stages3": ("paged_decode.cu", _MERGE_EDITS["stages3"]),
    "pd_stages6": ("paged_decode.cu", _MERGE_EDITS["stages6"]),
    "pd_kt16": ("paged_decode.cu", [(_HDR, _PD_KT,
                                     "  static constexpr int KT = 16;")]),
    "pd_kt64": ("paged_decode.cu", [(_HDR, _PD_KT,
                                     "  static constexpr int KT = 4096 / D;")]),
    "pd_target2": ("paged_decode.cu", [(_HDR, _PD_TARGET,
                                        "constexpr int TARGET_PER_SM = 2;")]),
    "pd_target4": ("paged_decode.cu", [(_HDR, _PD_TARGET,
                                        "constexpr int TARGET_PER_SM = 4;")]),
    "pd_no_cluster": ("paged_decode.cu", _MERGE_EDITS["no_cluster"]),
    "pd_no_cluster_attr": ("paged_decode.cu", _MERGE_EDITS["no_cluster"] + [
        (_HDR, _ATTRS, _NO_ATTR_ALONE)]),
    "pd_no_compute": ("paged_decode.cu", _MERGE_EDITS["no_compute"]),
    **{f"{pre}_{name}": (src, edits)
       for pre, src in (("fd", "flash_decode.cu"), ("pv", "paged_verify.cu"))
       for name, edits in (("base", []), *_MERGE_EDITS.items())},
    **{f"fv_{name}": ("flash_verify.cu", edits)
       for name, edits in (("base", []), *_MERGE_EDITS.items())
       if name != "stages6"},
    "fv_free_regs": ("flash_verify.cu", [("flash_verify.cu", _FV_MIN,
                                          "1)")]),
}
#: the variants whose function is the kernel's (their output is checked)
EXACT = tuple(v for v in VARIANTS if not v.endswith(
    ("_no_mma", "_no_merge", "_no_compute")))
#: the int8 shapes (m, d, n) and the merge kernels' cases timed
I8_CASES = [f"m{m} {d}x{n}" for m in (8, 32)
            for d, n in ((512, 512), (512, 2048), (2048, 512),
                         (512, 37000))]
PD_CASES = ("decode S8 h8 mp67 pages fp32", "decode S8 h8 mp67 pages int8")
PV_CASES = ("spec step S8 h8 T4 mp67 pages fp32",
            "spec step S8 h8 T4 mp67 pages int8")
FD_CASES = ("decode b8 h8 L1056 fp32", "decode b8 h8 L1056 bf16")
FV_CASES = ("spec step b8 h8 T4 L1060 fp32", "spec step b8 h8 T4 L1060 bf16")
#: phase 2's lengths and bias hole of the dense decode
FD_LENS, FD_HOLE = [60, 1056, 700, 300, 129, 128, 1000, 513], (20, 40)


def variant_source(name):
    """(source file name, {file: text}) of a variant: the source with the
    probe functions appended, and every file an edit touches; raises if
    an anchor is not found exactly once."""
    fname, edits = VARIANTS[name]
    texts = {}
    for f in {fname, *(e[0] for e in edits)}:
        with open(os.path.join(CSRC, f)) as fh:
            texts[f] = fh.read()
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {f}: "
                               f"{old!r}")
        texts[f] = texts[f].replace(old, new)
    texts[fname] += _OCC[fname] + _FLOOR
    return fname, texts


def build_variants(nvcc, flags, names=tuple(VARIANTS)):
    """Build the named variants' libraries at once; {name: path}."""
    root = os.path.join(HERE, "paddle_tpu_torch", "_build", "probe_dm")
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        fname, texts = variant_source(name)
        for other in os.listdir(CSRC):
            if other.endswith(".cuh"):
                with open(os.path.join(CSRC, other)) as f:
                    texts.setdefault(other, f.read())
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, f"lib{fname[:-3]}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", so, os.path.join(d, fname)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        paths[name] = so
    return paths


def fd_cases(cs, g):
    """The dense decode's cases: b8 h8 L1056 d64 at phase 2's lengths and
    bias hole, fp32 and the same values in bf16."""
    import torch

    q, k, v, length, bias = cs.dec_case(g, cs.SLOTS, cs.HEADS, cs.MAX_LEN, 64,
                                        FD_LENS, FD_HOLE)
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    return {FD_CASES[0]: (q, k, v, length, bias),
            FD_CASES[1]: (*bf, length, bias)}


def sweep(cs, lib, libs, card, prefix, stem, label, cases, call, plain,
          plan, occ, rel=False):
    """Time the `prefix` variants of library `stem` in turns at each case
    (the entry point swapped into the loaded kernels), check the exact
    ones against `plain` (the largest absolute error, or relative to the
    largest entry), and read each one's clusters at once; one JSON line a
    case."""
    import torch

    from paddle_tpu_torch.ops import _build

    entry, argtypes = _build._SIGNATURES[stem]
    base = getattr(lib, stem)
    names = [v for v in libs if v.startswith(prefix + "_")]
    if not names:
        return
    try:
        for cname, args in cases.items():
            want = plain(*args).float()
            row = {"case": f"{label} {cname}", "card": card,
                   "plan": plan(*args)}
            for name in names + names:
                fn = getattr(libs[name], entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(lib, stem, fn)
                try:
                    ms = cs.device_ms(lambda: call(*args))
                except RuntimeError as e:   # e.g. a ring past the card's
                    row[name + "_ms"] = str(e)  # shared memory
                    continue
                row.setdefault(name + "_ms", []).append(ms)
                if name in EXACT:
                    err = (call(*args).float() - want).abs().max().item()
                    row[name + "_err"] = err / want.abs().max().item() \
                        if rel else err
                o = occ(*args)
                fn = libs[name].probe_clusters
                fn.argtypes = [ctypes.c_int] * (1 + len(o))
                row[name + "_clusters_at_once"] = fn(0, *o)
            setattr(lib, stem, base)
            print(json.dumps(row), flush=True)
            del want
            torch.cuda.empty_cache()
    finally:
        setattr(lib, stem, base)


def main(only=None):
    """Build and time the variants (those whose prefix, e.g. "fv", is in
    `only`, or all)."""
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import quant as Q

    if not torch.cuda.is_available():
        print("probe_decode_merge: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    lib = _build.kernels()
    names = [v for v in VARIANTS
             if only is None or v.split("_")[0] in only]
    libs = {}
    for name, path in build_variants(_build._nvcc(), _build.NVCC_FLAGS,
                                     names).items():
        libs[name] = ctypes.CDLL(path)
    g = torch.Generator(device="cuda").manual_seed(0)
    i8 = cs.int8_cases(Q, g)
    new = cs.new_kernel_cases(g)

    def int8_kv(args):
        return 2 if args[1].dtype == torch.int8 else 0

    sweep(cs, lib, libs, card, "i8", "int8_matmul", "int8_matmul",
          {c: i8[c] for c in I8_CASES},
          lambda x, q, scale: Q._int8_matmul_cuda(x, q, scale),
          Q.int8_matmul_reference,
          lambda x, q, scale: Q.skinny_plan_on_card(*x.shape, q.shape[1],
                                                    "cuda"),
          lambda x, q, scale: (*x.shape, q.shape[1]), rel=True)
    sweep(cs, lib, libs, card, "pd", "paged_decode", "paged_flash_decode",
          {c: new["paged_flash_decode"][c] for c in PD_CASES},
          lambda *a: A._paged_decode_cuda(*a, None),
          A.paged_flash_decode_plain,
          lambda *a: A.paged_decode_plan_on_card(*a[0].shape[:2],
                                                 a[5].shape[1], "cuda"),
          lambda *a: (*a[0].shape[:2], a[5].shape[1], int8_kv(a)))
    sweep(cs, lib, libs, card, "pv", "paged_verify", "paged_flash_verify",
          {c: new["paged_flash_verify"][c] for c in PV_CASES},
          lambda *a: A._paged_verify_cuda(*a, None),
          A.paged_flash_verify_plain,
          lambda *a: A.paged_decode_plan_on_card(*a[0].shape[:2],
                                                 a[5].shape[1], "cuda"),
          lambda *a: (*a[0].shape[:2], a[5].shape[1], int8_kv(a)))
    sweep(cs, lib, libs, card, "fv", "flash_verify", "flash_verify",
          {c: new["flash_verify"][c] for c in FV_CASES},
          lambda *a: A._flash_verify_cuda(*a, None), A.flash_verify_plain,
          lambda q, k, *_: A.flash_decode_plan_on_card(*q.shape[:2],
                                                       k.shape[2], "cuda"),
          lambda q, k, *_: (*q.shape[:2], k.shape[2],
                            int(q.dtype == torch.bfloat16)))
    del new
    sweep(cs, lib, libs, card, "fd", "flash_decode", "flash_decode",
          fd_cases(cs, g), lambda *a: A._flash_decode_cuda(*a, None),
          A.flash_decode_plain,
          lambda q, k, *_: A.flash_decode_plan_on_card(*q.shape[:2],
                                                       k.shape[2], "cuda"),
          lambda q, k, *_: (*q.shape[:2], k.shape[2],
                            int(q.dtype == torch.bfloat16)))
    empty = libs[names[0]].probe_empty
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    row = {"case": "empty kernel (blocks, cluster size; 0 = no attribute)",
           "card": card}
    stream = torch.cuda.current_stream().cuda_stream
    for blocks, cluster in ((32, 0), (32, 1), (4, 8), (290, 0), (290, 1),
                            (64, 7)):
        row[f"{blocks}x{cluster}_ms"] = cs.device_ms(
            lambda: _build.raise_on("probe_empty",
                                    empty(blocks, cluster, stream)))
    print(json.dumps(row), flush=True)
    return 0


def ab_root(root):
    """The whole calls of the dense decode, the dense verify and the
    split route with the package under `root` ({case: median device
    ms})."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import attention as A

    if not os.path.abspath(A.__file__).startswith(root):
        raise RuntimeError(f"imported {A.__file__}, not the package under "
                           f"{root}")
    A._build.kernels()
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"root": root, "card": cs.card_line()}
    for cname, args in fd_cases(cs, g).items():
        res[f"flash_decode {cname}"] = cs.device_ms(
            lambda: A.flash_decode(*args))
    new = cs.new_kernel_cases(g)
    for cname in FV_CASES:
        res[f"flash_verify {cname}"] = cs.device_ms(
            lambda: A.flash_verify(*new["flash_verify"][cname]))
    for cname in PV_CASES:
        res[f"paged_flash_verify {cname}"] = cs.device_ms(
            lambda: A.paged_flash_verify(*new["paged_flash_verify"][cname]))
    return res


def ab(roots):
    """`ab_root` of each ROOT in a process of its own, in order."""
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-one", os.path.abspath(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-one":
        print(json.dumps(ab_root(sys.argv[2])), flush=True)
        sys.exit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        sys.exit(ab(sys.argv[2:]))
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        sys.exit(main(sys.argv[2].split(",")))
    sys.exit(main())
