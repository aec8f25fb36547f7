"""The design steps of the two kernels that merge their key splits in the
kernel, measured on one card: the int8 matmul's skinny route (m <= 32,
`csrc/int8_matmul.cu`) and the paged decode (`csrc/paged_decode.cu`).

    python tools/probe_decode_merge.py

Each variant is one of the two sources with anchored edits (`VARIANTS`;
tests/test_torch_routes.py checks that every anchor is still found
exactly once), built with nvcc into `paddle_tpu_torch/_build/probe_dm/
<name>/`, all at once, and its entry point swapped into the loaded
kernels; each is timed (`chip_smoke.device_ms`, median of 25) in turns
with the unedited kernel, at the serving shapes: int8_matmul at m 8 and
32 on 512x512, 512x2048, 2048x512 and 512x37000 (`chip_smoke.int8_cases`),
the paged decode at S8 h8 page 16 mp67 over fp32 and int8 pages
(`chip_smoke.new_kernel_cases`).

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
  pd_stages2     the decode's ring of 2 tiles, not 3
  pd_stages6     ... of 6 tiles
  pd_kt16        16-key tiles at d 64 (as at d 128), not 32
  pd_kt64        64-key tiles at d 64 (32 at d 128)
  pd_target2     the decode's plan aims at 2 blocks an SM, not 3
  pd_target4     ... at 4 blocks an SM
  pd_no_cluster  one block a slot-head row: no key splits
  pd_no_cluster_attr  ... and launched without the cluster attribute
  pd_no_compute  no arithmetic on the keys (copies and merge only: a
                 diagnostic)

A variant that keeps the kernel's function has its output checked
against the plain version (`EXACT`); the diagnostic ones print only
their times. A launch the card refuses (a ring past its shared memory)
is printed in place of the times. Each library also reports, through a function the probe
appends, how many clusters of the plan's size the card holds at once
(`cudaOccupancyMaxActiveClusters`), and an empty kernel launched as
they launch (blocks, cluster size, or no cluster attribute) gives the
floor of a launch. Prints one JSON line per case with the card's name
and power limit.
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
_PD_STAGES = ("constexpr int STAGES = 3;                   // the cp.async "
              "ring")
_PD_KT = "  static constexpr int KT = 2048 / D;"
_PD_PLAN = "  const int split = max(1, min(min(MAX_CLUSTER, mp), want));"
_PD_TARGET = ("constexpr int TARGET_PER_SM = 3;            // blocks an SM "
              "the plan aims for")
_I8_LOOP = ("#pragma unroll\n      for (int i = 0; i < MT; ++i) {\n" + _I8_MMA
            + "      }\n")
_I8_PIECE_MAJOR = "".join(
    f"#pragma unroll\n      for (int i = 0; i < MT; ++i) "
    f"mma(acc[i][j], a, {p}[i]);\n" for p in ("bl", "bm", "bh"))
_I8_WARPS = ("  *warps = strips * *c < sms && *kps % (2 * KC4) == 0 ? 8 : "
             "4;")
_PD_KEY = ("    if (j0 + gi >= end) continue;         // the same for the "
           "whole group")

# how many clusters of the kernel at the plan's size fit on the card
_I8_OCC = '''
extern "C" int probe_clusters(int device, int m, int d, int n) {
  int mt, c, kps, w;
  skinny::plan(sm_count(device), m, d, n, &mt, &c, &kps, &w);
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
_PD_OCC = '''
extern "C" int probe_clusters(int device, int S, int H, int mp, int kv) {
  int plan[2];
  pt_paged_decode_plan(device, S, H, mp, plan);
  auto run = [&](auto kernel, int bytes) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(plan[0], S * H);
    cfg.blockDim = dim3(pdec::THREADS);
    cfg.dynamicSmemBytes = bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan[0];
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int k = -1;
    cudaOccupancyMaxActiveClusters(&k, kernel, &cfg);
    return k;
  };
  constexpr int KT = pdec::Tile<64>::KT;
  const int tail = 24 * plan[1];
  return kv == 2
      ? run(pdec::paged_decode_kernel<float, signed char, 64>,
            pdec::STAGES * (2 * KT * 64 + KT * 4) + tail)
      : run(pdec::paged_decode_kernel<float, float, 64>,
            pdec::STAGES * (2 * KT * 256 + KT * 4) + tail);
}
'''

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

#: {variant: (source, [(anchor, replacement)])}
VARIANTS = {
    "i8_base": ("int8_matmul.cu", []),
    "i8_stages8": ("int8_matmul.cu", [(_I8_STAGES,
                                       "constexpr int STAGES = 8;")]),
    "i8_target8": ("int8_matmul.cu", [(_I8_TARGET,
                                       "constexpr int TARGET_PER_SM = 8;")]),
    "i8_warps4": ("int8_matmul.cu", [(_I8_WARPS, "  *warps = 4;")]),
    "i8_warps8": ("int8_matmul.cu", [(_I8_WARPS, "  *warps = *kps % (2 * "
                                      "KC4) == 0 ? 8 : 4;")]),
    "i8_piece_major": ("int8_matmul.cu", [(_I8_LOOP, _I8_PIECE_MAJOR)]),
    "i8_no_cluster_alone": ("int8_matmul.cu", [(_ATTRS, _NO_ATTR_ALONE)]),
    "i8_no_mma": ("int8_matmul.cu", [(_I8_MMA, "")]),
    "i8_no_merge": ("int8_matmul.cu", [(_I8_MERGE, "  return;\n  //")]),
    "pd_base": ("paged_decode.cu", []),
    "pd_stages2": ("paged_decode.cu", [(_PD_STAGES,
                                        "constexpr int STAGES = 2;")]),
    "pd_stages6": ("paged_decode.cu", [(_PD_STAGES,
                                        "constexpr int STAGES = 6;")]),
    "pd_kt16": ("paged_decode.cu", [(_PD_KT,
                                     "  static constexpr int KT = 16;")]),
    "pd_kt64": ("paged_decode.cu", [(_PD_KT,
                                     "  static constexpr int KT = 4096 / D;")]),
    "pd_target2": ("paged_decode.cu", [(_PD_TARGET,
                                        "constexpr int TARGET_PER_SM = 2;")]),
    "pd_target4": ("paged_decode.cu", [(_PD_TARGET,
                                        "constexpr int TARGET_PER_SM = 4;")]),
    "pd_no_cluster": ("paged_decode.cu", [(_PD_PLAN,
                                           "  const int split = 1;")]),
    "pd_no_cluster_attr": ("paged_decode.cu", [
        (_PD_PLAN, "  const int split = 1;"), (_ATTRS, _NO_ATTR_ALONE)]),
    "pd_no_compute": ("paged_decode.cu", [(_PD_KEY, "    continue;")]),
}
#: the variants whose function is the kernel's (their output is checked)
EXACT = ("i8_base", "i8_stages8", "i8_target8", "i8_warps4", "i8_warps8",
         "i8_piece_major", "i8_no_cluster_alone", "pd_base", "pd_stages2",
         "pd_stages6", "pd_kt16", "pd_kt64", "pd_target2", "pd_target4",
         "pd_no_cluster", "pd_no_cluster_attr")
#: the int8 shapes (m, d, n) and the paged decode cases timed
I8_CASES = [f"m{m} {d}x{n}" for m in (8, 32)
            for d, n in ((512, 512), (512, 2048), (2048, 512),
                         (512, 37000))]
PD_CASES = ("decode S8 h8 mp67 pages fp32", "decode S8 h8 mp67 pages int8")


def variant_source(name):
    """(file name, text) of a variant; raises if an anchor is not found
    exactly once."""
    fname, edits = VARIANTS[name]
    with open(os.path.join(CSRC, fname)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {fname}: "
                               f"{old!r}")
        text = text.replace(old, new)
    return fname, text + (_I8_OCC if fname == "int8_matmul.cu"
                          else _PD_OCC) + _FLOOR


def build_variants(nvcc, flags):
    """Build every variant's library at once; {name: path}."""
    root = os.path.join(HERE, "paddle_tpu_torch", "_build", "probe_dm")
    procs = {}
    for name in VARIANTS:
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        fname, text = variant_source(name)
        for other in os.listdir(CSRC):
            if other.endswith(".cuh"):
                with open(os.path.join(CSRC, other)) as f:
                    body = f.read()
                with open(os.path.join(d, other), "w") as f:
                    f.write(body)
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
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


def main():
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
    libs = {}
    for name, path in build_variants(_build._nvcc(),
                                     _build.NVCC_FLAGS).items():
        libs[name] = ctypes.CDLL(path)
    g = torch.Generator(device="cuda").manual_seed(0)
    i8 = cs.int8_cases(Q, g)
    pd = cs.new_kernel_cases(g)["paged_flash_decode"]
    base_i8, base_pd = lib.int8_matmul, lib.paged_decode
    try:
        for cname in I8_CASES:
            x, q, scale = i8[cname]
            m, d = x.shape
            n = q.shape[1]
            want = Q.int8_matmul_reference(x, q, scale)
            row = {"case": f"int8_matmul {cname}", "card": card,
                   "plan": Q.skinny_plan_on_card(m, d, n, "cuda")}
            names = [v for v in VARIANTS if v.startswith("i8_")]
            for name in names + names:
                fn = libs[name].pt_int8_matmul
                fn.argtypes = _build._SIGNATURES["int8_matmul"][1]
                fn.restype = ctypes.c_int
                lib.int8_matmul = fn
                try:
                    ms = cs.device_ms(lambda: Q._int8_matmul_cuda(x, q,
                                                                  scale))
                except RuntimeError as e:   # e.g. a ring past the card's
                    row[name + "_ms"] = str(e)  # shared memory
                    continue
                row.setdefault(name + "_ms", []).append(ms)
                if name in EXACT:
                    got = Q._int8_matmul_cuda(x, q, scale)
                    row[name + "_err"] = (got - want).abs().max().item() / \
                        want.abs().max().item()
                occ = libs[name].probe_clusters
                occ.argtypes = [ctypes.c_int] * 4
                row[name + "_clusters_at_once"] = occ(0, m, d, n)
            lib.int8_matmul = base_i8
            print(json.dumps(row), flush=True)
        for cname in PD_CASES:
            args = pd[cname]
            S, h = args[0].shape[:2]
            mp = args[5].shape[1]
            want = A.paged_flash_decode_plain(*args)
            row = {"case": f"paged_flash_decode {cname}", "card": card,
                   "plan": A.paged_decode_plan_on_card(S, h, mp, "cuda")}
            names = [v for v in VARIANTS if v.startswith("pd_")]
            for name in names + names:
                fn = libs[name].pt_paged_decode
                fn.argtypes = _build._SIGNATURES["paged_decode"][1]
                fn.restype = ctypes.c_int
                lib.paged_decode = fn
                try:
                    ms = cs.device_ms(lambda: A._paged_decode_cuda(*args,
                                                                   None))
                except RuntimeError as e:
                    row[name + "_ms"] = str(e)
                    continue
                row.setdefault(name + "_ms", []).append(ms)
                if name in EXACT:
                    got = A._paged_decode_cuda(*args, None)
                    row[name + "_err"] = (got - want).abs().max().item()
                occ = libs[name].probe_clusters
                occ.argtypes = [ctypes.c_int] * 5
                row[name + "_clusters_at_once"] = occ(
                    0, S, h, mp, 2 if args[1].dtype == torch.int8 else 0)
            lib.paged_decode = base_pd
            print(json.dumps(row), flush=True)
    finally:
        lib.int8_matmul, lib.paged_decode = base_i8, base_pd
    empty = libs["i8_base"].probe_empty
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


if __name__ == "__main__":
    sys.exit(main())
