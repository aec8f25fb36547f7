"""Hold the float32 flash forward to its plain version over many calls, on
a card whose shared memory and allocator hold garbage and which other
processes share.

The cases are the five float32 forward shapes of `chip_smoke.py` phase 2
(prefill b1 h8 s1024 causal with a pad hole, cross-attention b1 h8
1024 x 256, the decode step's cross-attention b8 h8 1 x 256, the encoder
b16 h8 s256 with pad holes, 16 causal rows over 1000 keys), made from
seed 0 as the phase makes them, on the routes and cluster sizes the card
plans for them. Before each call the script writes a pattern over the
whole shared memory of every SM (NaN, -inf or hashed random bits, by a
small fill kernel built here with nvcc), or also frees NaN-filled blocks
into PyTorch's allocator; every fourth call runs on the card as it is.
Each call's output and lse must lie within `chip_smoke.ATOL_KERNEL` of
the plain version.

    python tools/stress_flash_fwd.py [--iters 2000] [--procs 1]
        [--load-seconds 0]

--procs P runs P such processes at once; --load-seconds S adds one more
process that keeps the card busy with float32 matmuls for S seconds, so
the kernels are time-sliced against other contexts. Prints the card's
name and power limit, and one JSON line per process: calls, misses and
the largest error per case.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FILL_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void fill_kernel(uint32_t v, int n, int random, uint32_t* sink) {
  extern __shared__ uint32_t s[];
  volatile uint32_t* vs = s;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t x = v;
    if (random) {
      x = (uint32_t)i * 2654435761u ^ (blockIdx.x * 40503u) ^ v;
      x ^= x >> 13; x *= 0x5bd1e995u; x ^= x >> 15;
    }
    vs[i] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0 && vs[n - 1] == 0x12345678u) sink[blockIdx.x] = 1;
}
// every block takes the whole 227 KiB, 4 blocks an SM of the card
extern "C" int fill_smem(uint32_t v, int random, int sms, void* sink,
                         void* stream) {
  const int bytes = 227 * 1024;
  cudaFuncSetAttribute(fill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fill_kernel<<<sms * 4, 1024, bytes, (cudaStream_t)stream>>>(
      v, bytes / 4, random, (uint32_t*)sink);
  return (int)cudaGetLastError();
}
"""


def fill_library():
    """The fill kernel's library, built once under the port's build
    directory."""
    from paddle_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_ROOT, "stress_fill")
    so = os.path.join(out, "fill.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        src = os.path.join(out, "fill.cu")
        with open(src, "w") as f:
            f.write(FILL_CU)
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O2", "-shared",
                        "-Xcompiler", "-fPIC", "-o", f"{so}.{os.getpid()}",
                        src], check=True)
        os.replace(f"{so}.{os.getpid()}", so)
    lib = ctypes.CDLL(so)
    lib.fill_smem.argtypes = [ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    return lib


def stress(iters):
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.kernels()
    lib = fill_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(sms * 4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "prefill b1 h8 s1024 causal+pad": S.fwd_case(
            g, 1, S.HEADS, 1024, 1024, 64, True, [700]),
        "cross b1 h8 1024x256": S.fwd_case(
            g, 1, S.HEADS, 1024, S.SRC_LEN, 64, False, None),
        "decode-step cross b8 h8 1x256": S.fwd_case(
            g, S.SLOTS, S.HEADS, 1, S.SRC_LEN, 64, False, None),
        "encoder b16 h8 s256 pad": S.fwd_case(
            g, S.REQUESTS, S.HEADS, S.SRC_LEN, S.SRC_LEN, 64, False,
            [S.SRC_LEN - 9 * i for i in range(S.REQUESTS)]),
        "q16 b2 h8 sk1000 causal pad": S.fwd_case(
            g, 2, S.HEADS, 16, 1000, 64, True, [1000, 700]),
    }
    plain = {n: A.flash_attention_fwd_plain(*c) for n, c in cases.items()}
    misses = {n: 0 for n in cases}
    worst = {n: 0.0 for n in cases}
    t0 = time.perf_counter()
    for it in range(iters):
        for n, args in cases.items():
            mode = it % 4
            if mode == 0:
                lib.fill_smem(0x7fc00000, 0, sms, sink.data_ptr(), stream)
            elif mode == 1:
                lib.fill_smem(it * 7919, 1, sms, sink.data_ptr(), stream)
            elif mode == 2:
                junk = [torch.full((1 << 19,), float("nan"), device="cuda")
                        for _ in range(8)]
                del junk
                lib.fill_smem(0xff800000, 0, sms, sink.data_ptr(), stream)
            out, lse = A.flash_attention_fwd(*args)
            pout, plse = plain[n]
            e = max((out - pout).abs().max().item(),
                    (lse - plse).abs().max().item())
            if not e <= S.ATOL_KERNEL:
                misses[n] += 1
                print(f"miss at call {it} ({n}): "
                      + S.fwd_miss_detail(A, args, out, lse, pout, plse),
                      file=sys.stderr, flush=True)
            worst[n] = e if e != e else max(worst[n], e)
    return {"calls_per_case": iters, "misses": misses, "max_abs_err": worst,
            "cluster": {n: A.fwd_cluster(c[0], c[1].shape[2])
                        for n, c in cases.items()},
            "seconds": time.perf_counter() - t0}


def load(seconds):
    import torch

    a = torch.randn(8192, 8192, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = torch.tanh(a @ a * 1e-4)
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--load-seconds", type=float, default=0.0)
    ap.add_argument("--worker", choices=("build", "stress", "load"))
    args = ap.parse_args()
    if args.worker == "build":
        sys.path.insert(0, ROOT)
        from paddle_tpu_torch.ops import _build

        _build.kernels()
        fill_library()
        return 0
    if args.worker == "stress":
        print(json.dumps(stress(args.iters)), flush=True)
        return 0
    if args.worker == "load":
        load(args.load_seconds)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    me = [sys.executable, os.path.abspath(__file__)]
    # one process builds the kernels and the fill kernel first
    subprocess.run(me + ["--worker", "build"], check=True)
    procs = [subprocess.Popen(me + ["--worker", "stress", "--iters",
                                    str(args.iters)])
             for _ in range(args.procs)]
    if args.load_seconds > 0:
        procs.append(subprocess.Popen(me + ["--worker", "load",
                                            "--load-seconds",
                                            str(args.load_seconds)]))
    rcs = [p.wait() for p in procs]
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
