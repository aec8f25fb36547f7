#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits nonzero before the result lines:
 1. Device: the card's name and power limit (nvidia-smi) and the build
    time of the hand-written CUDA kernels (paddle_tpu_torch/csrc).
 2. Each kernel against its plain PyTorch version on the card, at the
    shapes the serving path gives it (fp32, atol 2e-5).
 3. Serve Transformer-base (d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
    vocab 37000; random weights from --seed) through ServingServer: 16
    requests over 8 slots, source memories of 256 tokens encoded on the
    card by the port's TransformerEncoder, prompts of 300-1000 tokens,
    32 new tokens each. The kernels' launch counters are zeroed just
    before and read just after; both must have grown. Two requests are
    re-run on the CPU through the plain versions: prefill logits agree
    within atol 1e-3, and greedy tokens agree up to the first position
    where the CPU's top-2 logit gap is below 1e-3.
 4. Timing at the phase-3 shapes (CUDA events, median of 25 runs, each
    queued behind a device sleep so host overhead is not timed): the
    kernel, its bound on the card (published H100 SXM peaks: 3.35 TB/s,
    67 TFLOP/s fp32), the plain version, and
    torch.nn.functional.scaled_dot_product_attention as a yardstick only
    (the port never calls it). Decode is timed twice: the kernel alone
    ("ms") and with its torch combine ("with_combine_ms", the scope of
    the plain and library times). Then a second pass of 8 requests under
    torch.profiler: device time by kernel and the device's busy share.
 5. Output: a {"kernels": [...]} line, then the card's name and power
    limit, then {"ok": true, "device": {...}} as the last line.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOPS_PER_S = 67e12      # H100 SXM, CUDA cores, published
ATOL_KERNEL = 2e-5
ATOL_LOGITS = 1e-3
GAP = 1e-3
D_MODEL, HEADS, LAYERS, FFN, VOCAB = 512, 8, 6, 2048, 37000
SLOTS, REQUESTS, SRC_LEN, NEW_TOKENS, MAX_LEN = 8, 16, 256, 32, 1056


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def device_ms(fn, runs=25, sleep_cycles=4_000_000):
    """Median device time of fn() in ms: each run is queued behind a
    device sleep, so the events bracket the kernels alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ------------------------------------------------------------- the cases

def fwd_case(g, b, h, sq, sk, d, causal, lens):
    """Inputs shaped as the layers produce them: [b, s, h*d] projections
    viewed as [b, h, s, d] (strided), bias [b, sk] over the pad hole."""
    def proj(s):
        return torch.randn(b, s, h * d, generator=g, device="cuda") \
            .view(b, s, h, d).transpose(1, 2)
    q, k, v = proj(sq), proj(sk), proj(sk)
    bias = None
    if lens is not None:
        kpos = torch.arange(sk, device="cuda")
        bias = torch.where(kpos[None] >= torch.tensor(lens, device="cuda")
                           [:, None], -1e30, 0.0).float().contiguous()
    return q, k, v, bias, causal


def fwd_numbers(A, args):
    q, k, v, bias, causal = args
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = (sum(max(0, min(sk, i + 1 + sk - sq)) for i in range(sq))
             if causal else sq * sk)
    flops = 4.0 * b * h * d * pairs
    nbytes = 4.0 * (b * h * (sq + 2 * sk) * d + b * h * sq * d
                    + b * h * sq + (b * sk if bias is not None else 0))
    mask = torch.zeros(b, 1, sq, sk, device="cuda")
    if bias is not None:
        mask = mask + bias[:, None, None, :]
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device="cuda").tril(sk - sq)
        mask = mask.masked_fill(~keep, -1e30)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: A._flash_fwd_cuda(q, k, v, bias, causal, None))
    plain = device_ms(lambda: A.flash_attention_fwd_plain(q, k, v, bias,
                                                          causal))
    lib = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def dec_case(g, b, h, L, d, lens, hole):
    q = torch.randn(b, h, 1, d, generator=g, device="cuda")
    k = torch.randn(b, h, L, d, generator=g, device="cuda")
    v = torch.randn(b, h, L, d, generator=g, device="cuda")
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bias = torch.zeros(b, L, device="cuda")
    bias[:, hole[0]:hole[1]] = -1e30
    return q, k, v, length, bias


def dec_numbers(A, args):
    q, k, v, length, bias = args
    b, h, _, d = q.shape
    L = k.shape[2]
    n = int(length.sum())                      # keys this data needs
    ns = -(-L // A.DECODE_SPLIT)
    nbytes = 4.0 * (2 * n * h * d + b * h * d + n + b
                    + b * h * ns * (d + 2))
    flops = 4.0 * n * h * d
    kpos = torch.arange(L, device="cuda")
    mask = torch.where(kpos[None] < length[:, None].long(), 0.0, -1e30) \
        + bias
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: A._decode_partials_cuda(
        q, k, v, length, bias, None, A.DECODE_SPLIT))
    # the whole attention (kernel + torch combine): the scope that the
    # plain version and the library call time
    whole = device_ms(lambda: A.flash_decode(q, k, v, length, bias))
    plain = device_ms(lambda: A.flash_decode_plain(q, k, v, length, bias))
    lib = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "with_combine_ms": whole, "plain_ms": plain,
            "library_ms": lib,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_kernels(A, g):
    """Phase 2: every kernel against its plain version at the serving
    shapes. Returns ({name: max_abs_err}, {case: inputs})."""
    fwd = {
        "prefill b1 h8 s1024 d64 causal+pad bias":
            fwd_case(g, 1, HEADS, 1024, 1024, 64, True, [700]),
        "cross-attention b1 h8 1024x256":
            fwd_case(g, 1, HEADS, 1024, SRC_LEN, 64, False, None),
        "decode-step cross-attention b8 h8 1x256":
            fwd_case(g, SLOTS, HEADS, 1, SRC_LEN, 64, False, None),
        "encoder b16 h8 s256 d64 pad bias":
            fwd_case(g, REQUESTS, HEADS, SRC_LEN, SRC_LEN, 64, False,
                     [SRC_LEN - 9 * i for i in range(REQUESTS)]),
    }
    dec = {
        # row 0's length ends inside the first 128-key split
        "decode b8 h8 L1056 d64 ragged":
            dec_case(g, SLOTS, HEADS, MAX_LEN, 64,
                     [60, 1056, 700, 300, 129, 128, 1000, 513], (20, 40)),
    }
    errs = {"flash_fwd": 0.0, "flash_decode": 0.0}
    for name, (q, k, v, bias, causal) in fwd.items():
        out, lse = A.flash_attention_fwd(q, k, v, bias, causal)
        pout, plse = A.flash_attention_fwd_plain(q, k, v, bias, causal)
        torch.cuda.synchronize()
        e = max((out - pout).abs().max().item(),
                (lse - plse).abs().max().item())
        log(f"  flash_fwd   {name}: max_abs_err {e:.3e}")
        if not e <= ATOL_KERNEL:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version on {name}: {e}")
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
    for name, (q, k, v, length, bias) in dec.items():
        out = A.flash_decode(q, k, v, length, bias)
        pout = A.flash_decode_plain(q, k, v, length, bias)
        torch.cuda.synchronize()
        e = (out - pout).abs().max().item()
        log(f"  flash_decode {name}: max_abs_err {e:.3e}")
        if not e <= ATOL_KERNEL:
            raise AssertionError(f"flash_decode disagrees with its plain "
                                 f"version on {name}: {e}")
        errs["flash_decode"] = max(errs["flash_decode"], e)
    return errs, fwd, dec


# ------------------------------------------------------------ the model

def build_model(seed, device):
    from paddle_tpu_torch import nn

    gen = torch.Generator().manual_seed(seed)
    model = nn.Transformer(D_MODEL, HEADS, LAYERS, LAYERS, FFN, dropout=0.0,
                           device=device, generator=gen).eval()
    embed = nn.Embedding(VOCAB, D_MODEL, device=device,
                         generator=gen).eval()
    project = nn.Linear(D_MODEL, VOCAB, device=device, generator=gen).eval()
    return model, embed, project


def serve(A, seed):
    """Phase 3. Returns (tokens served, launches, served requests, wall
    seconds, metrics snapshot)."""
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    model, embed, project = build_model(seed, "cuda")
    rs = np.random.RandomState(seed)
    src_lens = rs.randint(SRC_LEN // 2, SRC_LEN + 1, REQUESTS)
    src_lens[0] = SRC_LEN
    src = torch.as_tensor(rs.randint(2, VOCAB, (REQUESTS, SRC_LEN)),
                          device="cuda")
    kpos = torch.arange(SRC_LEN, device="cuda")
    src_mask = torch.where(kpos[None] >= torch.as_tensor(
        src_lens, device="cuda")[:, None], -1e30, 0.0).float()
    prompts = []
    for i in range(REQUESTS):
        n = int(rs.randint(300, 1001)) if i > 1 else (400, 1000)[i]
        p = rs.randint(2, VOCAB, n)
        p[0] = 0
        prompts.append(p)
    engine = ServingEngine(model.decoder, embed, project, num_slots=SLOTS,
                           max_len=MAX_LEN, device="cuda")
    server = ServingServer(engine, max_queue=REQUESTS)
    torch.cuda.synchronize()

    A.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        memory = model.encoder(embed(src), src_mask[:, None, None, :])
    reqs = [server.submit(prompts[i], memory[i], max_new_tokens=NEW_TOKENS,
                          eos_id=1) for i in range(REQUESTS)]
    results = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    server.shutdown(drain=True, timeout=60)

    for i, res in enumerate(results):
        if not res.ok:
            raise AssertionError(f"request {i} finished {res.finish_reason}"
                                 f": {res.error!r}")
    n_tok = sum(len(r.tokens) for r in results)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was never launched while serving")
    return (n_tok, launches, (model, embed, project, prompts, memory,
                              results), wall, engine)


def profile_serving(engine, prompts, memory):
    """Phase 4b: a second pass of SLOTS requests through a new server on
    the same engine under torch.profiler: device time by kernel and the
    device's busy share of the window (the profiler's own host cost
    included)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import ServingServer

    server = ServingServer(engine, max_queue=REQUESTS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [server.submit(prompts[i], memory[i],
                              max_new_tokens=NEW_TOKENS, eos_id=1)
                for i in range(SLOTS)]
        for r in reqs:
            r.result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    server.shutdown(drain=True, timeout=60)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler recorded no device time: breakdown not measured")
        return
    groups = {"flash_fwd": 0.0, "flash_decode": 0.0, "gemm": 0.0,
              "other": 0.0}
    for ms, _, key in rows:
        low = key.lower()
        g = ("flash_fwd" if "flash_fwd_kernel" in key else
             "flash_decode" if "flash_decode_kernel" in key else
             "gemm" if "gemm" in low or "cutlass" in low else "other")
        groups[g] += ms
    log(f"  profiled {SLOTS} requests: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    log("  device ms by group: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / busy:.1f}%)" for k, v in groups.items()))
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  {n:6d} x  {key[:90]}")


def cpu_rerun(A, served):
    """Phase 3b: two requests again on the CPU through the plain
    versions; prefill logits and greedy tokens against the card's."""
    from paddle_tpu_torch.core.bucketing import pad_prompt_row
    from paddle_tpu_torch.text.generation import _StepNet, generate_eager

    model, embed, project, prompts, memory, results = served
    nets = {"cuda": _StepNet(model.decoder, embed, project).eval(),
            "cpu": _StepNet(copy.deepcopy(model.decoder).cpu(),
                            copy.deepcopy(embed).cpu(),
                            copy.deepcopy(project).cpu()).eval()}
    for i in (0, 1):
        row, P0, Pb = pad_prompt_row(prompts[i], 1)
        logits = {}
        for dev, net in nets.items():
            caches = [layer.self_attn.gen_cache(None, max_length=Pb,
                                                batch_size=1)
                      for layer in net.decoder.layers]
            with torch.inference_mode():
                lg = net.prefill(torch.as_tensor(row, device=dev), P0,
                                 memory[i][None].to(dev), caches, MAX_LEN)[0]
            logits[dev] = lg[0, :P0].float().cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        net = nets["cpu"]
        toks, _, step_logits = generate_eager(
            net.decoder, net.embed, net.project, memory[i][None].cpu(),
            prompts[i][None], [P0], max_new_tokens=NEW_TOKENS,
            return_logits=True)
        top2 = step_logits[0].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).numpy()
        ambiguous = np.nonzero(gaps < GAP)[0]
        upto = int(ambiguous[0]) if ambiguous.size else NEW_TOKENS
        served = list(results[i].tokens)
        upto = min(upto, len(served))
        agree = served[:upto] == list(toks[0][:upto])
        log(f"  request {i} (prompt {P0}, bucket {Pb}): prefill logits "
            f"max_abs_err {err:.3e}; greedy tokens agree on the first "
            f"{upto} of {len(served)} (first CPU top-2 gap < {GAP}: "
            f"{'none' if not ambiguous.size else int(ambiguous[0])})")
        if not err <= ATOL_LOGITS:
            raise AssertionError(f"prefill logits differ by {err}")
        if not agree:
            raise AssertionError(f"request {i}: card tokens "
                                 f"{served[:upto]} != CPU tokens "
                                 f"{list(toks[0][:upto])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: device {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.kernels()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_info().get('seconds', 0.0):.2f} s, compiled "
        f"{_build.build_info().get('compiled', [])})")

    log("phase 2: kernels against their plain versions (fp32, atol "
        f"{ATOL_KERNEL})")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    errs, fwd, dec = check_kernels(A, g)

    log(f"phase 3: serve Transformer-base, {REQUESTS} requests over "
        f"{SLOTS} slots")
    n_tok, launches, served, wall, engine = serve(A, args.seed)
    snap = engine.metrics.snapshot()
    log(f"  {REQUESTS} requests done, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s; p50 TTFT "
        f"{snap['ttft_ms']['p50']:.1f} ms; p50 decode step "
        f"{snap['token_latency_ms']['p50']:.2f} ms; launches {launches}")
    cpu_rerun(A, served)

    log("phase 4: timing at the serving shapes (median of 25, ms)")
    kernels = []
    for kname, cases, numbers, replaces in (
            ("flash_fwd", fwd, fwd_numbers, "paddle_tpu/ops/attention.py:286"),
            ("flash_decode", dec, dec_numbers,
             "paddle_tpu/ops/attention.py:1376")):
        rows = []
        for cname, inputs in cases.items():
            nums = numbers(A, inputs)
            rows.append(dict(case=cname, **nums))
            whole = (f" (with combine {nums['with_combine_ms']:.4f})"
                     if "with_combine_ms" in nums else "")
            log(f"  {kname} {cname}: kernel {nums['ms']:.4f}{whole} bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}) plain "
                f"{nums['plain_ms']:.4f} sdpa {nums['library_ms']:.4f}; "
                f"{launches[kname] / n_tok:.2f} launches per served token")
        head = rows[0]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["case"],
            "launches_per_token": launches[kname] / n_tok, "cases": rows})
    profile_serving(engine, served[3], served[4])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
