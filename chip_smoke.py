#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits nonzero before the result lines:
 1. Device: the card's name and power limit (nvidia-smi) and the build
    time of the hand-written CUDA kernels (paddle_tpu_torch/csrc).
 2. Each kernel against its plain PyTorch version on the card, at the
    shapes the serving paths give it: flash_fwd and flash_decode (fp32,
    atol 2e-5); flash_verify at b8 h8 T4 L1060 (the speculative pool's
    verify step), fp32 and bf16, ragged lengths, a key-bias hole;
    paged_flash_decode (T 1) and paged_flash_verify (T 4, the paged
    speculative step, and T 256, a prefix hit's tail prefill) at S8 h8
    page 16 mp67 over a shuffled page table with trash and unmapped
    entries, pages fp32, bf16 and int8 with scales. Limits: fp32 output
    (fp32, bf16 or int8 pages under an fp32 query: the dequant is the
    same arithmetic on both sides) atol 2e-5; bf16 output 1e-2 of the
    plain version's largest entry.
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
 5. Dense speculative serve: ServingEngine(spec_k=4) with the phase-3
    weights, 8 requests whose prompts repeat a seeded 16-token period
    (300-1000 tokens), 32 new tokens, through ServingServer. Tokens equal
    the phase-3 plain dense engine's on the same requests (a mismatch
    passes only where the phase prints the first diverging step and a
    top-2 logit margin below 1e-4 there, teacher-forced on the card).
    Prints the acceptance rate, the effective k and tokens/s;
    flash_verify must have launched.
 6. Paged serve: ServingEngine(paged=True, page_size=16, num_slots=8,
    max_len=1056) through ServingServer, fp32 pages, 16 requests of a
    seeded 512-token shared preamble plus a distinct 32-480-token tail
    (one source memory, so the radix prefix cache matches the preamble).
    Tokens equal the dense engine's request for request (or a sub-1e-4
    tie, as in phase 5); at least one partial prefix hit (the tail
    prefill through paged_flash_verify at T up to 512); the allocator
    clean after the drain and every page free after a prefix flush.
    Then the same with spec_k=4. Both paged kernels must have launched;
    a profiled pass of 8 more requests gives the device's busy share.
 7. int8 pages: kv_dtype="int8", 4 of the phase-6 requests; token
    agreement with the fp32 pages is printed, not asserted.
 8. Timing of flash_verify, paged_flash_decode and paged_flash_verify at
    the phase-5/6 shapes: kernel (partials only) and with the combine,
    the bytes / operations bound, the plain version, and SDPA on the
    pre-gathered dense K/V with the equivalent mask (a yardstick; the
    gather is not timed).
 9. Training kernels at the ERNIE-base shapes (b8 h12 s1024 d64, a -1e4
    pad bias over ragged lengths, attention dropout 0.1 on the logical
    512 x 512 blocks): flash_fwd with dropout, flash_bwd_dq and
    flash_bwd_dkv against their plain versions on the same inputs, fp32
    (atol 2e-5 for the forward, 1e-4 for the gradients, 1e-3 for dbias)
    and bf16 (relative to the plain version's largest entry: 1e-3 of it
    for the gradients and dbias, 1e-2 for the output, about one bf16
    rounding step).
10. Train ERNIE-base (hidden 768, 12 layers, 12 heads, FFN 3072, GELU,
    vocab 30522, max_position 1026, 2 classes; hidden and attention
    dropout 0.1; bf16 compute on fp32 masters; AdamW lr 5e-5, weight
    decay 0.01; random weights from --seed) through SpmdTrainer for 12
    steps on one batch of 8 x 1024 tokens with a ragged 1/0 attention
    mask. The launch counters are zeroed just before and read just
    after: each training kernel must have run 12 layers x 12 steps
    times, and every loss must be finite. Reports seq/s over the last 10
    steps, peak device memory, and (two more steps under torch.profiler)
    the device's busy share and device time by kernel.
11. One fp32 step of a 2-layer full-width model (attention dropout 0.1,
    hidden dropout 0, batch 2 x 1024) on the card and on the CPU (plain
    versions; the dropout bits are a device-independent hash): the
    losses agree within rtol 1e-4, all gradients within a relative L2
    distance of 1e-4, and each parameter's gradient within 1e-3 of its
    own largest entry (plus 1e-7 for gradients that are zero in exact
    arithmetic).
12. Timing of the training kernels at the phase-10 shapes (bf16): kernel,
    bound (published H100 SXM peaks: bf16 989 TFLOP/s, fp32 67 TFLOP/s,
    3.35 TB/s; forward 4, dq 6, dkv 8 x b*h*sq*sk*d operations), plain
    version, and torch's scaled_dot_product_attention as the yardstick
    (forward alone for flash_fwd; forward + backward for the backward
    kernels, whose sum it compares with).
13. int8_matmul and lora_gather against their plain versions on the card:
    int8_matmul at m 8, 32 and 1024 (a decode step, a 4-token verify
    step, a prompt bucket) on every (d, n) of the decoder and the
    vocabulary projection (512x512, 512x2048, 2048x512, 512x37000),
    plus a bf16 x; lora_gather at b 8 s 1, b 8 s 4 and b 1 s 1024 on
    512x512, 512x2048 and 2048x512, rank 8, capacity 5, ids mixing the
    base row 0 and every tenant. Limits: fp32 1e-5 of the plain version's
    largest entry (sums over d <= 2048 in another order), bf16 1e-2.
14. Multi-tenant dense serve at the phase-3 width and weights: an
    AdapterPool of 4 tenants (`register_random(seed=100+i, scale=0.05)`,
    rank 8, capacity 5; `bench.py` `_serving_multitenant`), 8 slots, 16
    requests (4 a tenant, prompts of 300-1000 tokens, 32 new tokens)
    through ServingServer. (a) fp32 base: tokens equal, request for
    request, those of a solo fp32 engine per tenant whose target weights
    hold the tenant's `merged_weights` (a divergence passes only with a
    top-2 margin below 1e-4 there, as in phase 5). (b) quantize="int8":
    token agreement with (a) at least 0.8 and weights at least 1.9x
    smaller. The launch counters are zeroed before each serve; lora_gather
    (a, b) and int8_matmul (b) must have grown. Prints the tenancy
    section, tokens/s and the p50 TTFT.
15. Multi-tenant paged serve: the phase-6 preamble requests split across
    two tenants and the base, paged=True, page 16, fp32 pages, then with
    spec_k=4; tokens equal the dense multi-tenant engine's (or a sub-1e-4
    tie under the tenant's adapter). The prefix trie must hold exactly
    three scopes (two tenants and the base), each entered by a miss, so
    no hit crossed tenants; allocator clean, AdapterPool.check() passes
    and no row pinned after the drain.
16. Timing of int8_matmul and lora_gather at the phase-13 shapes: kernel,
    bound (published H100 SXM peaks: fp32 67 TFLOP/s, 3.35 TB/s), plain
    version, and the library yardstick (torch.matmul on the dequantized
    weight; torch.bmm twice on the gathered banks; the port never calls
    either). Then a profiled pass of 8 requests through the int8 + LoRA
    engine: the device's busy share and device time by kernel.
17. fused_conv_fwd and fused_conv_bwd (the fused 1x1-conv + BN op)
    against their plain versions at ResNet-50's bottleneck shapes, conv1
    and conv3 of each stage: (Ci, Co, HW) = (256, 64, 3136), (64, 256,
    3136), (512, 128, 784), (128, 512, 784), (1024, 256, 196), (256,
    1024, 196), (2048, 512, 49), (512, 2048, 49); bf16 at batch 128 with
    norm and ReLU, float32 at batch 8, one float32 identity case; stats
    cotangents nonzero. Limits, of the plain version's largest entry:
    float32 z and dx 1e-5, the stats, dW, dscale and dshift 1e-4 (sums
    over up to 401,408 positions in another order; float32 outputs in
    the bf16 runs too); bf16 z and dx one bf16 ulp of each element.
18. The BN chain of each stage at batch 128, bf16: x -> fused(conv1 W)
    -> bn_scale_shift -> fused(conv3 W, norm + ReLU) -> bn_scale_shift ->
    a loss over z and both stats, forward and backward through the
    autograd Function (the kernels) and through the plain versions; the
    gradients of x, both W and every gamma, beta within 1e-2 of their
    largest entry, and within 1e-3 (bf16 x, W) or 1e-5 (float32 gamma,
    beta) relative L2. The launch counters are zeroed just before the kernel
    run and read just after: two of each kernel a chain.
19. Train ResNet-50 at the bench configuration (`bench.py` `_resnet50`):
    resnet50(num_classes=1000), batch 128 x 3 x 224 x 224 from --seed,
    compute_dtype="bfloat16", momentum(0.1, 0.9), float32 log-softmax
    cross entropy, 12 steps: every loss finite, imgs/s over steps 3-12,
    peak memory (of the trainer's own allocations); two profiled steps
    (busy share, device ms by group); then one step of
    resnet50(num_classes=10) at 2 x 3 x 64 x 64 on the card and on the
    CPU in float64 (loss rtol 1e-12, gradients 1e-10 relative L2,
    running stats 1e-11) and in float32 (loss rtol 1e-4; gradients and running
    stats within 5e-2 / 5e-4 of float64: the random-init step is
    ill-conditioned, see `resnet_card_vs_cpu`).
20. Timing of fused_conv_fwd and fused_conv_bwd at the phase-17 shapes
    (bf16, batch 128): kernel, bound (bf16 989 TFLOP/s, 3.35 TB/s),
    plain version, and the library yardstick (torch.matmul on the
    materialised activation plus the two float32-accumulated sums over
    its bf16 z, sum and vector_norm squared; the backward's two
    torch.matmul on the materialised dz_eff; the port never calls them).
21. Output: a {"kernels": [...]} line for all eleven kernels, then the
    card's name and power limit, then {"ok": true, "device": {...}} as
    the last line.
"""
from __future__ import annotations

import argparse
import copy
import gc
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
BF16_FLOPS_PER_S = 989e12     # H100 SXM, dense tensor cores, published
ATOL_KERNEL = 2e-5
ATOL_LOGITS = 1e-3
GAP = 1e-3
D_MODEL, HEADS, LAYERS, FFN, VOCAB = 512, 8, 6, 2048, 37000
SLOTS, REQUESTS, SRC_LEN, NEW_TOKENS, MAX_LEN = 8, 16, 256, 32, 1056
# speculative and paged serving (phases 5-8)
SPEC_K, PAGE, PREAMBLE, PERIOD, TIE = 4, 16, 512, 16, 1e-4
REL_BF16_ATT = 1e-2   # bf16 attention outputs, of the plain's largest entry
# ERNIE-base fine-tune (the JAX bench's `_ernie_long` configuration)
E_HIDDEN, E_LAYERS, E_HEADS, E_FFN, E_VOCAB = 768, 12, 12, 3072, 30522
E_BATCH, E_SEQ, E_STEPS, E_DROPOUT, E_LR = 8, 1024, 12, 0.1, 5e-5
ATOL_GRAD = 1e-4
# bf16 limits of phase 5, as fractions of the plain version's largest entry
REL_BF16_GRAD, REL_BF16_OUT = 1e-3, 1e-2
# multi-tenant serving (phases 13-16; bench.py `_serving_multitenant`)
MT_TENANTS, MT_RANK, MT_REQUESTS, MT_AGREE = 4, 8, 16, 0.8
QUANT_SHAPES = ((512, 512), (512, 2048), (2048, 512), (512, VOCAB))
# float32 int8 / LoRA kernels, of the plain version's largest entry (sums
# over d <= 2048 in another order)
REL_F32_QUANT = 1e-5
# ResNet-50 training (bench.py `_resnet50`) and the fused 1x1-conv + BN
# op at its bottleneck shapes (phases 17-20): (Ci, Co, HW) of conv1 and
# conv3 of each stage
R_BATCH, R_IMG, R_STEPS, R_CLASSES, R_LR, R_MU = 128, 224, 12, 1000, 0.1, 0.9
FC_BATCH, FC_BATCH_F32 = 128, 8
FC_SHAPES = ((256, 64, 3136), (64, 256, 3136), (512, 128, 784),
             (128, 512, 784), (1024, 256, 196), (256, 1024, 196),
             (2048, 512, 49), (512, 2048, 49))
# float32 limits, of the plain version's largest entry: z and dx (sums over
# Ci or Co <= 2048), the stats, dW, dscale and dshift (sums over up to
# 401,408 positions in another order; float32 in the bf16 runs too). A
# bf16 z or dx is held to one bf16 ulp of each element, and at most 1% of
# its elements may differ at all: both sides round float32 sums of the
# same bf16-rounded operands, so only a sum within its reordering error
# (~1e-6 relative) of a rounding midpoint may land on the neighbouring
# bf16, while unrounded operands (errors ~2^-9 relative) move ~30%
REL_FC_NEAR, REL_FC_FAR, ULP_FC_BF16, SHARE_FC_BF16 = 1e-5, 1e-4, 1.0, 1e-2
# the BN chains (phase 18): each gradient's largest error within 1e-2 of
# its largest entry, and its relative L2 error within 1e-3 for the bf16
# leaves (x, W1, W3) and 1e-5 for the float32 ones (gamma, beta). The
# kernels read 1.2e-4 and 2.9e-7 at most; the same kernels with xn left
# unrounded read 2.5e-3 (W3) and 4.3e-5 (gamma3)
REL_FC_CHAIN, L2_CHAIN_BF16, L2_CHAIN_F32 = 1e-2, 1e-3, 1e-5
# the card-vs-CPU ResNet-50 step (phase 19c). float64: above what float64
# rounding can move this ill-conditioned step by (the float32 distances
# scaled by 2**-29: loss 8e-15, gradients 7e-11, stats 2e-13); float32
# against float64: 1.4x / 5x the CPU's own float32 distance at this size
F64_LOSS, F64_GRAD, F64_STATS = 1e-12, 1e-10, 1e-11
F32_GRAD, F32_STATS = 5e-2, 5e-4


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


def kernel_rows(prof):
    """(device ms, count, name) of every kernel in a torch.profiler run.
    Only the rows of device events count: a CPU op's row also carries
    the device time of the kernels it launched, so summing every row of
    key_averages() counts those kernels twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return rows


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
    for name in ("flash_fwd", "flash_decode"):
        if launches[name] < 1:
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
    rows = kernel_rows(prof)
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
             "gemm" if "gemm" in low or "cutlass" in low or "nvjet" in low
             else "other")
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

# --------------------------------------- verify and paged kernels (2, 8)

def ver_case(g, b, h, T, L, d, lens, dtype):
    """The dense verify step's operands: q from the [b, T, h*d]
    projection (strided), the pool's K/V, a key-bias hole."""
    q = torch.randn(b, T, h * d, generator=g, device="cuda").to(dtype) \
        .view(b, T, h, d).transpose(1, 2)
    k = torch.randn(b, h, L, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, h, L, d, generator=g, device="cuda").to(dtype)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bias = torch.zeros(b, L, device="cuda")
    bias[:, 20:40] = -1e30
    return q, k, v, length, bias


def paged_case(g, S, h, psz, mp, d, T, lens, q_dtype, kv_dtype):
    """A paged read's operands: pages of a shuffled pool (unused pages
    too), each slot's table entries past its written pages pointing at
    the trash row or unmapped (-1), int8 pages with per-(page, head)
    scales, a key-bias hole."""
    N = S * mp + 8
    table = torch.randperm(N, generator=g, device="cuda")[:S * mp] \
        .reshape(S, mp).to(torch.int32)
    for s, n in enumerate(lens):
        table[s, -(-n // psz):] = -1 if s % 2 else N
    raw = [torch.randn(N + 1, h, psz, d, generator=g, device="cuda")
           for _ in range(2)]
    scales = [None, None]
    if kv_dtype == torch.int8:
        for i, x in enumerate(raw):
            sc = x.abs().amax((2, 3), keepdim=True) / 127.0
            raw[i] = torch.round(x / sc).clamp(-127, 127)
            scales[i] = sc.contiguous()
    kp, vp = (x.to(kv_dtype) for x in raw)
    q = torch.randn(S, T, h * d, generator=g, device="cuda").to(q_dtype) \
        .view(S, T, h, d).transpose(1, 2)
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bias = torch.zeros(S, mp * psz, device="cuda")
    bias[:, 20:40] = -1e30
    return q, kp, vp, scales[0], scales[1], table, length, bias


def new_kernel_cases(g):
    """{kernel: {case: (inputs)}} at the shapes of the phase-5/6 paths."""
    lens8 = [60, 1060, 700, 300, 129, 128, 1000, 513]
    plens = [60, 1072, 700, 300, 129, 128, 1000, 513]
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    return {
        "flash_verify": {
            "spec step b8 h8 T4 L1060 fp32": ver_case(
                g, SLOTS, HEADS, SPEC_K, MAX_LEN + SPEC_K, 64, lens8, f32),
            "spec step b8 h8 T4 L1060 bf16": ver_case(
                g, SLOTS, HEADS, SPEC_K, MAX_LEN + SPEC_K, 64, lens8, bf16)},
        "paged_flash_decode": {
            f"decode S8 h8 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, 1, plens, qd, kd)
            for n, qd, kd in (("fp32", f32, f32), ("bf16", f32, bf16),
                              ("int8", f32, i8), ("bf16 q bf16", bf16,
                                                  bf16))},
        "paged_flash_verify": {
            **{f"spec step S8 h8 T4 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, SPEC_K, plens, qd, kd)
               for n, qd, kd in (("fp32", f32, f32), ("bf16", f32, bf16),
                                 ("int8", f32, i8),
                                 ("bf16 q bf16", bf16, bf16))},
            **{f"tail prefill S8 h8 T256 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, 256,
                [max(256, x) for x in plens], qd, kd)
               for n, qd, kd in (("fp32", f32, f32), ("int8", f32, i8))}},
    }


def check_new_kernels(A, cases):
    """Phase 2, second part: flash_verify, paged_flash_decode and
    paged_flash_verify against their plain versions. Returns
    ({kernel: max_abs_err of the fp32-output cases}, {kernel: the same
    for the bf16-output cases})."""
    errs, errs16 = {}, {}
    for kname, group in cases.items():
        wrapper, plain = getattr(A, kname), getattr(A, kname + "_plain")
        for cname, args in group.items():
            got, want = wrapper(*args), plain(*args)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if got.dtype == torch.float32:
                limit, into = ATOL_KERNEL, errs
            else:
                limit = REL_BF16_ATT * want.float().abs().max().item()
                into = errs16
            log(f"  {kname:18s} {cname}: max_abs_err {e:.3e} (limit "
                f"{limit:.3e})")
            if not e <= limit:
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version on {cname}: {e}")
            into[kname] = max(into.get(kname, 0.0), e)
    return errs, errs16


def _visible(length, T):
    """Key-query pairs one row of a T-token verify block sees."""
    return sum(int(length) - T + t + 1 for t in range(T))


def read_numbers(A, kname, args):
    """Phase 8: kernel (partials only) and with the combine, bound, plain
    version, and SDPA on the pre-gathered dense K/V with the equivalent
    [b, 1, T, L] mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kname == "flash_verify":
        q, k, v, length, bias = args
        kd, vd, elt, extra = k, v, k.element_size(), 0
        kern = lambda: A._verify_partials_cuda(      # noqa: E731
            q, k, v, length, bias, None, A.DECODE_SPLIT)
        ns = -(-k.shape[2] // A.DECODE_SPLIT)
    else:
        q, kp, vp, ks, vs, table, length, bias = args
        kd = A.paged_gather_kv(kp, ks, table, q.dtype)
        vd = A.paged_gather_kv(vp, vs, table, q.dtype)
        elt = kp.element_size()
        psz = kp.shape[2]
        # the table, and the scales of every page a row reads
        extra = table.numel() * 4 + (0 if ks is None else 2 * 4 * q.shape[1]
                                     * sum(-(-int(n) // psz) for n in length))
        kern = lambda: A._paged_partials_cuda(       # noqa: E731
            kname, q, kp, vp, ks, vs, table, length, bias, None)
        ns = -(-table.shape[1] // A._pages_per_split(psz))
    b, h, T, d = q.shape
    L = kd.shape[2]
    n = sum(int(x) for x in length)             # keys this data needs
    pairs = sum(_visible(x, T) for x in length)
    nbytes = (2.0 * n * h * d * elt + q.numel() * q.element_size()
              + 4.0 * (bias.numel() + b + b * h * ns * T * (d + 2)) + extra)
    flops = 4.0 * pairs * h * d
    kpos = torch.arange(L, device="cuda")
    qpos = length[:, None].long() - T + torch.arange(T, device="cuda")
    mask = (torch.where(kpos[None, None] <= qpos[:, :, None], 0.0, -1e30)
            + bias[:, None, :])[:, None].to(q.dtype)
    ms = device_ms(kern)
    whole = device_ms(lambda: getattr(A, kname)(*args))
    plain = device_ms(lambda: getattr(A, kname + "_plain")(*args))
    lib = device_ms(lambda: sdpa(q, kd, vd, attn_mask=mask))
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "with_combine_ms": whole, "plain_ms": plain,
            "library_ms": lib, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# ------------------------------------------- speculative and paged serves

def run_server(engine, prompts, memories, new_tokens=NEW_TOKENS,
               adapters=None):
    """Serve the requests (under the tenant adapters named in `adapters`,
    None for the base model) through a new ServingServer on `engine`.
    Returns (tokens per request, wall seconds)."""
    from paddle_tpu_torch.serving import ServingServer

    server = ServingServer(engine, max_queue=len(prompts))
    adapters = adapters or [None] * len(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        reqs = [server.submit(p, m, max_new_tokens=new_tokens, eos_id=1,
                              adapter=a)
                for p, m, a in zip(prompts, memories, adapters)]
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
    finally:
        server.shutdown(drain=True, timeout=60)
    for i, res in enumerate(results):
        if not res.ok:
            raise AssertionError(f"request {i} finished {res.finish_reason}"
                                 f": {res.error!r}")
    return [list(r.tokens) for r in results], wall


def top2_margin(net, prompt, memory, toks, j):
    """Top-2 logit margin of generated step j, teacher-forced on the card
    with the first j tokens (the serving layout: prompt bucket with its
    pad hole, then the generated tokens)."""
    from paddle_tpu_torch.core.bucketing import pad_prompt_row
    from paddle_tpu_torch.text.generation import pad_bias_row

    row, P0, Pb = pad_prompt_row(prompt, 1)
    seq = np.concatenate([row[0], np.asarray(toks[:j], np.int64)])
    x = torch.as_tensor(seq, device="cuda")[None]
    bias = pad_bias_row([P0], Pb, len(seq), "cuda")
    with torch.inference_mode():
        out = net.decoder(net.embed(x), memory[None].to("cuda"),
                          bias[:, None, None, :], None, tgt_is_causal=True)
        lg = net.project(out)[0, P0 - 1 if j == 0 else Pb + j - 1]
    top = lg.float().topk(2).values
    return float(top[0] - top[1])


def same_tokens(label, want, got, net, prompts, memories, margin_fn=None):
    """Request-for-request token equality; a divergence passes only at a
    top-2 margin below TIE (printed; `margin_fn(i, tokens, j)` computes it
    where the request needs more than `net`). Returns the count of tied
    requests."""
    ties = 0
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        j = next((t for t, (a, b) in enumerate(zip(w, g)) if a != b),
                 min(len(w), len(g)))
        margin = (margin_fn(i, w, j) if margin_fn is not None else
                  top2_margin(net, prompts[i], memories[i], w, j))
        log(f"  {label} request {i}: first diverging step {j} "
            f"({w[j:j + 1]} vs {g[j:j + 1]}), top-2 logit margin "
            f"{margin:.3e}")
        if not margin < TIE:
            raise AssertionError(f"{label}: request {i} diverges at step {j} "
                                 f"with a top-2 margin of {margin}")
        ties += 1
    return ties


def spec_serve(A, seed, model, embed, project, dense, memory):
    """Phase 5. Returns (launches, snapshot, tokens/s)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    rs = np.random.RandomState(seed + 5)
    prompts = []
    for _ in range(SLOTS):
        p = np.resize(rs.randint(2, VOCAB, PERIOD), int(rs.randint(300, 1001)))
        p[0] = 0
        prompts.append(p)
    mems = [memory[i] for i in range(SLOTS)]
    want, _ = run_server(dense, prompts, mems)
    engine = ServingEngine(model.decoder, embed, project, num_slots=SLOTS,
                           max_len=MAX_LEN, spec_k=SPEC_K, device="cuda")
    A.reset_launches()
    got, wall = run_server(engine, prompts, mems)
    launches = dict(A.LAUNCHES)
    snap = engine.metrics.snapshot()
    net = _StepNet(model.decoder, embed, project).eval()
    ties = same_tokens("spec", want, got, net, prompts, mems)
    sp = snap["speculation"]
    n_tok = sum(len(t) for t in got)
    log(f"  {SLOTS} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s; acceptance rate "
        f"{sp['acceptance_rate']}, effective_k {sp['effective_k']}, "
        f"{sp['rounds']} rounds, p50 verify step "
        f"{sp['verify_step_ms'].get('p50', 0):.2f} ms; tokens equal the "
        f"dense engine's ({ties} ties); launches {launches}")
    if launches["flash_verify"] < 1:
        raise AssertionError("flash_verify was never launched while serving")
    return launches, snap, n_tok / wall


def paged_requests(seed, n, memory):
    rs = np.random.RandomState(seed)
    pre = rs.randint(2, VOCAB, PREAMBLE)
    pre[0] = 0
    prompts = [np.concatenate([pre, rs.randint(2, VOCAB,
                                              int(rs.randint(32, 481)))])
               for _ in range(n)]
    return prompts, [memory] * n


def paged_serve(A, seed, model, embed, project, dense, memory):
    """Phase 6 (and the engine of phase 7). Returns ({path: launches},
    {path: snapshot}, {path: tokens/s}, fp32 tokens, prompts, memories)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    prompts, mems = paged_requests(seed + 6, REQUESTS, memory)
    want, _ = run_server(dense, prompts, mems)
    net = _StepNet(model.decoder, embed, project).eval()
    launches, snaps, rates, engines = {}, {}, {}, {}
    for path, spec_k in (("paged", None), ("paged_spec", SPEC_K)):
        engine = ServingEngine(model.decoder, embed, project, paged=True,
                               page_size=PAGE, num_slots=SLOTS,
                               max_len=MAX_LEN, spec_k=spec_k, device="cuda")
        A.reset_launches()
        got, wall = run_server(engine, prompts, mems)
        launches[path] = dict(A.LAUNCHES)
        snaps[path] = snap = engine.metrics.snapshot()
        engine._alloc.check()
        ties = same_tokens(path, want, got, net, prompts, mems)
        if path == "paged":
            fp32_tokens = got
        pre, pg = snap["prefix"], snap["paging"]
        n_tok = sum(len(t) for t in got)
        rates[path] = n_tok / wall
        extra = ""
        if spec_k:
            sp = snap["speculation"]
            extra = (f"; acceptance rate {sp['acceptance_rate']}, "
                     f"effective_k {sp['effective_k']}")
        log(f"  {path}: {REQUESTS} requests, {n_tok} tokens in {wall:.3f} s:"
            f" {rates[path]:.1f} tokens/s; p50 TTFT "
            f"{snap['ttft_ms']['p50']:.1f} ms; prefix whole/partial/miss "
            f"{pre['whole_hits']}/{pre['partial_hits']}/{pre['misses']}, "
            f"hit-token ratio {pre['hit_token_ratio']}, cow {pre['cow_copies']}"
            f"; pages in use {pg['pages_in_use']} of {engine.num_pages}, "
            f"waits {pg['page_waits']}, oom {pg['oom_evictions']}{extra}; "
            f"tokens equal the dense engine's ({ties} ties); launches "
            f"{launches[path]}")
        if pre["partial_hits"] < 1:
            raise AssertionError(f"{path}: no partial prefix hit")
        need = ["paged_flash_verify"] + ([] if spec_k else
                                         ["paged_flash_decode"])
        for name in need:
            if launches[path][name] < 1:
                raise AssertionError(f"{name} was never launched on {path}")
        engines[path] = engine
    # a profiled pass of SLOTS more requests (new tails: partial hits)
    more, more_mems = paged_requests(seed + 6, REQUESTS + SLOTS, memory)
    # flash_fwd_kernel: prefill of the cold join; split_attn_kernel: the
    # paged decode and verify kernels (one template)
    profile_pass(engines["paged"], more[REQUESTS:], more_mems[REQUESTS:],
                 ("flash_fwd_kernel", "split_attn_kernel"))
    for path, engine in engines.items():
        engine.flush_prefix_cache()
        engine._alloc.check()
        if engine._alloc.pages_free != engine.num_pages:
            raise AssertionError(f"{path}: pages leaked after the drain")
    log(f"  allocators clean after the drain; all pages free after the "
        f"prefix flush")
    return launches, snaps, rates, fp32_tokens, prompts, mems


def int8_serve(A, model, embed, project, prompts, mems, fp32_tokens):
    """Phase 7: int8 pages; agreement with the fp32 pages printed."""
    from paddle_tpu_torch.serving import ServingEngine

    engine = ServingEngine(model.decoder, embed, project, paged=True,
                           page_size=PAGE, num_slots=SLOTS, max_len=MAX_LEN,
                           kv_dtype="int8", device="cuda")
    A.reset_launches()
    got, wall = run_server(engine, prompts[:4], mems[:4])
    launches = dict(A.LAUNCHES)
    agree = int(sum(a == b for g, w in zip(got, fp32_tokens)
                    for a, b in zip(g, w)))
    first = [next((t for t, (a, b) in enumerate(zip(g, w)) if a != b),
                  len(g)) for g, w in zip(got, fp32_tokens)]
    log(f"  int8 pages: 4 requests in {wall:.3f} s; {agree} of "
        f"{sum(len(t) for t in got)} tokens equal the fp32 pages' "
        f"(tokens before the first difference: {first}); launches "
        f"{launches}")
    return {"agree": agree, "first_difference": first}


def profile_pass(engine, prompts, memories, kernel_names, adapters=None):
    """A pass under torch.profiler: wall, the device's busy share, and
    device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_server(engine, prompts, memories, adapters=adapters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler recorded no device time: breakdown not measured")
        return
    groups = {k: 0.0 for k in (*kernel_names, "gemm", "other")}
    for ms, _, key in rows:
        low = key.lower()
        grp = next((k for k in kernel_names if k in key), None)
        if grp is None:
            grp = ("gemm" if "gemm" in low or "cutlass" in low
                   or "nvjet" in low else "other")
        groups[grp] += ms
    log(f"  profiled {len(prompts)} requests: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    log("  device ms by group: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / busy:.1f}%)" for k, v in groups.items()))
    for ms, n, key in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:9.3f} ms  {n:6d} x  {key[:90]}")


# ------------------------------------------------------------- training

def train_case(g, dtype, seed=1234):
    """ERNIE-base attention operands as the layers produce them: [b, s,
    h*d] projections viewed as [b, h, s, d] (strided), dO likewise, a
    [b, s] key bias of -1e4 over each row's pad tail, and the dropout
    spec of a 0.1 call (logical blocks 512 x 512 at s 1024)."""
    from paddle_tpu_torch.ops import attention as A

    b, h, s, d = E_BATCH, E_HEADS, E_SEQ, E_HIDDEN // E_HEADS

    def proj():
        return torch.randn(b, s, h * d, generator=g, device="cuda") \
            .to(dtype).view(b, s, h, d).transpose(1, 2)
    q, k, v, do = proj(), proj(), proj(), proj()
    lens = torch.tensor([s, 900, 700, 1000, 513, 1024, 640, 800],
                        device="cuda")
    kpos = torch.arange(s, device="cuda")
    bias = torch.where(kpos[None] >= lens[:, None], -1e4, 0.0).float() \
        .contiguous()
    drop = A.drop_spec(E_DROPOUT, seed, s, s)
    return q, k, v, bias, do, drop


def check_train_kernels(A, g):
    """Phase 9: the three training kernels against their plain versions
    at the ERNIE shapes, fp32 and bf16. Returns ({kernel: max_abs_err
    fp32}, {kernel: max_abs_err bf16}, bf16 inputs)."""
    errs, errs16 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, do, drop = train_case(g, dtype)
        out, lse = A.flash_attention_fwd(q, k, v, bias, False, None, drop)
        pout, plse = A.flash_attention_fwd_plain(q, k, v, bias, False,
                                                 None, drop)
        got = A.flash_attention_bwd(q, k, v, bias, pout, plse, do, False,
                                    None, drop)
        want = A.flash_attention_bwd_plain(q, k, v, bias, pout, plse, do,
                                           False, None, drop)
        torch.cuda.synchronize()
        mags = {"flash_fwd": pout.float().abs().max().item(),
                "flash_bwd_dq": want[0].float().abs().max().item(),
                "flash_bwd_dkv": max(w.float().abs().max().item()
                                     for w in want[1:3]),
                "flash_bwd_dkv dbias": want[3].abs().max().item()}
        e = {"flash_fwd": max((out.float() - pout.float()).abs().max()
                              .item(), (lse - plse).abs().max().item()),
             "flash_bwd_dq": (got[0].float() - want[0].float()).abs().max()
             .item(),
             "flash_bwd_dkv": max((a.float() - w.float()).abs().max().item()
                                  for a, w in zip(got[1:3], want[1:3])),
             "flash_bwd_dkv dbias": (got[3] - want[3]).abs().max().item()}
        fp32 = dtype == torch.float32
        for name, err in e.items():
            if fp32:
                limit = ATOL_KERNEL if name == "flash_fwd" else ATOL_GRAD
                if name.endswith("dbias"):
                    # a sum over 12 heads x 1024 rows of dlogits
                    limit *= 10
            else:
                limit = mags[name] * (REL_BF16_OUT if name == "flash_fwd"
                                      else REL_BF16_GRAD)
            log(f"  {name:22s} {str(dtype)[6:]:8s} b8 h12 s1024 d64 bias "
                f"dropout 0.1: max_abs_err {err:.3e} (limit {limit:.3e}; "
                f"largest plain entry {mags[name]:.3e})")
            if not err <= limit:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version in {dtype}: {err}")
            (errs if fp32 else errs16)[name.split()[0]] = max(
                err, (errs if fp32 else errs16).get(name.split()[0], 0.0))
    return errs, errs16, (q, k, v, bias, do, drop)


def ernie(device, layers, dropout, seed):
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)

    cfg = ErnieConfig(vocab_size=E_VOCAB, hidden_size=E_HIDDEN,
                      num_layers=layers, num_heads=E_HEADS,
                      intermediate_size=E_FFN, max_position=E_SEQ + 2,
                      hidden_dropout=dropout[0], attn_dropout=dropout[1],
                      num_classes=2)
    return ErnieForSequenceClassification(
        cfg, device=device, generator=torch.Generator().manual_seed(seed))


def ernie_batch(seed, b, s):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, E_VOCAB, (b, s)).astype(np.int64)
    lens = rs.randint(s // 2, s + 1, b)
    lens[0] = s
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.float32)
    labels = rs.randint(0, 2, (b,)).astype(np.int64)
    return (ids, np.zeros_like(ids), mask), labels


def ce_loss(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def train(A, seed):
    """Phase 10. Returns (launches, losses, seq/s, peak bytes, trainer,
    batch)."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer

    model = ernie("cuda", E_LAYERS, (E_DROPOUT, E_DROPOUT), seed)
    tr = SpmdTrainer(model, ce_loss, fopt.adamw(E_LR, weight_decay=0.01),
                     compute_dtype="bfloat16", device="cuda",
                     generator=torch.Generator().manual_seed(seed))
    inputs, labels = ernie_batch(seed, E_BATCH, E_SEQ)
    inputs = tuple(torch.as_tensor(x, device="cuda") for x in inputs)
    labels = torch.as_tensor(labels, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    losses = []
    for i in range(E_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.step(inputs, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = E_LAYERS * E_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {E_STEPS} steps, expected {want}")
    return launches, losses, E_BATCH * (E_STEPS - 2) / wall, peak, tr, \
        (inputs, labels)


def profile_training(tr, batch, steps=2):
    """Phase 10b: two more steps under torch.profiler: the device's busy
    share of the window and device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler recorded no device time: breakdown not measured")
        return None
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "gemm": 0.0, "other": 0.0}
    for ms, _, key in rows:
        low = key.lower()
        grp = ("flash_fwd" if "flash_fwd_kernel" in key else
               "flash_bwd_dq" if "flash_bwd_dq_kernel" in key else
               "flash_bwd_dkv" if "flash_bwd_dkv_kernel" in key else
               "gemm" if "gemm" in low or "cutlass" in low
               or "xmma" in low or "nvjet" in low else "other")
        groups[grp] += ms
    share = busy / (wall * 1e3)
    log(f"  profiled {steps} steps: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * share:.1f}%), idle {100 * (1 - share):.1f}%")
    log("  device ms per step by group: " + ", ".join(
        f"{k} {v / steps:.2f} ({100 * v / busy:.1f}%)"
        for k, v in groups.items()))
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return {"busy_share": share, "step_ms": wall * 1e3 / steps,
            "groups_ms_per_step": {k: v / steps for k, v in groups.items()}}


def card_vs_cpu_step(seed):
    """Phase 11: one fp32 forward + backward of a 2-layer full-width
    model with attention dropout on the card and on the CPU."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer

    inputs, labels = ernie_batch(seed + 1, 2, E_SEQ)
    res = {}
    for dev in ("cuda", "cpu"):
        model = ernie(dev, 2, (0.0, E_DROPOUT), seed)
        tr = SpmdTrainer(model, ce_loss, fopt.adamw(E_LR), device=dev,
                         generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(inputs, labels)
        res[dev] = (float(loss), {n: g.cpu() for n, g in grads.items()})
        log(f"  {dev}: loss {res[dev][0]:.6f} in "
            f"{time.perf_counter() - t0:.2f} s")
    (l_gpu, g_gpu), (l_cpu, g_cpu) = res["cuda"], res["cpu"]
    if not abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu):
        raise AssertionError(f"card loss {l_gpu} != CPU loss {l_cpu}")
    num = sum(float((g_gpu[n] - g_cpu[n]).pow(2).sum()) for n in g_cpu)
    den = sum(float(g_cpu[n].pow(2).sum()) for n in g_cpu)
    rel = (num / den) ** 0.5
    worst, worst_name = 0.0, None
    for n in g_cpu:
        diff = float((g_gpu[n] - g_cpu[n]).abs().max())
        scale = float(g_cpu[n].abs().max())
        if not diff <= 1e-3 * scale + 1e-7:
            raise AssertionError(f"gradient of {n} differs by {diff} "
                                 f"(its largest entry {scale})")
        if scale > 1e-6 and diff / scale > worst:
            worst, worst_name = diff / scale, n
    log(f"  gradients: relative L2 distance {rel:.3e}; worst parameter "
        f"(of those with a gradient above 1e-6) {worst_name} at "
        f"{worst:.3e} of its largest entry")
    if not rel <= 1e-4:
        raise AssertionError(f"gradients differ: relative L2 {rel}")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu, "grad_rel_l2": rel,
            "grad_worst_rel": worst}


def train_numbers(A, case):
    """Phase 12: each training kernel's time at the main path's shapes
    (bf16), its bound, its plain version's and the library yardstick."""
    q, k, v, bias, do, drop = case
    b, h, s, d = q.shape
    pairs = b * h * s * s
    elt = q.element_size()
    qkv = b * h * s * d * elt                     # bytes of one operand
    row = 4.0 * b * h * s                          # an f32 per-row tensor
    out, lse = A.flash_attention_fwd(q, k, v, bias, False, None, drop)
    delta = A._delta(do, out)
    lse2 = lse.reshape(b * h, s)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias[:, None, None, :].to(q.dtype)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=E_DROPOUT)
        o.backward(do)

    def bound(flops, nbytes):
        t_ops = flops / (BF16_FLOPS_PER_S if q.dtype == torch.bfloat16
                         else FP32_FLOPS_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    plain_bwd = device_ms(lambda: A.flash_attention_bwd_plain(
        q, k, v, bias, out, lse, do, False, None, drop, False), runs=10)
    lib_fb = device_ms(lib_fwd_bwd, runs=10)
    rows = {}
    for name, flops, nbytes, fn, plain, lib in (
            ("flash_fwd", 4.0 * pairs * d, 4 * qkv + row + 4.0 * b * s,
             lambda: A._flash_fwd_cuda(q, k, v, bias, False, None, drop),
             device_ms(lambda: A.flash_attention_fwd_plain(
                 q, k, v, bias, False, None, drop), runs=10),
             device_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                    dropout_p=E_DROPOUT), runs=10)),
            ("flash_bwd_dq", 6.0 * pairs * d, 5 * qkv + 2 * row + 4.0 * b * s,
             lambda: A._flash_bwd_dq_cuda(q, k, v, bias, do, lse2, delta,
                                          False, None, drop),
             plain_bwd, lib_fb),
            ("flash_bwd_dkv", 8.0 * pairs * d,
             6 * qkv + 2 * row + 4.0 * b * s,
             lambda: A._flash_bwd_dkv_cuda(q, k, v, bias, do, lse2, delta,
                                           False, None, drop, False),
             plain_bwd, lib_fb)):
        bms, by = bound(flops, nbytes)
        ms = device_ms(fn)
        rows[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bms, "bound_by": by}
        log(f"  {name} bf16 b8 h12 s1024 d64 bias dropout: kernel "
            f"{ms:.4f} bound {bms:.4f} ({by}) plain {plain:.4f} sdpa "
            f"{lib:.4f}")
    total = sum(r["ms"] for r in rows.values())
    log(f"  the three kernels together {total:.4f} ms; sdpa forward + "
        f"backward {lib_fb:.4f} ms (the plain bwd times dq, dk and dv "
        f"together: {plain_bwd:.4f} ms)")
    return rows



# ------------------------------------- multi-tenant serving (13-16)

def int8_cases(Q, g):
    """{case: (x, q, scale)} at the multi-tenant serve's shapes: m = 8 (a
    decode step over 8 slots), 32 (a 4-token verify step) and 1024 (a
    prompt bucket), every (d, n) of the decoder and the vocabulary
    projection, Xavier-scaled weights quantized per column; plus one bf16
    x."""
    cases = {}
    for d, n in QUANT_SHAPES:
        w = torch.randn(d, n, generator=g, device="cuda") * \
            (6.0 / (d + n)) ** 0.5
        q, scale = Q.quantize_int8_weight(w)
        for m in (8, 32, 1024):
            cases[f"m{m} {d}x{n}"] = (
                torch.randn(m, d, generator=g, device="cuda"), q, scale)
    x, q, scale = cases["m8 512x2048"]
    cases["m8 512x2048 bf16 x"] = (x.bfloat16(), q, scale)
    return cases


def lora_cases(g):
    """{case: (x, A, B, host ids)}: decode (b 8, s 1), verify (b 8, s 4)
    and a join (b 1, s 1024) on each (d, n) of the adapter targets, rank
    8, capacity tenants + 1 (bank row 0 zero), ids mixing the base and
    every tenant."""
    cases = {}
    cap = MT_TENANTS + 1
    for d, n in ((512, 512), (512, 2048), (2048, 512)):
        A = torch.randn(cap, d, MT_RANK, generator=g, device="cuda") * 0.05
        B = torch.randn(cap, MT_RANK, n, generator=g, device="cuda") * 0.05
        A[0] = 0.0
        B[0] = 0.0
        for b, s in ((8, 1), (8, 4), (1, 1024)):
            ids = [0, 1, 2, 3, 4, 0, 2, 4] if b == 8 else [3]
            cases[f"b{b} s{s} {d}x{n}"] = (
                torch.randn(b, s, d, generator=g, device="cuda"), A, B,
                torch.tensor(ids, dtype=torch.int32))
    return cases


def check_quant_kernels(Q, g):
    """Phase 13: int8_matmul and lora_gather against their plain versions.
    Returns ({kernel: max_abs_err fp32}, {kernel: max_abs_err bf16},
    int8 cases, lora cases)."""
    i8, lo = int8_cases(Q, g), lora_cases(g)
    errs, errs16 = {}, {}
    for kname, cases, fn, plain in (
            ("int8_matmul", i8, Q.int8_matmul, Q.int8_matmul_reference),
            ("lora_gather", lo, Q.lora_delta, Q.lora_delta_reference)):
        for cname, args in cases.items():
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            fp32 = got.dtype == torch.float32
            limit = (REL_F32_QUANT if fp32 else REL_BF16_ATT) * \
                want.float().abs().max().item()
            log(f"  {kname:12s} {cname}: max_abs_err {e:.3e} (limit "
                f"{limit:.3e})")
            if not e <= limit:
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version on {cname}: {e}")
            into = errs if fp32 else errs16
            into[kname] = max(into.get(kname, 0.0), e)
    return errs, errs16, i8, lo


def mt_requests(seed):
    """16 requests, 4 per tenant: prompts of 300-1000 tokens."""
    rs = np.random.RandomState(seed)
    prompts, names = [], []
    for i in range(MT_REQUESTS):
        p = rs.randint(2, VOCAB, int(rs.randint(300, 1001)))
        p[0] = 0
        prompts.append(p)
        names.append(f"tenant{i % MT_TENANTS}")
    return prompts, names


def adapter_pool(decoder):
    from paddle_tpu_torch.serving import AdapterPool

    pool = AdapterPool(decoder, capacity=MT_TENANTS + 1, rank=MT_RANK)
    for i in range(MT_TENANTS):
        pool.register_random(f"tenant{i}", seed=100 + i, scale=0.05)
    return pool


def tenant_margin(Q, net, pool, prompts, memories, names):
    """margin_fn for `same_tokens`: the top-2 margin under the request's
    tenant adapter (a lora_scope over the pool's bank row)."""
    def fn(i, toks, j):
        row = pool.acquire(names[i])
        try:
            with Q.lora_scope(np.asarray([row], np.int32), pool.banks()):
                return top2_margin(net, prompts[i], memories[i], toks, j)
        finally:
            pool.release(row)
    return fn


def mt_dense_serve(Q, seed, memory):
    """Phase 14. (a) float32 base with adapters, against solo engines on
    the merged weights; (b) quantize="int8" with adapters. Returns a dict
    of results (engines included)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.adapters import decoder_lora_targets
    from paddle_tpu_torch.text.generation import _StepNet

    model, embed, project = build_model(seed, "cuda")
    base = copy.deepcopy((model.decoder, embed, project))  # before any pool
    del model
    prompts, names = mt_requests(seed + 14)
    mems = [memory[i] for i in range(MT_REQUESTS)]
    out = {"prompts": prompts, "names": names, "mems": mems}
    stack = copy.deepcopy(base)
    pool = adapter_pool(stack[0])
    engine = ServingEngine(*stack, num_slots=SLOTS, max_len=MAX_LEN,
                           adapters=pool, device="cuda")
    Q.reset_launches()
    got, wall = run_server(engine, prompts, mems, adapters=names)
    launches = launch_counts()
    snap = engine.metrics.snapshot()
    pool.check()
    if launches["lora_gather"] < 1:
        raise AssertionError("lora_gather was never launched while serving")
    n_tok = sum(len(t) for t in got)
    log(f"  (a) fp32 + adapters: {MT_REQUESTS} requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s; p50 TTFT "
        f"{snap['ttft_ms']['p50']:.1f} ms; launches {launches}")
    log(f"      tenancy {json.dumps(snap['tenancy'])}")
    ties = 0
    for t in range(MT_TENANTS):
        name = f"tenant{t}"
        mine = [i for i in range(MT_REQUESTS) if names[i] == name]
        solo = copy.deepcopy(base)
        targets = decoder_lora_targets(solo[0])
        with torch.no_grad():
            for k, w in pool.merged_weights(name):
                targets[k].weight.copy_(w)
        seng = ServingEngine(*solo, num_slots=SLOTS, max_len=MAX_LEN,
                             device="cuda")
        want, _ = run_server(seng, [prompts[i] for i in mine],
                             [mems[i] for i in mine])
        ties += same_tokens(f"merged {name}", want, [got[i] for i in mine],
                            _StepNet(*solo).eval(),
                            [prompts[i] for i in mine],
                            [mems[i] for i in mine])
        del seng, solo, targets
    log(f"  (a) tokens equal the solo merged-weight engines' request for "
        f"request ({ties} ties)")
    out.update(fp32_engine=engine, fp32_pool=pool, fp32_tokens=got,
               fp32_launches=launches, fp32_snap=snap, fp32_rate=n_tok / wall,
               ties=ties)

    stack8 = copy.deepcopy(base)
    pool8 = adapter_pool(stack8[0])
    engine8 = ServingEngine(*stack8, num_slots=SLOTS, max_len=MAX_LEN,
                            adapters=pool8, quantize="int8", device="cuda")
    del base
    Q.reset_launches()
    got8, wall8 = run_server(engine8, prompts, mems, adapters=names)
    launches8 = launch_counts()
    snap8 = engine8.metrics.snapshot()
    pool8.check()
    for name in ("int8_matmul", "lora_gather"):
        if launches8[name] < 1:
            raise AssertionError(f"{name} was never launched on the int8 "
                                 f"serve")
    agree = sum(a == b for g8, g32 in zip(got8, got)
                for a, b in zip(g8, g32))
    total = sum(len(t) for t in got)
    agreement = agree / total
    shrink = engine.weights_bytes() / engine8.weights_bytes()
    n8 = sum(len(t) for t in got8)
    log(f"  (b) int8 + adapters: {n8} tokens in {wall8:.3f} s: "
        f"{n8 / wall8:.1f} tokens/s; p50 TTFT {snap8['ttft_ms']['p50']:.1f} "
        f"ms; token agreement with (a) {agree}/{total} = {agreement:.4f} "
        f"(floor {MT_AGREE}); weights {engine.weights_bytes()} -> "
        f"{engine8.weights_bytes()} bytes ({shrink:.3f}x smaller, floor "
        f"1.9), adapter banks {engine8.adapter_bytes()} bytes; launches "
        f"{launches8}")
    log(f"      tenancy {json.dumps(snap8['tenancy'])}")
    log(f"      memory {json.dumps(snap8['memory'])}")
    if not agreement >= MT_AGREE:
        raise AssertionError(f"int8 token agreement {agreement} < "
                             f"{MT_AGREE}")
    if not shrink >= 1.9:
        raise AssertionError(f"int8 weights only {shrink}x smaller")
    out.update(int8_engine=engine8, int8_tokens=got8, int8_launches=launches8,
               int8_snap=snap8, int8_rate=n8 / wall8, agreement=agreement,
               shrink=shrink)
    return out


def mt_paged_serve(Q, seed, mt, memory):
    """Phase 15: the phase-6 preamble requests split across two tenants
    and the base, on the paged pool (fp32 pages), then with spec_k 4; the
    tokens of the dense multi-tenant engine. Returns ({path: launches},
    {path: snapshot})."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    dense, pool = mt["fp32_engine"], mt["fp32_pool"]
    net = dense._net
    prompts, mems = paged_requests(seed + 6, REQUESTS, memory)
    names = [(None, "tenant0", "tenant1")[i % 3] for i in range(REQUESTS)]
    want, _ = run_server(dense, prompts, mems, adapters=names)
    margin = tenant_margin(Q, _StepNet(net.decoder, net.embed,
                                       net.project).eval(),
                           pool, prompts, mems, names)
    launches, snaps = {}, {}
    for path, spec_k in (("mt_paged", None), ("mt_paged_spec", SPEC_K)):
        engine = ServingEngine(net.decoder, net.embed, net.project,
                               paged=True, page_size=PAGE, num_slots=SLOTS,
                               max_len=MAX_LEN, spec_k=spec_k, adapters=pool,
                               device="cuda")
        Q.reset_launches()
        got, wall = run_server(engine, prompts, mems, adapters=names)
        launches[path] = launch_counts()
        snaps[path] = snap = engine.metrics.snapshot()
        ties = same_tokens(path, want, got, None, prompts, mems, margin)
        pre = snap["prefix"]
        scopes = sorted(str(k[1]) for k in engine._prefix._roots)
        n_tok = sum(len(t) for t in got)
        log(f"  {path}: {REQUESTS} requests, {n_tok} tokens in {wall:.3f} s:"
            f" {n_tok / wall:.1f} tokens/s; prefix whole/partial/miss "
            f"{pre['whole_hits']}/{pre['partial_hits']}/{pre['misses']}, "
            f"hit-token ratio {pre['hit_token_ratio']}; trie scopes "
            f"{scopes}; tokens equal the dense multi-tenant engine's "
            f"({ties} ties); launches {launches[path]}")
        log(f"      tenancy {json.dumps(snap['tenancy'])}")
        # one scope per tenant and the base, each entered by a miss: a hit
        # never crossed tenants (the preamble is shared by all 16)
        if len(scopes) != 3 or pre["misses"] < 3:
            raise AssertionError(f"{path}: prefix scopes {scopes}, misses "
                                 f"{pre['misses']}")
        if launches[path]["lora_gather"] < 1:
            raise AssertionError(f"lora_gather was never launched on {path}")
        engine.flush_prefix_cache()
        engine._alloc.check()
        if engine._alloc.pages_free != engine.num_pages:
            raise AssertionError(f"{path}: pages leaked after the drain")
        pool.check()
        if pool.refcount.sum():
            raise AssertionError(f"{path}: adapter rows still pinned")
        del engine
    log("  allocators clean and adapter rows unpinned after the drains")
    return launches, snaps


def quant_numbers(Q, kname, args):
    """Phase 16: kernel, bound, plain version and the library yardstick
    (torch.matmul on the pre-dequantized weight; torch.bmm twice on the
    pre-gathered banks) at one case."""
    if kname == "int8_matmul":
        x, q, scale = args
        m, d = x.shape
        n = q.shape[1]
        flops = 2.0 * m * d * n
        nbytes = 4.0 * m * d + d * n + 4.0 * n + 4.0 * m * n
        w = q.float() * scale
        kern = lambda: Q._int8_matmul_cuda(x, q, scale)       # noqa: E731
        plain = lambda: Q.int8_matmul_reference(x, q, scale)  # noqa: E731
        lib = lambda: torch.matmul(x, w)                      # noqa: E731
    else:
        x, A, B, ids = args
        b, s, d = x.shape
        r, n = B.shape[1], B.shape[2]
        ids_dev = ids.to("cuda")
        distinct = len(set(ids.tolist()))
        flops = 2.0 * b * s * r * (d + n)
        nbytes = 4.0 * (b * s * d + distinct * r * (d + n) + b + b * s * n)
        ag, bg = A[ids_dev.long()], B[ids_dev.long()]
        kern = lambda: Q._lora_gather_cuda(x, A, B, ids_dev)  # noqa: E731
        plain = lambda: Q.lora_delta_reference(x, A, B, ids)  # noqa: E731
        lib = lambda: torch.bmm(torch.bmm(x, ag), bg)         # noqa: E731
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ms": device_ms(kern), "plain_ms": device_ms(plain),
            "library_ms": device_ms(lib),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# -------------------------------- the fused 1x1-conv + BN op (17, 18, 20)

def fc_case(g, B, ci, co, hw, dtype, norm=True):
    """Inputs of one fused op at a ResNet-50 bottleneck shape: x as a BN'd
    activation, a folded scale / shift, He-scaled W, and cotangents of z
    and of both stats (nonzero: the BN-chain path)."""
    x = torch.randn(B, ci, hw, generator=g, device="cuda").to(dtype)
    sc = torch.rand(ci, generator=g, device="cuda") + 0.5 if norm else None
    sh = torch.randn(ci, generator=g, device="cuda") * 0.1 if norm else None
    w = (torch.randn(co, ci, generator=g, device="cuda")
         * (2.0 / ci) ** 0.5).to(dtype)
    dz = torch.randn(B, co, hw, generator=g, device="cuda").to(dtype)
    ds = torch.randn(co, generator=g, device="cuda")
    dss = torch.randn(co, generator=g, device="cuda") * 0.01
    return x, sc, sh, w, dz, ds, dss


def bf16_ulps(a, b):
    """(the largest |a - b| in units of the bf16 spacing at max(|a|, |b|),
    element by element; the share of elements that differ)."""
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    return (float(((a - b).abs() / ulp).max()),
            float((a != b).float().mean()))


def check_fused_kernels(FC, g):
    """Phase 17: fused_conv_fwd / fused_conv_bwd against their plain
    versions at the eight bottleneck shapes: bf16 at batch 128 (norm and
    ReLU), float32 at batch 8, and one identity case (no norm, no ReLU).
    Every output of a case is measured and printed before a miss raises.
    Returns ({kernel: max_abs_err f32}, {kernel: max_abs_err bf16})."""
    errs, errs16 = {}, {}
    runs = [(shape, torch.bfloat16, FC_BATCH, True) for shape in FC_SHAPES]
    runs += [(shape, torch.float32, FC_BATCH_F32, True)
             for shape in FC_SHAPES]
    runs.append((FC_SHAPES[0], torch.float32, FC_BATCH_F32, False))
    for (ci, co, hw), dtype, B, norm in runs:
        args = fc_case(g, B, ci, co, hw, dtype, norm)
        x, sc, sh, w, dz, ds, dss = args
        relu = norm
        got = FC._fwd_cuda(x, sc, sh, w, relu)
        want = FC.fused_fwd_reference(x, sc, sh, w, relu)
        z = want[0]
        gotb = FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss, relu)
        wantb = FC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss, relu)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        parts = [("fused_conv_fwd", n, a, b, near) for n, a, b, near in
                 zip(("z", "sum", "sumsq"), got, want, (True, False, False))]
        parts += [("fused_conv_bwd", n, a, b, near) for n, a, b, near in
                  zip(("dx", "dW", "dscale", "dshift"), gotb, wantb,
                      (True, False, False, False)) if norm or n in ("dx",
                                                                     "dW")]
        worst, shown, missed = {}, [], []
        for kname, name, a, b, near in parts:
            e = (a.float() - b.float()).abs().max().item()
            if f32 or not near:
                m = e
                limit = (REL_FC_NEAR if near else REL_FC_FAR) * \
                    b.float().abs().max().item()
                shown.append(f"{name} {e:.2e}/{limit:.2e}")
            else:
                m, share = bf16_ulps(a, b)
                limit = ULP_FC_BF16
                shown.append(f"{name} {m:.2f}/{limit:.0f} ulp, "
                             f"{share:.2e}/{SHARE_FC_BF16:.0e} differ")
                if not share <= SHARE_FC_BF16:
                    missed.append(f"{kname} {name}: {share} of the "
                                  f"elements differ > {SHARE_FC_BF16}")
            if not m <= limit:
                missed.append(f"{kname} {name}: {m} > {limit}")
            worst[kname] = max(worst.get(kname, 0.0), e)
        into = errs if f32 else errs16
        for kname in ("fused_conv_fwd", "fused_conv_bwd"):
            into[kname] = max(into.get(kname, 0.0), worst[kname])
        tag = "norm relu" if norm else "identity"
        log(f"  B{B} Ci {ci} Co {co} HW {hw} {str(dtype)[6:]} {tag}: " +
            ", ".join(shown))
        if missed:
            raise AssertionError(
                f"disagreement with the plain versions at B{B} "
                f"{(ci, co, hw)} {dtype}: {'; '.join(missed)}")
    return errs, errs16


def bn_chain(fused, bnss, x, w1, w3, g1, b1, g3, b3, cot):
    """x -> fused(conv1 W, identity) -> bn_scale_shift -> fused(conv3 W,
    norm + ReLU) -> bn_scale_shift -> a loss over z and both stats."""
    B, _, hw = x.shape
    z1, s1, ss1 = fused(x, None, None, w1, relu=False)
    sc1, sh1, _, _ = bnss(g1, b1, s1, ss1, B * hw)
    z3, s3, ss3 = fused(z1, sc1, sh1, w3, relu=True)
    sc3, sh3, _, _ = bnss(g3, b3, s3, ss3, B * hw)
    gz, a3, c3 = cot
    return ((z3.float() * gz).sum() + (sc3 * a3).sum() + (sh3 * c3).sum())


def run_bn_chains(FC, g):
    """Phase 18: the BN chain of each stage (conv1 then conv3 of a
    bottleneck, the 3x3 between them left out) in bf16 at batch 128,
    forward and backward through the autograd Function on the card, then
    through the plain versions. Returns (launches, {stage: {"max_rel":
    each gradient's largest error of its largest entry, "rel_l2": its
    relative L2 error}})."""
    stages = [(FC_SHAPES[i][0], FC_SHAPES[i][1], FC_SHAPES[i][2])
              for i in (0, 2, 4, 6)]
    inputs = []
    for ci, co, hw in stages:
        x = torch.randn(FC_BATCH, ci, hw, generator=g, device="cuda")
        x = torch.relu(x).bfloat16()          # a block's input: post-ReLU
        w1 = (torch.randn(co, ci, generator=g, device="cuda")
              * (2.0 / ci) ** 0.5).bfloat16()
        w3 = (torch.randn(ci, co, generator=g, device="cuda")
              * (2.0 / co) ** 0.5).bfloat16()
        gb = [torch.rand(n, generator=g, device="cuda") + 0.5
              for n in (co, ci)]
        bb = [torch.randn(n, generator=g, device="cuda") * 0.1
              for n in (co, ci)]
        cot = (torch.randn(FC_BATCH, ci, hw, generator=g, device="cuda"),
               torch.randn(ci, generator=g, device="cuda"),
               torch.randn(ci, generator=g, device="cuda"))
        inputs.append(((x, w1, w3, gb[0], bb[0], gb[1], bb[1]), cot))

    def grads(fused, leaves, cot):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        bn_chain(fused, FC.bn_scale_shift, *ts, cot).backward()
        return [t.grad.float() for t in ts]

    torch.cuda.synchronize()
    FC.reset_launches()
    got = [grads(FC.fused_scale_act_mm_stats, *inp) for inp in inputs]
    torch.cuda.synchronize()
    launches = {k: FC.LAUNCHES[k] for k in ("fused_conv_fwd",
                                             "fused_conv_bwd")}
    for k, n in launches.items():
        if n != 2 * len(stages):
            raise AssertionError(f"{k} launched {n} times over "
                                 f"{len(stages)} two-op chains")
    errs = {}
    names = ("x", "W1", "W3", "gamma1", "beta1", "gamma3", "beta3")
    for (ci, co, hw), inp, mine in zip(stages, inputs, got):
        want = grads(FC.fused_scale_act_mm_stats_plain, *inp)
        rel = {n: (a - b).abs().max().item() / b.abs().max().item()
               for n, a, b in zip(names, mine, want)}
        l2 = {n: ((a - b).norm() / b.norm()).item()
              for n, a, b in zip(names, mine, want)}
        log(f"  stage Ci {ci} Co {co} HW {hw}: max error / largest entry "
            f"and relative L2 of the gradients: " + ", ".join(
                f"{n} {rel[n]:.2e} {l2[n]:.2e}" for n in names))
        missed = [f"{n}: max {rel[n]} > {REL_FC_CHAIN}" for n in names
                  if not rel[n] <= REL_FC_CHAIN]
        for n, leaf in zip(names, inp[0]):
            limit = L2_CHAIN_BF16 if leaf.dtype == torch.bfloat16 \
                else L2_CHAIN_F32
            if not l2[n] <= limit:
                missed.append(f"{n}: relative L2 {l2[n]} > {limit}")
        if missed:
            raise AssertionError(f"BN chain gradients differ at "
                                 f"{(ci, co, hw)}: {'; '.join(missed)}")
        errs[f"{ci}x{co}x{hw}"] = {"max_rel": rel, "rel_l2": l2}
    return launches, errs


def fused_numbers(FC, args):
    """Phase 20: each kernel's time at one shape (bf16, batch 128), its
    bound, its plain version's and the library yardstick's (torch.matmul
    on the materialised activation plus sum and vector_norm squared of z,
    float32-accumulated, for the forward; the two torch.matmuls of the
    backward on the materialised dz_eff)."""
    x, sc, sh, w, dz, ds, dss = args
    B, ci, hw = x.shape
    co = w.shape[0]
    z = FC._fwd_cuda(x, sc, sh, w)[0]
    xn = torch.relu(x.float() * sc[:, None] + sh[:, None]).to(x.dtype)
    dzb = (dz.float() + ds[:, None] + 2.0 * z.float() * dss[:, None]).to(
        x.dtype)
    dz2 = dzb.transpose(0, 1).reshape(co, B * hw).contiguous()
    xn2 = xn.transpose(0, 1).reshape(ci, B * hw).contiguous()
    wt = w.t().contiguous()

    def lib_fwd():
        zz = torch.matmul(w, xn)
        return zz.sum((0, 2), dtype=torch.float32), torch.linalg.vector_norm(
            zz, dim=(0, 2), dtype=torch.float32).square()

    def lib_bwd():
        return torch.matmul(wt, dzb), torch.matmul(dz2, xn2.t())

    el = x.element_size()
    act, out = B * ci * hw * el, B * co * hw * el
    small = w.numel() * el + 8.0 * ci + 8.0 * co
    rows = {}
    for kname, flops, nbytes, kern, plain, lib in (
            ("fused_conv_fwd", 2.0 * B * co * ci * hw, act + out + small,
             lambda: FC._fwd_cuda(x, sc, sh, w),
             lambda: FC.fused_fwd_reference(x, sc, sh, w), lib_fwd),
            ("fused_conv_bwd", 4.0 * B * co * ci * hw,
             2 * act + 2 * out + small + 4.0 * co * ci + 8.0 * ci,
             lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss),
             lambda: FC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss),
             lib_bwd)):
        t_ops = flops / BF16_FLOPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        rows[kname] = {
            "case": f"B{B} Ci {ci} Co {co} HW {hw} bf16",
            "ms": device_ms(kern), "plain_ms": device_ms(plain, runs=10),
            "library_ms": device_ms(lib),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    del xn, dzb, dz2, xn2
    return rows


# ------------------------------------------------------- ResNet-50 (19)

def softmax_ce(logits, labels):
    """The bench's loss: float32 (or wider) log-softmax cross entropy."""
    lp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                         torch.float32)), -1)
    return -lp.gather(1, labels[:, None]).mean()


def resnet_trainer(device, num_classes, seed, compute_dtype):
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=num_classes, device=device,
                     generator=torch.Generator().manual_seed(seed))
    return SpmdTrainer(model, softmax_ce, fopt.momentum(R_LR, R_MU),
                       compute_dtype=compute_dtype, device=device,
                       generator=torch.Generator().manual_seed(seed))


def train_resnet(seed):
    """Phase 19: ResNet-50 at the bench configuration, R_STEPS steps on one
    batch. Returns (launches, losses, imgs/s, peak bytes, trainer,
    batch). The peak counts the trainer's own allocations: what earlier
    phases left on the card at its start is taken off."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    log(f"  {before / 2 ** 30:.3f} GiB allocated before the trainer")
    tr = resnet_trainer("cuda", R_CLASSES, seed, "bfloat16")
    rs = np.random.RandomState(seed)
    imgs = torch.from_numpy(rs.randn(R_BATCH, 3, R_IMG, R_IMG).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rs.randint(0, R_CLASSES, (R_BATCH,)).astype(
        np.int64)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from paddle_tpu_torch.ops import _build
    _build.reset_launches()
    losses = []
    for i in range(R_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.step((imgs,), labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches().items() if v}
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    return launches, losses, R_BATCH * (R_STEPS - 2) / wall, \
        torch.cuda.max_memory_allocated() - before, tr, ((imgs,), labels)


def profile_resnet(tr, batch, steps=2):
    """Phase 19b: two more steps under torch.profiler: the device's busy
    share and device ms per step by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler recorded no device time: breakdown not measured")
        return None
    groups = {"conv": 0.0, "gemm": 0.0, "reduce": 0.0, "elementwise": 0.0,
              "other": 0.0}
    for ms, _, key in rows:
        low = key.lower()
        grp = ("conv" if any(t in low for t in (
                   "conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit"))
               else "gemm" if any(t in low for t in (
                   "gemm", "cutlass", "nvjet", "xmma"))
               else "reduce" if "reduce" in low
               else "elementwise" if any(t in low for t in (
                   "elementwise", "vectorized", "unrolled"))
               else "other")
        groups[grp] += ms
    share = busy / (wall * 1e3)
    log(f"  profiled {steps} steps: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * share:.1f}%), idle {100 * (1 - share):.1f}%")
    log("  device ms per step by group: " + ", ".join(
        f"{k} {v / steps:.2f} ({100 * v / busy:.1f}%)"
        for k, v in groups.items()))
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return {"busy_share": share, "step_ms": wall * 1e3 / steps,
            "groups_ms_per_step": {k: v / steps for k, v in groups.items()}}


def resnet_card_vs_cpu(seed):
    """Phase 19c: one forward + backward of resnet50(num_classes=10) at
    2 x 3 x 64 x 64, the same weights and batch on the card and on the
    CPU, in float64 and in float32.

    float64 holds the port's code on the card to the CPU's: loss rtol
    F64_LOSS, gradients (relative L2) F64_GRAD, running stats (of each
    buffer's largest entry) F64_STATS. float32 cannot be held so close:
    at random init the step is ill-conditioned (in float64, perturbing
    every weight and pixel by half a float32 ulp moves the gradient by
    1.0e-2 relative L2 and the running stats by 1.2e-5,
    tools/probe_resnet_conditioning.py), so two correct float32 runs
    differ by about that much. The float32 loss agrees with the CPU's
    within rtol 1e-4; its gradients and running stats must lie within
    F32_GRAD / F32_STATS of the float64 result. The fp32 card
    convolutions rely on torch.backends.cudnn.allow_tf32 = False (set in
    main): in TF32 they would keep ~3 decimal digits."""
    rs = np.random.RandomState(seed + 1)
    imgs = rs.randn(2, 3, 64, 64).astype(np.float32)
    labels = rs.randint(0, 10, (2,)).astype(np.int64)
    res = {}
    for dev in ("cuda", "cpu"):
        tr = resnet_trainer(dev, 10, seed, None)
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads((imgs,), labels)
        res[dev, 32] = (float(loss), {n: g.cpu().double() for n, g in
                                      grads.items()},
                        {n: b.cpu().double() for n, b in tr.buffers.items()})
        model = resnet_trainer(dev, 10, seed, None).layer.double()
        loss = softmax_ce(model(torch.from_numpy(imgs).double().to(dev)),
                          torch.from_numpy(labels).to(dev))
        loss.backward()
        res[dev, 64] = (float(loss.detach()),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        {n: b.cpu() for n, b in model.named_buffers()})
        log(f"  {dev}: loss float32 {res[dev, 32][0]:.6f}, float64 "
            f"{res[dev, 64][0]:.15f} in {time.perf_counter() - t0:.2f} s")

    def rel_l2(a, b):
        num = sum(float((a[n] - b[n]).pow(2).sum()) for n in b)
        return (num / sum(float(b[n].pow(2).sum()) for n in b)) ** 0.5

    def stats_err(a, b):
        return max(float((a[n] - b[n]).abs().max() / b[n].abs().max())
                   for n in b)

    (l64, g64, b64), (l64c, g64c, b64c) = res["cuda", 64], res["cpu", 64]
    (l32, g32, b32), (l32c, g32c, b32c) = res["cuda", 32], res["cpu", 32]
    out = {"loss_rel_f64": abs(l64 - l64c) / abs(l64c),
           "grad_rel_l2_f64": rel_l2(g64, g64c),
           "stats_err_f64": stats_err(b64, b64c),
           "loss_rel_f32": abs(l32 - l32c) / abs(l32c),
           "grad_rel_l2_f32_card_f64": rel_l2(g32, g64c),
           "grad_rel_l2_f32_cpu_f64": rel_l2(g32c, g64c),
           "grad_rel_l2_f32_card_cpu": rel_l2(g32, g32c),
           "stats_err_f32_card_f64": stats_err(b32, b64c),
           "stats_err_f32_cpu_f64": stats_err(b32c, b64c)}
    log(f"  float64, card vs CPU: loss {out['loss_rel_f64']:.2e} (limit "
        f"{F64_LOSS}), gradients {out['grad_rel_l2_f64']:.2e} ({F64_GRAD}), "
        f"running stats {out['stats_err_f64']:.2e} ({F64_STATS})")
    log(f"  float32: loss card vs CPU {out['loss_rel_f32']:.2e} (limit "
        f"1e-4); gradients from float64: card "
        f"{out['grad_rel_l2_f32_card_f64']:.3e} (limit {F32_GRAD}), CPU "
        f"{out['grad_rel_l2_f32_cpu_f64']:.3e}, card vs CPU "
        f"{out['grad_rel_l2_f32_card_cpu']:.3e}; running stats from "
        f"float64: card {out['stats_err_f32_card_f64']:.3e} (limit "
        f"{F32_STATS}), CPU {out['stats_err_f32_cpu_f64']:.3e}")
    for key, limit in (("loss_rel_f64", F64_LOSS),
                       ("grad_rel_l2_f64", F64_GRAD),
                       ("stats_err_f64", F64_STATS), ("loss_rel_f32", 1e-4),
                       ("grad_rel_l2_f32_card_f64", F32_GRAD),
                       ("stats_err_f32_card_f64", F32_STATS)):
        if not out[key] <= limit:
            raise AssertionError(f"ResNet-50 card step: {key} {out[key]} > "
                                 f"{limit}")
    return out


def launch_counts():
    from paddle_tpu_torch.ops import _build

    return _build.launches()


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
    from paddle_tpu_torch.ops import fused_conv as FC
    from paddle_tpu_torch.ops import quant as Q

    # full float32 products and convolutions: the fp32 card-vs-CPU checks
    # (phases 11 and 19) rely on it, TF32 keeps ~3 decimal digits
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
        f"{ATOL_KERNEL}; bf16 {REL_BF16_ATT} of the largest plain entry)")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    errs, fwd, dec = check_kernels(A, g)
    new_cases = new_kernel_cases(g)
    new_errs, new_errs16 = check_new_kernels(A, new_cases)

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
    kernels = {}
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
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["case"],
            "launches_per_token": launches[kname] / n_tok, "cases": rows}
    profile_serving(engine, served[3], served[4])
    model, embed, project, memory = served[0], served[1], served[2], \
        served[4]

    log(f"phase 5: dense speculative serve, spec_k {SPEC_K}, {SLOTS} "
        f"requests with a {PERIOD}-token period")
    s_launches, s_snap, s_rate = spec_serve(A, args.seed, model, embed,
                                            project, engine, memory)

    log(f"phase 6: paged serve, page {PAGE}, {REQUESTS} requests with a "
        f"{PREAMBLE}-token shared preamble; then with spec_k {SPEC_K}")
    p_launches, p_snaps, p_rates, p_tokens, p_prompts, p_mems = paged_serve(
        A, args.seed, model, embed, project, engine, memory[0])

    log("phase 7: int8 pages, 4 requests")
    int8 = int8_serve(A, model, embed, project, p_prompts, p_mems, p_tokens)

    log("phase 8: timing of flash_verify, paged_flash_decode and "
        "paged_flash_verify (median of 25, ms)")
    new_launches = {
        "flash_verify": s_launches["flash_verify"],
        "paged_flash_decode": p_launches["paged"]["paged_flash_decode"],
        "paged_flash_verify": p_launches["paged"]["paged_flash_verify"]
        + p_launches["paged_spec"]["paged_flash_verify"]}
    timed = {"flash_verify": ("spec step b8 h8 T4 L1060 fp32",),
             "paged_flash_decode": ("decode S8 h8 mp67 pages fp32",
                                    "decode S8 h8 mp67 pages int8"),
             "paged_flash_verify": ("spec step S8 h8 T4 mp67 pages fp32",
                                    "tail prefill S8 h8 T256 mp67 pages "
                                    "fp32")}
    sources = {"flash_verify": ("flash_verify.cu", 1580),
               "paged_flash_decode": ("paged_decode.cu", 1750),
               "paged_flash_verify": ("paged_verify.cu", 1939)}
    for kname, cnames in timed.items():
        rows = []
        for cname in cnames:
            nums = read_numbers(A, kname, new_cases[kname][cname])
            rows.append(dict(case=cname, **nums))
            log(f"  {kname} {cname}: kernel {nums['ms']:.4f} (with combine "
                f"{nums['with_combine_ms']:.4f}) bound {nums['bound_ms']:.4f}"
                f" ({nums['bound_by']}) plain {nums['plain_ms']:.4f} sdpa "
                f"{nums['library_ms']:.4f}")
        head = rows[0]
        src, line = sources[kname]
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/attention.py:{line}",
            "launches": new_launches[kname],
            "max_abs_err": new_errs[kname],
            "max_abs_err_bf16": new_errs16.get(kname),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "cases": rows}
    kernels["paged_flash_verify"]["launches_by_path"] = {
        "paged": p_launches["paged"]["paged_flash_verify"],
        "paged_spec": p_launches["paged_spec"]["paged_flash_verify"]}
    serving = {"dense_tokens_per_s": n_tok / wall,
               "spec_tokens_per_s": s_rate,
               "spec_acceptance_rate":
                   s_snap["speculation"]["acceptance_rate"],
               "paged_tokens_per_s": p_rates["paged"],
               "paged_spec_tokens_per_s": p_rates["paged_spec"],
               "paged_prefix": p_snaps["paged"]["prefix"],
               "int8_tokens_equal_fp32": int8["agree"]}
    log(f"  serving summary {json.dumps(serving)}")
    # the serving engines hold reference cycles (engine <-> layout): free
    # their pools now, so the training phases' peak memory is their own;
    # the source memories wait on the host for phases 14-15
    mt_memory = memory.cpu()
    del served, engine, model, embed, project, memory, new_cases
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 9: training kernels against their plain versions at the "
        "ERNIE-base shapes")
    t_errs, t_errs16, t_case = check_train_kernels(A, g)

    log(f"phase 10: train ERNIE-base, {E_STEPS} steps of {E_BATCH} x "
        f"{E_SEQ} tokens, bf16 compute, dropout {E_DROPOUT}")
    t_launches, losses, seq_s, peak, tr, batch = train(A, args.seed)
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  {seq_s:.2f} seq/s over the last {E_STEPS - 2} steps; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB; launches {t_launches}")
    prof = profile_training(tr, batch)
    del tr, batch
    torch.cuda.empty_cache()

    log("phase 11: one fp32 step of a 2-layer full-width model on the card "
        "and on the CPU (attention dropout 0.1)")
    card_vs_cpu_step(args.seed)

    log("phase 12: timing of the training kernels (bf16, median, ms)")
    t_rows = train_numbers(A, t_case)
    kernels["flash_fwd"]["cases"].append(dict(
        case="train b8 h12 s1024 d64 bf16 bias dropout 0.1",
        **t_rows["flash_fwd"]))
    by_path = {"serve": launches["flash_fwd"],
               "spec": s_launches["flash_fwd"],
               "paged": p_launches["paged"]["flash_fwd"],
               "paged_spec": p_launches["paged_spec"]["flash_fwd"],
               "train": t_launches["flash_fwd"]}
    kernels["flash_fwd"]["launches_by_path"] = by_path
    kernels["flash_fwd"]["launches"] = sum(by_path.values())
    kernels["flash_fwd"]["max_abs_err"] = max(errs["flash_fwd"],
                                              t_errs["flash_fwd"])
    for kname, line in (("flash_bwd_dq", 591), ("flash_bwd_dkv", 721)):
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": f"paddle_tpu/ops/attention.py:{line}",
            "launches": t_launches[kname], "max_abs_err": t_errs[kname],
            "max_abs_err_bf16": t_errs16[kname],
            "shape": "train b8 h12 s1024 d64 bf16 bias dropout 0.1",
            "library_scope": "sdpa forward + backward",
            "plain_scope": "flash_attention_bwd_plain (dq, dk, dv)",
            **t_rows[kname]}
    busy = "not measured" if prof is None else \
        f"{100 * prof['busy_share']:.1f}%"
    log(f"  training: {seq_s:.2f} seq/s, peak {peak / 2 ** 30:.2f} GiB, "
        f"device busy {busy}")
    del t_case
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 13: int8_matmul and lora_gather against their plain versions "
        f"(fp32 {REL_F32_QUANT} and bf16 {REL_BF16_ATT} of the largest plain "
        f"entry)")
    q_errs, q_errs16, i8_cases, lo_cases = check_quant_kernels(Q, g)

    log(f"phase 14: multi-tenant dense serve, {MT_TENANTS} tenants (rank "
        f"{MT_RANK}, capacity {MT_TENANTS + 1}), {MT_REQUESTS} requests over "
        f"{SLOTS} slots: (a) fp32, (b) quantize='int8'")
    mt = mt_dense_serve(Q, args.seed, mt_memory)

    log("phase 15: multi-tenant paged serve (page 16, fp32 pages), then "
        f"with spec_k {SPEC_K}")
    mp_launches, mp_snaps = mt_paged_serve(Q, args.seed, mt, mt_memory[0])

    log("phase 16: timing of int8_matmul and lora_gather (median of 25, ms)")
    by_path = {"mt_fp32": mt["fp32_launches"], "mt_int8": mt["int8_launches"],
               **mp_launches}
    for kname, cases, head, line in (
            ("int8_matmul", i8_cases, "m8 512x37000", 116),
            ("lora_gather", lo_cases, "b8 s1 512x2048", 243)):
        rows = []
        for cname, inputs in cases.items():
            if "bf16" in cname:
                continue
            nums = quant_numbers(Q, kname, inputs)
            rows.append(dict(case=cname, **nums))
            log(f"  {kname} {cname}: kernel {nums['ms']:.4f} bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}) plain "
                f"{nums['plain_ms']:.4f} library {nums['library_ms']:.4f}")
        top = next(r for r in rows if r["case"] == head)
        paths = {p: c[kname] for p, c in by_path.items() if c[kname]}
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": f"paddle_tpu/ops/quant.py:{line}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": q_errs[kname],
            "max_abs_err_bf16": q_errs16.get(kname),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "shape": head,
            "library_scope": ("torch.matmul on the dequantized weight"
                              if kname == "int8_matmul" else
                              "torch.bmm x2 on the gathered banks"),
            "cases": rows}
    prompts, names, mems = mt["prompts"], mt["names"], mt["mems"]
    profile_pass(mt["int8_engine"], prompts[:SLOTS], mems[:SLOTS],
                 ("int8_matmul", "lora_gather", "flash_fwd_kernel",
                  "flash_decode_kernel"), adapters=names[:SLOTS])
    log("  multi-tenant summary " + json.dumps({
        "fp32_tokens_per_s": mt["fp32_rate"],
        "int8_tokens_per_s": mt["int8_rate"],
        "int8_token_agreement": mt["agreement"],
        "int8_weight_shrink": mt["shrink"],
        "merged_weight_ties": mt["ties"],
        "paged_prefix": {p: s["prefix"] for p, s in mp_snaps.items()}}))
    del mt, prompts, names, mems, i8_cases, lo_cases
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 17: fused_conv_fwd and fused_conv_bwd against their plain "
        f"versions at ResNet-50's bottleneck shapes (fp32 z / dx "
        f"{REL_FC_NEAR}, stats / dW / dscale / dshift {REL_FC_FAR} of the "
        f"largest plain entry; bf16 z / dx {ULP_FC_BF16:.0f} bf16 ulp of "
        f"each element; error/limit)")
    fc_errs, fc_errs16 = check_fused_kernels(FC, g)

    log(f"phase 18: the BN chain of each stage (bf16, batch {FC_BATCH}): "
        "kernels against the plain versions, forward and backward")
    fc_launches, chain_errs = run_bn_chains(FC, g)
    log(f"  launches {fc_launches}")

    log(f"phase 19: train ResNet-50, {R_STEPS} steps of {R_BATCH} x 3 x "
        f"{R_IMG} x {R_IMG}, bf16 compute, momentum({R_LR}, {R_MU})")
    r_launches, r_losses, imgs_s, r_peak, r_tr, r_batch = train_resnet(
        args.seed)
    log(f"  losses {[round(x, 4) for x in r_losses]}")
    log(f"  {imgs_s:.2f} imgs/s over the last {R_STEPS - 2} steps; peak "
        f"device memory {r_peak / 2 ** 30:.2f} GiB; launches of the ported "
        f"kernels {r_launches} (the model runs none: its convolutions are "
        f"cuDNN's, as the JAX model's are XLA's)")
    r_prof = profile_resnet(r_tr, r_batch)
    del r_tr, r_batch
    gc.collect()
    torch.cuda.empty_cache()
    log("  one fp32 step of resnet50(num_classes=10) at 2 x 3 x 64 x 64 on "
        "the card and on the CPU")
    r_check = resnet_card_vs_cpu(args.seed)
    busy = "not measured" if r_prof is None else \
        f"{100 * r_prof['busy_share']:.1f}%"
    log(f"  ResNet-50: {imgs_s:.2f} imgs/s, peak {r_peak / 2 ** 30:.2f} "
        f"GiB, device busy {busy} ({card})")

    log("phase 20: timing of fused_conv_fwd and fused_conv_bwd (bf16, "
        f"batch {FC_BATCH}, median, ms)")
    fc_rows = {"fused_conv_fwd": [], "fused_conv_bwd": []}
    g20 = torch.Generator(device="cuda").manual_seed(args.seed + 20)
    for ci, co, hw in FC_SHAPES:
        case = fc_case(g20, FC_BATCH, ci, co, hw, torch.bfloat16)
        for kname, row in fused_numbers(FC, case).items():
            fc_rows[kname].append(row)
            log(f"  {kname} {row['case']}: kernel {row['ms']:.4f} bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']}) plain "
                f"{row['plain_ms']:.4f} library {row['library_ms']:.4f}")
    for kname, line in (("fused_conv_fwd", 66), ("fused_conv_bwd", 123)):
        head = fc_rows[kname][0]
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": f"paddle_tpu/ops/fused_conv.py:{line}",
            "launches": fc_launches[kname],
            "launches_by_path": {"bn_chain": fc_launches[kname]},
            "max_abs_err": fc_errs[kname],
            "max_abs_err_bf16": fc_errs16[kname],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "library_scope": (
                "torch.matmul on the materialised act(x * scale + shift) "
                "plus z.sum and vector_norm(z) ** 2, float32-accumulated" if kname == "fused_conv_fwd"
                else "the two torch.matmul of the backward on the "
                     "materialised dz_eff and activation"),
            "cases": fc_rows[kname]}
    log("  vision summary " + json.dumps({
        "resnet50_imgs_per_s": imgs_s, "resnet50_peak_gib": r_peak / 2 ** 30,
        "resnet50_busy_share": None if r_prof is None
        else r_prof["busy_share"],
        "resnet50_groups_ms_per_step": None if r_prof is None
        else r_prof["groups_ms_per_step"],
        "resnet50_losses": r_losses, "card_vs_cpu": r_check,
        "bn_chain_worst_rel": chain_errs}))

    log("phase 21: output")
    kernels = list(kernels.values())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
