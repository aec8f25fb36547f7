#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA
H100.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits nonzero before the result lines:
 1. Device: the card's name and power limit (nvidia-smi) and the build
    time of the hand-written CUDA kernels (paddle_tpu_torch/csrc); the
    HGMMA (wgmma) instructions in the SASS of flash_fwd, flash_bwd_dq,
    flash_bwd_dkv, fused_conv_fwd, fused_conv_bwd and int8_matmul, and
    the HMMA (TF32 mma.sync) of flash_fwd's float32 kernels
    (`cuobjdump -sass`; none fails the phase), and ptxas's registers and
    spills of their tensor-core kernels and of every instance of the
    four kernels on attn_merge.cuh.
 2. Each kernel against its plain PyTorch version on the card, at the
    shapes the serving paths give it: flash_fwd (fp32 on the tensor
    cores as 3xTF32: the four serving shapes on their routes, and the
    short-query route at 2, 5 and 16 rows over 256 keys, 1 row over 200
    and 16 causal rows over 1000, each launch counted on the route the C
    rule gives; its one-TF32-pass mutant, `testing.flash_fwd_split` with
    pieces=1 computed on the card, must be refused by the same limit at
    every case) and flash_decode (b8 h8 L1056 ragged, fp32 and bf16, and
    a row with no written key beside a -1e30 hole over the first split);
    flash_verify at b8 h8 T4 L1060 (the speculative pool's
    verify step), fp32 and bf16, ragged lengths, a key-bias hole, and
    the same with NaN keys and values past each row's length (a rejected
    draft's stale block), which must give the same bits;
    paged_flash_decode (T 1; also a slot with no written key and a -1e30
    hole over every slot's first split) and paged_flash_verify (T 4, the
    paged speculative step on the split route, and T 256, a prefix hit's
    tail prefill on the tiled route) at S8 h8 page 16 mp67 over a shuffled
    page table with trash and unmapped entries, pages fp32, bf16 and int8
    with scales; the tiled route also at the tail prefills phase 6 gives
    it (S1 h8 T64, T256, T512 over the width-clipped row of W = 32 + T/16
    pages; int8 and bf16 pages at T256), a slot with n_valid == T, and a
    -1e30 bias over the first two key tiles. Limits: fp32 output
    (fp32, bf16 or int8 pages under an fp32 query: the dequant is the
    same arithmetic on both sides) atol 2e-5; bf16 output 1e-2 of the
    plain version's largest entry. The four kernels that merge their key
    splits in the kernel (flash_decode, flash_verify, paged_flash_decode
    and the split route) must also launch once a call, give the same bits
    on every call, and agree with their kernel-order emulation
    (`testing.flash_decode_in_kernel`, `flash_verify_in_kernel`,
    `paged_verify_in_kernel`) within the same limits.
 3. Serve Transformer-base (d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
    vocab 37000; random weights from --seed) through ServingServer: 16
    requests over 8 slots, source memories of 256 tokens encoded on the
    card by the port's TransformerEncoder, prompts of 300-1000 tokens,
    32 new tokens each. The kernels' launch counters are zeroed just
    before and read just after; both must have grown, every flash_fwd
    launch on a float32 tensor-core route (counted by the C rule
    `pt_flash_fwd_route`; phases 5, 6, 14 and 15 check the same). Two requests are
    re-run on the CPU through the plain versions: prefill logits agree
    within atol 1e-3, and greedy tokens agree up to the first position
    where the CPU's top-2 logit gap is below 1e-3.
 4. Timing at the phase-3 shapes (CUDA events, median of 25 runs, each
    queued behind a device sleep so host overhead is not timed): the
    kernel, its bound on the card (published H100 SXM peaks: 3.35 TB/s,
    67 TFLOP/s fp32; for flash_fwd both the tensor-core bound of its 3
    TF32 products at 495 TFLOP/s, its bound_ms, and the CUDA-core bound
    of the same function, with the share of the tensor-core bound the
    kernel reaches), the plain version, and
    torch.nn.functional.scaled_dot_product_attention as a yardstick only
    (the port never calls it). The decode's time is its whole call (one
    launch: its key splits merge in the kernel), whose device kernels
    (torch.profiler, 5 calls) must be flash_decode_kernel alone. Then a
    second pass of 8 requests under torch.profiler: device time by kernel
    and the device's busy share.
 5. Dense speculative serve: ServingEngine(spec_k=4) with the phase-3
    weights, 8 requests whose prompts repeat a seeded 16-token period
    (300-1000 tokens), 32 new tokens, through ServingServer. Tokens equal
    the phase-3 plain dense engine's on the same requests (a mismatch
    passes only where the phase prints the first diverging step and a
    top-2 logit margin below 1e-4 there, teacher-forced on the card).
    Prints the acceptance rate, the effective k and tokens/s;
    flash_verify must have launched. Then a profiled pass of 8 more such
    requests through the same engine: the device's busy share, and one
    launch of flash_verify_kernel a flash_verify call (no combine after
    it).
5b. Rollback: the dense and the paged spec engines (spec_k=4,
    spec_adapt_low=0.9, spec_adapt_patience=1) on 8 requests of random
    (not periodic) prompts, every other one with `spec = False`, through
    Scheduler and serve_until_idle. Tokens equal the phase-3 dense
    engine's (or a sub-1e-4 tie, as in phase 5); each engine must have
    had a round with a `spec = False` row active and rolled a verify
    block back (a row kept fewer than spec_k of its block), so later
    verify steps ran over rejected keys past n_valid. Prints those
    counts, wasted_draft_tokens and k_shrink_events.
 6. Paged serve: ServingEngine(paged=True, page_size=16, num_slots=8,
    max_len=1056) through ServingServer, fp32 pages, 16 requests of a
    seeded 512-token shared preamble plus a distinct 32-480-token tail
    (one source memory, so the radix prefix cache matches the preamble).
    Tokens equal the dense engine's request for request (or a sub-1e-4
    tie, as in phase 5); at least one partial prefix hit (the tail
    prefill through paged_flash_verify at T up to 512); the allocator
    clean after the drain and every page free after a prefix flush.
    Then the same with spec_k=4. Both paged kernels must have launched;
    every tail prefill (one a partial hit and decoder layer, T > 4) on
    paged_flash_verify's tiled route and every speculative step (one a
    round and layer, T 4) on its split route, counted by route; a
    profiled pass of 8 more requests through each engine gives the
    device's busy share, and one launch of the decode kernel a decode
    call (paged) and of the split kernel a split-route call (paged +
    spec).
 7. int8 pages: kv_dtype="int8", 4 of the phase-6 requests; token
    agreement with the fp32 pages is printed, not asserted.
 8. Timing of flash_verify (fp32 and bf16), paged_flash_decode and
    paged_flash_verify at the phase-5/6 shapes: kernel and whole call
    (each writes its output, one launch but on the tiled route), the
    bytes / operations bound (the output counted in q's type), the plain
    version, and SDPA on the pre-gathered dense K/V with the equivalent
    mask (a yardstick; the gather is not timed), with the device kernels
    SDPA runs (torch.profiler). The paged verify also at the tail prefills of
    phase 6 (S1 h8 T64, T256 and T512 over W = 32 + T/16 pages). The
    dense verify, the paged decode and the split route are one launch a
    call (their key splits merged in the kernel): the device kernels of a
    call (torch.profiler, 5 calls) must be the kernel alone.
 9. Training kernels at the ERNIE-base shapes (b8 h12 s1024 d64, a -1e4
    pad bias over ragged lengths, attention dropout 0.1 on the logical
    512 x 512 blocks; and phase 25's pretraining micro-batch, b8 h12 s512
    d64, a key bias of zeros, one 512 x 512 dropout block a row):
    flash_fwd with dropout, flash_bwd_dq and flash_bwd_dkv against their
    plain versions on the same inputs, fp32
    (atol 2e-5 for the forward, 1e-4 for the gradients, 1e-3 for dbias)
    and bf16 (the output and lse within 1e-2 of the plain output's
    largest entry, about one bf16 rounding step; the output also against
    `testing.flash_fwd_tiled`, the plain version rounding p where the
    kernel does, and dq, dk and dv against the plain backward: every
    element within one bf16 ulp of the largest entry, at most 1% of the
    elements differing, relative L2 error at most 1e-3, since the bf16
    kernels sum on the tensor cores in another order; dbias 1e-3 of its
    largest entry).
10. Train ERNIE-base (hidden 768, 12 layers, 12 heads, FFN 3072, GELU,
    vocab 30522, max_position 1026, 2 classes; hidden and attention
    dropout 0.1; bf16 compute on fp32 masters; AdamW lr 5e-5, weight
    decay 0.01; random weights from --seed) through SpmdTrainer for 12
    steps on one batch of 8 x 1024 tokens with a ragged 1/0 attention
    mask. The launch counters are zeroed just before and read just
    after: each training kernel must have run 12 layers x 12 steps
    times, every flash_fwd launch on the tensor cores (the bf16 route),
    and every loss must be finite. Reports seq/s over the last 10
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
    (forward alone for flash_fwd; its backward alone for the backward
    kernels, whose sum it compares with: one forward outside the timer,
    then torch.autograd.grad with the graph kept; forward + backward is
    printed beside it).
13. int8_matmul and lora_gather against their plain versions on the card:
    int8_matmul at m 8, 32 and 1024 (a decode step, a 4-token verify
    step, a prompt bucket) on every (d, n) of the decoder and the
    vocabulary projection (512x512, 512x2048, 2048x512, 512x37000),
    plus a bf16 x at m 8 and 1024; lora_gather at b 8 s 1, b 8 s 4 and b
    1 s 1024 on 512x512, 512x2048 and 2048x512, rank 8, capacity 5, ids
    mixing the base row 0 and every tenant. Limits: fp32 1e-5 of the
    plain version's largest entry (sums over d <= 2048 in another
    order), bf16 1e-2. At every float32 case (both routes run on the
    tensor cores with x in three bf16 pieces: the skinny route at m 8
    and 32, the tiled route at m 1024) the one-piece mutant (a bf16 x,
    `testing.int8_matmul_split` with pieces=1, computed on the card) must
    be refused by the same limit.
14. Multi-tenant dense serve at the phase-3 width and weights: an
    AdapterPool of 4 tenants (`register_random(seed=100+i, scale=0.05)`,
    rank 8, capacity 5; `bench.py` `_serving_multitenant`), 8 slots, 16
    requests (4 a tenant, prompts of 300-1000 tokens, 32 new tokens)
    through ServingServer. (a) fp32 base: tokens equal, request for
    request, those of a solo fp32 engine per tenant whose target weights
    hold the tenant's `merged_weights` (a divergence passes only with a
    top-2 margin below 1e-4 there, as in phase 5). (b) quantize="int8":
    token agreement with (a) at least 0.8 and weights at least 1.9x
    smaller. (c) quantize="int8" with spec_k=4 on the dense pool, 8 of
    the (b) requests: tokens equal (b)'s (or a sub-1e-4 top-2 tie under
    the tenant's adapter); the verify step runs the skinny int8 route at
    m 32. The launch counters are zeroed before each serve; lora_gather
    (a, b, c) and int8_matmul (b, c) must have grown. Prints the tenancy
    section, tokens/s and the p50 TTFT, and for (c) int8_matmul's
    launches by path and the skinny launches by (m, d, n).
15. Multi-tenant paged serve: the phase-6 preamble requests split across
    two tenants and the base, paged=True, page 16, fp32 pages, then with
    spec_k=4; tokens equal the dense multi-tenant engine's (or a sub-1e-4
    tie under the tenant's adapter). The prefix trie must hold exactly
    three scopes (two tenants and the base), each entered by a miss, so
    no hit crossed tenants; allocator clean, AdapterPool.check() passes
    and no row pinned after the drain; the paged verify's routes as in
    phase 6.
16. Timing of int8_matmul and lora_gather at the phase-13 shapes: kernel,
    bound (published H100 SXM peaks: fp32 67 TFLOP/s, 3.35 TB/s; for the
    tiled int8 path the tensor-core bound of its 3 bf16 passes at 989
    TFLOP/s beside the CUDA-core bound, the share and its k-splits),
    plain version, and the library yardstick (torch.matmul on the dequantized
    weight; torch.bmm twice on the gathered banks; the port never calls
    either); lora_gather's plan (rows a tile, CTAs a cluster, CTAs in
    all); the skinny route's plan (8-row tiles, k-splits a cluster,
    warps a block) and the device kernels of a call (the skinny kernel
    alone). Then
    a profiled pass of 8 requests through the int8 + LoRA engine: the
    device's busy share, device time by kernel, and int8_matmul's skinny,
    tiled and reduce kernels apart (no more reduce launches than tiled
    ones: the skinny route has no second pass).
17. fused_conv_fwd and fused_conv_bwd (the fused 1x1-conv + BN op)
    against their plain versions at ResNet-50's bottleneck shapes, conv1
    and conv3 of each stage: (Ci, Co, HW) = (256, 64, 3136), (64, 256,
    3136), (512, 128, 784), (128, 512, 784), (1024, 256, 196), (256,
    1024, 196), (2048, 512, 49), (512, 2048, 49); bf16 at batch 128 with
    norm and ReLU, float32 at batch 8, one float32 identity case, one
    bf16 x with a float32 W at (256, 64, 3136); stats cotangents nonzero.
    Limits, of the plain version's largest entry: float32 z and dx 1e-5,
    the stats, dW, dscale and dshift 1e-4 (sums over up to 401,408
    positions in another order; float32 outputs in the bf16 runs too);
    bf16 z and dx `testing.judge_bf16_sum`: each element within one bf16
    ulp plus 2^-20 of its sum of |products| (`fused_conv_abs_sums`), at
    most 1% of the elements differing (the tensor-core products sum in
    another float32 order than the plain version's GEMM). At every bf16
    shape the plain versions with xn or dz_eff left unrounded (mutants,
    computed on the card) must be refused, and their readings are
    printed. Each launch counts the routes the C rules give (the
    forward's product and dx on wgmma for a bf16 x and W, dW for any
    bf16 x; the rest SIMT).
18. The BN chain of each stage at batch 128, bf16: x -> fused(conv1 W)
    -> bn_scale_shift -> fused(conv3 W, norm + ReLU) -> bn_scale_shift ->
    a loss over z and both stats, forward and backward through the
    autograd Function (the kernels). Limits: each gradient within 1e-2
    of its largest entry and within 1e-3 (bf16 x, W) or 1e-5 (float32
    gamma, beta) relative L2, against the chain through the plain
    versions for W3, gamma3 and beta3 (the gradients no ReLU mask of
    conv3 moves: a z one ulp off at that threshold turns a masked
    gradient on or off), and against the plain backward at the kernels'
    forward values for all of them. The plain forward summed in float64
    must pass the first limits and the plain versions with unrounded
    operands must be refused by them at every stage; every reading is
    printed (`run_bn_chains`). The launch counters are zeroed just before
    the kernel run and read just after: two of each kernel a chain, the
    product of every fused_conv_fwd launch and the dx and dW of every
    fused_conv_bwd launch on the tensor cores.
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
    torch.matmul on the materialised dz_eff; the port never calls them);
    and the backward's split into its dx half (the dx kernel and the
    dscale / dshift sum) and its dW half, from the device rows of a
    torch.profiler run of five calls.
21. The segment branch of flash_fwd, flash_bwd_dq and flash_bwd_dkv
    against their plain versions (phase 9's limits) on a 16-case small
    grid (fp32 and bf16, causal, bias, dropout), a case whose key ids
    differ from the query's and the packed 12 x h12 x 1024 bf16 case;
    then fresh q, k, v and dO in the even segments must leave the odd
    segments' output, dq, dk and dv bitwise unchanged.
22. ERNIE-base 12 steps on `bench.py`'s 16 varlen sequences, padded (16
    rows with a mask) and packed (`pack_padded`, 12 rows): every loss
    finite, segment-branch launches 144 packed and 0 padded, every
    flash_fwd launch on the tensor cores, no bf16 forward or backward
    launch copying by element; seq/s, peak memory, and two profiled
    steps each (busy share, device ms by group).
23. A 2-layer full-width ERNIE at dropout 0 in float32: each sequence's
    logits from the packed rows within 1e-4 of the largest |logit| of
    its padded logits.
24. Timing of the segment branch at the packed shape (bf16, dropout):
    kernel, bound over the same-segment pairs, plain version, SDPA with
    the dense boolean mask (forward for flash_fwd, backward alone for the
    backward kernels), and the 64 x 64 tiles that `seg_window`'s rule
    visits, counted on the host from the ids (a log line only).
25. ERNIE-base pretraining: ErnieForPretraining(ErnieConfig.base())
    (12 layers, hidden 768, 12 heads, FFN 3072, vocabulary 18000, 513
    positions, dropout 0.1; random weights from --seed), bf16 compute on
    float32 masters, through SpmdTrainer with grad_accum=4 on one batch
    of 32 x 512 (micro-batches of 8 x 512; 15% of the positions masked,
    random NSP labels, from --seed), the masked-position cross-entropy
    plus the NSP cross-entropy, and the eager AdamW of the ERNIE / BERT
    recipe: LinearWarmup(PolynomialDecay(1e-4, 100), 4 updates),
    ClipGradByGlobalNorm(1.0), no decay on biases and norms. (a) 12
    updates with remat on, then off: every loss finite, seq/s over
    updates 3-12, peak memory; remat must not raise the peak. (b) The
    launch counters, zeroed just before each run and read just after:
    dq and dk/dv 12 layers x 4 micro-batches x 12 updates, the forward as
    many (twice under remat), every launch on the tensor cores. (c) One
    profiled update (busy share, device ms by group), then one optimizer
    step profiled on three paths (the trainer's update, the eager AdamW's
    multi-tensor step and its per-parameter path): device kernels, device
    ms and host ms. (d) The multi-tensor step and the per-parameter path
    on two copies of the parameters, 3 updates of the same gradients:
    parameters and slots equal bit for bit. (f) `run_epoch` against a
    loop of `step` over 4 host batches, ms an update (loop, run_epoch,
    loop; printed, losses finite). (e) A 2-layer full-width model in
    float32 on the card and on the CPU: losses rtol 1e-4, gradients and
    the parameters after two updates within 1e-4 relative L2, the two
    updates themselves within 1e-3.
26. DecodeEngine at Transformer-base width (random weights from --seed),
    b8 with ragged prompts in the 64 bucket, 32 new tokens. (a) Greedy:
    tokens equal `generate_eager`'s on the card (a divergence passes only
    at a top-2 logit margin below 1e-4, as in phase 5), flash_decode
    launches = 6 layers x decode steps; ms a token. (b) Beam 4: tokens/s,
    and the regather of the 12 cache tensors by beam parent timed alone;
    then a 2-layer full-width model on the card and on the CPU: the same
    tokens and lengths, or a tie (the row's scores still agree), scores
    within 1e-4 relative. (c) spec_k 4 with the n-gram draft, then with a
    2-layer DraftModel of other weights: tokens equal (a)'s (tie rule),
    flash_verify launches = 6 x rounds, the draft's flash_decode launches
    = 2 x 4 x rounds; the DraftModel's acceptance must be below 1.0 (the
    card rolls back rejected drafts).
27. Chunked prefill: dense and paged (page 16) engines, 8 slots, 4
    prompts of 1024 tokens among 12 of 16-200, prefill_chunk 256,
    through ServingServer: tokens equal the same engines without
    chunking (tie rule); 16 chunks, and 96 verify launches at T 256
    (dense flash_verify; paged: the tiled route); decode-step gap p50 /
    p99 with and without chunking (printed). Then flash_verify at b1 h8
    T64 and T256, L 1056, fp32 and bf16, against its plain version
    (phase 2's limits), timed beside SDPA.
28. Preemption: a paged engine (page 16) under ShapingScheduler, 8
    batch-class requests of 512 tokens and 64 new tokens fill the slots,
    then 8 interactive ones arrive; a FIFO twin serves the same arrivals
    unpreempted; spec_k off and 4. Preemptions == resumes >= 1, replayed
    tokens > 0, tokens equal the twin's (tie rule), prefills at most the
    16 cold prompts, the allocator's check passes and every page returns
    after a prefix flush; interactive TTFT p50 / p99 against the twin
    (printed). The three phases' wall time is printed.
29. Output: a {"kernels": [...]} line for all eleven kernels (the
    attention kernels' launches summed over every serving path, phases
    3, 5, 5b, 6, 14, 15 and 26-28, and over the training paths, phases
    10, 22 and 25), then the card's name and power limit, then {"ok":
    true, "device": {...}} as the last line.
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
TF32_FLOPS_PER_S = 495e12     # H100 SXM, dense tensor cores, published
# the float32 kernels on the tensor cores take each product in 3 pieces
# (flash_fwd: 3xTF32; int8_matmul's tiled path: x in 3 bf16 pieces)
SPLIT_PIECES = 3
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
# bf16 limits of phases 9 and 21, as fractions of the plain version's
# largest entry: the flash output 1e-2 (about one bf16 rounding step), the
# float32 dbias 1e-3
REL_BF16_OUT, REL_BF16_DBIAS = 1e-2, 1e-3
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
# bf16 z or dx is held to `paddle_tpu_torch.testing.judge_bf16_sum`
# (ULP_FC_BF16, SUM_FC_BF16, SHARE_FC_BF16 there)
REL_FC_NEAR, REL_FC_FAR = 1e-5, 1e-4
# the BN chains (phase 18): each gradient's largest error within 1e-2 of
# its largest entry, and its relative L2 error within 1e-3 for the bf16
# leaves (x, W1, W3) and 1e-5 for the float32 ones (gamma, beta). Against
# the chain through the plain versions these limits hold the gradients
# that no ReLU mask of conv3 moves (CHAIN_FLIP_FREE); x, W1, gamma1 and
# beta1 lie past conv3's ReLU, where a z one ulp off at the threshold
# (phase 17's limit allows it) turns a masked gradient on or off, as a
# correct plain forward summed in float64 does too (phase 18 prints both
# readings). Against the plain backward at the kernels' forward values
# they hold every gradient
REL_FC_CHAIN, L2_CHAIN_BF16, L2_CHAIN_F32 = 1e-2, 1e-3, 1e-5
CHAIN_FLIP_FREE = ("W3", "gamma3", "beta3")
# the card-vs-CPU ResNet-50 step (phase 19c). float64: above what float64
# rounding can move this ill-conditioned step by (the float32 distances
# scaled by 2**-29: loss 8e-15, gradients 7e-11, stats 2e-13); float32
# against float64: 1.4x / 5x the CPU's own float32 distance at this size
F64_LOSS, F64_GRAD, F64_STATS = 1e-12, 1e-10, 1e-11
F32_GRAD, F32_STATS = 5e-2, 5e-4
# packed ERNIE-base training (phases 21-24; bench.py:293 `_packed_varlen`):
# 16 sequences of 64-1024 tokens packed into rows of 1024
P_BATCH, P_MIN_LEN = 16, 64
# packed against padded logits (phase 23), of the largest |logit|: tile
# boundaries fall at other offsets in the two layouts, so float32 sums
# are taken in another order
REL_PACKED = 1e-4
# phase 21's small grid (s 384): per-row segment lengths with boundaries
# inside and across 64-token tiles, a one-token segment and a segment
# spanning tiles; key ids for the kv case (every query id has keys)
SEG_GRID = ([1, 129, 70, 56, 128], [64, 64, 128, 100, 28])
SEG_KV = ([10, 300, 100, 90, 20], [100, 50, 150, 150, 70])
# ERNIE-base pretraining (phase 25): `ErnieConfig.base()` (vocabulary
# 18000, 513 positions), micro-batches of 8 x 512, 4 an update, 15% of the
# positions masked; the ERNIE / BERT recipe: AdamW (weight decay 0.01, none
# on biases and norms) under a linear warmup over 4 updates into a linear
# decay of 1e-4 over 100, a global-norm clip of 1.0
PT_BATCH, PT_SEQ, PT_ACCUM, PT_UPDATES = 8, 512, 4, 12
PT_MASK, PT_LR, PT_WARMUP, PT_DECAY = 0.15, 1e-4, 4, 100
# the multi-tensor step against the per-parameter path on the card (25d)
PT_PATH_UPDATES = 3
# DecodeEngine (phase 26): a batch of ragged prompts in one bucket, greedy,
# beam and speculative generation; the draft model's and the card-vs-CPU
# beam model's depth; the card-vs-CPU beam scores' relative limit
DE_BATCH, DE_PROMPT, DE_NEW, DE_BEAM, DE_DRAFT_LAYERS = 8, 64, 32, 4, 2
REL_BEAM = 1e-4
# chunked prefill (phase 27): long prompts among short ones, the chunk
CH_CHUNK, CH_LONG, CH_SHORT, CH_LONG_LEN = 256, 4, 12, 1024
# preemption under the ShapingScheduler (phase 28): batch-class requests
# fill the slots, then interactive ones arrive
PR_BATCH, PR_INTER, PR_BATCH_LEN, PR_BATCH_NEW = 8, 8, 512, 64


#: flash_fwd launches by route on each serving path, and int8_matmul's
#: by path (skinny or tiled), for the kernels line
FWD_ROUTES, INT8_ROUTES = {}, {}


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


def sdpa_backward_ms(q, k, v, mask, do):
    """The library yardstick of the backward kernels: torch's
    scaled_dot_product_attention backward alone (one forward with dropout
    outside the timer, then torch.autograd.grad over q, k and v with the
    graph kept), median of 10."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask, dropout_p=E_DROPOUT)
    return device_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg), do, retain_graph=True), runs=10)


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
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            **split_bounds(flops, nbytes, TF32_FLOPS_PER_S, ms)}


def split_bounds(flops, nbytes, peak, ms):
    """The bounds of a float32 kernel on the tensor cores: bound_ms the
    least time for the work it does (SPLIT_PIECES products at the
    pieces' tensor-core peak, or the bytes), beside the CUDA-core bound of
    the same function (float32 FMAs at 67 TFLOP/s, or the bytes), and the
    share of the tensor-core bound the kernel reaches."""
    t_tc, t_fma = SPLIT_PIECES * flops / peak, flops / FP32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound = max(t_tc, t_bytes) * 1e3
    return {"bound_ms": bound,
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "cuda_core_bound_ms": max(t_fma, t_bytes) * 1e3,
            "cuda_core_bound_by": "operations" if t_fma >= t_bytes
            else "bytes",
            "bound_share": bound / ms}


def dec_case(g, b, h, L, d, lens, hole):
    q = torch.randn(b, h, 1, d, generator=g, device="cuda")
    k = torch.randn(b, h, L, d, generator=g, device="cuda")
    v = torch.randn(b, h, L, d, generator=g, device="cuda")
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bias = torch.zeros(b, L, device="cuda")
    bias[:, hole[0]:hole[1]] = -1e30
    return q, k, v, length, bias


def dec_numbers(A, args):
    """Phase 4: the decode's whole call (one launch: its key splits merge
    in the kernel) against its bound, the plain version and SDPA, and the
    device kernels a call (torch.profiler), which must be the decode
    kernel alone."""
    q, k, v, length, bias = args
    b, h, _, d = q.shape
    L = k.shape[2]
    n = int(length.sum())                      # keys this data needs
    # K and V of the visible keys, q, their bias, the lengths, the output
    nbytes = 4.0 * (2 * n * h * d + b * h * d + n + b + b * h * d)
    flops = 4.0 * n * h * d
    kpos = torch.arange(L, device="cuda")
    mask = torch.where(kpos[None] < length[:, None].long(), 0.0, -1e30) \
        + bias
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: A.flash_decode(q, k, v, length, bias))
    plain = device_ms(lambda: A.flash_decode_plain(q, k, v, length, bias))
    lib = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    per_call = kernels_per_call(lambda: A.flash_decode(q, k, v, length,
                                                       bias))
    only_kernel("flash_decode", per_call, "flash_decode_kernel")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "plan": dict(zip(("splits", "keys_per_split"),
                             A.flash_decode_plan_on_card(b, h, L,
                                                         q.device))),
            "kernels_per_call": per_call}


#: each merge kernel's largest error against `testing`'s kernel-order
#: emulation in phase 2 (float32 outputs), for the kernels line
EMU_ERRS = {}


def one_launch_each(A, name, fn, *args):
    """Two calls of a wrapper: each must add one to its kernel's count and
    both must give the same bits (the splits merge in rank order).
    Returns the first call's output."""
    before = A.LAUNCHES[name]
    out, again = fn(*args), fn(*args)
    calls = A.LAUNCHES[name] - before
    if calls != 2 or not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls launched {calls} kernels, "
                             f"bitwise equal {torch.equal(out, again)}")
    return out


def emulation_err(label, got, emu, limit):
    """The largest error of a kernel's output against its kernel-order
    emulation (numpy, `testing.merge_in_kernel`), held to `limit`."""
    e = (got.float().cpu() - emu).abs().max().item()
    if not e <= limit:
        raise AssertionError(f"{label}: {e} from the kernel-order emulation "
                             f"(limit {limit})")
    return e


def fwd_miss_detail(A, args, out, lse, pout, plse):
    """What a flash_fwd miss looks like, for its error message: the
    non-finite entries of the output and lse, the first [b, h, row] off
    by more than the limit, and the error of a second call on the same
    inputs (a miss that does not repeat is no fault of the arithmetic).
    The run fails all the same."""
    off = ((out - pout).abs() > ATOL_KERNEL).any(-1) \
        | ~torch.isfinite(out).all(-1)
    again, again_lse = A.flash_attention_fwd(*args)
    e2 = max((again - pout).abs().max().item(),
             (again_lse - plse).abs().max().item())
    return (f"{int((~torch.isfinite(out)).sum())} non-finite outputs and "
            f"{int((~torch.isfinite(lse)).sum())} lse, {int(off.sum())} "
            f"rows off, the first {off.nonzero()[:8].tolist()}; a second "
            f"call's error {e2}")


def check_kernels(A, g):
    """Phase 2: every kernel against its plain version at the serving
    shapes. Returns ({name: max_abs_err}, {case: inputs})."""
    from paddle_tpu_torch.testing import flash_fwd_split

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
    # the short-query route at every width it takes, keys off the tiles
    short = {f"short q{sq} b8 h8 1x256": fwd_case(g, SLOTS, HEADS, sq,
                                                  SRC_LEN, 64, False, None)
             for sq in (2, 5, 16)}
    short["short q1 b8 h8 sk200 pad bias"] = fwd_case(
        g, SLOTS, HEADS, 1, 200, 64, False, [200 - 17 * i for i in range(8)])
    short["short q16 b2 h8 sk1000 causal pad bias"] = fwd_case(
        g, 2, HEADS, 16, 1000, 64, True, [1000, 700])
    dec = {
        # row 0's length ends inside the first 128-key split
        "decode b8 h8 L1056 d64 ragged":
            dec_case(g, SLOTS, HEADS, MAX_LEN, 64,
                     [60, 1056, 700, 300, 129, 128, 1000, 513], (20, 40)),
    }
    # the same values in bf16, and a row with no written key beside a
    # -1e30 hole over the first split that every other row sees keys past
    q, k, v, length, bias = dec["decode b8 h8 L1056 d64 ragged"]
    dec_all = {**dec, "decode b8 h8 L1056 d64 ragged bf16": (
        *(x.to(torch.bfloat16) for x in (q, k, v)), length, bias),
        "decode b8 h8 L1056 d64 length-0 row, hole over split 0": dec_case(
            g, SLOTS, HEADS, MAX_LEN, 64,
            [0, 1056, 700, 300, 200, 161, 1000, 513], (0, 160))}
    errs = {"flash_fwd": 0.0, "flash_decode": 0.0}
    errs16 = {}
    for name, (q, k, v, bias, causal) in {**fwd, **short}.items():
        route = A.fwd_route(q.dtype, q.shape[2])
        before = dict(A.ROUTE_LAUNCHES)
        out, lse = A.flash_attention_fwd(q, k, v, bias, causal)
        moved = {r: n - before[r] for r, n in A.ROUTE_LAUNCHES.items()
                 if n != before[r]}
        pout, plse = A.flash_attention_fwd_plain(q, k, v, bias, causal)
        mout, mlse = flash_fwd_split(q, k, v, bias, causal, None, 1)
        torch.cuda.synchronize()
        e = max((out - pout).abs().max().item(),
                (lse - plse).abs().max().item())
        em = max((mout - pout).abs().max().item(),
                 (mlse - plse).abs().max().item())
        log(f"  flash_fwd   {name} [{route}, cluster "
            f"{A.fwd_cluster(q, k.shape[2])}]: max_abs_err {e:.3e}; "
            f"one-TF32-pass mutant {em:.3e}")
        if moved != {f"flash_fwd:{route}": 1}:
            raise AssertionError(f"flash_fwd {name}: launched {moved}, not "
                                 f"the {route} route")
        if not e <= ATOL_KERNEL:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version on {name}: "
                f"{e}; " + fwd_miss_detail(A, (q, k, v, bias, causal), out,
                                           lse, pout, plse))
        if not em > ATOL_KERNEL:
            raise AssertionError(f"flash_fwd {name}: the limit "
                                 f"{ATOL_KERNEL} passes one TF32 pass "
                                 f"({em})")
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
    from paddle_tpu_torch.testing import flash_decode_in_kernel

    for name, args in dec_all.items():
        q, k = args[:2]
        out = one_launch_each(A, "flash_decode", A.flash_decode, *args)
        pout = A.flash_decode_plain(*args)
        plan = A.flash_decode_plan_on_card(*q.shape[:2], k.shape[2],
                                           q.device)
        emu = flash_decode_in_kernel(*args, plan=plan)
        torch.cuda.synchronize()
        e = (out.float() - pout.float()).abs().max().item()
        limit = ATOL_KERNEL if q.dtype == torch.float32 else \
            REL_BF16_ATT * pout.float().abs().max().item()
        ee = emulation_err(f"flash_decode {name}", out, emu, limit)
        log(f"  flash_decode {name} [splits, keys a split {plan}; one launch "
            f"a call, bitwise repeatable]: max_abs_err {e:.3e}, against the "
            f"kernel-order emulation {ee:.3e} (limit {limit:.3e})")
        if not e <= limit:
            raise AssertionError(f"flash_decode disagrees with its plain "
                                 f"version on {name}: {e}")
        into = errs if q.dtype == torch.float32 else errs16
        into["flash_decode"] = max(into.get("flash_decode", 0.0), e)
        if q.dtype == torch.float32:
            EMU_ERRS["flash_decode"] = max(EMU_ERRS.get("flash_decode", 0.0),
                                           ee)
    return errs, errs16, fwd, dec


def check_fwd_routes(A, label, launches):
    """Phases 3, 5, 6, 14 and 15: every flash_fwd launch of a serve
    (float32, no dropout, no segment ids) ran on the tensor cores, counted
    by the C rule (`pt_flash_fwd_route`): query-tiled 3xTF32 or
    short-query 3xTF32, none on the SIMT kernel. Returns {route:
    launches}."""
    routes = {k.split(":")[1]: v for k, v in A.ROUTE_LAUNCHES.items()}
    log(f"  {label}: flash_fwd launches by route {routes}")
    tc = routes["tf32x3"] + routes["tf32x3_short"]
    if launches["flash_fwd"] < 1 or tc != launches["flash_fwd"] \
            or routes["simt"] or routes["wgmma"]:
        raise AssertionError(f"{label}: flash_fwd launches {routes}, not "
                             f"all {launches['flash_fwd']} on the float32 "
                             f"tensor-core routes")
    return routes


def int8_routes(Q, label, launches):
    """Phase 14 (b): int8_matmul launches by path (`Q.ROUTE_LAUNCHES`):
    skinny for decode and verify steps, tiled on the tensor cores for a
    prompt bucket (m > 32); both must have run. Returns {path:
    launches}."""
    routes = {k.split(":")[1]: v for k, v in Q.ROUTE_LAUNCHES.items()}
    log(f"  {label}: int8_matmul launches by path {routes}")
    if sum(routes.values()) != launches["int8_matmul"] or not all(
            routes.values()):
        raise AssertionError(f"{label}: int8_matmul launches {routes} of "
                             f"{launches['int8_matmul']}")
    return routes


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
    FWD_ROUTES["serve"] = check_fwd_routes(A, "serve", launches)
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
        return None
    groups = {"flash_fwd": 0.0, "flash_decode": 0.0, "gemm": 0.0,
              "other": 0.0}
    for ms, _, key in rows:
        low = key.lower()
        g = ("flash_fwd" if "flash_fwd" in key else
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


def paged_case(g, S, h, psz, mp, d, T, lens, q_dtype, kv_dtype,
               hole=(20, 40)):
    """A paged read's operands: pages of a shuffled pool (unused pages
    too), each slot's table entries past its written pages pointing at
    the trash row or unmapped (-1), int8 pages with per-(page, head)
    scales, a -1e30 key-bias hole over `hole`."""
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
    bias[:, hole[0]:hole[1]] = -1e30
    return q, kp, vp, scales[0], scales[1], table, length, bias


def pattach_case(g, T, kv_dtype=torch.float32, q_dtype=torch.float32):
    """The tail prefill `_pattach_join` gives `PagedLayout.pattach`
    (serving/engine.py:893-897) after a hit on the 512-token preamble: S 1,
    h 8, T = the tail's bucket, the width-clipped table row of W = 32 +
    T / 16 pages, all mapped, and n_valid = 512 + T = W * 16."""
    W = PREAMBLE // PAGE + T // PAGE
    return paged_case(g, 1, HEADS, PAGE, W, 64, T, [W * PAGE], q_dtype,
                      kv_dtype)


def new_kernel_cases(g):
    """{kernel: {case: (inputs)}} at the shapes of the phase-5/6 paths."""
    lens8 = [60, 1060, 700, 300, 129, 128, 1000, 513]
    plens = [60, 1072, 700, 300, 129, 128, 1000, 513]
    hlens = [0, 1072, 700, 300, 160, 145, 1000, 513]
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    return {
        "flash_verify": {
            "spec step b8 h8 T4 L1060 fp32": ver_case(
                g, SLOTS, HEADS, SPEC_K, MAX_LEN + SPEC_K, 64, lens8, f32),
            "spec step b8 h8 T4 L1060 bf16": ver_case(
                g, SLOTS, HEADS, SPEC_K, MAX_LEN + SPEC_K, 64, lens8, bf16)},
        "paged_flash_decode": {
            **{f"decode S8 h8 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, 1, plens, qd, kd)
               for n, qd, kd in (("fp32", f32, f32), ("bf16", f32, bf16),
                                 ("int8", f32, i8),
                                 ("bf16 q bf16", bf16, bf16))},
            # a slot with no written key (output 0) and a -1e30 hole over
            # the first split's 144 keys of every slot, each of which
            # sees keys past it: that split's partial weighs nothing
            **{f"decode S8 h8 mp67 length-0 slot, hole over split 0 "
               f"pages {n}": paged_case(g, SLOTS, HEADS, PAGE, 67, 64, 1,
                                        hlens, f32, kd, hole=(0, 144))
               for n, kd in (("fp32", f32), ("int8", i8))}},
        "paged_flash_verify": {
            **{f"spec step S8 h8 T4 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, SPEC_K, plens, qd, kd)
               for n, qd, kd in (("fp32", f32, f32), ("bf16", f32, bf16),
                                 ("int8", f32, i8),
                                 ("bf16 q bf16", bf16, bf16))},
            **{f"tail prefill S8 h8 T256 mp67 pages {n}": paged_case(
                g, SLOTS, HEADS, PAGE, 67, 64, 256,
                [max(256, x) for x in plens], qd, kd)
               for n, qd, kd in (("fp32", f32, f32), ("int8", f32, i8),
                                 ("bf16 q bf16", bf16, bf16))},
            # the tiled route at the tail prefills of phase 6's partial
            # hits (pattach: S1 h8, W = 32 + T/16 pages)
            **{f"tail prefill S1 h8 T{T} W{32 + T // 16} pages {n}":
               pattach_case(g, T, kd)
               for T in (64, 256, 512)
               for n, kd in (("fp32", f32),) + ((("int8", i8),
                                                 ("bf16", bf16))
                                                if T == 256 else ())},
            "tail prefill S2 h8 T64 mp36 no seed (n_valid == T) fp32":
                paged_case(g, 2, HEADS, PAGE, 36, 64, 64, [64, 576], f32,
                           f32),
            # every row's first two key tiles all in a -1e30 hole: the
            # splits of 384 keys flush them in the block's online softmax
            # (every row still sees keys past the hole)
            "tail prefill S8 h8 T256 mp67 bias hole over keys 0-127 fp32":
                paged_case(g, SLOTS, HEADS, PAGE, 67, 64, 256,
                           [max(384, x) for x in plens], f32, f32,
                           hole=(0, 128))},
    }


def check_new_kernels(A, cases):
    """Phase 2, second part: flash_verify, paged_flash_decode and
    paged_flash_verify against their plain versions; the merge kernels
    (the dense verify, the paged decode, the split route) also one launch
    a call, bitwise repeatable, and against the kernel-order emulation;
    the dense verify also over a cache whose keys and values past each
    row's length are NaN (a rejected draft's stale block): the same bits.
    Returns ({kernel: max_abs_err of the fp32-output cases}, {kernel: the
    same for the bf16-output cases})."""
    from paddle_tpu_torch.testing import (flash_verify_in_kernel,
                                          nan_past_lengths,
                                          paged_verify_in_kernel)

    errs, errs16 = {}, {}
    for kname, group in cases.items():
        wrapper, plain = getattr(A, kname), getattr(A, kname + "_plain")
        for cname, args in group.items():
            q = args[0]
            S, h, T, d = q.shape
            merge = kname in ("flash_verify", "paged_flash_decode") or (
                kname == "paged_flash_verify"
                and A.paged_verify_route(T, d) == "split")
            got = (one_launch_each(A, kname, wrapper, *args) if merge
                   else wrapper(*args))
            want = plain(*args)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if got.dtype == torch.float32:
                limit, into = ATOL_KERNEL, errs
            else:
                limit = REL_BF16_ATT * want.float().abs().max().item()
                into = errs16
            route = ""
            if kname == "paged_flash_verify":
                route = f" [{A.paged_verify_route(T, d)}]"
            if kname == "flash_verify":
                plan = A.flash_decode_plan_on_card(S, h, args[1].shape[2],
                                                   q.device)
                emu = flash_verify_in_kernel(*args, plan=plan)
                k, v, length, bias = args[1:]
                stale = wrapper(q, *nan_past_lengths(k, v, length), length,
                                bias)
                if not torch.equal(stale, got):
                    raise AssertionError(
                        f"{kname} {cname}: NaN keys past n_valid moved the "
                        f"output by {(stale - got).abs().max().item()}")
                route = (f" [splits, keys a split {plan}; NaN keys past "
                         f"n_valid: the same bits]")
            elif merge:
                plan = A.paged_decode_plan_on_card(S, h, args[5].shape[1],
                                                   q.device)
                emu = paged_verify_in_kernel(*args, plan=plan)
                route += f" [splits, pages a split {plan}]"
            if merge:
                ee = emulation_err(f"{kname} {cname}", got, emu, limit)
                if got.dtype == torch.float32:
                    EMU_ERRS[kname] = max(EMU_ERRS.get(kname, 0.0), ee)
                route += (f" [one launch a call, bitwise repeatable; "
                          f"against the kernel-order emulation {ee:.3e}]")
            log(f"  {kname:18s} {cname}{route}: max_abs_err {e:.3e} (limit "
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
    """Phase 8: kernel and whole call (every one of the three writes its
    output: a call is one launch, but for the paged verify's tiled route
    with its own plan), bound, plain version, and SDPA on the
    pre-gathered dense K/V with the equivalent [b, 1, T, L] mask; the
    device kernels a call of the dense verify, the paged decode and the
    split route (torch.profiler), which must be the kernel alone."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kname == "flash_verify":
        q, k, v, length, bias = args
        kd, vd, elt, extra = k, v, k.element_size(), 0
        kern = lambda: A._flash_verify_cuda(         # noqa: E731
            q, k, v, length, bias, None)
    else:
        q, kp, vp, ks, vs, table, length, bias = args
        kd = A.paged_gather_kv(kp, ks, table, q.dtype)
        vd = A.paged_gather_kv(vp, vs, table, q.dtype)
        elt = kp.element_size()
        psz = kp.shape[2]
        # the table, and the scales of every page a row reads
        extra = table.numel() * 4 + (0 if ks is None else 2 * 4 * q.shape[1]
                                     * sum(-(-int(n) // psz) for n in length))
        if kname == "paged_flash_verify":
            kern = lambda: A._paged_verify_cuda(     # noqa: E731
                q, kp, vp, ks, vs, table, length, bias, None)
        else:
            kern = lambda: A._paged_decode_cuda(     # noqa: E731
                q, kp, vp, ks, vs, table, length, bias, None)
    b, h, T, d = q.shape
    L = kd.shape[2]
    n = sum(int(x) for x in length)             # keys this data needs
    pairs = sum(_visible(x, T) for x in length)
    # K and V of the keys the rows see, q, the bias, the lengths, the
    # [b, h, T, d] output in q's type, the table and scales
    nbytes = (2.0 * n * h * d * elt + 2.0 * q.numel() * q.element_size()
              + 4.0 * (bias.numel() + b) + extra)
    flops = 4.0 * pairs * h * d
    kpos = torch.arange(L, device="cuda")
    qpos = length[:, None].long() - T + torch.arange(T, device="cuda")
    mask = (torch.where(kpos[None, None] <= qpos[:, :, None], 0.0, -1e30)
            + bias[:, None, :])[:, None].to(q.dtype)
    ms = device_ms(kern)
    whole = device_ms(lambda: getattr(A, kname)(*args))
    plain = device_ms(lambda: getattr(A, kname + "_plain")(*args))
    lib = device_ms(lambda: sdpa(q, kd, vd, attn_mask=mask))
    # the peak of q's type: bf16 at the tensor cores' dense rate, float32
    # at the CUDA cores' FMA rate
    bf16 = q.dtype == torch.bfloat16
    t_ops = flops / (BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    lib_kernels = kernels_per_call(lambda: sdpa(q, kd, vd, attn_mask=mask))
    row = {"ms": ms, "whole_call_ms": whole, "plain_ms": plain,
           "library_ms": lib, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_peak": "bf16 tensor cores" if bf16
           else "fp32 CUDA cores",
           "library_kernels": sorted(lib_kernels)
           if isinstance(lib_kernels, dict) else lib_kernels}
    merge = {"paged_flash_decode": "paged_decode_kernel",
             "flash_verify": "flash_verify_kernel"}
    if kname == "paged_flash_verify":
        row["route"] = A.paged_verify_route(T, d)
        if row["route"] == "tiled":
            row["plan"] = dict(zip(("rows", "splits", "keys_per_split"),
                                   A.paged_verify_plan(q, L)))
        else:
            merge[kname] = "paged_split_kernel"
    if kname in merge:
        # one call is one launch of the route's kernel: no combine after it
        row["plan"] = (dict(zip(("splits", "keys_per_split"),
                                A.flash_decode_plan_on_card(b, h, L,
                                                            q.device)))
                       if kname == "flash_verify" else
                       dict(zip(("splits", "pages_per_split"),
                                A.paged_decode_plan_on_card(
                                    b, h, table.shape[1], q.device))))
        row["kernels_per_call"] = kernels_per_call(
            lambda: getattr(A, kname)(*args))
        only_kernel(kname, row["kernels_per_call"], merge[kname])
    return row


def only_kernel(label, per_call, name):
    """Fail unless the one device kernel a call launched is `name` (no
    second pass, no combine after it); the profiler's count a call is
    printed, not held (in a long process its activity records have come
    short of the launches, while a fresh process counts one a call)."""
    if per_call != "not measured" and (
            len(per_call) != 1 or name not in next(iter(per_call))):
        raise AssertionError(f"{label}: one call launched {per_call}")


def kernels_per_call(fn, calls=5):
    """{device kernel: launches per call} of fn (torch.profiler over a
    few calls), or "not measured" when the profiler recorded no device
    row."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    if not rows:
        return "not measured"
    out = {}
    for _, n, key in rows:
        name = key.replace("(anonymous namespace)::", "").split("(")[0]
        out[name[-60:]] = out.get(name[-60:], 0.0) + n / calls
    return out


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


def spec_prompts(rs, n):
    """Phase 5's prompts: a seeded PERIOD-token period repeated over 300 to
    1000 tokens (the n-gram draft's case)."""
    prompts = []
    for _ in range(n):
        p = np.resize(rs.randint(2, VOCAB, PERIOD), int(rs.randint(300, 1001)))
        p[0] = 0
        prompts.append(p)
    return prompts


def spec_serve(A, seed, model, embed, project, dense, memory):
    """Phase 5, then a profiled pass of SLOTS more requests through the
    same engine: one launch of flash_verify_kernel a verify call, no
    combine after it. Returns (launches, snapshot, tokens/s, profile
    summary)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    rs = np.random.RandomState(seed + 5)
    prompts = spec_prompts(rs, SLOTS)
    more = spec_prompts(rs, SLOTS)
    mems = [memory[i] for i in range(SLOTS)]
    want, _ = run_server(dense, prompts, mems)
    engine = ServingEngine(model.decoder, embed, project, num_slots=SLOTS,
                           max_len=MAX_LEN, spec_k=SPEC_K, device="cuda")
    A.reset_launches()
    got, wall = run_server(engine, prompts, mems)
    launches = dict(A.LAUNCHES)
    FWD_ROUTES["spec"] = check_fwd_routes(A, "spec", launches)
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
    # the profiled pass: flash_fwd (the joins' prefill, the cross-
    # attention), flash_verify_kernel (every verify step, its key splits
    # merged in the kernel)
    prof = {}

    def profiled():
        calls, restore = call_log(A, "flash_verify")
        try:
            rows = profile_call(f"{len(more)} requests",
                                lambda: run_server(engine, more, mems),
                                ("flash_fwd", "flash_verify_kernel",
                                 "flash_decode_kernel"), summary=prof)
        finally:
            restore()
        return rows, calls[None]

    got = one_launch_a_call("flash_verify", "flash_verify_kernel", profiled)
    if got is not None:
        prof.update(zip(("calls", "launches", "kernel_ms"), got))
    return launches, snap, n_tok / wall, prof


def rollback_serve(A, seed, model, embed, project, dense, memory):
    """Phase 5b: the dense and the paged spec engines (spec_k=SPEC_K) on
    SLOTS requests of random, non-periodic prompts, every other request
    with `spec = False`, the adaptive k on a tight band
    (`spec_adapt_low=0.9, spec_adapt_patience=1`): drafts are rejected and
    each verify block past a row's accepted tokens is rolled back, so the
    next block's verify runs over a cache whose keys past n_valid are the
    rejected ones. Tokens must equal the dense engine's (or a sub-1e-4
    tie). Fails unless each engine rolled a block back. Returns ({path:
    launches}, {path: speculation counts})."""
    from paddle_tpu_torch.serving import Request, Scheduler, ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    rs = np.random.RandomState(seed + 55)
    prompts = []
    for _ in range(SLOTS):
        p = rs.randint(2, VOCAB, int(rs.randint(300, 1001)))
        p[0] = 0
        prompts.append(p)
    mems = [memory[i] for i in range(SLOTS)]
    want, _ = run_server(dense, prompts, mems)
    net = _StepNet(model.decoder, embed, project).eval()
    launches, counts = {}, {}
    for path, paged in (("rollback", False), ("rollback_paged", True)):
        kw = dict(paged=True, page_size=PAGE) if paged else {}
        engine = ServingEngine(model.decoder, embed, project,
                               num_slots=SLOTS, max_len=MAX_LEN,
                               spec_k=SPEC_K, spec_adapt_low=0.9,
                               spec_adapt_patience=1, device="cuda", **kw)
        # each verify round: its active rows, the rows with speculation
        # on, and the tokens each row kept (a log, not a counter)
        rounds = []
        inner = engine.layout.spec_step

        def logged(drafts, active, spec_on, k_eff, inner=inner,
                   rounds=rounds):
            emit, n_emit = inner(drafts, active, spec_on, k_eff)
            rounds.append((active.cpu().numpy(), spec_on.cpu().numpy(),
                           n_emit.cpu().numpy()))
            return emit, n_emit

        engine.layout.spec_step = logged
        sched = Scheduler(max_queue=SLOTS)
        reqs = [Request(p, m, max_new_tokens=NEW_TOKENS, eos_id=1)
                for p, m in zip(prompts, mems)]
        for r in reqs[1::2]:
            r.spec = False
        A.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        engine.serve_until_idle(sched)
        wall = time.perf_counter() - t0
        launches[path] = dict(A.LAUNCHES)
        results = [r.result() for r in reqs]
        for i, res in enumerate(results):
            if not res.ok:
                raise AssertionError(f"{path}: request {i} finished "
                                     f"{res.finish_reason}: {res.error!r}")
        got = [list(res.tokens) for res in results]
        ties = same_tokens(path, want, got, net, prompts, mems)
        sp = engine.metrics.snapshot()["speculation"]
        off = sum(int((a & ~on).any()) for a, on, _ in rounds)
        rolled = sum(int((a & (n < SPEC_K)).sum()) for a, _, n in rounds)
        counts[path] = {
            "rounds": sp["rounds"], "rounds_with_spec_off_row": off,
            "blocks_rolled_back": rolled,
            "wasted_draft_tokens": sp["wasted_draft_tokens"],
            "k_shrink_events": sp["k_shrink_events"],
            "effective_k": sp["effective_k"],
            "acceptance_rate": sp["acceptance_rate"], "ties": ties}
        name = "paged_flash_verify" if paged else "flash_verify"
        n_tok = sum(len(t) for t in got)
        log(f"  {path}: {SLOTS} requests ({SLOTS // 2} with spec = False), "
            f"{n_tok} tokens in {wall:.3f} s; {json.dumps(counts[path])}; "
            f"{name} launches {launches[path][name]}; tokens equal the "
            f"dense engine's ({ties} ties)")
        if len(rounds) != sp["rounds"] or off < 1 or rolled < 1 \
                or launches[path][name] < 1:
            raise AssertionError(f"{path}: {len(rounds)} logged rounds of "
                                 f"{sp['rounds']}, {off} with a spec = "
                                 f"False row, {rolled} blocks rolled back, "
                                 f"{launches[path][name]} {name} launches")
        if paged:
            engine._alloc.check()
    return launches, counts


def paged_requests(seed, n, memory):
    rs = np.random.RandomState(seed)
    pre = rs.randint(2, VOCAB, PREAMBLE)
    pre[0] = 0
    prompts = [np.concatenate([pre, rs.randint(2, VOCAB,
                                              int(rs.randint(32, 481)))])
               for _ in range(n)]
    return prompts, [memory] * n


def verify_width_log(A):
    """Wrap `A.paged_flash_verify` (the paged dispatcher looks it up at
    each call) to log (T, the route its launch counted) per call: a log,
    not a counter. Returns (log, restore)."""
    calls = []
    inner = A.paged_flash_verify

    def logged(q, *args, **kwargs):
        before = dict(A.PAGED_ROUTE_LAUNCHES)
        out = inner(q, *args, **kwargs)
        grew = [k.split(":")[1] for k, v in A.PAGED_ROUTE_LAUNCHES.items()
                if v != before[k]]
        calls.append((int(q.shape[2]), grew[0] if len(grew) == 1 else grew))
        return out

    A.paged_flash_verify = logged
    return calls, lambda: setattr(A, "paged_flash_verify", inner)


def check_verify_routes(A, label, calls, snap, spec_k):
    """Phases 6 and 15: every tail prefill of a partial prefix hit (T above
    the speculative step's SPEC_K rows; one a hit and decoder layer) ran
    the tiled route, every speculative step (T = SPEC_K; one a round and
    layer) the split route. Returns {route: launches}."""
    routes = {k.split(":")[1]: v for k, v in A.PAGED_ROUTE_LAUNCHES.items()}
    tails = [t for t, _ in calls if t > SPEC_K]
    steps = [t for t, _ in calls if t <= SPEC_K]
    wrong = [(t, r) for t, r in calls
             if r != ("tiled" if t > SPEC_K else "split")]
    want_tails = snap["prefix"]["partial_hits"] * LAYERS
    want_steps = snap["speculation"]["rounds"] * LAYERS if spec_k else 0
    log(f"  {label}: paged_flash_verify launches by route {routes}: "
        f"{len(tails)} tail prefills (T {sorted(set(tails))}; "
        f"{snap['prefix']['partial_hits']} partial hits x {LAYERS} layers), "
        f"{len(steps)} speculative steps (T {sorted(set(steps))})")
    if wrong or len(tails) != want_tails or len(steps) != want_steps \
            or routes != {"split": len(steps), "tiled": len(tails)}:
        raise AssertionError(
            f"{label}: verify routes {routes}, calls on a wrong route "
            f"{wrong[:5]}, tail prefills {len(tails)} (want {want_tails}), "
            f"speculative steps {len(steps)} (want {want_steps})")
    return routes


def paged_serve(A, seed, model, embed, project, dense, memory):
    """Phase 6 (and the engine of phase 7). Returns ({path: launches},
    {path: snapshot}, {path: tokens/s}, fp32 tokens, prompts, memories,
    {path: paged_flash_verify launches by route})."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    prompts, mems = paged_requests(seed + 6, REQUESTS, memory)
    want, _ = run_server(dense, prompts, mems)
    net = _StepNet(model.decoder, embed, project).eval()
    launches, snaps, rates, engines, routes = {}, {}, {}, {}, {}
    for path, spec_k in (("paged", None), ("paged_spec", SPEC_K)):
        engine = ServingEngine(model.decoder, embed, project, paged=True,
                               page_size=PAGE, num_slots=SLOTS,
                               max_len=MAX_LEN, spec_k=spec_k, device="cuda")
        calls, restore = verify_width_log(A)
        A.reset_launches()
        try:
            got, wall = run_server(engine, prompts, mems)
        finally:
            restore()
        launches[path] = dict(A.LAUNCHES)
        FWD_ROUTES[path] = check_fwd_routes(A, path, launches[path])
        snaps[path] = snap = engine.metrics.snapshot()
        routes[path] = check_verify_routes(A, path, calls, snap, spec_k)
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
    # flash_fwd (the float32 tensor-core kernels): the encoder, the
    # prefill of a cold join and the cross-attention; paged_decode_kernel:
    # the paged decode, its key splits merged in the kernel;
    # paged_tiled_kernel: the tail prefills of the partial hits
    def decode_pass():
        calls, restore = call_log(A, "paged_flash_decode")
        try:
            rows = profile_call(
                f"{len(more) - REQUESTS} requests", lambda: run_server(
                    engines["paged"], more[REQUESTS:],
                    more_mems[REQUESTS:]),
                ("flash_fwd", "paged_decode_kernel", "paged_tiled_kernel"))
        finally:
            restore()
        return rows, calls[None]

    one_launch_a_call("paged_flash_decode", "paged_decode_kernel",
                      decode_pass)

    # the speculative engine's pass: every speculative step (T = SPEC_K)
    # one launch of paged_split_kernel, its splits merged in the kernel
    def split_pass():
        vcalls, restore = verify_width_log(A)
        try:
            rows = profile_call(
                f"{len(more) - REQUESTS} requests", lambda: run_server(
                    engines["paged_spec"], more[REQUESTS:],
                    more_mems[REQUESTS:]),
                ("flash_fwd", "paged_split_kernel", "paged_tiled_kernel",
                 "paged_decode_kernel"))
        finally:
            restore()
        return rows, sum(r == "split" for _, r in vcalls)

    one_launch_a_call("paged_flash_verify's split route",
                      "paged_split_kernel", split_pass)
    for path, engine in engines.items():
        engine.flush_prefix_cache()
        engine._alloc.check()
        if engine._alloc.pages_free != engine.num_pages:
            raise AssertionError(f"{path}: pages leaked after the drain")
    log(f"  allocators clean after the drain; all pages free after the "
        f"prefix flush")
    return launches, snaps, rates, fp32_tokens, prompts, mems, routes


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


def profile_call(label, fn, kernel_names, summary=None):
    """fn() under torch.profiler: wall, the device's busy share, and
    device time by kernel group (also into `summary`, a dict, when
    given). Returns the profile's kernel rows, or None when it recorded
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler recorded no device time: breakdown not measured")
        return None
    groups = {k: 0.0 for k in (*kernel_names, "gemm", "other")}
    for ms, _, key in rows:
        low = key.lower()
        grp = next((k for k in kernel_names if k in key), None)
        if grp is None:
            grp = ("gemm" if "gemm" in low or "cutlass" in low
                   or "nvjet" in low else "other")
        groups[grp] += ms
    log(f"  profiled {label}: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%")
    log("  device ms by group: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / busy:.1f}%)" for k, v in groups.items()))
    if summary is not None:
        summary.update(wall_ms=wall * 1e3, busy_ms=busy,
                       busy_share=busy / (wall * 1e3), groups_ms=groups)
    for ms, n, key in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:9.3f} ms  {n:6d} x  {key[:90]}")
    return rows


def rows_matching(rows, name):
    """(device ms, launches) of the profile rows whose kernel name holds
    `name`."""
    hit = [(ms, n) for ms, n, key in rows if name in key]
    return sum(ms for ms, _ in hit), sum(n for _, n in hit)


def one_launch_a_call(label, kernel, profiled, tries=3):
    """Hold profiled passes to one launch of `kernel` a call. `profiled()`
    runs one pass under torch.profiler and returns (its kernel rows or
    None, the calls the wrapper saw). More launches than calls, or no
    call, fail at once. Fewer launches than calls is also what the
    profiler shows when it drops kernel records, which it does now and
    then in this long process (3 of 204 once), so the pass is profiled
    again, up to `tries` passes, and fails unless one of them shows
    exactly one launch a call: a wrapper that skips its kernel on some
    calls reads short in every pass. Returns (calls, launches, device
    ms), or None when the profiler recorded no device time."""
    for _ in range(tries):
        rows, n_calls = profiled()
        if rows is None:
            return None
        ms, n = rows_matching(rows, kernel)
        log(f"  {label}: {n_calls} calls, {n} launches of {kernel} "
            f"({ms:.2f} ms): one launch a call, no combine after it")
        if n_calls < 1 or n > n_calls:
            raise AssertionError(f"{label}: {n_calls} calls launched "
                                 f"{kernel} {n} times")
        if n == n_calls:
            return n_calls, n, ms
        log(f"  {label}: the profile holds {n_calls - n} launches fewer "
            f"than calls; the pass is profiled again")
    raise AssertionError(f"{label}: {n_calls} calls launched {kernel} "
                         f"fewer times in each of {tries} profiled passes "
                         f"(last {n})")


def call_log(mod, name, key=lambda *args: None):
    """Wrap `mod.<name>` (its callers look it up at each call) to count
    its calls by key(*args). Returns (a Counter, restore)."""
    import collections

    calls = collections.Counter()
    inner = getattr(mod, name)

    def counted(*args, **kwargs):
        calls[key(*args)] += 1
        return inner(*args, **kwargs)

    setattr(mod, name, counted)
    return calls, lambda: setattr(mod, name, inner)


# ------------------------------------------------------------- training

def train_case(g, dtype, seed=1234, b=E_BATCH, s=E_SEQ,
               lens=(E_SEQ, 900, 700, 1000, 513, 1024, 640, 800)):
    """ERNIE-base attention operands as the layers produce them: [b, s,
    h*d] projections viewed as [b, h, s, d] (strided), dO likewise, a
    [b, s] key bias of -1e4 over each row's pad tail (past `lens`), and
    the dropout spec of a 0.1 call (logical blocks 512 x 512 at s 1024,
    one block over the whole row at s 512)."""
    from paddle_tpu_torch.ops import attention as A

    h, d = E_HEADS, E_HIDDEN // E_HEADS

    def proj():
        return torch.randn(b, s, h * d, generator=g, device="cuda") \
            .to(dtype).view(b, s, h, d).transpose(1, 2)
    q, k, v, do = proj(), proj(), proj(), proj()
    lens = torch.tensor(lens, device="cuda")
    kpos = torch.arange(s, device="cuda")
    bias = torch.where(kpos[None] >= lens[:, None], -1e4, 0.0).float() \
        .contiguous()
    drop = A.drop_spec(E_DROPOUT, seed, s, s)
    return q, k, v, bias, do, drop


def judge_train_kernels(A, case, causal, label, errs, errs16, **ids):
    """The three training kernels against their plain versions on one
    case (q, k, v, bias, dO, dropout spec; segment ids as keywords), each
    within its limit: fp32 atol 2e-5 for the forward, 1e-4 for the
    gradients, 1e-3 for dbias (a sum over heads and rows of dlogits);
    bf16 1e-2 of the plain version's largest entry for the output and
    lse, `paddle_tpu_torch.testing.judge_bf16_grad` for dq, dk and dv,
    1e-3 of the largest entry for dbias (float32). Every output is
    measured and printed before a miss raises. Folds each kernel's
    largest error into errs (fp32) or errs16 (bf16)."""
    from paddle_tpu_torch.testing import flash_fwd_tiled, judge_bf16_grad

    q, k, v, bias, do, drop = case
    out, lse = A.flash_attention_fwd(q, k, v, bias, causal, None, drop,
                                     **ids)
    pout, plse = A.flash_attention_fwd_plain(q, k, v, bias, causal, None,
                                             drop, **ids)
    got = A.flash_attention_bwd(q, k, v, bias, pout, plse, do, causal,
                                None, drop, **ids)
    want = A.flash_attention_bwd_plain(q, k, v, bias, pout, plse, do,
                                       causal, None, drop, **ids)
    torch.cuda.synchronize()
    fp32 = q.dtype == torch.float32
    parts = [("flash_fwd", "out", out, pout), ("flash_fwd", "lse", lse, plse)]
    parts += [(kname, n, a, w) for kname, n, a, w in zip(
        ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd_dkv"),
        ("dq", "dk", "dv", "dbias"), got, want) if w is not None]
    shown, missed = [], []
    into = errs if fp32 else errs16
    for kname, name, a, w in parts:
        e = (a.float() - w.float()).abs().max().item()
        into[kname] = max(e, into.get(kname, 0.0))
        if not fp32 and name in ("dq", "dk", "dv"):
            nums, miss = judge_bf16_grad(a, w)
            shown.append(f"{name} {e:.2e} ({nums['ulps_of_largest']:.2f} "
                         f"ulp of the largest, {nums['share']:.2e} differ, "
                         f"L2 {nums['rel_l2']:.2e})")
            missed += [f"{kname} {name}: {x}" for x in miss]
            continue
        if fp32:
            limit = ATOL_KERNEL if kname == "flash_fwd" else ATOL_GRAD
            if name == "dbias":
                limit *= 10
        else:
            ref = w if name == "dbias" else pout
            limit = ref.float().abs().max().item() * (
                REL_BF16_DBIAS if name == "dbias" else REL_BF16_OUT)
        shown.append(f"{name} {e:.2e}/{limit:.2e}")
        if not e <= limit:
            missed.append(f"{kname} {name}: {e} > {limit}")
        if not fp32 and name == "out":
            nums, miss = judge_bf16_grad(a, flash_fwd_tiled(
                q, k, v, bias, causal, None, drop, **ids))
            shown.append(f"out vs tiled ({nums['ulps_of_largest']:.2f} ulp "
                         f"of the largest, {nums['share']:.2e} differ, L2 "
                         f"{nums['rel_l2']:.2e})")
            missed += [f"{kname} out vs tiled: {x}" for x in miss]
    log(f"  {str(q.dtype)[6:]} {label}: " + ", ".join(shown))
    if missed:
        raise AssertionError(f"disagreement with the plain versions in "
                             f"{q.dtype} on {label}: {'; '.join(missed)}")


def check_train_kernels(A, g):
    """Phase 9: the three training kernels against their plain versions
    at the ERNIE shapes, fp32 and bf16: fine-tuning's b8 s1024 with padded
    rows, and pretraining's (phase 25) b8 s512 micro-batch, whose mask
    keeps every key (a key bias of zeros) and whose 0.1 dropout draws one
    512 x 512 block a row. Returns ({kernel: max_abs_err fp32}, {kernel:
    max_abs_err bf16}, the fine-tuning bf16 inputs). The pretraining
    cases draw from a generator of their own, so g's later draws are
    those of the fine-tuning cases alone."""
    errs, errs16 = {}, {}
    g25 = torch.Generator(device="cuda").manual_seed(g.initial_seed() + 25)
    for dtype in (torch.float32, torch.bfloat16):
        case = train_case(g, dtype)
        judge_train_kernels(A, case, False,
                            "b8 h12 s1024 d64 bias dropout 0.1", errs,
                            errs16)
        judge_train_kernels(
            A, train_case(g25, dtype, b=PT_BATCH, s=PT_SEQ,
                          lens=(PT_SEQ,) * PT_BATCH), False,
            f"pretraining b{PT_BATCH} h{E_HEADS} s{PT_SEQ} d64 zero bias "
            f"dropout {E_DROPOUT}", errs, errs16)
    return errs, errs16, case


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


def train(A, seed, batch=None):
    """Phase 10 (and the two runs of phase 22): ERNIE-base, E_STEPS steps
    on one batch ((inputs, labels); default phase 10's 8 x 1024 padded
    rows). Returns (launches, segment-branch launches, losses, seq/s,
    peak bytes net of what earlier phases left allocated, trainer,
    batch)."""
    from paddle_tpu_torch.optimizer import functional as fopt
    from paddle_tpu_torch.parallel import SpmdTrainer

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = ernie("cuda", E_LAYERS, (E_DROPOUT, E_DROPOUT), seed)
    tr = SpmdTrainer(model, ce_loss, fopt.adamw(E_LR, weight_decay=0.01),
                     compute_dtype="bfloat16", device="cuda",
                     generator=torch.Generator().manual_seed(seed))
    inputs, labels = batch or ernie_batch(seed, E_BATCH, E_SEQ)
    inputs = tuple(None if x is None else torch.as_tensor(x, device="cuda")
                   for x in inputs)
    labels = torch.as_tensor(labels, device="cuda")
    torch.cuda.synchronize()
    A.reset_launches()
    losses = []
    for i in range(E_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.step(inputs, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, seg = dict(A.LAUNCHES), dict(A.SEG_LAUNCHES)
    if any(A.ELEMENT_LOAD_LAUNCHES.values()):
        raise AssertionError(f"a bf16 kernel copied ERNIE's views "
                             f"element by element: "
                             f"{A.ELEMENT_LOAD_LAUNCHES}")
    if A.ROUTE_LAUNCHES["flash_fwd:wgmma"] != launches["flash_fwd"]:
        raise AssertionError(f"bf16 flash_fwd launches off the tensor "
                             f"cores: {A.ROUTE_LAUNCHES} of "
                             f"{launches['flash_fwd']}")
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() - before
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = E_LAYERS * E_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {E_STEPS} steps, expected {want}")
    return launches, seg, losses, len(labels) * (E_STEPS - 2) / wall, \
        peak, tr, (inputs, labels)


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
        grp = ("flash_fwd" if "flash_fwd_kernel" in key
               or "flash_fwd_mma" in key else
               "flash_bwd_dq" if "flash_bwd_dq_" in key else
               "flash_bwd_dkv" if "flash_bwd_dkv_" in key else
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
    lib_b = sdpa_backward_ms(q, k, v, mask, do)
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
             plain_bwd, lib_b),
            ("flash_bwd_dkv", 8.0 * pairs * d,
             6 * qkv + 2 * row + 4.0 * b * s,
             lambda: A._flash_bwd_dkv_cuda(q, k, v, bias, do, lse2, delta,
                                           False, None, drop, False),
             plain_bwd, lib_b)):
        bms, by = bound(flops, nbytes)
        ms = device_ms(fn)
        rows[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bms, "bound_by": by}
        log(f"  {name} bf16 b8 h12 s1024 d64 bias dropout: kernel "
            f"{ms:.4f} bound {bms:.4f} ({by}) plain {plain:.4f} sdpa "
            f"{lib:.4f}")
    pair = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_fwd_bwd_ms"] = lib_fb
    log(f"  dq + dkv {pair:.4f} ms against sdpa's backward alone "
        f"{lib_b:.4f} ms ({pair / lib_b:.2f}x) and its forward + backward "
        f"{lib_fb:.4f} ms; the three kernels together "
        f"{sum(r['ms'] for r in rows.values()):.4f} ms (the plain bwd times "
        f"dq, dk and dv together: {plain_bwd:.4f} ms)")
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
    for m in (8, 1024):
        x, q, scale = cases[f"m{m} 512x2048"]
        cases[f"m{m} 512x2048 bf16 x"] = (x.bfloat16(), q, scale)
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
    from paddle_tpu_torch.testing import int8_matmul_split

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
            # both int8 routes split x into three bf16 pieces on the
            # tensor cores: the one-piece mutant (a bf16 x) must be
            # refused by the same limit at every float32 case
            mutant = ""
            if kname == "int8_matmul" and fp32:
                m = args[0].shape[0]
                em = (int8_matmul_split(*args, pieces=1) - want).abs() \
                    .max().item()
                route = "skinny" if m <= 32 else "tiled"
                if route == "skinny":
                    plan = Q.skinny_plan_on_card(m, *args[1].shape, "cuda")
                    route += (f" {plan[0]} m-tiles, {plan[1]} k-splits of "
                              f"{plan[2]}, {plan[3]} warps")
                mutant = f" [{route}]; one-bf16-piece mutant {em:.3e}"
                if not em > limit:
                    raise AssertionError(f"int8_matmul {cname}: the limit "
                                         f"{limit} passes a bf16 x ({em})")
            log(f"  {kname:12s} {cname}: max_abs_err {e:.3e} (limit "
                f"{limit:.3e}){mutant}")
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
    from paddle_tpu_torch.ops import attention as A
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
    FWD_ROUTES["mt_fp32"] = check_fwd_routes(A, "(a) fp32", launches)
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
    stack8s = copy.deepcopy(base)        # (c)'s own stack (quantized there)
    del base
    Q.reset_launches()
    got8, wall8 = run_server(engine8, prompts, mems, adapters=names)
    launches8 = launch_counts()
    FWD_ROUTES["mt_int8"] = check_fwd_routes(A, "(b) int8", launches8)
    INT8_ROUTES["mt_int8"] = int8_routes(Q, "(b) int8", launches8)
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
    out.update(int8_spec_serve(Q, stack8s, prompts[:SLOTS], mems[:SLOTS],
                               names[:SLOTS], got8[:SLOTS]))
    return out


def int8_spec_serve(Q, stack, prompts, mems, names, want):
    """Phase 14 (c): the int8 + LoRA stack with spec_k=4 on the dense pool
    (8 requests): tokens equal the int8 serve without speculation (or a
    sub-1e-4 tie under the tenant's adapter); the verify step (m = 8 slots
    x 4 tokens) runs the skinny route at m 32. Returns its results."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    pool = adapter_pool(stack[0])
    engine = ServingEngine(*stack, num_slots=SLOTS, max_len=MAX_LEN,
                           adapters=pool, quantize="int8", spec_k=SPEC_K,
                           device="cuda")
    # the skinny launches by (m, d, n) (int8_matmul looks the launcher up
    # at each call)
    shapes, restore = call_log(
        Q, "_int8_matmul_cuda", lambda x, q, scale: (
            (x.shape[0], *q.shape) if x.shape[0] <= 32 else None))
    Q.reset_launches()
    try:
        got, wall = run_server(engine, prompts, mems, adapters=names)
    finally:
        restore()
    shapes.pop(None, None)
    launches = launch_counts()
    FWD_ROUTES["mt_int8_spec"] = check_fwd_routes(A, "(c) int8 spec",
                                                  launches)
    INT8_ROUTES["mt_int8_spec"] = int8_routes(Q, "(c) int8 spec", launches)
    snap = engine.metrics.snapshot()
    pool.check()
    net = _StepNet(*stack).eval()
    ties = same_tokens("(c) int8 spec", want, got, None, prompts, mems,
                       tenant_margin(Q, net, pool, prompts, mems, names))
    by_shape = {f"m{m} {d}x{n}": c for (m, d, n), c in sorted(shapes.items())}
    m32 = sum(c for (m, _, _), c in shapes.items() if m > 8)
    sp = snap["speculation"]
    n_tok = sum(len(t) for t in got)
    log(f"  (c) int8 + adapters, spec_k {SPEC_K}: {len(prompts)} requests, "
        f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; "
        f"acceptance rate {sp['acceptance_rate']}, {sp['rounds']} rounds; "
        f"tokens equal (b)'s ({ties} ties); launches {launches}")
    log(f"      skinny int8_matmul launches by shape {json.dumps(by_shape)}")
    for name in ("int8_matmul", "lora_gather"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched on the int8 "
                                 f"spec serve")
    if m32 < 1 or sum(shapes.values()) != \
            INT8_ROUTES["mt_int8_spec"]["skinny"]:
        raise AssertionError(f"(c): skinny launches by shape {by_shape}, "
                             f"none above m 8 or not the route's count")
    return {"int8_spec_launches": launches, "int8_spec_rate": n_tok / wall,
            "int8_spec_ties": ties, "int8_spec_skinny_by_shape": by_shape,
            "int8_spec_acceptance": sp["acceptance_rate"]}


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
    from paddle_tpu_torch.ops import attention as A

    launches, snaps = {}, {}
    for path, spec_k in (("mt_paged", None), ("mt_paged_spec", SPEC_K)):
        engine = ServingEngine(net.decoder, net.embed, net.project,
                               paged=True, page_size=PAGE, num_slots=SLOTS,
                               max_len=MAX_LEN, spec_k=spec_k, adapters=pool,
                               device="cuda")
        calls, restore = verify_width_log(A)
        Q.reset_launches()
        try:
            got, wall = run_server(engine, prompts, mems, adapters=names)
        finally:
            restore()
        launches[path] = launch_counts()
        FWD_ROUTES[path] = check_fwd_routes(A, path, launches[path])
        snaps[path] = snap = engine.metrics.snapshot()
        launches[path]["verify_routes"] = check_verify_routes(
            A, path, calls, snap, spec_k)
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
    row = {"ms": device_ms(kern), "plain_ms": device_ms(plain),
           "library_ms": device_ms(lib),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if kname == "int8_matmul":
        # both routes: x in bf16 pieces on the tensor cores
        row.update(split_bounds(flops, nbytes, BF16_FLOPS_PER_S, row["ms"]),
                   splits=Q._int8_splits(m, d, n))
        if m <= 32:
            row["plan"] = dict(zip(("m_tiles", "k_splits", "k_per_split",
                                    "warps"),
                                   Q.skinny_plan_on_card(m, d, n, "cuda")))
            row["kernels_per_call"] = kernels_per_call(kern)
            only_kernel(f"int8_matmul m{m} {d}x{n}", row["kernels_per_call"],
                        "int8_matmul_skinny_mma")
    if kname == "lora_gather":
        rows, cluster = Q.lora_gather_plan(b, s, d, "cuda")
        row["plan"] = {"rows": rows, "cluster": cluster,
                       "ctas": b * -(-s // rows) * cluster}
    return row


# -------------------------------- the fused 1x1-conv + BN op (17, 18, 20)

def fc_case(g, B, ci, co, hw, dtype, norm=True, wdtype=None):
    """Inputs of one fused op at a ResNet-50 bottleneck shape: x as a BN'd
    activation, a folded scale / shift, He-scaled W (in x's type, or
    wdtype), and cotangents of z and of both stats (nonzero: the
    BN-chain path)."""
    x = torch.randn(B, ci, hw, generator=g, device="cuda").to(dtype)
    sc = torch.rand(ci, generator=g, device="cuda") + 0.5 if norm else None
    sh = torch.randn(ci, generator=g, device="cuda") * 0.1 if norm else None
    w = (torch.randn(co, ci, generator=g, device="cuda")
         * (2.0 / ci) ** 0.5).to(wdtype or dtype)
    dz = torch.randn(B, co, hw, generator=g, device="cuda").to(dtype)
    ds = torch.randn(co, generator=g, device="cuda")
    dss = torch.randn(co, generator=g, device="cuda") * 0.01
    return x, sc, sh, w, dz, ds, dss


def check_fused_kernels(FC, g):
    """Phase 17: fused_conv_fwd / fused_conv_bwd against their plain
    versions at the eight bottleneck shapes: bf16 at batch 128 (norm and
    ReLU), float32 at batch 8, one identity case (no norm, no ReLU) and
    one bf16 x with a float32 W. Every output of a case is measured and
    printed before a miss raises; at each bf16 shape of the eight the
    unrounded-operand mutants (`testing.fused_conv_mutants`) must be
    refused. Each launch must count the routes that the C rules give
    (`FC.fwd_route` / `FC.bwd_routes`). Returns ({kernel: max_abs_err f32}, {kernel:
    max_abs_err bf16}, {route: launches}, {case: the judge's numbers of
    z, dx and the two mutants})."""
    from paddle_tpu_torch.testing import (SHARE_FC_BF16,
                                          fused_conv_abs_sums,
                                          fused_conv_mutants,
                                          judge_bf16_sum)

    errs, errs16, readings = {}, {}, {}
    runs = [(shape, torch.bfloat16, FC_BATCH, True, None)
            for shape in FC_SHAPES]
    runs += [(shape, torch.float32, FC_BATCH_F32, True, None)
             for shape in FC_SHAPES]
    runs.append((FC_SHAPES[0], torch.float32, FC_BATCH_F32, False, None))
    runs.append((FC_SHAPES[0], torch.bfloat16, FC_BATCH, True,
                 torch.float32))
    FC.reset_launches()
    for (ci, co, hw), dtype, B, norm, wdtype in runs:
        args = fc_case(g, B, ci, co, hw, dtype, norm, wdtype)
        x, sc, sh, w, dz, ds, dss = args
        relu = norm
        before = dict(FC.ROUTE_LAUNCHES)
        got = FC._fwd_cuda(x, sc, sh, w, relu)
        want = FC.fused_fwd_reference(x, sc, sh, w, relu)
        z = want[0]
        gotb = FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss, relu)
        wantb = FC.fused_bwd_reference(x, sc, sh, w, z, dz, ds, dss, relu)
        torch.cuda.synchronize()
        routes = (FC.fwd_route(x.dtype, w.dtype),
                  *FC.bwd_routes(x.dtype, w.dtype))
        moved = {k: FC.ROUTE_LAUNCHES[k] - before[k] for k in before}
        want_moved = {f"{k}:{r}": int(route == r)
                      for k, route in zip(("fused_conv_fwd",
                                           "fused_conv_bwd_dx",
                                           "fused_conv_bwd_dw"), routes)
                      for r in ("wgmma", "simt")}
        if moved != want_moved:
            raise AssertionError(f"route counts {moved}, expected "
                                 f"{want_moved}")
        f32 = dtype == torch.float32
        abs_z = abs_dx = None
        if not f32:
            abs_z, abs_dx = fused_conv_abs_sums(x, sc, sh, w, z, dz, ds,
                                                dss, relu)
        parts = [("fused_conv_fwd", n, a, b, s_) for n, a, b, s_ in
                 zip(("z", "sum", "sumsq"), got, want, (abs_z, None, None))]
        parts += [("fused_conv_bwd", n, a, b, s_) for n, a, b, s_ in
                  zip(("dx", "dW", "dscale", "dshift"), gotb, wantb,
                      (abs_dx, None, None, None))
                  if norm or n in ("dx", "dW")]
        tag = ("norm relu" if norm else "identity") + (
            f", W {str(w.dtype)[6:]}" if w.dtype != x.dtype else "")
        key = f"B{B} {ci}x{co}x{hw} {str(dtype)[6:]} {tag}"
        worst, shown, missed, reading = {}, [], [], {}
        for kname, name, a, b, abs_sum in parts:
            e = (a.float() - b.float()).abs().max().item()
            near = name in ("z", "dx")
            if abs_sum is None:
                limit = (REL_FC_NEAR if near else REL_FC_FAR) * \
                    b.float().abs().max().item()
                shown.append(f"{name} {e:.2e}/{limit:.2e}")
                if not e <= limit:
                    missed.append(f"{kname} {name}: {e} > {limit}")
            else:
                nums, miss = judge_bf16_sum(a, b, abs_sum)
                reading[name] = nums
                shown.append(f"{name} {nums['sum_units']:.3f} units of "
                             f"2^-20 ({nums['ulps']:.0f} ulp), "
                             f"{nums['share']:.2e}/{SHARE_FC_BF16:.0e} "
                             f"differ")
                missed += [f"{kname} {name}: {m}" for m in miss]
            worst[kname] = max(worst.get(kname, 0.0), e)
        into = errs if f32 else errs16
        for kname in ("fused_conv_fwd", "fused_conv_bwd"):
            into[kname] = max(into.get(kname, 0.0), worst[kname])
        log(f"  {key} (fwd {routes[0]}, dx {routes[1]}, dW {routes[2]}): "
            + ", ".join(shown))
        if not f32 and wdtype is None:
            bad_z, bad_dx = fused_conv_mutants(x, sc, sh, w, z, dz, ds,
                                               dss, relu)
            for name, bad, want_, abs_sum in (
                    ("z, xn unrounded", bad_z, want[0], abs_z),
                    ("dx, dz_eff unrounded", bad_dx, wantb[0], abs_dx)):
                nums, miss = judge_bf16_sum(bad, want_, abs_sum)
                reading[f"mutant {name}"] = nums
                log(f"    mutant {name}: {nums['sum_units']:.3g} units of "
                    f"2^-20, {nums['share']:.3g} differ: "
                    + ("refused" if miss else "PASSED"))
                if not miss:
                    missed.append(f"the mutant {name} passes the limit")
            del bad_z, bad_dx
        readings[key] = reading
        if missed:
            raise AssertionError(
                f"disagreement with the plain versions at B{B} "
                f"{(ci, co, hw)} {dtype}: {'; '.join(missed)}")
        del args, x, z, dz, got, want, gotb, wantb, abs_z, abs_dx
    return errs, errs16, dict(FC.ROUTE_LAUNCHES), readings


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
    forward and backward through the autograd Function on the card (the
    kernels), judged by the chain limits against two references: the
    chain through the plain versions forward and backward, on the
    gradients that no ReLU mask of conv3 moves (`CHAIN_FLIP_FREE`), and
    the plain backward at the kernels' own forward values (the forward
    is deterministic, so it sees the same z, stats and masks), on all of
    them. Each limit against the plain chain is given its two readings
    here: the plain forward summed in float64 (a correct sum in another
    order) must pass it, and the plain versions with their bf16 operands
    left in float32 (`rounded=False`) must be refused at every stage.
    Every reading is printed before a miss raises. Returns (launches,
    launches by route, {stage: {reading: {"max_rel": each gradient's
    largest error of its largest entry, "rel_l2": its relative L2
    error}}})."""
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
    on_tc = {k: FC.ROUTE_LAUNCHES[f"{k}:wgmma"] for k in (
        "fused_conv_fwd", "fused_conv_bwd_dx", "fused_conv_bwd_dw")}
    if on_tc != {"fused_conv_fwd": launches["fused_conv_fwd"],
                 "fused_conv_bwd_dx": launches["fused_conv_bwd"],
                 "fused_conv_bwd_dw": launches["fused_conv_bwd"]}:
        raise AssertionError(f"bf16 fused_conv launches off the tensor "
                             f"cores: {FC.ROUTE_LAUNCHES}")
    routes = {k: v for k, v in FC.ROUTE_LAUNCHES.items() if v}

    def through(fwd, bwd):
        return lambda x, scale, shift, w, relu=True: FC._FusedConv.apply(
            x, scale, shift, w, bool(relu), fwd, bwd)

    def fwd_float64(x, scale, shift, w, relu=True):
        xn = FC._act_in(x, scale, shift, relu)[0].double()
        z = torch.matmul(w.double(), xn)
        return (z.float().to(x.dtype), z.sum((0, 2)).float(),
                (z * z).sum((0, 2)).float())

    def unrounded(fn):
        return lambda *a: fn(*a, rounded=False)

    names = ("x", "W1", "W3", "gamma1", "beta1", "gamma3", "beta3")

    def judge(mine, want, judged):
        rel = {n: (a - b).abs().max().item() / b.abs().max().item()
               for n, a, b in zip(names, mine, want)}
        l2 = {n: ((a - b).norm() / b.norm()).item()
              for n, a, b in zip(names, mine, want)}
        missed = [f"{n}: max {rel[n]:.3g} > {REL_FC_CHAIN}" for n in judged
                  if not rel[n] <= REL_FC_CHAIN]
        for n in judged:
            limit = L2_CHAIN_BF16 if n in ("x", "W1", "W3") else L2_CHAIN_F32
            if not l2[n] <= limit:
                missed.append(f"{n}: relative L2 {l2[n]:.3g} > {limit}")
        return {"max_rel": rel, "rel_l2": l2}, missed

    errs, faults = {}, []
    at_fwd = through(FC._fwd_cuda, FC.fused_bwd_reference)
    f64 = through(fwd_float64, FC.fused_bwd_reference)
    bad = through(unrounded(FC.fused_fwd_reference),
                  unrounded(FC.fused_bwd_reference))
    for (ci, co, hw), inp, mine in zip(stages, inputs, got):
        plain = grads(FC.fused_scale_act_mm_stats_plain, *inp)
        key = f"{ci}x{co}x{hw}"
        errs[key] = {}
        log(f"  stage Ci {ci} Co {co} HW {hw}: max error / largest entry "
            f"and relative L2 of each gradient")
        for reading, a, b, judged, must in (
                ("kernels vs plain backward at their forward", mine,
                 grads(at_fwd, *inp), names, "pass"),
                ("kernels vs plain chain", mine, plain, CHAIN_FLIP_FREE,
                 "pass"),
                ("float64 forward vs plain chain", grads(f64, *inp), plain,
                 CHAIN_FLIP_FREE, "pass"),
                ("unrounded vs plain chain", grads(bad, *inp), plain,
                 CHAIN_FLIP_FREE, "be refused")):
            nums, missed = judge(a, b, judged)
            errs[key][reading] = nums
            ok = not missed if must == "pass" else bool(missed)
            log(f"    {reading} (judged: {', '.join(judged)}): " + ", ".join(
                f"{n} {nums['max_rel'][n]:.2e} {nums['rel_l2'][n]:.2e}"
                for n in names) + f" -> {'; '.join(missed) or 'within'}"
                + ("" if ok else f" (must {must})"))
            if not ok:
                faults.append(f"{key} {reading} must {must}: "
                              f"{'; '.join(missed) or 'within every limit'}")
    if faults:
        raise AssertionError("BN chain gradients: " + " | ".join(faults))
    return launches, routes, errs


def bwd_split_ms(fn, runs=5):
    """The backward kernel's device ms split into its dx half (the dx
    kernel and the second pass of dscale / dshift) and its dW half (the
    dW kernel and its k-range sum), from the device rows of a
    torch.profiler run of `runs` calls (a log line for the next PR: which
    half to take)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    split = {"dx": 0.0, "dw": 0.0}
    for ms, _, name in kernel_rows(prof):
        if "memset" in name.lower():
            continue
        split["dw" if "dw" in name else "dx"] += ms / runs
    return split


def fused_numbers(FC, args):
    """Phase 20: each kernel's time at one shape (bf16, batch 128), its
    bound, its plain version's and the library yardstick's (torch.matmul
    on the materialised activation plus sum and vector_norm squared of z,
    float32-accumulated, for the forward; the two torch.matmuls of the
    backward on the materialised dz_eff), and the backward's split into
    dx and dW."""
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
    rows["fused_conv_bwd"]["split_ms"] = bwd_split_ms(
        lambda: FC._bwd_cuda(x, sc, sh, w, z, dz, ds, dss))
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


# ------------------------------- packed ERNIE-base training (21-24)

def seg_ids(rows):
    """[b, s] int32 segment ids on the card from per-row segment lengths
    (non-decreasing along each row)."""
    return torch.stack([torch.cat([
        torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(r)])
        for r in rows]).to("cuda")


def packed_batch(seed):
    """`bench.py:293` `_packed_varlen`'s batch: P_BATCH sequences from
    RandomState(seed), lengths uniform in [64, 1024] and sorted, token
    ids from the vocabulary; the padded rows with their 1/0 mask, and
    `pack_padded(row_len=1024)` of the same sequences. Returns (padded
    inputs, packed inputs, labels, PackedBatch)."""
    from paddle_tpu_torch.core.lod import pack_padded

    rs = np.random.RandomState(seed)
    lens = np.sort(rs.randint(P_MIN_LEN, E_SEQ + 1, size=P_BATCH))
    ids = np.zeros((P_BATCH, E_SEQ), np.int64)
    mask = np.zeros((P_BATCH, E_SEQ), np.float32)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.randint(1, E_VOCAB, n)
        mask[i, :n] = 1.0
    labels = rs.randint(0, 2, (P_BATCH,)).astype(np.int64)
    pk = pack_padded(ids, lens, row_len=E_SEQ)
    packed = (pk.data, None, None, pk.positions.astype(np.int64),
              pk.segment_ids, pk.cls_flat_index().astype(np.int64))
    return (ids, np.zeros_like(ids), mask), packed, labels, pk


def seg_case(g, b, h, sq, sk, d, dtype, bias, p):
    """Segment-branch operands as the layers produce them ([b, s, h*d]
    projections viewed as [b, h, s, d]), an optional small key bias and
    the dropout spec of one call."""
    from paddle_tpu_torch.ops import attention as A

    def proj(s):
        return torch.randn(b, s, h * d, generator=g, device="cuda") \
            .to(dtype).view(b, s, h, d).transpose(1, 2)
    q, k, v, do = proj(sq), proj(sk), proj(sk), proj(sq)
    kb = (0.5 * torch.randn(b, sk, generator=g, device="cuda")) \
        .contiguous() if bias else None
    return q, k, v, kb, do, A.drop_spec(p, 4321, sq, sk)


def check_segment_kernels(A, g, pk):
    """Phase 21: the segment branch of the three training kernels against
    their plain versions (phase 9's limits) on a small grid and at the
    packed batch's shape, then the exact no-leakage check. Returns
    ({kernel: max_abs_err fp32}, {kernel: max_abs_err bf16}, the packed
    bf16 case and its segment ids)."""
    errs, errs16 = {}, {}
    segs = seg_ids(SEG_GRID)
    b, s = segs.shape
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for bias in (False, True):
                for p in (0.0, E_DROPOUT):
                    case = seg_case(g, b, 2, s, s, 64, dtype, bias, p)
                    judge_train_kernels(
                        A, case, causal, f"b{b} h2 s{s} d64 causal "
                        f"{int(causal)} bias {int(bias)} dropout {p}", errs,
                        errs16, segment_ids=segs)
    kv = seg_ids(SEG_KV)
    case = seg_case(g, b, 2, s, kv.shape[1], 64, torch.float32, True, 0.0)
    judge_train_kernels(A, case, False, f"kv ids differ, s{s} x "
                        f"{kv.shape[1]}", errs, errs16, segment_ids=segs,
                        kv_segment_ids=kv)
    packed = torch.as_tensor(pk.segment_ids, device="cuda")
    rows = packed.shape[0]
    case = seg_case(g, rows, E_HEADS, E_SEQ, E_SEQ, E_HIDDEN // E_HEADS,
                    torch.bfloat16, False, E_DROPOUT)
    judge_train_kernels(A, case, False, f"packed {rows} rows h{E_HEADS} "
                        f"s{E_SEQ} d64 dropout {E_DROPOUT}", errs, errs16,
                        segment_ids=packed)
    no_leakage(A, case, packed)
    return errs, errs16, case, packed


def no_leakage(A, case, segs):
    """Fresh values for every token of an even segment id (q, k, v and
    dO) must leave the output, dq, dk and dv of the odd-id tokens bitwise
    unchanged: the kernels' own forward and backward, dropout on."""
    q, k, v, _, do, drop = case
    odd = (segs % 2 == 1)[:, None, :, None]

    def run(q, k, v, do):
        out, lse = A.flash_attention_fwd(q, k, v, None, False, None, drop,
                                         segs)
        grads = A.flash_attention_bwd(q, k, v, None, out, lse, do, False,
                                      None, drop, True, segs)
        return (out,) + tuple(grads[:3])

    base = run(q, k, v, do)
    moved = run(*(torch.where(odd, t, 3.0 * torch.randn_like(t))
                  for t in (q, k, v, do)))
    torch.cuda.synchronize()
    keep = odd.expand_as(base[0])
    for name, a, w in zip(("out", "dq", "dk", "dv"), base, moved):
        if not torch.equal(a[keep], w[keep]):
            raise AssertionError(f"{name} of a segment moved when only "
                                 f"other segments' inputs changed")
        if torch.equal(a, w):
            raise AssertionError(f"{name}: the perturbation changed nothing")
    log(f"  no leakage: out, dq, dk, dv of the odd segments bitwise equal "
        f"after fresh q, k, v, dO in the even ones")


def packed_training(A, seed, padded, packed, labels, pk):
    """Phase 22: ERNIE-base trained E_STEPS steps on the padded rows and
    on the packed rows (same sequences, model, optimizer and dropout).
    Returns {run: numbers}."""
    want = E_LAYERS * E_STEPS
    res = {}
    for run, inputs in (("padded", padded), ("packed", packed)):
        launches, seg, losses, seq_s, peak, tr, batch = train(
            A, seed, (inputs, labels))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{run}: non-finite loss {losses}")
        want_seg = want if run == "packed" else 0
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if seg[name] != want_seg:
                raise AssertionError(f"{run}: {name} ran its segment branch "
                                     f"{seg[name]} times, expected "
                                     f"{want_seg}")
        rows = batch[0][0].shape[0]
        log(f"  {run}: {rows} rows x {E_SEQ}; losses "
            f"{[round(x, 4) for x in losses]}")
        log(f"  {run}: {seq_s:.2f} seq/s over the last {E_STEPS - 2} steps; "
            f"peak {peak / 2 ** 30:.2f} GiB; launches "
            f"{ {k: launches[k] for k in seg} }, segment branch {seg}, "
            f"bf16 backward copying by element "
            f"{dict(A.ELEMENT_LOAD_LAUNCHES)}")
        prof = profile_training(tr, batch)
        res[run] = {"rows": rows, "seq_per_s": seq_s, "peak_gib":
                    peak / 2 ** 30, "losses": losses,
                    "launches": {k: launches[k] for k in seg},
                    "segment_launches": seg,
                    "busy_share": None if prof is None
                    else prof["busy_share"],
                    "step_ms": None if prof is None else prof["step_ms"],
                    "groups_ms_per_step": None if prof is None
                    else prof["groups_ms_per_step"]}
        del tr, batch
        gc.collect()
        torch.cuda.empty_cache()
    res["packed"]["fill"] = pk.fill
    return res


def packed_logits_agree(A, seed, padded, packed):
    """Phase 23: a 2-layer full-width ERNIE at dropout 0, float32, on the
    card: each sequence's logits from the packed rows against its logits
    from the padded rows, within REL_PACKED of the largest |logit|."""
    model = ernie("cuda", 2, (0.0, 0.0), seed).eval()

    def run(inputs):
        with torch.no_grad():
            return model(*(None if x is None else
                           torch.as_tensor(x, device="cuda")
                           for x in inputs))

    want = run(padded)
    A.reset_launches()
    got = run(packed)
    seg = dict(A.SEG_LAUNCHES)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    limit = REL_PACKED * want.abs().max().item()
    log(f"  {got.shape[0]} sequences: max |packed - padded| logit {err:.3e} "
        f"(limit {limit:.3e}); segment-branch launches {seg}")
    if not err <= limit or seg["flash_fwd"] != 2:
        raise AssertionError(f"packed logits differ from padded: {err}")
    return {"max_abs_err": err, "limit": limit}


def segment_numbers(A, case, segs):
    """Phase 24: the segment branch's time at the packed shape (bf16,
    dropout), its bound over the same-segment pairs these ids visit, the
    plain versions and SDPA with the dense boolean segment mask (a
    yardstick the port never calls)."""
    q, k, v, _, do, drop = case
    b, h, s, d = q.shape
    counts = [torch.unique_consecutive(r, return_counts=True)[1]
              for r in segs.cpu()]
    pairs = h * sum(int((c.long() ** 2).sum()) for c in counts)
    qkv = b * h * s * d * q.element_size()
    row = 4.0 * b * h * s
    ids = 4.0 * b * s
    out, lse = A.flash_attention_fwd(q, k, v, None, False, None, drop, segs)
    delta = A._delta(do, out)
    lse2 = lse.reshape(b * h, s)
    pair_segs = (segs, segs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (segs[:, :, None] == segs[:, None, :])[:, None]
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def lib_fwd_bwd():
        o = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=E_DROPOUT)
        o.backward(do)

    plain_bwd = device_ms(lambda: A.flash_attention_bwd_plain(
        q, k, v, None, out, lse, do, False, None, drop, False, segs),
        runs=10)
    lib_fb = device_ms(lib_fwd_bwd, runs=10)
    lib_b = sdpa_backward_ms(q, k, v, mask, do)
    rows = {}
    for name, mult, nbytes, fn, plain, lib in (
            ("flash_fwd", 4, 4 * qkv + row + ids,
             lambda: A._flash_fwd_cuda(q, k, v, None, False, None, drop,
                                       pair_segs),
             device_ms(lambda: A.flash_attention_fwd_plain(
                 q, k, v, None, False, None, drop, segs), runs=10),
             device_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                    dropout_p=E_DROPOUT), runs=10)),
            ("flash_bwd_dq", 6, 5 * qkv + 2 * row + ids,
             lambda: A._flash_bwd_dq_cuda(q, k, v, None, do, lse2, delta,
                                          False, None, drop, pair_segs),
             plain_bwd, lib_b),
            ("flash_bwd_dkv", 8, 6 * qkv + 2 * row + ids,
             lambda: A._flash_bwd_dkv_cuda(q, k, v, None, do, lse2, delta,
                                           False, None, drop, False,
                                           pair_segs),
             plain_bwd, lib_b)):
        t_ops = mult * pairs * d / BF16_FLOPS_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S
        ms = device_ms(fn)
        rows[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes"}
        log(f"  {name} packed {b} rows h{h} s{s} d{d} bf16 segments "
            f"dropout: kernel {ms:.4f} bound {rows[name]['bound_ms']:.4f} "
            f"({rows[name]['bound_by']}) plain {plain:.4f} sdpa+mask "
            f"{lib:.4f}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_fwd_bwd_ms"] = lib_fb
    tiles = visited_tiles(segs)
    log(f"  same-segment pairs {pairs} of {b * h * s * s} "
        f"({100 * pairs / (b * h * s * s):.1f}%); query x key tiles of 64 x "
        f"64 that seg_window's rule visits per head (counted on the host "
        f"from the ids) {tiles[0]} of {tiles[1]}; the three kernels "
        f"{sum(r['ms'] for r in rows.values()):.4f} ms, sdpa backward alone "
        f"with the mask {lib_b:.4f} ms, forward + backward {lib_fb:.4f} ms")
    return rows


def visited_tiles(segs, tile=64):
    """(tiles visited, all tiles) over the rows of [b, s] segment ids, per
    head: each query tile visits the key tiles of its ids' range
    (`seg_window` in csrc/flash_common.cuh), and with the key ids equal
    to the query ids each key tile visits as many query tiles."""
    ids = segs.cpu().numpy()
    b, s = ids.shape
    n = -(-s // tile)
    visited = 0
    for r in ids:
        for t in range(n):
            own = r[t * tile:(t + 1) * tile]
            lo = int(np.searchsorted(r, own.min(), "left"))
            hi = int(np.searchsorted(r, own.max(), "right"))
            visited += -(-hi // tile) - lo // tile
    return visited, b * n * n


# ------------------------------------------- ERNIE-base pretraining (25)

def pretrain_model(device, layers, dropout, seed):
    from paddle_tpu_torch.text import ErnieConfig, ErnieForPretraining

    cfg = ErnieConfig.base(num_layers=layers, hidden_dropout=dropout[0],
                           attn_dropout=dropout[1])
    return ErnieForPretraining(
        cfg, device=device, generator=torch.Generator().manual_seed(seed))


def pretrain_batch(seed, b, s, vocab):
    """(ids, token types, attention mask), labels [b, s + 1]: random ids,
    PT_MASK of the positions replaced by the [MASK] id 3 with their ids
    as masked-LM targets (-1 elsewhere), then a random next-sentence
    label in the last column."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, vocab, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    mask = np.ones((b, s), np.float32)
    masked = rs.rand(b, s) < PT_MASK
    labels = np.full((b, s + 1), -1, np.int64)
    labels[:, :s][masked] = ids[masked]
    ids[masked] = 3
    labels[:, s] = rs.randint(0, 2, b)
    return (ids, tt, mask), labels


def pretrain_loss(outs, labels):
    """The masked-position cross-entropy plus the NSP cross-entropy, in
    float32."""
    mlm, nsp = outs
    tgt = labels[:, :-1]
    mlm_loss = torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, mlm.shape[-1]), tgt.reshape(-1),
        ignore_index=-1)
    return mlm_loss + torch.nn.functional.cross_entropy(nsp.float(),
                                                        labels[:, -1])


def no_decay_rule(name):
    """The recipe's decay rule: no decay on biases and norms."""
    return not (name.endswith("bias") or "norm" in name)


def pretrain_recipe(model):
    """The eager AdamW of the ERNIE / BERT pretraining recipe over the
    model's named parameters."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as O

    sched = O.lr.LinearWarmup(O.lr.PolynomialDecay(PT_LR, PT_DECAY, 0.0),
                              PT_WARMUP, 0.0, PT_LR)
    return O.AdamW(sched, parameters=model.named_parameters(),
                   weight_decay=0.01,
                   grad_clip=tnn.ClipGradByGlobalNorm(1.0),
                   apply_decay_param_fun=no_decay_rule)


def pretrain_trainer(model, seed, device, remat=False, compute_dtype=None,
                     accum=PT_ACCUM):
    from paddle_tpu_torch.parallel import SpmdTrainer

    return SpmdTrainer(model, pretrain_loss, pretrain_recipe(model),
                       compute_dtype=compute_dtype, device=device,
                       generator=torch.Generator().manual_seed(seed),
                       remat=remat, grad_accum=accum)


def pretrain(A, seed, remat):
    """Phase 25 (a, b): ERNIE-base pretraining, PT_UPDATES updates of
    PT_ACCUM micro-batches on one batch, bf16 compute on float32 masters,
    dropout 0.1. Checks every loss finite and the attention kernels'
    launches: dq and dk/dv layers x micro-batches x updates, the forward
    as many (twice as many under remat: the recompute runs it again), all
    on the tensor-core routes, none copying by element. Returns a dict of
    the numbers, the trainer and the batch."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = pretrain_model("cuda", E_LAYERS, (E_DROPOUT, E_DROPOUT), seed)
    tr = pretrain_trainer(model, seed, "cuda", remat, "bfloat16")
    inputs, labels = pretrain_batch(seed, PT_BATCH * PT_ACCUM, PT_SEQ,
                                    model.ernie.cfg.vocab_size)
    inputs = tuple(torch.as_tensor(x, device="cuda") for x in inputs)
    labels = torch.as_tensor(labels, device="cuda")
    torch.cuda.synchronize()
    A.reset_launches()
    losses = []
    for i in range(PT_UPDATES):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.step(inputs, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: A.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}
    routes, element = dict(A.ROUTE_LAUNCHES), dict(A.ELEMENT_LOAD_LAUNCHES)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() - before
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite pretraining loss: {losses}")
    want = E_LAYERS * PT_ACCUM * PT_UPDATES
    expect = {"flash_fwd": want * (2 if remat else 1),
              "flash_bwd_dq": want, "flash_bwd_dkv": want}
    if launches != expect:
        raise AssertionError(f"pretraining launches {launches}, expected "
                             f"{expect} (remat {remat})")
    if routes["flash_fwd:wgmma"] != launches["flash_fwd"] or \
            any(element.values()):
        raise AssertionError(f"pretraining attention off the tensor-core "
                             f"routes: {routes}, copying by element "
                             f"{element}")
    seq_s = PT_BATCH * PT_ACCUM * (PT_UPDATES - 2) / wall
    return {"losses": losses, "seq_per_s": seq_s, "peak_bytes": peak,
            "launches": launches, "remat": remat}, tr, (inputs, labels)


def optimizer_kernels(tr, grads, steps=3):
    """Phase 25 (c): one optimizer step under torch.profiler on the
    model's parameters and one update's gradients ({name: tensor}): the
    trainer's own update (its functional rule, `from_eager`, and the copy
    into the parameters), and the eager AdamW of the same recipe on its
    multi-tensor path and on its per-parameter path (`_use_fused =
    False`). Each path runs one step before (slots) and `steps` timed on
    the host clock. Returns {path: {kernels, device_ms, host_ms}}."""
    from torch.profiler import ProfilerActivity, profile

    model = tr.layer
    names = list(tr.params)

    def trainer_update():
        with torch.no_grad():
            new, tr.opt_state = tr.tx.update(
                {n: p.detach() for n, p in tr.params.items()}, grads,
                tr.opt_state)
            torch._foreach_copy_([tr.params[n].detach() for n in names],
                                 [new[n] for n in names])

    paths = {"trainer_update": trainer_update}
    for path in ("multi_tensor", "per_param"):
        opt = pretrain_recipe(model)
        opt._use_fused = path == "multi_tensor"
        paths[path] = opt.step
    out = {}
    for path, step in paths.items():
        for n, p in model.named_parameters():
            p.grad = grads[n]
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        out[path] = {"kernels": sum(r[1] for r in rows),
                     "device_ms": sum(r[0] for r in rows), "host_ms": host}
        log(f"  (c) optimizer step, {path}: {out[path]['kernels']} device "
            f"kernels, {out[path]['device_ms']:.3f} device ms, "
            f"{host:.2f} ms on the host clock")
    for p in model.parameters():
        p.grad = None
    return out


def optimizer_paths_agree(tr, batch):
    """Phase 25 (d): the eager AdamW recipe's multi-tensor step and its
    per-parameter path on two copies of the model's parameters, fed the
    same gradients (one update's, scaled per update) for PT_PATH_UPDATES
    updates with the schedule stepped after each: the parameters and
    every slot must be equal bit for bit, and the parameters must have
    moved."""
    _, grads = tr.loss_and_grads(*batch)
    copies, opts = [], []
    for fused in (True, False):
        m = pretrain_model("cuda", E_LAYERS, (0.0, 0.0), 0)
        m.load_state_dict(tr.layer.state_dict())
        opt = pretrain_recipe(m)
        opt._use_fused = fused
        copies.append(m)
        opts.append(opt)
    from paddle_tpu_torch.optimizer import fused

    start = {n: p.detach().clone() for n, p in tr.layer.named_parameters()}
    took, restore = call_log(fused, "apply", key=lambda opt, _: id(opt))
    try:
        for k in range(PT_PATH_UPDATES):
            for m, opt in zip(copies, opts):
                for n, p in m.named_parameters():
                    p.grad = grads[n] * (1.0 + 0.25 * k)
                opt.step()
                opt._lr.step()
    finally:
        restore()
    if took[id(opts[0])] != PT_PATH_UPDATES or took[id(opts[1])]:
        raise AssertionError(f"the two AdamW steps did not take their "
                             f"paths: multi-tensor steps {dict(took)}")
    diff = [n for (n, a), b in zip(copies[0].named_parameters(),
                                   copies[1].parameters())
            if not torch.equal(a, b)]
    sa, sb = opts[0].state_dict(), opts[1].state_dict()
    diff += [k for k, v in sa.items() if isinstance(v, torch.Tensor)
             and not torch.equal(v, sb[k])]
    moved = sum(not torch.equal(p.detach(), start[n])
                for n, p in copies[0].named_parameters())
    slots = sum(isinstance(v, torch.Tensor) for v in sa.values())
    log(f"  (d) multi-tensor against per-parameter AdamW, "
        f"{PT_PATH_UPDATES} updates: {len(diff)} of {len(start)} parameters "
        f"and {slots} slots differ; {moved} parameters moved")
    if diff or moved < len(start) // 2:
        raise AssertionError(f"the multi-tensor step and the per-parameter "
                             f"path differ on the card: {diff[:8]} "
                             f"({moved} parameters moved)")
    return {"params": len(start), "slots": slots, "differ": len(diff),
            "moved": moved}


def run_epoch_timing(tr, seed, batches=4, chunk=2):
    """Phase 25 (f): `run_epoch` (pinned chunks staged on a side stream)
    against a loop of `step`, both fed the same host (numpy) batches,
    timed on the host clock as loop, run_epoch, loop. Every loss must be
    finite. Returns the three times in ms an update."""
    data = [pretrain_batch(seed + 2 + i, PT_BATCH * PT_ACCUM, PT_SEQ,
                           tr.layer.ernie.cfg.vocab_size)
            for i in range(batches)]

    def loop():
        return [tr.step(x, y) for x, y in data][-1]

    def epoch():
        return tr.run_epoch(iter(data), chunk=chunk)

    out, losses = {}, []
    for name, run in (("loop", loop), ("run_epoch", epoch),
                      ("loop_again", loop)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(run()))
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / batches
    log(f"  (f) {batches} updates from host batches, ms an update: loop of "
        f"step {out['loop']:.2f}, run_epoch (chunk {chunk}) "
        f"{out['run_epoch']:.2f}, loop again {out['loop_again']:.2f}; "
        f"last losses {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in (f): {losses}")
    return out


def pretrain_card_vs_cpu(seed):
    """Phase 25 (e): a 2-layer full-width pretraining model in float32
    (attention dropout 0.1, hidden dropout 0: the hidden masks come from
    a device generator) through the recipe trainer on the card and on the
    CPU, batch 2 x 512 in 2 micro-batches: the loss and gradients of one
    batch (as phase 11), then two updates (the first at the warmup's rate
    0). Losses rtol 1e-4,
    gradients and the parameters after the updates within 1e-4 relative
    L2, and the updates themselves (parameters after less before) within
    1e-3 relative L2: the update is ~3e-5 of the parameters' norm, so the
    parameter check alone would pass an update dropped whole."""
    inputs, labels = pretrain_batch(seed + 1, 2, PT_SEQ, 18000)
    res = {}
    for dev in ("cuda", "cpu"):
        model = pretrain_model(dev, 2, (0.0, E_DROPOUT), seed)
        start = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        tr = pretrain_trainer(model, seed, dev, accum=2)
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(inputs, labels)
        losses = [float(loss)] + [float(tr.step(inputs, labels))
                                  for _ in range(2)]
        res[dev] = (losses, {n: g.cpu() for n, g in grads.items()},
                    {n: p.detach().cpu()
                     for n, p in model.named_parameters()})
        log(f"  (e) {dev}: losses {losses} in "
            f"{time.perf_counter() - t0:.2f} s")

    def rel(a, b):
        num = sum(float((a[n] - b[n]).double().pow(2).sum()) for n in b)
        den = sum(float(b[n].double().pow(2).sum()) for n in b)
        return (num / den) ** 0.5

    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = res["cuda"], res["cpu"]
    upd = rel({n: p_gpu[n] - start[n] for n in start},
              {n: p_cpu[n] - start[n] for n in start})
    out = {"losses_card": l_gpu, "losses_cpu": l_cpu,
           "grad_rel_l2": rel(g_gpu, g_cpu),
           "param_rel_l2": rel(p_gpu, p_cpu), "update_rel_l2": upd}
    log(f"  (e) gradients relative L2 {out['grad_rel_l2']:.3e}, parameters "
        f"after two updates {out['param_rel_l2']:.3e}, the updates "
        f"themselves {upd:.3e} (limits 1e-4, 1e-4, 1e-3)")
    if not all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(l_gpu, l_cpu)):
        raise AssertionError(f"card losses {l_gpu} != CPU losses {l_cpu}")
    if not (out["grad_rel_l2"] <= 1e-4 and out["param_rel_l2"] <= 1e-4
            and upd <= 1e-3):
        raise AssertionError(f"card against CPU: {out}")
    return out


def tensor_core_report():
    """Phase 1b: the tensor-core instructions in the SASS of the six
    libraries with tensor-core kernels (`cuobjdump -sass`): HGMMA (wgmma)
    in each, which must have some, and in flash_fwd also HMMA (its float32
    kernels' TF32 mma.sync), which must have some; and ptxas's registers
    and spills of their tensor-core kernels. Returns {library: HGMMA
    count}."""
    from paddle_tpu_torch.ops import _build

    info = _build.build_info()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for stem in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "fused_conv_fwd", "fused_conv_bwd", "int8_matmul"):
        sass = subprocess.run(
            [tool, "-sass", os.path.join(info["dir"], f"lib{stem}.so")],
            capture_output=True, text=True, check=True, timeout=120).stdout
        lines = sass.splitlines()
        counts[stem] = sum("HGMMA" in line for line in lines)
        hmma = sum("HMMA" in line and "HGMMA" not in line for line in lines)
        usage, mma = [], False
        for ln in (info.get("logs") or {}).get(stem, "").splitlines():
            if "Compiling entry" in ln:
                mma = any(k in ln for k in ("_mma", "tf32", "wgmma"))
            elif mma and ("registers" in ln or "spill" in ln):
                usage.append(ln.split(" : ")[-1].strip())
        log(f"  {stem}: {counts[stem]} HGMMA"
            + (f", {hmma} HMMA" if stem == "flash_fwd" else "")
            + f" instructions in the SASS; tensor-core kernels: "
            f"{'; '.join(usage) or 'cached'}")
        if counts[stem] == 0 or (stem == "flash_fwd" and hmma == 0):
            raise AssertionError(f"{stem}: no tensor-core instructions of "
                                 f"its kernels in its SASS")
    return counts


def merge_kernel_report():
    """Phase 1c: ptxas's registers and spills of each instance of the
    kernels on `csrc/attn_merge.cuh` (flash_decode_kernel,
    flash_verify_kernel, paged_decode_kernel, paged_split_kernel: R query
    rows a block hold R x d / 8 q and accumulator values a lane).
    Returns {kernel: [(mangled name, registers, spill store bytes)]},
    empty where an earlier process built the kernels."""
    import re

    from paddle_tpu_torch.ops import _build

    logs = _build.build_info().get("logs") or {}
    out = {}
    for stem, key in (("flash_decode", "flash_decode_kernel"),
                      ("flash_verify", "flash_verify_kernel"),
                      ("paged_decode", "paged_decode_kernel"),
                      ("paged_verify", "paged_split_kernel")):
        rows, name, spill = [], None, 0
        for ln in logs.get(stem, "").splitlines():
            if "Compiling entry" in ln:
                name = ln.split("'")[1] if key in ln else None
            elif name and "spill stores" in ln:
                spill = int(re.search(r"(\d+) bytes spill stores", ln)[1])
            elif name and "registers" in ln:
                rows.append((name, int(re.search(r"Used (\d+) registers",
                                                 ln)[1]), spill))
                name = None
        out[key] = rows
        log(f"  {key}: " + ("; ".join(f"{n[-28:]} {r} regs, {sp} B spilled"
                                      for n, r, sp in rows) or "cached"))
    return out


def launch_counts():
    from paddle_tpu_torch.ops import _build

    return _build.launches()


# ------------------------------------------ decoding and shaping (26-28)

def encoded(model, embed, rs, n):
    """n source memories [n, SRC_LEN, D] encoded on the card from random
    source tokens (every position real)."""
    src = torch.as_tensor(rs.randint(2, VOCAB, (n, SRC_LEN)), device="cuda")
    with torch.inference_mode():
        return model.encoder(embed(src))


def beam_rows_agree(label, card, cpu):
    """Phase 26 (b): the card's beams against the CPU's, row by row. Equal
    tokens and lengths need scores within REL_BEAM; a row whose beams
    differ passes only as a tie, when its best-first scores still agree
    within REL_BEAM (two beam sets of the same scores). Returns (ties,
    worst relative score error)."""
    (ct, cs, cl), (pt, ps, pl) = card, cpu
    ties, worst = 0, 0.0
    for b in range(ct.shape[0]):
        rel = float(np.max(np.abs(cs[b] - ps[b]) /
                           np.maximum(np.abs(ps[b]), 1e-30)))
        worst = max(worst, rel)
        same = np.array_equal(ct[b], pt[b]) and np.array_equal(cl[b], pl[b])
        if not rel <= REL_BEAM:
            raise AssertionError(f"{label} row {b}: scores {cs[b]} vs "
                                 f"{ps[b]} (relative {rel:.3e})")
        if not same:
            ties += 1
            log(f"  {label} row {b}: beams differ with scores within "
                f"{rel:.3e}: a tie")
    return ties, worst


def decode_engine_phase(A, seed):
    """Phase 26: DecodeEngine at Transformer-base width. Returns
    ({path: launches}, summary)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.text.decode import map_state
    from paddle_tpu_torch.text.generation import (DecodeEngine, _StepNet,
                                                  generate_eager)
    from paddle_tpu_torch.text.speculative import DraftModel

    model, embed, project = build_model(seed, "cuda")
    net = _StepNet(model.decoder, embed, project).eval()
    rs = np.random.RandomState(seed + 26)
    memory = encoded(model, embed, rs, DE_BATCH)
    lens = rs.randint(DE_PROMPT // 2 + 1, DE_PROMPT + 1, DE_BATCH)
    lens[0] = DE_PROMPT
    prompt = rs.randint(2, VOCAB, (DE_BATCH, DE_PROMPT))
    prompt[:, 0] = 0
    rows = [prompt[i, :lens[i]] for i in range(DE_BATCH)]
    mems = [memory[i] for i in range(DE_BATCH)]
    eng = DecodeEngine(model.decoder, embed, project, device="cuda")
    kw = dict(bos_id=0, eos_id=1, max_new_tokens=DE_NEW)
    eng.generate(memory, prompt, lens, **dict(kw, max_new_tokens=2))
    paths, out = {}, {}

    def timed(label, **extra):
        torch.cuda.synchronize()
        A.reset_launches()
        t0 = time.perf_counter()
        res = eng.generate(memory, prompt, lens, **kw, **extra)
        torch.cuda.synchronize()
        paths[label] = dict(A.LAUNCHES)
        return res, time.perf_counter() - t0

    # (a) greedy against the eager oracle on the card
    (toks, tl), wall = timed("decode_greedy")
    steps = min(int(tl.max()), DE_NEW) - 1
    et, el = generate_eager(model.decoder, embed, project, memory, prompt,
                            lens, **kw)
    greedy = [list(toks[i][:tl[i]]) for i in range(DE_BATCH)]
    ties = same_tokens("DecodeEngine greedy",
                       [list(et[i][:el[i]]) for i in range(DE_BATCH)],
                       greedy, net, rows, mems)
    got = paths["decode_greedy"]
    log(f"  (a) greedy b{DE_BATCH}, prompts {sorted(lens.tolist())} (bucket "
        f"{DE_PROMPT}), {DE_NEW} new tokens: {1e3 * wall / (steps + 1):.2f} "
        f"ms a token ({DE_BATCH * (steps + 1) / wall:.1f} tokens/s); tokens "
        f"equal generate_eager's ({ties} ties); launches {got}")
    if got["flash_decode"] != LAYERS * steps or got["flash_fwd"] < 1:
        raise AssertionError(f"greedy: flash_decode launches "
                             f"{got['flash_decode']} != {LAYERS} layers x "
                             f"{steps} steps, or no flash_fwd prefill")
    out["greedy_ms_per_token"] = 1e3 * wall / (steps + 1)
    split = out["greedy_profile"] = {}
    profile_call("greedy generate", lambda: eng.generate(
        memory, prompt, lens, **kw), ("flash_fwd", "flash_decode_kernel"),
        split)

    # (b) beam 4, then the beam regather's cost and a 2-layer card-vs-CPU
    (bt, bs, bl), wall = timed("decode_beam", beam_size=DE_BEAM)
    bsteps = DE_NEW - 1
    got = paths["decode_beam"]
    rows_kv = DE_BATCH * DE_BEAM
    state = [t for layer in model.decoder.layers
             for t in layer.self_attn.gen_cache(
                 None, max_length=DE_PROMPT + DE_NEW, batch_size=rows_kv,
                 dtype=torch.float32)[:2]]
    flat = torch.randperm(rows_kv, device="cuda")
    gather_ms = device_ms(lambda: map_state(
        lambda t: t.index_select(0, flat), state))
    gather_bytes = 2.0 * sum(t.numel() * t.element_size() for t in state)
    log(f"  (b) beam {DE_BEAM}: {DE_BATCH * DE_BEAM * DE_NEW / wall:.1f} "
        f"beam tokens/s ({DE_BATCH * DE_NEW / wall:.1f} best-beam tokens/s, "
        f"{1e3 * wall / DE_NEW:.2f} ms a step); launches {got}; the "
        f"regather of {len(state)} cache tensors by parent: {gather_ms:.4f} "
        f"ms a step (bound {1e3 * gather_bytes / HBM_BYTES_PER_S:.4f}, "
        f"{gather_bytes / 2 ** 20:.1f} MiB read + written)")
    if got["flash_decode"] != LAYERS * bsteps:
        raise AssertionError(f"beam: flash_decode launches "
                             f"{got['flash_decode']} != {LAYERS} x {bsteps}")
    out.update(beam_tokens_per_s=DE_BATCH * DE_BEAM * DE_NEW / wall,
               beam_regather_ms=gather_ms, beam_profile={})
    profile_call("beam generate", lambda: eng.generate(
        memory, prompt, lens, beam_size=DE_BEAM, **kw),
        ("flash_fwd", "flash_decode_kernel", "gather_kernel", "RadixSort"),
        out["beam_profile"])
    res = {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(seed + 260)
        small = nn.TransformerDecoder(nn.TransformerDecoderLayer(
            D_MODEL, HEADS, FFN, dropout=0.0, device=dev, generator=gen),
            DE_DRAFT_LAYERS).eval()
        e2 = nn.Embedding(VOCAB, D_MODEL, device=dev, generator=gen).eval()
        p2 = nn.Linear(D_MODEL, VOCAB, device=dev, generator=gen).eval()
        t0 = time.perf_counter()
        res[dev] = DecodeEngine(small, e2, p2, device=dev).generate(
            memory.to(dev), prompt, lens, beam_size=DE_BEAM, **kw)
        log(f"      {DE_DRAFT_LAYERS}-layer beam {DE_BEAM} on the {dev}: "
            f"{time.perf_counter() - t0:.2f} s")
    bties, worst = beam_rows_agree("beam card vs CPU", res["cuda"],
                                   res["cpu"])
    log(f"      card vs CPU: tokens and lengths equal in "
        f"{DE_BATCH - bties} of {DE_BATCH} rows ({bties} ties), worst "
        f"relative score error {worst:.3e} (limit {REL_BEAM})")
    out.update(beam_card_vs_cpu_worst_rel=worst, beam_ties=bties)

    # (c) speculative: the n-gram draft, then a DraftModel of other weights
    gen = torch.Generator().manual_seed(seed + 261)
    dm = DraftModel(
        nn.TransformerDecoder(nn.TransformerDecoderLayer(
            D_MODEL, HEADS, FFN, dropout=0.0, device="cuda", generator=gen),
            DE_DRAFT_LAYERS).eval(),
        nn.Embedding(VOCAB, D_MODEL, device="cuda", generator=gen).eval(),
        nn.Linear(D_MODEL, VOCAB, device="cuda", generator=gen).eval())
    for label, extra in (("decode_spec_ngram", {}),
                         ("decode_spec_draft", {"draft_model": dm})):
        (st, sl, stats), wall = timed(label, spec_k=SPEC_K,
                                      return_spec_stats=True, **extra)
        spec = [list(st[i][:sl[i]]) for i in range(DE_BATCH)]
        sties = same_tokens(label, greedy, spec, net, rows, mems)
        got = paths[label]
        rate = stats["accepted"] / max(1, stats["proposed"])
        draft_steps = got["flash_decode"]
        log(f"  (c) {label[12:]}: spec_k {SPEC_K}, {stats['rounds']} rounds, "
            f"acceptance {rate:.4f} ({stats['accepted']} of "
            f"{stats['proposed']} drafts), {1e3 * wall / DE_NEW:.2f} ms a "
            f"token; flash_verify launches {got['flash_verify']} "
            f"(= {LAYERS} x rounds), the draft's flash_decode launches "
            f"{draft_steps}; tokens equal greedy's ({sties} ties)")
        if got["flash_verify"] != LAYERS * stats["rounds"]:
            raise AssertionError(f"{label}: flash_verify launches "
                                 f"{got['flash_verify']} != {LAYERS} x "
                                 f"{stats['rounds']} rounds")
        out[f"{label[12:]}_acceptance"] = rate
        out[f"{label[12:]}_rounds"] = stats["rounds"]
    out["draft_profile"] = {}
    profile_call("draft-model spec generate", lambda: eng.generate(
        memory, prompt, lens, spec_k=SPEC_K, draft_model=dm, **kw),
        ("flash_fwd", "flash_decode_kernel", "flash_verify_kernel"),
        out["draft_profile"])
    if not out["draft_acceptance"] < 1.0:
        raise AssertionError("the DraftModel's drafts were never rejected")
    if paths["decode_spec_draft"]["flash_decode"] != \
            DE_DRAFT_LAYERS * SPEC_K * out["draft_rounds"]:
        raise AssertionError("the draft model's steps did not run the "
                             "flash decode k times a round")
    return paths, out


def chunk_requests(seed, memory):
    """Phase 27's traffic: CH_LONG prompts of CH_LONG_LEN tokens among
    CH_SHORT short ones (16-200 tokens), spread through the queue."""
    rs = np.random.RandomState(seed + 27)
    n = CH_LONG + CH_SHORT
    prompts = []
    for i in range(n):
        p = rs.randint(2, VOCAB, CH_LONG_LEN if i % 4 == 1 else
                       int(rs.randint(16, 201)))
        p[0] = 0
        prompts.append(p)
    return prompts, [memory[i % memory.shape[0]] for i in range(n)]


def chunked_phase(A, seed):
    """Phase 27: dense and paged engines with and without chunked prefill
    on the same requests. Returns ({path: launches}, summary)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.generation import _StepNet

    model, embed, project = build_model(seed, "cuda")
    net = _StepNet(model.decoder, embed, project).eval()
    memory = encoded(model, embed, np.random.RandomState(seed + 270), SLOTS)
    prompts, mems = chunk_requests(seed, memory)
    paths, out = {}, {}
    for pool, kw in (("dense", {}), ("paged", dict(paged=True,
                                                   page_size=PAGE))):
        res = {}
        for chunk in (None, CH_CHUNK):
            eng = ServingEngine(model.decoder, embed, project,
                                num_slots=SLOTS, max_len=MAX_LEN,
                                prefill_chunk=chunk, device="cuda", **kw)
            calls, restore = call_log(A, "flash_verify",
                                      key=lambda q, *a: int(q.shape[2]))
            A.reset_launches()
            try:
                toks, wall = run_server(eng, prompts, mems)
            finally:
                restore()
            label = f"chunked_{pool}" if chunk else f"whole_{pool}"
            paths[label] = dict(A.LAUNCHES)
            m = eng.metrics
            gap = m.step_gap_s.summary(1e3)
            res[chunk] = (toks, gap)
            tiled = A.PAGED_ROUTE_LAUNCHES["paged_flash_verify:tiled"]
            log(f"  {pool} prefill_chunk {chunk}: {wall:.3f} s, chunked "
                f"joins {m.chunked_prefills}, chunks {m.chunks}; "
                f"flash_verify launches by T {dict(calls)}; paged tiled "
                f"route {tiled}; decode-step gap p50 "
                f"{gap.get('p50', 0):.2f} ms, p99 {gap.get('p99', 0):.2f} "
                f"ms; launches {paths[label]}")
            if chunk:
                n_chunks = CH_LONG * (CH_LONG_LEN // CH_CHUNK)
                want = n_chunks * LAYERS
                got = calls[CH_CHUNK] if pool == "dense" else tiled
                if m.chunks != n_chunks or got != want:
                    raise AssertionError(
                        f"{pool}: {m.chunks} chunks ({n_chunks} expected), "
                        f"{got} T{CH_CHUNK} verify launches ({want})")
                out[f"{pool}_chunks"] = m.chunks
                out[f"{pool}_t{CH_CHUNK}_verify_launches"] = got
            if pool == "dense" and chunk:
                out["dense_chunked_profile"] = {}
                profile_call(f"{len(prompts)} requests",
                             lambda: run_server(eng, prompts, mems),
                             ("flash_fwd", "flash_decode_kernel",
                              "flash_verify_kernel"),
                             summary=out["dense_chunked_profile"])
            if pool == "paged":
                eng.flush_prefix_cache()
                eng._alloc.check()
        ties = same_tokens(f"{pool} chunked", res[None][0], res[CH_CHUNK][0],
                           net, prompts, mems)
        out[f"{pool}_step_gap_ms"] = {
            "whole": {k: res[None][1].get(k) for k in ("p50", "p99")},
            "chunked": {k: res[CH_CHUNK][1].get(k) for k in ("p50", "p99")}}
        log(f"  {pool}: chunked tokens equal the whole-prompt engine's "
            f"({ties} ties)")
    return paths, out


def verify_chunk_cases(A, g):
    """Phase 27: flash_verify at the dense chunk's shape (b1 h8, T 64 and
    CH_CHUNK, L MAX_LEN, the chunk ending at key CH_LONG_LEN) against its
    plain version, and its timing beside SDPA. Returns (rows, worst fp32
    error, worst bf16 error)."""
    rows, e32, e16 = [], 0.0, 0.0
    for T in (64, CH_CHUNK):
        for dtype in (torch.float32, torch.bfloat16):
            args = ver_case(g, 1, HEADS, T, MAX_LEN, D_MODEL // HEADS,
                            [CH_LONG_LEN], dtype)
            got = A.flash_verify(*args)
            want = A.flash_verify_plain(*args)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            limit = ATOL_KERNEL if dtype == torch.float32 else \
                REL_BF16_ATT * want.float().abs().max().item()
            name = f"chunk b1 h{HEADS} T{T} L{MAX_LEN} " + \
                ("fp32" if dtype == torch.float32 else "bf16")
            if not e <= limit:
                raise AssertionError(f"flash_verify {name}: {e} > {limit}")
            if dtype == torch.float32:
                e32 = max(e32, e)
            else:
                e16 = max(e16, e)
            nums = read_numbers(A, "flash_verify", args)
            rows.append(dict(case=name, max_abs_err=e, **nums))
            log(f"  flash_verify {name}: max_abs_err {e:.3e} (limit "
                f"{limit:.3e}); kernel {nums['ms']:.4f} (whole call "
                f"{nums['whole_call_ms']:.4f}, {nums['plan']}) bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}, "
                f"{nums['bound_peak']}) plain "
                f"{nums['plain_ms']:.4f} sdpa {nums['library_ms']:.4f}")
    return rows, e32, e16


def preempt_requests(seed, memory):
    rs = np.random.RandomState(seed + 28)
    batch = []
    for _ in range(PR_BATCH):
        p = rs.randint(2, VOCAB, PR_BATCH_LEN)
        p[0] = 0
        batch.append(p)
    inter = []
    for _ in range(PR_INTER):
        p = rs.randint(2, VOCAB, int(rs.randint(16, 129)))
        p[0] = 0
        inter.append(p)
    mems = [memory[i % memory.shape[0]] for i in range(PR_BATCH + PR_INTER)]
    return batch, inter, mems


def shaped_serve(eng, sched, batch, inter, mems):
    """Fill the slots with batch-class requests, then let the interactive
    ones arrive. Returns the requests (batch first)."""
    from paddle_tpu_torch.serving import Request

    reqs = [Request(p, mems[i], max_new_tokens=PR_BATCH_NEW, eos_id=1,
                    slo="batch") for i, p in enumerate(batch)]
    for r in reqs:
        sched.submit(r)
    for _ in range(1000):        # every batch request joined
        if all(r.tokens or r.state == "DONE" for r in reqs):
            break
        eng.run_iteration(sched)
    late = [Request(p, mems[len(batch) + i], max_new_tokens=NEW_TOKENS,
                    eos_id=1, slo="interactive")
            for i, p in enumerate(inter)]
    for r in late:
        sched.submit(r)
    eng.serve_until_idle(sched, max_iterations=100000)
    return reqs + late


def preempt_phase(A, seed):
    """Phase 28: a paged engine under ShapingScheduler against a FIFO twin,
    spec_k off and SPEC_K. Returns ({path: launches}, summary)."""
    from paddle_tpu_torch.serving import (Scheduler, ServingEngine,
                                          ShapingScheduler)
    from paddle_tpu_torch.text.generation import _StepNet

    model, embed, project = build_model(seed, "cuda")
    net = _StepNet(model.decoder, embed, project).eval()
    memory = encoded(model, embed, np.random.RandomState(seed + 280), SLOTS)
    batch, inter, mems = preempt_requests(seed, memory)
    prompts = batch + inter
    paths, out = {}, {}
    for spec_k in (None, SPEC_K):
        res = {}
        for kind in ("fifo", "shaped"):
            eng = ServingEngine(model.decoder, embed, project,
                                num_slots=SLOTS, max_len=MAX_LEN, paged=True,
                                page_size=PAGE, spec_k=spec_k, device="cuda")
            sched = (ShapingScheduler(max_queue=64, metrics=eng.metrics)
                     if kind == "shaped" else Scheduler(max_queue=64))
            A.reset_launches()
            t0 = time.perf_counter()
            reqs = shaped_serve(eng, sched, batch, inter, mems)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            label = f"preempt_{kind}{'_spec' if spec_k else ''}"
            paths[label] = dict(A.LAUNCHES)
            for r in reqs:
                if not r.result(timeout=60).ok:
                    raise AssertionError(f"{label}: request {r.id} "
                                         f"finished {r.finish_reason}")
            ttft = np.asarray([1e3 * (r.first_token_at - r.submitted_at)
                               for r in reqs[PR_BATCH:]])
            m = eng.metrics
            res[kind] = ([list(r.tokens) for r in reqs], ttft)
            log(f"  spec_k {spec_k} {kind}: {wall:.3f} s; interactive TTFT "
                f"p50 {np.percentile(ttft, 50):.1f} ms, p99 "
                f"{np.percentile(ttft, 99):.1f} ms; preemptions "
                f"{m.preemptions}, resumes {m.resumes}, replayed tokens "
                f"{m.replay_tokens}, prefills {eng.prefill_count}; launches "
                f"{paths[label]}")
            if kind == "shaped":
                if not (m.preemptions == m.resumes >= 1 and
                        m.replay_tokens > 0):
                    raise AssertionError(
                        f"{label}: preemptions {m.preemptions}, resumes "
                        f"{m.resumes}, replayed tokens {m.replay_tokens}")
                if eng.prefill_count > len(prompts):
                    raise AssertionError(
                        f"{label}: {eng.prefill_count} prefills for "
                        f"{len(prompts)} cold prompts: a resume prefilled")
                out[f"{label}_preemptions"] = m.preemptions
                out[f"{label}_replay_tokens"] = m.replay_tokens
            eng.flush_prefix_cache()
            eng._alloc.check()
            if eng._alloc.pages_free != eng.num_pages:
                raise AssertionError(f"{label}: {eng._alloc.pages_free} of "
                                     f"{eng.num_pages} pages free")
        ties = same_tokens(f"preempt spec_k {spec_k}", res["fifo"][0],
                           res["shaped"][0], net, prompts, mems)
        if not spec_k:
            eng = ServingEngine(model.decoder, embed, project,
                                num_slots=SLOTS, max_len=MAX_LEN, paged=True,
                                page_size=PAGE, device="cuda")
            out["shaped_profile"] = {}
            profile_call("shaped serve", lambda: shaped_serve(
                eng, ShapingScheduler(max_queue=64, metrics=eng.metrics),
                batch, inter, mems), ("flash_fwd", "paged_decode_kernel"),
                out["shaped_profile"])
        out[f"spec{spec_k or 0}_ttft_ms"] = {
            k: {"p50": float(np.percentile(res[k][1], 50)),
                "p99": float(np.percentile(res[k][1], 99))}
            for k in ("fifo", "shaped")}
        log(f"  spec_k {spec_k}: preempted tokens equal the FIFO twin's "
            f"({ties} ties)")
    return paths, out


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
    hgmma = tensor_core_report()
    merge_regs = merge_kernel_report()

    log("phase 2: kernels against their plain versions (fp32, atol "
        f"{ATOL_KERNEL}; bf16 {REL_BF16_ATT} of the largest plain entry)")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    errs, errs16, fwd, dec = check_kernels(A, g)
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
            whole = (f" (one launch a call: {nums['plan']}; kernels a "
                     f"call {nums['kernels_per_call']})"
                     if "kernels_per_call" in nums else "")
            both = (f"; CUDA-core bound {nums['cuda_core_bound_ms']:.4f} "
                    f"({nums['cuda_core_bound_by']}), "
                    f"{100 * nums['bound_share']:.1f}% of the tensor-core "
                    f"bound" if "cuda_core_bound_ms" in nums else "")
            log(f"  {kname} {cname}: kernel {nums['ms']:.4f}{whole}; bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}){both} plain "
                f"{nums['plain_ms']:.4f} sdpa {nums['library_ms']:.4f}; "
                f"{launches[kname] / n_tok:.2f} launches per served token")
        head = rows[0]
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname],
            "max_abs_err_bf16": errs16.get(kname),
            "max_abs_err_emulation": EMU_ERRS.get(kname), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["case"],
            "launches_per_token": launches[kname] / n_tok, "cases": rows}
    profile_serving(engine, served[3], served[4])
    model, embed, project, memory = served[0], served[1], served[2], \
        served[4]

    log(f"phase 5: dense speculative serve, spec_k {SPEC_K}, {SLOTS} "
        f"requests with a {PERIOD}-token period")
    s_launches, s_snap, s_rate, s_prof = spec_serve(A, args.seed, model,
                                                    embed, project, engine,
                                                    memory)

    log(f"phase 5b: rollback: the dense and the paged spec engines on "
        f"{SLOTS} random prompts, every other request with spec = False, "
        f"spec_adapt_low 0.9, patience 1")
    rb_launches, rb_counts = rollback_serve(A, args.seed, model, embed,
                                            project, engine, memory)

    log(f"phase 6: paged serve, page {PAGE}, {REQUESTS} requests with a "
        f"{PREAMBLE}-token shared preamble; then with spec_k {SPEC_K}")
    (p_launches, p_snaps, p_rates, p_tokens, p_prompts, p_mems,
     p_routes) = paged_serve(A, args.seed, model, embed, project, engine,
                             memory[0])

    log("phase 7: int8 pages, 4 requests")
    int8 = int8_serve(A, model, embed, project, p_prompts, p_mems, p_tokens)

    log("phase 8: timing of flash_verify, paged_flash_decode and "
        "paged_flash_verify (median of 25, ms)")
    new_launches = {
        "flash_verify": s_launches["flash_verify"],
        "paged_flash_decode": p_launches["paged"]["paged_flash_decode"],
        "paged_flash_verify": p_launches["paged"]["paged_flash_verify"]
        + p_launches["paged_spec"]["paged_flash_verify"]}
    timed = {"flash_verify": ("spec step b8 h8 T4 L1060 fp32",
                              "spec step b8 h8 T4 L1060 bf16"),
             "paged_flash_decode": ("decode S8 h8 mp67 pages fp32",
                                    "decode S8 h8 mp67 pages int8"),
             "paged_flash_verify": ("spec step S8 h8 T4 mp67 pages fp32",
                                    "tail prefill S8 h8 T256 mp67 pages "
                                    "fp32",
                                    *(f"tail prefill S1 h8 T{T} W"
                                      f"{32 + T // 16} pages fp32"
                                      for T in (64, 256, 512)))}
    sources = {"flash_verify": ("flash_verify.cu", 1580),
               "paged_flash_decode": ("paged_decode.cu", 1750),
               "paged_flash_verify": ("paged_verify.cu", 1939)}
    for kname, cnames in timed.items():
        rows = []
        for cname in cnames:
            nums = read_numbers(A, kname, new_cases[kname][cname])
            rows.append(dict(case=cname, **nums))
            route = (f" [{nums['route']} {nums.get('plan', '')}]"
                     if "route" in nums else
                     f" [{nums['plan']}; kernels a call "
                     f"{nums['kernels_per_call']}]" if "plan" in nums
                     else "")
            log(f"  {kname} {cname}{route}: kernel {nums['ms']:.4f} (whole "
                f"call {nums['whole_call_ms']:.4f}) bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}) plain "
                f"{nums['plain_ms']:.4f} sdpa {nums['library_ms']:.4f} "
                f"(sdpa kernels {nums['library_kernels']})")
        head = rows[0]
        src, line = sources[kname]
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/attention.py:{line}",
            "launches": new_launches[kname],
            "max_abs_err": new_errs[kname],
            "max_abs_err_bf16": new_errs16.get(kname),
            "max_abs_err_emulation": EMU_ERRS.get(kname),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["case"],
            "cases": rows}
    kernels["paged_flash_verify"]["launches_by_path"] = {
        "paged": p_launches["paged"]["paged_flash_verify"],
        "paged_spec": p_launches["paged_spec"]["paged_flash_verify"]}
    kernels["paged_flash_verify"]["launches_by_route_and_path"] = p_routes
    kernels["paged_flash_verify"]["route_rule"] = (
        "split (paged_split_kernel, the key splits merged in the kernel) for "
        "T <= 8, tiled (paged_tiled_kernel) above: pt_paged_verify_route")
    kernels["flash_verify"]["spec_profile"] = s_prof
    kernels["flash_verify"]["rollback"] = rb_counts
    serving = {"dense_tokens_per_s": n_tok / wall,
               "spec_tokens_per_s": s_rate,
               "spec_acceptance_rate":
                   s_snap["speculation"]["acceptance_rate"],
               "spec_busy_share": s_prof.get("busy_share"),
               "rollback": rb_counts,
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
    t_launches, _, losses, seq_s, peak, tr, batch = train(A, args.seed)
    t_routes = dict(A.ROUTE_LAUNCHES)
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  {seq_s:.2f} seq/s over the last {E_STEPS - 2} steps; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB; launches {t_launches}; "
        f"bf16 backward launches copying by element "
        f"{dict(A.ELEMENT_LOAD_LAUNCHES)}")
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
    kernels["flash_fwd"].update(
        max_abs_err_bf16=t_errs16["flash_fwd"], hgmma=hgmma["flash_fwd"],
        route_by_dtype={"bfloat16": "wgmma (tensor cores)",
                        "float32": "3xTF32 mma.sync (tensor cores): "
                        "query-tiled above 16 rows, short-query at or "
                        "below; SIMT (CUDA cores) under dropout or segment "
                        "ids"},
        route_rule="pt_flash_fwd_route",
        serve_launches_by_route=dict(FWD_ROUTES),
        train_launches_by_route=t_routes)
    for kname, line in (("flash_bwd_dq", 591), ("flash_bwd_dkv", 721)):
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": f"paddle_tpu/ops/attention.py:{line}",
            "launches": t_launches[kname], "max_abs_err": t_errs[kname],
            "max_abs_err_bf16": t_errs16[kname], "hgmma": hgmma[kname],
            "route_by_dtype": {"bfloat16": "wgmma (tensor cores)",
                               "float32": "SIMT (CUDA cores)"},
            "shape": "train b8 h12 s1024 d64 bf16 bias dropout 0.1",
            "library_scope": "sdpa backward alone",
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
               "mt_int8_spec": mt["int8_spec_launches"], **mp_launches}
    for kname, cases, head, line in (
            ("int8_matmul", i8_cases, "m8 512x37000", 116),
            ("lora_gather", lo_cases, "b8 s1 512x2048", 243)):
        rows = []
        for cname, inputs in cases.items():
            if "bf16" in cname:
                continue
            nums = quant_numbers(Q, kname, inputs)
            rows.append(dict(case=cname, **nums))
            both = (f"; CUDA-core bound {nums['cuda_core_bound_ms']:.4f} "
                    f"({nums['cuda_core_bound_by']}), "
                    f"{100 * nums['bound_share']:.1f}% of the tensor-core "
                    f"bound, {nums['splits']} k-splits"
                    if "cuda_core_bound_ms" in nums else "")
            log(f"  {kname} {cname}: kernel {nums['ms']:.4f} bound "
                f"{nums['bound_ms']:.4f} ({nums['bound_by']}){both} plain "
                f"{nums['plain_ms']:.4f} library {nums['library_ms']:.4f}"
                + (f" {nums['plan']}" if "plan" in nums else "")
                + (f"; kernels a call {nums['kernels_per_call']}"
                   if "kernels_per_call" in nums else ""))
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
    kernels["int8_matmul"]["launches_by_route"] = dict(INT8_ROUTES)
    kernels["int8_matmul"]["skinny_launches_by_shape_spec"] = \
        mt["int8_spec_skinny_by_shape"]
    kernels["int8_matmul"]["hgmma"] = hgmma["int8_matmul"]
    kernels["paged_flash_verify"]["launches_by_route_and_path"].update(
        {p: c["verify_routes"] for p, c in mp_launches.items()})
    # the attention kernels' launches on every serving path
    serve_paths = {"serve": launches, "spec": s_launches, **rb_launches,
                   **p_launches, **by_path}
    for kname in ("flash_decode", "flash_verify", "paged_flash_decode",
                  "paged_flash_verify"):
        paths = {p: c[kname] for p, c in serve_paths.items()
                 if c.get(kname)}
        kernels[kname]["launches_by_path"] = paths
        kernels[kname]["launches"] = sum(paths.values())
    for kname, key in (("flash_decode", "flash_decode_kernel"),
                       ("flash_verify", "flash_verify_kernel"),
                       ("paged_flash_decode", "paged_decode_kernel"),
                       ("paged_flash_verify", "paged_split_kernel")):
        kernels[kname]["merge_kernel_registers"] = merge_regs[key]
    log("  attention launches by path " + json.dumps(
        {k: kernels[k]["launches_by_path"] for k in (
            "flash_decode", "flash_verify", "paged_flash_decode",
            "paged_flash_verify")}))
    prompts, names, mems = mt["prompts"], mt["names"], mt["mems"]
    rows = profile_call(
        f"{SLOTS} requests", lambda: run_server(
            mt["int8_engine"], prompts[:SLOTS], mems[:SLOTS],
            adapters=names[:SLOTS]),
        ("int8_matmul", "lora_cluster_kernel", "flash_fwd",
         "flash_decode_kernel"))
    if rows is not None:
        parts = {p: rows_matching(rows, k) for p, k in (
            ("skinny", "int8_matmul_skinny_mma"),
            ("tiled", "int8_matmul_wgmma"), ("reduce", "int8_matmul_reduce"))}
        log("  int8_matmul by kernel: " + ", ".join(
            f"{p} {ms:.2f} ms in {n} launches" for p, (ms, n) in parts.items()))
        kernels["int8_matmul"]["profile_by_kernel"] = {
            p: {"ms": ms, "launches": n} for p, (ms, n) in parts.items()}
        if parts["reduce"][1] > parts["tiled"][1] or not parts["skinny"][1]:
            raise AssertionError(f"int8_matmul profile {parts}: the skinny "
                                 f"route has a second pass")
    log("  multi-tenant summary " + json.dumps({
        "fp32_tokens_per_s": mt["fp32_rate"],
        "int8_tokens_per_s": mt["int8_rate"],
        "int8_token_agreement": mt["agreement"],
        "int8_weight_shrink": mt["shrink"],
        "int8_spec_tokens_per_s": mt["int8_spec_rate"],
        "int8_spec_ties": mt["int8_spec_ties"],
        "int8_spec_acceptance": mt["int8_spec_acceptance"],
        "merged_weight_ties": mt["ties"],
        "paged_prefix": {p: s["prefix"] for p, s in mp_snaps.items()}}))
    del mt, prompts, names, mems, i8_cases, lo_cases
    gc.collect()
    torch.cuda.empty_cache()

    from paddle_tpu_torch.testing import ULP_FC_BF16, SHARE_FC_BF16

    log("phase 17: fused_conv_fwd and fused_conv_bwd against their plain "
        f"versions at ResNet-50's bottleneck shapes (fp32 z / dx "
        f"{REL_FC_NEAR}, stats / dW / dscale / dshift {REL_FC_FAR} of the "
        f"largest plain entry, error/limit; bf16 z / dx {ULP_FC_BF16:.0f} "
        f"bf16 ulp + 2^-20 of each element's sum of |products|: the worst "
        f"term past the ulp in units of 2^-20, at most {SHARE_FC_BF16} of "
        f"the elements differing; each unrounded-operand mutant must be "
        f"refused)")
    fc_errs, fc_errs16, fc_routes, fc_readings = check_fused_kernels(FC, g)
    log(f"  launches by route {fc_routes}")

    log(f"phase 18: the BN chain of each stage (bf16, batch {FC_BATCH}): "
        "forward and backward through the kernels, against the chain "
        f"through the plain versions ({', '.join(CHAIN_FLIP_FREE)}) and "
        "the plain backward at the kernels' forward values (all); the "
        "float64-summed plain forward must pass, the unrounded plain "
        f"versions must be refused (limits max {REL_FC_CHAIN} of the "
        f"largest entry, relative L2 {L2_CHAIN_BF16} bf16 / {L2_CHAIN_F32} "
        "float32)")
    fc_launches, chain_routes, chain_errs = run_bn_chains(FC, g)
    log(f"  launches {fc_launches}, by route {chain_routes}")

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
            split = row.get("split_ms")
            log(f"  {kname} {row['case']}: kernel {row['ms']:.4f} bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']}) plain "
                f"{row['plain_ms']:.4f} library {row['library_ms']:.4f}"
                + (f" (profiled split: dx {split['dx']:.4f}, dW "
                   f"{split['dw']:.4f})" if split else ""))
    for kname, line in (("fused_conv_fwd", 66), ("fused_conv_bwd", 123)):
        head = fc_rows[kname][0]
        kernels[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{kname}.cu",
            "replaces": f"paddle_tpu/ops/fused_conv.py:{line}",
            "launches": fc_launches[kname],
            "launches_by_path": {"bn_chain": fc_launches[kname]},
            "max_abs_err": fc_errs[kname],
            "max_abs_err_bf16": fc_errs16[kname], "hgmma": hgmma[kname],
            "route_by_dtype": {
                "bfloat16 x, bfloat16 W": "wgmma" if kname ==
                "fused_conv_fwd" else "dx and dW on wgmma",
                "bfloat16 x, float32 W": "SIMT" if kname ==
                "fused_conv_fwd" else "dx SIMT, dW on wgmma",
                "float32 x": "SIMT"},
            "phase17_launches_by_route": {
                k: v for k, v in fc_routes.items() if k.startswith(kname)},
            "bn_chain_launches_by_route": {
                k: v for k, v in chain_routes.items()
                if k.startswith(kname)},
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
        "bn_chain_worst_rel": chain_errs,
        "fused_conv_bf16_readings": fc_readings}))

    log("phase 21: the segment branch of flash_fwd, flash_bwd_dq and "
        "flash_bwd_dkv against their plain versions (phase 9's limits), "
        "then no leakage across segments")
    padded, packed, p_labels, pk = packed_batch(args.seed)
    s_errs, s_errs16, s_case, s_segs = check_segment_kernels(A, g, pk)

    log(f"phase 22: train ERNIE-base on {P_BATCH} sequences of "
        f"{P_MIN_LEN}-{E_SEQ} tokens, padded and packed ({pk.num_rows} rows, "
        f"fill {pk.fill:.4f}), {E_STEPS} steps each, bf16, dropout "
        f"{E_DROPOUT}")
    ab = packed_training(A, args.seed, padded, packed, p_labels, pk)
    ratio = ab["packed"]["seq_per_s"] / ab["padded"]["seq_per_s"]
    log(f"  packed / padded seq/s {ratio:.3f} ({card})")

    log("phase 23: packed against padded logits, 2 layers at full width, "
        "float32, dropout 0")
    agree = packed_logits_agree(A, args.seed, padded, packed)

    log("phase 24: timing of the segment branch at the packed shape (bf16, "
        "median, ms)")
    s_rows = segment_numbers(A, s_case, s_segs)
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        row = kernels[kname]
        paths = row.get("launches_by_path") or {"train": row["launches"]}
        for run in ("padded", "packed"):
            paths[f"{run}_train16"] = ab[run]["launches"][kname]
        row["launches_by_path"] = paths
        row["launches"] = sum(paths.values())
        row["max_abs_err"] = max(row["max_abs_err"], s_errs[kname])
        row["segment_branch"] = {
            "shape": f"packed {pk.num_rows} rows h{E_HEADS} s{E_SEQ} d64 "
                     f"bf16 dropout {E_DROPOUT}",
            "launches": ab["packed"]["segment_launches"][kname],
            "max_abs_err": s_errs[kname], "max_abs_err_bf16":
            s_errs16[kname], "library_scope": "sdpa with the dense boolean "
            "segment mask" + (" (forward)" if kname == "flash_fwd" else
                              ", backward alone"), **s_rows[kname]}
    log("  packed summary " + json.dumps({
        "card": card, "rows": pk.num_rows, "fill": pk.fill,
        "padded": ab["padded"], "packed": ab["packed"],
        "logits_agree": agree}))

    log(f"phase 25: ERNIE-base pretraining, {PT_UPDATES} updates of "
        f"{PT_ACCUM} x {PT_BATCH} x {PT_SEQ} tokens (grad_accum "
        f"{PT_ACCUM}), masked LM + NSP, bf16 compute, dropout {E_DROPOUT}, "
        f"AdamW under warmup {PT_WARMUP} and decay, clip 1.0; remat on, "
        f"then off")
    pt = {}
    for remat in (True, False):
        pt[remat], pt_tr, pt_batch = pretrain(A, args.seed, remat)
        run = pt[remat]
        log(f"  (a) remat {'on' if remat else 'off'}: losses "
            f"{[round(x, 4) for x in run['losses']]}; {run['seq_per_s']:.2f} "
            f"seq/s over updates 3-{PT_UPDATES}; peak "
            f"{run['peak_bytes'] / 2 ** 30:.2f} GiB")
        log(f"  (b) launches {run['launches']} (layers x micro-batches x "
            f"updates = {E_LAYERS * PT_ACCUM * PT_UPDATES}; the forward "
            f"twice under remat), all on wgmma")
        if remat:
            del pt_tr, pt_batch
            gc.collect()
            torch.cuda.empty_cache()
    if pt[True]["peak_bytes"] > pt[False]["peak_bytes"]:
        raise AssertionError(f"remat raised the peak: "
                             f"{pt[True]['peak_bytes']} > "
                             f"{pt[False]['peak_bytes']} bytes")
    pt_prof = profile_training(pt_tr, pt_batch, steps=1)
    pt_opt = optimizer_kernels(pt_tr, pt_tr.loss_and_grads(*pt_batch)[1])
    pt_paths = optimizer_paths_agree(pt_tr, pt_batch)
    pt_epoch = run_epoch_timing(pt_tr, args.seed)
    del pt_tr, pt_batch
    gc.collect()
    torch.cuda.empty_cache()
    pt_cpu = pretrain_card_vs_cpu(args.seed)
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        row = kernels[kname]
        for remat in (False, True):
            row["launches_by_path"]["pretrain_remat" if remat else
                                    "pretrain"] = pt[remat]["launches"][kname]
        row["launches"] = sum(row["launches_by_path"].values())
    log("  pretraining summary " + json.dumps({
        "card": card, "remat_off": pt[False], "remat_on": pt[True],
        "profiled_update": pt_prof, "optimizer_step": pt_opt,
        "optimizer_paths": pt_paths, "run_epoch": pt_epoch,
        "card_vs_cpu": pt_cpu}))

    log(f"phase 26: DecodeEngine at Transformer-base width: greedy, beam "
        f"{DE_BEAM} and spec_k {SPEC_K} (n-gram, then a "
        f"{DE_DRAFT_LAYERS}-layer DraftModel of other weights), "
        f"b{DE_BATCH}, prompts in the "
        f"{DE_PROMPT} bucket, {DE_NEW} new tokens")
    t_new = time.perf_counter()
    de_paths, de_out = decode_engine_phase(A, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 27: chunked prefill, dense and paged (page {PAGE}): {CH_LONG} "
        f"prompts of {CH_LONG_LEN} tokens among {CH_SHORT} short ones, "
        f"prefill_chunk {CH_CHUNK}, against the same engines without "
        f"chunking; then flash_verify at the chunk's shape")
    ch_paths, ch_out = chunked_phase(A, args.seed)
    ch_rows, ch_e32, ch_e16 = verify_chunk_cases(A, g)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 28: preemption under ShapingScheduler (paged, page {PAGE}): "
        f"{PR_BATCH} batch requests of {PR_BATCH_LEN} tokens fill the slots, "
        f"then {PR_INTER} interactive ones arrive; against a FIFO twin, "
        f"spec_k off and {SPEC_K}")
    pr_paths, pr_out = preempt_phase(A, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    new_wall = time.perf_counter() - t_new
    for label, counts in {**de_paths, **ch_paths, **pr_paths}.items():
        for kname in ("flash_fwd", "flash_decode", "flash_verify",
                      "paged_flash_decode", "paged_flash_verify"):
            if counts.get(kname):
                kernels[kname]["launches_by_path"][label] = counts[kname]
    for kname in ("flash_fwd", "flash_decode", "flash_verify",
                  "paged_flash_decode", "paged_flash_verify"):
        row = kernels[kname]
        row["launches"] = sum(row["launches_by_path"].values())
    kernels["flash_verify"]["cases"].extend(ch_rows)
    kernels["flash_verify"]["max_abs_err"] = max(
        kernels["flash_verify"]["max_abs_err"], ch_e32)
    kernels["flash_verify"]["max_abs_err_bf16"] = max(
        kernels["flash_verify"]["max_abs_err_bf16"] or 0.0, ch_e16)
    log("  decoding and shaping summary " + json.dumps({
        "card": card, "wall_s": new_wall, "decode_engine": de_out,
        "chunked": ch_out, "preemption": pr_out}))

    log("phase 29: output")
    kernels = list(kernels.values())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
