"""Attention: plain PyTorch versions and the wrappers of the port's
hand-written Hopper kernels.

Layout: (batch, heads, seq, head_dim) throughout, as in the JAX
package's `ops/attention.py`.

  * `flash_attention_fwd` -> `csrc/flash_fwd.cu`: online-softmax
    attention with an optional [b, sk] key bias, causal masking,
    in-kernel attention dropout and packed segment ids, returning (out,
    lse). Carries prompt prefill, encoder self-attention, every
    cross-attention over the memory, and the training forward. bf16
    runs on the tensor cores (wgmma); float32 runs on them too as
    3xTF32 (each operand split into two TF32 pieces, three products),
    query-tiled or, for sq <= 16, split over the keys, except with
    attention dropout or segment ids, which keep float32 FMAs on the
    CUDA cores (`fwd_route`).
  * `flash_attention_bwd` -> `csrc/flash_bwd_dq.cu` (dQ, looping over
    key tiles) and `csrc/flash_bwd_dkv.cu` (dK, dV and the key-bias
    gradient, looping over query tiles). Both recompute the
    probabilities from the saved lse; delta = rowsum(dO * O) is one
    torch op here, as it is one XLA op in the JAX package. bf16 runs on
    the tensor cores (wgmma), float32 on the CUDA cores.
  * `flash_attention`: the differentiable entry (`_FlashAttention`, a
    `torch.autograd.Function` over the three kernels).
  * Packed sequences (`core/lod.pack_padded`): `segment_ids` [b, sq]
    and `kv_segment_ids` [b, sk] (default: the query's), non-decreasing
    along each row, restrict attention to same-segment pairs. The three
    kernels turn them into loop bounds that skip every tile outside a
    tile's segment range and mask cross-segment pairs (-1e30) on the
    tiles they visit; `segment_bias` is the dense form of that mask.
  * `flash_decode` -> `csrc/flash_decode.cu`: one query token per row
    against a preallocated KV cache with per-row written lengths, split
    over the cache length on a thread-block cluster (`flash_decode_plan`)
    and merged in the kernel, which writes the output: one launch (the
    JAX package combines its per-split partials in XLA; the plain version
    keeps that split-and-combine).
  * `flash_verify` -> `csrc/flash_verify.cu`: the speculative-decoding
    VERIFY block, T query tokens per row just written at the row's own
    offset, causal within the block (key j visible to row i while
    j <= length - T + i), on the decode's kernel body and plan at T
    query rows: one launch that writes the output (the plain version
    keeps the JAX split-and-combine).
  * `paged_flash_decode` -> `csrc/paged_decode.cu` and
    `paged_flash_verify` -> `csrc/paged_verify.cu`: the same two reads
    through a paged pool ([N+1, h, page_size, d] pages, row N the trash
    page, a [S, max_pages] page table, int8 pages dequantized by
    per-(page, head) scales), without a dense copy of the cache. The
    decode splits a row's pages over a thread-block cluster
    (`paged_decode_plan`) and merges the splits in the kernel, which
    writes the output: one launch. The verify has two routes
    (`paged_verify_route`, the C rule), each one launch that writes the
    output: for T <= 8 (the speculative step) the decode's kernel body
    (`csrc/attn_merge.cuh`, shared with both decodes and the dense
    verify) over T query rows, and a query-tiled kernel for the wider
    tail prefills.

Attention dropout is the JAX package's counter hash (`_hash_bits`), not
torch's RNG: the keep bit of logit (row, col) is a murmur3-finalised
hash of (seed, b*h index, row block, col block, row in block, col in
block) over the LOGICAL blocks of `_pick_blocks_heuristic`, whatever
tile size a kernel uses. The forward and both backward kernels, their
plain versions and `dropout_keep_reference` therefore draw the same
bits on any device, and they equal the JAX interpret-mode kernels'.

Each wrapper runs its kernel's plain PyTorch version when its tensors
lie on the CPU, and launches the kernel when they lie on a CUDA card;
there is no fallback from a failed launch. `LAUNCHES` counts kernel
launches per wrapper, `SEG_LAUNCHES` those of the segment-id branch
among them, `ROUTE_LAUNCHES` the forward's by route (`fwd_route`),
`PAGED_ROUTE_LAUNCHES` the paged verify's by route (split
or tiled), `ELEMENT_LOAD_LAUNCHES` the 16-bit forward and backward
launches on views that 16-byte copies cannot address, `F16_LAUNCHES`
their float16 launches. The dispatchers `sdpa` and `decode_attention` mirror the
JAX ones: a mask that reduces to a per-key bias, and packed segment
ids, ride the flash kernels. A richer (per-query or per-head) mask goes
to the `sdpa_reference` composition on the CPU only and without
attention dropout; on the card, or with dropout, it raises: no kernel
takes such a mask (pass segment ids, or a [b, sk] key bias with
`is_causal`).
The paged dispatchers follow the JAX fallback on the CPU: gather the
dense logical view of the pages, then run the same plain dense decode or
verify that the dense pool runs, so fp32 pages serve the dense pool's
tokens bit for bit; on the card they launch the paged kernels.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["NEG", "LAUNCHES", "reset_launches", "DropSpec", "drop_spec",
           "decode_shardings",
           "dropout_keep_reference", "sdpa_reference", "segment_bias",
           "SEG_LAUNCHES", "ELEMENT_LOAD_LAUNCHES", "F16_LAUNCHES",
           "ROUTE_LAUNCHES",
           "PAGED_ROUTE_LAUNCHES", "fwd_route", "fwd_cluster",
           "paged_verify_route",
           "paged_verify_plan", "paged_decode_plan",
           "paged_decode_plan_on_card", "flash_decode_plan",
           "flash_decode_plan_on_card",
           "decode_attention_reference", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention", "flash_decode",
           "flash_decode_plain", "sdpa", "decode_attention", "DECODE_SPLIT",
           "kv_verify_scope", "in_kv_verify_scope",
           "verify_attention_reference", "flash_verify", "flash_verify_plain",
           "verify_attention", "paged_gather_kv", "paged_flash_decode",
           "paged_flash_decode_plain", "paged_decode_attention",
           "paged_flash_verify", "paged_flash_verify_plain",
           "paged_verify_attention"]

NEG = -1e30
#: keys per split of the plain versions' split-and-combine (the JAX
#: kernels' order) and of the dense verify kernel
DECODE_SPLIT = 128
#: kernel launches per wrapper; each wrapper adds one where it launches
#: its kernel and nowhere else (plain CPU runs do not count).
#: `reset_launches` zeroes these and `ops.quant.LAUNCHES` together.
LAUNCHES = _build.counter(["flash_fwd", "flash_decode", "flash_bwd_dq",
                           "flash_bwd_dkv", "flash_verify",
                           "paged_flash_decode", "paged_flash_verify"])
#: launches of the segment-id branch of the three flash kernels (each
#: also counted in LAUNCHES)
SEG_LAUNCHES = _build.counter(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"],
                              branch=True)
#: bf16 launches of the forward and the two backward kernels on views
#: whose rows do not all start on 16 bytes (`pt_flash_fwd_vector_loads`,
#: `pt_flash_bwd_vector_loads`): the same tensor-core kernels, with their
#: tiles copied element by element instead of by 16-byte cp.async (each
#: also counted in LAUNCHES)
ELEMENT_LOAD_LAUNCHES = _build.counter(["flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv"], branch=True)
#: float16 launches of the forward and the two backward kernels (the f16
#: instances of their wgmma body; each also counted in LAUNCHES)
F16_LAUNCHES = _build.counter(["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"],
                              branch=True)
#: launches of the forward by route (`fwd_route`, counted by the C entry
#: point's own rule `pt_flash_fwd_route`): "flash_fwd:wgmma" the bf16
#: tensor-core kernel, "flash_fwd:tf32x3" and "flash_fwd:tf32x3_short" the
#: float32 kernels on the tensor cores (query-tiled, and split over the
#: keys for sq <= 16), "flash_fwd:simt" the float32 kernel on the CUDA
#: cores (attention dropout or segment ids); each also counted in LAUNCHES
FWD_ROUTES = ("wgmma", "tf32x3", "tf32x3_short", "simt")
ROUTE_LAUNCHES = _build.counter([f"flash_fwd:{r}" for r in FWD_ROUTES],
                                branch=True)
#: query rows up to which the float32 forward takes the short-query route
#: (`SHORT_ROWS`, csrc/flash_fwd.cu)
FWD_SHORT_ROWS = 16
#: launches of the paged verify by route (`paged_verify_route`, asked of
#: the C entry point's own rule `pt_paged_verify_route`):
#: "paged_flash_verify:split" the in-kernel split merge (T <= 8, the
#: speculative verify step), "paged_flash_verify:tiled" the query-tiled
#: kernel (the tail prefill of a partial prefix hit); each also counted in
#: LAUNCHES
PAGED_ROUTE_LAUNCHES = _build.counter(["paged_flash_verify:split",
                                       "paged_flash_verify:tiled"],
                                      branch=True)
reset_launches = _build.reset_launches


def _scale(d, scale):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _acc(x):
    """Accumulation type of the plain versions: float32, as in the
    kernels, or float64 for float64 operands (finite-difference checks
    of the plain math)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _up(x, ref):
    return x.to(_acc(ref))


def _scaled_q(q, s):
    """The query with the softmax scale folded in once, rounded to the
    operand type (what the kernels do), in the accumulation type."""
    return (_up(q, q) * s).to(q.dtype).to(_acc(q))


# --------------------------------------------------------------------------
# attention-dropout bits (the JAX package's interpret-mode counter hash)
# --------------------------------------------------------------------------

#: in-kernel attention dropout of one call: probability p, the call's
#: seed (a host int, read as uint32), the logical blocks that address
#: the bits, and where the call's operands lie in a larger sharded call:
#: batch offset b0, head offset h0 and that call's head count `heads`
#: (None: the operands' own). The bits of local head (b, h) are those of
#: global head (b0 + b) * heads + (h0 + h), so a data-parallel rank's
#: rows and a tensor-parallel rank's heads draw their slice of the
#: one-device call's mask.
DropSpec = collections.namedtuple(
    "DropSpec", ["p", "seed", "block_q", "block_k", "b0", "h0", "heads"],
    defaults=(0, 0, None))
_M32 = 0xFFFFFFFF


def _drop_consts(dropout_p):
    """(uint32 keep-threshold as an int, float32 1/keep as a float): a
    logit is kept while its bits >= the threshold."""
    thresh = min(int(round(dropout_p * 2.0 ** 32)), 2 ** 32 - 1)
    inv_keep = float(torch.tensor(1.0 / (1.0 - dropout_p),
                                  dtype=torch.float32))
    return thresh, inv_keep


def _check_drop_grid(sk, block_k):
    """The JAX kernels pack (qi, ki) into one seed word as qi*4096 + ki,
    injective only while ki < 4096; the port keeps the same bound (over
    the key blocks a ragged tail reaches too) so both address the same
    set of blocks."""
    nk = -(-sk // block_k)
    if nk > 4096:
        raise ValueError(
            f"flash dropout block addressing needs sk/block_k <= 4096 "
            f"(got {nk}); raise block_k or disable attention dropout")


def _pick_blocks_heuristic(sq, sk, block_q=None, block_k=None):
    """The JAX package's block ladder (512, 384, 256, 128; the largest
    that divides the length, or the length itself when shorter). The
    port's kernels tile by 64 whatever this returns: the blocks only fix
    the logical dropout addressing, so that the bits equal the JAX
    kernels' for the same seed."""
    def _one(s, override):
        if override is not None:
            return min(override, s)
        for b in (512, 384, 256, 128):
            if s % b == 0 or b >= s:
                return min(b, s)
        return min(128, s)
    return _one(sq, block_q), _one(sk, block_k)


def drop_spec(dropout_p, seed, sq, sk, block_q=None, block_k=None,
              address=None):
    """The DropSpec of one attention call (None when dropout_p is 0).
    `seed` is an int or a one-element integer tensor (int32 in the JAX
    package); it is read as uint32. `address`: (b0, h0, heads) of a
    shard of a larger call (see DropSpec), or None."""
    if not dropout_p:
        return None
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"attention dropout_p must be in [0, 1), got "
                         f"{dropout_p}")
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    bq, bk = _pick_blocks_heuristic(sq, sk, block_q, block_k)
    _check_drop_grid(sk, bk)
    b0, h0, heads = address or (0, 0, None)
    if b0 < 0 or h0 < 0 or (heads is not None and heads < h0 + 1):
        raise ValueError(f"bad dropout address {address}")
    return DropSpec(float(dropout_p), int(seed) & _M32, int(bq), int(bk),
                    int(b0), int(h0), None if heads is None else int(heads))


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (torch has no uint32 shifts on the CPU)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _hash_bits(seed, bh, qi, ki, r, c):
    """The JAX `_hash_bits` (attention.py:215) on int64 tensors holding
    uint32 values (broadcasting): a murmur3 fmix32 over the xor of the
    odd-constant products of (seed, bh, qi, ki, row, col)."""
    x = (_mul32(seed, 0x9E3779B9) ^ _mul32(bh, 0x85EBCA6B)
         ^ _mul32(qi, 0xC2B2AE35) ^ _mul32(ki, 0x27D4EB2F))
    x = x ^ _mul32(r, 0x165667B1) ^ _mul32(c, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep_reference(seed, b, h, sq, sk, block_q, block_k, dropout_p,
                           device="cpu", b0=0, h0=0, heads=None):
    """Keep mask [b*h, sq, sk] (bool) of the in-kernel attention dropout:
    the bits the kernels draw, computed with torch ops on `device`. Any
    sq / sk: a ragged tail row takes qi = row // block_q like every
    other row. b0, h0, heads: the shard's address in a larger call
    (DropSpec); local head (i, j) hashes (b0 + i) * heads + (h0 + j)."""
    thresh, _ = _drop_consts(dropout_p)
    i64 = dict(dtype=torch.int64, device=device)
    rows = torch.arange(sq, **i64)
    cols = torch.arange(sk, **i64)
    heads = h if heads is None else heads
    bh = ((torch.arange(b, **i64)[:, None] + b0) * heads
          + torch.arange(h, **i64)[None] + h0).reshape(b * h, 1, 1)
    qi, r = (rows // block_q)[None, :, None], (rows % block_q)[None, :, None]
    ki, c = (cols // block_k)[None, None, :], (cols % block_k)[None, None, :]
    seed = torch.tensor(int(seed) & _M32, **i64)
    return _hash_bits(seed, bh, qi, ki, r, c) >= thresh


def _keep4(drop, b, h, sq, sk, device):
    return dropout_keep_reference(drop.seed, b, h, sq, sk, drop.block_q,
                                  drop.block_k, drop.p, device, drop.b0,
                                  drop.h0, drop.heads) \
        .reshape(b, h, sq, sk)


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------

def sdpa_reference(q, k, v, mask=None, is_causal=False, scale=None):
    """Plain attention: always correct, any mask. Causal aligns the
    diagonal at the END (key j visible to row i while j <= i + sk - sq),
    the JAX reference's `tril(..., klen - qlen)`."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(d, scale)
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def segment_bias(segment_ids, kv_segment_ids=None):
    """Additive float32 [b, 1, sq, sk] attention bias from per-token
    segment ids ([b, sq] / [b, sk] int): 0 within a segment, -1e30
    across (the JAX `segment_bias`). The dense form of the kernels'
    segment mask, for the reference composition and the tests."""
    seg_q = torch.as_tensor(segment_ids)
    seg_k = seg_q if kv_segment_ids is None else \
        torch.as_tensor(kv_segment_ids, device=seg_q.device)
    eq = seg_q[:, :, None] == seg_k[:, None, :]
    return torch.where(eq, 0.0, NEG).float()[:, None]


def _segments(segment_ids, kv_segment_ids, q, k):
    """(query ids [b, sq], key ids [b, sk]) as contiguous int32 on q's
    device, or None without segment ids. The key ids default to the
    query's (self-attention packing). No monotonicity check: it would
    cost a device sync per call; ids that decrease along a row give
    unspecified output."""
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids needs segment_ids")
        return None
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    kv = segment_ids if kv_segment_ids is None else kv_segment_ids
    out = []
    for ids, n, what in ((segment_ids, sq, "query"), (kv, sk, "key")):
        ids = torch.as_tensor(ids)
        if tuple(ids.shape) != (b, n) or ids.is_floating_point() \
                or ids.is_complex() or ids.dtype == torch.bool:
            raise ValueError(f"{what} segment ids must be an integer "
                             f"[{b}, {n}] tensor, got {ids.dtype} "
                             f"{tuple(ids.shape)}")
        out.append(ids.to(device=q.device, dtype=torch.int32).contiguous())
    return tuple(out)


def _kv_bias(mask, b, sk):
    """A mask that varies only over (batch, key) as a [b, sk] float32
    additive bias — the padded-batch case; None when it is richer."""
    m = mask
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, NEG).float()
    shp = tuple(m.shape)
    if shp[-1] != sk:
        return None
    lead = shp[:-1]
    if any(x != 1 for x in lead[1:]):
        return None
    if lead and lead[0] not in (1, b):
        return None
    m = m.reshape(lead[0] if lead else 1, sk).float()
    return m.expand(b, sk).contiguous()


def decode_attention_reference(q, k, v, length, bias=None, scale=None):
    """Plain single-token decode attention against a preallocated cache:
    q [b, h, 1, d]; k/v [b, h, L, d]; key positions >= length (an int
    or a [b] tensor) are masked; bias an optional [b, L] additive key
    bias (pad holes)."""
    b, L = q.shape[0], k.shape[2]
    length = _lengths(length, b, q.device)
    kpos = torch.arange(L, device=q.device)
    m = torch.where(kpos[None, :] < length[:, None], 0.0, NEG).float()
    if bias is not None:
        m = m + bias.float().reshape(b, L)
    return sdpa_reference(q, k, v, m[:, None, None, :], False, scale)


def _lengths(length, b, device):
    length = torch.as_tensor(length, dtype=torch.int32, device=device)
    return length.reshape(-1).expand(b).contiguous()


# --------------------------------------------------------------------------
# flash forward: plain version + kernel wrapper
# --------------------------------------------------------------------------

def _logits(q, k, bias, is_causal, s, segs=None, mm=torch.matmul):
    """The kernels' logits as float32: round(q * s) . k + bias, then
    pairs of different segments (segs: the `_segments` pair) and causal
    keys (end-aligned) set to -1e30, in the JAX kernel's order. mm: the
    product (`testing.split_matmul` takes it as the tensor cores do)."""
    sq, sk = q.shape[2], k.shape[2]
    logits = mm(_scaled_q(q, s), _up(k, q).transpose(-1, -2))
    if bias is not None:
        logits = logits + _up(bias, q)[:, None, None, :]
    if segs is not None:
        same = segs[0][:, None, :, None] == segs[1][:, None, None, :]
        logits = logits.masked_fill(~same, NEG)
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG)
    return logits


def flash_attention_fwd_plain(q, k, v, bias=None, is_causal=False,
                              scale=None, dropout=None, segment_ids=None,
                              kv_segment_ids=None):
    """The flash forward's function in plain PyTorch: (out [b,h,sq,d],
    lse [b*h, sq, 1]). Running max floored at -1e30, p rounded to the
    operand type for the p.v product, normaliser floored at 1e-30 —
    the kernel's math without the tiling. With `dropout` (a DropSpec)
    the p.v product sees the dropped, upscaled p while the normaliser
    keeps summing the raw p (the JAX kernel's order). Segment ids mask
    cross-segment pairs with -1e30 (the kernel's skipped tiles hold
    only such pairs). Rows with no visible key at all (no same-segment
    key, under the causal mask) are degenerate and left unspecified
    (the kernel may differ)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    segs = _segments(segment_ids, kv_segment_ids, q, k)
    logits = _logits(q, k, bias, is_causal, _scale(d, scale), segs)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    if dropout is not None:
        keep = _keep4(dropout, b, h, sq, sk, q.device)
        p = torch.where(keep, p * _drop_consts(dropout.p)[1], 0.0)
    out = torch.matmul(_up(p.to(q.dtype), q), _up(v, q)) / l
    lse = (m + torch.log(l)).reshape(b * h, sq, 1)
    return out.to(q.dtype), lse


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the dtypes of the three training kernels (flash forward, dQ, dK / dV):
#: float16 runs the bf16 wgmma body's f16 instance (`amp.auto_cast(
#: dtype="float16")` hands them f16 q, k, v)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_operands(name, q, k, v, extra=(), dtypes=_DTYPES):
    """Device / dtype / layout checks of a kernel wrapper: everything on
    one CUDA device, q/k/v one dtype of `dtypes` with unit stride on the
    head dim, head_dim <= 128."""
    for t in (q, k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices "
                             f"({t.device} vs {q.device})")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        names = ", ".join(str(t).replace("torch.", "") for t in dtypes)
        raise TypeError(f"{name}: q/k/v must share one of {names}, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q/k/v must be [b, h, s, d]")
    d = q.shape[-1]
    if not 1 <= d <= 128:
        raise ValueError(f"{name}: head_dim {d} outside the kernel's 1..128")
    if k.shape[:2] != q.shape[:2] or v.shape != k.shape or k.shape[-1] != d:
        raise ValueError(f"{name}: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")


def _check_bias(name, bias, b, n):
    if bias is None:
        return
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, n) \
            or not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be a contiguous float32 "
                         f"[{b}, {n}] tensor, got {bias.dtype} "
                         f"{tuple(bias.shape)}")


_raise_on = _build.raise_on


def _drop_args(drop, h):
    """(seed, keep threshold, 1/keep, block_q, block_k, b0, h0, heads)
    for the C entry points of a call with h heads; block_q 0 switches
    dropout off."""
    if drop is None:
        return 0, 0, 1.0, 0, 0, 0, 0, h
    thresh, inv_keep = _drop_consts(drop.p)
    heads = h if drop.heads is None else drop.heads
    if heads < drop.h0 + h:
        raise ValueError(f"dropout address: heads {heads} < h0 {drop.h0} + "
                         f"{h} local heads")
    return (drop.seed, thresh, inv_keep, drop.block_q, drop.block_k,
            drop.b0, drop.h0, heads)


def _row_strides(*ts):
    """(batch, head, row) element strides of each [b, h, s, d] operand."""
    return _build.strides_arg([x for t in ts for x in t.stride()[:3]])


def _seg_ptrs(segs):
    """The (query ids, key ids) pointers of a C entry point: both null
    without segments."""
    return (None, None) if segs is None else \
        (segs[0].data_ptr(), segs[1].data_ptr())


def _count(name, segs):
    LAUNCHES[name] += 1
    if segs is not None:
        SEG_LAUNCHES[name] += 1


def _count_f16(name, q):
    if q.dtype == torch.float16:
        F16_LAUNCHES[name] += 1


def fwd_route(dtype, sq=None, segments=False, dropout=False):
    """The forward kernel's route for q/k/v of this dtype and sq query
    rows, with or without segment ids and attention dropout: "wgmma"
    (bf16 or float16 on the tensor cores); for float32 "simt" (float32 FMAs on the
    CUDA cores) under dropout or segment ids, which no serving path
    passes, else 3xTF32 on the tensor cores, "tf32x3_short" for sq <= 16
    (the decode step's cross-attention) and "tf32x3" above. The C entry
    point's rule (`pt_flash_fwd_route`), written out here for the CPU;
    the wrapper counts by the C rule."""
    if dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_fwd: no kernel for {dtype}")
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma"
    if segments or dropout:
        return "simt"
    if sq is None:
        raise ValueError("flash_fwd: the float32 route depends on sq")
    return "tf32x3_short" if sq <= FWD_SHORT_ROWS else "tf32x3"


def fwd_cluster(q, sk):
    """Blocks a thread-block cluster (key splits) of the float32
    tensor-core forward for q [b, h, sq, d] over sk keys on q's card, as
    the C entry point plans it (`pt_flash_fwd_cluster`): about two blocks
    an SM, at most one a 64-key tile and 8."""
    b, h, sq = q.shape[:3]
    return _build.kernels().flash_fwd_cluster(q.device.index or 0, b * h,
                                              sq, sk)


def _count_fwd(q, k, v, strides, segs, dropout):
    """Count a forward launch by its route (the C rule); a 16-bit one
    whose views the kernel copies element by element also in
    ELEMENT_LOAD_LAUNCHES; a float16 one also in F16_LAUNCHES."""
    _count("flash_fwd", segs)
    _count_f16("flash_fwd", q)
    lib = _build.kernels()
    code = lib.flash_fwd_route(_FLASH_DTYPES[q.dtype], q.shape[2],
                               int(segs is not None), int(dropout is not None))
    route = {0: "simt", 1: "wgmma", 2: "tf32x3", 3: "tf32x3_short"}[code]
    ROUTE_LAUNCHES[f"flash_fwd:{route}"] += 1
    if route == "wgmma" and not lib.flash_fwd_vector_loads(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, q.shape[-1]):
        ELEMENT_LOAD_LAUNCHES["flash_fwd"] += 1


def _flash_fwd_cuda(q, k, v, bias, is_causal, scale, dropout=None,
                    segs=None):
    _check_operands("flash_fwd", q, k, v,
                    (() if bias is None else (bias,)) + (segs or ()),
                    _FLASH_DTYPES)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_bias("flash_fwd", bias, b, sk)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    if sq == 0 or b * h == 0:
        return out, lse
    fn = _build.kernels().flash_fwd
    strides = _row_strides(q, k, v)
    err = fn(q.device.index or 0, _FLASH_DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), *_seg_ptrs(segs),
             out.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, strides,
             float(_scale(d, scale)), int(bool(is_causal)),
             *_drop_args(dropout, h),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    _count_fwd(q, k, v, strides, segs, dropout)
    return out, lse


def _device_kind(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {q.device.type} tensors")
    return q.device.type


def flash_attention_fwd(q, k, v, bias=None, is_causal=False, scale=None,
                        dropout=None, segment_ids=None, kv_segment_ids=None):
    """Flash forward: (out [b, h, sq, d], lse [b*h, sq, 1]). bias: an
    optional [b, sk] float32 additive key bias. Causal aligns at the
    end of the key axis (the reference semantics; start-aligned when
    sq == sk). dropout: a DropSpec (see `drop_spec`) or None.
    segment_ids / kv_segment_ids: [b, sq] / [b, sk] integer ids,
    non-decreasing along each row (see `_segments`). CPU tensors run
    `flash_attention_fwd_plain`; CUDA tensors launch `csrc/flash_fwd.cu`
    (any sq / sk, head_dim <= 128)."""
    if _device_kind("flash_attention_fwd", q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, is_causal, scale,
                                         dropout, segment_ids,
                                         kv_segment_ids)
    return _flash_fwd_cuda(q, k, v, bias, is_causal, scale, dropout,
                           _segments(segment_ids, kv_segment_ids, q, k))


# --------------------------------------------------------------------------
# flash backward (dQ, dK/dV): plain version + kernel wrappers
# --------------------------------------------------------------------------

def _delta(g, out):
    """delta = rowsum(dO * O) in float32, [b*h, sq]: the softmax
    correction term (one torch op, as in the JAX package)."""
    b, h, sq, _ = g.shape
    return (_up(g, g) * _up(out, g)).sum(-1).reshape(b * h, sq)


def flash_attention_bwd_plain(q, k, v, bias, out, lse, g, is_causal=False,
                              scale=None, dropout=None, need_dbias=True,
                              segment_ids=None, kv_segment_ids=None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv,
    dbias). The logits are recomputed with the forward's scale folding
    and subtract the saved lse; dq folds the scale into k and dk into q
    (each rounded to the operand type, as the JAX kernels do); with
    dropout, dP and the P of the dV product see the same keep bits as
    the forward; cross-segment pairs get p = 0. dbias ([b, sk] float32,
    the key bias's gradient summed over heads) is None without a bias or
    when not needed."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    s = _scale(d, scale)
    segs = _segments(segment_ids, kv_segment_ids, q, k)
    logits = _logits(q, k, bias, is_causal, s, segs)
    p = torch.exp(logits - lse.reshape(b, h, sq, 1))
    dp = torch.matmul(_up(g, q), _up(v, q).transpose(-1, -2))
    pd = p
    if dropout is not None:
        keep = _keep4(dropout, b, h, sq, sk, q.device)
        inv_keep = _drop_consts(dropout.p)[1]
        pd = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    delta = _delta(g, out).reshape(b, h, sq, 1)
    ds = p * (dp - delta)                 # d loss / d (q.k*s + bias)
    kbs = _up((_up(k, q) * s).to(k.dtype), q)
    dq = torch.matmul(_up(ds.to(q.dtype), q), kbs)
    dk = torch.matmul(_up(ds.to(k.dtype), q).transpose(-1, -2),
                      _scaled_q(q, s))
    dv = torch.matmul(_up(pd.to(k.dtype), q).transpose(-1, -2), _up(g, q))
    dbias = ds.sum(2).sum(1) if bias is not None and need_dbias else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check_bwd(name, q, k, v, bias, g, lse, delta, segs):
    _check_operands(name, q, k, v, tuple(
        t for t in (bias, g, lse, delta) if t is not None) + (segs or ()),
        _FLASH_DTYPES)
    b, h, sq, _ = q.shape
    _check_bias(name, bias, b, k.shape[2])
    if g.shape != q.shape or g.dtype != q.dtype or g.stride(-1) != 1:
        raise ValueError(f"{name}: dO must match q's shape and dtype with a "
                         f"contiguous head dim")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.dtype != torch.float32 or t.numel() != b * h * sq \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 "
                             f"with {b * h * sq} elements")


def _count_bwd(name, q, k, v, g, strides, segs):
    """Count a backward launch; a 16-bit one whose views the kernels copy
    element by element (`pt_flash_bwd_vector_loads`, the C entry points'
    own rule) also in ELEMENT_LOAD_LAUNCHES; a float16 one also in
    F16_LAUNCHES."""
    _count(name, segs)
    _count_f16(name, q)
    if q.dtype != torch.float32 and not _build.kernels() \
            .flash_bwd_vector_loads(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    g.data_ptr(), strides, q.shape[-1]):
        ELEMENT_LOAD_LAUNCHES[name] += 1


def _flash_bwd_dq_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                       dropout=None, segs=None):
    _check_bwd("flash_bwd_dq", q, k, v, bias, g, lse, delta, segs)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b * h == 0:
        return dq
    fn = _build.kernels().flash_bwd_dq
    strides = _row_strides(q, k, v, g)
    err = fn(q.device.index or 0, _FLASH_DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), *_seg_ptrs(segs),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             b, h, sq, sk, d, strides,
             float(_scale(d, scale)), int(bool(is_causal)),
             *_drop_args(dropout, h),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dq", err)
    _count_bwd("flash_bwd_dq", q, k, v, g, strides, segs)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                        dropout=None, need_dbias=True, segs=None):
    """(dk, dv, dbias per (b*h, key) as [b*h, sk] float32 or None)."""
    _check_bwd("flash_bwd_dkv", q, k, v, bias, g, lse, delta, segs)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    db = None
    if bias is not None and need_dbias:
        db = torch.empty((b * h, sk), dtype=torch.float32, device=q.device)
    if sk == 0 or b * h == 0:
        return dk, dv, db
    fn = _build.kernels().flash_bwd_dkv
    strides = _row_strides(q, k, v, g)
    err = fn(q.device.index or 0, _FLASH_DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), *_seg_ptrs(segs),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), None if db is None else db.data_ptr(), b, h, sq,
             sk, d, strides, float(_scale(d, scale)),
             int(bool(is_causal)), *_drop_args(dropout, h),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dkv", err)
    _count_bwd("flash_bwd_dkv", q, k, v, g, strides, segs)
    return dk, dv, db


def flash_attention_bwd(q, k, v, bias, out, lse, g, is_causal=False,
                        scale=None, dropout=None, need_dbias=True,
                        segment_ids=None, kv_segment_ids=None):
    """Flash backward: (dq, dk, dv, dbias) from the forward's inputs, its
    output and lse, and dO = g (any strides with a contiguous head dim).
    CPU tensors run `flash_attention_bwd_plain`; CUDA tensors launch
    `csrc/flash_bwd_dq.cu` and `csrc/flash_bwd_dkv.cu` on the current
    stream (the autograd engine's, when called from backward)."""
    if _device_kind("flash_attention_bwd", q) == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, g,
                                         is_causal, scale, dropout,
                                         need_dbias, segment_ids,
                                         kv_segment_ids)
    b, h, _, _ = q.shape
    segs = _segments(segment_ids, kv_segment_ids, q, k)
    delta = _delta(g, out)
    lse = lse.reshape(b * h, -1)
    dq = _flash_bwd_dq_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                            dropout, segs)
    dk, dv, db = _flash_bwd_dkv_cuda(q, k, v, bias, g, lse, delta,
                                     is_causal, scale, dropout, need_dbias,
                                     segs)
    dbias = None if db is None else db.reshape(b, h, -1).sum(1)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX `_flash_diff_fn`): the
    forward kernel saves out and lse, the two backward kernels recompute
    P from them; the dropout bits are regenerated from the saved seed.
    The segment ids are saved and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal, scale, dropout, qseg, kseg):
        out, lse = flash_attention_fwd(q, k, v, bias, is_causal, scale,
                                       dropout, qseg, kseg)
        ctx.save_for_backward(q, k, v, bias, out, lse, qseg, kseg)
        ctx.cfg = (is_causal, scale, dropout)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse, qseg, kseg = ctx.saved_tensors
        is_causal, scale, dropout = ctx.cfg
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, bias, out, lse, g, is_causal, scale, dropout,
            need_dbias, qseg, kseg)
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attention(q, k, v, bias=None, is_causal=False, scale=None,
                    block_q=None, block_k=None, dropout_p=0.0,
                    dropout_seed=None, segment_ids=None,
                    kv_segment_ids=None, dropout_address=None):
    """Differentiable flash attention over [b, h, s, d] operands (the
    JAX `flash_attention`): bias an optional [b, sk] float32 key bias
    (it gets a gradient when it requires one); dropout_p the in-kernel
    attention dropout, addressed by (dropout_seed, b*h, logical block)
    so the forward and both backward kernels regenerate the same bits.
    block_q / block_k override the logical dropout blocks (the JAX
    package's block sizes); the kernels tile by 64 regardless.
    segment_ids ([b, sq] integer, non-decreasing along each row: the
    `core/lod.pack_padded` layout) restrict attention to same-segment
    pairs, and the kernels skip the tiles that hold none;
    kv_segment_ids ([b, sk]) defaults to segment_ids. dropout_address
    (b0, h0, heads): the operands are rows and heads of a larger sharded
    call, whose dropout bits they take (`DropSpec`). Without gradients
    to compute it runs the forward alone."""
    sq, sk = q.shape[2], k.shape[2]
    dropout = drop_spec(dropout_p, dropout_seed, sq, sk, block_q, block_k,
                        dropout_address)
    segs = _segments(segment_ids, kv_segment_ids, q, k) or (None, None)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, is_causal, scale,
                                     dropout, *segs)
    return flash_attention_fwd(q, k, v, bias, is_causal, scale, dropout,
                               *segs)[0]


# --------------------------------------------------------------------------
# flash decode: plain version + kernel wrapper
# --------------------------------------------------------------------------

def _decode_partials_plain(q, k, v, length, bias, scale, split):
    """Per-split (acc [b*h, ns, d], m, l [b*h, ns]) exactly as the JAX
    kernel defines them, including the skip value of a split past the
    row's written length (acc 0, m -1e30, l 0)."""
    b, h, _, d = q.shape
    L = k.shape[2]
    ns = -(-L // split)
    pad = ns * split - L
    logits = torch.matmul(_scaled_q(q, _scale(d, scale)),
                          k.float().transpose(-1, -2))[:, :, 0]
    kpos = torch.arange(L, device=q.device)
    logits = torch.where(kpos[None, None, :] < length[:, None, None],
                         logits, NEG)
    if bias is not None:
        logits = logits + bias.float()[:, None, :]
    logits = F.pad(logits, (0, pad), value=float("-inf"))
    logits = logits.reshape(b, h, ns, split)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    vp = F.pad(v.float(), (0, 0, 0, pad)).reshape(b, h, ns, split, d)
    acc = torch.einsum("bhns,bhnsd->bhnd", p.to(q.dtype).float(), vp)
    starts = torch.arange(ns, device=q.device) * split
    skip = (starts[None, :] >= length[:, None])[:, None, :]   # [b, 1, ns]
    acc = acc.masked_fill(skip[..., None], 0.0)
    m = m.masked_fill(skip, NEG)
    l = l.masked_fill(skip, 0.0)
    return (acc.reshape(b * h, ns, d), m.reshape(b * h, ns),
            l.reshape(b * h, ns))


def _combine(acc, m, l, dtype):
    """Logsumexp merge of the per-split partials (the JAX
    `flash_decode` combine)."""
    m_star = m.amax(1, keepdim=True)
    alpha = torch.exp(m - m_star)
    num = (acc * alpha[..., None]).sum(1)
    den = (l * alpha).sum(1).clamp_min(1e-30)
    return (num / den[..., None]).to(dtype)


def _decode_lengths(q, k, length):
    b, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"flash_decode takes a single query token, got "
                         f"sq={sq}; prefill runs on flash_attention_fwd")
    if k.shape[2] < 1:
        raise ValueError("flash_decode: empty cache")
    return _lengths(length, b, q.device)


#: `csrc/attn_merge.cuh`'s plan (`amerge::plan`, the rule of both decodes,
#: the dense verify and the paged verify's split route): blocks an SM to
#: aim for, the most blocks a cluster (key splits of a row), and the dense
#: kernels' step of keys (`amerge::UNIT`: whole key tiles at every head
#: width)
_MERGE_PER_SM, _MERGE_CLUSTER, _DECODE_UNIT = 3, 8, 32


def _legal_split(split, n):
    """`amerge::legal_split`: a tuned split of n units the merge kernels
    take (a portable cluster, at least one unit a split)."""
    return type(split) is int and 1 <= split <= min(_MERGE_CLUSTER, n)


def _merge_plan(rows, n, sms, split_k=0):
    """(splits, units a split) of `rows` rows over n units on `sms` SMs:
    `amerge::plan` written out. A legal `split_k` (the tuning table's)
    replaces the rule's split; 0 or an illegal value keeps the rule."""
    if _legal_split(split_k, n):
        split = split_k
    else:
        want = -(-_MERGE_PER_SM * sms // max(rows, 1))
        split = max(1, min(_MERGE_CLUSTER, n, want))
    per = -(-n // split)
    return -(-n // per), per


def flash_decode_plan(b, h, L, sms=_build.H100_SMS, split_k=0):
    """(blocks a cluster = key splits of a row, keys a split) of the
    dense decode and verify kernels for b x h rows over a cache of L keys
    on a card of `sms` SMs: the C rule `pt_flash_decode_plan`
    (`amerge::dense_plan`, which the verify's entry point also follows)
    written out. A row's keys split in whole 32-key steps over up to 8
    blocks of a thread-block cluster until about three blocks an SM run;
    the kernel merges the splits in rank order. It reads no lengths: a
    split past a row's length holds no visible key. `split_k` is the
    plan's override (0 = the rule; see `_merge_plan`)."""
    if b < 0 or h < 1 or L < 1:
        raise ValueError(f"flash_decode: no plan for b={b}, h={h}, L={L}")
    c, units = _merge_plan(b * h, -(-L // _DECODE_UNIT), sms, split_k)
    return c, units * _DECODE_UNIT


def flash_decode_plan_on_card(b, h, L, device, split_k=0):
    """`flash_decode_plan` as the built library's C rule gives it on
    `device`'s card (builds the kernels on first use)."""
    out = _build.ints_out(2)
    err = _build.kernels().flash_decode_plan(
        torch.device(device).index or 0, int(b), int(h), int(L),
        int(split_k), out)
    _raise_on("flash_decode", err)
    return tuple(out)


# --------------------------------------------------------------------------
# the tuning table's consult sites (`tuning/table.py`)
# --------------------------------------------------------------------------

def _tuned(kernel, key):
    """The tuning table's config for (kernel, key), or None: a miss, and
    any failure of the tuning layer, run the rule (the JAX `_tuned`)."""
    from ..tuning import table as _tbl

    return _tbl.tuned(kernel, key)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def decode_key(kernel, d, rows, L, dtype, T=None):
    """The table key of a dense decode ("flash_decode") or verify
    ("flash_verify", T query rows) launch: every input of its plan rule,
    sizes bucketed: (head_dim, rows b*h, cache length, dtype[, T])."""
    from ..tuning.table import seq_bucket

    key = (int(d), seq_bucket(rows), seq_bucket(L), _dtype_name(dtype))
    return key if kernel == "flash_decode" else key + (int(T),)


def paged_key(kernel, d, rows, psz, mp, kv_dtype, T=None):
    """The table key of a paged decode ("paged_flash_decode") or verify
    ("paged_flash_verify", T query rows) launch: (head_dim, rows S*h, page
    size, pages a row, the pages' dtype[, T]), sizes bucketed."""
    from ..tuning.table import seq_bucket

    key = (int(d), seq_bucket(rows), int(psz), seq_bucket(mp),
           _dtype_name(kv_dtype))
    return key if kernel == "paged_flash_decode" else key + (int(T),)


def _knob(cfg, name, legal):
    """A tuned config's knob where `legal(value)` holds, else 0 (the
    rule): an entry that does not fit reads as a miss."""
    if not cfg:
        return 0
    v = cfg.get(name)
    return v if legal(v) else 0


def decode_split(kernel, q, L):
    """The tuned split_k of a dense decode / verify launch for q [b, h, T,
    d] over L keys (0 = the rule)."""
    b, h, T, d = q.shape
    cfg = _tuned(kernel, decode_key(kernel, d, b * h, L, q.dtype, T))
    units = -(-int(L) // _DECODE_UNIT)
    return _knob(cfg, "split_k", lambda v: _legal_split(v, units))


def paged_tiles(L):
    """Key tiles of L keys on the tiled route (its 64-key tiles)."""
    return max(1, -(-int(L) // _PAGED_TILE))


def _legal_tiles(tps, tiles):
    """`tiled::plan`'s check of a tuned tiles_per_split."""
    return type(tps) is int and 1 <= tps <= tiles and \
        -(-tiles // tps) <= _PAGED_MAX_SPLITS


def paged_overrides(kernel, q, kp, mp):
    """(kernel, split_k, tiles_per_split) the tuning table gives a paged
    read of q [S, h, T, d] over mp pages of kp: kernel False is the gather
    route, the rest the plan overrides (0 = the rule)."""
    S, h, T, d = q.shape
    psz = kp.shape[2]
    cfg = _tuned(kernel, paged_key(kernel, d, S * h, psz, mp, kp.dtype, T))
    if not cfg:
        return True, 0, 0
    use_kernel = cfg.get("kernel", True) is not False
    tiles = paged_tiles(mp * psz)
    return (use_kernel,
            _knob(cfg, "split_k", lambda v: _legal_split(v, mp)),
            _knob(cfg, "tiles_per_split", lambda v: _legal_tiles(v, tiles)))


def _flash_decode_cuda(q, k, v, length, bias, scale, split_k=None):
    """Launch `csrc/flash_decode.cu`: the [b, h, 1, d] output in q's
    type, the key splits (`flash_decode_plan`, its override the tuning
    table's unless `split_k` is given) merged in the kernel (one
    launch)."""
    _check_operands("flash_decode", q, k, v,
                    (length,) if bias is None else (length, bias))
    b, h, _, d = q.shape
    L = k.shape[2]
    _check_bias("flash_decode", bias, b, L)
    if length.dtype != torch.int32 or not length.is_contiguous():
        raise ValueError("flash_decode: length must be contiguous int32")
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    err = _build.kernels().flash_decode(
        q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if bias is None else bias.data_ptr(),
        length.data_ptr(), out.data_ptr(), b, h, L, d, _row_strides(q, k, v),
        float(_scale(d, scale)),
        decode_split("flash_decode", q, L) if split_k is None else split_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return out


def flash_decode_plain(q, k, v, length, bias=None, scale=None):
    """The decode's function in plain PyTorch, on any device: the JAX
    kernel's partials of DECODE_SPLIT keys and its combine. The kernel
    merges its own splits in another order (float32: the same function;
    bf16: p rounded at another running max)."""
    length = _decode_lengths(q, k, length)
    b, h, _, d = q.shape
    acc, m, l = _decode_partials_plain(q, k, v, length, bias, scale,
                                       DECODE_SPLIT)
    return _combine(acc, m, l, q.dtype).reshape(b, h, 1, d)


def flash_decode(q, k, v, length, bias=None, scale=None):
    """Decode: q [b, h, 1, d] against k/v [b, h, L, d]; `length` (an int
    or [b] int32) is each row's written-token count; bias an optional
    [b, L] float32 key bias. Returns [b, h, 1, d]. CPU tensors run the
    plain version; CUDA tensors launch `csrc/flash_decode.cu`, which
    merges its key splits itself (one launch, no combine; any L,
    head_dim <= 128)."""
    length = _decode_lengths(q, k, length)
    if _device_kind("flash_decode", q) == "cpu":
        return flash_decode_plain(q, k, v, length, bias, scale)
    return _flash_decode_cuda(q, k, v, length, bias, scale)


# --------------------------------------------------------------------------
# verify-mode attention: a T-token draft-verify block against the cache
# --------------------------------------------------------------------------

_SCOPE = threading.local()


@contextlib.contextmanager
def kv_verify_scope():
    """While set (on this thread), a multi-token `MultiHeadAttention` call
    against a preallocated cache (dense or paged) is a speculative
    VERIFY block: the T tokens land at each row's own write offset and
    attend causally within the block through `verify_attention`,
    instead of prefilling an empty cache. Rolling the write index back
    afterwards is the caller's acceptance logic."""
    prev = in_kv_verify_scope()
    _SCOPE.verify = True
    try:
        yield
    finally:
        _SCOPE.verify = prev


@contextlib.contextmanager
def decode_shardings(specs=None):
    """The JAX package's scope that annotates the decode kernels' operands
    with the sharded serving pool's layout (`{"q", "kv", "pages", "out"}`
    -> sharding) for XLA's partitioner. A multi-controller rank has
    nothing to annotate: its decode kernels already see only its own dp
    shard of the slots (the sharded engines run their bodies on this
    rank's rows), so the scope keeps the JAX name and does nothing."""
    yield


def in_kv_verify_scope():
    return getattr(_SCOPE, "verify", False)


def _verify_lengths(name, q, k, length):
    b, h, T, d = q.shape
    if T < 1 or k.shape[2] < T:
        raise ValueError(f"{name}: {T} query tokens against a cache of "
                         f"{k.shape[2]}")
    return _lengths(length, b, q.device)


def verify_attention_reference(q, k, v, length, bias=None, scale=None):
    """Plain verify attention: q [b, h, T, d] are T tokens just written
    into k/v [b, h, L, d] at each row's own offset; `length` (an int or
    [b]) counts the written keys AFTER that write, so query i sits at
    position length - T + i and sees keys <= its own position. bias: an
    optional [b, L] additive key bias. With T == 1 this is
    `decode_attention_reference`."""
    b, h, T, d = q.shape
    L = k.shape[2]
    length = _verify_lengths("verify_attention_reference", q, k, length)
    kpos = torch.arange(L, device=q.device)
    qpos = length[:, None] - T + torch.arange(T, device=q.device)[None]
    m = torch.where(kpos[None, None, :] <= qpos[:, :, None], 0.0,
                    NEG).float()                            # [b, T, L]
    if bias is not None:
        m = m + bias.float().reshape(b, 1, L)
    return sdpa_reference(q, k, v, m[:, None], False, scale)


def _split_partials(qs, kf, vf, length, bias, split, p_dtype):
    """Per-split partials (acc [b*h, ns, T, d], m and l [b*h, ns, T]) of
    T query rows against the cache, as the verify kernels define them:
    logits = qs . k (qs already scaled), key j hidden from row i past
    position length - T + i (-1e30), then the [b, L] bias; m the split's
    max, p = exp(logits - m), l = sum(p), acc = p . v with p rounded to
    `p_dtype` (None: float32). A split starting at or past the row's
    length is the exact-zero partial (acc 0, m -1e30, l 0). Keys past L
    (a ragged last split) never enter the softmax. qs, kf and vf are in
    the accumulation type."""
    b, h, T, d = qs.shape
    L = kf.shape[2]
    ns = -(-L // split)
    pad = ns * split - L
    dev = qs.device
    logits = torch.matmul(qs, kf.transpose(-1, -2))          # [b, h, T, L]
    kpos = torch.arange(L, device=dev)
    qpos = length[:, None] - T + torch.arange(T, device=dev)[None]
    logits = torch.where(kpos[None, None, None, :] <= qpos[:, None, :, None],
                         logits, NEG)
    if bias is not None:
        logits = logits + bias.to(qs.dtype)[:, None, None, :]
    logits = F.pad(logits, (0, pad), value=float("-inf"))
    logits = logits.reshape(b, h, T, ns, split)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    if p_dtype is not None:
        p = p.to(p_dtype).to(qs.dtype)
    vp = F.pad(vf, (0, 0, 0, pad)).reshape(b, h, ns, split, d)
    acc = torch.einsum("bhtns,bhnsd->bhntd", p, vp)
    starts = torch.arange(ns, device=dev) * split
    skip = (starts[None, :] >= length[:, None])[:, None, :, None]  # b,1,ns,1
    acc = acc.masked_fill(skip[..., None], 0.0)
    m = m.transpose(2, 3).masked_fill(skip, NEG)
    l = l.transpose(2, 3).masked_fill(skip, 0.0)
    return (acc.reshape(b * h, ns, T, d), m.reshape(b * h, ns, T),
            l.reshape(b * h, ns, T))


def _verify_partials_plain(q, k, v, length, bias, scale, split):
    """The dense verify kernel's partials: q scaled and rounded to its
    dtype (the TPU kernel's order), p rounded to q's dtype for p . v."""
    return _split_partials(_scaled_q(q, _scale(q.shape[-1], scale)),
                           _up(k, q), _up(v, q), length, bias, split,
                           q.dtype)


def _flash_verify_cuda(q, k, v, length, bias, scale, split_k=None):
    """Launch `csrc/flash_verify.cu`: the [b, h, T, d] output in q's
    type, the key splits (`flash_decode_plan`, its override the tuning
    table's unless `split_k` is given) merged in the kernel (one
    launch)."""
    _check_operands("flash_verify", q, k, v,
                    (length,) if bias is None else (length, bias))
    b, h, T, d = q.shape
    L = k.shape[2]
    _check_bias("flash_verify", bias, b, L)
    if length.dtype != torch.int32 or not length.is_contiguous():
        raise ValueError("flash_verify: length must be contiguous int32")
    out = torch.empty((b, h, T, d), dtype=q.dtype, device=q.device)
    err = _build.kernels().flash_verify(
        q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), None if bias is None else bias.data_ptr(),
        length.data_ptr(), out.data_ptr(), b, h, T, L, d,
        _row_strides(q, k, v), float(_scale(d, scale)),
        decode_split("flash_verify", q, L) if split_k is None else split_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_verify", err)
    LAUNCHES["flash_verify"] += 1
    return out


def flash_verify_plain(q, k, v, length, bias=None, scale=None):
    """The verify's function in plain PyTorch, on any device: the JAX
    kernel's partials of DECODE_SPLIT keys and its combine. The kernel
    merges its own splits in another order (float32: the same function;
    bf16: p rounded at another running max)."""
    length = _verify_lengths("flash_verify", q, k, length)
    b, h, T, d = q.shape
    parts = _verify_partials_plain(q, k, v, length, bias, scale,
                                   DECODE_SPLIT)
    return _combine(*parts, q.dtype).reshape(b, h, T, d)


def flash_verify(q, k, v, length, bias=None, scale=None):
    """Verify: q [b, h, T, d] (T tokens just written at each row's own
    offset) against k/v [b, h, L, d]; `length` (an int or [b] int32)
    counts each row's written keys after that write; bias an optional
    [b, L] float32 key bias. Returns [b, h, T, d]. CPU tensors run the
    plain version; CUDA tensors launch `csrc/flash_verify.cu`, which
    merges its key splits itself (one launch, no combine; any L and T,
    head_dim <= 128; keys at or past `length` are never read)."""
    length = _verify_lengths("flash_verify", q, k, length)
    if _device_kind("flash_verify", q) == "cpu":
        return flash_verify_plain(q, k, v, length, bias, scale)
    return _flash_verify_cuda(q, k, v, length, bias, scale)


# --------------------------------------------------------------------------
# paged decode / verify: the reads through a page table
# --------------------------------------------------------------------------

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _pages_per_split(page_size):
    """Pages per split of the paged plain versions' split-and-combine:
    DECODE_SPLIT keys (one page when pages are larger)."""
    return max(1, DECODE_SPLIT // int(page_size))


def _table_rows(table, n_rows):
    """Physical page rows of `table` entries: an unmapped (-1) or
    out-of-range entry reads the trash row n_rows - 1, as the JAX
    package's trash-clipped table does."""
    table = table.long()
    return torch.where((table < 0) | (table >= n_rows), n_rows - 1, table)


def paged_gather_kv(pages, scales, table, compute_dtype):
    """Dense [S, h, max_pages * page_size, d] logical view of a paged
    cache ([N+1, h, psz, d] pages through a [S, max_pages] table),
    dequantized by the per-(page, head) scales [N+1, h, 1, 1] when given.
    Entries through the trash row gather garbage that the written-length
    mask hides."""
    S, mp = table.shape
    _, h, psz, d = pages.shape
    rows = _table_rows(table, pages.shape[0])
    g = pages[rows]                                   # [S, mp, h, psz, d]
    if scales is not None:
        g = g.float() * scales[rows]
    return g.permute(0, 2, 1, 3, 4).reshape(S, h, mp * psz, d) \
        .to(compute_dtype)


def _paged_partials_plain(q, kp, vp, ks, vs, table, length, bias, scale):
    """The paged plain version's partials: q, K, V and p in float32 after
    the dequant (no rounding to the operand type, the TPU kernels' order),
    one partial per run of `_pages_per_split` logical pages, for the
    combine (the JAX package's split-and-combine)."""
    acc_t = _acc(q)
    qs = q.to(acc_t) * _scale(q.shape[-1], scale)
    kf = paged_gather_kv(kp, ks, table, acc_t)
    vf = paged_gather_kv(vp, vs, table, acc_t)
    split = _pages_per_split(kp.shape[2]) * kp.shape[2]
    return _split_partials(qs, kf, vf, length, bias, split, None)


def _check_paged(name, q, kp, vp, ks, vs, table, length, bias):
    for t in (kp, vp, table, length, *(x for x in (ks, vs, bias)
                                       if x is not None)):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices "
                             f"({t.device} vs {q.device})")
    if q.dtype not in _DTYPES or kp.dtype not in _KV_DTYPES \
            or vp.dtype != kp.dtype:
        raise TypeError(f"{name}: q must be float32 or bfloat16 and the "
                        f"pages one of float32, bfloat16, int8; got "
                        f"{q.dtype}/{kp.dtype}/{vp.dtype}")
    S, h, T, d = q.shape
    if kp.dim() != 4 or vp.shape != kp.shape or kp.shape[1] != h \
            or kp.shape[3] != d:
        raise ValueError(f"{name}: pages must be [N+1, {h}, page_size, {d}]"
                         f", got {tuple(kp.shape)} / {tuple(vp.shape)}")
    if not 1 <= d <= 128:
        raise ValueError(f"{name}: head_dim {d} outside the kernel's 1..128")
    if q.stride(-1) != 1 or kp.stride(-1) != 1 or vp.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if (ks is None) != (vs is None) or (kp.dtype == torch.int8
                                        and ks is None):
        raise ValueError(f"{name}: int8 pages need both k and v scales")
    for sc in (ks, vs):
        if sc is not None and (sc.dtype != torch.float32
                               or tuple(sc.shape) != (kp.shape[0], h, 1, 1)
                               or not sc.is_contiguous()):
            raise ValueError(f"{name}: scales must be contiguous float32 "
                             f"[{kp.shape[0]}, {h}, 1, 1]")
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != S or not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous int32 [{S}, "
                         f"max_pages]")
    if length.dtype != torch.int32 or not length.is_contiguous():
        raise ValueError(f"{name}: length must be contiguous int32")
    _check_bias(name, bias, S, table.shape[1] * kp.shape[2])


def _paged_pointers(q, kp, vp, ks, vs, table, length, bias):
    """The operand pointers of the paged entry points, in their order."""
    return (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), table.data_ptr(),
            length.data_ptr(), None if bias is None else bias.data_ptr())


def _paged_strides(q, kp, vp):
    return _build.strides_arg([*q.stride()[:3], *kp.stride()[:3],
                               *vp.stride()[:3]])


def _split_buffers(q, ns):
    S, h, T, d = q.shape
    return (torch.empty((S * h, ns, T, d), dtype=torch.float32,
                        device=q.device),
            torch.empty((S * h, ns, T), dtype=torch.float32, device=q.device),
            torch.empty((S * h, ns, T), dtype=torch.float32, device=q.device))


def paged_decode_plan(S, h, mp, sms=_build.H100_SMS, split_k=0):
    """(blocks a cluster = key splits of a row, pages a split) of the
    paged decode kernel, and of the paged verify's split route, for S
    slots x h heads over mp pages on a card of `sms` SMs: the C rule
    `pt_paged_decode_plan` written out. A row's pages split in whole pages
    over up to 8 blocks of a thread-block cluster until about three blocks
    an SM run; the kernel merges the splits in rank order. `split_k` is
    the plan's override (0 = the rule; see `_merge_plan`)."""
    if S < 0 or h < 1 or mp < 1:
        raise ValueError(f"paged_flash_decode: no plan for S={S}, h={h}, "
                         f"mp={mp}")
    return _merge_plan(S * h, mp, sms, split_k)


def paged_decode_plan_on_card(S, h, mp, device, split_k=0):
    """`paged_decode_plan` as the built library's C rule gives it on
    `device`'s card (builds the kernels on first use)."""
    out = _build.ints_out(2)
    err = _build.kernels().paged_decode_plan(
        torch.device(device).index or 0, int(S), int(h), int(mp),
        int(split_k), out)
    _raise_on("paged_flash_decode", err)
    return tuple(out)


#: `csrc/paged_verify.cu`'s tiled plan (`tiled::plan`): keys a tile, the
#: blocks an SM it aims for, the most tiles a split, the most splits
_PAGED_TILE, _PAGED_PER_SM, _PAGED_TILES_PER_SPLIT = 64, 1, 4
_PAGED_MAX_SPLITS = 64
#: query rows up to which the paged verify takes the split route
#: (`tiled::SPLIT_MAX_T`; `paged_verify_route` asks the C rule)
PAGED_SPLIT_MAX_T = 8


def paged_tiled_plan(S, h, T, L, sms=_build.H100_SMS, tiles_per_split=0):
    """(query rows a block, key splits, keys a split) of the paged
    verify's tiled route for S slots x h heads, T rows over L keys on a
    card of `sms` SMs: the C rule `pt_paged_verify_plan` (`tiled::plan`)
    written out. Query tiles of 16 RI rows (RI 1, 2 or 4 by T, halved while
    the grid would not fill the card), then enough splits of whole 64-key
    tiles for about a block an SM and at most 4 tiles a split. A legal
    `tiles_per_split` (the tuning table's) replaces the rule's; 0 or an
    illegal value keeps the rule."""
    tiles = max(1, -(-int(L) // _PAGED_TILE))
    target = _PAGED_PER_SM * sms
    ri = 1 if T <= 16 else 2 if T <= 32 else 4

    def base(r):
        return S * h * -(-T // (16 * r))

    while ri > 1 and base(ri) * min(tiles, _PAGED_MAX_SPLITS) < target:
        ri //= 2
    bq = max(1, base(ri))
    want = max(-(-target // bq), -(-tiles // _PAGED_TILES_PER_SPLIT))
    want = min(want, tiles, _PAGED_MAX_SPLITS)
    tps = tiles_per_split if _legal_tiles(tiles_per_split, tiles) \
        else -(-tiles // want)
    return 16 * ri, -(-tiles // tps), tps * _PAGED_TILE


def _paged_decode_cuda(q, kp, vp, ks, vs, table, length, bias, scale,
                      split_k=None):
    """Launch `csrc/paged_decode.cu`: the [S, h, 1, d] output in q's type,
    the key splits (`paged_decode_plan`, its override the tuning table's
    unless `split_k` is given) merged in the kernel (one launch)."""
    name = "paged_flash_decode"
    _check_paged(name, q, kp, vp, ks, vs, table, length, bias)
    S, h, _, d = q.shape
    mp, psz = table.shape[1], kp.shape[2]
    out = torch.empty((S, h, 1, d), dtype=q.dtype, device=q.device)
    if split_k is None:
        _, split_k, _ = paged_overrides(name, q, kp, mp)
    err = _build.kernels().paged_decode(
        q.device.index or 0, _DTYPES[q.dtype], _KV_DTYPES[kp.dtype],
        *_paged_pointers(q, kp, vp, ks, vs, table, length, bias),
        out.data_ptr(), S, h, mp, psz, kp.shape[0], d,
        _paged_strides(q, kp, vp), float(_scale(d, scale)), split_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def paged_verify_route(T, d):
    """The paged verify kernel's route for T query rows of head_dim d, as
    the C entry point's rule `pt_paged_verify_route` gives it (so it builds
    the kernels on first use): "tiled" (the query-tiled kernel: the tail
    prefill of a partial prefix hit) or "split" (the in-kernel split merge
    of `csrc/attn_merge.cuh` over the T rows: the speculative verify
    step)."""
    T, d = int(T), int(d)
    if T < 1 or not 1 <= d <= 128:
        raise ValueError(f"paged_flash_verify: no kernel for T={T} rows of "
                         f"head_dim {d}")
    return "tiled" if _build.kernels().paged_verify_route(T, d) else "split"


def paged_verify_plan(q, L, tiles_per_split=0):
    """(query rows a block, key splits, keys a split) of the tiled route
    for q [S, h, T, d] over L = max_pages * page_size keys on q's card, as
    the C entry point plans it (`pt_paged_verify_plan`; `paged_tiled_plan`
    writes it out), `tiles_per_split` its override (0 = the rule)."""
    S, h, T, _ = q.shape
    out = _build.ints_out(3)
    _build.kernels().paged_verify_plan(q.device.index or 0, S, h, T,
                                       int(L), int(tiles_per_split), out)
    return tuple(out)


def _paged_verify_cuda(q, kp, vp, ks, vs, table, length, bias, scale,
                      split_k=None, tiles_per_split=None):
    """Launch `csrc/paged_verify.cu` on its route (one launch either way):
    the final [S, h, T, d] output in q's type. The plans' overrides are
    the tuning table's unless given."""
    name = "paged_flash_verify"
    _check_paged(name, q, kp, vp, ks, vs, table, length, bias)
    S, h, T, d = q.shape
    mp, psz = table.shape[1], kp.shape[2]
    route = paged_verify_route(T, d)
    out = torch.empty((S, h, T, d), dtype=q.dtype, device=q.device)
    parts, counters = (None, None, None), None
    _, tuned_split, tuned_tps = paged_overrides(name, q, kp, mp)
    split_k = tuned_split if split_k is None else split_k
    tps = tuned_tps if tiles_per_split is None else tiles_per_split
    if route == "tiled":
        bq, ns, _ = paged_verify_plan(q, mp * psz, tps)
        if ns > 1:
            parts = _split_buffers(q, ns)
            counters = torch.empty(S * h * -(-T // bq), dtype=torch.int32,
                                   device=q.device)
    ptr = [None if t is None else t.data_ptr()
           for t in (*parts, out, counters)]
    err = _build.kernels().paged_verify(
        q.device.index or 0, _DTYPES[q.dtype], _KV_DTYPES[kp.dtype],
        *_paged_pointers(q, kp, vp, ks, vs, table, length, bias), *ptr, S,
        h, T, mp, psz, kp.shape[0], d, _paged_strides(q, kp, vp),
        float(_scale(d, scale)), split_k, tps,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(name, err)
    LAUNCHES[name] += 1
    PAGED_ROUTE_LAUNCHES[f"{name}:{route}"] += 1
    return out


def _paged_lengths(name, q, table, kp, length, single):
    S, h, T, d = q.shape
    if single and T != 1:
        raise ValueError(f"{name} takes a single query token per slot, got "
                         f"T={T}; a verify block runs on paged_flash_verify")
    if table.shape[1] * kp.shape[2] < T:
        raise ValueError(f"{name}: {T} query tokens against "
                         f"{table.shape[1]} pages of {kp.shape[2]}")
    return _lengths(length, S, q.device)


def _paged_call(name, single, plain, q, kp, vp, ks, vs, table, length,
                bias, scale):
    """A paged read: its plain version (CPU tensors, or `plain`: partials,
    then the combine) or its kernel (CUDA tensors: one launch that writes
    the output)."""
    length = _paged_lengths(name, q, table, kp, length, single)
    if plain or _device_kind(name, q) == "cpu":
        parts = _paged_partials_plain(q, kp, vp, ks, vs, table, length, bias,
                                      scale)
        return _combine(*parts, q.dtype).reshape(q.shape)
    cuda = _paged_decode_cuda if single else _paged_verify_cuda
    return cuda(q, kp, vp, ks, vs, table, length, bias, scale)


def paged_flash_decode_plain(q, k_pages, v_pages, k_scale, v_scale, table,
                             length, bias=None, scale=None):
    """The paged decode kernel's function in plain PyTorch, on any
    device: per-run partials and the logsumexp combine (the kernel merges
    its own splits in the same arithmetic)."""
    return _paged_call("paged_flash_decode", True, True, q, k_pages, v_pages,
                       k_scale, v_scale, table, length, bias, scale)


def paged_flash_decode(q, k_pages, v_pages, k_scale, v_scale, table,
                       length, bias=None, scale=None):
    """Paged decode: one query token per slot, q [S, h, 1, d], against
    K/V read through the page table: pages [N+1, h, psz, d] (float32,
    bfloat16, or int8 with k_scale / v_scale [N+1, h, 1, 1]), table
    [S, max_pages] int32 (unmapped entries read the trash row N),
    length [S] written counts, bias an optional [S, max_pages * psz]
    float32 key bias in logical positions. CPU tensors run the plain
    version; CUDA tensors launch `csrc/paged_decode.cu`, which merges its
    key splits itself (one launch, no combine)."""
    return _paged_call("paged_flash_decode", True, False, q, k_pages,
                       v_pages, k_scale, v_scale, table, length, bias, scale)


def paged_flash_verify_plain(q, k_pages, v_pages, k_scale, v_scale, table,
                             length, bias=None, scale=None):
    """The paged verify kernel's function in plain PyTorch, on any
    device."""
    return _paged_call("paged_flash_verify", False, True, q, k_pages,
                       v_pages, k_scale, v_scale, table, length, bias, scale)


def paged_flash_verify(q, k_pages, v_pages, k_scale, v_scale, table,
                       length, bias=None, scale=None):
    """Paged verify: T query tokens per slot, q [S, h, T, d], just
    written through the table at each slot's own offset (length counts
    after the write), against K/V read through the table; the rest as
    `paged_flash_decode`. CUDA tensors launch `csrc/paged_verify.cu` on
    the route `paged_verify_route(T, d)` gives (one launch either way, no
    combine)."""
    return _paged_call("paged_flash_verify", False, False, q, k_pages,
                       v_pages, k_scale, v_scale, table, length, bias, scale)


# --------------------------------------------------------------------------
# dispatchers
# --------------------------------------------------------------------------

def sdpa(q, k, v, mask=None, is_causal=False, scale=None, dropout_p=0.0,
         dropout_seed=None, segment_ids=None, dropout_address=None):
    """Attention dispatch (the JAX `sdpa`): the differentiable flash
    attention whenever the mask reduces to a per-key bias (none, or
    every padded batch), with in-kernel attention dropout when
    dropout_p > 0 (dropout_seed then required) and the segment mask of
    packed rows when segment_ids ([b, s] integer, non-decreasing along
    each row) are given, on every device. A richer mask runs the
    reference composition (with the segment mask folded in) on the CPU
    without dropout, and raises on any other device or with dropout:
    no kernel takes such a mask. dropout_address: see `flash_attention`."""
    bias = None if mask is None else _kv_bias(mask, q.shape[0], k.shape[2])
    if mask is None or bias is not None:
        return flash_attention(q, k, v, bias, is_causal, scale,
                               dropout_p=dropout_p, dropout_seed=dropout_seed,
                               segment_ids=segment_ids,
                               dropout_address=dropout_address)
    if q.device.type == "cpu" and not dropout_p:
        if segment_ids is not None:
            if mask.dtype == torch.bool:
                mask = torch.where(mask, 0.0, NEG).float()
            mask = mask.float() + segment_bias(segment_ids).to(q.device)
        return sdpa_reference(q, k, v, mask, is_causal, scale)
    where = "with attention dropout" if dropout_p else \
        f"on a {q.device.type} device"
    raise NotImplementedError(
        f"sdpa: no kernel takes a {tuple(mask.shape)} mask that varies per "
        f"query or per head ({where}). Pass packed segment ids "
        f"(segment_ids=) or a [b, 1, 1, sk] key bias with is_causal=True")


def decode_attention(q, k, v, length, bias=None, scale=None):
    """Single-token decode against a preallocated cache through the
    flash decode (bias: [b, L] or [b, 1, 1, L])."""
    return flash_decode(q, k, v, length, _flat_bias(bias, q, k.shape[2]),
                        scale)


def _flat_bias(bias, q, L):
    """A [b, L] or [b, 1, 1, L] key bias as a contiguous [b, L] float32."""
    if bias is None:
        return None
    return bias.float().reshape(q.shape[0], L).contiguous()


def verify_attention(q, k, v, length, bias=None, scale=None):
    """Verify-block attention against a preallocated cache through
    `flash_verify` (bias: [b, L] or [b, 1, 1, L])."""
    return flash_verify(q, k, v, length, _flat_bias(bias, q, k.shape[2]),
                        scale)


def _paged_dispatch(paged_fn, dense_fn, q, k_pages, v_pages, k_scale,
                    v_scale, table, length, bias, scale):
    bias = _flat_bias(bias, q, table.shape[1] * k_pages.shape[2])
    gather = q.device.type == "cpu"
    split_k = None
    if not gather:
        # a tuned `kernel: False` takes the JAX gather route on the card:
        # the dense logical view, then the dense kernel at the entry's
        # split_k
        name = "paged_flash_decode" if paged_fn is paged_flash_decode \
            else "paged_flash_verify"
        use_kernel, split_k, _ = paged_overrides(name, q, k_pages,
                                                 table.shape[1])
        gather = not use_kernel
    if gather:
        kd = paged_gather_kv(k_pages, k_scale, table, q.dtype)
        vd = paged_gather_kv(v_pages, v_scale, table, q.dtype)
        L = kd.shape[2]
        if q.device.type == "cuda" and \
                _legal_split(split_k, -(-L // _DECODE_UNIT)):
            dense = _flash_verify_cuda if dense_fn is flash_verify else \
                _flash_decode_cuda
            return dense(q, kd, vd, _lengths(length, q.shape[0], q.device),
                         bias, scale, split_k)
        return dense_fn(q, kd, vd, length, bias, scale)
    return paged_fn(q, k_pages, v_pages, k_scale, v_scale, table, length,
                    bias, scale)


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, table,
                           length, bias=None, scale=None):
    """Paged decode dispatch (the JAX `paged_decode_attention`): on the
    CPU, gather the dense logical view and run the dense pool's plain
    decode (fp32 pages then give the dense pool's output bit for bit);
    on the card, the page-table kernel."""
    return _paged_dispatch(paged_flash_decode, flash_decode, q, k_pages,
                           v_pages, k_scale, v_scale, table, length, bias,
                           scale)


def paged_verify_attention(q, k_pages, v_pages, k_scale, v_scale, table,
                           length, bias=None, scale=None):
    """Paged verify dispatch: the gather + dense plain verify on the CPU,
    the page-table verify kernel on the card."""
    return _paged_dispatch(paged_flash_verify, flash_verify, q, k_pages,
                           v_pages, k_scale, v_scale, table, length, bias,
                           scale)
