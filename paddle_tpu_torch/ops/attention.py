"""Attention: plain PyTorch versions and the wrappers of the port's
hand-written Hopper kernels.

Layout: (batch, heads, seq, head_dim) throughout, as in the JAX
package's `ops/attention.py`.

  * `flash_attention_fwd` -> `csrc/flash_fwd.cu`: online-softmax
    attention with an optional [b, sk] key bias, causal masking and
    in-kernel attention dropout, returning (out, lse). Carries prompt
    prefill, encoder self-attention, every cross-attention over the
    memory, and the training forward.
  * `flash_attention_bwd` -> `csrc/flash_bwd_dq.cu` (dQ, looping over
    key tiles) and `csrc/flash_bwd_dkv.cu` (dK, dV and the key-bias
    gradient, looping over query tiles). Both recompute the
    probabilities from the saved lse; delta = rowsum(dO * O) is one
    torch op here, as it is one XLA op in the JAX package.
  * `flash_attention`: the differentiable entry (`_FlashAttention`, a
    `torch.autograd.Function` over the three kernels).
  * `flash_decode` -> `csrc/flash_decode.cu`: one query token per row
    against a preallocated KV cache, split-K over the cache length with
    per-row written lengths; the logsumexp combine of the per-split
    partials runs here as torch ops (the JAX package does it in XLA).

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
launches per wrapper. The dispatchers `sdpa` and `decode_attention`
mirror the JAX ones: a mask that reduces to a per-key bias rides the
flash kernels. A richer (per-query or per-head) mask goes to the
`sdpa_reference` composition on the CPU only and without attention
dropout; on the card, or with dropout, it raises, since no kernel takes
such a mask yet (pass a [b, sk] key bias with `is_causal` instead).
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["NEG", "LAUNCHES", "reset_launches", "DropSpec", "drop_spec",
           "dropout_keep_reference", "sdpa_reference",
           "decode_attention_reference", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention", "flash_decode",
           "flash_decode_plain", "sdpa", "decode_attention", "DECODE_SPLIT"]

NEG = -1e30
#: keys per split of the decode kernel: 128 keys keep a [8 x 8 heads]
#: decode batch at ~1k cached tokens above 500 blocks on 132 SMs
DECODE_SPLIT = 128
#: kernel launches per wrapper; each wrapper adds one where it launches
#: its kernel and nowhere else (plain CPU runs do not count)
LAUNCHES = {"flash_fwd": 0, "flash_decode": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
#: seed (a host int, read as uint32) and the logical blocks that address
#: the bits
DropSpec = collections.namedtuple("DropSpec", ["p", "seed", "block_q",
                                               "block_k"])
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


def drop_spec(dropout_p, seed, sq, sk, block_q=None, block_k=None):
    """The DropSpec of one attention call (None when dropout_p is 0).
    `seed` is an int or a one-element integer tensor (int32 in the JAX
    package); it is read as uint32."""
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
    return DropSpec(float(dropout_p), int(seed) & _M32, int(bq), int(bk))


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
                           device="cpu"):
    """Keep mask [b*h, sq, sk] (bool) of the in-kernel attention dropout:
    the bits the kernels draw, computed with torch ops on `device`. Any
    sq / sk: a ragged tail row takes qi = row // block_q like every
    other row."""
    thresh, _ = _drop_consts(dropout_p)
    i64 = dict(dtype=torch.int64, device=device)
    rows = torch.arange(sq, **i64)
    cols = torch.arange(sk, **i64)
    bh = torch.arange(b * h, **i64)[:, None, None]
    qi, r = (rows // block_q)[None, :, None], (rows % block_q)[None, :, None]
    ki, c = (cols // block_k)[None, None, :], (cols % block_k)[None, None, :]
    seed = torch.tensor(int(seed) & _M32, **i64)
    return _hash_bits(seed, bh, qi, ki, r, c) >= thresh


def _keep4(drop, b, h, sq, sk, device):
    return dropout_keep_reference(drop.seed, b, h, sq, sk, drop.block_q,
                                  drop.block_k, drop.p, device) \
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

def _logits(q, k, bias, is_causal, s):
    """The kernels' logits as float32: round(q * s) . k + bias, causal
    keys (end-aligned) set to -1e30."""
    sq, sk = q.shape[2], k.shape[2]
    logits = torch.matmul(_scaled_q(q, s), _up(k, q).transpose(-1, -2))
    if bias is not None:
        logits = logits + _up(bias, q)[:, None, None, :]
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG)
    return logits


def flash_attention_fwd_plain(q, k, v, bias=None, is_causal=False,
                              scale=None, dropout=None):
    """The flash forward's function in plain PyTorch: (out [b,h,sq,d],
    lse [b*h, sq, 1]). Running max floored at -1e30, p rounded to the
    operand type for the p.v product, normaliser floored at 1e-30 —
    the kernel's math without the tiling. With `dropout` (a DropSpec)
    the p.v product sees the dropped, upscaled p while the normaliser
    keeps summing the raw p (the JAX kernel's order). Rows with no
    visible key at all are degenerate and left unspecified (the kernel
    may differ)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    logits = _logits(q, k, bias, is_causal, _scale(d, scale))
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


def _check_operands(name, q, k, v, extra=()):
    """Device / dtype / layout checks of a kernel wrapper: everything on
    one CUDA device, q/k/v one supported dtype with unit stride on the
    head dim, head_dim <= 128."""
    for t in (q, k, v, *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices "
                             f"({t.device} vs {q.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, "
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


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


def _drop_args(drop):
    """(seed, keep threshold, 1/keep, block_q, block_k) for the C entry
    points; block_q 0 switches dropout off."""
    if drop is None:
        return 0, 0, 1.0, 0, 0
    thresh, inv_keep = _drop_consts(drop.p)
    return drop.seed, thresh, inv_keep, drop.block_q, drop.block_k


def _row_strides(*ts):
    """(batch, head, row) element strides of each [b, h, s, d] operand."""
    return _build.strides_arg([x for t in ts for x in t.stride()[:3]])


def _flash_fwd_cuda(q, k, v, bias, is_causal, scale, dropout=None):
    _check_operands("flash_fwd", q, k, v,
                    () if bias is None else (bias,))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_bias("flash_fwd", bias, b, sk)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    if sq == 0 or b * h == 0:
        return out, lse
    fn = _build.kernels().flash_fwd
    err = fn(q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, sq, sk, d, _row_strides(q, k, v),
             float(_scale(d, scale)), int(bool(is_causal)),
             *_drop_args(dropout),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _device_kind(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {q.device.type} tensors")
    return q.device.type


def flash_attention_fwd(q, k, v, bias=None, is_causal=False, scale=None,
                        dropout=None):
    """Flash forward: (out [b, h, sq, d], lse [b*h, sq, 1]). bias: an
    optional [b, sk] float32 additive key bias. Causal aligns at the
    end of the key axis (the reference semantics; start-aligned when
    sq == sk). dropout: a DropSpec (see `drop_spec`) or None. CPU
    tensors run `flash_attention_fwd_plain`; CUDA tensors launch
    `csrc/flash_fwd.cu` (any sq / sk, head_dim <= 128)."""
    if _device_kind("flash_attention_fwd", q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, is_causal, scale,
                                         dropout)
    return _flash_fwd_cuda(q, k, v, bias, is_causal, scale, dropout)


# --------------------------------------------------------------------------
# flash backward (dQ, dK/dV): plain version + kernel wrappers
# --------------------------------------------------------------------------

def _delta(g, out):
    """delta = rowsum(dO * O) in float32, [b*h, sq]: the softmax
    correction term (one torch op, as in the JAX package)."""
    b, h, sq, _ = g.shape
    return (_up(g, g) * _up(out, g)).sum(-1).reshape(b * h, sq)


def flash_attention_bwd_plain(q, k, v, bias, out, lse, g, is_causal=False,
                              scale=None, dropout=None, need_dbias=True):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv,
    dbias). The logits are recomputed with the forward's scale folding
    and subtract the saved lse; dq folds the scale into k and dk into q
    (each rounded to the operand type, as the JAX kernels do); with
    dropout, dP and the P of the dV product see the same keep bits as
    the forward. dbias ([b, sk] float32, the key bias's gradient summed
    over heads) is None without a bias or when not needed."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    s = _scale(d, scale)
    logits = _logits(q, k, bias, is_causal, s)
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


def _check_bwd(name, q, k, v, bias, g, lse, delta):
    _check_operands(name, q, k, v, tuple(
        t for t in (bias, g, lse, delta) if t is not None))
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


def _flash_bwd_dq_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                       dropout=None):
    _check_bwd("flash_bwd_dq", q, k, v, bias, g, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b * h == 0:
        return dq
    fn = _build.kernels().flash_bwd_dq
    err = fn(q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk,
             d, _row_strides(q, k, v, g), float(_scale(d, scale)),
             int(bool(is_causal)), *_drop_args(dropout),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dq", err)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                        dropout=None, need_dbias=True):
    """(dk, dv, dbias per (b*h, key) as [b*h, sk] float32 or None)."""
    _check_bwd("flash_bwd_dkv", q, k, v, bias, g, lse, delta)
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
    err = fn(q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             None if db is None else db.data_ptr(), b, h, sq, sk, d,
             _row_strides(q, k, v, g), float(_scale(d, scale)),
             int(bool(is_causal)), *_drop_args(dropout),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_bwd_dkv", err)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv, db


def flash_attention_bwd(q, k, v, bias, out, lse, g, is_causal=False,
                        scale=None, dropout=None, need_dbias=True):
    """Flash backward: (dq, dk, dv, dbias) from the forward's inputs, its
    output and lse, and dO = g (any strides with a contiguous head dim).
    CPU tensors run `flash_attention_bwd_plain`; CUDA tensors launch
    `csrc/flash_bwd_dq.cu` and `csrc/flash_bwd_dkv.cu` on the current
    stream (the autograd engine's, when called from backward)."""
    if _device_kind("flash_attention_bwd", q) == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, g,
                                         is_causal, scale, dropout,
                                         need_dbias)
    b, h, _, _ = q.shape
    delta = _delta(g, out)
    lse = lse.reshape(b * h, -1)
    dq = _flash_bwd_dq_cuda(q, k, v, bias, g, lse, delta, is_causal, scale,
                            dropout)
    dk, dv, db = _flash_bwd_dkv_cuda(q, k, v, bias, g, lse, delta,
                                     is_causal, scale, dropout, need_dbias)
    dbias = None if db is None else db.reshape(b, h, -1).sum(1)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX `_flash_diff_fn`): the
    forward kernel saves out and lse, the two backward kernels recompute
    P from them; the dropout bits are regenerated from the saved seed."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal, scale, dropout):
        out, lse = flash_attention_fwd(q, k, v, bias, is_causal, scale,
                                       dropout)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.cfg = (is_causal, scale, dropout)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        is_causal, scale, dropout = ctx.cfg
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, bias, out, lse, g, is_causal, scale, dropout,
            need_dbias)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, is_causal=False, scale=None,
                    block_q=None, block_k=None, dropout_p=0.0,
                    dropout_seed=None):
    """Differentiable flash attention over [b, h, s, d] operands (the
    JAX `flash_attention`): bias an optional [b, sk] float32 key bias
    (it gets a gradient when it requires one); dropout_p the in-kernel
    attention dropout, addressed by (dropout_seed, b*h, logical block)
    so the forward and both backward kernels regenerate the same bits.
    block_q / block_k override the logical dropout blocks (the JAX
    package's block sizes); the kernels tile by 64 regardless. Without
    gradients to compute it runs the forward alone."""
    sq, sk = q.shape[2], k.shape[2]
    dropout = drop_spec(dropout_p, dropout_seed, sq, sk, block_q, block_k)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, is_causal, scale,
                                     dropout)
    return flash_attention_fwd(q, k, v, bias, is_causal, scale, dropout)[0]


# --------------------------------------------------------------------------
# split-K flash decode: plain version + kernel wrapper
# --------------------------------------------------------------------------

def _decode_partials_plain(q, k, v, length, bias, scale, split):
    """Per-split (acc [b*h, ns, d], m, l [b*h, ns]) exactly as the
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


def _decode_partials_cuda(q, k, v, length, bias, scale, split):
    _check_operands("flash_decode", q, k, v,
                    (length,) if bias is None else (length, bias))
    b, h, _, d = q.shape
    L = k.shape[2]
    _check_bias("flash_decode", bias, b, L)
    if length.dtype != torch.int32 or not length.is_contiguous():
        raise ValueError("flash_decode: length must be contiguous int32")
    ns = -(-L // split)
    acc = torch.empty((b * h, ns, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b * h, ns), dtype=torch.float32, device=q.device)
    l = torch.empty((b * h, ns), dtype=torch.float32, device=q.device)
    strides = _build.strides_arg(
        [q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
         v.stride(0), v.stride(1), v.stride(2)])
    fn = _build.kernels().flash_decode
    err = fn(q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), length.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, L, d,
             int(split), strides, float(_scale(d, scale)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return acc, m, l


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


def flash_decode_plain(q, k, v, length, bias=None, scale=None):
    """The decode kernel's function in plain PyTorch, on any device:
    the same per-split partials and the same combine."""
    length = _decode_lengths(q, k, length)
    b, h, _, d = q.shape
    acc, m, l = _decode_partials_plain(q, k, v, length, bias, scale,
                                       DECODE_SPLIT)
    return _combine(acc, m, l, q.dtype).reshape(b, h, 1, d)


def flash_decode(q, k, v, length, bias=None, scale=None):
    """Split-K decode: q [b, h, 1, d] against k/v [b, h, L, d]; `length`
    (an int or [b] int32) is each row's written-token count; bias an
    optional [b, L] float32 key bias. Returns [b, h, 1, d]. CPU tensors
    compute the partials with the plain version; CUDA tensors launch
    `csrc/flash_decode.cu` (any L, head_dim <= 128)."""
    length = _decode_lengths(q, k, length)
    b, h, _, d = q.shape
    if q.device.type == "cpu":
        parts = _decode_partials_plain(q, k, v, length, bias, scale,
                                       DECODE_SPLIT)
    elif q.device.type == "cuda":
        parts = _decode_partials_cuda(q, k, v, length, bias, scale,
                                      DECODE_SPLIT)
    else:
        raise ValueError(f"flash_decode: no kernel for {q.device.type} "
                         f"tensors")
    return _combine(*parts, q.dtype).reshape(b, h, 1, d)


# --------------------------------------------------------------------------
# dispatchers
# --------------------------------------------------------------------------

def sdpa(q, k, v, mask=None, is_causal=False, scale=None, dropout_p=0.0,
         dropout_seed=None):
    """Attention dispatch (the JAX `sdpa`): the differentiable flash
    attention whenever the mask reduces to a per-key bias (none, or
    every padded batch), with in-kernel attention dropout when
    dropout_p > 0 (dropout_seed then required). A richer mask runs the
    reference composition on the CPU without dropout, and raises on any
    other device or with dropout: no kernel takes it yet."""
    bias = None if mask is None else _kv_bias(mask, q.shape[0], k.shape[2])
    if mask is None or bias is not None:
        return flash_attention(q, k, v, bias, is_causal, scale,
                               dropout_p=dropout_p, dropout_seed=dropout_seed)
    if q.device.type == "cpu" and not dropout_p:
        return sdpa_reference(q, k, v, mask, is_causal, scale)
    if dropout_p:
        raise NotImplementedError(
            f"sdpa: attention dropout under a {tuple(mask.shape)} mask that "
            f"varies per query or per head has no kernel yet (it comes "
            f"with the packed slice's segment ids). Pass a [b, 1, 1, sk] "
            f"key bias with is_causal=True")
    raise NotImplementedError(
        f"sdpa: a {tuple(mask.shape)} mask varies per query or per head, "
        f"and no {q.device.type} kernel takes such a mask yet (per-query "
        f"masks come with the packed slice's segment ids). Pass a "
        f"[b, 1, 1, sk] key bias with is_causal=True, or run on the CPU")


def decode_attention(q, k, v, length, bias=None, scale=None):
    """Single-token decode against a preallocated cache through the
    split-K flash decode (bias: [b, L] or [b, 1, 1, L])."""
    if bias is not None:
        bias = bias.float().reshape(q.shape[0], k.shape[2]).contiguous()
    return flash_decode(q, k, v, length, bias, scale)
