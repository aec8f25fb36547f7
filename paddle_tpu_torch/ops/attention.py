"""Attention for the serving path: plain PyTorch versions and the
wrappers of the two hand-written Hopper kernels.

Layout: (batch, heads, seq, head_dim) throughout, as in the JAX
package's `ops/attention.py`.

  * `flash_attention_fwd` -> `csrc/flash_fwd.cu`: online-softmax
    attention with an optional [b, sk] key bias and causal masking,
    returning (out, lse). Carries prompt prefill, encoder
    self-attention and every cross-attention over the memory.
  * `flash_decode` -> `csrc/flash_decode.cu`: one query token per row
    against a preallocated KV cache, split-K over the cache length with
    per-row written lengths; the logsumexp combine of the per-split
    partials runs here as torch ops (the JAX package does it in XLA).

Each wrapper runs its kernel's plain PyTorch version when its tensors
lie on the CPU, and launches the kernel when they lie on a CUDA card;
there is no fallback from a failed launch. `LAUNCHES` counts kernel
launches per wrapper. The dispatchers `sdpa` and `decode_attention`
mirror the JAX ones: a mask that reduces to a per-key bias rides the
flash kernel. A richer (per-query or per-head) mask goes to the
`sdpa_reference` composition on the CPU only; on the card it raises,
since no kernel takes such a mask yet (pass a [b, sk] key bias with
`is_causal` instead).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["NEG", "LAUNCHES", "reset_launches", "sdpa_reference",
           "decode_attention_reference", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_decode", "flash_decode_plain",
           "sdpa", "decode_attention", "DECODE_SPLIT"]

NEG = -1e30
#: keys per split of the decode kernel: 128 keys keep a [8 x 8 heads]
#: decode batch at ~1k cached tokens above 500 blocks on 132 SMs
DECODE_SPLIT = 128
#: kernel launches per wrapper; each wrapper adds one where it launches
#: its kernel and nowhere else (plain CPU runs do not count)
LAUNCHES = {"flash_fwd": 0, "flash_decode": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(d, scale):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _scaled_q(q, s):
    """The query with the softmax scale folded in once, rounded to the
    operand type (what both kernels do), as float32."""
    return (q.float() * s).to(q.dtype).float()


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

def flash_attention_fwd_plain(q, k, v, bias=None, is_causal=False,
                              scale=None):
    """The flash forward's function in plain PyTorch: (out [b,h,sq,d],
    lse [b*h, sq, 1]). Running max floored at -1e30, p rounded to the
    operand type for the p.v product, normaliser floored at 1e-30 —
    the kernel's math without the tiling. Rows with no visible key at
    all are degenerate and left unspecified (the kernel may differ)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    logits = torch.matmul(_scaled_q(q, _scale(d, scale)),
                          k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, NEG)
    m = logits.amax(-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
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


def _flash_fwd_cuda(q, k, v, bias, is_causal, scale):
    _check_operands("flash_fwd", q, k, v,
                    () if bias is None else (bias,))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_bias("flash_fwd", bias, b, sk)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    if sq == 0 or b * h == 0:
        return out, lse
    strides = _build.strides_arg(
        [q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
         k.stride(2), v.stride(0), v.stride(1), v.stride(2)])
    fn = _build.kernels().flash_fwd
    err = fn(q.device.index or 0, _DTYPES[q.dtype], q.data_ptr(),
             k.data_ptr(), v.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, sq, sk, d, strides,
             float(_scale(d, scale)), int(bool(is_causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, bias=None, is_causal=False, scale=None):
    """Flash forward: (out [b, h, sq, d], lse [b*h, sq, 1]). bias: an
    optional [b, sk] float32 additive key bias. Causal aligns at the
    end of the key axis (the reference semantics; start-aligned when
    sq == sk). CPU tensors run `flash_attention_fwd_plain`; CUDA tensors
    launch `csrc/flash_fwd.cu` (any sq / sk, head_dim <= 128)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, is_causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for "
                         f"{q.device.type} tensors")
    return _flash_fwd_cuda(q, k, v, bias, is_causal, scale)


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

def sdpa(q, k, v, mask=None, is_causal=False, scale=None):
    """Attention dispatch: the flash forward whenever the mask reduces
    to a per-key bias (none, or every padded batch). A richer mask runs
    the reference composition on the CPU and raises on any other
    device: no kernel takes it yet."""
    if mask is None:
        return flash_attention_fwd(q, k, v, None, is_causal, scale)[0]
    bias = _kv_bias(mask, q.shape[0], k.shape[2])
    if bias is not None:
        return flash_attention_fwd(q, k, v, bias, is_causal, scale)[0]
    if q.device.type == "cpu":
        return sdpa_reference(q, k, v, mask, is_causal, scale)
    raise NotImplementedError(
        f"sdpa: a {tuple(mask.shape)} mask varies per query or per head, "
        f"and no {q.device.type} kernel takes such a mask yet (per-query "
        f"masks come with the training slice's segment ids). Pass a "
        f"[b, 1, 1, sk] key bias with is_causal=True, or run on the CPU")


def decode_attention(q, k, v, length, bias=None, scale=None):
    """Single-token decode against a preallocated cache through the
    split-K flash decode (bias: [b, L] or [b, 1, 1, L])."""
    if bias is not None:
        bias = bias.float().reshape(q.shape[0], k.shape[2]).contiguous()
    return flash_decode(q, k, v, length, bias, scale)
