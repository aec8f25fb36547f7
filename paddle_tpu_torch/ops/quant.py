"""Quantized and gathered matmuls for multi-tenant serving: plain PyTorch
versions and the wrappers of the port's hand-written Hopper kernels (the
JAX package's `ops/quant.py`).

  * `int8_matmul` -> `csrc/int8_matmul.cu`: a weight stored as symmetric
    per-output-channel int8 with float32 scales (`quantize_int8_weight`),
    ``y = (f32(x) @ f32(q)) * scale [+ bias]`` with a float32 accumulate,
    cast back to x's type. The large dense weights of a serving stack
    (attention projections, FFN, the logits projection) take this path
    after `quantize="int8"`. Both routes run on the tensor cores with x
    in three bf16 pieces, each exact against the int8 weight: decode and
    verify steps (m <= 32) on the skinny route (`mma.sync`, one launch,
    d split over a thread-block cluster as `skinny_plan` gives), a prompt
    bucket on the tiled route (wgmma, d split over blocks only for small
    grids, `_int8_splits`) (`ROUTE_LAUNCHES`).
  * `lora_delta` -> `csrc/lora_gather.cu`: the per-row low-rank adapter
    delta of the multi-tenant pool, ``(f32(x[i]) @ A[ids[i]]) @
    B[ids[i]]`` over stacked ``A [cap, d_in, r]`` / ``B [cap, r, d_out]``
    banks. Bank row 0 is the base model and stays all-zero, so base
    requests get an exact zero through the same arithmetic.
  * `int8_gather`: the embedding lookup over an int8 table (gather the
    rows, apply the scales); plain torch, as the JAX package has no
    Pallas kernel behind it.

Each dispatcher runs the plain version when its tensors lie on the CPU
and launches the kernel when they lie on a CUDA card; there is no
fallback from a failed launch. The kernels take any m, n and d, and any
rank up to `LORA_MAX_RANK` (the wrapper raises above it). `LAUNCHES`
counts kernel launches per wrapper.

The adapter ids and banks reach the Linear layers through a scope
(`lora_scope`), not through signatures: the serving bodies open it
around the net's call, and every Linear an `AdapterPool` installed
`_lora_idx` on adds its delta. The ids are host integers, validated
against the bank capacity on the host and copied to the card once per
scope (the TPU kernel took them by scalar prefetch), so no kernel ever
reads a bank out of bounds.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "reset_launches", "LORA_MAX_RANK",
           "quantize_int8_weight", "int8_matmul_reference", "int8_matmul",
           "int8_gather", "lora_delta_reference", "lora_delta",
           "merge_lora_weight", "lora_scope", "current_lora",
           "lora_gather_plan", "lora_plan", "skinny_plan",
           "skinny_plan_on_card", "int8_key", "lora_key"]

#: kernel launches per wrapper (`reset_launches` zeroes these and
#: `ops.attention.LAUNCHES` together)
LAUNCHES = _build.counter(["int8_matmul", "lora_gather"])
#: int8_matmul launches by path, the C entry point's rule (m <= 32):
#: "int8_matmul:skinny" (decode and verify steps, mma.sync, k-splits
#: merged in the kernel), "int8_matmul:tiled" (a prompt bucket, wgmma);
#: both on the tensor cores; each also counted in LAUNCHES
ROUTE_LAUNCHES = _build.counter(["int8_matmul:skinny", "int8_matmul:tiled"],
                                branch=True)
reset_launches = _build.reset_launches
_QMAX = 127.0
#: the largest adapter rank `csrc/lora_gather.cu` takes
LORA_MAX_RANK = 32
#: `lora_plan`'s largest row tile and cluster (`csrc/lora_gather.cu`)
_LORA_ROWS, _LORA_CLUSTER = 16, 8
#: the skinny route of `csrc/int8_matmul.cu` (m <= 32, `skinny::plan`):
#: output columns a block, the k-rows a stage of four warps (a split is
#: whole stages), the most blocks a cluster (k-splits), and blocks an SM
#: to aim for
_SKINNY_M, _SKINNY_COLS, _SKINNY_KC = 32, 128, 64
_SKINNY_CLUSTER, _SKINNY_PER_SM = 8, 2

#: the tiled path (m > 32): output tile rows and columns, the blocks to
#: aim for (one an SM) when a grid of fewer than half as many tiles splits
#: d, and the least k a split keeps (4 of the kernel's 32-deep chunks)
_TILE_M, _TILE_N, _TILED_TARGET, _TILED_MIN_K = 128, 128, 132, 128


# --------------------------------------------------------------------------
# weight quantization
# --------------------------------------------------------------------------

def quantize_int8_weight(w):
    """Symmetric per-output-channel int8: ``w [..., d_out]`` -> ``(q int8,
    scale float32 [d_out])`` with ``scale = amax(|column|) / 127`` (1.0
    for an all-zero column, so the dequant never divides by zero) and
    ``q = clip(round(w / scale), -127, 127)``, rounding half to even."""
    w32 = torch.as_tensor(w).float()
    red = tuple(range(w32.dim() - 1))
    amax = w32.abs().amax(dim=red)
    scale = torch.where(amax > 0, amax / _QMAX,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(w32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


# --------------------------------------------------------------------------
# int8 matmul: plain version, kernel wrapper, dispatcher
# --------------------------------------------------------------------------

def int8_matmul_reference(x, q, scale, bias=None):
    """``(f32(x) @ f32(q)) * scale`` cast to x's type, then ``+ bias``:
    the kernel's function in plain PyTorch, on any device. Scaling after
    the product equals dequantizing first (the scales are per output
    channel)."""
    acc = torch.matmul(x.float(), q.float()) * scale.float()
    out = acc.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _check_device(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices "
                             f"({t.device} vs {dev})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev.type} tensors")
    return dev.type


def skinny_plan(m, d, n, sms=_build.H100_SMS, split_k=0):
    """(8-row tiles of m, blocks a cluster, k-rows a split, warps a block)
    of the skinny route (m <= 32) on a card of `sms` SMs: the C rule
    `pt_int8_matmul_skinny_plan` written out. Output columns come in
    strips of 128; d is split in whole 64-row stages over up to 8 blocks
    of a thread-block cluster until about two blocks an SM run, and the
    kernel adds the splits' partials in rank order. A grid still short of
    a block an SM whose splits hold whole 128-row stages takes 8 warps a
    block (128-row stages), else 4. A legal `split_k` (the tuning table's:
    1..8 blocks, at most one a 64-row stage) replaces the rule's split; 0
    or an illegal value keeps the rule."""
    if not 0 < m <= _SKINNY_M:
        raise ValueError(f"int8_matmul: the skinny route takes 1 <= m <= "
                         f"{_SKINNY_M}, got m={m}")
    mt = 1 if m <= 8 else 2 if m <= 16 else 4
    strips = max(1, -(-n // _SKINNY_COLS))
    chunks = -(-d // _SKINNY_KC) if d > 0 else 1
    want = -(-_SKINNY_PER_SM * sms // strips)
    split = split_k if _legal_cluster(split_k, chunks) else \
        max(1, min(_SKINNY_CLUSTER, chunks, want))
    per = -(-chunks // split)
    c, kps = -(-chunks // per), per * _SKINNY_KC
    warps = 8 if strips * c < sms and kps % (2 * _SKINNY_KC) == 0 else 4
    return mt, c, kps, warps


def _legal_cluster(c, units):
    """A tuned cluster the kernels take: 1..8 blocks (portable), at most
    one a unit of work."""
    return type(c) is int and 1 <= c <= min(_SKINNY_CLUSTER, units)


# --------------------------------------------------------------------------
# the tuning table's consult sites (`tuning/table.py`)
# --------------------------------------------------------------------------

def _tuned(kernel, key):
    """The tuning table's config for (kernel, key), or None: a miss, and
    any failure of the tuning layer, run the rule (the JAX `_tuned`)."""
    from ..tuning import table as _tbl

    return _tbl.tuned(kernel, key)


def int8_key(m, d, n, dtype):
    """The table key of an int8 matmul launch: (contraction d, output
    columns n, x's dtype, rows m), sizes bucketed (the JAX key with m
    added: the skinny rule reads it)."""
    from ..tuning.table import seq_bucket

    return (seq_bucket(d), seq_bucket(n), str(dtype).replace("torch.", ""),
            seq_bucket(m))


def int8_split(m, d, n, dtype=torch.float32):
    """The tuned split_k of a skinny-route launch (0 = the rule)."""
    cfg = _tuned("int8_matmul", int8_key(m, d, n, dtype))
    v = cfg.get("split_k") if cfg else None
    chunks = -(-d // _SKINNY_KC) if d > 0 else 1
    return v if _legal_cluster(v, chunks) else 0


def lora_key(b, s, d, r, dtype):
    """The table key of a gathered-LoRA launch: (d bucket, rank, dtype,
    batch rows b, tokens a row s), sizes bucketed (the JAX key with the
    plan's b and s added)."""
    from ..tuning.table import seq_bucket

    return (seq_bucket(d), int(r), str(dtype).replace("torch.", ""),
            seq_bucket(b), seq_bucket(s))


def _legal_lora_cluster(c, d, n):
    """`lora_plan`'s check of a tuned cluster: 1..8 CTAs, each with 4 or
    more of d and of n."""
    return type(c) is int and 1 <= c <= _LORA_CLUSTER and \
        4 * c <= d + 3 and 4 * c <= n + 3


def lora_overrides(b, s, d, r, n, dtype=torch.float32):
    """(kernel, cluster) the tuning table gives a LoRA delta launch. A
    tuned `kernel: False` is the JAX XLA-einsum route: the port takes it
    only where the plain version runs anyway (CPU tensors), so the knob
    loads as JAX tables carry it and puts no library product on the
    card's path. cluster is the plan's override (0 = the rule)."""
    cfg = _tuned("lora_matmul", lora_key(b, s, d, r, dtype))
    if not cfg:
        return True, 0
    c = cfg.get("cluster")
    return (cfg.get("kernel", True) is not False,
            c if _legal_lora_cluster(c, d, n) else 0)


def _int8_splits(m, d, n):
    """How many blocks split the d of an output tile. The skinny route (m
    <= 32): the cluster of `skinny_plan`, merged in the kernel. The tiled
    route: only where fewer than half of `_TILED_TARGET` tiles would run
    (n = 512 at a prompt bucket), up to that target and at least
    `_TILED_MIN_K` of d a split; its partials go to a work buffer that a
    second pass adds in k order."""
    if m > _SKINNY_M:
        tiles = -(-m // _TILE_M) * -(-n // _TILE_N)
        if 2 * tiles > _TILED_TARGET:
            return 1
        return max(1, min(-(-_TILED_TARGET // tiles), -(-d // _TILED_MIN_K)))
    return skinny_plan(m, d, n)[1]


def _int8_matmul_cuda(x, q, scale, split_k=None):
    """Launch `csrc/int8_matmul.cu` on a contiguous float32 x [m, d], a
    contiguous int8 q [d, n] and float32 scale [n]; returns float32
    [m, n]. The skinny route (m <= 32) is one launch that plans its own
    k-splits (`skinny_plan`) and merges them in the kernel: no work
    buffer; its override is the tuning table's unless `split_k` is
    given. The tiled route splits d by `_int8_splits` into a work buffer
    of splits x m x n, added by a second launch."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("int8_matmul: x must be a contiguous float32 "
                         f"[m, d] tensor, got {x.dtype} {tuple(x.shape)}")
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("int8_matmul: q must be a contiguous int8 [d, n] "
                         f"tensor, got {q.dtype} {tuple(q.shape)}")
    m, d = x.shape
    n = q.shape[1]
    if q.shape[0] != d:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)} do not chain")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,) \
            or not scale.is_contiguous():
        raise ValueError(f"int8_matmul: scale must be a contiguous float32 "
                         f"[{n}] tensor, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    skinny = m <= _SKINNY_M
    splits = 1 if skinny else _int8_splits(m, d, n)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _build.kernels().int8_matmul(
        x.device.index or 0, x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(), m, d, n,
        splits, (0 if not skinny else int8_split(m, d, n, x.dtype)
                 if split_k is None else split_k),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on("int8_matmul", err)
    LAUNCHES["int8_matmul"] += 1
    ROUTE_LAUNCHES["int8_matmul:skinny" if skinny
                   else "int8_matmul:tiled"] += 1
    return out


def skinny_plan_on_card(m, d, n, device, split_k=0):
    """`skinny_plan` as the built library's C rule gives it on `device`'s
    card (builds the kernels on first use)."""
    dev = torch.device(device)
    out = _build.ints_out(4)
    _build.kernels().int8_matmul_skinny_plan(dev.index or 0, int(m), int(d),
                                             int(n), int(split_k), out)
    return tuple(out)


def int8_matmul(x, q, scale, bias=None):
    """Scaled int8 matmul: ``x [..., d_in] @ q int8 [d_in, d_out] * scale
    [d_out] (+ bias)``, float32 accumulate, result in x's type (a bf16 x
    is cast to float32 for the product). CPU tensors run
    `int8_matmul_reference`; CUDA tensors launch `csrc/int8_matmul.cu`."""
    if _check_device("int8_matmul", x, q, scale) == "cpu":
        return int8_matmul_reference(x, q, scale, bias)
    d, n = q.shape
    lead = x.shape[:-1]
    acc = _int8_matmul_cuda(x.reshape(-1, d).float().contiguous(), q,
                            scale)
    out = acc.to(x.dtype).reshape(*lead, n)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def int8_gather(ids, q, scale, dtype):
    """Embedding lookup over an int8 table: the id rows times the
    per-output-channel scale, in `dtype` (no dequantized [V, D] copy)."""
    return (q[ids].float() * scale).to(dtype)


# --------------------------------------------------------------------------
# gathered LoRA matmul: plain version, kernel wrapper, dispatcher
# --------------------------------------------------------------------------

def lora_delta_reference(x, A, B, ids):
    """``(f32(x) @ A[ids]) @ B[ids]`` cast to x's type: x [b, s, d_in],
    A [cap, d_in, r], B [cap, r, d_out], ids [b] (host or device
    integers). The kernel's function in plain PyTorch, on any device."""
    ids = torch.as_tensor(ids, device=A.device).long()
    Ag = A[ids].float()                                  # [b, d_in, r]
    Bg = B[ids].float()                                  # [b, r, d_out]
    xa = torch.bmm(x.float(), Ag)
    return torch.bmm(xa, Bg).to(x.dtype)


def _host_ids(ids, cap, b):
    """The ids as a host int32 array of length b, each in [0, cap)."""
    if torch.is_tensor(ids):
        ids = ids.detach().cpu().numpy()   # a device tensor syncs here
    ids = np.asarray(ids).reshape(-1)
    if ids.shape[0] != b:
        raise ValueError(f"lora_delta: {ids.shape[0]} adapter ids for "
                         f"{b} batch rows")
    if ids.size and (ids.min() < 0 or ids.max() >= cap):
        raise ValueError(f"lora_delta: adapter ids {ids.tolist()} outside "
                         f"the banks' rows [0, {cap})")
    return ids.astype(np.int32)


def _device_ids(ids, cap, b, device):
    """Validated int32 ids on `device`. The ids a `lora_scope` holds are
    copied once per scope and device (through pinned memory, without a
    device sync); other ids are copied per call."""
    host = _host_ids(ids, cap, b)
    ctx = getattr(_LORA_STATE, "ctx", None)
    memo = None
    if ctx is not None and ctx[0] is ids:
        memo = _LORA_STATE.placed
        hit = memo.get(device)
        if hit is not None:
            return hit
    t = torch.from_numpy(host)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    if memo is not None:
        memo[device] = t
    return t


def _lora_gather_cuda(x, A, B, ids, cluster=None):
    """Launch `csrc/lora_gather.cu` on a contiguous float32 x [b, s, d],
    float32 banks A [cap, d, r] / B [cap, r, n] and int32 ids [b] on the
    card (validated by the caller); returns float32 [b, s, n]. The plan's
    override is the tuning table's unless `cluster` is given."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("lora_delta: x must be a contiguous float32 "
                         f"[b, s, d] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for name, t in (("A", A), ("B", B)):
        if t.dtype != torch.float32 or t.dim() != 3 \
                or not t.is_contiguous():
            raise ValueError(f"lora_delta: bank {name} must be a "
                             f"contiguous float32 3-D tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, s, d = x.shape
    cap, _, r = A.shape
    n = B.shape[2]
    if tuple(A.shape) != (cap, d, r) or tuple(B.shape) != (cap, r, n):
        raise ValueError(f"lora_delta: banks A {tuple(A.shape)} / B "
                         f"{tuple(B.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= r <= LORA_MAX_RANK:
        raise ValueError(f"lora_delta: rank {r} outside the kernel's "
                         f"1..{LORA_MAX_RANK}")
    if ids.dtype != torch.int32 or tuple(ids.shape) != (b,):
        raise ValueError(f"lora_delta: ids must be int32 [{b}]")
    out = torch.empty((b, s, n), dtype=torch.float32, device=x.device)
    if b * s * n == 0:
        return out
    err = _build.kernels().lora_gather(
        x.device.index or 0, x.data_ptr(), A.data_ptr(), B.data_ptr(),
        ids.data_ptr(), out.data_ptr(), b, s, d, r, n, cap,
        lora_overrides(b, s, d, r, n, x.dtype)[1] if cluster is None
        else cluster,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on("lora_gather", err)
    LAUNCHES["lora_gather"] += 1
    return out


def lora_plan(b, s, d, n=None, sms=_build.H100_SMS, cluster=0):
    """(rows of s a row tile, CTAs a cluster) of `csrc/lora_gather.cu`
    for x [b, s, d] and n output columns (default d) on a card of `sms`
    SMs: the C rule `lora_plan` written out. The row tile is the least
    power of two up to 16 covering s; the cluster the least power of two
    up to 8 whose grid covers every SM (while each CTA keeps more than 4
    of d). A legal `cluster` (the tuning table's) replaces the rule's; 0
    or an illegal value keeps the rule."""
    n = d if n is None else n
    rt = 1
    while rt < s and rt < _LORA_ROWS:
        rt *= 2
    tiles = b * -(-s // rt)
    c = 1
    while c < _LORA_CLUSTER and tiles * c < sms and 4 * c < d:
        c *= 2
    return rt, cluster if _legal_lora_cluster(cluster, d, n) else c


def lora_gather_plan(b, s, d, device, n=None, cluster=0):
    """(rows of s a row tile, CTAs a cluster) of `csrc/lora_gather.cu`
    for x [b, s, d] and n output columns (default d) on the card
    `device`, as the C entry point plans it (`pt_lora_gather_plan`;
    `lora_plan` writes it out), `cluster` its override (0 = the rule):
    the grid is b * ceil(s / rows) clusters."""
    out = _build.ints_out(2)
    err = _build.kernels().lora_gather_plan(
        torch.device(device).index or 0, int(b), int(s), int(d),
        int(d if n is None else n), int(cluster), out)
    _build.raise_on("lora_gather", err)
    return tuple(out)


def lora_delta(x, A, B, ids):
    """Gathered-LoRA delta ``(f32(x[i]) @ A[ids[i]]) @ B[ids[i]]`` per batch
    row i, in x's type: x [b, s, d_in]; ids [b] host integers (numpy, a
    list or a CPU tensor; a CUDA tensor costs a device sync for its
    check), each in [0, cap) or ValueError. CPU tensors run
    `lora_delta_reference`; CUDA tensors launch `csrc/lora_gather.cu`."""
    b = x.shape[0]
    if _check_device("lora_delta", x, A, B) == "cpu":
        # the plain version: the kernel's function and the JAX
        # `kernel: False` route alike (`lora_overrides`)
        return lora_delta_reference(x, A, B, _host_ids(ids, A.shape[0], b))
    dev_ids = _device_ids(ids, A.shape[0], b, x.device)
    out = _lora_gather_cuda(x.float().contiguous(), A, B, dev_ids)
    return out.to(x.dtype)


def merge_lora_weight(w, wA, wB):
    """``W + A @ B`` in float32, cast back to W's type, on W's device: the
    merged-weight equivalent of the factored delta (B pre-scaled by
    alpha / r, the `AdapterPool` convention)."""
    w = torch.as_tensor(w)
    a = torch.as_tensor(wA, dtype=torch.float32, device=w.device)
    b = torch.as_tensor(wB, dtype=torch.float32, device=w.device)
    return (w.float() + a @ b).to(w.dtype)


# --------------------------------------------------------------------------
# the adapter scope the serving bodies open
# --------------------------------------------------------------------------

_LORA_STATE = threading.local()


@contextlib.contextmanager
def lora_scope(ids, banks):
    """Make (per-row adapter ids, [(A, B), ...] banks) visible to the
    Linear layers inside this scope, on this thread. `ids` holds one bank
    row per batch row of every Linear input (host integers); `banks` is
    indexed by each target layer's `_lora_idx`. Re-entrant: the previous
    scope is restored on exit. Outside any scope `current_lora()` is
    None."""
    prev = (getattr(_LORA_STATE, "ctx", None),
            getattr(_LORA_STATE, "placed", None))
    _LORA_STATE.ctx = (ids, banks)
    _LORA_STATE.placed = {}
    try:
        yield
    finally:
        _LORA_STATE.ctx, _LORA_STATE.placed = prev


def current_lora():
    """The active (ids, banks) pair, or None outside any lora_scope."""
    return getattr(_LORA_STATE, "ctx", None)
