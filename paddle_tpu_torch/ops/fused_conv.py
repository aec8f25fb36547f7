"""The fused 1x1-conv + BatchNorm op (the JAX package's
`ops/fused_conv.py`): plain PyTorch versions and the wrappers of the
port's hand-written Hopper kernels.

  * forward -> `csrc/fused_conv_fwd.cu`: ``z = act(x * scale + shift) @
    W^T`` per image of an NCHW tensor with HW flattened, plus the
    per-channel ``sum z`` and ``sum z^2`` over (B, HW) of the float32 z,
    in one pass over x (the normalized activation never exists in device
    memory, and the stats never read z back);
  * backward -> `csrc/fused_conv_bwd.cu`: from (x, z, dz) and the stats
    cotangents (ds, dss) it forms ``dz_eff = dz + ds + 2 z dss`` and
    writes dx, dW, dscale and dshift, recomputing the normalized
    activation and dz_eff on chip.

With a bf16 x and a bf16 W the forward's product and the backward's dx
run on the tensor cores (wgmma), and with a bf16 x the backward's dW
does; every other product runs float32 FMAs on the CUDA cores
(`fwd_route`, `bwd_routes`).

The stats outputs are differentiable, so a BN chain (``bn_scale_shift``
folding one op's stats into the next op's scale and shift) trains end
to end. `fused_scale_act_mm_stats` runs the plain versions when its
tensors lie on the CPU and launches the kernels when they lie on a CUDA
card; there is no fallback from a failed launch. `LAUNCHES` counts
kernel launches per wrapper, `ROUTE_LAUNCHES` each product's launches by
its route.

Numerics follow the JAX kernels: the affine normalize and ReLU in
float32, the activation rounded to x's type before the product, the
products accumulated in float32 (a bf16 operand is widened exactly, and
mixed bf16 x / float32 W promote to float32 as `jax.lax.dot_general`
does), z stored in x's type, the stats from the unrounded float32 z, and
the backward's dz_eff from the STORED z.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["LAUNCHES", "ROUTE_LAUNCHES", "fwd_route", "bwd_routes",
           "reset_launches", "fused_fwd_reference", "fused_bwd_reference",
           "fused_scale_act_mm_stats", "fused_scale_act_mm_stats_plain",
           "bn_scale_shift"]

#: kernel launches per wrapper (`reset_launches` zeroes every kernel's)
LAUNCHES = _build.counter(["fused_conv_fwd", "fused_conv_bwd"])
#: each product's launches by its route ("wgmma" or "simt"), counted by
#: the C entry points' own rules (`pt_fused_conv_fwd_tensor_cores`,
#: `pt_fused_conv_bwd_tensor_cores`, asked through `fwd_route` /
#: `bwd_routes`): the forward's product, the backward's dx and its dW
ROUTE_LAUNCHES = _build.counter(
    [f"{k}:{r}" for k in ("fused_conv_fwd", "fused_conv_bwd_dx",
                          "fused_conv_bwd_dw") for r in ("wgmma", "simt")],
    branch=True)
reset_launches = _build.reset_launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' column tile (positions of the flattened (B, HW) axis a
#: block owns): the forward's stats and the backward's dscale / dshift
#: come as one partial per tile, added by a second pass in a fixed order
_TILE_N = 64


def _bcol(v):
    """A [C] per-channel vector as [C, 1], broadcasting over HW."""
    return v.float().reshape(-1, 1)


def _act_in(x, scale, shift, relu, rounded=True):
    """(xn, ReLU mask or None): the kernels' normalized activation. With a
    norm, ``f32(x) * scale + shift`` (then ReLU) rounded to x's type (left
    in float32 with rounded=False); without, ReLU in x's own type."""
    if scale is not None:
        pre = x.float() * _bcol(scale) + _bcol(shift)
        mask = pre > 0 if relu else None
        xn = torch.clamp_min(pre, 0.0) if relu else pre
        return (xn.to(x.dtype) if rounded else xn), mask
    if relu:
        return torch.relu(x), x > 0
    return x, None


def fused_fwd_reference(x, scale, shift, w, relu=True, *, rounded=True):
    """The forward kernel's function in plain PyTorch, on any device:
    x [B, Ci, HW], scale / shift [Ci] (None for the identity), w [Co, Ci]
    -> (z [B, Co, HW] in x's type, sum z [Co] float32, sum z^2 [Co]
    float32), the sums over (B, HW) of the float32 z. rounded=False
    leaves the product's operand xn in float32: the fault of a kernel
    that skips its rounding, for the checks that show a limit refuses
    it (`testing.fused_conv_mutants`)."""
    xn, _ = _act_in(x, scale, shift, relu, rounded)
    z = torch.matmul(w.float(), xn.float())
    return z.to(x.dtype), z.sum((0, 2)), (z * z).sum((0, 2))


def fused_bwd_reference(x, scale, shift, w, z, dz, ds, dss, relu=True, *,
                        rounded=True):
    """The backward kernel's function in plain PyTorch, on any device:
    (dx in x's type, dW [Co, Ci] float32, dscale [Ci] float32, dshift
    [Ci] float32) from the forward's inputs, its stored z and the
    cotangents of (z, sum z, sum z^2). dscale and dshift are zeros
    without a norm. rounded=False leaves the products' operands dz_eff
    and xn in float32 (as `fused_fwd_reference`'s)."""
    dt = x.dtype
    dz_eff = dz.float() + _bcol(ds) + 2.0 * z.float() * _bcol(dss)
    dzb = dz_eff.to(dt) if rounded else dz_eff
    xn, mask = _act_in(x, scale, shift, relu, rounded)
    dxn = torch.matmul(w.float().t(), dzb.float())
    dpre = torch.where(mask, dxn, 0.0) if relu else dxn
    B, Co, HW = z.shape
    Ci = x.shape[1]
    dw = torch.matmul(dzb.float().transpose(0, 1).reshape(Co, B * HW),
                      xn.float().transpose(0, 1).reshape(Ci, B * HW).t())
    if scale is None:
        zeros = torch.zeros(Ci, dtype=torch.float32, device=x.device)
        return dpre.to(dt), dw, zeros, zeros.clone()
    dx = (dpre * _bcol(scale)).to(dt)
    return dx, dw, (dpre * x.float()).sum((0, 2)), dpre.sum((0, 2))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(x, scale, shift, w):
    """The kernels' contract: x a contiguous float32 / bf16 [B, Ci, HW]
    on a CUDA card, w [Co, Ci], scale / shift [Ci] or both None, all on
    x's device."""
    if x.dtype not in _DTYPES or x.dim() != 3:
        raise ValueError("fused_scale_act_mm_stats: x must be a float32 or "
                         f"bfloat16 [B, Ci, HW] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"fused_scale_act_mm_stats: w {tuple(w.shape)} is "
                         f"not [Co, {x.shape[1]}]")
    if (scale is None) != (shift is None):
        raise ValueError("fused_scale_act_mm_stats: pass scale and shift "
                         "together (both None for the identity)")
    for t in (w, scale, shift):
        if t is not None and t.device != x.device:
            raise ValueError("fused_scale_act_mm_stats: operands on "
                             f"different devices ({t.device} vs "
                             f"{x.device})")
    if scale is not None and (scale.numel() != x.shape[1]
                              or shift.numel() != x.shape[1]):
        raise ValueError("fused_scale_act_mm_stats: scale / shift must "
                         f"have {x.shape[1]} entries")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_scale_act_mm_stats: no kernel for "
                         f"{x.device.type} tensors")


def _vec(v):
    return None if v is None else v.float().reshape(-1).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _tiles(x):
    B, _, HW = x.shape
    return -(-(B * HW) // _TILE_N)


def _type_codes(x_dtype, w_dtype):
    if x_dtype not in _DTYPES:
        raise TypeError(f"fused_conv: no kernel for an x of {x_dtype}")
    return _DTYPES[x_dtype], int(w_dtype == torch.bfloat16)


def _route(tc):
    return "wgmma" if tc else "simt"


def fwd_route(x_dtype, w_dtype):
    """The route of the forward kernel's product, as the C entry point's
    rule `pt_fused_conv_fwd_tensor_cores` gives it (so it builds the
    kernels on first use): "wgmma" (bf16 products, exact in float32, on
    the tensor cores) or "simt" (float32 FMAs on the CUDA cores)."""
    codes = _type_codes(x_dtype, w_dtype)
    return _route(_build.kernels().fused_conv_fwd_tensor_cores(*codes))


def bwd_routes(x_dtype, w_dtype):
    """(the route of the backward's dx product, that of its dW product),
    as the C entry point's rule `pt_fused_conv_bwd_tensor_cores` gives
    them."""
    dt, wbf = _type_codes(x_dtype, w_dtype)
    lib = _build.kernels()
    return tuple(_route(lib.fused_conv_bwd_tensor_cores(dt, wbf, product))
                 for product in (0, 1))


def _w_arg(w, tc):
    """W as the route takes it (bf16 on the tensor cores, else float32,
    which widens a bf16 W exactly) and its type code."""
    if tc:
        return w.contiguous(), 1
    return w.float().contiguous(), 0


def _fwd_cuda(x, scale, shift, w, relu=True):
    """Launch `csrc/fused_conv_fwd.cu`: (z, s, ss) as the reference."""
    _check(x, scale, shift, w)
    x = x.contiguous()
    B, Ci, HW = x.shape
    Co = w.shape[0]
    z = torch.empty((B, Co, HW), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, Co), dtype=torch.float32, device=x.device)
    P = _tiles(x)
    part = torch.empty((2, Co, max(P, 1)), dtype=torch.float32,
                       device=x.device)
    lib = _build.kernels()
    dt = _DTYPES[x.dtype]
    route = fwd_route(x.dtype, w.dtype)
    sc, sh = _vec(scale), _vec(shift)
    wk, wdt = _w_arg(w, route == "wgmma")
    err = lib.fused_conv_fwd(
        x.device.index or 0, dt, wdt, x.data_ptr(), _ptr(sc), _ptr(sh),
        wk.data_ptr(), z.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), part.data_ptr(), B, Ci, Co, HW, P,
        int(scale is not None), int(bool(relu)), _stream(x))
    _build.raise_on("fused_conv_fwd", err)
    LAUNCHES["fused_conv_fwd"] += 1
    ROUTE_LAUNCHES[f"fused_conv_fwd:{route}"] += 1
    return z, stats[0], stats[1]


def _bwd_cuda(x, scale, shift, w, z, dz, ds, dss, relu=True):
    """Launch `csrc/fused_conv_bwd.cu`: (dx, dW float32, dscale, dshift)
    as the reference."""
    _check(x, scale, shift, w)
    B, Ci, HW = x.shape
    Co = w.shape[0]
    for name, t in (("z", z), ("dz", dz)):
        if t.device != x.device or tuple(t.shape) != (B, Co, HW):
            raise ValueError(f"fused_conv backward: {name} must be "
                             f"[{B}, {Co}, {HW}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    x = x.contiguous()
    z = z.to(x.dtype).contiguous()
    dz = dz.to(x.dtype).contiguous()
    dsv, dssv = _vec(ds), _vec(dss)
    if dsv.numel() != Co or dssv.numel() != Co:
        raise ValueError(f"fused_conv backward: ds / dss must have {Co} "
                         "entries")
    lib = _build.kernels()
    dt = _DTYPES[x.dtype]
    dx = torch.empty_like(x)
    dw = torch.empty((Co, Ci), dtype=torch.float32, device=x.device)
    dvec = torch.empty((2, Ci), dtype=torch.float32, device=x.device)
    P = _tiles(x)
    part = torch.empty((2, Ci, max(P, 1)), dtype=torch.float32,
                       device=x.device)
    splits = lib.fused_conv_bwd_splits(dt, B, Ci, Co, HW)
    work = (torch.empty((splits, Co, Ci), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    r_dx, r_dw = bwd_routes(x.dtype, w.dtype)
    sc, sh = _vec(scale), _vec(shift)
    wk, wdt = _w_arg(w, r_dx == "wgmma")
    err = lib.fused_conv_bwd(
        x.device.index or 0, dt, wdt, x.data_ptr(), _ptr(sc), _ptr(sh),
        wk.data_ptr(), z.data_ptr(), dz.data_ptr(),
        dsv.data_ptr(), dssv.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        dvec[0].data_ptr(), dvec[1].data_ptr(), part.data_ptr(), _ptr(work),
        B, Ci, Co, HW, P, splits, int(scale is not None), int(bool(relu)),
        _stream(x))
    _build.raise_on("fused_conv_bwd", err)
    LAUNCHES["fused_conv_bwd"] += 1
    ROUTE_LAUNCHES[f"fused_conv_bwd_dx:{r_dx}"] += 1
    ROUTE_LAUNCHES[f"fused_conv_bwd_dw:{r_dw}"] += 1
    return dx, dw, dvec[0], dvec[1]


# --------------------------------------------------------------------------
# the differentiable op
# --------------------------------------------------------------------------

class _FusedConv(torch.autograd.Function):
    """`_diff_fn` of the JAX package: one forward pass producing (z, sum
    z, sum z^2), whose backward takes the cotangents of all three. `fwd`
    and `bwd` are the kernel wrappers or the plain versions."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, relu, fwd, bwd):
        z, s, ss = fwd(x, scale, shift, w, relu)
        ctx.save_for_backward(x, scale, shift, w, z)
        ctx.relu, ctx.bwd = relu, bwd
        return z, s, ss

    @staticmethod
    def backward(ctx, dz, ds, dss):
        x, scale, shift, w, z = ctx.saved_tensors
        dx, dw, dsc, dsh = ctx.bwd(x, scale, shift, w, z, dz, ds, dss,
                                   ctx.relu)
        if scale is None:
            dsc = dsh = None
        else:
            dsc, dsh = dsc.to(scale.dtype), dsh.to(shift.dtype)
        return dx, dsc, dsh, dw.to(w.dtype), None, None, None


def fused_scale_act_mm_stats(x, scale, shift, w, relu=True):
    """``z = act(x * scale[:, None] + shift[:, None]) @ w`` with the
    channel stats of z, in one pass over x.

    x: [B, Ci, HW] (NCHW with HW flattened), float32 or bfloat16; scale,
    shift: [Ci] float32 (the producing BN's folded batch-stat scale and
    shift; None for the identity); w: [Co, Ci]. Returns (z [B, Co, HW] in
    x's type, sum_z [Co] float32, sumsq_z [Co] float32). Differentiable in
    x, scale, shift and w, including through the stats outputs (BN-chain
    training). CPU tensors run the plain versions; CUDA tensors launch
    `csrc/fused_conv_fwd.cu` and, for the gradient,
    `csrc/fused_conv_bwd.cu`."""
    _check(x, scale, shift, w)
    if x.device.type == "cpu":
        return fused_scale_act_mm_stats_plain(x, scale, shift, w, relu)
    return _FusedConv.apply(x, scale, shift, w, bool(relu), _fwd_cuda,
                            _bwd_cuda)


def fused_scale_act_mm_stats_plain(x, scale, shift, w, relu=True):
    """`fused_scale_act_mm_stats` through the plain versions on any
    device: the kernels' function, forward and backward, in plain
    PyTorch (what the CPU runs, and what the card's kernels are checked
    against)."""
    return _FusedConv.apply(x, scale, shift, w, bool(relu),
                            fused_fwd_reference, fused_bwd_reference)


def bn_scale_shift(gamma, beta, s, ss, n, epsilon=1e-5):
    """Fold batch stats (the channel sum and sum of squares over n
    elements) and the affine parameters into the per-channel (scale,
    shift) the next fused op normalizes with; also returns (mean, var).
    Plain torch, differentiable into (gamma, beta) and back into the
    stats (hence the producing activation)."""
    mean = s / n
    var = torch.clamp_min(ss / n - mean * mean, 0.0)
    inv = 1.0 / torch.sqrt(var + epsilon)
    scale = gamma.float() * inv
    shift = beta.float() - mean * scale
    return scale, shift, mean, var
