"""Convolution, pooling and batch normalisation (the JAX package's
`ops/kernels.py`, the parts the vision models run), NCHW / OIHW.

None of these reaches a Pallas kernel in the JAX package: its
convolutions go to XLA, and here they go to `torch.nn.functional.conv2d`
(cuDNN on the card). Batch normalisation keeps the JAX package's
semantics, which are not `torch.nn.BatchNorm2d`'s:

  * running stats update as ``new = momentum * running + (1 - momentum) *
    batch`` with the BIASED batch variance (momentum 0.9 by default);
  * the batch moments are accumulated in float32, two-pass for float32
    inputs and the one-pass ``E[x^2] - E[x]^2`` for half-width inputs;
  * under bf16 the normalize and its analytic backward run in x's own
    type with only the two per-channel reductions in float32
    (`_BNNorm`); float32 is plain torch autograd, differentiable at
    every order.

The 1x1-conv-as-dot route (`PT_CONV1X1_DOT` in the JAX package, off by
default there) is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

__all__ = ["conv2d", "max_pool2d", "adaptive_avg_pool2d",
           "batch_norm_train", "batch_norm_infer"]

_HALF = (torch.bfloat16, torch.float16)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v), int(v))


def _conv_padding(padding, size=2):
    """The reference's padding forms: "SAME" / "VALID", an int, one int a
    spatial dim, or [before, after] of each dim flattened -> a string or
    a list of (before, after) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * size
    padding = list(padding)
    if len(padding) == size:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * size:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(size)]
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(x, k, stride, dilation):
    """The explicit (before, after) pairs of "SAME": out = ceil(in /
    stride), the odd pixel after."""
    pads = []
    for i in range(2):
        size = x.shape[2 + i]
        eff = (k[i] - 1) * dilation[i] + 1
        total = max(0, (-(-size // stride[i]) - 1) * stride[i] + eff - size)
        pads.append((total // 2, total - total // 2))
    return pads


def _explicit(x, pad, k, stride, dilation):
    if pad == "VALID":
        return [(0, 0), (0, 0)]
    if pad == "SAME":
        return _same_pads(x, k, stride, dilation)
    return pad


def conv2d(x, w, stride=1, padding=0, dilation=1, groups=1):
    """NCHW x [B, C, H, W] by OIHW w [O, C / groups, KH, KW], no bias:
    `torch.nn.functional.conv2d` (symmetric padding goes to it as is, an
    asymmetric one is padded with zeros first)."""
    stride, dilation = _pair(stride), _pair(dilation)
    pad = _explicit(x, _conv_padding(padding), w.shape[2:], stride,
                    dilation)
    if pad[0][0] == pad[0][1] and pad[1][0] == pad[1][1]:
        return tF.conv2d(x, w, None, stride, (pad[0][0], pad[1][0]),
                         dilation, groups)
    x = tF.pad(x, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
    return tF.conv2d(x, w, None, stride, 0, dilation, groups)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Max over windows; the padding is -inf (never the max of a window
    that holds a real element). The JAX package's `ceil_mode` is not
    ported: it accepts it and applies nothing."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pad = _explicit(x, _conv_padding(padding), k, s, (1, 1))
    if any(p for pair in pad for p in pair):
        x = tF.pad(x, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]),
                   value=float("-inf"))
    return tF.max_pool2d(x, k, s)


def adaptive_avg_pool2d(x, output_size):
    """Mean over adaptive windows: a reshape where the output divides the
    input, else the window of output cell i spanning [floor(i * h / oh),
    ceil((i + 1) * h / oh)) (the reference's rule)."""
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    hs = [(math.floor(i * h / oh), math.ceil((i + 1) * h / oh))
          for i in range(oh)]
    ws = [(math.floor(j * w / ow), math.ceil((j + 1) * w / ow))
          for j in range(ow)]
    rows = [torch.stack([x[:, :, h0:h1, w0:w1].mean(dim=(2, 3))
                         for (w0, w1) in ws], dim=-1) for (h0, h1) in hs]
    return torch.stack(rows, dim=-2)


# --------------------------------------------------------------------------
# batch normalisation
# --------------------------------------------------------------------------

def _bshape(v, ndim):
    """A per-channel vector shaped to broadcast over channel axis 1."""
    shape = [1] * ndim
    shape[1] = -1
    return v.reshape(shape)


def _reduce_axes(x):
    """Every axis but the channel axis 1."""
    return (0,) + tuple(range(2, x.dim()))


def _acc(x):
    """The accumulation type: float32, or float64 for a float64 x."""
    return torch.promote_types(x.dtype, torch.float32)


def _bn_moments(x, axes, acc):
    """Per-channel (mean, biased var, n) in `acc`. Half-width inputs take
    the one-pass E[x^2] - E[x]^2 (clamped at 0); full-width ones the
    two-pass (x - mean)^2, which does not cancel."""
    n = 1
    for i in axes:
        n *= x.shape[i]
    xf = x.to(acc)
    mean = torch.sum(xf, dim=axes, keepdim=True) / n
    if x.dtype in _HALF:
        var = torch.clamp_min(torch.sum(xf * xf, dim=axes, keepdim=True) / n
                              - mean * mean, 0.0)
    else:
        d = xf - mean
        var = torch.sum(d * d, dim=axes, keepdim=True) / n
    return mean.reshape(-1), var.reshape(-1), n


def _bn_norm_fwd_impl(x, gamma, beta, epsilon, moments=None):
    """(y, (mean, var, inv)): the batch-stat normalize. Per-channel scale
    and shift in float32, cast to x's type, so the big tensor is read and
    written once in its own width. `moments`: the (mean, var) of x when
    the caller has them already."""
    acc = _acc(x)
    mean, var = moments or _bn_moments(x, _reduce_axes(x), acc)[:2]
    inv = 1.0 / torch.sqrt(var + epsilon)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean * scale
    y = x * _bshape(scale.to(x.dtype), x.dim()) + _bshape(
        shift.to(x.dtype), x.dim())
    return y, (mean, var, inv)


class _BNNorm(torch.autograd.Function):
    """The half-width normalize (`_make_bn_norm` of the JAX package): its
    analytic backward keeps the big tensors in dy's type; only the two
    per-channel reductions accumulate in float32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, epsilon, mean, var):
        y, (_, _, inv) = _bn_norm_fwd_impl(x, gamma, beta, epsilon,
                                           (mean, var))
        ctx.save_for_backward(x, gamma, mean, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, inv = ctx.saved_tensors
        nd, axes = x.dim(), _reduce_axes(x)
        acc = _acc(x)
        n = 1
        for i in axes:
            n *= x.shape[i]
        xhat = (x - _bshape(mean.to(x.dtype), nd)) * _bshape(
            inv.to(x.dtype), nd)
        sum_dy = torch.sum(dy.to(acc), dim=axes)
        sum_dy_xhat = torch.sum((dy * xhat).to(acc), dim=axes)
        coef = gamma.to(acc) * inv
        dx = _bshape(coef.to(dy.dtype), nd) * (
            dy - _bshape((sum_dy / n).to(dy.dtype), nd)
            - xhat * _bshape((sum_dy_xhat / n).to(dy.dtype), nd))
        return (dx.to(x.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(gamma.dtype), None, None, None)


def batch_norm_train(x, gamma, beta, running_mean, running_var, momentum,
                     epsilon):
    """(y, new_mean, new_var, batch_mean, batch_var): normalize with the
    batch stats and fold them into the running stats. The returned batch
    stats carry no gradient (they feed the buffers only); the moments are
    computed once and serve both."""
    if x.dtype in _HALF:
        with torch.no_grad():
            mean, var, _ = _bn_moments(x, _reduce_axes(x), _acc(x))
        y = _BNNorm.apply(x, gamma, beta, float(epsilon), mean, var)
    else:
        y, (mean, var, _) = _bn_norm_fwd_impl(x, gamma, beta, epsilon)
        mean, var = mean.detach(), var.detach()
    new_mean = momentum * running_mean + (1.0 - momentum) * mean
    new_var = momentum * running_var + (1.0 - momentum) * var
    return y, new_mean, new_var, mean, var


def batch_norm_infer(x, gamma, beta, running_mean, running_var, epsilon):
    """Normalize with the running stats: per-channel float32 scale and
    shift, applied in x's type (a bf16 feature map is never widened)."""
    acc = _acc(x)
    inv = 1.0 / torch.sqrt(running_var.to(acc) + epsilon)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - running_mean.to(acc) * scale
    return x * _bshape(scale.to(x.dtype), x.dim()) + _bshape(
        shift.to(x.dtype), x.dim())
