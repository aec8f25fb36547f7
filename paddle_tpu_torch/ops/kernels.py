"""The op library (the JAX package's `ops/kernels.py`): convolution,
pooling, batch normalisation and the classification losses of the vision
models and `hapi.Model`, NCHW / OIHW; and the rest of its jnp kernels,
which `tensor/`, `nn.functional` and the layers call: activations,
softmax, layer / group / instance / RMS normalisation, one-hot, the
reductions, the losses, the shape, index and search ops, interpolation,
`segment_sum`, `clip_by_norm` and `spectral_normalize`. Where Paddle's
meaning and torch's differ under one name (`split`, `gather`, `scatter`,
the tie orders of `topk` / `argsort` / `sort`), these follow the JAX
function; the docstrings say how.

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

The channel axis is 1 (NCHW, NCL, NC) or the last one (NHWC, NLC,
NDHWC): `c_axis` of the batch-norm functions.

Pooling refuses `ceil_mode=True`: the JAX package takes it and applies
nothing (`ops/kernels.py:333`, :355 there), so a caller asking for it
would silently get floor-mode windows.

The 1x1-conv-as-dot route (`PT_CONV1X1_DOT` in the JAX package, off by
default there) is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

__all__ = ["conv2d", "conv2d_transpose", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "batch_norm_train",
           "batch_norm_infer", "softmax_with_cross_entropy",
           "cross_entropy_loss", "relu", "relu6", "sigmoid", "tanh", "gelu",
           "silu", "swish", "leaky_relu", "elu", "selu", "hardswish",
           "hardsigmoid", "hardtanh", "softplus", "softsign", "mish",
           "softmax", "log_softmax", "log_sigmoid", "maximum", "minimum",
           "scale", "clip", "matmul", "linear", "bmm", "dot", "layer_norm",
           "group_norm", "instance_norm", "rms_norm", "embedding", "one_hot",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "logsumexp", "bce_loss", "bce_with_logits",
           "mse_loss", "l1_loss", "smooth_l1", "nll_loss", "kl_div",
           "label_smooth", "reshape", "transpose", "concat", "split",
           "stack", "unstack", "squeeze", "unsqueeze", "flatten", "expand",
           "expand_as", "broadcast_to", "tile", "slice_op", "strided_slice",
           "gather", "gather_nd", "scatter", "scatter_nd_add",
           "index_select", "index_sample", "masked_select", "where", "pad",
           "roll", "flip", "cumsum", "cumprod", "diag", "meshgrid", "argmax",
           "argmin", "topk", "argsort", "sort", "unique", "nonzero",
           "searchsorted", "norm", "clip_by_norm", "t", "tril", "triu",
           "einsum", "multiplex", "interpolate_nearest",
           "interpolate_bilinear", "linear_nd", "cubic_nd", "segment_sum",
           "spectral_normalize"]

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


def conv2d_transpose(x, w, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1):
    """The transposed convolution of an NCHW x by a [in, out / groups, kh,
    kw] w (the JAX layout, which is torch's too), no bias: the gradient
    of `conv2d` with respect to its input, plus `output_padding` zero
    rows and columns at the end. Padding is an int, one int a spatial dim
    or [before, after] of each dim; string padding raises, as in the JAX
    package. torch's own padding is used where it is symmetric and the
    output padding is below the stride or the dilation; otherwise the
    unpadded result is cropped and extended explicitly."""
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv2d_transpose")
    stride, dilation = _pair(stride), _pair(dilation)
    opad = _pair(output_padding)
    pad = _conv_padding(padding)
    native = all(pad[i][0] == pad[i][1] and opad[i] < max(stride[i],
                                                          dilation[i])
                 for i in range(2))
    if native:
        return tF.conv_transpose2d(x, w, None, stride,
                                   (pad[0][0], pad[1][0]), opad, groups,
                                   dilation)
    out = tF.conv_transpose2d(x, w, None, stride, 0, 0, groups, dilation)
    # negative pads crop; the output padding's rows past the last input
    # see only zeros
    return tF.pad(out, (-pad[1][0], opad[1] - pad[1][1],
                        -pad[0][0], opad[0] - pad[0][1]))


def _no_ceil(ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True is not supported: the JAX package accepts it "
            "and applies nothing, so the port refuses it")


def _pool_pads(x, kernel_size, stride, padding):
    """(k, s, [(before, after), (before, after)]) of a 2-D pool."""
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    return k, s, _explicit(x, _conv_padding(padding), k, s, (1, 1))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """Max over windows; the padding is -inf (never the max of a window
    that holds a real element). `ceil_mode=True` raises."""
    _no_ceil(ceil_mode)
    k, s, pad = _pool_pads(x, kernel_size, stride, padding)
    if any(p for pair in pad for p in pair):
        x = tF.pad(x, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]),
                   value=float("-inf"))
    return tF.max_pool2d(x, k, s)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    """Mean over windows. With `exclusive` (the default) a window's padded
    cells are left out of its count (torch's `count_include_pad=False`,
    not torch's default); otherwise every window divides by kh * kw.
    "SAME" padding may put the odd cell after: torch cannot pad
    asymmetrically, so x is padded with zeros first and the count comes
    from the same pooling of a padded ones mask. `ceil_mode=True`
    raises."""
    _no_ceil(ceil_mode)
    k, s, pad = _pool_pads(x, kernel_size, stride, padding)
    if all(a == b and a <= k[i] // 2 for i, (a, b) in enumerate(pad)):
        return tF.avg_pool2d(x, k, s, (pad[0][0], pad[1][0]),
                             count_include_pad=not exclusive)
    flat = (pad[1][0], pad[1][1], pad[0][0], pad[0][1])
    out = tF.avg_pool2d(tF.pad(x, flat), k, s)
    if not exclusive:
        return out
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return out / tF.avg_pool2d(tF.pad(ones, flat), k, s)


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


def adaptive_max_pool2d(x, output_size):
    """Max over adaptive windows (the windows of `adaptive_avg_pool2d`;
    the JAX package computes only outputs that divide the input and
    raises on the others)."""
    return tF.adaptive_max_pool2d(x, _pair(output_size))


# --------------------------------------------------------------------------
# batch normalisation
# --------------------------------------------------------------------------

def _bshape(v, ndim, c_axis=1):
    """A per-channel vector shaped to broadcast over channel axis
    `c_axis`."""
    shape = [1] * ndim
    shape[c_axis] = -1
    return v.reshape(shape)


def _reduce_axes(x, c_axis=1):
    """Every axis but the channel axis."""
    return tuple(i for i in range(x.dim()) if i != c_axis % x.dim())


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


def _bn_norm_fwd_impl(x, gamma, beta, epsilon, moments=None, c_axis=1):
    """(y, (mean, var, inv)): the batch-stat normalize. Per-channel scale
    and shift in float32, cast to x's type, so the big tensor is read and
    written once in its own width. `moments`: the (mean, var) of x when
    the caller has them already."""
    acc = _acc(x)
    mean, var = moments or _bn_moments(x, _reduce_axes(x, c_axis), acc)[:2]
    inv = 1.0 / torch.sqrt(var + epsilon)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - mean * scale
    y = x * _bshape(scale.to(x.dtype), x.dim(), c_axis) + _bshape(
        shift.to(x.dtype), x.dim(), c_axis)
    return y, (mean, var, inv)


class _BNNorm(torch.autograd.Function):
    """The half-width normalize (`_make_bn_norm` of the JAX package): its
    analytic backward keeps the big tensors in dy's type; only the two
    per-channel reductions accumulate in float32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, epsilon, mean, var, c_axis):
        y, (_, _, inv) = _bn_norm_fwd_impl(x, gamma, beta, epsilon,
                                           (mean, var), c_axis)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.c_axis = c_axis
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, inv = ctx.saved_tensors
        nd, c = x.dim(), ctx.c_axis
        axes = _reduce_axes(x, c)
        acc = _acc(x)
        n = 1
        for i in axes:
            n *= x.shape[i]
        xhat = (x - _bshape(mean.to(x.dtype), nd, c)) * _bshape(
            inv.to(x.dtype), nd, c)
        sum_dy = torch.sum(dy.to(acc), dim=axes)
        sum_dy_xhat = torch.sum((dy * xhat).to(acc), dim=axes)
        coef = gamma.to(acc) * inv
        dx = _bshape(coef.to(dy.dtype), nd, c) * (
            dy - _bshape((sum_dy / n).to(dy.dtype), nd, c)
            - xhat * _bshape((sum_dy_xhat / n).to(dy.dtype), nd, c))
        return (dx.to(x.dtype), sum_dy_xhat.to(gamma.dtype),
                sum_dy.to(gamma.dtype), None, None, None, None)


def batch_norm_train(x, gamma, beta, running_mean, running_var, momentum,
                     epsilon, c_axis=1):
    """(y, new_mean, new_var, batch_mean, batch_var): normalize with the
    batch stats over every axis but `c_axis` and fold them into the
    running stats. The returned batch stats carry no gradient (they feed
    the buffers only); the moments are computed once and serve both."""
    if x.dtype in _HALF:
        with torch.no_grad():
            mean, var, _ = _bn_moments(x, _reduce_axes(x, c_axis), _acc(x))
        y = _BNNorm.apply(x, gamma, beta, float(epsilon), mean, var, c_axis)
    else:
        y, (mean, var, _) = _bn_norm_fwd_impl(x, gamma, beta, epsilon,
                                              c_axis=c_axis)
        mean, var = mean.detach(), var.detach()
    new_mean = momentum * running_mean + (1.0 - momentum) * mean
    new_var = momentum * running_var + (1.0 - momentum) * var
    return y, new_mean, new_var, mean, var


def batch_norm_infer(x, gamma, beta, running_mean, running_var, epsilon,
                     c_axis=1):
    """Normalize with the running stats: per-channel float32 scale and
    shift, applied in x's type (a bf16 feature map is never widened)."""
    acc = _acc(x)
    inv = 1.0 / torch.sqrt(running_var.to(acc) + epsilon)
    scale = gamma.to(acc) * inv
    shift = beta.to(acc) - running_mean.to(acc) * scale
    return x * _bshape(scale.to(x.dtype), x.dim(), c_axis) + _bshape(
        shift.to(x.dtype), x.dim(), c_axis)


# --------------------------------------------------------------------------
# classification losses
# --------------------------------------------------------------------------

def _hard_label(label, logits, axis):
    """A hard label without the class axis: [N, 1] becomes [N]."""
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        return label.squeeze(axis)
    return label


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """-log softmax(logits) at the label along `axis` (kept as a size-1
    axis), or -(label * log softmax).sum for soft labels. A hard label
    equal to a non-negative `ignore_index` gives 0 (the JAX package masks
    only then; a negative one is never masked)."""
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        return -(label * logp).sum(axis, keepdim=True)
    idx = _hard_label(label, logits, axis).unsqueeze(axis).long()
    if ignore_index is None or ignore_index < 0:
        return -torch.gather(logp, axis, idx)
    keep = idx != ignore_index
    nll = -torch.gather(logp, axis, torch.where(keep, idx, 0))
    return torch.where(keep, nll, 0.0)


def cross_entropy_loss(logits, label, soft_label=False, reduction="mean",
                       ignore_index=-100, weight=None, axis=-1,
                       use_softmax=True):
    """The JAX package's `cross_entropy_loss`: the per-sample loss (from
    log softmax, or from log(clip(p, 1e-12)) when `use_softmax` is
    False), weighted by `weight[label]` for hard labels, then reduced.
    "mean" divides a weighted sum by the sum of the weights drawn, an
    ignore-masked sum by the count kept, else takes the mean."""
    if use_softmax:
        loss = softmax_with_cross_entropy(logits, label, soft_label, axis,
                                          ignore_index)
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-12))
        if soft_label:
            loss = -(label * logp).sum(axis, keepdim=True)
        else:
            idx = _hard_label(label, logits, axis).unsqueeze(axis).long()
            loss = -torch.gather(logp, axis, idx)
    loss = loss.squeeze(axis)
    if weight is not None and not soft_label:
        w = weight[_hard_label(label, logits, axis).long()]
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(w.sum(), 1e-12)
    if reduction == "mean":
        if ignore_index is not None and ignore_index >= 0 and \
                not soft_label:
            cnt = (_hard_label(label, logits, axis) != ignore_index).sum()
            return loss.sum() / torch.clamp_min(cnt, 1)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# --------------------------------------------------------------------------
# the rest of the op library: activations, normalisation, losses, shape,
# index and search ops, interpolation (the JAX package's jnp kernels, one
# torch function each; none reaches a Pallas kernel there)
# --------------------------------------------------------------------------

def _norm_axis(axis):
    """None, an int, or a tuple of ints (an empty list means all axes)."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis) if len(axis) else None
    return int(axis)


def _dims(x, axis):
    """The `dim` argument of a torch reduction: every axis for None."""
    axis = _norm_axis(axis)
    return tuple(range(x.dim())) if axis is None else axis


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate=False):
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return x * torch.sigmoid(x)


swish = silu


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def softplus(x, beta=1.0, threshold=20.0):
    bx = beta * x
    return torch.where(bx > threshold, x, torch.log1p(torch.exp(bx)) / beta)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def mish(x):
    return x * torch.tanh(softplus(x))


def softmax(x, axis=-1):
    return torch.softmax(x, axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, axis)


def log_sigmoid(x):
    return tF.logsigmoid(x)


def maximum(x, y):
    return torch.maximum(x, y)


def minimum(x, y):
    return torch.minimum(x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def linear(x, w, b=None):
    out = torch.matmul(x, w)
    return out if b is None else out + b


def bmm(x, y):
    return torch.matmul(x, y)


def dot(x, y):
    return (x * y).sum(-1)


def layer_norm(x, gamma=None, beta=None, epsilon=1e-5, begin_norm_axis=-1):
    """Normalise over the axes from `begin_norm_axis` on (biased
    variance, epsilon inside the root), then scale and shift."""
    start = begin_norm_axis % x.dim()
    axes = tuple(range(start, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + epsilon)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def group_norm(x, num_groups, gamma=None, beta=None, epsilon=1e-5):
    """Normalise each of `num_groups` channel groups of an [N, C, ...]
    x over its channels and spatial positions."""
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(axes, keepdim=True)
    var = ((xg - mean) ** 2).mean(axes, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    if gamma is not None:
        y = y * _bshape(gamma, x.dim(), 1)
    if beta is not None:
        y = y + _bshape(beta, x.dim(), 1)
    return y


def instance_norm(x, gamma=None, beta=None, epsilon=1e-5):
    """Normalise each (sample, channel) of [N, C, ...] over its spatial
    positions."""
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = ((x - mean) ** 2).mean(axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + epsilon)
    if gamma is not None:
        y = y * _bshape(gamma, x.dim(), 1)
    if beta is not None:
        y = y + _bshape(beta, x.dim(), 1)
    return y


def rms_norm(x, gamma=None, epsilon=1e-6):
    """x / sqrt(mean(x^2) + eps) over the last axis, the mean square in
    at least float32."""
    ms = (x.to(_acc(x)) ** 2).mean(-1, keepdim=True)
    y = x * (1.0 / torch.sqrt(ms + epsilon)).to(x.dtype)
    return y if gamma is None else y * gamma


def embedding(ids, table, padding_idx=None):
    out = table[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def one_hot(ids, num_classes, dtype=None):
    """float32 one-hot rows; an id outside [0, num_classes) gives a zero
    row (the JAX function's rule; torch's one_hot raises there)."""
    cls = torch.arange(num_classes, device=ids.device)
    return (ids[..., None].long() == cls).to(dtype or torch.float32)


def reduce_sum(x, axis=None, keepdim=False):
    return x.sum(_dims(x, axis), keepdim=keepdim)


def reduce_mean(x, axis=None, keepdim=False):
    return x.mean(_dims(x, axis), keepdim=keepdim)


def reduce_max(x, axis=None, keepdim=False):
    return torch.amax(x, _dims(x, axis), keepdim=keepdim)


def reduce_min(x, axis=None, keepdim=False):
    return torch.amin(x, _dims(x, axis), keepdim=keepdim)


def reduce_prod(x, axis=None, keepdim=False):
    axis = _norm_axis(axis)
    if axis is None:
        out = x.prod()
        return out.reshape((1,) * x.dim()) if keepdim else out
    for a in sorted((axis,) if isinstance(axis, int) else axis,
                    key=lambda a: a % x.dim(), reverse=True):
        x = x.prod(a, keepdim=keepdim)
    return x


def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, _dims(x, axis), keepdim=keepdim)


def bce_loss(x, label):
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    return -(label * torch.log(x) + (1.0 - label) * torch.log(1.0 - x))


def bce_with_logits(logits, label, pos_weight=None):
    logp, lognp = tF.logsigmoid(logits), tF.logsigmoid(-logits)
    if pos_weight is not None:
        return -(pos_weight * label * logp + (1.0 - label) * lognp)
    return -(label * logp + (1.0 - label) * lognp)


def mse_loss(x, y):
    return (x - y) ** 2


def l1_loss(x, y):
    return torch.abs(x - y)


def smooth_l1(x, y, delta=1.0):
    d = torch.abs(x - y)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


def nll_loss(logp, label, weight=None, ignore_index=-100):
    """-logp[n, label[n]] of [N, C] log-probabilities (times
    weight[label]); `ignore_index` is taken and not applied, as in the
    JAX package."""
    idx = label.long()
    nll = -torch.gather(logp, 1, idx[:, None])[:, 0]
    return nll if weight is None else nll * weight[idx]


def kl_div(logp, target):
    return target * (torch.log(torch.clamp_min(target, 1e-12)) - logp)


def label_smooth(label, epsilon=0.1, prior=None):
    if prior is None:
        return (1.0 - epsilon) * label + epsilon / label.shape[-1]
    return (1.0 - epsilon) * label + epsilon * prior


def reshape(x, shape):
    return x.reshape([int(s) for s in shape])


def transpose(x, perm):
    return x.permute([int(p) for p in perm])


def concat(xs, axis=0):
    return torch.cat(list(xs), int(axis))


def split(x, num_or_sections, axis=0):
    """Paddle's split: an int is a number of equal parts (it must divide
    the axis), a list is the parts' sizes (one of them may be -1: the
    rest)."""
    axis = int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"axis of size {total} does not split into "
                             f"{num_or_sections} equal parts")
        return list(torch.split(x, total // num_or_sections, axis))
    sections = [int(s) if s not in (-1, None) else -1
                for s in num_or_sections]
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, axis))


def stack(xs, axis=0):
    return torch.stack(list(xs), int(axis))


def unstack(x, axis=0):
    return list(torch.unbind(x, int(axis)))


def squeeze(x, axis=None):
    """Drop size-1 axes: all of them, or those of `axis` that have size 1
    (others stay, as in Paddle)."""
    if axis is None:
        return x.squeeze()
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(a % x.dim() for a in axes if x.shape[a] == 1)
    return x.squeeze(axes) if axes else x


def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(int(a) for a in axis):
            x = x.unsqueeze(a)
        return x
    return x.unsqueeze(int(axis))


def flatten(x, start_axis=0, stop_axis=-1):
    n = x.dim()
    if n == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % n, stop_axis % n)


def expand(x, shape):
    """Broadcast to `shape`; -1 keeps x's size on that axis."""
    shape = list(shape)
    xshape = [1] * (len(shape) - x.dim()) + list(x.shape)
    tgt = [xs if s in (-1, None) else int(s) for s, xs in zip(shape, xshape)]
    return x.reshape(xshape).expand(tgt)


def expand_as(x, y):
    return x.expand(y.shape)


def broadcast_to(x, shape):
    return x.expand([int(s) for s in shape])


def tile(x, repeat_times):
    return x.tile(tuple(int(r) for r in repeat_times))


def slice_op(x, axes, starts, ends):
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(int(st), int(en))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """Strided slices; a negative stride walks the axis backwards (torch
    indexing takes only positive steps, so it goes through a flip)."""
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        dim = x.shape[ax]
        rng = range(dim)[slice(int(st), int(en), int(sd))]
        x = x.index_select(ax, torch.tensor(list(rng), dtype=torch.long,
                                            device=x.device))
    return x


def gather(x, index, axis=0):
    """Rows of x along `axis` at `index` (Paddle's gather is an
    index_select)."""
    return x.index_select(int(axis), index.reshape(-1).long()).reshape(
        x.shape[:int(axis) % x.dim()] + tuple(index.shape)
        + x.shape[int(axis) % x.dim() + 1:])


def gather_nd(x, index):
    idx = index.long()
    return x[tuple(idx[..., i] for i in range(idx.shape[-1]))]


def scatter(x, index, updates, overwrite=True):
    """x with the rows at `index` set to `updates` (overwrite) or, as the
    JAX function computes it, with `updates` ADDED onto x's rows
    (overwrite=False; Paddle's own scatter zeroes those rows first). With
    duplicate indices and overwrite=True the result depends on the order
    of the writes, in both packages."""
    return x.index_put((index.reshape(-1).long(),), updates,
                       accumulate=not overwrite)


def scatter_nd_add(x, index, updates):
    idx = index.long()
    return x.index_put(tuple(idx[..., i] for i in range(idx.shape[-1])),
                       updates, accumulate=True)


def index_select(x, index, axis=0):
    return x.index_select(int(axis), index.long())


def index_sample(x, index):
    return torch.gather(x, 1, index.long())


def masked_select(x, mask):
    return x[mask.bool()]


def where(cond, x, y):
    return torch.where(cond.bool(), x, y)


def _pad_pairs(x, paddings):
    """(before, after) for every axis: 2 * ndim values pair up axis by
    axis; fewer pad the trailing axes (Paddle's NCHW convention)."""
    if len(paddings) == 2 * x.dim():
        return [(int(paddings[2 * i]), int(paddings[2 * i + 1]))
                for i in range(x.dim())]
    k = len(paddings) // 2
    return [(0, 0)] * (x.dim() - k) + [
        (int(paddings[2 * i]), int(paddings[2 * i + 1])) for i in range(k)]


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    period = 2 * (n - 1)                      # reflect, edge not repeated
    i = i.abs() % period if period else i * 0
    return torch.where(i >= n, period - i, i)


def pad(x, paddings, mode="constant", value=0.0):
    """numpy-style padding of any axes: "constant" (with `value`),
    "reflect", "replicate" (edge) or "circular" (wrap)."""
    pairs = _pad_pairs(x, paddings)
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return tF.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad mode {mode!r}")
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def flip(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, [int(a) for a in axes])


def cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


def cumprod(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, int(dim))


def diag(x, offset=0, padding_value=0.0):
    if x.dim() == 1 and padding_value != 0.0:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        return torch.where(mask, torch.diag(x, offset), base)
    return torch.diag(x, offset)


def meshgrid(*xs):
    return list(torch.meshgrid(*xs, indexing="ij"))


def argmax(x, axis=None, keepdim=False, dtype=torch.int64):
    """The first maximal index (ties break to the lower index, as
    jnp.argmax does)."""
    if axis is None:
        return torch.argmax(x).to(dtype)
    return torch.argmax(x, int(axis), keepdim=keepdim).to(dtype)


def argmin(x, axis=None, keepdim=False, dtype=torch.int64):
    if axis is None:
        return torch.argmin(x).to(dtype)
    return torch.argmin(x, int(axis), keepdim=keepdim).to(dtype)


def topk(x, k, axis=-1, largest=True, sorted=True):
    """(values, int64 indices) of the k largest (smallest) along `axis`,
    in order; equal values come lower index first (`lax.top_k`'s order),
    which a stable sort gives."""
    v, i = torch.sort(x, dim=axis, descending=largest, stable=True)
    return v.narrow(axis, 0, k), i.narrow(axis, 0, k)


def argsort(x, axis=-1, descending=False):
    """Stable: equal values keep their order (jnp.argsort's)."""
    return torch.sort(x, dim=axis, descending=descending, stable=True)[1]


def sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def unique(x, return_index=False, return_inverse=False, return_counts=False):
    """The sorted distinct values of the flattened x (jnp.unique), and on
    request the index of each one's first occurrence, the inverse map
    and the counts, all int64."""
    flat = x.reshape(-1)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    out = [vals]
    if return_index:
        pos = torch.arange(flat.numel(), device=x.device)
        first = torch.full((vals.numel(),), flat.numel(), dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def nonzero(x):
    return torch.nonzero(x)


def searchsorted(sorted_seq, values, right=False):
    return torch.searchsorted(sorted_seq, values, right=right)


def norm(x, p=2, axis=None, keepdim=False):
    """The JAX function's p-norms. Note its whole-tensor 2-norm (axis
    None) sums the squares in float32 and casts back, even for a float64
    x; the port computes the same."""
    if p == 2 and axis is None:
        return torch.sqrt((x.float() ** 2).sum()).to(x.dtype)
    axis = _norm_axis(axis)
    dims = tuple(range(x.dim())) if axis is None else axis
    if p == "fro" or p == 2:
        return torch.sqrt((x ** 2).sum(dims, keepdim=keepdim))
    if p == 1:
        return torch.abs(x).sum(dims, keepdim=keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dims, keepdim=keepdim)
    return (torch.abs(x) ** p).sum(dims, keepdim=keepdim) ** (1.0 / p)


def clip_by_norm(x, max_norm):
    n = torch.sqrt((x ** 2).sum())
    return torch.where(n > max_norm, x * (max_norm / torch.clamp_min(
        n, 1e-12)), x)


def t(x):
    return x if x.dim() < 2 else x.transpose(-1, -2)


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def einsum(eq, *xs):
    return torch.einsum(eq, *xs)


def multiplex(inputs, index):
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def _coords(o, d, align_corners, align_mode, device):
    """Source coordinates (float64) of `o` output cells over an axis of
    `d`: align_corners spreads them over [0, d - 1] (for o > 1);
    align_mode 1 is the legacy dst * d / o; otherwise half-pixel, (dst +
    0.5) * d / o - 0.5 (Paddle's meaning of align_mode, not torch's)."""
    i = torch.arange(o, dtype=torch.float64, device=device)
    if align_corners and o > 1:
        return torch.linspace(0.0, d - 1.0, o, dtype=torch.float64,
                              device=device)
    if align_mode == 1:
        return i * (d / o)
    return (i + 0.5) * (d / o) - 0.5


def interpolate_nearest(x, out_hw):
    """Nearest cell of an NCHW x: source index floor(dst * in / out)."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    dev = x.device
    ih = (torch.arange(oh, dtype=torch.float64, device=dev) * (h / oh)).long()
    iw = (torch.arange(ow, dtype=torch.float64, device=dev) * (w / ow)).long()
    return x[:, :, ih][:, :, :, iw]


def interpolate_bilinear(x, out_hw, align_corners=False, align_mode=0):
    """Bilinear resize of an NCHW x (both axes' corners as a pair: the
    JAX function's align_corners needs oh > 1 and ow > 1)."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    both = align_corners and oh > 1 and ow > 1
    ys = _coords(oh, h, both, align_mode, x.device)
    xs = _coords(ow, w, both, align_mode, x.device)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y1, x1 = torch.clamp(y0 + 1, 0, h - 1), torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0).to(x.dtype)[:, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0).to(x.dtype)
    top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
    bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
    return top * (1 - wy) + bot * wy


def linear_nd(x, out_sizes, align_corners, align_mode=0):
    """Separable linear resize over the trailing len(out_sizes) axes of
    an (N, C, *spatial) x (linear and trilinear interpolation)."""
    spatial = len(out_sizes)
    for i, o in enumerate(out_sizes):
        ax = x.dim() - spatial + i
        d = x.shape[ax]
        coords = _coords(o, d, align_corners, align_mode, x.device)
        lo = torch.clamp(torch.floor(coords), 0, d - 1).long()
        hi = torch.clamp(lo + 1, 0, d - 1)
        shape = [1] * x.dim()
        shape[ax] = o
        wgt = torch.clamp(coords - lo, 0.0, 1.0).to(x.dtype).reshape(shape)
        x = x.index_select(ax, lo) * (1 - wgt) + x.index_select(ax, hi) * wgt
    return x


def cubic_nd(x, out_sizes, align_corners):
    """Separable Keys bicubic (a = -0.75, Paddle's and OpenCV's kernel)
    over the trailing axes; taps past the edge repeat the edge."""
    spatial = len(out_sizes)
    a = -0.75

    def keys(t):
        t = torch.abs(t)
        return torch.where(
            t <= 1.0, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
            torch.where(t < 2.0,
                        a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                        torch.zeros_like(t)))

    for i, o in enumerate(out_sizes):
        ax = x.dim() - spatial + i
        d = x.shape[ax]
        coords = _coords(o, d, align_corners, 0, x.device)
        base = torch.floor(coords).long()
        frac = coords - base
        shape = [1] * x.dim()
        shape[ax] = o
        acc = None
        for tap in (-1, 0, 1, 2):
            ix = torch.clamp(base + tap, 0, d - 1)
            term = x.index_select(ax, ix) * keys(frac - tap).to(
                x.dtype).reshape(shape)
            acc = term if acc is None else acc + term
        x = acc
    return x


def segment_sum(data, segment_ids, num_segments):
    out = torch.zeros((int(num_segments),) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def spectral_normalize(w, u, v, dim=0, power_iters=1, eps=1e-12):
    """(w / sigma, u, v): sigma, the largest singular value of w as a
    [w.shape[dim], rest] matrix, estimated by `power_iters` rounds of
    power iteration from (u, v). The returned u and v carry no gradient;
    the caller writes them back so the estimate converges across calls."""
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    u, v = u.reshape(-1), v.reshape(-1)

    def _unit(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    for _ in range(max(power_iters, 0)):
        v = _unit(wm.T @ u)
        u = _unit(wm @ v)
    sigma = u @ wm @ v
    return w / sigma, u.detach(), v.detach()
