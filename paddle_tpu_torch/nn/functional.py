"""Paddle's `nn.functional` (the JAX package's `nn/functional`):
activations, dropout, attention, the int8 and LoRA matmuls of
multi-tenant serving, convolution, pooling and normalisation, the
losses, interpolation and the vision helpers.

Randomness (dropout, alpha dropout, Gumbel noise) comes from
`generator`, a torch.Generator on the input's device (None: that
device's default generator). `embedding(sparse=True)` gives a leaf
weight a row-sparse gradient (`sparse.SelectedRows` wraps it), which the
optimizers' sparse rules apply. `ctc_loss` runs the alpha recursion of
`ops/sequence_losses.py` over a float32 log-softmax, as the JAX package
does.
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from ..ops import attention as A
from ..ops import kernels as K
from ..ops import quant as Q
from ..ops import sequence_losses as SL

__all__ = ["relu", "relu6", "relu_", "gelu", "tanh", "sigmoid", "silu",
           "swish", "leaky_relu", "elu", "selu", "prelu", "hardswish",
           "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
           "tanhshrink", "softplus", "softsign", "mish", "maxout",
           "softmax", "log_softmax", "log_sigmoid", "gumbel_softmax",
           "flatten", "dropout", "dropout2d", "alpha_dropout", "draw_seed",
           "scaled_dot_product_attention", "linear", "linear_int8",
           "embedding", "embedding_int8", "one_hot", "lora_delta", "conv1d",
           "conv2d", "conv2d_transpose", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "max_pool1d",
           "avg_pool1d", "batch_norm", "layer_norm", "group_norm",
           "instance_norm", "normalize", "local_response_norm",
           "cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_similarity", "square_error_cost", "log_loss",
           "sigmoid_focal_loss", "label_smooth", "interpolate", "upsample",
           "pixel_shuffle", "unfold", "grid_sample", "affine_grid", "pad",
           "temporal_shift", "npair_loss", "ctc_loss"]


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def relu_(x):
    """ReLU in place; returns x."""
    return x.relu_()


def gelu(x, approximate=False):
    """GELU: the exact erf form, or the tanh form with `approximate`."""
    return K.gelu(x, approximate)


def tanh(x):
    return torch.tanh(x)


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def dropout(x, p=0.5, training=True, generator=None, *, axis=None,
            mode="upscale_in_train"):
    """Dropout: keeps each element with probability 1 - p. The default
    "upscale_in_train" divides the kept ones by 1 - p and is the identity
    outside training; "downscale_in_infer" keeps them as they are and
    multiplies by 1 - p outside training. `axis` (an int or a list)
    draws one mask entry per index of those axes, shared along the
    others. The mask is drawn from `generator` (a torch.Generator on x's
    device; None: that device's default generator)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p must be in [0, 1), got {p}")
    keep = 1.0 - p
    shape = x.shape
    if axis is not None:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])]
        shape = [x.shape[i] if i in axes else 1 for i in range(x.dim())]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    scale = 1.0 / keep if mode == "upscale_in_train" else 1.0
    return torch.where(mask, x * scale, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Drops whole channels of an NCHW x."""
    return dropout(x, p, training, generator, axis=[0, 1])


def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map restores the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return (a * torch.where(mask, x, alpha_p) + b).to(x.dtype)


def draw_seed(generator=None):
    """An attention-dropout seed (a host int32) drawn from a CPU
    torch.Generator (None: torch's default CPU generator). A CPU draw
    never waits for a device, and a seed is the same on every device."""
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=generator))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, dropout_seed=None,
                                 segment_ids=None, dropout_address=None):
    """Attention over [batch, heads, seq, dim] operands: the flash kernels
    on CUDA whenever the mask reduces to a per-key bias, their plain
    versions on the CPU (ops.attention.sdpa, which refuses a per-query
    mask on the card). In training with dropout_p > 0 the attention
    probabilities are dropped in-kernel, addressed by `dropout_seed`
    (drawn with `draw_seed()` when None). segment_ids ([batch, seq]
    integer, non-decreasing along each row: the packed rows of
    `core.lod.pack_padded`) restrict attention to same-segment tokens
    through the kernels' segment branch (the LoD-packed varlen path).
    dropout_address (b0, h0, heads): the operands are a shard of a larger
    call and draw its dropout bits (`ops.attention.DropSpec`)."""
    p = float(dropout_p or 0.0) if training else 0.0
    if p and dropout_seed is None:
        dropout_seed = draw_seed()
    return A.sdpa(query, key, value, attn_mask, is_causal, dropout_p=p,
                  dropout_seed=dropout_seed, segment_ids=segment_ids,
                  dropout_address=dropout_address)


def linear_int8(x, weight_q, scale, bias=None):
    """Scaled int8 matmul: `weight_q` int8 [in, out] with per-output-
    channel float32 `scale`, float32 accumulate, result in x's dtype
    (`ops.quant.int8_matmul`), plus `bias`."""
    return Q.int8_matmul(x, weight_q, scale, bias)


def embedding_int8(x, weight_q, scale, dtype):
    """Embedding lookup over an int8 table with per-output-channel scales:
    gather and scale, no dequantized copy (`ops.quant.int8_gather`)."""
    return Q.int8_gather(x, weight_q, scale, dtype)


def lora_delta(x, A, B, ids):
    """Per-row low-rank adapter delta `(x @ A[ids]) @ B[ids]` over stacked
    banks (`ops.quant.lora_delta`; id 0 is the base model, a zero
    delta)."""
    return Q.lora_delta(x, A, B, ids)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """2-D convolution of an NCHW x by an OIHW weight
    (`ops.kernels.conv2d`), plus a per-channel bias."""
    out = K.conv2d(x, weight, stride, padding, dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """Transposed convolution of an NCHW x by a [in, out / groups, kh, kw]
    weight (`ops.kernels.conv2d_transpose`), plus a per-channel bias."""
    out = K.conv2d_transpose(x, weight, stride, padding, output_padding,
                             dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """`ceil_mode=True` raises (the JAX package ignores it)."""
    return K.max_pool2d(x, kernel_size, stride, padding, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    """`exclusive`: padded cells are left out of a window's count."""
    return K.avg_pool2d(x, kernel_size, stride, padding, ceil_mode,
                        exclusive)


def adaptive_avg_pool2d(x, output_size):
    return K.adaptive_avg_pool2d(x, output_size)


def adaptive_max_pool2d(x, output_size):
    return K.adaptive_max_pool2d(x, output_size)


def _pool1d_args(kernel_size, stride, padding):
    """The 2-D pool's (kernel, stride, padding) of a 1-D pool over [N, C,
    L] as [N, C, 1, L]."""
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = stride if stride is None or isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    return (1, k), (1, s if s else k), (0, p)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    k, s, p = _pool1d_args(kernel_size, stride, padding)
    return K.max_pool2d(x[:, :, None], k, s, p, ceil_mode)[:, :, 0]


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    k, s, p = _pool1d_args(kernel_size, stride, padding)
    return K.avg_pool2d(x[:, :, None], k, s, p, ceil_mode,
                        exclusive)[:, :, 0]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch normalisation over the channels of x with the reference's
    semantics (`ops.kernels`); the channel axis is 1 for a `data_format`
    starting "NC" (NCHW, NCL, NC, NCDHW) and the last one otherwise
    (NHWC, NLC, NDHWC). In training, unless `use_global_stats`, it
    normalizes with the batch stats and updates `running_mean` /
    `running_var` in place, outside autograd (``momentum * running + (1 -
    momentum) * batch``, biased variance); otherwise it normalizes with
    the running stats. A missing weight / bias is 1 / 0."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    c = x.shape[c_axis]
    if weight is None:
        weight = torch.ones(c, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=x.dtype, device=x.device)
    if training and not use_global_stats:
        y, new_mean, new_var, _, _ = K.batch_norm_train(
            x, weight, bias, running_mean, running_var, momentum, epsilon,
            c_axis)
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
        return y
    return K.batch_norm_infer(x, weight, bias, running_mean, running_var,
                              epsilon, c_axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """The reference's cross entropy (`ops.kernels.cross_entropy_loss`):
    hard labels of [N] or [N, 1] (any integer type), `soft_label`
    distributions, per-class `weight`, a non-negative `ignore_index`,
    the class `axis`, and `use_softmax=False` for probabilities. A hard
    label carries no gradient."""
    if not soft_label:
        label = label.detach()
    return K.cross_entropy_loss(input, label, soft_label, reduction,
                                ignore_index, weight, axis, use_softmax)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced loss with its class axis kept at size 1 (and the
    softmax when `return_softmax`)."""
    loss = K.softmax_with_cross_entropy(
        logits, label if soft_label else label.detach(), soft_label, axis,
        ignore_index)
    if return_softmax:
        return loss, torch.softmax(logits, axis)
    return loss


def mse_loss(input, label, reduction="mean"):
    out = (input - label) ** 2
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


# ----------------------------------------------------------- activations

def sigmoid(x):
    return torch.sigmoid(x)


def silu(x):
    return K.silu(x)


def swish(x):
    return K.swish(x)


def leaky_relu(x, negative_slope=0.01):
    return K.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return K.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return K.selu(x, scale, alpha)


def prelu(x, weight, data_format="NCHW"):
    """where(x >= 0, x, w * x); a weight of one value is shared, else it
    is per channel (axis 1 for NCHW, the last axis otherwise)."""
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    axis = 1 if data_format == "NCHW" else x.dim() - 1
    return torch.where(x >= 0, x, K._bshape(weight, x.dim(), axis) * x)


def hardswish(x):
    return K.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return K.hardsigmoid(x, slope, offset)


def hardtanh(x, min=-1.0, max=1.0):
    return K.hardtanh(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def tanhshrink(x):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    return K.softplus(x, beta, threshold)


def softsign(x):
    return K.softsign(x)


def mish(x):
    return K.mish(x)


def maxout(x, groups, axis=1):
    """The max over `groups` consecutive channels of `axis`."""
    shape = list(x.shape)
    new = shape[:axis] + [shape[axis] // groups, groups] + shape[axis + 1:]
    return torch.amax(x.reshape(new), axis + 1)


def softmax(x, axis=-1, dtype=None):
    from ..core.dtypes import convert_dtype

    dt = convert_dtype(dtype)
    return K.softmax(x if dt is None else x.to(dt), axis)


def log_softmax(x, axis=-1, dtype=None):
    return K.log_softmax(x, axis)


def log_sigmoid(x):
    return K.log_sigmoid(x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """softmax((x + Gumbel noise) / temperature); `hard` returns the
    one-hot of the argmax with the soft sample's gradient. The noise is
    drawn from `generator` on x's device."""
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32) * (1.0 - 1e-20) + 1e-20
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = onehot + y - y.detach()
    return y


# -------------------------------------------------- linear / embedding

def linear(x, weight, bias=None):
    """x @ weight + bias, weight [in, out]."""
    return K.linear(x, weight, bias)


class _SparseEmbedding(torch.autograd.Function):
    """The lookup whose weight gradient is row-sparse: an uncoalesced
    torch sparse COO tensor of the weight's shape holding one row a
    looked-up id (indices [1, B*S], values [B*S, D]), so no dense [V, D]
    gradient is built (`sparse.SelectedRows` wraps it). A `padding_idx`
    lookup keeps its entry with zero values."""

    @staticmethod
    def forward(ctx, ids, weight, padding_idx):
        ctx.save_for_backward(ids)
        ctx.padding_idx = padding_idx
        ctx.weight_shape = tuple(weight.shape)
        return K.embedding(ids, weight, padding_idx)

    @staticmethod
    def backward(ctx, g):
        from ..sparse import _coo

        (ids,) = ctx.saved_tensors
        # a copy: the gradient must not alias the caller's ids (nor two
        # gradients one another, which AccumulateGrad would merge)
        flat = ids.reshape(-1).to(torch.int64, copy=True)
        vals = g.reshape((-1,) + ctx.weight_shape[1:])
        if ctx.padding_idx is not None and ctx.padding_idx >= 0:
            vals = vals * (flat != ctx.padding_idx)[:, None].to(vals.dtype)
        return None, _coo(flat[None], vals, ctx.weight_shape), None


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of `weight` at the ids x; rows at `padding_idx` are zero and
    get no gradient. `sparse=True` makes the weight's gradient row-sparse
    (`_SparseEmbedding`) where the weight is a leaf that takes a
    gradient; a derived weight (a cast, a scaled or sliced table) needs
    a dense gradient to flow upstream, so it takes the dense lookup, as
    in the JAX package."""
    if sparse and weight.is_leaf and weight.requires_grad \
            and torch.is_grad_enabled():
        return _SparseEmbedding.apply(x, weight, padding_idx)
    return K.embedding(x, weight, padding_idx)


def one_hot(x, num_classes):
    return K.one_hot(x, num_classes)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """1-D convolution of [N, C, L] by [O, C / groups, K] as a 2-D one
    over [N, C, 1, L]; `padding` is an int, [p] or "SAME" / "VALID"."""
    s = stride if isinstance(stride, int) else stride[0]
    d = dilation if isinstance(dilation, int) else dilation[0]
    p = padding if isinstance(padding, (int, str)) else int(padding[0])
    pad = p if isinstance(p, str) else [0, 0, p, p]
    out = K.conv2d(x[:, :, None, :], weight[:, :, None, :], (1, s), pad,
                   (1, d), groups)[:, :, 0, :]
    return out if bias is None else out + bias.reshape(1, -1, 1)


# --------------------------------------------------------- normalization

def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return K.layer_norm(x, weight, bias, epsilon, -len(normalized_shape))


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    return K.group_norm(x, num_groups, weight, bias, epsilon)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Per-sample, per-channel normalisation with the input's own stats
    (the running stats are taken and not used, as in the JAX package)."""
    return K.instance_norm(x, weight, bias, eps)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    return x / torch.clamp_min(K.norm(x, p, axis, True), epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """x / (k + alpha * sum of squares over `size` neighbouring
    channels) ** beta, the window zero-padded at the edges."""
    half = size // 2
    sq = torch.nn.functional.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, size):
        acc = acc + sq[:, i:i + x.shape[1]]
    return x / (k + alpha * acc) ** beta


# ------------------------------------------------------------------- losses

def _reduce_loss(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def l1_loss(input, label, reduction="mean"):
    return _reduce_loss(K.l1_loss(input, label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    return _reduce_loss(K.smooth_l1(input, label, delta), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """-input[n, label[n]] (times weight[label]); "mean" is the plain
    mean and `ignore_index` is taken and not applied, as in the JAX
    package."""
    return _reduce_loss(K.nll_loss(input, label.detach(), weight,
                                   ignore_index), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    out = K.bce_loss(input, label)
    return _reduce_loss(out if weight is None else out * weight, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    out = K.bce_with_logits(logit, label, pos_weight)
    return _reduce_loss(out if weight is None else out * weight, reduction)


def kl_div(input, label, reduction="mean"):
    """label * (log label - input), input being log-probabilities;
    "batchmean" divides the sum by the batch size."""
    out = K.kl_div(input, label)
    if reduction == "batchmean":
        return out.sum() / out.shape[0]
    return _reduce_loss(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce_loss(torch.clamp_min(-label * (input - other) + margin,
                                        0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce_loss(torch.where(label == 1.0, input, torch.clamp_min(
        margin - input, 0.0)), reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    num = (x1 * x2).sum(axis)
    den = torch.sqrt((x1 * x1).sum(axis)) * torch.sqrt((x2 * x2).sum(axis))
    return num / torch.clamp_min(den, eps)


def square_error_cost(input, label):
    return K.mse_loss(input, label)


def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) - (1.0 - label) * torch.log(
        1.0 - input + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Paddle's `ctc_loss` (warpctc): log_probs [T, B, C] are raw logits,
    log-softmaxed inside in float32 whatever their type, as the JAX
    package does; the recursion then runs in float32 or, for float64
    logits, float64. `reduction="mean"` is the plain mean over the batch
    (the JAX function's; Paddle's own divides by the label lengths
    first)."""
    dt = torch.promote_types(log_probs.dtype, torch.float32)
    lp = torch.log_softmax(log_probs.float(), -1).to(dt)
    loss = SL.ctc_loss(lp, labels, input_lengths, label_lengths, blank)
    if norm_by_times:
        n = torch.as_tensor(input_lengths, device=loss.device).reshape(-1)
        loss = loss / n.to(loss.dtype).clamp(min=1.0)
    return _reduce_loss(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = K.bce_with_logits(logit, label)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce_loss(out, reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    return K.label_smooth(label, epsilon, prior_dist)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Softmax cross-entropy of anchor-positive similarities against the
    label-equality targets, plus `l2_reg` / 4 of the mean squared norms."""
    sim = anchor @ positive.T
    lbl = labels.detach().reshape(-1, 1)
    tgt = (lbl == lbl.T).to(anchor.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, -1)).sum(1).mean()
    reg = (anchor * anchor).sum(1).mean() + (positive * positive).sum(
        1).mean()
    return ce + l2_reg * reg * 0.25


# ------------------------------------------------------------------- vision

def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the spatial axes of an (N, C, *spatial) x to `size` (or the
    sizes times `scale_factor`, truncated): "nearest" (2-D), "bilinear"
    (or "linear" on 2-D), "linear" / "trilinear" (any number of axes)
    and "bicubic". `align_corners` and `align_mode` have Paddle's meaning
    (align_mode 0 is half-pixel, 1 the legacy dst * in / out), not
    torch's."""
    spatial = x.dim() - 2
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = [int(s) for s in size.reshape(-1).tolist()]
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size] * spatial)]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            (scale_factor,) * spatial
        out = [int(d * s) for d, s in zip(x.shape[2:], sf)]
    if mode == "nearest":
        if spatial != 2:
            raise NotImplementedError("nearest interpolate is 2-D")
        return K.interpolate_nearest(x, tuple(out))
    if mode == "bilinear" or (mode == "linear" and spatial == 2):
        return K.interpolate_bilinear(x, tuple(out), align_corners,
                                      align_mode)
    if mode in ("linear", "trilinear"):
        return K.linear_nd(x, out, align_corners, align_mode)
    if mode == "bicubic":
        return K.cubic_nd(x, out, align_corners)
    raise NotImplementedError(f"interpolate mode {mode}")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False):
    return interpolate(x, size, scale_factor, mode, align_corners)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of NCHW x: [N, C * kh * kw, L], the channel-major order of
    the JAX function (torch's `unfold` has the same layout)."""
    k, s = K._pair(kernel_sizes), K._pair(strides)
    p, d = K._pair(paddings), K._pair(dilations)
    return torch.nn.functional.unfold(x, k, d, p, s)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Bilinear sampling of NCHW x at `grid` ([N, gh, gw, 2] of (x, y) in
    [-1, 1]); points outside read zeros. Other modes and padding modes
    raise (the JAX package takes them and applies bilinear / zeros)."""
    if mode != "bilinear" or padding_mode != "zeros":
        raise NotImplementedError(
            "grid_sample: only mode='bilinear', padding_mode='zeros' (the "
            "JAX package ignores the others)")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        gx, gy = (gx + 1.0) * (w - 1) / 2.0, (gy + 1.0) * (h - 1) / 2.0
    else:
        gx, gy = ((gx + 1.0) * w - 1.0) / 2.0, ((gy + 1.0) * h - 1.0) / 2.0
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    wx, wy = gx - x0, gy - y0
    bidx = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out = x[bidx, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(valid[..., None], out, 0.0)

    out = (sample(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
           + sample(y0, x0 + 1) * (wx * (1 - wy))[..., None]
           + sample(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
           + sample(y0 + 1, x0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


def affine_grid(theta, out_shape, align_corners=True):
    """The [N, H, W, 2] sampling grid of the affine maps theta [N, 2, 3]
    over an output of `out_shape` (N, C, H, W)."""
    n, c, h, w = [int(v) for v in out_shape]
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        ys, xs = torch.linspace(-1.0, 1.0, h, **kw), torch.linspace(
            -1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) * 2 + 1) / h - 1
        xs = (torch.arange(w, **kw) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    """Pad the trailing axes ([before, after] pairs from the first padded
    axis on, or of every axis): "constant", "reflect", "replicate" or
    "circular"."""
    pads = [int(p) for p in (pad.reshape(-1).tolist() if isinstance(
        pad, torch.Tensor) else pad)]
    return K.pad(x, pads, mode, value)


def temporal_shift(x, seg_num, shift_ratio=0.25):
    """TSM: a `shift_ratio` of the channels shifted one segment back, the
    next share one forward, zeros at the ends."""
    nt, c, h, w = x.shape
    n = nt // seg_num
    a = x.reshape(n, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([a[:, 1:, :fold], torch.zeros_like(a[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                       a[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, a[:, :, 2 * fold:]], 2).reshape(
        nt, c, h, w)


# the JAX package's amp policy at the functions it dispatches by name
_amp.register(globals(), _amp._FUNCTIONAL_OPS)
