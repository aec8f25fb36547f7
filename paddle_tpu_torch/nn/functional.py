"""Functional entries the layers call (the JAX package's
`nn/functional`): activations, dropout, attention, the int8 and LoRA
matmuls of multi-tenant serving, the convolution, pooling and batch
normalisation of the vision models, and the losses `hapi.Model`
prepares."""
from __future__ import annotations

import torch

from ..ops import attention as A
from ..ops import kernels as K
from ..ops import quant as Q

__all__ = ["relu", "relu6", "gelu", "tanh", "flatten", "dropout",
           "draw_seed", "scaled_dot_product_attention", "linear_int8",
           "embedding_int8", "lora_delta", "conv2d", "conv2d_transpose",
           "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d", "max_pool1d", "avg_pool1d", "batch_norm",
           "cross_entropy", "softmax_with_cross_entropy", "mse_loss"]


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x):
    """GELU, the exact erf form (the reference's approximate=False)."""
    return torch.nn.functional.gelu(x)


def tanh(x):
    return torch.tanh(x)


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout (the reference's default mode): keeps
    each element with probability 1 - p and divides the kept ones by
    1 - p; identity when not training or p == 0. The mask is drawn from
    `generator` (a torch.Generator on x's device; None: that device's
    default generator)."""
    if not training or p == 0.0:
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p must be in [0, 1), got {p}")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def draw_seed(generator=None):
    """An attention-dropout seed (a host int32) drawn from a CPU
    torch.Generator (None: torch's default CPU generator). A CPU draw
    never waits for a device, and a seed is the same on every device."""
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=generator))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, dropout_seed=None,
                                 segment_ids=None):
    """Attention over [batch, heads, seq, dim] operands: the flash kernels
    on CUDA whenever the mask reduces to a per-key bias, their plain
    versions on the CPU (ops.attention.sdpa, which refuses a per-query
    mask on the card). In training with dropout_p > 0 the attention
    probabilities are dropped in-kernel, addressed by `dropout_seed`
    (drawn with `draw_seed()` when None). segment_ids ([batch, seq]
    integer, non-decreasing along each row: the packed rows of
    `core.lod.pack_padded`) restrict attention to same-segment tokens
    through the kernels' segment branch (the LoD-packed varlen path)."""
    p = float(dropout_p or 0.0) if training else 0.0
    if p and dropout_seed is None:
        dropout_seed = draw_seed()
    return A.sdpa(query, key, value, attn_mask, is_causal, dropout_p=p,
                  dropout_seed=dropout_seed, segment_ids=segment_ids)


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
