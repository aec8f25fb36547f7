"""Functional entries the layers call (the JAX package's
`nn/functional`): activations, dropout, attention, the int8 and LoRA
matmuls of multi-tenant serving, and the convolution, pooling and batch
normalisation of the vision models."""
from __future__ import annotations

import torch

from ..ops import attention as A
from ..ops import kernels as K
from ..ops import quant as Q

__all__ = ["relu", "gelu", "tanh", "dropout", "draw_seed",
           "scaled_dot_product_attention", "linear_int8", "embedding_int8",
           "lora_delta", "conv2d", "max_pool2d", "adaptive_avg_pool2d",
           "batch_norm"]


def relu(x):
    return torch.relu(x)


def gelu(x):
    """GELU, the exact erf form (the reference's approximate=False)."""
    return torch.nn.functional.gelu(x)


def tanh(x):
    return torch.tanh(x)


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
                                 training=True, dropout_seed=None):
    """Attention over [batch, heads, seq, dim] operands: the flash kernels
    on CUDA whenever the mask reduces to a per-key bias, their plain
    versions on the CPU (ops.attention.sdpa, which refuses a per-query
    mask on the card). In training with dropout_p > 0 the attention
    probabilities are dropped in-kernel, addressed by `dropout_seed`
    (drawn with `draw_seed()` when None)."""
    p = float(dropout_p or 0.0) if training else 0.0
    if p and dropout_seed is None:
        dropout_seed = draw_seed()
    return A.sdpa(query, key, value, attn_mask, is_causal, dropout_p=p,
                  dropout_seed=dropout_seed)


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


def max_pool2d(x, kernel_size, stride=None, padding=0):
    return K.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x, output_size):
    return K.adaptive_avg_pool2d(x, output_size)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5):
    """Batch normalisation over the channels of an NCHW x with the
    reference's semantics (`ops.kernels`). In training it normalizes
    with the batch stats and updates `running_mean` / `running_var` in
    place, outside autograd (``momentum * running + (1 - momentum) *
    batch``, biased variance); otherwise it normalizes with the running
    stats. A missing weight / bias is 1 / 0."""
    c = x.shape[1]
    if weight is None:
        weight = torch.ones(c, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=x.dtype, device=x.device)
    if training:
        y, new_mean, new_var, _, _ = K.batch_norm_train(
            x, weight, bias, running_mean, running_var, momentum, epsilon)
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
        return y
    return K.batch_norm_infer(x, weight, bias, running_mean, running_var,
                              epsilon)
