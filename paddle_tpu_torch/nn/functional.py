"""Functional entries the layers call (the JAX package's
`nn/functional`): activations, dropout and attention."""
from __future__ import annotations

import torch

from ..ops import attention as A

__all__ = ["relu", "gelu", "tanh", "dropout", "draw_seed",
           "scaled_dot_product_attention"]


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
