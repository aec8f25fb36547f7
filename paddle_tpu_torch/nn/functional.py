"""Functional entries the transformer layers call."""
from __future__ import annotations

import torch

from ..ops import attention as A

__all__ = ["relu", "scaled_dot_product_attention"]


def relu(x):
    return torch.relu(x)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention over [batch, heads, seq, dim] operands: the flash
    forward kernel on CUDA whenever the mask reduces to a per-key bias,
    its plain version on the CPU (ops.attention.sdpa, which refuses a
    per-query mask on the card). Attention dropout belongs to the
    training slice and is refused here."""
    if training and dropout_p:
        raise NotImplementedError(
            "attention dropout comes with the training slice of the port; "
            "call in eval mode or with dropout_p=0")
    return A.sdpa(query, key, value, attn_mask, is_causal)
