"""Decoding rules shared by the serving steppers (the JAX package's
`text/decode.py`; its fused scan searches are not ported)."""
from __future__ import annotations

import torch

__all__ = ["greedy_accept"]


def greedy_accept(drafts, preds):
    """Greedy draft-verify acceptance. drafts [B, K-1] are the proposed
    continuation tokens; preds [B, K] the argmax of the verify logits
    for the fed block [pending, d_1, ..., d_{K-1}], so preds[:, i] is the
    oracle token FOLLOWING fed position i. Draft i is accepted only while
    every earlier draft matched its oracle, which keeps the output
    identical to plain greedy decoding for any draft source.

    Returns (n_match [B] in [0, K-1], emit [B, K]), both int32: emit[:, i]
    is the i-th newly emitted token (the accepted drafts, then the
    correction token preds[:, n_match]; positions past n_match repeat
    the correction token, and callers emit only n_match + 1)."""
    K = preds.shape[1]
    match = (drafts == preds[:, :-1]).to(torch.int32)
    n_match = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    corr = preds.gather(1, n_match[:, None].long())
    ii = torch.arange(K, device=preds.device)[None, :]
    dpad = torch.cat([drafts.to(preds.dtype), corr], dim=1)
    emit = torch.where(ii < n_match[:, None], dpad, corr)
    return n_match, emit.to(torch.int32)
