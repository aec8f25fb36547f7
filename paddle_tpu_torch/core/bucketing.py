"""Shape-bucketing helpers for the serving path.

The port keeps the JAX package's bucket policy (prompt lengths pad to
the next power of two) so that the port's serving engine and its solo
oracle lay prompts out exactly as the reference does: same positions,
same pad hole, same masking. Under eager PyTorch no compile cache
depends on it, but the numerics contract does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bucket_size", "pad_prompt_row"]


def bucket_size(n, minimum=1):
    """Next power of two >= n (and >= `minimum`)."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()


def pad_prompt_row(prompt, pad_id, minimum=1, dtype=np.int64):
    """One slot join's prompt layout: the 1-D token array padded with
    `pad_id` to its power-of-two bucket as a [1, Pb] row. Returns
    (row, P0, Pb) where P0 = max(len(prompt), minimum) is the real
    token count admission and masking reason about."""
    prompt = np.asarray(prompt)
    P0 = max(int(prompt.shape[0]), int(minimum))
    Pb = bucket_size(P0)
    row = np.full((1, Pb), pad_id, dtype)
    row[0, :prompt.shape[0]] = prompt
    return row, P0, Pb
