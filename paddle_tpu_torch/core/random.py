"""The global seed (the JAX package's `core/random.py`; reference:
framework/generator.h and paddle.seed).

The port's random draws take explicit `torch.Generator`s; where a caller
passes none (`generator=None`), torch's default generators draw: the
CPU's and each card's. `seed(s)` seeds all of them, so a seeded program
repeats. The bits differ from the JAX package's (jax.random against
torch's Philox and Mersenne Twister): seeded draws match the JAX
package's only in distribution.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "get_seed"]

_SEED = [0]


def seed(s: int):
    """paddle.seed: seed torch's default CPU generator and every card's
    (torch.manual_seed); returns the seed."""
    _SEED[0] = int(s)
    torch.manual_seed(_SEED[0])
    return _SEED[0]


def get_seed() -> int:
    return _SEED[0]
