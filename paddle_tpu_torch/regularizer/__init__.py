"""Weight-decay regularizers (the JAX package's `regularizer`, the
reference's fluid/regularizer.py): `L2Decay` adds ``coeff * p`` to a
gradient, `L1Decay` adds ``coeff * sign(p)``.

The port's eager optimizers take an `L2Decay` (or a float) as
`weight_decay` and refuse an `L1Decay`: the JAX eager optimizers read
only its coefficient and so decay it as L2, which the port does not
copy.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "L2DecayRegularizer", "L1DecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff


class L2Decay(WeightDecayRegularizer):
    def grad_term(self, p):
        return self._coeff * p


class L1Decay(WeightDecayRegularizer):
    def grad_term(self, p):
        return self._coeff * torch.sign(p)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
