"""Linear, Embedding, LayerNorm and Dropout with the JAX package's
parameter layouts and initialisers.

`Linear.weight` keeps the reference's [in_features, out_features]
layout (y = x @ W + b), so a JAX `state_dict()` loads without any
transpose and no call transposes a weight. Parameters are drawn on the
CPU from an explicit `torch.Generator` (the global one when None) and
then moved to `device`, so one seed gives the same weights on every
device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.device import resolve_device

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout"]

Dropout = nn.Dropout   # upscale-in-train, identity in eval: the reference's


def _param(shape, device, init=None):
    t = torch.zeros(shape)
    if init is not None:
        init(t)
    return nn.Parameter(t.to(device))


class Linear(nn.Module):
    """y = x @ weight + bias; weight [in, out] Xavier-uniform, bias 0."""

    def __init__(self, in_features, out_features, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        lim = math.sqrt(6.0 / (in_features + out_features))
        self.weight = _param(
            (in_features, out_features), dev,
            lambda t: t.uniform_(-lim, lim, generator=generator))
        self.bias = _param((out_features,), dev)

    def forward(self, x):
        y = torch.addmm(self.bias, x.reshape(-1, self.in_features),
                        self.weight)
        return y.reshape(*x.shape[:-1], self.out_features)


class Embedding(nn.Module):
    """Token lookup; weight [num_embeddings, dim] ~ N(0, 1)."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 generator=None):
        super().__init__()
        self.weight = _param(
            (num_embeddings, embedding_dim), resolve_device(device),
            lambda t: t.normal_(0.0, 1.0, generator=generator))

    def forward(self, x):
        return torch.nn.functional.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing dims (biased variance,
    epsilon inside the square root)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = _param(self._normalized_shape, dev, lambda t: t.fill_(1))
        self.bias = _param(self._normalized_shape, dev)

    def forward(self, x):
        return torch.nn.functional.layer_norm(
            x, self._normalized_shape, self.weight, self.bias,
            self._epsilon)
