"""Linear, Embedding, LayerNorm, Dropout and Tanh with the JAX
package's parameter layouts and initialisers.

`Linear.weight` keeps the reference's [in_features, out_features]
layout (y = x @ W + b), so a JAX `state_dict()` loads without any
transpose and no call transposes a weight. Parameters are drawn on the
CPU from an explicit `torch.Generator` (the global one when None) and
then moved to `device`, so one seed gives the same weights on every
device.

Serving-time int8: `Linear.quantize_int8()` and
`Embedding.quantize_int8()` replace the float32 `weight` Parameter with
the `weight_q` (int8) and `weight_scale` (float32) buffers of the JAX
package, so a JAX `state_dict()` of a quantized net loads by name.
A Linear an `AdapterPool` installed `_lora_idx` on adds the per-row
adapter delta inside a `lora_scope` (`ops.quant`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.device import resolve_device
from .. import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "Tanh"]


class Dropout(nn.Module):
    """Upscale-in-train dropout, identity in eval (the reference's).
    `generator`: the torch.Generator its masks are drawn from, on the
    device of the inputs (None: that device's default generator);
    `SpmdTrainer` binds its own."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Tanh(nn.Module):
    def forward(self, x):
        return F.tanh(x)


def _param(shape, device, init=None):
    t = torch.zeros(shape)
    if init is not None:
        init(t)
    return nn.Parameter(t.to(device))


def _quantize(layer):
    """Swap `layer.weight` for the int8 `weight_q` / float32
    `weight_scale` buffers (per output channel). One-way."""
    from ...ops import quant as Q

    w = layer.weight.detach()
    q, scale = Q.quantize_int8_weight(w)
    layer._weight_dtype = w.dtype
    layer.register_buffer("weight_q", q)
    layer.register_buffer("weight_scale", scale)
    layer.weight = None          # drops the float32 copy from the parameters
    return layer


class Linear(nn.Module):
    """y = x @ weight + bias; weight [in, out] Xavier-uniform, bias 0.
    After `quantize_int8()`, y = int8_matmul(x, weight_q, weight_scale) +
    bias."""

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

    @property
    def param_dtype(self):
        """The compute dtype of the outputs: the weight's, or after
        `quantize_int8()` the recorded pre-quantization dtype."""
        if self.weight is not None:
            return self.weight.dtype
        return self._weight_dtype

    @property
    def device(self):
        """Where the layer's weights live (float32 or int8)."""
        return (self.weight if self.weight is not None
                else self.weight_q).device

    def quantize_int8(self):
        """Serving-time weight quantization: the float32 weight becomes the
        symmetric per-output-channel int8 `weight_q` with float32
        `weight_scale` (`ops.quant.quantize_int8_weight`), and the forward
        runs the scaled int8 matmul. One-way (a serving engine owns the
        model it serves); the bias and the compute dtype stay."""
        if self.weight is None:
            return self
        return _quantize(self)

    def forward(self, x):
        if self.weight is None:
            y = F.linear_int8(x, self.weight_q, self.weight_scale, self.bias)
        else:
            y = torch.addmm(self.bias, x.reshape(-1, self.in_features),
                            self.weight)
            y = y.reshape(*x.shape[:-1], self.out_features)
        # batched-LoRA hook: an AdapterPool installs `_lora_idx` on its
        # target layers; inside a `lora_scope` the per-row adapter delta
        # joins the output
        idx = self.__dict__.get("_lora_idx")
        if idx is not None:
            from ...ops.quant import current_lora

            ctx = current_lora()
            if ctx is not None:
                ids, banks = ctx
                A, B = banks[idx]
                y = y + F.lora_delta(x, A, B, ids)
        return y


class Embedding(nn.Module):
    """Token lookup; weight [num_embeddings, dim] ~ N(0, 1), or after
    `quantize_int8()` the int8 `weight_q` with `weight_scale`."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 generator=None):
        super().__init__()
        self.weight = _param(
            (num_embeddings, embedding_dim), resolve_device(device),
            lambda t: t.normal_(0.0, 1.0, generator=generator))

    def quantize_int8(self):
        """Serving-time vocabulary-table quantization: the [V, D] table
        becomes int8 with per-output-channel float32 scales; a lookup
        gathers int8 rows and scales them (no dequantized table)."""
        if self.weight is None:
            return self
        return _quantize(self)

    def forward(self, x):
        if self.weight is None:
            return F.embedding_int8(x, self.weight_q, self.weight_scale,
                                    self._weight_dtype)
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
