"""Quantization-aware training, the eager half of the JAX package's
`slim/quant.py` (:219-:384; reference: imperative/qat.py,
fake_quantize_dequantize ops).

`ImperativeQuantAware().quantize(model)` swaps every `Linear` / `Conv2D`
for a `QuantedLinear` / `QuantedConv2D` holding the same parameters under
the same names (state-dict keys unchanged): its weight is fake-quantized
at its abs-max, its input at a moving abs-max, both with the
straight-through gradient (`fake_quant`).

The JAX layer reads the activation's max on the host every training
step. Here the moving max is a 0-d float64 tensor on the layer's device
(a non-persistent buffer): the same float64 arithmetic as the JAX
package's Python float, with no host sync a step. Scales divide by a 0-d
float64 tensor of the bound, never by a Python number (CUDA multiplies
by a Python divisor's reciprocal, one rounding more).

Waiting for ROADMAP item 8d (static slim and `jit/`), each raising:
`PostTrainingQuantization` / `quant_post_static`, the static-graph QAT
passes, and `save_quantized_model` (its export runs `jit.save`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layer.common import Conv2D, Linear

__all__ = ["fake_quant", "QuantedLinear", "QuantedConv2D",
           "ImperativeQuantAware", "PostTrainingQuantization",
           "quant_post_static"]

_ITEM8 = "waits for the port's static slim and jit (ROADMAP item 8d)"


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bound):
        s = scale.to(x.dtype)
        ctx.save_for_backward(x)
        ctx.limit = (bound * scale).to(x.dtype)
        return torch.clamp(torch.round(x / s), -bound, bound) * s

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= ctx.limit).to(g.dtype), None, None


def _scale_tensor(scale, like):
    if isinstance(scale, torch.Tensor):
        return scale.detach()
    return torch.full((), float(scale), dtype=torch.float64,
                      device=like.device)


def fake_quant(x, scale, bits=8):
    """Quantize-dequantize, clip(round(x / s), -b, b) * s with b = 2^(bits
    - 1) - 1 and s rounded to x's dtype, with the straight-through
    gradient (passed where |x| <= b * s, zero elsewhere). `scale` is a
    number or a 0-d tensor (float64 keeps the JAX package's Python-float
    threshold)."""
    bound = 2.0 ** (bits - 1) - 1
    return _FakeQuant.apply(x, _scale_tensor(scale, x), bound)


class _QuantWrapper(nn.Module):
    """Weight abs-max fake quant + activation moving-max fake quant over
    the wrapped layer's own parameters."""

    def __init__(self, inner, weight_bits=8, activation_bits=8,
                 momentum=0.9):
        super().__init__()
        self.weight = inner.weight
        self.bias = inner.bias
        self._mom = float(momentum)
        self._w_bits = int(weight_bits)
        self._a_bits = int(activation_bits)
        dev = inner.weight.device
        self.register_buffer("_act_max", torch.ones(
            (), dtype=torch.float64, device=dev), persistent=False)

    def _bound(self, bits, like):
        return torch.full((), 2.0 ** (bits - 1) - 1, dtype=torch.float64,
                          device=like.device)

    def _quant_act(self, x):
        if self.training:
            cur = x.detach().abs().max().to(torch.float64).clamp(min=1e-8)
            self._act_max.copy_(self._mom * self._act_max
                                + (1 - self._mom) * cur)
        s = self._act_max.clamp(min=1e-8) / self._bound(self._a_bits, x)
        return fake_quant(x, s, self._a_bits)

    def _quant_w(self, w):
        absmax = w.detach().abs().max().to(torch.float64).clamp(min=1e-8)
        return fake_quant(w, absmax / self._bound(self._w_bits, w),
                          self._w_bits)


class QuantedLinear(_QuantWrapper):
    """`Linear` under QAT: y = fq(x) @ fq(weight) + bias."""

    def forward(self, x):
        return F.linear(self._quant_act(x), self._quant_w(self.weight),
                        self.bias)


class QuantedConv2D(_QuantWrapper):
    """`Conv2D` under QAT: conv2d(fq(x), fq(weight)) + bias."""

    def __init__(self, inner, weight_bits=8, activation_bits=8,
                 momentum=0.9):
        super().__init__(inner, weight_bits, activation_bits, momentum)
        self._cfg = (inner._stride, inner._padding, inner._dilation,
                     inner._groups)

    def forward(self, x):
        st, pad, dil, grp = self._cfg
        return F.conv2d(self._quant_act(x), self._quant_w(self.weight),
                        self.bias, st, pad, dil, grp)


class ImperativeQuantAware:
    """imperative/qat.py: wrap the quantizable sublayers in place,
    keeping their parameter names."""

    def __init__(self, quantizable_layer_type=("Linear", "Conv2D"),
                 weight_bits=8, activation_bits=8, **kw):
        self.types = tuple(quantizable_layer_type)
        self.weight_bits = int(weight_bits)
        self.activation_bits = int(activation_bits)

    def quantize(self, model):
        type_map = {"Linear": (Linear, QuantedLinear),
                    "Conv2D": (Conv2D, QuantedConv2D)}
        wanted = [type_map[t] for t in self.types if t in type_map]

        def walk(layer):
            for name, sub in list(layer.named_children()):
                for cls, qcls in wanted:
                    if type(sub) is cls:
                        layer._modules[name] = qcls(
                            sub, self.weight_bits, self.activation_bits)
                        break
                else:
                    walk(sub)

        walk(model)
        return model

    def save_quantized_model(self, model, path, input_spec=None, **kw):
        raise NotImplementedError(f"the QAT export through jit.save {_ITEM8}")


class PostTrainingQuantization:
    def __init__(self, *args, **kw):
        raise NotImplementedError(f"post-training quantization {_ITEM8}")


def quant_post_static(*args, **kw):
    raise NotImplementedError(f"quant_post_static {_ITEM8}")
