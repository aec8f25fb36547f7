"""paddle.autograd (the JAX package's `autograd/`, `core/autograd.py`'s
grad modes and `paddle.grad`), on torch's autograd.

    y = model(x); penalty = paddle.grad(y.sum(), [x], create_graph=True)[0]
    class Clip(PyLayer):
        @staticmethod
        def forward(ctx, x): ctx.save_for_backward(x); return x.clamp(0, 1)
        @staticmethod
        def backward(ctx, g): (x,) = ctx.saved_tensor; return g * ...

`grad` leaves every tensor's `.grad` untouched (torch.autograd.grad);
`retain_graph` defaults to `create_graph`, as in Paddle; the gradient of
an `nn.Embedding(sparse=True)` weight comes back as a
`sparse.SelectedRows`, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import enable_grad, is_grad_enabled, no_grad

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "PyLayer", "PyLayerContext"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` into the leaves' `.grad`
    (one backward pass; each tensor seeded by its grad tensor, or ones)."""
    ts = _as_list(tensors)
    gs = _as_list(grad_tensors) if isinstance(grad_tensors, (list, tuple)) \
        else [grad_tensors] * len(ts)
    seeds = [torch.ones_like(t) if g is None else _like(g, t)
             for t, g in zip(ts, gs)]
    torch.autograd.backward(ts, seeds, retain_graph=retain_graph)


def _like(g, t):
    g = g if isinstance(g, torch.Tensor) else torch.as_tensor(np.asarray(g))
    return g.to(device=t.device, dtype=t.dtype)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad (imperative/partial_grad_engine.cc:29): the gradients
    of `outputs` (each seeded by its `grad_outputs` entry, or ones) with
    respect to `inputs` (leaves or intermediates), in one reverse pass,
    leaving every `.grad` untouched. `retain_graph` defaults to
    `create_graph`; with `create_graph=True` the gradients are
    differentiable (double grad). An unused input raises unless
    `allow_unused`, which gives None for it. A row-sparse gradient comes
    back as a `SelectedRows`."""
    from ..sparse import SelectedRows

    outs = _as_list(outputs)
    ins = _as_list(inputs)
    gos = [None] * len(outs)
    if grad_outputs is not None:
        gos = _as_list(grad_outputs)
        if len(gos) != len(outs):
            raise ValueError(
                f"the length of grad_outputs ({len(gos)}) must equal the "
                f"length of outputs ({len(outs)})")
    seeds = [torch.ones_like(o) if g is None else _like(g, o)
             for o, g in zip(outs, gos)]
    retain = bool(create_graph) if retain_graph is None \
        else bool(retain_graph)
    gs = torch.autograd.grad(outs, ins, seeds, retain_graph=retain,
                             create_graph=create_graph,
                             allow_unused=allow_unused)
    return [SelectedRows(g) if g is not None and g.layout == torch.sparse_coo
            else g for g in gs]


class PyLayerContext:
    """What a PyLayer's forward and backward share: `save_for_backward`
    and `saved_tensor` (a tuple), and any attribute set on it."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function every PyLayer runs through: the subclass's
    forward under no grad, its backward's gradients mapped back to the
    tensor arguments (None for the others)."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext()
        out = layer.forward(pctx, *args, **kwargs)
        ctx.layer, ctx.pctx = layer, pctx
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        saved = pctx._saved
        ctx.saved_kinds = [isinstance(t, torch.Tensor) for t in saved]
        ctx.save_for_backward(*[t for t in saved
                                if isinstance(t, torch.Tensor)])
        ctx.saved_other = [t for t in saved
                           if not isinstance(t, torch.Tensor)]
        return out

    @staticmethod
    def backward(ctx, *grads):
        tensors = iter(ctx.saved_tensors)
        other = iter(ctx.saved_other)
        ctx.pctx._saved = tuple(next(tensors) if k else next(other)
                                for k in ctx.saved_kinds)
        gin = ctx.layer.backward(ctx.pctx, *grads)
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        out, it = [None, None], iter(gin)
        for is_t in ctx.is_tensor:
            out.append(next(it, None) if is_t else None)
        return tuple(out)


class PyLayer:
    """A user-defined differentiable op: subclass with static `forward(ctx,
    *args, **kwargs)` and `backward(ctx, *grads)` (one gradient for each
    tensor argument, in order), then call `Layer.apply(*args)`."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)
