"""Gradient clips (the JAX package's `nn.ClipGradByGlobalNorm`,
`ClipGradByNorm` and `ClipGradByValue`), over `(param, grad)` lists of
tensors.

The global norm is ``sqrt(sum over tensors of sum(g.float32 ** 2))`` and
the scale ``min(1, clip_norm / max(norm, 1e-12))``, both float32 tensors
on the gradients' device (no host round trip). Every path of the port
that clips by the global norm calls `clip_by_global_norm` here: the
clip object, the eager optimizers' multi-tensor and per-parameter
steps, and `optimizer.functional.clip_by_global_norm`; so all three
scale a gradient by the same bits.

The per-tensor norms come from `torch._foreach_norm` (one sweep a
device and dtype); their squares are summed. That rounds differently
from a sum of squares taken element by element, by a few float32 ulps
of the norm, far inside the 1e-6 relative limit the CPU tests hold the
scale to against the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "by_device_and_dtype", "global_norm", "clip_by_global_norm"]


def by_device_and_dtype(tensors):
    """[[index, ...], ...]: the positions of `tensors` grouped by
    (device, dtype), each group in order, groups in order of first
    appearance. A `torch._foreach_*` op takes one device and one dtype
    on its fast path."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


def global_norm(grads):
    """sqrt(sum over tensors of sum(g.float32 ** 2)): a float32 0-d
    tensor on the first gradient's device."""
    dev = grads[0].device
    parts = []
    for idx in by_device_and_dtype(grads):
        norms = torch._foreach_norm([grads[i] for i in idx], 2,
                                    dtype=torch.float32)
        parts.append(torch.stack(norms).square().sum().to(dev))
    total = parts[0] if len(parts) == 1 else torch.stack(parts).sum()
    return total.sqrt()


def clip_by_global_norm(grads, clip_norm):
    """The gradients scaled by min(1, clip_norm / max(norm, 1e-12)), each
    in its own dtype (a new list; the inputs are not changed)."""
    grads = list(grads)
    if not grads:
        return grads
    norm = global_norm(grads)
    # a tensor numerator: `float / tensor` is a reciprocal and a product
    scale = torch.full_like(norm, float(clip_norm)).div_(
        norm.clamp(min=1e-12)).clamp_(max=1.0)
    out = [None] * len(grads)
    for idx in by_device_and_dtype(grads):
        s = scale.to(grads[idx[0]].device)
        for i, g in zip(idx, torch._foreach_mul([grads[i] for i in idx],
                                                s)):
            out[i] = g
    return out


class ClipGradByGlobalNorm:
    """Scale every gradient by one factor so that their global norm is
    at most `clip_norm`."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        params_grads = list(params_grads)
        live = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        if not live:
            return params_grads
        scaled = clip_by_global_norm([params_grads[i][1] for i in live],
                                     self.clip_norm)
        out = list(params_grads)
        for i, g in zip(live, scaled):
            out[i] = (params_grads[i][0], g)
        return out


class ClipGradByNorm:
    """Scale each gradient whose own L2 norm (in its dtype) exceeds
    `clip_norm` down to that norm."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                n = g.square().sum().sqrt()
                factor = torch.full_like(n, self.clip_norm).div_(
                    n.clamp(min=1e-12))
                g = torch.where(n > self.clip_norm, g * factor, g)
            out.append((p, g))
        return out


class ClipGradByValue:
    """Clamp each gradient to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):  # noqa: A002 (the reference's names)
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]
