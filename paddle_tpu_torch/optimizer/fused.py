"""The multi-tensor optimizer step (the JAX package's `optimizer/fused.py`,
whose one donated XLA dispatch becomes one sweep of `torch._foreach_*`
ops a parameter group).

`apply(opt, dense_pg)` updates every dense (param, grad) pair of an
eager optimizer at once. The parameters are grouped by (learning-rate
multiplier, weight decay, master weight) as the JAX `_build` groups
them; each group runs the optimizer's functional rule
(`opt._fused_tx(lr * mult, wd)`) once over all its tensors, which
`optimizer.functional` sweeps by device and dtype. A global-norm clip
scales all the dense gradients before any group's rule
(`nn.clip.clip_by_global_norm`, the helper the per-parameter path calls
too). `multi_precision` parameters feed their float32 `master_weight`
slot to the rule and receive its update rounded to their own dtype.

The grouping (the plan) is made anew each step from each parameter's
multiplier, decay and master flag: one pass over the list, which is what
looking up a plan keyed on those values would cost (the JAX package
caches its plan because the plan there is a compiled program). The
learning rate and the step count enter each step as values. Slots live
in `opt._accumulators` as on the per-parameter path, so the two paths
can be switched between steps and give the same bits.

The way back to the per-parameter path is the JAX package's: a
subclass that overrides `_update_param`, a clip other than
`ClipGradByGlobalNorm`, `opt._use_fused = False`, or the environment
variable `PADDLE_TPU_FUSED_OPT=0`.
"""
from __future__ import annotations

import os

from ..nn import clip as _clip
from . import functional as F

__all__ = ["supported", "apply"]


def _enabled():
    return os.environ.get("PADDLE_TPU_FUSED_OPT", "1") != "0"


def supported(opt):
    """True when `opt`'s dense update can run on the multi-tensor path."""
    from . import Optimizer

    if opt.__dict__.get("_use_fused") is False or not _enabled():
        return False
    if getattr(type(opt), "_fused_state_cls", None) is None:
        return False
    # a subclass overriding the per-parameter rule opts out
    if type(opt)._update_param is not Optimizer._update_param:
        return False
    clip = opt._grad_clip
    return clip is None or type(clip) is _clip.ClipGradByGlobalNorm


def _plan(opt, params):
    """[((mult, wd, master), [index, ...]), ...] in sorted key order."""
    groups = {}
    for i, p in enumerate(params):
        key = (opt._mult(p), opt._decay_value(p), opt._mp_enabled(p))
        groups.setdefault(key, []).append(i)
    return sorted(groups.items(), key=lambda kv: kv[0])


def apply(opt, dense_pg):
    """One multi-tensor update of the dense (param, grad) list, the clip
    included."""
    plan = _plan(opt, [p for p, _ in dense_pg])
    clip = opt._grad_clip
    clip_norm = None if clip is None else clip.clip_norm
    grads = [g for _, g in dense_pg]
    if clip_norm is not None:
        grads = _clip.clip_by_global_norm(grads, clip_norm)
    lr = F.f32(opt.get_lr())
    for (mult, wd, _), idx in plan:
        opt._run_rule([dense_pg[i][0] for i in idx], [grads[i] for i in idx],
                      F.f32(lr * F.f32(mult)), wd)
