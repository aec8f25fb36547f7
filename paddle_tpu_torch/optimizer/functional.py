"""Pure optimizer rules over {name: tensor} dictionaries (the JAX
package's `optimizer/functional.py`): `init(params) -> state` and
`update(params, grads, state) -> (new_params, new_state)`. Neither
changes its inputs.

Each `update` sweeps the whole dictionary with `torch._foreach_*` ops,
one call an operation for each (device, dtype) group of tensors: the
counterpart of XLA fusing the JAX rule's tree map into one program. The
sweep keeps the JAX rules' order of operations, one rounding an
operation (no foreach op that may fuse a multiply and an add, such as
addcmul, addcdiv, lerp or an add with alpha), so a rule gives the same
bits on one tensor as on a list of them. Host scalars derived from the
step count (Adam's bias corrections c = 1 - beta ** t, Adamax's lr / c)
are float32 values, as the JAX rules compute them; a division by one
goes through a 0-d device tensor (`_div`), since CUDA would take a
Python divisor as a product by its reciprocal.

`learning_rate` is a float or a callable of the step count before the
increment (`state.count`, a Python int), such as a schedule's
`get_lr_traced` from `optimizer.lr`.

Rules: `sgd`, `momentum`, `adam` / `adamw` (with `decay_mask(name)`),
`lamb`, `adamax`, `adagrad`, `adadelta`, `rmsprop`, `lars_momentum`;
wrappers `clip_by_global_norm` and `dgc`; `from_eager` builds the rule
of an eager optimizer of `paddle_tpu_torch.optimizer`.
"""
from __future__ import annotations

import collections
import warnings

import numpy as np
import torch

from ..nn import clip as _clip

__all__ = ["Transform", "ScaleState", "MomentumState", "AdamState",
           "AdamaxState", "AdagradState", "AdadeltaState", "RmspropState",
           "LarsState", "DgcState", "sgd", "momentum", "adam", "adamw",
           "lamb", "adamax", "adagrad", "adadelta", "rmsprop",
           "clip_by_global_norm", "from_eager", "lars_momentum", "dgc"]

Transform = collections.namedtuple("Transform", ["init", "update"])
ScaleState = collections.namedtuple("ScaleState", ["count"])
MomentumState = collections.namedtuple("MomentumState",
                                       ["count", "velocity"])
AdamState = collections.namedtuple("AdamState", ["count", "m", "v"])
AdamaxState = collections.namedtuple("AdamaxState", ["count", "m", "u"])
AdagradState = collections.namedtuple("AdagradState", ["count", "moment"])
AdadeltaState = collections.namedtuple(
    "AdadeltaState", ["count", "avg_sq_grad", "avg_sq_upd"])
RmspropState = collections.namedtuple(
    "RmspropState", ["count", "mean_square", "mean_grad", "momentum"])
LarsState = collections.namedtuple("LarsState", ["count", "velocity"])
DgcState = collections.namedtuple("DgcState", ["inner", "residual"])

def f32(x):
    """x rounded to float32, as a Python float. One float64 operation on
    float32 operands rounded this way gives the float32 operation's bits
    (53 >= 2 * 24 + 2)."""
    return float(np.float32(x))


def _f32_pow(base, t):
    """base ** t in float32, as a Python float (a host number, so the
    update never waits for the device)."""
    return float(torch.tensor(base, dtype=torch.float32)
                 ** torch.tensor(float(t), dtype=torch.float32))


def bias_correction(beta, t):
    """1 - beta ** t in float32 (the JAX rules' c1 and c2)."""
    return f32(1.0 - _f32_pow(beta, t))


def _resolve_lr(lr, count):
    if callable(lr):
        lr = lr(count)
        if lr is None:
            raise ValueError("the learning-rate callable returned None "
                             "(a schedule with no count form)")
    return float(lr)


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _sweep(rule, params, grads, slots, key=None):
    """Run `rule(ps, gs, *slot_lists, group)` over each (device, dtype,
    key(name)) group of `params`, gradients cast to the parameter's
    dtype. Returns (new params, [new slot dict, ...]) in `params`'
    order."""
    names = list(params)
    groups = {}
    for n in names:
        p = params[n]
        k = (p.device, p.dtype, None if key is None else key(n))
        groups.setdefault(k, []).append(n)
    outs = {}
    for (_, dtype, k), group in groups.items():
        ps = [params[n] for n in group]
        gs = [grads[n] if grads[n].dtype == dtype else grads[n].to(dtype)
              for n in group]
        out = rule(ps, gs, *[[s[n] for n in group] for s in slots], k)
        for j, n in enumerate(group):
            outs[n] = [lst[j] for lst in out]
    new_p = {n: outs[n][0] for n in names}
    return new_p, [{n: outs[n][i + 1] for n in names}
                   for i in range(len(slots))]


def _div(xs, c):
    """[x / c] for the float32 host value c, one true division an
    element. CUDA takes a division by a Python scalar as a product by
    its reciprocal (a second rounding), so float32 and float64 lists
    divide by a 0-d tensor of their own dtype on their device (one fill
    kernel), which CPU and CUDA both divide by. Lists of other dtypes
    divide by the Python scalar (a 0-d tensor would round c to their
    type)."""
    if xs[0].dtype in (torch.float32, torch.float64):
        c = torch.full((), c, dtype=xs[0].dtype, device=xs[0].device)
    return torch._foreach_div(xs, c)


def _scaled(xs, factors):
    """[x * f for each tensor and 0-d factor] (a per-tensor scale the
    device computed: one product a tensor)."""
    return [x * f for x, f in zip(xs, factors.unbind())]


# ------------------------------------------------------------ list rules
# Each takes lists (one device, one dtype) and returns new lists in the
# JAX rule's order of operations.

def sgd_lists(ps, gs, lr, wd):
    """p - lr * (g + wd * p)"""
    if wd:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    return (torch._foreach_sub(ps, torch._foreach_mul(gs, lr)),)


def momentum_lists(ps, gs, vel, lr, mu, wd, nesterov):
    """g += wd * p; v = mu * v + g; p - lr * v (Nesterov: p - lr * (g +
    mu * v))."""
    if wd:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    v = torch._foreach_mul(vel, mu)
    torch._foreach_add_(v, gs)
    if nesterov:
        step = torch._foreach_mul(v, mu)
        step = torch._foreach_add(gs, step)
    else:
        step = v
    return torch._foreach_sub(ps, torch._foreach_mul(step, lr)), v


def adam_lists(ps, gs, ms, vs, lr, b1, b2, eps, c1, c2, wd_c, wd_d):
    """g += wd_c * p; m = b1 * m + (1 - b1) * g; v = b2 * v + (1 - b2) *
    (g * g); upd = (m / c1) / (sqrt(v / c2) + eps) + wd_d * p; p - lr *
    upd."""
    if wd_c:
        gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd_c))
    m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
    gg = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(gg, 1 - b2)
    v = torch._foreach_mul(vs, b2)
    torch._foreach_add_(v, gg)
    del gg
    upd = _div(m, c1)
    den = _div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(upd, den)
    del den
    if wd_d:
        torch._foreach_add_(upd, torch._foreach_mul(ps, wd_d))
    torch._foreach_mul_(upd, lr)
    return torch._foreach_sub(ps, upd), m, v


def lamb_lists(ps, gs, ms, vs, lr, b1, b2, eps, c1, c2, wd):
    """Adam's moments, r = m_hat / (sqrt(v_hat) + eps) + wd * p, then p -
    lr * trust * r with trust = ||p|| / ||r|| (1 where either is 0),
    norms in float32."""
    m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
    gg = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(gg, 1 - b2)
    v = torch._foreach_mul(vs, b2)
    torch._foreach_add_(v, gg)
    r = _div(m, c1)
    den = _div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(r, den)
    if wd:
        torch._foreach_add_(r, torch._foreach_mul(ps, wd))
    w_norm = torch.stack(torch._foreach_norm(ps, 2, dtype=torch.float32))
    r_norm = torch.stack(torch._foreach_norm(r, 2, dtype=torch.float32))
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        1.0).to(ps[0].dtype)
    step = _scaled(r, trust * lr)
    return torch._foreach_sub(ps, step), m, v


def adamax_lists(ps, gs, ms, us, lr_c1, b1, b2, eps):
    """m = b1 * m + (1 - b1) * g; u = max(b2 * u, |g|); p - (lr / c1) *
    m / (u + eps); `lr_c1` is lr / c1 in float32."""
    m = torch._foreach_mul(ms, b1)
    torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
    u = torch._foreach_maximum(torch._foreach_mul(us, b2),
                               torch._foreach_abs(gs))
    step = torch._foreach_mul(m, lr_c1)
    torch._foreach_div_(step, torch._foreach_add(u, eps))
    return torch._foreach_sub(ps, step), m, u


def adagrad_lists(ps, gs, accs, lr, eps):
    """acc += g * g; p - lr * g / (sqrt(acc) + eps)."""
    acc = torch._foreach_add(accs, torch._foreach_mul(gs, gs))
    den = torch._foreach_sqrt(acc)
    torch._foreach_add_(den, eps)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, den)
    return torch._foreach_sub(ps, step), acc


def adadelta_lists(ps, gs, egs, eus, lr, eps, rho):
    """eg = rho * eg + (1 - rho) * g * g; upd = sqrt(eu + eps) / sqrt(eg
    + eps) * g; eu = rho * eu + (1 - rho) * upd * upd; p - lr * upd."""
    eg = torch._foreach_mul(egs, rho)
    t = torch._foreach_mul(gs, 1 - rho)
    torch._foreach_mul_(t, gs)
    torch._foreach_add_(eg, t)
    upd = torch._foreach_add(eus, eps)
    torch._foreach_sqrt_(upd)
    den = torch._foreach_add(eg, eps)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, gs)
    eu = torch._foreach_mul(eus, rho)
    t = torch._foreach_mul(upd, 1 - rho)
    torch._foreach_mul_(t, upd)
    torch._foreach_add_(eu, t)
    return torch._foreach_sub(ps, torch._foreach_mul(upd, lr)), eg, eu


def rmsprop_lists(ps, gs, mss, mgs, moms, lr, rho, eps, mom, centered):
    """ms = rho * ms + (1 - rho) * g * g; centered: mg = rho * mg + (1 -
    rho) * g, denom = sqrt(ms - mg * mg + eps), else sqrt(ms + eps); mom
    = mom * momentum + lr * g / denom; p - mom."""
    ms = torch._foreach_mul(mss, rho)
    t = torch._foreach_mul(gs, 1 - rho)
    torch._foreach_mul_(t, gs)
    torch._foreach_add_(ms, t)
    if centered:
        mg = torch._foreach_mul(mgs, rho)
        torch._foreach_add_(mg, torch._foreach_mul(gs, 1 - rho))
        den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        torch._foreach_add_(den, eps)
    else:
        mg = list(mgs)
        den = torch._foreach_add(ms, eps)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, den)
    m = torch._foreach_mul(moms, mom)
    torch._foreach_add_(m, step)
    return torch._foreach_sub(ps, m), ms, mg, m


def lars_lists(ps, gs, vs, lr, mu, coeff, wd, eps):
    """local = lr * coeff * ||p|| / (||g|| + wd * ||p|| + eps) (lr where
    ||p|| = 0); v = mu * v + local * (g + wd * p); p - v."""
    pn = torch.stack(torch._foreach_norm(ps, 2, dtype=torch.float32))
    gn = torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float32))
    local = lr * coeff * pn / (gn + wd * pn + eps)
    local = torch.where(pn > 0, local, lr).to(ps[0].dtype)
    t = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
    v = torch._foreach_mul(vs, mu)
    torch._foreach_add_(v, _scaled(t, local))
    return torch._foreach_sub(ps, v), v


# ----------------------------------------------------------------- rules

def sgd(learning_rate=0.01, weight_decay=0.0):
    """p -= lr * (g + wd * p)."""

    def init(params):
        return ScaleState(count=0)

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, _ = _sweep(lambda ps, gs, k: sgd_lists(ps, gs, lr,
                                                      weight_decay),
                          params, grads, [])
        return new_p, ScaleState(state.count + 1)

    return Transform(init, update)


def momentum(learning_rate=0.01, mu=0.9, weight_decay=0.0,
             use_nesterov=False):
    """SGD with momentum (the reference's momentum_op): the decay joins
    the gradient, ``v = mu * v + g``, then ``p - lr * v`` (Nesterov: ``p
    - lr * (g + mu * v)``). Velocities start at zero."""

    def init(params):
        return MomentumState(count=0, velocity=_zeros(params))

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, (vel,) = _sweep(
            lambda ps, gs, vs, k: momentum_lists(
                ps, gs, vs, lr, mu, weight_decay, use_nesterov),
            params, grads, [state.velocity])
        return new_p, MomentumState(state.count + 1, vel)

    return Transform(init, update)


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
         weight_decay=0.0, decoupled=False, decay_mask=None):
    """Adam, or AdamW with `decoupled` (the decay added to the update,
    not the gradient). `decay_mask(name) -> bool` limits the weight
    decay to the parameters it accepts (all of them when None)."""

    def init(params):
        return AdamState(count=0, m=_zeros(params), v=_zeros(params))

    def update(params, grads, state):
        t = state.count + 1
        lr = _resolve_lr(learning_rate, state.count)
        c1, c2 = bias_correction(beta1, t), bias_correction(beta2, t)

        def rule(ps, gs, ms, vs, decays):
            wd = weight_decay if decays in (None, True) else 0.0
            return adam_lists(ps, gs, ms, vs, lr, beta1, beta2, epsilon,
                              c1, c2, 0.0 if decoupled else wd,
                              wd if decoupled else 0.0)

        key = None if decay_mask is None else \
            (lambda n: bool(decay_mask(n)))
        new_p, (m, v) = _sweep(rule, params, grads, [state.m, state.v],
                               key)
        return new_p, AdamState(t, m, v)

    return Transform(init, update)


def adamw(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
          weight_decay=0.01, decay_mask=None):
    return adam(learning_rate, beta1, beta2, epsilon, weight_decay,
                decoupled=True, decay_mask=decay_mask)


def lamb(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6,
         weight_decay=0.01):
    """The reference's lamb_op: Adam's moments and a layer-wise trust
    ratio."""

    def init(params):
        return AdamState(count=0, m=_zeros(params), v=_zeros(params))

    def update(params, grads, state):
        t = state.count + 1
        lr = _resolve_lr(learning_rate, state.count)
        c1, c2 = bias_correction(beta1, t), bias_correction(beta2, t)
        new_p, (m, v) = _sweep(
            lambda ps, gs, ms, vs, k: lamb_lists(
                ps, gs, ms, vs, lr, beta1, beta2, epsilon, c1, c2,
                weight_decay),
            params, grads, [state.m, state.v])
        return new_p, AdamState(t, m, v)

    return Transform(init, update)


def adamax(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """The reference's adamax_op: Adam's first moment and an
    infinity-norm second moment (no weight decay, as the eager rule)."""

    def init(params):
        return AdamaxState(count=0, m=_zeros(params), u=_zeros(params))

    def update(params, grads, state):
        t = state.count + 1
        lr = _resolve_lr(learning_rate, state.count)
        lr_c1 = f32(f32(lr) / bias_correction(beta1, t))
        new_p, (m, u) = _sweep(
            lambda ps, gs, ms, us, k: adamax_lists(
                ps, gs, ms, us, lr_c1, beta1, beta2, epsilon),
            params, grads, [state.m, state.u])
        return new_p, AdamaxState(t, m, u)

    return Transform(init, update)


def adagrad(learning_rate=0.001, epsilon=1e-6):
    """The reference's adagrad_op: acc += g * g; p -= lr * g / (sqrt(acc)
    + eps)."""

    def init(params):
        return AdagradState(count=0, moment=_zeros(params))

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, (acc,) = _sweep(
            lambda ps, gs, accs, k: adagrad_lists(ps, gs, accs, lr,
                                                  epsilon),
            params, grads, [state.moment])
        return new_p, AdagradState(state.count + 1, acc)

    return Transform(init, update)


def adadelta(learning_rate=0.001, epsilon=1e-6, rho=0.95):
    """The reference's adadelta_op."""

    def init(params):
        return AdadeltaState(count=0, avg_sq_grad=_zeros(params),
                             avg_sq_upd=_zeros(params))

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, (eg, eu) = _sweep(
            lambda ps, gs, egs, eus, k: adadelta_lists(ps, gs, egs, eus,
                                                       lr, epsilon, rho),
            params, grads, [state.avg_sq_grad, state.avg_sq_upd])
        return new_p, AdadeltaState(state.count + 1, eg, eu)

    return Transform(init, update)


def rmsprop(learning_rate=0.001, rho=0.95, epsilon=1e-6, momentum=0.0,
            centered=False):
    """The reference's rmsprop_op (the rate folded into the momentum
    accumulator)."""

    def init(params):
        return RmspropState(count=0, mean_square=_zeros(params),
                            mean_grad=_zeros(params),
                            momentum=_zeros(params))

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, (ms, mg, mom) = _sweep(
            lambda ps, gs, a, b, c, k: rmsprop_lists(
                ps, gs, a, b, c, lr, rho, epsilon, momentum, centered),
            params, grads,
            [state.mean_square, state.mean_grad, state.momentum])
        return new_p, RmspropState(state.count + 1, ms, mg, mom)

    return Transform(init, update)


def lars_momentum(learning_rate=0.01, mu=0.9, lars_coeff=0.001,
                  lars_weight_decay=5e-4, epsilon=1e-9):
    """The reference's lars_momentum_op: layer-wise adaptive rate
    scaling, local_lr = lr * coeff * ||p|| / (||g|| + wd * ||p|| + eps),
    v = mu * v + local_lr * (g + wd * p); p -= v."""

    def init(params):
        return LarsState(count=0, velocity=_zeros(params))

    def update(params, grads, state):
        lr = _resolve_lr(learning_rate, state.count)
        new_p, (vel,) = _sweep(
            lambda ps, gs, vs, k: lars_lists(
                ps, gs, vs, lr, mu, lars_coeff, lars_weight_decay,
                epsilon),
            params, grads, [state.velocity])
        return new_p, LarsState(state.count + 1, vel)

    return Transform(init, update)


def clip_by_global_norm(tx, max_norm):
    """`tx` behind ClipGradByGlobalNorm(max_norm) (the same helper as the
    clip object and the eager optimizers' steps)."""

    def init(params):
        return tx.init(params)

    def update(params, grads, state, **kw):
        names = list(grads)
        scaled = _clip.clip_by_global_norm([grads[n] for n in names],
                                           max_norm)
        return tx.update(params, dict(zip(names, scaled)), state, **kw)

    return Transform(init, update)


def dgc(tx, sparsity=0.99, rampup_begin_step=0):
    """Deep Gradient Compression: keep the top (1 - sparsity) share of
    each gradient's entries by magnitude (ties at the threshold kept),
    carry the rest to the next step (error feedback), and run `tx` on
    the sparsified gradients. `rampup_begin_step` is accepted and
    unused, as in the JAX package."""

    def init(params):
        return DgcState(inner=tx.init(params), residual=_zeros(params))

    def update(params, grads, state, **kw):
        sent, resid = {}, {}
        for n, g in grads.items():
            acc = g + state.residual[n]
            flat = acc.abs().reshape(-1)
            k = max(1, int(flat.numel() * (1.0 - sparsity)))
            thresh = torch.topk(flat, k).values[-1]
            sent[n] = torch.where(acc.abs() >= thresh, acc, 0.0)
            resid[n] = acc - sent[n]
        new_p, new_inner = tx.update(params, sent, state.inner, **kw)
        return new_p, DgcState(new_inner, resid)

    return Transform(init, update)


def from_eager(opt):
    """The pure Transform of an eager optimizer of
    `paddle_tpu_torch.optimizer`. Carries its rule, weight decay, AdamW's
    `apply_decay_param_fun` (as `decay_mask`, called with the parameter
    names of the dictionaries the rule is given), a global-norm clip, and
    its schedule: the count form (`get_lr_traced`) where the schedule has
    one, else its current rate, frozen with a warning. Per-parameter
    rate multipliers and Lamb's exclusion function are not carried (a
    warning names the latter), as in the JAX package."""
    from . import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                   Momentum, RMSProp)
    from .lr import LRScheduler

    lr = opt._lr
    if isinstance(lr, LRScheduler):
        if type(lr).traceable() and lr.get_lr_traced(0) is not None:
            lrv = lr.get_lr_traced
        else:
            warnings.warn(
                f"{type(lr).__name__} has no count form; the functional "
                f"rule freezes its current lr={float(lr())}")
            lrv = float(lr())
    else:
        lrv = float(lr)
    wd = opt._decay_coeff()
    fn = getattr(opt, "_apply_decay_param_fun", None)
    decay_mask = None if fn is None else (lambda name: bool(fn(name)))

    if isinstance(opt, AdamW):
        tx = adamw(lrv, opt._beta1, opt._beta2, opt._eps, wd,
                   decay_mask=decay_mask)
    elif isinstance(opt, Adam):
        tx = adam(lrv, opt._beta1, opt._beta2, opt._eps, wd)
    elif isinstance(opt, Momentum):
        tx = momentum(lrv, opt._momentum, wd, opt._use_nesterov)
    elif isinstance(opt, Lamb):
        if opt._exclude_fn is not None:
            warnings.warn("Lamb's exclude_from_weight_decay_fn is not "
                          "carried into the functional rule")
        tx = lamb(lrv, opt._beta1, opt._beta2, opt._eps, wd)
    elif isinstance(opt, Adamax):
        tx = adamax(lrv, opt._beta1, opt._beta2, opt._eps)
    elif isinstance(opt, Adagrad):
        tx = adagrad(lrv, opt._eps)
    elif isinstance(opt, Adadelta):
        tx = adadelta(lrv, opt._eps, opt._rho)
    elif isinstance(opt, RMSProp):
        tx = rmsprop(lrv, opt._rho, opt._eps, opt._momentum, opt._centered)
    elif isinstance(opt, SGD):
        tx = sgd(lrv, wd)
    else:
        raise TypeError(f"no functional rule for {type(opt).__name__}")

    clip = opt._grad_clip
    if clip is not None:
        if isinstance(clip, _clip.ClipGradByGlobalNorm):
            tx = clip_by_global_norm(tx, clip.clip_norm)
        else:
            warnings.warn(
                f"grad_clip {type(clip).__name__} is not carried into the "
                f"functional rule; only ClipGradByGlobalNorm is")
    return tx
