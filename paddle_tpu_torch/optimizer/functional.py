"""Pure optimizer rules over {name: tensor} dictionaries (the JAX
package's `optimizer/functional.py`): `init(params) -> state` and
`update(params, grads, state) -> (new_params, new_state)`.

`adam` / `adamw` keep the JAX package's arithmetic step for step: the
bias corrections c1 = 1 - beta1^t and c2 = 1 - beta2^t in float32, the
decoupled decay added to the update (`m_hat / (sqrt(v_hat) + eps) +
wd * p`), then `p - lr * update`. Each rule is plain torch ops per
tensor; the fused optimizer step belongs to a later slice.
"""
from __future__ import annotations

import collections

import torch

__all__ = ["Transform", "AdamState", "adam", "adamw"]

Transform = collections.namedtuple("Transform", ["init", "update"])
AdamState = collections.namedtuple("AdamState", ["count", "m", "v"])


def _f32_pow(base, t):
    """base ** t in float32, as a Python float (a host number, so the
    update never waits for the device)."""
    return float(torch.tensor(base, dtype=torch.float32)
                 ** torch.tensor(float(t), dtype=torch.float32))


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
         weight_decay=0.0, decoupled=False, decay_mask=None):
    """Adam, or AdamW with `decoupled`. `decay_mask(name) -> bool`
    limits the weight decay to the parameters it accepts (all of them
    when None)."""
    if callable(learning_rate):
        raise NotImplementedError("learning-rate schedules come with a "
                                  "later slice; pass a float")

    def init(params):
        return AdamState(
            count=0,
            m={n: torch.zeros_like(p) for n, p in params.items()},
            v={n: torch.zeros_like(p) for n, p in params.items()})

    def update(params, grads, state):
        t = state.count + 1
        c1 = 1.0 - _f32_pow(beta1, t)
        c2 = 1.0 - _f32_pow(beta2, t)
        new_p, new_m, new_v = {}, {}, {}
        for n, p in params.items():
            dm = 1.0 if decay_mask is None or decay_mask(n) else 0.0
            wd_c = 0.0 if decoupled else weight_decay * dm
            wd_d = weight_decay * dm if decoupled else 0.0
            g = grads[n].to(p.dtype)
            if wd_c:
                g = g + wd_c * p
            m = beta1 * state.m[n] + (1 - beta1) * g
            v = beta2 * state.v[n] + (1 - beta2) * (g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + epsilon)
            if wd_d:
                upd = upd + wd_d * p
            new_p[n] = p - learning_rate * upd
            new_m[n], new_v[n] = m, v
        return new_p, AdamState(t, new_m, new_v)

    return Transform(init, update)


def adamw(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
          weight_decay=0.01, decay_mask=None):
    return adam(learning_rate, beta1, beta2, epsilon, weight_decay,
                decoupled=True, decay_mask=decay_mask)
