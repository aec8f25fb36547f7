"""Optimizers of the port (the JAX package's `optimizer`): the eager
optimizers `SGD`, `Momentum`, `Adam`, `AdamW`, `Adamax`, `Adagrad`,
`Adadelta`, `RMSProp` and `Lamb` over torch Parameters and their
`.grad`; the schedules (`lr`); and the functional rules the trainer
applies (`functional`).

    opt = AdamW(LinearWarmup(PolynomialDecay(1e-4, 1000), 100, 0.0, 1e-4),
                parameters=model.named_parameters(),
                grad_clip=nn.ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda name: not (
                    name.endswith("bias") or "norm" in name))
    loss.backward(); opt.step(); opt.clear_grad()

**Names.** `parameters=` takes Parameters, or `(name, Parameter)` pairs
such as `model.named_parameters()`. A torch Parameter has no name of
its own, so the pair's name is what AdamW's `apply_decay_param_fun` and
Lamb's `exclude_from_weight_decay_fn` receive (the JAX package passes
`p.name`) and what `state_dict()` keys the slots by
(``"{name}__{slot}"``); a bare Parameter is named by its position.

`step()` runs one multi-tensor sweep over the dense parameters
(`optimizer/fused.py`) or, on the way back the JAX package keeps, the
same functional rule one parameter at a time; both give the same bits.
A Parameter's `optimize_attr = {"learning_rate": m}` scales its rate;
`multi_precision=True` (Momentum, Adam, AdamW) keeps a float32
`master_weight` slot for each bf16 or fp16 parameter and rounds its
update into the parameter.

Refused, where the JAX package would act otherwise: an `L1Decay` weight
decay (the JAX optimizers decay it as L2), and a weight decay on Adamax,
Adagrad, Adadelta or RMSProp (their rules apply none).

**Sparse gradients.** A parameter whose `.grad` is row-sparse (a torch
sparse COO tensor, as `nn.Embedding(sparse=True)` gives) takes its
optimizer's sparse rule, the JAX package's (`_sgd_sparse_rule`,
`_momentum_sparse_rule` with Nesterov, `_adam_sparse_rule`, whose
moments decay on every row, and Adam's and AdamW's `lazy_mode`, which
reads and writes only the touched rows of the parameter and of both
moments); the dense parameters of the same step still take the
multi-tensor path. The rows are merged first (`SelectedRows.merge`: a
stable sort, each row's values summed in their order), and each rule
writes its unique rows by gather, update and scatter, never by an
atomic add, so a step repeats bit for bit on the card. As in JAX, a
weight decay or a `grad_clip` over a sparse gradient raises, so does
`multi_precision`, and the other optimizers raise naming the rule they
lack.
"""
from __future__ import annotations

import numpy as np
import torch

from ..regularizer import L1Decay
from ..sparse import SelectedRows
from . import functional
from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "lr", "functional"]


def _named(parameters):
    """([Parameter, ...], [name, ...]) from Parameters or (name,
    Parameter) pairs; a bare Parameter is named by its position."""
    params, names = [], []
    for i, item in enumerate(parameters or ()):
        if isinstance(item, tuple):
            name, p = item
        else:
            name, p = str(i), item
        params.append(p)
        names.append(str(name))
    return params, names


class Optimizer:
    # the functional rule of a concrete optimizer: its slot names (in the
    # state tuple's order), the state tuple and the rule's factory
    _fused_slots = ()
    _fused_state_cls = None
    _takes_weight_decay = True
    _multi_precision = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(weight_decay, L1Decay):
            raise ValueError(
                "L1Decay is not supported as an optimizer's weight_decay: "
                "the JAX optimizers read only its coefficient and decay it "
                "as L2; pass L2Decay or a float")
        if not self._takes_weight_decay and weight_decay:
            raise ValueError(f"{type(self).__name__} applies no weight "
                             f"decay; got weight_decay={weight_decay!r}")
        self._lr = learning_rate
        self._parameters, self._names = _named(parameters)
        self._name_of = {id(p): n for p, n in zip(self._parameters,
                                                  self._names)}
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}  # id(param) -> {slot: tensor}
        self._step_count = 0

    # ------------------------------------------------------------ lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError(
                "optimizer's learning rate can't be LRScheduler when "
                "invoke this API, because this will lead to conflict")
        self._lr = float(value)

    @staticmethod
    def _mult(p):
        """The Parameter's rate multiplier (`optimize_attr`)."""
        attr = getattr(p, "optimize_attr", None)
        return float(attr.get("learning_rate", 1.0)) if attr else 1.0

    def _lr_for(self, p):
        """The rate of `p` in float32: f32(lr) * f32(multiplier), as the
        multi-tensor path computes it for p's group."""
        f32 = functional.f32
        return f32(f32(self.get_lr()) * f32(self._mult(p)))

    # -------------------------------------------------------- decay
    def _decay_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "coeff", wd))

    def _decay_value(self, p):
        return self._decay_coeff()

    # ------------------------------------------------------- slots
    def _mp_enabled(self, p):
        """True when `p` trains against a float32 master weight."""
        return bool(self._multi_precision) and p.dtype in (torch.bfloat16,
                                                           torch.float16)

    def _slot_init(self, p, slot):
        return torch.zeros(p.shape, device=p.device,
                           dtype=torch.float32 if self._mp_enabled(p)
                           else p.dtype)

    def _slots(self, p):
        slots = self._accumulators.get(id(p))
        if slots is None:
            slots = self._accumulators[id(p)] = {
                k: self._slot_init(p, k) for k in self._fused_slots}
        if self._mp_enabled(p) and "master_weight" not in slots:
            slots["master_weight"] = p.detach().float()
        return slots

    def state_dict(self):
        out = {"_step_count": self._step_count}
        for p, name in zip(self._parameters, self._names):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                out[f"{name}__{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Load `state_dict()`'s slots (tensors or numpy arrays) by name;
        a parameter whose name has no slot in `state` takes the slots of
        the saved parameter at its position (the JAX package's fallback,
        which loads a checkpoint whose names differ, such as one
        converted from the JAX package)."""
        self._step_count = state.get("_step_count", 0)
        saved = []
        for k in state:
            if isinstance(k, str) and "__" in k and k not in (
                    "_step_count", "LR_Scheduler"):
                pre = k.rsplit("__", 1)[0]
                if pre not in saved:
                    saved.append(pre)
        for i, (p, name) in enumerate(zip(self._parameters, self._names)):
            prefix = f"{name}__"
            if not any(isinstance(k, str) and k.startswith(prefix)
                       for k in state) and i < len(saved):
                prefix = saved[i] + "__"
            for k, v in state.items():
                if isinstance(k, str) and k.startswith(prefix):
                    if not isinstance(v, torch.Tensor):
                        v = torch.from_numpy(np.array(v))
                    self._accumulators.setdefault(id(p), {})[
                        k[len(prefix):]] = v.to(p.device)
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])

    set_dict = set_state_dict

    # -------------------------------------------------------- step
    def _fused_tx(self, lrv, wd):
        raise NotImplementedError

    def _collect(self):
        """This step's (param, grad) pairs, split into (dense, sparse)."""
        dense, sparse = [], []
        for p in self._parameters:
            if not p.requires_grad or p.grad is None:
                continue
            (dense if p.grad.layout == torch.strided else sparse).append(
                (p, p.grad))
        return dense, sparse

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        dense, sparse = self._collect()
        if self._grad_clip is not None and sparse:
            raise NotImplementedError(
                "grad_clip over sparse (SelectedRows) gradients is not "
                "supported; clip densely or drop the clip")
        if dense:
            from . import fused

            if fused.supported(self) and \
                    len({id(p) for p, _ in dense}) == len(dense):
                fused.apply(self, dense)
            else:
                pg = self._grad_clip(dense) if self._grad_clip is not None \
                    else dense
                for p, g in pg:
                    self._update_param(p, g)
        for p, g in sparse:
            if g.layout != torch.sparse_coo or g.sparse_dim() != 1:
                raise NotImplementedError(
                    f"only row-sparse gradients (a sparse COO tensor with "
                    f"one sparse dim, as nn.Embedding(sparse=True) gives) "
                    f"have sparse rules; got {g.layout} with "
                    f"{g.sparse_dim()} sparse dims")
            if self._decay_value(p):
                raise ValueError(
                    "weight_decay/regularization is not supported with "
                    "sparse (SelectedRows) gradients, as in the reference's "
                    "lookup_table is_sparse=True")
            if self._mp_enabled(p):
                raise NotImplementedError(
                    "multi_precision is not supported with sparse "
                    "(SelectedRows) gradients")
            g = SelectedRows(g).merge()
            self._update_param_sparse(p, g.rows, g.values.to(p.dtype),
                                      self._lr_for(p))

    def _update_param_sparse(self, p, rows, vals, lr):
        """The sparse rule: parameter `p` (updated in place) at merged
        `rows` (unique, ascending) with their gradient `vals`, at rate
        `lr`, in the JAX rule's order of operations."""
        raise NotImplementedError(
            f"{type(self).__name__} has no sparse (SelectedRows) update "
            f"rule; use SGD/Momentum/Adam for sparse embedding training")

    def _update_param(self, p, g):
        """The per-parameter path: the functional rule on one tensor."""
        self._run_rule([p], [g], self._lr_for(p), self._decay_value(p))

    def _run_rule(self, params, grads, lrv, wd):
        """One functional update of `params` (a list) at rate `lrv` and
        decay `wd`: slots and master weights read and written back, each
        parameter written in place."""
        keys = [str(i) for i in range(len(params))]
        slots = [self._slots(p) for p in params]
        bases = {k: s["master_weight"] if self._mp_enabled(p)
                 else p.detach() for k, p, s in zip(keys, params, slots)}
        state = self._fused_state_cls(
            self._step_count - 1,
            *[{k: s[n] for k, s in zip(keys, slots)}
              for n in self._fused_slots])
        new_p, new_state = self._fused_tx(lrv, wd).update(
            bases, dict(zip(keys, grads)), state)
        for j, n in enumerate(self._fused_slots):
            for k, s in zip(keys, slots):
                s[n] = new_state[j + 1][k]
        for k, p, s in zip(keys, params, slots):
            if self._mp_enabled(p):
                s["master_weight"] = new_p[k]
        torch._foreach_copy_([p.detach() for p in params],
                             [new_p[k] for k in keys])

    @property
    def _parameter_list(self):
        return self._parameters

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (set_to_zero is accepted and
        ignored, as in the JAX package)."""
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward (unless the parameters already hold gradients), then
        step. Returns (None, None)."""
        if all(p.grad is None for p in self._parameters
               if p.requires_grad):
            loss.backward()
        self.step()
        return None, None


class SGD(Optimizer):
    _fused_state_cls = functional.ScaleState

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _fused_tx(self, lrv, wd):
        return functional.sgd(lrv, wd)

    def _update_param_sparse(self, p, rows, vals, lr):
        """p[rows] -= lr * g (`_sgd_sparse_rule`)."""
        p[rows] = p[rows] - vals * lr


class Momentum(Optimizer):
    _fused_slots = ("velocity",)
    _fused_state_cls = functional.MomentumState

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._multi_precision = bool(multi_precision)

    def _fused_tx(self, lrv, wd):
        return functional.momentum(lrv, self._momentum, wd,
                                   self._use_nesterov)

    def _update_param_sparse(self, p, rows, vals, lr):
        """`_momentum_sparse_rule`: v = mu * v on every row, + g on its
        rows; p -= lr * v (Nesterov: p -= lr * mu * v on every row, then
        lr * g on the gradient's rows)."""
        vel = self._slots(p)["velocity"]
        mu = self._momentum
        vel.mul_(mu)
        vel[rows] = vel[rows] + vals
        if self._use_nesterov:
            p.sub_(vel * (lr * mu))
            p[rows] = p[rows] - vals * lr
        else:
            p.sub_(vel * lr)


class Adam(Optimizer):
    _decoupled_wd = False
    _fused_slots = ("moment1", "moment2")
    _fused_state_cls = functional.AdamState

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)    # sparse gradients only
        self._multi_precision = bool(multi_precision)

    def _fused_tx(self, lrv, wd):
        return functional.adam(lrv, self._beta1, self._beta2, self._eps,
                               wd, decoupled=self._decoupled_wd)

    def _update_param_sparse(self, p, rows, vals, lr):
        """`_adam_sparse_rule` (m and v decay on every row, the gradient
        adds on its rows, every row moves) or, with `lazy_mode`,
        `_adam_sparse_lazy_rule` (only the gradient's rows of p, m and v
        are read and written)."""
        slots = self._slots(p)
        m, v = slots["moment1"], slots["moment2"]
        b1, b2, eps = self._beta1, self._beta2, self._eps
        t = self._step_count
        c1 = functional.bias_correction(b1, t)
        c2 = functional.bias_correction(b2, t)
        if self._lazy_mode:
            m_r = m[rows] * b1 + vals * (1 - b1)
            v_r = v[rows] * b2 + vals * (1 - b2) * vals
            den = functional._div([v_r], c2)[0].sqrt_().add_(eps)
            upd = functional._div([m_r], c1)[0].mul_(lr).div_(den)
            p[rows] = p[rows] - upd
            m[rows] = m_r
            v[rows] = v_r
            return
        m.mul_(b1)
        m[rows] = m[rows] + vals * (1 - b1)
        v.mul_(b2)
        v[rows] = v[rows] + vals * (1 - b2) * vals
        den = functional._div([v], c2)[0].sqrt_().add_(eps)
        p.sub_(functional._div([m], c1)[0].mul_(lr).div_(den))


class AdamW(Adam):
    """Adam with decoupled weight decay; `apply_decay_param_fun(name)`
    limits the decay to the parameters it accepts."""
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 apply_decay_param_fun=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_value(self, p):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._name_of[id(p)]):
            return 0.0
        return super()._decay_value(p)


class Adamax(Optimizer):
    _fused_slots = ("moment", "inf_norm")
    _fused_state_cls = functional.AdamaxState
    _takes_weight_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _fused_tx(self, lrv, wd):
        return functional.adamax(lrv, self._beta1, self._beta2, self._eps)


class Adagrad(Optimizer):
    """`initial_accumulator_value` fills the moment slot (the JAX package
    stores it and starts from zeros)."""
    _fused_slots = ("moment",)
    _fused_state_cls = functional.AdagradState
    _takes_weight_decay = False

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = float(initial_accumulator_value)

    def _slot_init(self, p, slot):
        return super()._slot_init(p, slot).fill_(self._init_acc)

    def _fused_tx(self, lrv, wd):
        return functional.adagrad(lrv, self._eps)


class Adadelta(Optimizer):
    _fused_slots = ("avg_sq_grad", "avg_sq_upd")
    _fused_state_cls = functional.AdadeltaState
    _takes_weight_decay = False

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps, self._rho = epsilon, rho

    def _fused_tx(self, lrv, wd):
        return functional.adadelta(lrv, self._eps, self._rho)


class RMSProp(Optimizer):
    _fused_slots = ("mean_square", "mean_grad", "momentum")
    _fused_state_cls = functional.RmspropState
    _takes_weight_decay = False

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _fused_tx(self, lrv, wd):
        return functional.rmsprop(lrv, self._rho, self._eps,
                                  self._momentum, self._centered)


class Lamb(Optimizer):
    """`exclude_from_weight_decay_fn(name)` exempts the parameters it
    accepts from the decay."""
    _fused_slots = ("moment1", "moment2")
    _fused_state_cls = functional.AdamState

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_value(self, p):
        if self._exclude_fn is not None and \
                self._exclude_fn(self._name_of[id(p)]):
            return 0.0
        return super()._decay_value(p)

    def _fused_tx(self, lrv, wd):
        return functional.lamb(lrv, self._beta1, self._beta2, self._eps,
                               wd)
