"""Learning-rate schedules (the JAX package's `optimizer/lr.py`, the
reference's python/paddle/optimizer/lr.py): `LRScheduler` and its 14
schedules.

Each schedule has two forms:

- the host form, `step()` / `get_lr()` / `sched()`, a function of
  `last_epoch` in float64 Python, stepped by the caller; an eager
  optimizer reads `sched()` at each `step()`;
- the count form, `get_lr_traced(count)`, a function of an optimizer's
  step count that computes in float32, operation for operation as the
  JAX package's traced form does, and returns that float32 value as a
  Python float. `optimizer.functional` rules call it with the count
  before the increment (`from_eager` hands it to them). `LambdaDecay`,
  `ReduceOnPlateau`, `OneCycleLR` and `CyclicLR` have no count form
  (`traceable()` is False), nor has a `LinearWarmup` over one of them
  (its `get_lr_traced` returns None).

`state_dict()` / `set_state_dict()` carry `last_epoch` and `last_lr`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "ReduceOnPlateau", "CosineAnnealingDecay", "OneCycleLR",
           "CyclicLR"]


def _f32(x):
    """A float32 0-d CPU tensor: the count form's arithmetic type (a
    Python scalar beside it enters as float32, as a weakly typed scalar
    does in JAX)."""
    return torch.tensor(x, dtype=torch.float32)


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def get_lr_traced(self, count):
        """The schedule at step count `count` in float32 (None: no count
        form)."""
        return None

    @classmethod
    def traceable(cls):
        return cls.get_lr_traced is not LRScheduler.get_lr_traced

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", self.last_epoch)
        self.last_lr = state.get("last_lr", self.last_lr)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * (self.warmup_steps ** -1.5))

    def get_lr_traced(self, count):
        step = _f32(max(count, 1))
        return float(self.base_lr * (self.d_model ** -0.5) * torch.minimum(
            step ** -0.5, step * (self.warmup_steps ** -1.5)))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]

    def get_lr_traced(self, count):
        idx = sum(int(count >= b) for b in self.boundaries)
        return float(_f32(self.values)[idx])


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)

    def get_lr_traced(self, count):
        return float(self.base_lr * torch.exp(-self.gamma * _f32(count)))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)

    def get_lr_traced(self, count):
        # a tensor numerator: `float / tensor` is a reciprocal and a product
        return float(torch.div(_f32(self.base_lr),
                              1 + self.gamma * _f32(count)))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - step / decay_steps) ** self.power) + self.end_lr

    def get_lr_traced(self, count):
        step = _f32(count)
        if self.cycle:
            div = torch.clamp(torch.ceil(step / self.decay_steps), min=1.0)
            decay_steps = self.decay_steps * div
        else:
            decay_steps = float(self.decay_steps)
            step = torch.clamp(step, max=decay_steps)
        return float((self.base_lr - self.end_lr) * (
            (1 - step / decay_steps) ** self.power) + self.end_lr)


class LinearWarmup(LRScheduler):
    """Linear warmup from `start_lr` to `end_lr` over `warmup_steps`,
    then `learning_rate` (a float or an inner schedule). Past the warmup
    the host form steps the inner schedule to `last_epoch -
    warmup_steps` on every `get_lr()` (the reference's side effect)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(
            learning_rate if isinstance(learning_rate, float) else end_lr,
            last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return float(self.lr)

    def get_lr_traced(self, count):
        cf = _f32(count)
        warm = (self.end_lr - self.start_lr) * (
            cf / self.warmup_steps) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            if not type(self.lr).traceable():
                return None
            after = self.lr.get_lr_traced(max(count - self.warmup_steps, 0))
        else:
            after = float(self.lr)
        return float(warm if count < self.warmup_steps else _f32(after))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)

    def get_lr_traced(self, count):
        return float(self.base_lr * (self.gamma ** _f32(count)))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)

    def get_lr_traced(self, count):
        n = _f32(sum(int(count >= m) for m in self.milestones))
        return float(self.base_lr * (self.gamma ** n))


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch //
                                              self.step_size))

    def get_lr_traced(self, count):
        return float(self.base_lr * (self.gamma ** _f32(
            count // self.step_size)))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    """Scale the rate by `factor` once `metrics` (passed to `step`) has
    not improved for more than `patience` steps. Its `state_dict` also
    carries the best metric and the two counters (the JAX package's
    carries only the rate), so a restored schedule continues as the
    saved one would."""

    _state_keys = ("best", "num_bad", "cooldown_counter")

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        v = float(metrics)
        better = (self.best is None or
                  (v < self.best - abs(self.best) * self.threshold
                   if self.mode == "min" else
                   v > self.best + abs(self.best) * self.threshold)
                  if self.threshold_mode == "rel" else
                  (v < self.best - self.threshold if self.mode == "min"
                   else v > self.best + self.threshold))
        if self.best is None or better:
            self.best = v
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def get_lr(self):
        return self.last_lr

    def state_dict(self):
        out = super().state_dict()
        out.update({k: getattr(self, k) for k in self._state_keys})
        return out

    def set_state_dict(self, state):
        super().set_state_dict(state)
        for k in self._state_keys:
            setattr(self, k, state.get(k, getattr(self, k)))

    set_dict = set_state_dict


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2

    def get_lr_traced(self, count):
        return float(self.eta_min + (self.base_lr - self.eta_min) * (
            1 + torch.cos(math.pi * _f32(count) / self.T_max)) / 2)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        up = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = (step - up) / max(self.total_steps - up, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (
            1 + math.cos(math.pi * pct)) / 2


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1.0 - (pos - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp * pct
