"""The train step on one device (the JAX package's `SpmdTrainer`,
without a mesh or sharding).

One `step` is forward, backward and the optimizer update over the
layer's parameters, kept in float32 ("master" weights). Under
`compute_dtype` the forward runs on casts of the parameters and of the
float inputs to that type, through `torch.func.functional_call`, so the
gradients land on the float32 masters; the loss is averaged in float32.

All the randomness of a step flows from the trainer's `generator`, a CPU
torch.Generator: at construction the trainer binds it to every
`MultiHeadAttention` (each call draws its attention-dropout seed from
it, a host int, the same on every device) and binds every `Dropout` to a
generator on the trainer's device seeded from it (the hidden-dropout
masks). Remat, gradient accumulation, LR schedules and the mesh belong
to later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn.layer.common import Dropout
from ..nn.layer.transformer import MultiHeadAttention
from ..optimizer import functional as fopt

__all__ = ["SpmdTrainer"]

def _dtype(d):
    """compute_dtype: None (float32 throughout) or bfloat16."""
    dt = getattr(torch, d, None) if isinstance(d, str) else d
    if dt not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                         f"{d!r}")
    return dt


class SpmdTrainer:
    """loss_fn(outputs, labels) -> scalar tensor; optimizer: a
    `optimizer.functional` Transform (e.g. `adamw(5e-5)`). Batches are
    (inputs tuple, labels) of tensors or numpy arrays, moved to the
    trainer's device."""

    def __init__(self, layer, loss_fn, optimizer, compute_dtype=None,
                 device=None, generator=None):
        if not isinstance(optimizer, fopt.Transform):
            raise TypeError("SpmdTrainer takes an optimizer.functional "
                            "Transform (e.g. adamw(5e-5)); the eager "
                            "optimizers belong to a later slice")
        self.device = resolve_device(device)
        self.layer = layer.to(self.device)
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.compute_dtype = _dtype(compute_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if generator.device.type != "cpu":
            raise ValueError("SpmdTrainer's generator must be a CPU "
                             "torch.Generator (attention-dropout seeds are "
                             "host ints)")
        self.generator = generator
        mask_gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2 ** 62, (), generator=generator)))
        for m in self.layer.modules():
            if isinstance(m, MultiHeadAttention):
                m.seed_generator = generator
            elif isinstance(m, Dropout):
                m.generator = mask_gen
        self.params = dict(self.layer.named_parameters())
        for n, p in self.params.items():
            if p.dtype != torch.float32:
                raise TypeError(f"parameter {n} is {p.dtype}: the trainer "
                                f"keeps float32 master weights")
        self.opt_state = self.tx.init(
            {n: p.detach() for n, p in self.params.items()})

    def _to_device(self, x):
        if x is None:
            return None
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    def _forward_loss(self, inputs, labels):
        self.layer.train()
        cdt = self.compute_dtype
        if cdt is None:
            out = self.layer(*inputs)
        else:
            params = {n: p.to(cdt) for n, p in self.params.items()}
            inputs = tuple(
                x.to(cdt) if x is not None and x.is_floating_point() else x
                for x in inputs)
            out = torch.func.functional_call(self.layer, params, inputs)
        return self.loss_fn(out, labels).float().mean()

    def loss_and_grads(self, inputs, labels):
        """Forward and backward on one batch without the update: (loss,
        {name: float32 gradient}). The loss is a float32 0-d tensor on
        the device, not synchronised."""
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        inputs = tuple(self._to_device(x) for x in inputs)
        labels = self._to_device(labels)
        names = list(self.params)
        loss = self._forward_loss(inputs, labels)
        grads = torch.autograd.grad(
            loss, [self.params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss.detach(), grads

    def step(self, inputs, labels):
        """One forward + backward + update; returns the loss."""
        loss, grads = self.loss_and_grads(inputs, labels)
        with torch.no_grad():
            new, self.opt_state = self.tx.update(
                {n: p.detach() for n, p in self.params.items()}, grads,
                self.opt_state)
            for n, p in self.params.items():
                p.copy_(new[n])
        return loss

    def run_steps(self, inputs, labels, n_steps):
        """n_steps updates on one batch; returns the last loss."""
        loss = None
        for _ in range(int(n_steps)):
            loss = self.step(inputs, labels)
        return loss
