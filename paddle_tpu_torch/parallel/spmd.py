"""The train step on one device (the JAX package's `SpmdTrainer`,
without a mesh or sharding).

One `step` is forward, backward and the optimizer update over the
layer's parameters, kept in float32 ("master" weights). Under
`compute_dtype` the forward runs on casts of the parameters and of the
float inputs to that type, through `torch.func.functional_call`, so the
gradients land on the float32 masters; the loss is averaged in float32.
The optimizer is an `optimizer.functional` Transform or an eager
optimizer of `paddle_tpu_torch.optimizer`, turned into its Transform by
`functional.from_eager` (rule, decay and its mask, global-norm clip,
schedule), as the JAX trainer does.

Buffers (BatchNorm's running stats) are not cast: they stay float32 on
the layer, and a training forward updates them in place outside
autograd, which is what the JAX trainer's buffer channel computes (the
new stats of each step, in float32, carried to the next). `buffers`
reads them; `eval_step` runs the inference branch on them.

All the randomness of a step flows from the trainer's `generator`, a CPU
torch.Generator: at construction the trainer binds it to every
`MultiHeadAttention` (each call draws its attention-dropout seed from
it, a host int, the same on every device) and binds every `Dropout` to a
generator on the trainer's device seeded from it (the hidden-dropout
masks).

`remat=True` runs the forward under `torch.utils.checkpoint` (not
reentrant): its activations are recomputed in the backward instead of
kept. `checkpoint` restores only torch's default generators, so the
trainer saves both of its own at the start of the forward and replays
them for the recompute, which then draws the same seeds and masks: the
gradients equal those without remat, bit for bit.

`grad_accum=N` splits each batch into N contiguous micro-batches (the
JAX trainer's ``x.reshape((N, b // N) + ...)``), runs forward and
backward on each in order, accumulates ``acc + g.float32 / N`` and the
loss as ``loss / N``, carries BatchNorm's buffers from one micro-batch
to the next, then updates once.

`moe_aux_weight` (0.01 by default, the JAX trainer's): every `MoELayer`
of the layer sets its load-balance `aux_loss` in the forward, and each
micro-batch's loss becomes ``loss + moe_aux_weight * sum(aux losses)``,
the objective the gradients are of and the loss the step returns (the
JAX trainer's). The aux losses are read right after the forward, before
the backward: under `remat` the recompute runs `forward` again and sets
them anew, but the loss already holds the first forward's, so each is
added once and its gradient reaches the router once. The recompute's aux
losses are kept detached: their graph would hold every recomputed
activation below them through the backward (on the card it raised
remat's peak above the plain step's).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..nn.layer.common import Dropout
from ..nn.layer.moe import MoELayer
from ..nn.layer.transformer import MultiHeadAttention
from ..optimizer import Optimizer
from ..optimizer import functional as fopt

__all__ = ["SpmdTrainer"]


def _dtype(d):
    """compute_dtype: None (float32 throughout) or bfloat16."""
    dt = getattr(torch, d, None) if isinstance(d, str) else d
    if dt not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                         f"{d!r}")
    return dt


def _as_tensor(x):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x))


class SpmdTrainer:
    """loss_fn(outputs, labels) -> scalar tensor; optimizer: an
    `optimizer.functional` Transform (e.g. `adamw(5e-5)`) or an eager
    optimizer (e.g. `optimizer.AdamW(...)`; only its settings are read,
    the trainer keeps its own state). Batches are (inputs tuple, labels)
    of tensors or numpy arrays, moved to the trainer's device."""

    def __init__(self, layer, loss_fn, optimizer, compute_dtype=None,
                 device=None, generator=None, remat=False, grad_accum=1,
                 moe_aux_weight=0.01):
        if isinstance(optimizer, Optimizer):
            optimizer = fopt.from_eager(optimizer)
        if not isinstance(optimizer, fopt.Transform):
            raise TypeError("SpmdTrainer takes an optimizer.functional "
                            "Transform or an eager optimizer of "
                            "paddle_tpu_torch.optimizer")
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.layer = layer.to(self.device)
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.compute_dtype = _dtype(compute_dtype)
        self.remat = bool(remat)
        self.grad_accum = int(grad_accum)
        self.moe_aux_weight = float(moe_aux_weight)
        self._moe = [m for m in self.layer.modules()
                     if isinstance(m, MoELayer)]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if generator.device.type != "cpu":
            raise ValueError("SpmdTrainer's generator must be a CPU "
                             "torch.Generator (attention-dropout seeds are "
                             "host ints)")
        self.generator = generator
        self._mask_gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2 ** 62, (), generator=generator)))
        for m in self.layer.modules():
            if isinstance(m, MultiHeadAttention):
                m.seed_generator = generator
            elif isinstance(m, Dropout):
                m.generator = self._mask_gen
        self.params = dict(self.layer.named_parameters())
        for n, p in self.params.items():
            if p.dtype != torch.float32:
                raise TypeError(f"parameter {n} is {p.dtype}: the trainer "
                                f"keeps float32 master weights")
        self.opt_state = self.tx.init(
            {n: p.detach() for n, p in self.params.items()})

    def _to_device(self, x):
        return None if x is None else _as_tensor(x).to(self.device)

    def _inputs(self, inputs):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        return tuple(self._to_device(x) for x in inputs)

    @property
    def buffers(self):
        """{name: buffer} of the layer (float32 under any compute_dtype),
        as the steps so far left them."""
        return dict(self.layer.named_buffers())

    def sync_to_layer(self):
        """The JAX trainer writes its state back into the Layer here; the
        port's parameters and buffers already live on the layer, so
        there is nothing to do."""

    def _apply_plain(self, inputs):
        cdt = self.compute_dtype
        if cdt is None:
            return self.layer(*inputs)
        params = {n: p.to(cdt) for n, p in self.params.items()}
        inputs = tuple(
            x.to(cdt) if x is not None and x.is_floating_point() else x
            for x in inputs)
        return torch.func.functional_call(self.layer, params, inputs)

    def _apply(self, inputs):
        if not self.remat:
            return self._apply_plain(inputs)
        gens = (self.generator, self._mask_gen)
        start = [g.get_state() for g in gens]
        runs = []

        def forward(*xs):
            runs.append(None)
            if len(runs) == 1:
                return self._apply_plain(xs)
            # the recompute: the forward's draws again, then the
            # generators back where the steps since left them
            now = [g.get_state() for g in gens]
            for g, st in zip(gens, start):
                g.set_state(st)
            try:
                return self._apply_plain(xs)
            finally:
                for g, st in zip(gens, now):
                    g.set_state(st)
                # the recompute set every aux loss anew; its graph reaches
                # back through every layer below and would keep all the
                # recomputed activations alive through the backward
                for m in self._moe:
                    if m.aux_loss is not None:
                        m.aux_loss = m.aux_loss.detach()

        return checkpoint(forward, *inputs, use_reentrant=False)

    def _forward_loss(self, inputs, labels):
        self.layer.train()
        for m in self._moe:
            m.aux_loss = None
        loss = self.loss_fn(self._apply(inputs), labels).float().mean()
        if self.moe_aux_weight and self._moe:
            loss = loss + self.moe_aux_weight * sum(
                m.aux_loss.float().reshape(()) for m in self._moe)
        return loss

    def eval_step(self, inputs):
        """The layer's inference forward (BatchNorm on its running stats,
        no update) under the trainer's compute_dtype, without gradients;
        returns the outputs."""
        inputs = self._inputs(inputs)
        self.layer.eval()
        try:
            with torch.no_grad():
                return self._apply_plain(inputs)
        finally:
            self.layer.train()

    def _one_batch(self, inputs, labels):
        names = list(self.params)
        loss = self._forward_loss(inputs, labels)
        grads = torch.autograd.grad(
            loss, [self.params[n] for n in names], allow_unused=True)
        return loss.detach(), [
            torch.zeros_like(self.params[n]) if g is None else g
            for n, g in zip(names, grads)]

    def loss_and_grads(self, inputs, labels):
        """Forward and backward on one batch (over `grad_accum`
        micro-batches) without the update: (loss, {name: float32
        gradient}). The loss is a float32 0-d tensor on the device, not
        synchronised."""
        inputs = self._inputs(inputs)
        labels = self._to_device(labels)
        names = list(self.params)
        n = self.grad_accum
        if n == 1:
            loss, grads = self._one_batch(inputs, labels)
            return loss, dict(zip(names, grads))
        b = labels.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into grad_accum="
                             f"{n} micro-batches")
        mb = b // n
        # a 0-d divisor on the device: CUDA takes a division by a Python
        # scalar as a product by its reciprocal, which rounds twice
        nt = torch.full((), float(n), device=self.device)
        acc, loss = None, None
        for i in range(n):
            sl = slice(i * mb, (i + 1) * mb)
            l_i, g = self._one_batch(
                tuple(None if x is None else x[sl] for x in inputs),
                labels[sl])
            g = torch._foreach_div([t.float() for t in g], nt)
            acc = g if acc is None else torch._foreach_add(acc, g)
            loss = l_i / nt if loss is None else loss + l_i / nt
        return loss, {k: a.to(self.params[k].dtype)
                      for k, a in zip(names, acc)}

    def step(self, inputs, labels):
        """One forward + backward + update; returns the loss."""
        loss, grads = self.loss_and_grads(inputs, labels)
        with torch.no_grad():
            names = list(self.params)
            new, self.opt_state = self.tx.update(
                {n: p.detach() for n, p in self.params.items()}, grads,
                self.opt_state)
            torch._foreach_copy_([self.params[n].detach() for n in names],
                                 [new[n] for n in names])
        return loss

    def run_steps(self, inputs, labels, n_steps):
        """n_steps updates on one batch; returns the last loss."""
        loss = None
        for _ in range(int(n_steps)):
            loss = self.step(inputs, labels)
        return loss

    def run_epoch(self, batches, chunk=8):
        """`step` over every (inputs, labels) of `batches`; returns the
        last loss. Batches are staged `chunk` at a time: on a card the
        next chunk is pinned on the host and copied on a side stream once
        the current chunk's first step is queued, so both overlap that
        chunk's steps on the card (the JAX trainer's double-buffered
        input), and the steps wait for that copy alone."""
        it = iter(batches)
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def host(x):
            t = _as_tensor(x)
            if cuda and t is not None and t.device.type == "cpu":
                return t.pin_memory()
            return t

        def copy(t):
            return None if t is None else t.to(self.device,
                                               non_blocking=True)

        def stage():
            items = [(tuple(host(x) for x in (
                inputs if isinstance(inputs, (list, tuple)) else (inputs,))),
                host(labels))
                for inputs, labels in itertools.islice(it, chunk)]
            if not cuda:
                return items
            with torch.cuda.stream(side):
                return [(tuple(copy(t) for t in x), copy(y))
                        for x, y in items]

        loss = None
        current = stage()
        while current:
            if cuda:
                main = torch.cuda.current_stream(self.device)
                main.wait_stream(side)
                for x, y in current:
                    for t in (*x, y):
                        if t is not None:
                            t.record_stream(main)
            # the chunk's first step is queued before the next chunk is
            # pinned and copied, so both run while the card works on it
            loss = self.step(*current[0])
            following = stage()
            for inputs, labels in current[1:]:
                loss = self.step(inputs, labels)
            current = following
        return loss
