"""The train step (the JAX package's `SpmdTrainer`), on one device or,
with `mesh=`, on every rank of a mesh.

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
trainer saves all of its own (the seeds', the masks' and, under tp, the
split feed-forward's) at the start of the forward and replays them for
the recompute, which then draws the same seeds and masks: the gradients
equal those without remat, bit for bit.

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

On a mesh (`mesh=`, `rules=`, `batch_axes=`) every rank runs the
trainer's entry points, each on its own device (the JAX trainer is one
process driving every device):

* the batch splits over `batch_axes` (the ones the mesh holds more than
  once): a rank takes its rows of each micro-batch (`shard_batch`), and
  its gradients are summed over those axes and divided by their ranks,
  the mean over the global batch; the loss returned is the global one;
* `rules` split parameters over the other axes (`layers.shard_layer`:
  Megatron's tensor parallelism over tp, the experts over ep); the
  trainer then works on a copy of the layer holding this rank's blocks,
  and `sync_to_layer` gathers the full parameters back into the layer it
  was given. The optimizer's slots take their parameter's block (the
  JAX trainer's "ZeRO-lite"), and a global-norm clip and Lamb's and
  LARS's trust ratios take the norms of the whole parameters (the
  optimizer's `reduce_sq`). The parameters' and
  gradients' other axes are replicas: every rank of them computes the
  same update;
* every batch norm normalises with the statistics of the global batch
  (the JAX program's, which XLA computes over the mesh), and every MoE
  layer routes over it;
* the attention dropout of a rank draws the bits of its rows and heads
  of the one-device call (`MultiHeadAttention.dropout_shard`), and the
  hidden dropout masks of a batch rank differ from its peers' (seeded by
  its batch index; ranks that hold the same activations draw the same
  masks, and a tensor-parallel rank draws its own mask of the feed-
  forward's split activations).

With every axis of size one (world size 1) the trainer is the
one-device trainer, bit for bit.
"""
from __future__ import annotations

import copy
import itertools

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..nn.layer.common import Dropout, _BatchNormBase
from ..nn.layer.moe import MoELayer
from ..nn.layer.transformer import MultiHeadAttention, TransformerEncoderLayer
from ..optimizer import Optimizer
from ..optimizer import functional as fopt
from .collectives import all_gather_cat
from .layers import ColumnParallelLinear, batch_axes_of, shard_layer
from .mesh import get_mesh
from .sharding import Sharding, batch_sharding

__all__ = ["SpmdTrainer", "spmd_data_parallel"]

#: bytes of one bucket of the data-parallel gradient all-reduce
_BUCKET_BYTES = 25 * 1024 * 1024


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
                 moe_aux_weight=0.01, mesh=None, rules=None,
                 batch_axes=("dp",)):
        if mesh is None and dist.is_initialized():
            mesh = get_mesh()
        if mesh is not None:
            if device is None:
                device = mesh.device
            elif resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
        if isinstance(optimizer, Optimizer):
            optimizer = fopt.from_eager(optimizer)
        if not isinstance(optimizer, fopt.Transform):
            raise TypeError("SpmdTrainer takes an optimizer.functional "
                            "Transform or an eager optimizer of "
                            "paddle_tpu_torch.optimizer")
        if int(grad_accum) < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules
        self.batch_axes = tuple(batch_axes)
        self._user_layer = layer.to(self.device)
        self.layer = self._user_layer
        self._bax = () if mesh is None else batch_axes_of(mesh, batch_axes)
        self.param_shardings = {}
        if mesh is not None and mesh.size > 1:
            split = any(Sharding(mesh, rules.spec_for(n, p.ndim)).is_split
                        for n, p in self.layer.named_parameters()) \
                if rules is not None else False
            if split:
                self.layer = copy.deepcopy(self._user_layer)
            self.param_shardings = shard_layer(self.layer, mesh, rules,
                                               batch_axes)
            if self._bax:
                group = mesh.group_of(self._bax)
                for m in self.layer.modules():
                    if isinstance(m, _BatchNormBase):
                        m._sync_group = group
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
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        # a batch rank's hidden-dropout masks differ from its peers'; the
        # ranks holding the same activations (tp / ep peers) draw alike
        bidx = self.mesh.coord(self._bax) if self._bax else 0
        self._mask_gen = torch.Generator(device=self.device).manual_seed(
            (seed + bidx * 0x9E3779B97F4A7C15) % 2 ** 62)
        #: the masks of the feed-forward's activations where they are
        #: split over tp (each rank draws its own of its columns)
        self._split_gen = None
        for m in self.layer.modules():
            if isinstance(m, MultiHeadAttention):
                m.seed_generator = generator
            elif isinstance(m, Dropout):
                m.generator = self._mask_gen
        for m in self.layer.modules():
            if isinstance(m, TransformerEncoderLayer) and isinstance(
                    m.linear1, ColumnParallelLinear):
                if self._split_gen is None:
                    tidx = self.mesh.coord("tp") + 1
                    self._split_gen = torch.Generator(
                        device=self.device).manual_seed(
                        (seed + bidx * 0x9E3779B97F4A7C15
                         + tidx * 0xBF58476D1CE4E5B9) % 2 ** 62)
                m.dropout_act.generator = self._split_gen
        self.params = dict(self.layer.named_parameters())
        #: {name: group its blocks are spread over} of the split parameters
        self._split_groups = {
            n: self.mesh.group_of(sh.axes())
            for n, sh in self.param_shardings.items()
            if n in self.params and sh.is_split}
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
        """Write the trained state back into the layer the trainer was
        given. Unsharded, the parameters and buffers already live there;
        with split parameters each is gathered from the ranks' blocks
        (collective: every rank calls it)."""
        if self.layer is self._user_layer:
            return
        own = {**dict(self._user_layer.named_parameters()),
               **dict(self._user_layer.named_buffers())}
        with torch.no_grad():
            for n, p in self.params.items():
                sh = self.param_shardings.get(n)
                full = sh.gather(p.detach()) if sh is not None and \
                    sh.is_split else p.detach()
                own[n].copy_(full)
            for n, b in self.layer.named_buffers():
                if n in own:
                    own[n].copy_(b)

    def full_params(self):
        """{name: full parameter}: the blocks gathered (collective), the
        rest as they are."""
        out = {}
        for n, p in self.params.items():
            sh = self.param_shardings.get(n)
            out[n] = sh.gather(p.detach()) if sh is not None and \
                sh.is_split else p.detach()
        return out

    # ---------------------------------------------------------- the mesh
    def _batch_group(self):
        return self.mesh.group_of(self._bax) if self._bax else None

    def _batch_parts(self):
        n = 1
        for a in self._bax:
            n *= self.mesh.axis_size(a)
        return n

    def _local_rows(self, x, acc=None):
        """This rank's rows of a global batch array: of each of the `acc`
        (default `grad_accum`) micro-batches, the slice of its batch
        index."""
        t = _as_tensor(x)
        if t is None or not self._bax:
            return t
        n, i = self._batch_parts(), self.mesh.coord(self._bax)
        acc = self.grad_accum if acc is None else acc
        b = t.shape[0]
        if b % (n * acc):
            raise ValueError(f"batch {b} does not split over {n} batch ranks "
                             f"x grad_accum={acc}")
        mb = b // (n * acc)
        t = t.reshape((acc, n, mb) + tuple(t.shape[1:]))[:, i]
        return t.reshape((acc * mb,) + tuple(t.shape[2:]))

    def shard_batch(self, *arrays):
        """This rank's rows of host batch arrays, on its device (the JAX
        trainer places them over the mesh, the leading dim over the
        batch axes)."""
        return tuple(self._to_device(self._local_rows(a)) for a in arrays)

    def batch_sharding(self, leading=0):
        """The Sharding of a batch input over the batch axes (with this
        trainer's micro-batch interleave: `shard` gives `shard_batch`'s
        rows)."""
        sh = batch_sharding(self.mesh, self.batch_axes, leading) \
            if self.mesh is not None else None
        if sh is None:
            return None
        trainer = self

        class _Rows(Sharding):
            def shard(self, full):
                return trainer._local_rows(full)

        return _Rows(self.mesh, sh.spec)

    def _reduce_grads(self, grads):
        """Sum each gradient over the batch axes its parameter is not split
        on, in float32 buckets, and divide by the batch ranks: the mean
        gradient of the global batch."""
        if not self._bax:
            return grads
        n = self._batch_parts()
        groups = {}
        for name, g in grads.items():
            sh = self.param_shardings.get(name)
            axes = tuple(a for a in self._bax
                         if sh is None or a not in sh.axes())
            groups.setdefault(axes, []).append(name)
        out = dict(grads)
        for axes, names in groups.items():
            group = self.mesh.group_of(axes)
            bucket, size = [], 0
            for i, name in enumerate(names):
                bucket.append(name)
                size += grads[name].numel() * 4
                if size >= _BUCKET_BYTES or i == len(names) - 1:
                    flat = torch.cat([grads[k].reshape(-1).float()
                                      for k in bucket])
                    if group is not None:
                        dist.all_reduce(flat, group=group)
                    flat = flat / torch.full((), float(n),
                                             device=flat.device)
                    ofs = 0
                    for k in bucket:
                        m = grads[k].numel()
                        out[k] = flat[ofs:ofs + m].view_as(grads[k]).to(
                            grads[k].dtype)
                        ofs += m
                    bucket, size = [], 0
        return out

    def _global_loss(self, loss):
        if not self._bax:
            return loss
        t = loss.detach().clone()
        dist.all_reduce(t, group=self._batch_group())
        return t / torch.full((), float(self._batch_parts()),
                              device=t.device)

    def _reduce_sq(self, names, sq):
        """The optimizer's `reduce_sq`: the squared norms `sq` of the
        tensors of `names` with each split parameter's entry summed over
        the ranks its blocks are spread over, one all-reduce a group (in
        the order of the names, the same on every rank)."""
        split = self._split_groups
        for group in dict.fromkeys(split[n] for n in names if n in split):
            idx = torch.tensor([i for i, n in enumerate(names)
                                if split.get(n) is group], device=sq.device)
            part = sq.index_select(0, idx)
            dist.all_reduce(part, group=group)
            sq = sq.index_copy(0, idx, part)
        return sq

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
        gens = [g for g in (self.generator, self._mask_gen,
                            self._split_gen) if g is not None]
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
        returns the outputs (on a mesh, of the global batch: each rank
        runs its rows and the outputs are gathered)."""
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        # contiguous rows (one micro-batch), so that the gathered outputs
        # come back in the batch's order
        inputs = tuple(self._to_device(self._local_rows(x, 1))
                       for x in inputs)
        self.layer.eval()
        try:
            with torch.no_grad():
                out = self._apply_plain(inputs)
        finally:
            self.layer.train()
        if not self._bax:
            return out
        group, ranks = self._batch_group(), self.mesh.ranks_of(self._bax)
        if isinstance(out, torch.Tensor):
            return all_gather_cat(out, group, 0, ranks)
        return type(out)(all_gather_cat(o, group, 0, ranks) for o in out)

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
        synchronised. On a mesh the batch is the global one: the rank
        takes its rows, and the loss and gradients are the global
        batch's (each gradient of this rank's block)."""
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        return self._local_loss_and_grads(self.shard_batch(*inputs),
                                          self.shard_batch(labels)[0])

    def _local_loss_and_grads(self, inputs, labels):
        loss, grads = self._loss_and_grads(inputs, labels)
        if self._bax:
            grads = self._reduce_grads(grads)
            loss = self._global_loss(loss)
        return loss, grads

    def _loss_and_grads(self, inputs, labels):
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
        self._update(grads)
        return loss

    def _update(self, grads):
        # split parameters: the rules' norms are the whole parameters'
        kw = {"reduce_sq": self._reduce_sq} if self._split_groups else {}
        with torch.no_grad():
            names = list(self.params)
            new, self.opt_state = self.tx.update(
                {n: p.detach() for n, p in self.params.items()}, grads,
                self.opt_state, **kw)
            torch._foreach_copy_([self.params[n].detach() for n in names],
                                 [new[n] for n in names])

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
        input), and the steps wait for that copy alone. On a mesh the
        batches come through `io.DevicePrefetcher(sharding=)`, which
        hands each rank its rows on its device."""
        if self._bax:
            return self._run_epoch_sharded(batches)
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

    def _run_epoch_sharded(self, batches):
        from ..io import DevicePrefetcher

        def pairs():
            for inputs, labels in batches:
                inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
                    else (inputs,)
                yield inputs, labels

        loss = None
        pf = DevicePrefetcher(pairs(), sharding=self.batch_sharding(),
                              depth=2, device=self.device)
        for inputs, labels in pf:
            loss, grads = self._local_loss_and_grads(inputs, labels)
            self._update(grads)
        return loss


def spmd_data_parallel(layer, loss_fn, optimizer, **kw):
    """A data-parallel trainer over the world (the installed mesh, by
    default dp over every rank): CompiledProgram.with_data_parallel's
    replacement."""
    return SpmdTrainer(layer, loss_fn, optimizer, **kw)
