"""The layers on a mesh: what the JAX package leaves to XLA's SPMD
partitioner, written out for a multi-controller rank.

`shard_layer(layer, mesh, rules, batch_axes)` cuts each parameter that
the rules split into this rank's block (in place: the module keeps its
parameter names, now of the block's shape) and switches the modules that
compute on blocks to their sharded forms, by class:

* a `Linear` split by output columns (q/k/v, `linear1`) takes its input
  through `copy_to` (its gradient summed over the split axis) and
  computes its columns; one split by input rows (`out_proj`, `linear2`)
  sums its partial products over the axis (`reduce_from`) and adds its
  bias once, after the sum;
* an `Embedding` split by vocabulary rows looks up the ids its rows
  hold, zeroes the others and sums over the axis (exact: each id's row
  lives on one rank);
* a `MultiHeadAttention` whose projections are split runs its heads:
  `num_heads / tp` of them, through the flash kernels on its local
  tensors, with the dropout address of its rows and heads
  (`dropout_shard`);
* a `MoELayer` routes over the global batch (its capacity, queue
  positions and load-balance loss are those of every token of the batch
  axes) and, with its experts split over ep, computes its own experts:
  where the ep peers hold the same tokens, each computes its experts'
  slots and the peers' rows are summed (exact: each slot lives on one
  rank); where ep splits the batch, the slots travel to their expert's
  rank by all-to-all and come back the same way.

A parameter split in a module of any other kind raises: the rules would
give it a block it does not know how to compute on.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn.layer.common import Embedding, Linear, _embedding
from ..nn.layer.moe import MoELayer
from ..nn.layer.transformer import MultiHeadAttention
from .collectives import (all_gather_cat, all_reduce_sum, all_to_all,
                          copy_to, reduce_from)
from .sharding import named_sharding

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ShardedMoELayer", "shard_layer",
           "batch_axes_of"]


class ColumnParallelLinear(Linear):
    """A Linear holding output columns of the full layer (`_group`: the
    split axis' group)."""

    def forward(self, x):
        return super().forward(copy_to(x, self._group))


class RowParallelLinear(Linear):
    """A Linear holding input rows of the full layer; the bias is whole."""

    def forward(self, x):
        y = reduce_from(torch.matmul(x, self.weight), self._group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Embedding):
    """An Embedding holding rows [_vocab_start, _vocab_start + rows) of the
    table; `_ranks` are the split axis' ranks in the order of their rows."""

    def forward(self, x):
        n = self.weight.shape[0]
        inside = (x >= self._vocab_start) & (x < self._vocab_start + n)
        local = torch.where(inside, x - self._vocab_start, 0)
        out = _embedding(local, self.weight)
        out = out * inside[..., None].to(out.dtype)
        return reduce_from(out, self._group)


class ShardedMoELayer(MoELayer):
    """`MoELayer` over the global batch and, with `_ep_group`, its own
    experts [_e0, _e0 + local experts). Attributes set by `shard_layer`:
    `_batch_group` / `_batch_ranks` / `_batch_coord` (the ranks that
    split the batch), `_ep_group` / `_ep_split` (ep splits the batch
    too), `_tp_group` (the experts' hidden dim split over tp)."""

    def forward(self, x):
        b, s, d = x.shape
        e = self.num_experts
        el = self.experts.weight_in.shape[0]
        tokens = b * s
        nb = len(self._batch_ranks)
        cap = self.capacity(tokens * nb)
        xf = x.reshape(tokens, d)

        probs = torch.softmax(xf @ self.router, -1)             # [T, E]
        route = torch.argmax(probs, -1)
        gate = probs.gather(1, route[:, None])[:, 0]
        onehot = route[None] == torch.arange(e, device=x.device)[:, None]
        local_pos = torch.cumsum(onehot.long(), 1).gather(
            0, route[None])[0] - 1
        counts = onehot.sum(1)                                  # [E]
        if nb > 1:
            # queue positions and load over the global batch: the tokens
            # of the batch ranks before this one come first
            every = all_gather_cat(counts[None], self._batch_group, 0,
                                   self._batch_ranks)           # [nb, E]
            load = every.sum(0)
            offset = every[:self._batch_coord].sum(0)
        else:
            load, offset = counts, torch.zeros_like(counts)
        keep = local_pos + offset[route] < cap
        zero = xf.new_zeros(1, d)

        if self._ep_group is not None and not self._ep_split:
            # the ep peers hold the same tokens: this rank's experts only
            mine = keep & (route >= self._e0) & (route < self._e0 + el)
            slot = torch.where(mine, (route - self._e0) * cap + local_pos,
                               el * cap)
            xin = copy_to(xf, self._ep_group)
            expert_out = self._experts(xin, slot, el, cap)
            rows = torch.cat([expert_out.reshape(el * cap, d), zero]) \
                .index_select(0, slot)
            rows = reduce_from(rows, self._ep_group)
        else:
            # this rank's tokens in every expert's queue at their local
            # positions; with ep splitting the batch the [E, C, D] queues
            # go to their experts' ranks and come back
            slot = torch.where(keep, route * cap + local_pos, e * cap)
            if self._ep_group is None:
                expert_out = self._experts(xf, slot, e, cap)
            else:
                expert_out = self._ep_exchange(xf, slot, e, el, cap, d)
            rows = torch.cat([expert_out.reshape(e * cap, d), zero]) \
                .index_select(0, slot)
        out = rows * (gate * keep.to(gate.dtype))[:, None]

        n = float(tokens * nb)
        f_e = load.float() / n
        p_e = all_reduce_sum(probs.float().sum(0), self._batch_group) / n
        self.aux_loss = (f_e * p_e).sum() * float(e)
        self.last_route, self.last_probs = route.detach(), probs.detach()
        self.last_load = load.detach()
        self.last_dropped = (~keep).sum().detach()
        return out.reshape(b, s, d)

    def _ffn(self, expert_in):
        """[experts here, rows, D] through this rank's expert weights
        (their hidden dim split over `_tp_group` when it is set)."""
        expert_in = copy_to(expert_in, self._tp_group)
        h = torch.bmm(expert_in, self.experts.weight_in)
        h = F.gelu(h) if self.act == "gelu" else F.relu(h)
        return reduce_from(torch.bmm(h, self.experts.weight_out),
                           self._tp_group)

    def _experts(self, xf, slot, n_exp, cap):
        d = xf.shape[1]
        token_of_slot = torch.full((n_exp * cap + 1,), xf.shape[0],
                                   dtype=torch.long, device=xf.device).scatter(
            0, slot, torch.arange(xf.shape[0], device=xf.device))[:n_exp * cap]
        expert_in = torch.cat([xf, xf.new_zeros(1, d)]).index_select(
            0, token_of_slot).reshape(n_exp, cap, d)
        return self._ffn(expert_in)

    def _ep_exchange(self, xf, slot, e, el, cap, d):
        ep = e // el
        token_of_slot = torch.full((e * cap + 1,), xf.shape[0],
                                   dtype=torch.long, device=xf.device).scatter(
            0, slot, torch.arange(xf.shape[0], device=xf.device))[:e * cap]
        queues = torch.cat([xf, xf.new_zeros(1, d)]).index_select(
            0, token_of_slot)                              # [E * C, D]
        got = all_to_all(queues.reshape(ep, el * cap * d), self._ep_group)
        # [source rank, expert here, C, D] -> [expert here, sources * C, D]
        got = got.reshape(ep, el, cap, d).transpose(0, 1).reshape(
            el, ep * cap, d)
        done = self._ffn(got).reshape(el, ep, cap, d).transpose(0, 1)
        back = all_to_all(done.reshape(ep, el * cap * d), self._ep_group)
        return back.reshape(e, cap, d)


def batch_axes_of(mesh, batch_axes):
    """The batch axes the mesh holds more than once."""
    return tuple(a for a in batch_axes if mesh.axis_size(a) > 1)


def _owner(layer, name):
    mod = layer
    *path, leaf = name.split(".")
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def shard_layer(layer, mesh, rules, batch_axes=("dp",)):
    """Cut the layer's split parameters into this rank's blocks and switch
    the modules that compute on them to their sharded forms (see the
    module's docstring); bind the dropout address of every
    MultiHeadAttention and the global routing of every MoELayer. Returns
    {parameter name: Sharding}."""
    from .sharding import infer_param_specs

    params = dict(layer.named_parameters())
    specs = infer_param_specs(params, rules)
    shardings = {n: named_sharding(specs[n], mesh) for n in params}
    split = {n: sh for n, sh in shardings.items() if sh.is_split}
    handled = set()
    for name, sh in split.items():
        mod, leaf = _owner(layer, name)
        with torch.no_grad():
            setattr(mod, leaf, torch.nn.Parameter(
                sh.shard(params[name].detach())))
    bax = batch_axes_of(mesh, batch_axes)
    for mname, mod in layer.named_modules():
        prefix = f"{mname}." if mname else ""
        w = split.get(prefix + "weight")
        if isinstance(mod, Linear) and w is not None:
            (dim, axes), = w.splits
            mod._group = mesh.group_of(axes)
            mod.__class__ = ColumnParallelLinear if dim == 1 else \
                RowParallelLinear
            handled.update({prefix + "weight", prefix + "bias"})
        elif isinstance(mod, Embedding) and w is not None:
            (dim, axes), = w.splits
            if dim != 0:
                raise NotImplementedError(f"{mname}: an embedding splits its "
                                          f"vocabulary rows only")
            mod._group = mesh.group_of(axes)
            mod._ranks = mesh.ranks_of(axes)
            mod._vocab_start = mesh.coord(axes) * mod.weight.shape[0]
            mod.__class__ = VocabParallelEmbedding
            handled.add(prefix + "weight")
        elif isinstance(mod, MultiHeadAttention):
            q = split.get(prefix + "q_proj.weight")
            heads = mod.num_heads
            h0 = 0
            if q is not None:
                (_, axes), = q.splits
                n = q.parts(axes)
                if heads % n:
                    raise ValueError(f"{mname}: {heads} heads do not split "
                                     f"over {n} ranks")
                mod.num_heads = heads // n
                h0 = mesh.coord(axes) * mod.num_heads
            if q is not None or bax:
                mod.dropout_shard = (mesh.coord(bax) if bax else 0, h0,
                                     heads)
        elif isinstance(mod, MoELayer) and (bax or split.get(
                prefix + "experts.weight_in") is not None):
            win = split.get(prefix + "experts.weight_in")
            mod._batch_group = mesh.group_of(bax) if bax else None
            mod._batch_ranks = mesh.ranks_of(bax) if bax else [0]
            mod._batch_coord = mesh.coord(bax) if bax else 0
            mod._ep_group = mod._tp_group = None
            mod._ep_split, mod._e0 = False, 0
            for dim, axes in (win.splits if win is not None else ()):
                if dim == 0:
                    mod._ep_group = mesh.group_of(axes)
                    mod._ep_split = any(a in bax for a in axes)
                    mod._e0 = mesh.coord(axes) * mod.experts.weight_in \
                        .shape[0]
                elif dim == 2:
                    mod._tp_group = mesh.group_of(axes)
            mod.__class__ = ShardedMoELayer
            handled.update({prefix + "experts.weight_in",
                            prefix + "experts.weight_out"})
    left = sorted(set(split) - handled)
    if left:
        raise NotImplementedError(
            f"the sharding rules split {left}, which no sharded layer of the "
            f"port computes on")
    return shardings
