"""Differentiable collectives over a process group: what the JAX package
gets from `jax.lax.psum` / `ppermute` / `all_to_all` inside `shard_map`
and their transposes.

Which backward a reduction takes depends on how the ranks use its
result. Where every rank of the group goes on with the same replicated
computation and the ranks' gradients are NOT averaged afterwards (the
tensor-parallel and expert-parallel peers), the Megatron pair holds:
`copy_to` (identity forward, all-reduce of the gradient backward) where
a replicated tensor enters a split computation, and `reduce_from`
(all-reduce forward, identity backward) where the partial results come
together. Where the ranks hold different data and their gradients ARE
averaged afterwards (the data-parallel peers: global batch statistics,
MoE capacity and load), `all_reduce_sum` sums both ways.

A group of None is one rank (`DeviceMesh.group_of` gives None for axes
of size one): every function is then the identity.
"""
from __future__ import annotations

import torch

from .. import distributed as D

__all__ = ["copy_to", "reduce_from", "all_reduce_sum", "ppermute",
           "all_to_all", "all_gather_cat", "gather_dim", "gather_from"]


def _n(group):
    if group is None or D._alone(group):
        return 1
    return torch.distributed.get_world_size(group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return D.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return D.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return D.shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return D.shift(g.contiguous(), ctx.group, -ctx.offset), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return D.all_to_all_single(torch.empty_like(x), x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return D.all_to_all_single(torch.empty_like(g), g, ctx.group), None


def copy_to(x, group):
    """Identity forward; the gradient is summed over `group`."""
    return x if _n(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The sum over `group` forward; the gradient passes as it is."""
    return x if _n(group) == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x, group):
    """The sum over `group`, forward and backward."""
    return x if _n(group) == 1 else _AllReduceSum.apply(x, group)


def ppermute(x, group, offset=1):
    """Ring shift by `offset` over `group` (the JAX ppermute j -> j +
    offset); the gradient shifts back."""
    return x.clone() if _n(group) == 1 else _PPermute.apply(x, group, offset)


def all_to_all(x, group):
    """x's equal chunks along dim 0 go to the group's ranks in order (its
    own inverse, so the gradient takes the same exchange)."""
    return x if _n(group) == 1 else _AllToAll.apply(x, group)


def all_gather_cat(x, group, dim=0, ranks=None):
    """The ranks' tensors concatenated along `dim` in the order of
    `ranks` (global ranks; None: the group's order). No gradient."""
    if _n(group) == 1:
        return x
    parts = D.all_gather([], x.detach().contiguous(), group=group)
    if ranks is not None:
        order = torch.distributed.get_process_group_ranks(group)
        parts = [parts[order.index(r)] for r in ranks]
    return torch.cat(parts, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, ranks):
        ctx.group, ctx.dim, ctx.n = group, dim, len(ranks)
        ctx.i = ranks.index(torch.distributed.get_rank())
        return all_gather_cat(x, group, dim, ranks)

    @staticmethod
    def backward(ctx, g):
        g = D.all_reduce(g.contiguous().clone(), group=ctx.group)
        return g.chunk(ctx.n, ctx.dim)[ctx.i].contiguous(), None, None, None


def gather_dim(x, group, dim, ranks):
    """The ranks' tensors concatenated along `dim` in the order of
    `ranks` (global ranks, this one among them); the gradient is this
    rank's slice of the ranks' gradients summed (the JAX all_gather's
    transpose)."""
    if _n(group) == 1:
        return x
    return _GatherDim.apply(x, group, dim % x.dim(), list(ranks))


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, ranks):
        ctx.dim, ctx.n = dim, len(ranks)
        ctx.i = ranks.index(torch.distributed.get_rank())
        return all_gather_cat(x, group, dim, ranks)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.i].contiguous(), None, None, None


def gather_from(x, group, dim, ranks):
    """The ranks' tensors concatenated along `dim` in the order of `ranks`
    (global ranks, this one among them); the gradient is this rank's
    slice of the gradient as it is. Megatron's gather for a result that
    every rank of the group goes on with alike (the peers' gradients are
    the same, so summing them would count each `len(ranks)` times)."""
    if _n(group) == 1:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim(), list(ranks))
