"""Pipeline parallelism: the GPipe fill-drain schedule over the `pp`
mesh axis (the JAX package's `parallel/pipeline.py`).

`fn = pipeline_spmd_fn(stage_apply, mesh, first_fn=, last_fn=)`;
`fn(params, microbatches)` runs M microbatches through the S stages of
the pp axis in M + S - 1 ticks: at tick t stage s applies its stage to
microbatch t - s (stage 0 ingests it with `first_fn`, the last stage
finishes it with `last_fn`) and hands its activation to the next stage,
which takes it at tick t + 1. The result, (M, ...) per-microbatch
outputs, is the last stage's, on every rank of the axis.

The whole schedule is one `torch.autograd.Function`: its forward runs
the ticks, sending each activation on by point-to-point calls (a ring
shift over the axis, as the JAX `ppermute`), and keeps each tick's graph;
its backward walks the ticks in reverse, sending each activation's
gradient back the same way, so `backward()` (or `autograd.grad`) through
`fn`'s output goes through the schedule. Every rank makes the same
point-to-point calls at every tick; a stage computes only on the ticks
that hold one of its microbatches (the JAX version computes on every
tick and masks, the pipeline's bubble).

Params: without first_fn / last_fn, `params` is this stage's parameter
tree and `microbatches` a (M, mb, ...) float tensor of activations, the
same on every rank; with them, `params = (stage params, first params,
last params)` and `microbatches` any tuple of tensors with leading axis
M. The JAX package stacks every stage's parameters on a leading axis
sharded over pp; a port rank holds its own stage's: `stack_stage_params`
stacks per-stage trees, and `fn` takes either this stage's tree or the
stack (it then picks this stage's row). The first and last parameters
are replicated; their gradients are summed over the axis (only stage 0
and the last stage produce any), so every rank holds the full ones.
"""
from __future__ import annotations

import torch

from .collectives import copy_to
from .mesh import get_mesh

__all__ = ["pipeline_spmd_fn", "stack_stage_params"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return next(it) if isinstance(tree, torch.Tensor) else tree


def _index(tree, i):
    return _rebuild(tree, iter([x[i] for x in _leaves(tree)]))


class StackedParams(dict):
    """{name: (S, ...)}: every stage's parameters on a leading axis."""


def stack_stage_params(per_stage_params):
    """[{name: tensor}, ...] per stage -> {name: (S, ...) stacked}. All
    stages must share one parameter structure."""
    keys = per_stage_params[0].keys()
    return StackedParams({k: torch.stack([sp[k] for sp in per_stage_params])
                          for k in keys})


#: the output dtypes the schedule hands from the last stage
_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int64, torch.int32]


def _from_last(res, like, last, group, is_last):
    """The last stage's `res` on every rank of the axis (a header of its
    dtype and shape, then the tensor)."""
    from .. import distributed as D

    header = torch.zeros(10, dtype=torch.long, device=like.device)
    if is_last:
        header[0] = _DTYPES.index(res.dtype)
        header[1] = res.dim()
        header[2:2 + res.dim()] = torch.tensor(res.shape)
    D.broadcast(header, last, group=group)
    if not is_last:
        h = header.tolist()
        res = torch.zeros(h[2:2 + h[1]], dtype=_DTYPES[h[0]],
                          device=like.device)
    return D.broadcast(res.contiguous(), last, group=group)


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, *flat):
        stage_apply, ffn, lfn, tree, n_stages, s, group, M = cfg
        from .. import distributed as D

        leaves = [x.detach().requires_grad_(x.requires_grad)
                  for x in flat]
        stage_p, first_p, last_p, mbs = _rebuild(tree, iter(leaves))
        with torch.no_grad():
            x_like = ffn(first_p, _index(mbs, 0))
        state = torch.zeros_like(x_like)
        ticks = []        # per tick: (x_in leaf or None, y, out or None)
        outs = [None] * M
        for t in range(M + n_stages - 1):
            j = t - s
            y = torch.zeros_like(x_like)
            x_in = out = None
            if 0 <= j < M:
                with torch.enable_grad():
                    if s == 0:
                        x = ffn(first_p, _index(mbs, j))
                    else:
                        x = x_in = state.detach().requires_grad_(True)
                    y = stage_apply(stage_p, x)
                    if s == n_stages - 1:
                        out = lfn(last_p, y, _index(mbs, j))
                        outs[j] = out.detach()
            ticks.append((x_in, y, out))
            state = D.shift(y.detach().contiguous(), group, 1)
        is_last = s == n_stages - 1
        last = torch.distributed.get_process_group_ranks(group)[-1]
        res = _from_last(torch.stack(outs) if is_last else None, x_like,
                         last, group, is_last)
        ctx.ticks, ctx.cfg, ctx.leaves, ctx.x_like = ticks, cfg, leaves, \
            x_like
        return res

    @staticmethod
    def backward(ctx, g):
        stage_apply, ffn, lfn, tree, n_stages, s, group, M = ctx.cfg
        from .. import distributed as D

        grads = [None] * len(ctx.leaves)
        want = [i for i, x in enumerate(ctx.leaves) if x.requires_grad]
        g_state = torch.zeros_like(ctx.x_like)   # gradient of the x_in
        for t in reversed(range(len(ctx.ticks))):
            # this tick's y became the next stage's input at tick t + 1
            g_y = D.shift(g_state.contiguous(), group, -1)
            x_in, y, out = ctx.ticks[t]
            g_state = torch.zeros_like(ctx.x_like)
            if not y.requires_grad:
                continue
            # the vector-Jacobian product as the gradient of one scalar
            # (autograd.grad with grad_outputs imports sympy on first use)
            with torch.enable_grad():
                total = (y * g_y).sum()
                if out is not None:
                    total = total + (out * g[t - s]).sum()
            inputs = [ctx.leaves[i] for i in want]
            if x_in is not None:
                inputs.append(x_in)
            if not inputs:
                continue
            got = torch.autograd.grad(total, inputs, allow_unused=True)
            if x_in is not None:
                if got[-1] is not None:
                    g_state = got[-1]
                got = got[:-1]
            for i, gi in zip(want, got):
                if gi is not None:
                    grads[i] = gi if grads[i] is None else grads[i] + gi
        ctx.ticks = None
        return (None, *grads)


def pipeline_spmd_fn(stage_apply, mesh=None, axis_name="pp", first_fn=None,
                     last_fn=None):
    """fn(params, microbatches) -> (M, ...) outputs over the `axis_name`
    stages (see the module's docstring)."""
    m = mesh or get_mesh()
    n_stages = m.axis_size(axis_name)
    has_ends = first_fn is not None or last_fn is not None
    ffn = first_fn or (lambda fp, mb: mb)
    lfn = last_fn or (lambda lp, y, mb: y)

    def fn(params, microbatches):
        stages_p, first_p, last_p = params if has_ends else (params, (), ())
        M = _leaves(microbatches)[0].shape[0]
        s = m.coord(axis_name) if n_stages > 1 else 0
        sp = _index(stages_p, s) if isinstance(stages_p, StackedParams) \
            else stages_p
        if n_stages == 1:
            return torch.stack([
                lfn(last_p, stage_apply(sp, ffn(first_p, _index(
                    microbatches, j))), _index(microbatches, j))
                for j in range(M)])
        group = m.group_of(axis_name)
        # replicated ends: their gradients summed over the stages
        first_p = _rebuild(first_p, iter(
            [copy_to(x, group) for x in _leaves(first_p)]))
        last_p = _rebuild(last_p, iter(
            [copy_to(x, group) for x in _leaves(last_p)]))
        tree = (sp, first_p, last_p, microbatches)
        cfg = (stage_apply, ffn, lfn, tree, n_stages, s, group, M)
        return _Schedule.apply(cfg, *_leaves(tree))

    return fn
