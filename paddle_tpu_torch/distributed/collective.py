"""The named collectives of static programs (`c_allreduce_sum`,
`c_allgather`, ...; the JAX package's `distributed/collective.py`), over
the group of the installed mesh's axis `axis_name`. In the JAX package
they are XLA collectives inside `shard_map`; here each runs on this
rank's tensor and returns a new one, differentiable as the JAX
transposes are: a sum's gradient is summed, an all-gather's is this
rank's slice of the summed gradient, a ring shift's shifts back. An axis
of size one makes each the identity. The stream-sync ops are no-ops:
the collectives run in order on the current stream.
"""
from __future__ import annotations

import torch

from . import _alone
from ..parallel import collectives as C
from ..parallel.mesh import get_mesh

__all__ = ["c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
           "c_allreduce_prod", "c_allgather", "c_reducescatter",
           "c_broadcast", "c_ppermute", "c_sync_calc_stream",
           "c_sync_comm_stream", "barrier_op"]


def _group(axis_name):
    return get_mesh().group_of(axis_name)


def c_allreduce_sum(x, axis_name="dp"):
    return C.all_reduce_sum(x, _group(axis_name))


def _extreme(x, axis_name, op):
    from . import ReduceOp, all_reduce

    g = _group(axis_name)
    if _alone(g):
        return x
    return all_reduce(x.detach().contiguous().clone(), op, g)


def c_allreduce_max(x, axis_name="dp"):
    from . import ReduceOp

    return _extreme(x, axis_name, ReduceOp.MAX)


def c_allreduce_min(x, axis_name="dp"):
    from . import ReduceOp

    return _extreme(x, axis_name, ReduceOp.MIN)


def c_allreduce_prod(x, axis_name="dp"):
    """exp(sum(log x)) over the axis, as the JAX op computes it (positive
    x)."""
    return torch.exp(c_allreduce_sum(torch.log(x), axis_name))


def c_allgather(x, axis_name="dp", tiled=True):
    """The axis' tensors concatenated along dim 0 (tiled) or stacked."""
    m = get_mesh()
    if m.axis_size(axis_name) == 1:
        return x if tiled else x[None]
    out = C.gather_dim(x, m.group_of(axis_name), 0, m.ranks_of(axis_name))
    return out if tiled else out.reshape((-1,) + tuple(x.shape))


def c_reducescatter(x, axis_name="dp"):
    """This rank's dim-0 chunk of the axis' sum."""
    m = get_mesh()
    n = m.axis_size(axis_name)
    if n == 1:
        return x
    return c_allreduce_sum(x, axis_name).chunk(n, 0)[m.coord(axis_name)]


def c_broadcast(x, root=0, axis_name="dp"):
    """The axis' rank `root`'s x on every rank of the axis (a masked sum,
    as the JAX op)."""
    m = get_mesh()
    if m.axis_size(axis_name) == 1:
        return x
    keep = torch.ones((), dtype=x.dtype, device=x.device) \
        if m.coord(axis_name) == root else \
        torch.zeros((), dtype=x.dtype, device=x.device)
    return c_allreduce_sum(x * keep, axis_name)


def c_ppermute(x, perm, axis_name="dp"):
    """The JAX ppermute for a uniform shift perm [(j, j + s mod n)]."""
    m = get_mesh()
    n = m.axis_size(axis_name)
    shifts = {(dst - src) % n for src, dst in perm}
    if len(shifts) != 1 or len(perm) != n:
        raise NotImplementedError(
            "c_ppermute takes a uniform ring shift [(j, (j + s) % n)] over "
            "every rank of the axis")
    return C.ppermute(x, m.group_of(axis_name), shifts.pop())


def c_sync_calc_stream(x):
    return x


def c_sync_comm_stream(x):
    return x


def barrier_op(axis_name="dp"):
    g = _group(axis_name)
    if not _alone(g):
        torch.distributed.barrier(group=g)
    return torch.zeros(())
