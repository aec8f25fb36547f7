"""The device mesh over torch.distributed (the JAX package's
`parallel/mesh.py`).

The JAX mesh is single-controller: one process drives every device of a
`jax.sharding.Mesh`. The port is multi-controller: each rank is one
process on one device, and the mesh is the world's ranks laid out
row-major over the named axes in the canonical order ("dp", "fsdp", "pp",
"tp", "sp", "ep") (`fsdp` only when asked for, as in JAX), so that rank
= the flat index of its coordinates, as JAX's `devices.reshape(sizes)`.
Each axis larger than one gets a `torch.distributed` group for every
line of ranks along it, and the mesh keeps the rank's own: the named
collectives over an axis run on that group. The product of the sizes
must equal the world's size.

Building a mesh, `group_of` a new set of axes and `slice_axis` are
collective over the ranks concerned: each rank makes the groups it
belongs to, in the same order as its peers.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

__all__ = ["DeviceMesh", "init_mesh", "auto_mesh", "get_mesh",
           "mesh_axis_size", "CANONICAL"]

CANONICAL = ("dp", "fsdp", "pp", "tp", "sp", "ep")

_current: list = [None]


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DeviceMesh:
    """The world's ranks over named axes (`ranks`: the ndarray of global
    ranks, axis order = `axis_names`), this rank's coordinates and its
    groups, and its device."""

    def __init__(self, ranks, axis_names: Sequence[str], device=None):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.ranks.ndim} dims for axes "
                             f"{self.axis_names}")
        _, me = _world()
        where = np.argwhere(self.ranks == me)
        #: this rank's index on each axis (None: not a member)
        self.coords = None if not len(where) else dict(
            zip(self.axis_names, (int(i) for i in where[0])))
        self.device = _mesh_device(device)
        self._groups = {}
        for name in self.axis_names:
            if self.axis_size(name) > 1:
                self.group_of((name,))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def devices(self):
        """The mesh's ranks (the JAX mesh's device ndarray)."""
        return self.ranks

    @property
    def size(self):
        return int(self.ranks.size)

    def axis_size(self, name: str) -> int:
        if name not in self.axis_names:
            return 1
        return int(self.ranks.shape[self.axis_names.index(name)])

    def coord(self, name) -> int:
        """This rank's index on axis `name` (0 for an absent axis); for a
        tuple of axes, the joint index, the first axis major."""
        if isinstance(name, (tuple, list)):
            idx = 0
            for n in name:
                idx = idx * self.axis_size(n) + self.coord(n)
            return idx
        if self.coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return self.coords.get(name, 0)

    def group_of(self, axes):
        """The group of this rank's peers along `axes` (a name or a tuple
        of names; the others held fixed), or None where the axes span one
        rank. Its members are in the joint order of `axes` (first axis
        major), which `ranks_of` gives. Collective on first use."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        if not axes:
            return None
        key = axes
        if key not in self._groups:
            idx = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(self.ranks.ndim) if i not in idx]
            # axes of the group last, in the order asked: each line of the
            # moved array is one group's ranks in joint order
            lines = np.transpose(self.ranks, rest + idx).reshape(
                -1, int(np.prod([self.ranks.shape[i] for i in idx])))
            mine = None
            _, me = _world()
            for line in lines:
                if me in line:
                    # only the members rendezvous (each rank makes its own
                    # groups, in the same order as its peers)
                    ranks = [int(r) for r in line]
                    mine = (dist.new_group(
                        ranks, use_local_synchronization=True), ranks)
            self._groups[key] = mine
        got = self._groups[key]
        return None if got is None else got[0]

    def ranks_of(self, axes):
        """The global ranks of `group_of(axes)`, in joint order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if self.axis_size(a) > 1)
        if not axes:
            return [_world()[1]]
        self.group_of(axes)
        return self._groups[axes][1]

    def slice_axis(self, name: str, start, stop) -> "DeviceMesh":
        """The sub-mesh over the [start, stop) slab of one axis, every
        axis name kept (the serving engines' prefill / decode split).
        Collective: every rank of this mesh calls it."""
        if name not in self.axis_names:
            raise ValueError(f"mesh has no axis {name!r}: {self.axis_names}")
        ax = self.axis_names.index(name)
        idx = [slice(None)] * self.ranks.ndim
        idx[ax] = slice(int(start), int(stop))
        sub = self.ranks[tuple(idx)]
        if sub.size == 0:
            raise ValueError(f"empty {name!r} slice [{start}, {stop}) of "
                             f"axis size {self.axis_size(name)}")
        return DeviceMesh(sub, self.axis_names, self.device)

    def __enter__(self):
        self._prev = _current[0]
        _current[0] = self
        return self

    def __exit__(self, *exc):
        _current[0] = self._prev
        return False

    def __repr__(self):
        return f"DeviceMesh({self.shape})"


def _mesh_device(device):
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(
                "init_mesh(devices=) takes this rank's own device only (one "
                "process a rank), or None")
        device = device[0]
    if device is not None:
        from ..core.device import resolve_device

        return resolve_device(device)
    from .. import distributed as D

    if D.device() is not None:
        return D.device()
    from ..core.device import resolve_device

    return resolve_device(None)


def init_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1,
              ep: int = 1, fsdp: Optional[int] = None,
              devices=None) -> DeviceMesh:
    """Build and install the global mesh over the world's ranks. The axis
    sizes must multiply to the world's size. Axes of size 1 are kept;
    `fsdp` joins only when given. `devices`: this rank's device (or a
    one-element list of it); None takes `init_parallel_env`'s device,
    else the card."""
    sizes = collections.OrderedDict(
        [("dp", dp), ("pp", pp), ("tp", tp), ("sp", sp), ("ep", ep)])
    if fsdp is not None:
        sizes = collections.OrderedDict(
            [("dp", dp), ("fsdp", fsdp), ("pp", pp), ("tp", tp),
             ("sp", sp), ("ep", ep)])
    total = int(np.prod(list(sizes.values())))
    world, _ = _world()
    if total != world:
        raise ValueError(
            f"mesh {dict(sizes)} needs {total} ranks, the world has {world}")
    ranks = np.arange(world).reshape(tuple(sizes.values()))
    dm = DeviceMesh(ranks, tuple(sizes.keys()), devices)
    _current[0] = dm
    return dm


def auto_mesh(n_devices: Optional[int] = None, *, want_pp=False,
              want_tp=True, want_sp=False, want_ep=False) -> DeviceMesh:
    """Factor the world (n_devices: its size) into (dp, pp, tp, sp, ep):
    tp up to 2 (4 with 8 ranks or more), pp, sp and ep 2 when asked, the
    rest dp (the JAX policy)."""
    n = _world()[0] if n_devices is None else int(n_devices)
    rem = n
    sizes = {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1}

    def take(axis, k):
        nonlocal rem
        if rem % k == 0 and rem >= k:
            sizes[axis] = k
            rem //= k

    if want_pp and rem % 2 == 0:
        take("pp", 2)
    if want_tp and rem % 2 == 0:
        take("tp", 4 if rem % 4 == 0 and rem >= 8 else 2)
    if want_sp and rem % 2 == 0:
        take("sp", 2)
    if want_ep and rem % 2 == 0:
        take("ep", 2)
    sizes["dp"] = rem
    return init_mesh(**sizes)


def get_mesh() -> DeviceMesh:
    """The installed mesh; by default pure data parallel over the world."""
    if _current[0] is None:
        return init_mesh(dp=_world()[0])
    return _current[0]


def mesh_axis_size(name: str) -> int:
    return get_mesh().axis_size(name)


def _reset():
    """Forget the installed mesh (its groups stay with torch.distributed)."""
    _current[0] = None
