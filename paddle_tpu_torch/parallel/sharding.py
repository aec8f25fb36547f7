"""Sharding rules: parameter-name patterns -> how each dimension splits
over the mesh (the JAX package's `parallel/sharding.py`).

The rule tables are the JAX ones, entry for entry: Linear weights are
stored (in, out) in both packages, so Megatron's layout reads the same:
q/k/v and `linear1` split their output columns over tp, `out_proj` and
`linear2` their input rows, the vocabulary table its rows, and the
stacked experts their expert axis over ep. A spec is a tuple over the
tensor's dims, each entry an axis name, a tuple of axis names (split
jointly, the first major) or None (not split).

The JAX package hands a spec to XLA as a `NamedSharding`. In the port a
`Sharding` is the spec against one mesh (axes the mesh lacks or holds
once dropped) with the two operations a multi-controller rank needs:
`shard` cuts a full tensor into this rank's block, and `gather` puts the
blocks of the split axes back together (an all-gather over each split
dimension's group).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import DeviceMesh, get_mesh

__all__ = ["ShardingRules", "COMMON_TP_RULES", "serving_param_rules",
           "infer_param_specs", "named_sharding", "fitted_sharding",
           "batch_sharding", "Sharding", "shard_tensor", "gather_tensor"]


class ShardingRules:
    """Ordered (regex, spec-tuple) table; the first match wins; a name no
    rule matches is not split."""

    def __init__(self, rules: Sequence[Tuple[str, Tuple]] = (),
                 default: Tuple = ()):
        self.rules: List[Tuple[re.Pattern, Tuple]] = [
            (re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def add(self, pattern: str, spec: Tuple):
        self.rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, name: str, ndim: int) -> Tuple:
        for pat, spec in self.rules:
            if pat.search(name):
                spec = tuple(spec)[:ndim]
                return spec + (None,) * (ndim - len(spec))
        return (None,) * ndim


# Megatron-style TP rules for the transformer layers (q_proj / k_proj /
# v_proj / out_proj, linear1 / linear2, the vocabulary table, the MoE
# layer's stacked experts); Linear weights are (in_features, out_features)
COMMON_TP_RULES = ShardingRules([
    (r"(q|k|v)_proj\.weight$", (None, "tp")),
    (r"(q|k|v)_proj\.bias$", ("tp",)),
    (r"out_proj\.weight$", ("tp", None)),
    (r"linear1\.weight$", (None, "tp")),
    (r"linear1\.bias$", ("tp",)),
    (r"linear2\.weight$", ("tp", None)),
    (r"word_embeddings\.weight$", ("tp", None)),
    (r"experts\..*weight_in$", ("ep", None, "tp")),
    (r"experts\..*weight_out$", ("ep", "tp", None)),
])


def serving_param_rules(layout: str = "gathered") -> ShardingRules:
    """The sharded serving engines' weight layouts over data x fsdp x tp
    (the rules only: the engines come with the serving half of the
    multi-GPU work). "gathered": every large weight splits its output
    dim (the vocabulary for embeddings) jointly over (fsdp, tp), no
    contraction dim is split, so a sharded step is bit-identical to one
    device. "megatron": qkv and ffn-in split (fsdp rows, tp columns),
    attn-out and ffn-out (tp rows, fsdp columns), which sums partial
    products."""
    if layout == "gathered":
        joint = (None, ("fsdp", "tp"))
        return ShardingRules([
            (r"(q|k|v)_proj\.weight$", joint),
            (r"out_proj\.weight$", joint),
            (r"linear[12]\.weight$", joint),
            (r"(^|\.)embed\.weight$", (("fsdp", "tp"), None)),
            (r"word_embeddings\.weight$", (("fsdp", "tp"), None)),
            (r"(^|\.)project\.weight$", joint),
        ])
    if layout == "megatron":
        return ShardingRules([
            (r"(q|k|v)_proj\.weight$", ("fsdp", "tp")),
            (r"(q|k|v)_proj\.bias$", ("tp",)),
            (r"out_proj\.weight$", ("tp", "fsdp")),
            (r"linear1\.weight$", ("fsdp", "tp")),
            (r"linear1\.bias$", ("tp",)),
            (r"linear2\.weight$", ("tp", "fsdp")),
            (r"(^|\.)embed\.weight$", (("fsdp", "tp"), None)),
            (r"word_embeddings\.weight$", (("fsdp", "tp"), None)),
            (r"(^|\.)project\.weight$", ("fsdp", "tp")),
        ])
    raise ValueError(f"unknown serving weight layout {layout!r} "
                     f"(want 'gathered' or 'megatron')")


def infer_param_specs(params: Dict[str, object],
                      rules: Optional[ShardingRules]) -> Dict[str, Tuple]:
    """name -> spec tuple for a flat {name: tensor} tree (nothing split
    without rules)."""
    out = {}
    for name, t in params.items():
        ndim = getattr(t, "ndim", 0)
        out[name] = (None,) * ndim if rules is None else \
            rules.spec_for(name, ndim)
    return out


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Sharding:
    """A spec against one mesh: `spec` with the axes the mesh lacks (or
    holds once) dropped, `splits` the (dim, axes) of each split dim."""

    def __init__(self, mesh: DeviceMesh, spec):
        self.mesh = mesh
        clean = []
        for entry in spec:
            kept = tuple(a for a in _axes(entry) if mesh.axis_size(a) > 1)
            clean.append(None if not kept else
                         kept[0] if len(kept) == 1 else kept)
        self.spec = tuple(clean)
        self.splits = [(d, _axes(e)) for d, e in enumerate(self.spec)
                       if e is not None]

    @property
    def is_split(self):
        return bool(self.splits)

    def axes(self):
        """Every mesh axis some dim splits over."""
        return tuple(a for _, ax in self.splits for a in ax)

    def parts(self, axes):
        n = 1
        for a in axes:
            n *= self.mesh.axis_size(a)
        return n

    def shard_shape(self, shape):
        shape = list(shape)
        for d, ax in self.splits:
            n = self.parts(ax)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {n} over {ax}")
            shape[d] //= n
        return tuple(shape)

    def shard(self, full):
        """This rank's block of a full tensor (a view's contiguous copy)."""
        self.shard_shape(full.shape)
        out = full
        for d, ax in self.splits:
            out = out.chunk(self.parts(ax), d)[self.mesh.coord(ax)]
        return out.contiguous()

    def gather(self, local):
        """The full tensor from every rank's block (collective over each
        split dim's group)."""
        from .. import distributed as D

        out = local.contiguous()
        for d, ax in reversed(self.splits):
            group = self.mesh.group_of(ax)
            parts = D.all_gather([], out, group=group)
            # group members in joint order: reorder from the group's own
            import torch.distributed as dist

            order = dist.get_process_group_ranks(group)
            want = self.mesh.ranks_of(ax)
            parts = [parts[order.index(r)] for r in want]
            out = torch.cat(parts, d)
        return out

    def __repr__(self):
        return f"Sharding({self.spec})"


def named_sharding(spec, mesh: Optional[DeviceMesh] = None) -> Sharding:
    """The spec against the mesh (axis names the mesh lacks dropped, so the
    same rules run on a dp-only mesh)."""
    return Sharding(mesh or get_mesh(), tuple(spec))


def fitted_sharding(shape, spec, mesh: Optional[DeviceMesh] = None):
    """`named_sharding` pruned against a shape: a split whose parts do not
    divide the dim drops its innermost axis until they do (or none is
    left), so an odd vocabulary stays whole instead of failing."""
    m = mesh or get_mesh()

    def fit(entry, dim):
        names = [n for n in _axes(entry) if m.axis_size(n) > 1]
        while names:
            total = 1
            for n in names:
                total *= m.axis_size(n)
            if dim % total == 0:
                break
            names.pop()
        if not names:
            return None
        return names[0] if len(names) == 1 else tuple(names)

    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return named_sharding(tuple(fit(e, d) for e, d in zip(spec, shape)), m)


def batch_sharding(mesh: Optional[DeviceMesh] = None, axes=("dp",),
                   leading=0) -> Sharding:
    """A batch input's sharding: its leading dim (after `leading`
    unsplit dims) over the batch axes that the mesh holds more than
    once."""
    m = mesh or get_mesh()
    first = tuple(a for a in axes if m.axis_size(a) > 1) or None
    if first and len(first) == 1:
        first = first[0]
    return named_sharding((None,) * leading + (first,), m)


def shard_tensor(full, spec, mesh: Optional[DeviceMesh] = None):
    """This rank's block of `full` under `spec` (a spec tuple or a
    Sharding)."""
    sh = spec if isinstance(spec, Sharding) else named_sharding(spec, mesh)
    return sh.shard(full)


def gather_tensor(local, spec, mesh: Optional[DeviceMesh] = None):
    """The full tensor of the ranks' blocks under `spec` (collective)."""
    sh = spec if isinstance(spec, Sharding) else named_sharding(spec, mesh)
    return sh.gather(local)
