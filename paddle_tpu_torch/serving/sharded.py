"""Mesh-sharded serving (the JAX package's `serving/sharded.py`): the
single-card engines' slot lifecycle over a `parallel.mesh` DeviceMesh.

The JAX engine is one process driving every device of the mesh. The
port is multi-controller, one process and one device a rank (the rest of
`parallel` is): every rank of the mesh builds the same engine over the
same whole layers, submits the same requests to its own scheduler in the
same order, and runs the same `run_iteration` loop. The control is
replicated: every host decision (slot choice, admission, eviction, page
mapping, speculation's k, when a disaggregated prefill lands) is made
from values every rank holds alike, and what only some ranks compute
(a dp shard's tokens, an owner row's token 0, the prefill slice's
readiness) is shared over the world before any rank decides on it.

  * **weights** are cut per `parallel.sharding.serving_param_rules`:
    "gathered" (default) splits every large weight's output features
    (the vocabulary rows of an embedding) jointly over (fsdp, tp), so a
    Linear is a column block followed by an all-gather of the columns
    over its (fsdp, tp) line, and no contraction dim is split;
    "megatron" splits contraction dims too (qkv and ffn-in: fsdp rows,
    tp columns; attn-out and ffn-out: tp rows, fsdp columns), the row
    blocks' partial products summed over their axis. Activations stay
    whole on every rank of a line. int8 weights (`quantize="int8"`) are
    quantized whole, then cut (scales with their columns), so the int8
    matmul runs on a column block; the LoRA banks stay whole on every
    rank, and each target's B enters the kernel cut to its layer's
    columns.
  * **the slot pool** splits its slot axis over the decode slice's dp
    rows: a dense pool rank holds only its shard's rows, a join runs on
    the owner row alone and the steps on each rank's shard; the shards'
    tokens are gathered over the world every step, so every rank's
    scheduler sees every emitted token. The paged pool keeps its pages
    and slot rows whole on every rank (the radix prefix cache shares
    prompt pages between slots of any dp row): every paged join runs on
    every rank, the steps on each rank's shard.
  * **prefill/decode disaggregation** (`prefill="disaggregated"`, dense
    only, as in JAX): the last `prefill_dp` dp rows form the prefill
    slice. A join dispatches its prompt to one prefill row (round robin)
    and returns; `_poll_pending` lands it once that row's first rank sees
    it ready (a CUDA event; `poll_block_s` bounds the wait as in JAX)
    and has shared the decision and token 0 over the world. The K/V
    travel point to point from each prefill rank to the owner row's rank
    of the same (fsdp, tp) place (`distributed.send_recv`: through host
    memory under gloo, as they are under NCCL), and land in one splice
    program (one batched program for a bucket's burst).

Numerics contract ("gathered", float32): a column block's product is
the full product's columns, so every request's tokens equal the one-card
engine's; the logits may differ in the last bits where a BLAS rounds a
block otherwise (the tests hold them within a stated tolerance and the
tokens exactly). "megatron" sums partial products in another order: the
same tokens, up to a top-2 tie.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.bucketing import bucket_size, pad_prompt_row
from ..nn.layer.common import Embedding, Linear, _dense
from ..testing import faults
from . import tracing as _rt
from .engine import PagedServingEngine, ServingEngine, _PT_PREFILL
from .layers import ShardedDenseLayout, ShardedPagedLayout, ShardedPlacement

__all__ = ["ShardedServingEngine", "ShardedPagedServingEngine",
           "ServingShardLinear", "ServingShardEmbedding",
           "shard_serving_net"]

#: fault point of the disaggregated splice (a prefill slice's K/V landing
#: in the live pool): chaos tests pin per-request isolation on it
_PT_SPLICE = faults.point("serving.prefill_splice")


class ServingShardLinear(Linear):
    """A Linear of a sharded serving engine, holding the block [rows,
    cols] of its weight: `_rows` (group, lo, hi) when the input features
    split (the block's partial product is summed over the group),
    `_cols` (group, ranks, lo, hi) when the output features split (the
    columns are gathered over the group, in the order of `ranks`). The
    bias is held as the rules place it (whole, or its columns where the
    rules split it too) and joins once, with the block's columns; a LoRA
    target's delta is its columns' (the engine's banks carry B cut to
    them)."""

    _serving_block = True

    def forward(self, x):
        from .. import distributed as D
        from ..nn import functional as F
        from ..ops.quant import current_lora
        from ..parallel.collectives import all_gather_cat

        rows, cols = self._rows, self._cols
        xr = x if rows is None else x[..., rows[1]:rows[2]]
        b = self.bias
        if b is not None and cols is not None and \
                b.shape[0] != cols[3] - cols[2]:
            b = b[cols[2]:cols[3]]
        bias = b if rows is None else None
        if self.weight is None:
            y = F.linear_int8(xr, self.weight_q, self.weight_scale, bias)
        elif bias is None:
            y = torch.matmul(xr, self.weight)
        else:
            y = _dense(xr, self.weight, bias)
        if rows is not None:
            y = D.all_reduce(y.contiguous(), group=rows[0])
            if b is not None:
                y = y + b
        idx = self.__dict__.get("_lora_idx")
        if idx is not None:
            ctx = current_lora()
            if ctx is not None:
                ids, banks = ctx
                A, B = banks[idx]
                y = y + F.lora_delta(x, A, B, ids)
        if cols is not None:
            y = all_gather_cat(y.contiguous(), cols[0], -1, cols[1])
        return y


class ServingShardEmbedding(Embedding):
    """An Embedding of a sharded serving engine holding vocabulary rows
    [_vocab_start, _vocab_start + rows): its ids looked up, the others
    zeroed, summed over `_group` (exact: each id's row lives on one
    rank)."""

    _serving_block = True

    def forward(self, x):
        from .. import distributed as D

        w = self.weight if self.weight is not None else self.weight_q
        inside = (x >= self._vocab_start) & \
            (x < self._vocab_start + w.shape[0])
        out = super().forward(torch.where(inside, x - self._vocab_start, 0))
        out = out * inside[..., None].to(out.dtype)
        return D.all_reduce(out.contiguous(), group=self._group)


def _param(t):
    return torch.nn.Parameter(t.contiguous(), requires_grad=False)


def _cut(mesh, axes, size):
    """(group, ranks, lo, hi) of this rank's block of a dim of `size`
    split over `axes`."""
    n = 1
    for a in axes:
        n *= mesh.axis_size(a)
    step = size // n
    i = mesh.coord(tuple(axes))
    return mesh.group_of(tuple(axes)), mesh.ranks_of(tuple(axes)), \
        i * step, (i + 1) * step


def _shared(net):
    """A deepcopy memo that shares `net`'s tensors and process groups
    (groups cannot be copied; tensors are cut or kept, never cloned)."""
    memo = {id(t): t for t in [*net.parameters(), *net.buffers()]}
    for mod in net.modules():
        for v in mod.__dict__.values():
            for x in (v if isinstance(v, tuple) else (v,)):
                if isinstance(x, dist.ProcessGroup):
                    memo[id(x)] = x
    return memo


def _whole_copy(net):
    """`net` with the blocks of layers cut by `parallel.shard_layer`
    gathered back whole (collective over their groups); `net` itself when
    none is cut. Unsplit tensors are shared, not copied."""
    from ..parallel.collectives import all_gather_cat
    from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                                   VocabParallelEmbedding)

    cut = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    if not any(isinstance(m, cut) for m in net.modules()):
        return net
    out = copy.deepcopy(net, _shared(net))
    with torch.no_grad():
        for mod in out.modules():
            if isinstance(mod, ColumnParallelLinear):
                mod.weight = _param(all_gather_cat(mod.weight, mod._group, 1))
                if mod.bias is not None:
                    mod.bias = _param(all_gather_cat(mod.bias, mod._group, 0))
                mod.__class__ = Linear
            elif isinstance(mod, RowParallelLinear):
                mod.weight = _param(all_gather_cat(mod.weight, mod._group, 0))
                mod.__class__ = Linear
            elif isinstance(mod, VocabParallelEmbedding):
                mod.weight = _param(all_gather_cat(mod.weight, mod._group, 0))
                mod.__class__ = Embedding
            for attr in ("_group", "_ranks", "_vocab_start"):
                mod.__dict__.pop(attr, None)
    return out


def shard_serving_net(net, mesh, rules):
    """A copy of the serving step net with this rank's blocks: every
    Linear / Embedding whose `{name}.weight` the rules split (fitted to
    its shape: a split that does not divide a dim drops axes, as JAX's
    `fitted_sharding`) becomes a `ServingShardLinear` /
    `ServingShardEmbedding` of its block; unsplit tensors are shared with
    `net`. Returns (the copy, {LoRA target index: (lo, hi) of its
    columns, None when whole})."""
    from ..parallel.sharding import fitted_sharding

    out = copy.deepcopy(net, _shared(net))
    lora_cols = {}
    with torch.no_grad():
        for name, mod in out.named_modules():
            prefix = f"{name}." if name else ""
            if isinstance(mod, Linear):
                w = mod.weight if mod.weight is not None else mod.weight_q
                sh = fitted_sharding(tuple(w.shape), rules.spec_for(
                    prefix + "weight", 2), mesh)
                rows = cols = None
                r0, r1, c0, c1 = 0, w.shape[0], 0, w.shape[1]
                for dim, axes in sh.splits:
                    g, ranks, lo, hi = _cut(mesh, axes, w.shape[dim])
                    if dim == 0:
                        rows, (r0, r1) = (g, lo, hi), (lo, hi)
                    else:
                        cols, (c0, c1) = (g, ranks, lo, hi), (lo, hi)
                idx = mod.__dict__.get("_lora_idx")
                if idx is not None:
                    lora_cols[idx] = None if cols is None else (c0, c1)
                if not sh.is_split:
                    continue
                if mod.weight is not None:
                    mod.weight = _param(mod.weight[r0:r1, c0:c1])
                else:
                    mod.weight_q = mod.weight_q[r0:r1, c0:c1].contiguous()
                    mod.weight_scale = mod.weight_scale[c0:c1].contiguous()
                if mod.bias is not None and cols is not None and \
                        fitted_sharding(tuple(mod.bias.shape), rules.spec_for(
                            prefix + "bias", 1), mesh).is_split:
                    # the rules split the bias too: with the columns
                    mod.bias = _param(mod.bias[c0:c1])
                mod._rows, mod._cols = rows, cols
                mod.__class__ = ServingShardLinear
            elif isinstance(mod, Embedding):
                w = mod.weight if mod.weight is not None else mod.weight_q
                sh = fitted_sharding(tuple(w.shape), rules.spec_for(
                    prefix + "weight", 2), mesh)
                if not sh.is_split:
                    continue
                (dim, axes), = sh.splits
                if dim != 0:
                    raise NotImplementedError(
                        f"{name}: a serving embedding splits its vocabulary "
                        f"rows only")
                g, _, lo, hi = _cut(mesh, axes, w.shape[0])
                if mod.weight is not None:
                    mod.weight = _param(mod.weight[lo:hi])
                else:
                    # the scales are per embedding column: whole
                    mod.weight_q = mod.weight_q[lo:hi].contiguous()
                mod._group, mod._vocab_start = g, lo
                mod.__class__ = ServingShardEmbedding
    return out, lora_cols


class ShardedServingEngine(ServingEngine):
    """`ServingEngine` over a device mesh; every rank of the mesh builds it
    over the same whole layers and drives it alike (see the module's
    docstring). Extra knobs:

      mesh       parallel.DeviceMesh (default: the installed one). Needs a
                 `dp` axis whose size (the decode slice's) divides
                 `num_slots`; `fsdp` / `tp` axes cut the weights where
                 present (absent axes drop out of the rules, so the same
                 engine runs on a dp-only mesh).
      rules      parallel.ShardingRules for the step net's weights
                 (default: `serving_param_rules(layout)`).
      layout     "gathered" (default) | "megatron" (`weight_layout`).
      prefill    "inline" (joins block, one-card semantics) |
                 "disaggregated" (the prompt prefills on the prefill
                 slice; joins land asynchronously).
      prefill_dp how many dp rows the prefill slice takes (default 1).

    `paged=True` routes to `ShardedPagedServingEngine`. The device is
    the mesh's unless `device=` says otherwise. The weights are cut at
    construction: after updating the layers in place call
    `refresh_params()`. Chunked prefill (`prefill_chunk`) is not wired
    into the sharded pools and raises."""

    _accepts_sharded_params = True

    def __new__(cls, *args, **kw):
        if cls is ShardedServingEngine and kw.get("paged"):
            return object.__new__(ShardedPagedServingEngine)
        return object.__new__(cls)

    def __init__(self, decoder, embed, project, *, mesh=None, rules=None,
                 layout="gathered", prefill="inline", prefill_dp=1,
                 num_slots=8, max_len=128, **kw):
        from ..parallel.mesh import get_mesh
        from ..parallel.sharding import serving_param_rules

        if kw.get("prefill_chunk") is not None:
            raise NotImplementedError(
                "prefill_chunk on a sharded engine: chunked prefill is not "
                "wired into the sharded pools (serve chunked prompts on a "
                "one-card engine)")
        self._mesh = mesh if mesh is not None else get_mesh()
        self._rules = rules if rules is not None \
            else serving_param_rules(layout)
        #: the weights' layout ("gathered" | "megatron"); `layout` is the
        #: cache layout object, as on every engine
        self.weight_layout = layout
        if prefill not in ("inline", "disaggregated"):
            raise ValueError(
                f"prefill policy must be 'inline' or 'disaggregated', "
                f"got {prefill!r}")
        self._prefill_policy = prefill
        dp = self._mesh.axis_size("dp")
        me = self._mesh.coord("dp") if "dp" in self._mesh.axis_names else 0
        if prefill == "disaggregated":
            prefill_dp = int(prefill_dp)
            if dp < prefill_dp + 1:
                raise ValueError(
                    f"disaggregated prefill needs dp >= {prefill_dp + 1} "
                    f"(a decode slice plus {prefill_dp} prefill row(s)); "
                    f"mesh has dp={dp}")
            self._decode_dm = self._mesh.slice_axis("dp", 0, dp - prefill_dp)
            self._prefill_dm = self._mesh.slice_axis("dp", dp - prefill_dp,
                                                     dp)
            self._prefill_rows = prefill_dp
        else:
            self._decode_dm = self._mesh
            self._prefill_dm = None
            self._prefill_rows = 0
        self._pool_dp = max(1, self._decode_dm.axis_size("dp"))
        if int(num_slots) % self._pool_dp:
            raise ValueError(
                f"num_slots ({num_slots}) must be divisible by the "
                f"decode slice's dp axis ({self._pool_dp}): the slot "
                f"pool shards over it")
        #: this rank's place: its dp row, whether it decodes (else it
        #: prefills: its row of the prefill slice)
        self._decodes = me < self._pool_dp
        self._dp_row = me if self._decodes else None
        self._prefill_row = None if self._decodes else me - self._pool_dp
        self._local_pool = not kw.get("paged", False)
        self._pending_info = {}
        self._prefill_turn = 0
        self._lora_banks = None
        #: seconds a dispatched prefill may stay not-ready before
        #: _poll_pending stops polling and blocks for it
        self.poll_block_s = 0.5
        kw.setdefault("device", self._mesh.device)
        super().__init__(decoder, embed, project, num_slots=num_slots,
                         max_len=max_len, **kw)
        self.layout = (ShardedPagedLayout(self)
                       if isinstance(self, PagedServingEngine)
                       else ShardedDenseLayout(self))
        self._full_net = self._net
        self._n_params = sum(t.numel() for t in [
            *self._full_net.parameters(), *self._full_net.buffers()])
        self._place_params()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _make_placement(self):
        return ShardedPlacement(self)

    def _place_params(self):
        """Cut this rank's blocks of the (possibly updated) whole layers
        (timed into the collective budget: the engine-driven traffic)."""
        t0 = time.monotonic()
        self._net, self._lora_cols = shard_serving_net(
            _whole_copy(self._full_net), self._mesh, self._rules)
        self._net.eval()
        self._lora_banks = None
        self._fingerprint = None
        self.metrics.record_collective(time.monotonic() - t0)

    def refresh_params(self):
        """Re-cut the (possibly updated) layer weights into this rank's
        blocks; the program cache stays."""
        self._place_params()
        self._weights_bytes = None

    # ---- adapter banks on the mesh ----
    def _placed_banks(self):
        """The LoRA banks as this rank's layers take them: A whole, each
        target's B cut to its layer's columns (contiguous copies, re-cut
        only when a load moves the pool's version)."""
        pool = self._apool
        cached = self._lora_banks
        if cached is not None and cached[0] == pool.version:
            return cached[1]
        banks = []
        for i, (A, B) in enumerate(pool.banks()):
            cols = self._lora_cols.get(i)
            banks.append((A, B if cols is None
                          else B[:, :, cols[0]:cols[1]].contiguous()))
        self._lora_banks = (pool.version, banks)
        return banks

    def _lora_ctx(self, rows):
        import contextlib

        if self._apool is None:
            return contextlib.nullcontext()
        from ..ops.quant import lora_scope

        return lora_scope(np.asarray(rows, np.int32).reshape(-1),
                          self._placed_banks())

    def weights_bytes(self):
        """GLOBAL logical weight bytes: the whole model (and, under
        disaggregation, the prefill slice's second copy), the number
        capacity planning sums against the cards' memory, as the JAX
        engine reports."""
        if self._weights_bytes is None:
            b = sum(t.numel() * t.element_size() for t in [
                *self._full_net.parameters(), *self._full_net.buffers()])
            self._weights_bytes = b * (2 if self._prefill_dm is not None
                                       else 1)
        return self._weights_bytes

    # ------------------------------------------------------------------
    # shard-aware slot policy + gauges
    # ------------------------------------------------------------------
    def _shard_of(self, s):
        return s // (self.num_slots // self._pool_dp)

    def _shard_occupancies(self):
        per = self.num_slots // self._pool_dp
        return [sum(self.slots[g * per + i] is not None
                    for i in range(per)) / per
                for g in range(self._pool_dp)]

    def _choose_slot(self, free):
        """Balance occupancy across the dp shards of the slot axis so one
        mesh row never saturates while another idles."""
        occ = self._shard_occupancies()
        return min(free, key=lambda s: (occ[self._shard_of(s)], s))

    def _iteration_gauges(self):
        gauges = dict(super()._iteration_gauges() or {})
        gauges["shard_occupancy"] = self._shard_occupancies()
        return gauges

    def _pool_variant(self):
        return "sharded-" + super()._pool_variant()

    # ------------------------------------------------------------------
    # disaggregated prefill: dispatch on the prefill slice, land
    # asynchronously in the live pool
    # ------------------------------------------------------------------
    def _join(self, s, r):
        """A join every rank agrees on: its token 0 (the owner row's; the
        other ranks give -1) and whether it failed anywhere come back from
        one all-reduce, so a join that fails on some ranks fails on all
        (the slot lifecycle stays replicated)."""
        tok, err = None, None
        try:
            if self._prefill_dm is None:
                tok = super()._join(s, r)
            else:
                tok = self._dispatch_prefill(s, r)
        except Exception as e:
            err = e
        t = torch.tensor([-1 if tok is None else int(tok.reshape(())),
                          0 if err is None else 1], dtype=torch.int64)
        got = self.placement.max_over_world(t.to(self.device)).cpu()
        if int(got[1]):
            if self._prefill_dm is not None:
                # the dispatch registered nothing where it failed
                self._pending.discard(s)
                self._pending_info.pop(s, None)
            raise err if err is not None else RuntimeError(
                f"slot {s}'s join failed on another rank of the mesh")
        if tok is None:
            return None
        return torch.full((), int(got[0]), dtype=torch.int64,
                          device=self.device)

    def _leads(self, prow):
        """True on the first rank of prefill row `prow` (it decides when
        that row's prefills land)."""
        if self._prefill_row != prow:
            return False
        return all(self._mesh.coord(a) == 0 for a in self._mesh.axis_names
                   if a != "dp")

    def _dispatch_prefill(self, s, r):
        _PT_PREFILL()
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, Pb = pad_prompt_row(r.prompt, pad_id)
        memory = r.memory.to(self.device)
        self._ensure_state(memory)
        prow = self._prefill_turn % self._prefill_rows
        self._prefill_turn += 1
        prompt = torch.as_tensor(prompt_b, device=self.device)

        def dispatch(row):
            if self._prefill_row != prow:
                return None, None
            fn = self._program(("prefill", Pb), self.layout.prefill)
            outs = self.placement.run(fn, prompt, P0, memory[None], row)
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
            return outs, ev

        outs, ev = self._pinned_join(s, r, dispatch)
        self._pending.add(s)
        self._pending_info[s] = {
            "req": r, "outs": outs, "event": ev, "Pb": Pb, "P0": P0,
            "prompt": prompt, "prow": prow, "t0": time.monotonic()}
        return None   # token 0 comes with the splice

    def _travel(self, ss, nb):
        """The prefill outputs of slots `ss` (one bucket; padded to `nb`
        entries by repeating the first) from their prefill rows to the
        owner rows, rank to rank at the same (fsdp, tp, ...) place; on an
        owner rank returns (tok0s [nb], kvs [(K, V) [nb, 1, H, Pb, D]],
        statics [(K, V) [nb, 1, H, M, D]], bias rows [nb, 1, L]), else
        None."""
        from .. import distributed as D

        mesh, me = self._mesh, dist.get_rank() if dist.is_initialized() \
            else 0
        ax = mesh.axis_names.index("dp")
        where = np.argwhere(mesh.ranks == me)[0]

        def peer(dp_row):
            idx = list(where)
            idx[ax] = dp_row
            return int(mesh.ranks[tuple(idx)])

        infos = [self._pending_info[s] for s in ss]
        ix = list(range(len(ss))) + [0] * (nb - len(ss))
        Pb = infos[0]["Pb"]
        dec = self._net.decoder.layers
        M, Dm = self._mem_shape
        dt, dev = self._dtype, self.device

        def shapes():
            out = [((nb,), torch.int64), ((nb, 1, self._pool_len),
                                          torch.float32)]
            for ly in dec:
                a = ly.self_attn
                out += [((nb, 1, a.num_heads, Pb, a.head_dim), dt)] * 2
            for ly in dec:
                c = ly.cross_attn
                out += [((nb, 1, c.num_heads, M, c.head_dim), dt)] * 2
            return out

        sends, recvs, got = [], [], {}
        for prow in sorted({i["prow"] for i in infos}):
            for g in sorted({self._shard_of(s) for s in ss}):
                sel = [j for j, k in enumerate(ix)
                       if infos[k]["prow"] == prow and
                       self._shard_of(ss[k]) == g]
                if not sel:
                    continue
                if self._prefill_row == prow:
                    flat = self._stack_outs([infos[ix[j]]["outs"]
                                             for j in sel])
                    sends += [(t, peer(g)) for t in flat]
                elif self._decodes and self._dp_row == g:
                    bufs = [torch.empty((len(sel),) + shp[0][1:], dtype=shp[1],
                                        device=dev) for shp in shapes()]
                    recvs += [(t, peer(self._pool_dp + prow)) for t in bufs]
                    got[(prow, g)] = (sel, bufs)
        D.send_recv(sends, recvs)
        if not got:
            return None
        full = [torch.empty(shp, dtype=d, device=dev) for shp, d in shapes()]
        for sel, bufs in got.values():
            idx = torch.as_tensor(sel, device=dev)
            for f, b in zip(full, bufs):
                f.index_copy_(0, idx, b)
        n = len(dec)
        kvs = [(full[2 + 2 * i], full[3 + 2 * i]) for i in range(n)]
        statics = [(full[2 + 2 * n + 2 * i], full[3 + 2 * n + 2 * i])
                   for i in range(n)]
        return full[0], kvs, statics, full[1]

    @staticmethod
    def _stack_outs(outs):
        """[(tok0, kvs, statics, bias_row)] -> the flat list of stacked
        tensors `_travel` sends."""
        flat = [torch.stack([o[0].reshape(()).to(torch.int64)
                             for o in outs]),
                torch.stack([o[3] for o in outs])]
        n = len(outs[0][1])
        for i in range(n):
            flat += [torch.stack([o[1][i][0] for o in outs]),
                     torch.stack([o[1][i][1] for o in outs])]
        for i in range(n):
            flat += [torch.stack([o[2][i][0] for o in outs]),
                     torch.stack([o[2][i][1] for o in outs])]
        return flat

    def _splice_entries(self, ss, nb, travelled, prompts, lengths):
        """Land the travelled entries of slots `ss` (their bucketed prompts
        [1, Pb] and true lengths) on their owner ranks, the per-entry
        splice in order (a padded entry repeats entry 0: idempotent)."""
        tok0s, kvs, statics, bias_rows = travelled
        ix = list(range(len(ss))) + [0] * (nb - len(ss))
        for j, k in enumerate(ix):
            self.layout.splice(
                ss[k], tok0s[j], bias_rows[j],
                [(a[j], b[j]) for a, b in kvs],
                [(a[j], b[j]) for a, b in statics], prompts[k], lengths[k])

    def _fail_pending_splice(self, s, r, e):
        """Per-request isolation: the failed splice fails THIS request,
        frees the slot, the pool keeps serving."""
        self.slots[s] = None
        self._evict(s)
        r.slot = None
        if r._trace is not None:
            _rt.on_splice_end(r, ok=False, error=e)
        self.metrics.record_error("prefill_splice", e)
        r.fail(e, self.clock())
        self.metrics.record_finish("error", len(r.tokens))
        self._cbs.emit("on_finish", r)

    def _finish_splice(self, s, r, tok0):
        self._pending.discard(s)
        self._pending_info.pop(s, None)
        if r._trace is not None:
            _rt.on_splice_end(r, ok=True)
        self._deliver(r, tok0, self.clock())

    def _splice(self, Pb, ss, toks):
        """Land slots `ss` of bucket Pb: one `("splice", Pb)` program for
        a single entry, one `("bsplice", Pb, nb)` program (nb: the count's
        power-of-two bucket) for a burst. A failure fails the entries'
        requests only."""
        reqs = [self.slots[s] for s in ss]
        nb = 1 if len(ss) == 1 else bucket_size(len(ss))
        key = ("splice", Pb) if nb == 1 else ("bsplice", Pb, nb)
        try:
            err = None
            try:
                t1 = time.monotonic()
                travelled = self._travel(ss, nb)
                self.metrics.record_collective(time.monotonic() - t1)
                fn = self._program(key, self._splice_entries)
                if travelled is not None:
                    infos = [self._pending_info[s] for s in ss]
                    self.placement.run(fn, ss, nb, travelled,
                                       [i["prompt"] for i in infos],
                                       [i["P0"] for i in infos])
            except Exception as e:
                err = e
            self.placement.agree(err)
        except Exception as e:
            for s, r in zip(ss, reqs):
                self._fail_pending_splice(s, r, e)
            return False
        for s, r, tok in zip(ss, reqs, toks):
            self._finish_splice(s, r, tok)
        return True

    def _poll_pending(self, now):
        """Land every finished prefill (once an iteration). The first rank
        of each prefill row decides for its row's entries: ready (its CUDA
        event passed), or past `poll_block_s`, or nothing decodes (every
        occupied slot is pending: blocking costs no overlap), and then
        waits for it; the decisions and tokens 0 are shared over the
        world (the max of each entry's token, -1 where not ready), so
        every rank lands the same entries. Ready entries group by prompt
        bucket: a bucket's burst lands as one program."""
        if not self._pending:
            return False
        entries = []
        for s in sorted(self._pending):
            if self._pending_info.get(s) is None or self.slots[s] is None:
                self._pending.discard(s)          # evicted while pending
                self._pending_info.pop(s, None)
                continue
            entries.append(s)
        if not entries:
            return False
        flags = torch.full((len(entries),), -1, dtype=torch.int64)
        spin = self.occupancy() == len(self._pending)
        for i, s in enumerate(entries):
            info = self._pending_info[s]
            if not self._leads(info["prow"]):
                continue
            ev = info["event"]
            if ev is not None and not ev.query():
                if not spin and \
                        time.monotonic() - info["t0"] < self.poll_block_s:
                    continue
                ev.synchronize()
            flags[i] = int(info["outs"][0])
        flags = self.placement.max_over_world(
            flags.to(self.device)).cpu().tolist()
        ready = []
        for s, tok in zip(entries, flags):
            if tok < 0:
                continue
            r = self.slots[s]
            self.metrics.record_prefill_step(
                time.monotonic() - self._pending_info[s]["t0"])
            # the fault point fires PER REQUEST before any batching, so an
            # injected splice fault isolates exactly one request
            try:
                _PT_SPLICE()
            except Exception as e:
                self._fail_pending_splice(s, r, e)
                continue
            ready.append((s, tok))
        groups = {}
        for s, tok in ready:
            groups.setdefault(self._pending_info[s]["Pb"], []).append(
                (s, tok))
        activated = False
        for Pb, items in sorted(groups.items()):
            activated |= self._splice(Pb, [s for s, _ in items],
                                      [t for _, t in items])
        return activated

    def _evict(self, s):
        self._pending_info.pop(s, None)
        super()._evict(s)

    # ------------------------------------------------------------------
    # zero-warmup startup: the sharded program set
    # ------------------------------------------------------------------
    def _program_fingerprint(self):
        # the mesh geometry, this rank's place, the prefill policy and the
        # weights' layout change the programs: fold them into the
        # persistent cache's identity
        coords = ",".join(f"{a}{self._mesh.coord(a)}"
                          for a in self._mesh.axis_names)
        return (f"{super()._program_fingerprint()}|"
                f"mesh{'x'.join(str(v) for v in self._mesh.shape.values())}"
                f"@{coords}|dp{self._pool_dp}|{self._prefill_policy}|"
                f"{self.weight_layout}")

    def precompile(self, memory, *, cache=None, **kw):
        """`ServingEngine.precompile` on every rank of the mesh (collective:
        the startup runs hold the step's exchange). A cache directory is
        kept per rank (`<cache>/rank<r>`): the cache's manifest has one
        writer."""
        import os

        if isinstance(cache, (str, os.PathLike)):
            rank = dist.get_rank() if dist.is_initialized() else 0
            cache = os.path.join(os.fspath(cache), f"rank{rank}")
        return super().precompile(memory, cache=cache, **kw)

    def _program_from_cache(self, ck, cache, cuda):
        """Every rank takes a program from the cache, or none does: a
        program's first run may hold collectives, which every rank must
        enter alike."""
        hit = super()._program_from_cache(ck, cache, cuda)
        flag = torch.tensor([1 if hit else 0], dtype=torch.int64)
        if dist.is_initialized() and dist.get_world_size() > 1:
            from .. import distributed as D

            flag = self.placement._collective_tensor(flag.to(self.device))
            D.all_reduce(flag, op=D.ReduceOp.MIN)
        return bool(int(flag.reshape(-1)[0]))

    def _startup_programs(self, prompt_buckets):
        """The one-card program set with each rank's join on its own first
        slot; under disaggregation the prefill, splice and 2-burst splice
        programs in place of the joins. Every rank readies the same keys
        in the same order (a body that is not a rank's business returns
        at once)."""
        progs = super()._startup_programs(prompt_buckets)
        own = self.placement.bounds()[0]
        out = []
        for key, body, args in progs:
            if key[0] == "join":
                if self._prefill_dm is not None:
                    continue
                args = (own,) + tuple(args[1:])
            out.append((key, body, args))
        if self._prefill_dm is None:
            return out
        M, Dm = self._mem_shape
        dev, dt = self.device, self._dtype
        mem1 = torch.zeros((1, M, Dm), dtype=dt, device=dev)
        for Pb in sorted({bucket_size(int(p)) for p in prompt_buckets}):
            out.append((("prefill", Pb), self.layout.prefill,
                        (torch.zeros((1, Pb), dtype=torch.long, device=dev),
                         1, mem1, 0)))
            for nb in (1, 2):
                key = ("splice", Pb) if nb == 1 else ("bsplice", Pb, 2)
                out.append((key, self._splice_entries,
                            self._startup_splice_args(Pb, nb)))
        return out

    def _startup_splice_args(self, Pb, nb):
        """A splice program's startup arguments: zero outputs landing in
        this rank's first slot of the scratch pool (a no-op off the
        decode slice)."""
        dt, dev = self._dtype, self.device
        M, _ = self._mem_shape
        dec = self._net.decoder.layers

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(a, n):
            return (z(nb, 1, a.num_heads, n, a.head_dim),
                    z(nb, 1, a.num_heads, n, a.head_dim))

        travelled = (z(nb, dtype=torch.int64),
                     [kv(ly.self_attn, Pb) for ly in dec],
                     [kv(ly.cross_attn, M) for ly in dec],
                     z(nb, 1, self._pool_len, dtype=torch.float32))
        s = self.placement.bounds()[0] if self._decodes else -1
        return ([s], nb, travelled, [z(1, Pb, dtype=torch.long)], [1])


class ShardedPagedServingEngine(ShardedServingEngine, PagedServingEngine):
    """`ShardedServingEngine(..., paged=True)`: the paged pool's host
    bookkeeping (allocator, prefix cache, copy-on-write, page tables) is
    the one-card engine's; the pages and slot rows are whole on every
    rank, the steps run on each rank's dp shard of the slots (see
    `layers.ShardedPagedLayout`). Page reads and writes are selections,
    so with `kv_dtype=None` the tokens are the dense engine's.

    Disaggregated prefill is not wired through the paged join (prefix
    attach and copy-on-write interleave with allocation on the host), as
    in JAX: `prefill="disaggregated"` raises."""

    def __init__(self, decoder, embed, project, *, prefill="inline", **kw):
        if prefill != "inline":
            raise NotImplementedError(
                "ShardedPagedServingEngine supports prefill='inline' only "
                "(disaggregation of the paged join, prefix attach and "
                "copy-on-write, is not wired); use the dense "
                "ShardedServingEngine for disaggregated prefill")
        kw.pop("paged", None)
        super().__init__(decoder, embed, project, prefill="inline",
                         paged=True, **kw)

    def _check_params(self):
        """The prefix cache holds model-derived pages: an in-place change
        of the WHOLE layers' weights flushes it and re-cuts the blocks."""
        cur = tuple((p.data_ptr(), p._version)
                    for p in self._full_net.parameters())
        if self._prefix_params is not None and cur != self._prefix_params:
            self.flush_prefix_cache()
            self._place_params()
        self._prefix_params = cur
