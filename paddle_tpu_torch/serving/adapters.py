"""Multi-tenant adapter serving: batched LoRA banks over one shared base
(the JAX package's `serving/adapters.py`).

One serving engine carries many tenants:

  * every target Linear of the decoder (self-attention Q/K/V/out and the
    FFN pair, per layer) gets a row in stacked banks ``A [capacity, d_in,
    r]`` / ``B [capacity, r, d_out]``; row 0 is the base model and stays
    all-zero, so base requests ride the same step with an exactly-zero
    delta;
  * the per-slot bank rows reach every join and step through
    `ops.quant.lora_scope`, and each target adds its delta through ONE
    gathered batched matmul (`ops.quant.lora_delta`, the
    `csrc/lora_gather.cu` kernel on the card);
  * `AdapterPool` is the host-side bookkeeping, on the PageAllocator
    pattern: a free list and refcounts over bank rows, LRU reuse of
    zero-reference rows (a released adapter stays hot until its row is
    needed: the adapter cache), and `OutOfAdapters` backpressure when
    every row is pinned by a live slot (the engine defers the queue head,
    as for out-of-pages);
  * `quantize_net` applies the int8 weight path to the whole serving
    stack, shrinking the base weights the tenants share.

The banks live on the decoder's device. An adapter load writes its bank
row in place (``A[row].copy_(...)``), on the current stream: steps
already queued read the banks before the write, and a row is only
written while no live slot holds it. Single-threaded by the engine
contract, like the PageAllocator.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

__all__ = ["OutOfAdapters", "AdapterPool", "quantize_net",
           "decoder_lora_targets"]


class OutOfAdapters(RuntimeError):
    """Every adapter bank row is pinned by a live slot: backpressure. The
    engine defers the queue head until a tenant's last slot drains and
    frees a row."""


def decoder_lora_targets(decoder):
    """The per-layer large dense matmuls adapters attach to: self-attention
    Q/K/V/out projections and the FFN pair, in layer order. Cross-attention
    and the norms stay base-only (a prefix-hit attach runs the
    cross-attention K/V alone, so it needs no banks)."""
    out = []
    for layer in decoder.layers:
        sa = layer.self_attn
        out.extend((sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj))
        out.extend((layer.linear1, layer.linear2))
    return out


def quantize_net(decoder, embed=None, project=None):
    """int8-quantize every large dense weight of a serving stack: the
    decoder's self- and cross-attention projections and FFN pairs, the
    token embedding's table and the logits projection (symmetric
    per-output-channel scales, float32 compute kept; biases and norms stay
    float32). In place and one-way. Returns the number of layers
    quantized."""
    n = 0
    for layer in decoder.layers:
        for attn in (layer.self_attn, layer.cross_attn):
            for lin in (attn.q_proj, attn.k_proj, attn.v_proj,
                        attn.out_proj):
                lin.quantize_int8()
                n += 1
        layer.linear1.quantize_int8()
        layer.linear2.quantize_int8()
        n += 2
    for mod in (embed, project):
        if mod is not None and hasattr(mod, "quantize_int8"):
            mod.quantize_int8()
            n += 1
    return n


def _device_of(module):
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return torch.device("cpu")


class AdapterPool:
    """Refcounted hot-load and eviction of LoRA adapter banks for one
    serving engine. `capacity` counts bank rows INCLUDING the reserved
    base row 0; `rank` is the shared low rank r; `alpha` the LoRA scaling
    (B is stored pre-scaled by alpha / r, so the served delta and the
    merged-weight oracle share one convention). Tenants `register()`
    host-side weights once; `acquire()` pins a bank row for a slot
    (loading over the LRU zero-reference row on a miss) and `release()`
    unpins it. A zero-reference adapter stays hot until its row is
    reused: the adapter cache the hit rate measures."""

    def __init__(self, decoder, *, capacity=4, rank=8, alpha=None):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (the reserved base row "
                             "plus at least one adapter)")
        if rank < 1:
            raise ValueError("rank must be >= 1")
        self.decoder = decoder
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.targets = decoder_lora_targets(decoder)
        self._dims = []
        for i, lin in enumerate(self.targets):
            lin._lora_idx = i
            self._dims.append((int(lin.in_features), int(lin.out_features)))
        dev = _device_of(decoder)
        self._A = [torch.zeros((self.capacity, din, self.rank),
                               dtype=torch.float32, device=dev)
                   for din, _ in self._dims]
        self._B = [torch.zeros((self.capacity, self.rank, dout),
                               dtype=torch.float32, device=dev)
                   for _, dout in self._dims]
        self._registry = {}        # name -> [(A, B scaled) numpy]
        self._gen = {}             # name -> registration count: the paged
        #                            engine's per-tenant prefix keys carry
        #                            it, so re-registered weights never
        #                            serve a stale cached prefix
        self._rows = {}            # name -> hot bank row
        self._row_name = {}        # row -> name
        self.refcount = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, 0, -1))
        self._lru = collections.OrderedDict()   # zero-reference hot rows
        self.loads = 0
        #: bumps on every bank write (a sharded engine re-cuts its column
        #: blocks of the banks when it moves)
        self.version = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        self._metrics = None
        self._invalidate_cbs = []

    # ---- engine wiring ----
    def bind_metrics(self, metrics):
        """The engine mirrors pool events into its metrics' tenancy
        section."""
        self._metrics = metrics

    # ---- tenant registry (host-side cold storage) ----
    def register(self, name, weights):
        """Register a tenant's adapter: `weights` is a list aligned with
        `targets` of (A [d_in, r], B [r, d_out]) arrays, or None for a
        target the adapter leaves at base. B is stored pre-scaled by
        alpha / r. Re-registering swaps the weights: refused while a live
        slot holds the tenant; a zero-reference hot row is dropped so the
        next acquire reloads it, and the generation bumps (subscribers of
        `on_invalidate` drop the tenant's cached prefixes)."""
        if name is None or name == "base":
            raise ValueError("adapter name None/'base' is reserved for the "
                             "base model")
        if len(weights) != len(self.targets):
            raise ValueError(f"adapter {name!r} has {len(weights)} target "
                             f"entries, pool targets {len(self.targets)}")
        s = self.alpha / self.rank
        stored = []
        for i, wpair in enumerate(weights):
            din, dout = self._dims[i]
            if wpair is None:
                stored.append((np.zeros((din, self.rank), np.float32),
                               np.zeros((self.rank, dout), np.float32)))
                continue
            wa = np.asarray(wpair[0], np.float32)
            wb = np.asarray(wpair[1], np.float32) * s
            if wa.shape != (din, self.rank) or wb.shape != (self.rank, dout):
                raise ValueError(
                    f"adapter {name!r} target {i}: shapes {wa.shape}/"
                    f"{wb.shape} != ({din}, {self.rank})/({self.rank}, "
                    f"{dout})")
            stored.append((wa, wb))
        row = self._rows.get(name)
        if row is not None:
            if self.refcount[row] > 0:
                raise ValueError(f"adapter {name!r} is pinned by a live "
                                 f"slot; drain it before re-registering new "
                                 f"weights")
            self._lru.pop(row, None)
            del self._rows[name]
            del self._row_name[row]
            self._free.append(row)
        self._registry[name] = stored
        self._gen[name] = self._gen.get(name, 0) + 1
        for cb in self._invalidate_cbs:
            cb(name, self._gen[name])
        return self

    def generation(self, name):
        """Registration generation of `name` (0 = unregistered): folded
        into the paged engine's per-tenant prefix keys."""
        return self._gen.get(name, 0)

    def on_invalidate(self, cb):
        """Subscribe `cb(name, new_generation)` to re-registrations (the
        paged engine drops the tenant's prefix subtree then). Callbacks
        must hold only weak references to long-lived owners."""
        self._invalidate_cbs.append(cb)
        return cb

    def register_random(self, name, seed=0, scale=0.1):
        """A deterministic random adapter on every target, drawn with
        numpy's RandomState(seed): the JAX package's draws, so both
        packages get the same adapter from the same seed."""
        rs = np.random.RandomState(seed)
        ws = [(rs.randn(din, self.rank).astype(np.float32) * scale,
               rs.randn(self.rank, dout).astype(np.float32) * scale)
              for din, dout in self._dims]
        return self.register(name, ws)

    def registered(self, name):
        return name in self._registry

    def tenants(self):
        return sorted(self._registry)

    def merged_weights(self, name):
        """[(target index, merged W' = W + A @ B_scaled)] for a registered
        tenant: the weights of a solo engine the factored path is held to.
        Needs the targets' float32 weights (merge before `quantize_net`)."""
        from ..ops.quant import merge_lora_weight

        out = []
        for i, (wa, wb) in enumerate(self._registry[name]):
            lin = self.targets[i]
            if lin.weight is None:
                raise ValueError("merged_weights needs float32 target "
                                 "weights (these were quantized in place)")
            out.append((i, merge_lora_weight(lin.weight.detach(), wa, wb)))
        return out

    # ---- hot rows: acquire / release / load ----
    def can_acquire(self, name):
        """Admission headroom: True when `name` is hot or a bank row is
        free or evictable now. The engine's admission gate defers the
        request on False instead of letting the join raise."""
        return name in self._rows or bool(self._free) or bool(self._lru)

    def acquire(self, name):
        """Pin a bank row for one slot serving `name` and return it (0 for
        the base model). A hot adapter is a cache hit; a miss loads into a
        free row, or evicts the LRU zero-reference adapter for its row.
        Raises KeyError for an unregistered name and OutOfAdapters when
        every row is pinned."""
        if name is None:
            return 0
        if name not in self._registry:
            raise KeyError(f"adapter {name!r} is not registered (tenants: "
                           f"{self.tenants()})")
        row = self._rows.get(name)
        if row is not None:
            self.hits += 1
            if self._metrics is not None:
                self._metrics.record_adapter_acquire(True)
            self._lru.pop(row, None)
            self.refcount[row] += 1
            return row
        self.misses += 1
        if self._metrics is not None:
            self._metrics.record_adapter_acquire(False)
        if self._free:
            row = self._free.pop()
        elif self._lru:
            row, _ = self._lru.popitem(last=False)
            old = self._row_name.pop(row)
            del self._rows[old]
            self.evictions += 1
            if self._metrics is not None:
                self._metrics.record_adapter_eviction()
        else:
            raise OutOfAdapters(f"every adapter row is pinned by a live "
                                f"slot ({self.capacity - 1} rows, base "
                                f"excluded)")
        try:
            self._load(row, name)
        except Exception:
            # the row never became visible: back to the free list
            self._free.append(row)
            raise
        self._rows[name] = row
        self._row_name[row] = name
        self.refcount[row] = 1
        return row

    def _load(self, row, name):
        """Write every target's bank row from the registry, in place."""
        for i, (wa, wb) in enumerate(self._registry[name]):
            self._A[i][row].copy_(torch.from_numpy(wa))
            self._B[i][row].copy_(torch.from_numpy(wb))
        self.loads += 1
        self.version += 1
        if self._metrics is not None:
            self._metrics.record_adapter_load()

    def release(self, row):
        """Unpin one slot's reference. A row at zero references stays hot
        (LRU-evictable): the next acquire of the tenant is a cache hit."""
        row = int(row)
        if row == 0:
            return
        if self.refcount[row] <= 0:
            raise RuntimeError(f"release on unpinned adapter row {row}")
        self.refcount[row] -= 1
        if self.refcount[row] == 0:
            self._lru[row] = True

    # ---- the banks the bodies take ----
    def banks(self):
        """[(A, B)] per target, the tensors every adapter-carrying body
        reads (loads update them in place)."""
        return list(zip(self._A, self._B))

    def bytes(self):
        """Device bytes of the stacked banks: capacity * (d_in + d_out) *
        r * 4 summed over the targets."""
        return sum(a.numel() * a.element_size() + b.numel() * b.element_size()
                   for a, b in zip(self._A, self._B))

    def check(self):
        """Invariants (the leak checks pivot on this, as on
        PageAllocator.check): free rows, hot rows and pinned rows partition
        1..capacity-1; refcounts never negative; every hot name maps a
        consistent row; a zero-reference hot row is LRU-evictable."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate adapter rows on the free list")
        hot = set(self._rows.values())
        if free & hot:
            raise AssertionError(f"adapter rows both free and hot: "
                                 f"{sorted(free & hot)}")
        if free | hot != set(range(1, self.capacity)):
            raise AssertionError(
                "leaked adapter rows: "
                f"{sorted(set(range(1, self.capacity)) - free - hot)}")
        if (self.refcount < 0).any():
            raise AssertionError("negative adapter refcount")
        for row in free:
            if self.refcount[row] != 0:
                raise AssertionError(f"free adapter row {row} holds "
                                     f"references")
        for name, row in self._rows.items():
            if self._row_name.get(row) != name:
                raise AssertionError(f"row map out of sync at {row}")
            if self.refcount[row] == 0 and row not in self._lru:
                raise AssertionError(f"zero-ref hot row {row} not "
                                     f"LRU-evictable")
        return True
