"""Continuous-batching generation engines over a fixed slot pool.

Iteration-level batching as in the JAX package (`serving/engine.py`):
the pool owns S cache slots; one batched decode step runs over all
slots with an active mask; a free slot is refilled by prefilling the new
prompt (bucketed to a power of two) into the slot's cache.

  * `ServingEngine(...)`: the dense pool (per-layer [S, H, pool_len, D]
    K/V rows per slot).
  * `ServingEngine(..., paged=True)` (a `PagedServingEngine`): a global
    pool of fixed-size pages mapped through a host-owned page table,
    with admission on free pages, on-demand decode pages, out-of-pages
    eviction, and the radix prefix cache (whole hits attach the cached
    pages with zero prefill; partial hits prefill only the divergent
    tail; copy-on-write keeps shared pages immutable).
  * `spec_k=k` on either: speculative decoding (an n-gram self-draft and
    one k-token verify per iteration, adaptive effective k).
  * `adapters=AdapterPool(...)` on either: multi-tenant serving. Each
    request names its tenant (`Request(..., adapter=name)`); the slot
    pins a bank row of the pool, and every join and step adds the
    per-row LoRA delta of its slots' tenants (`ops.quant.lora_scope`),
    so one batched step serves many tenants. A pool with every row
    pinned defers the queue head (`tenancy.adapter_waits`).
  * `quantize="int8"`: the stack's large dense weights become int8 with
    per-output-channel scales (`adapters.quantize_net`), in place.

Numerics contract: every slot reproduces `generate_eager` for its own
prompt token for token (under a `lora_scope` of its tenant's bank row),
speculation included (greedy acceptance). All per-slot operations are
row-wise, so co-resident requests cannot perturb each other's output.

Chunked prefill (`prefill_chunk`) is a later slice and is refused at
construction.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bucketing import bucket_size, pad_prompt_row
from ..core.device import resolve_device
from .layers import (DenseLayout, PagedLayout, PlainStepper, SinglePlacement,
                     SpecStepper)
from .metrics import ServingMetrics
from .paging import (PageAllocator, RadixPrefixCache, pages_for,
                     resolve_kv_dtype)

__all__ = ["ServingEngine", "PagedServingEngine"]

#: engine options of the JAX package that later slices of the port bring
_LATER = {"prefill_chunk": "the traffic-shaping slice"}


def _tensor_bytes(x):
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class _EngineBase:
    """Slot lifecycle and the per-iteration orchestration. One
    `run_iteration(scheduler)` is the continuous-batching unit: (1)
    cancelled / past-deadline requests leave their slots with partial
    output; (2) up to `max_joins_per_iter` queued requests prefill into
    free slots; (3) one batched decode step over the active mask. Not
    thread-safe: drive it from one thread (the `ServingServer` loop or a
    synchronous drain)."""

    def __init__(self, num_slots, *, max_joins_per_iter=2, metrics=None,
                 clock=time.monotonic):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.max_joins_per_iter = int(max_joins_per_iter)
        self.clock = clock
        self.metrics = metrics if metrics is not None else \
            ServingMetrics(clock=clock)
        self.slots = [None] * self.num_slots   # Request | None

    def admit_check(self, request):
        """Raise ValueError for requests this pool can never serve."""

    def _join(self, slot, request):
        raise NotImplementedError

    def _decode_step(self, active):
        raise NotImplementedError

    def _evict(self, slot):
        """Host bookkeeping when a slot is released (paged: its pages)."""

    def _admission_gate(self, request):
        """Resource headroom beyond a free slot. False pushes the request
        back to the queue HEAD and ends this iteration's joins (adapter
        rows, the paged pool's pages)."""
        return True

    def _tenant_of(self, request):
        """Tenant label for per-tenant accounting (None: the engine
        carries no AdapterPool)."""
        return None

    def _iteration_gauges(self):
        """Extra per-iteration gauges for `metrics.record_iteration`."""
        return None

    def _reset_pool(self):
        """Rebuild device pool state after a decode-step failure."""

    def occupancy(self):
        return sum(r is not None for r in self.slots)

    def _finish_slot(self, s, reason, now):
        r = self.slots[s]
        self.slots[s] = None
        self._evict(s)
        self.metrics.record_finish(reason)
        r.finish(reason, now)

    def _fail_active(self, exc):
        """A decode step failed: the batched step is all-or-nothing, so
        every in-flight request ends with its partial tokens and the
        cause, the pool is rebuilt, and serving continues."""
        now = self.clock()
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            self.slots[s] = None
            self._evict(s)
            self.metrics.record_finish("error")
            r.finish("error", now, error=exc)
        self._reset_pool()

    def _deliver(self, r, tok, now):
        if r.state == "DONE":
            return
        r.tokens.append(tok)
        self.metrics.record_token(self._tenant_of(r))
        if r.first_token_at is None:
            r.first_token_at = now
            if r.submitted_at is not None:
                self.metrics.record_first_token(now - r.submitted_at)
        if r.stream_cb is not None:
            try:
                r.stream_cb(r, tok)
            except Exception as e:
                # a broken streaming callback must not stall the pool;
                # the failure is recorded, never swallowed
                self.metrics.record_error("stream_cb", e)
        if r.eos_id is not None and tok == r.eos_id:
            self._finish_slot(r.slot, "eos", now)
        elif len(r.tokens) >= r.max_new_tokens:
            self._finish_slot(r.slot, "length", now)

    def run_iteration(self, scheduler):
        """One iteration: harvest, admit, decode. Returns True when any
        work was done (False = idle). A speculative step delivers up to
        k tokens per slot, stopping the moment the slot finishes."""
        now = self.clock()
        progress = False
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            if r.cancelled:
                self._finish_slot(s, "cancelled", now)
                progress = True
            elif r.expired(now):
                self._finish_slot(s, "timeout", now)
                progress = True

        def _queue_death(req):   # cancelled / expired while queued
            self.metrics.record_finish(req.finish_reason)

        joins = 0
        tok0s = []   # (request, device token 0), synced after the loop
        while joins < self.max_joins_per_iter:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            r = scheduler.pop_ready(now, on_dead=_queue_death)
            if r is None:
                break
            try:
                self.admit_check(r)
            except ValueError as e:
                self.metrics.record_error("admit", e)
                r.fail(e, now)
                self.metrics.record_finish("error")
                continue
            if not self._admission_gate(r):
                # resource backpressure: the request stays queued at the
                # head, joins stop for this iteration, decode drains
                scheduler.push_front(r)
                break
            s = free[0]
            r.state, r.slot = "RUNNING", s
            self.slots[s] = r
            try:
                tok = self._join(s, r)
            except Exception as e:
                # per-request isolation: the failed join fails THIS
                # request and frees its slot; the join's writes were
                # slot-local, so the pool keeps serving
                self.slots[s] = None
                self._evict(s)
                r.slot = None
                self.metrics.record_error("slot_join", e)
                r.fail(e, self.clock())
                self.metrics.record_finish("error")
                progress = True
                continue
            joins += 1
            progress = True
            self.metrics.record_join()
            tok0s.append((r, tok))
        if tok0s:
            # one host sync for the whole admission round's first tokens
            firsts = torch.stack([t for _, t in tok0s]).cpu().tolist()
            for (r, _), tok in zip(tok0s, firsts):
                self._deliver(r, int(tok), self.clock())
        active = np.asarray([r is not None for r in self.slots], bool)
        if active.any():
            t0 = self.clock()
            try:
                toks = self._decode_step(active)
            except Exception as e:
                self.metrics.record_error("decode_step", e)
                self._fail_active(e)
                progress = True
            else:
                now2 = self.clock()
                n = 0
                if isinstance(toks, tuple):
                    emit, n_emit = toks      # speculative: [S, k], [S]
                else:
                    emit, n_emit = toks[:, None], np.ones_like(toks)
                for s, r in enumerate(list(self.slots)):
                    if r is None or not active[s]:
                        continue
                    for j in range(int(n_emit[s])):
                        if self.slots[s] is not r or r.state == "DONE":
                            break
                        self._deliver(r, int(emit[s, j]), now2)
                        n += 1
                self.metrics.record_decode(n, now2 - t0)
                progress = True
        self.metrics.record_iteration(scheduler.depth(),
                                      self.occupancy() / self.num_slots,
                                      **(self._iteration_gauges() or {}))
        return progress

    def serve_until_idle(self, scheduler, max_iterations=None):
        """Synchronous drive: iterate until queue and pool are empty."""
        it = 0
        while scheduler.depth() > 0 or self.occupancy() > 0:
            self.run_iteration(scheduler)
            it += 1
            if max_iterations is not None and it >= max_iterations:
                raise RuntimeError(f"serve_until_idle: no convergence "
                                   f"after {it} iterations")

    def abort_active(self, reason, now=None):
        """Finalize every in-flight request (non-drain shutdown); partial
        tokens are delivered."""
        if now is None:
            now = self.clock()
        for s, r in enumerate(self.slots):
            if r is not None:
                self._finish_slot(s, "cancelled" if r.cancelled else reason,
                                  now)


class ServingEngine(_EngineBase):
    """The model-backed engine: a (decoder, embed, project) triple over a
    pooled cache of `num_slots` rows x `max_len` positions on `device`
    (None means the CUDA card; the model must already live there). On
    CUDA every attention runs through the port's kernels, and float32
    matmuls are kept at full precision
    (`torch.backends.cuda.matmul.allow_tf32 = False`). `paged=True`
    builds a `PagedServingEngine`.

    Speculative decoding: `spec_k >= 2` turns the batched decode step
    into an n-gram draft (`spec_ngram`) plus one spec_k-token verify,
    delivering up to spec_k tokens per slot per iteration with the same
    tokens; the pool carries spec_k extra positions so a round's
    fixed-k write never clips. The effective k adapts batch-wide on the
    acceptance-rate EMA (`spec_adapt*`, see `layers.SpecStepper`).

    Admission contract: a request needs `bucket(prompt_len) +
    max_new_tokens <= max_len` cache positions and a cross-attention
    memory of the pool's [M, D] shape (fixed by the first join). Prompt
    at positions [0, Pb), its pad hole key-masked forever, generated
    tokens at Pb, Pb + 1, ..."""

    def __new__(cls, *args, **kw):
        # `paged=True` routes construction to the paged-pool engine, so
        # callers opt into paging without a second entry point
        if cls is ServingEngine and kw.get("paged"):
            return object.__new__(PagedServingEngine)
        return object.__new__(cls)

    def __init__(self, decoder, embed, project, *, num_slots=8,
                 max_len=128, max_joins_per_iter=2, metrics=None,
                 clock=time.monotonic, device=None, paged=False,
                 spec_k=None, spec_ngram=2, spec_adapt=True,
                 spec_adapt_low=0.15, spec_adapt_high=0.6,
                 spec_adapt_patience=4, spec_adapt_alpha=0.3, adapters=None,
                 quantize=None, prefill_chunk=None):
        if prefill_chunk:
            raise NotImplementedError(
                f"ServingEngine(prefill_chunk=...) is not ported yet: it "
                f"comes with {_LATER['prefill_chunk']}")
        super().__init__(num_slots, max_joins_per_iter=max_joins_per_iter,
                         metrics=metrics, clock=clock)
        from ..text.generation import _StepNet

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        # int8 base weights: every large dense weight of the stack becomes
        # int8 + per-output-channel scales, in place and one-way (the
        # engine owns the model it serves); quantize=None touches nothing
        if quantize is not None:
            if str(quantize) != "int8":
                raise ValueError(f"quantize={quantize!r}: only 'int8' is "
                                 f"supported")
            from .adapters import quantize_net

            quantize_net(decoder, embed, project)
        # batched LoRA adapters: the slots' bank rows ride into every join
        # and step through ops.quant.lora_scope
        if adapters is not None and adapters.decoder is not decoder:
            raise ValueError("the AdapterPool was built for a different "
                             "decoder than this engine serves")
        self._apool = adapters
        self._adapter_rows = np.zeros(self.num_slots, np.int64)
        if adapters is not None:
            adapters.bind_metrics(self.metrics)
        self._net = _StepNet(decoder, embed, project).eval()
        for name, p in [*self._net.named_parameters(),
                        *self._net.named_buffers()]:
            if p.device != self.device:
                raise ValueError(f"parameter {name} lives on {p.device}, "
                                 f"the engine serves on {self.device}")
        self.max_len = int(max_len)
        if spec_k is not None:
            spec_k = int(spec_k)
            if spec_k < 2:
                raise ValueError("spec_k must be >= 2 (the pending token "
                                 "plus at least one draft)")
        self.spec_k = spec_k
        self.spec_ngram = int(spec_ngram)
        self.spec_adapt = bool(spec_adapt)
        self.spec_adapt_low = float(spec_adapt_low)
        self.spec_adapt_high = float(spec_adapt_high)
        self.spec_adapt_patience = int(spec_adapt_patience)
        self.spec_adapt_alpha = float(spec_adapt_alpha)
        self._pool_len = self.max_len + (spec_k or 0)
        self.layout = (PagedLayout(self) if isinstance(self, PagedServingEngine)
                       else DenseLayout(self))
        self.placement = SinglePlacement(self)
        self.stepper = SpecStepper(self) if spec_k else PlainStepper(self)
        self._state = None          # built on the first join
        self._mem_shape = None
        self._dtype = None
        self._weights_bytes = None
        self.metrics.set_memory_provider(self.memory_ledger)

    def _pool_variant(self):
        """Label of the pool for per-variant metric splits."""
        return "paged" if isinstance(self, PagedServingEngine) else "dense"

    def _max_len_detail(self):
        return ""

    # ---- multi-tenant adapter plumbing (serving/adapters.py) ----
    def _tenant_of(self, r):
        if self._apool is None:
            return None
        return getattr(r, "adapter", None) or "base"

    def _lora_ctx(self, rows):
        """The adapter scope a body opens around the net: `rows` holds one
        bank row per batch row (a join's one row, a step's [S] slot rows).
        A no-op scope when the engine carries no pool."""
        import contextlib

        if self._apool is None:
            return contextlib.nullcontext()
        from ..ops.quant import lora_scope

        return lora_scope(np.asarray(rows, np.int32).reshape(-1),
                          self._apool.banks())

    def _release_slot_adapter(self, s):
        row = int(self._adapter_rows[s])
        if row:
            self._adapter_rows[s] = 0
            self._apool.release(row)

    def _pinned_join(self, s, r, join):
        """Run `join(row)` with the request's bank row (0 = base) pinned
        for slot `s`: an earlier attempt's row is released first, and the
        row is released again if the join fails."""
        self._release_slot_adapter(s)
        if self._apool is None:
            return join(0)
        row = self._apool.acquire(getattr(r, "adapter", None))
        try:
            tok0 = join(row)
        except Exception:
            self._apool.release(row)
            raise
        self._adapter_rows[s] = row
        return tok0

    def _adapter_gate(self, r):
        """Admission headroom for the request's adapter: False defers the
        queue head until a bank row frees (the OutOfAdapters
        backpressure)."""
        if self._apool is None:
            return True
        name = getattr(r, "adapter", None)
        if name is None or self._apool.can_acquire(name):
            return True
        self.metrics.record_adapter_wait()
        return False

    def _admission_gate(self, r):
        return self._adapter_gate(r)

    def _tenant_slot_counts(self):
        out = {}
        for req in self.slots:
            if req is not None:
                t = self._tenant_of(req)
                out[t] = out.get(t, 0) + 1
        return out

    def _iteration_gauges(self):
        if self._apool is None:
            return None
        return {"tenant_slots": self._tenant_slot_counts()}

    def _evict(self, s):
        self._release_slot_adapter(s)

    # ---- the memory ledger ----
    def weights_bytes(self):
        """Bytes of the parameters and buffers the engine serves with."""
        if self._weights_bytes is None:
            self._weights_bytes = sum(
                _tensor_bytes(t) for t in [*self._net.parameters(),
                                           *self._net.buffers()])
        return self._weights_bytes

    def pool_bytes(self):
        """Bytes of the slot pool's device state (0 before the first
        join builds it)."""
        return _tensor_bytes(self._state)

    def pool_in_use_bytes(self):
        """The live part of the pool: the dense pool commits every row."""
        return self.pool_bytes()

    def adapter_bytes(self):
        """Bytes of the stacked LoRA banks (0 without an AdapterPool)."""
        return 0 if self._apool is None else self._apool.bytes()

    def memory_ledger(self):
        """The `memory` section's components: weights, pool, adapter banks
        and the bytes in use."""
        w, a = self.weights_bytes(), self.adapter_bytes()
        return {"weights_bytes": w, "pool_bytes": self.pool_bytes(),
                "adapter_bytes": a,
                "in_use_bytes": w + a + self.pool_in_use_bytes()}

    def admit_check(self, r):
        name = getattr(r, "adapter", None)
        if name is not None:
            if self._apool is None:
                raise ValueError(f"request names adapter {name!r} but this "
                                 f"engine carries no AdapterPool "
                                 f"(adapters=)")
            if not self._apool.registered(name):
                raise ValueError(f"adapter {name!r} is not registered with "
                                 f"the pool (tenants: "
                                 f"{self._apool.tenants()})")
        P = max(1, int(r.prompt.shape[0]))
        Pb = bucket_size(P)
        if Pb + r.max_new_tokens > self.max_len:
            raise ValueError(f"request needs bucket({P})={Pb} prompt slots "
                             f"+ {r.max_new_tokens} decode slots > pool "
                             f"max_len {self.max_len}"
                             f"{self._max_len_detail()}")
        if r.memory is None or r.memory.dim() != 2:
            raise ValueError("ServingEngine requests need a 2-D "
                             "cross-attention memory [M, D]")
        if self._mem_shape is not None and \
                tuple(r.memory.shape) != self._mem_shape:
            raise ValueError(f"memory shape {tuple(r.memory.shape)} != "
                             f"pool's {self._mem_shape} (fixed by the first "
                             f"join)")

    def _ensure_state(self, memory):
        if self._state is None:
            self._state = self.placement.run(self.layout.build_state,
                                             memory)
            self._mem_shape = tuple(memory.shape)
            self._dtype = memory.dtype
            self._post_state_build()

    def _post_state_build(self):
        """Hook once the pool state exists (paged: the page byte size)."""

    def _join(self, s, r):
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, _ = pad_prompt_row(r.prompt, pad_id)
        memory = r.memory.to(self.device)
        self._ensure_state(memory)
        prompt = torch.as_tensor(prompt_b, device=self.device)
        return self._pinned_join(s, r, lambda row: self.placement.run(
            self.layout.join, s, prompt, P0, memory[None], row))

    def _decode_step(self, active):
        # plain vs speculative is the stepper axis (layers.py)
        return self.stepper.decode(active)

    def _reset_pool(self):
        # every slot is empty by now: the next join rebuilds a zeroed pool
        self._state = None


class PagedServingEngine(ServingEngine):
    """The serving pool over PAGED KV storage: `ServingEngine(...,
    paged=True)`. Per layer, K/V live in a global pool of fixed-size pages
    ([num_pages + 1, H, page_size, D]; the last row is the trash page);
    each slot maps its logical positions through a host-owned int32 page
    table shipped to the device every step:

      * a join allocates only the pages its PROMPT bucket needs; decode
        pages are mapped on demand as the write position crosses page
        boundaries, so occupancy follows actual tokens, and `num_pages`
        may be far below `num_slots * max_pages` (oversubscription);
      * the radix prefix cache (`prefix_cache=True`): a prompt already in
        it joins with zero prefill (the shared pages mapped read-only,
        refcounted); a prompt sharing a cached prefix prefills only its
        divergent tail (`pattach`, one verify block through the pages);
        a shared page the joiner would decode-write into is copied first
        (copy-on-write), so co-resident requests stay isolated;
        `radix_mid_page` chooses how a match ending inside a page is
        served ("round_down": re-prefill from the page boundary; "cow":
        copy the partly matching page);
      * admission runs on free-page headroom (prompt pages + a decode
        reservation of `reserve_decode_frac`): too few pages DEFER the
        queue head (`paging.page_waits`) instead of failing it; a pool
        that still runs dry mid-decode evicts the starved slot with its
        partial tokens and an `OutOfPages` cause (`paging.oom_evictions`);
      * pages store the compute dtype (default), bf16 or int8 with
        per-(page, head) scales behind `kv_dtype=`, dequantized at read
        time (in the kernels on the card).

    Numerics contract: with `kv_dtype=None` every request's tokens equal
    the dense `ServingEngine`'s (bit for bit on the CPU, where the paged
    reads gather the dense view), provided `max_len` is a page multiple
    (it is rounded up to one)."""

    def __init__(self, decoder, embed, project, *, num_slots=8,
                 max_len=128, page_size=16, num_pages=None,
                 kv_dtype=None, prefix_cache=True, prefix_capacity=64,
                 radix_mid_page="round_down", reserve_decode_frac=1.0,
                 paged=True, **kw):
        page_size = int(page_size)
        max_len = pages_for(max_len, page_size) * page_size
        super().__init__(decoder, embed, project, num_slots=num_slots,
                         max_len=max_len, **kw)
        self.page_size = page_size
        # a speculative pool writes up to spec_k tokens past a row's
        # admitted budget before rolling back: page-cover that overhang
        self._pool_len = pages_for(self.max_len + (self.spec_k or 0),
                                   page_size) * page_size
        self.max_pages = self._pool_len // page_size
        self.num_pages = (int(num_pages) if num_pages is not None
                          else self.num_slots * self.max_pages)
        self.kv_dtype = kv_dtype
        self.reserve_decode_frac = float(reserve_decode_frac)
        self._alloc = PageAllocator(self.num_pages, page_size)
        self._prefix = (RadixPrefixCache(self._alloc, prefix_capacity,
                                         page_size=page_size,
                                         mid_page=radix_mid_page)
                        if prefix_cache else None)
        if self._prefix is not None and self._apool is not None:
            # eager tenant invalidation: re-registering an adapter drops
            # its cached prefixes now (the generation in the tenant key
            # would also miss them on the next touch)
            import weakref

            wr = weakref.ref(self)

            def _drop(name, gen):
                e = wr()
                if e is not None and e._prefix is not None:
                    e._prefix.drop_tenant(name)

            self._apool.on_invalidate(_drop)
        self._table = np.full((self.num_slots, self.max_pages), -1, np.int32)
        self._index = np.zeros(self.num_slots, np.int32)
        # total pages each occupied slot will have mapped by the time its
        # request hits max_new_tokens: admission subtracts the unmapped
        # remainder from the free headroom (reserve_decode_frac=1.0 is a
        # no-OOM guarantee)
        self._slot_pages_total = np.zeros(self.num_slots, np.int64)
        self._page_bytes = None
        self._prefix_params = None   # parameter state the cache holds for
        self.prefill_count = 0       # real prefills run (prefix hits skip)

    def _max_len_detail(self):
        return f" (= {self.max_pages} pages x {self.page_size} tokens, paged)"

    def _spec_overhang(self):
        """Positions a speculative verify may write past a row's accepted
        budget before the rollback: admission and the per-slot page
        reservations cover them."""
        return (self.spec_k - 1) if self.spec_k else 0

    def admit_check(self, r):
        super().admit_check(r)
        # liveness: a request the whole (empty) pool could never hold
        # must fail fast, not defer at the backpressure gate forever
        P = max(1, int(r.prompt.shape[0]))
        need = pages_for(bucket_size(P) + r.max_new_tokens +
                         self._spec_overhang(), self.page_size)
        if need > self.num_pages:
            raise ValueError(f"request needs {need} pages > pool num_pages "
                             f"{self.num_pages} ({self.page_size}-token "
                             f"pages)")

    def _post_state_build(self):
        storage, quantized = resolve_kv_dtype(self.kv_dtype, self._dtype)
        h0 = self._net.decoder.layers[0].self_attn
        per_buf = h0.num_heads * self.page_size * h0.head_dim * \
            torch.empty((), dtype=storage).element_size()
        scale_b = h0.num_heads * 4 if quantized else 0
        self._page_bytes = 2 * len(self._net.decoder.layers) * \
            (per_buf + scale_b)

    # ---- host page bookkeeping ----
    def _alloc_pages(self, n):
        """Allocate n pages, reclaiming LRU prefix-cache entries under
        pressure first."""
        if self._alloc.pages_free < n and self._prefix is not None:
            self._prefix.reclaim(n)
        return self._alloc.alloc(n)

    def _release_slot(self, s):
        mapped = [int(p) for p in self._table[s] if p >= 0]
        if mapped:
            self._alloc.decref(mapped)
        self._table[s] = -1
        self._index[s] = 0
        self._slot_pages_total[s] = 0

    def _evict(self, s):
        super()._evict(s)          # the adapter row
        self._release_slot(s)

    def pool_in_use_bytes(self):
        """The pool less its free pages."""
        return self.pool_bytes() - \
            self._alloc.pages_free * (self._page_bytes or 0)

    def _device_table(self):
        # unmapped entries point at the trash row (num_pages): inactive
        # slots' masked writes can never land on live pages
        return torch.as_tensor(
            np.where(self._table < 0, self.num_pages, self._table)
            .astype(np.int32), device=self.device)

    def flush_prefix_cache(self):
        """Drop every prefix-cache entry (releases the cache's page
        references; pages still mapped by live slots survive via their
        own). After a full drain the allocator is all free again."""
        if self._prefix is not None:
            self._prefix.flush()

    def _reset_pool(self):
        # a decode-step failure evicted every slot (pages returned); the
        # device pages are rebuilt zeroed on the next join, so the prefix
        # cache's pages would hold garbage: flush it
        self.flush_prefix_cache()
        self._table[:] = -1
        self._index[:] = 0
        self._state = None

    # ---- admission: free-page headroom ----
    def _pages_needed(self, r):
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        row, P0, Pb = pad_prompt_row(r.prompt, pad_id)
        n_pp = pages_for(Pb, self.page_size)
        need_prompt = n_pp
        if self._prefix is not None:
            res = self._prefix.peek(row[0, :P0], P0, Pb, self._mem_key(r),
                                    self._tenant_key(r),
                                    allow_partial=self._radix_partial_ok())
            if res is not None and res[0] == "whole":
                # shared pages are free; only a COW of the partial tail
                # page (when the bucket ends mid-page) is new
                need_prompt = 1 if Pb % self.page_size else 0
            elif res is not None:
                # matched prefix pages are free; the joiner allocates the
                # rest (COW page included) + a possible tail COW
                m = len(res[1]["pages"])
                need_prompt = (n_pp - m) + (1 if Pb % self.page_size else 0)
        total = pages_for(Pb + r.max_new_tokens + self._spec_overhang(),
                          self.page_size)
        reserve = int(np.ceil(self.reserve_decode_frac * (total - n_pp)))
        return need_prompt + reserve

    def _outstanding_reservations(self):
        """Pages already-admitted slots will still map before they finish
        (scaled by the reservation fraction): subtracted from the free
        headroom so admission never promises the same page twice."""
        out = 0
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            mapped = int((self._table[s] >= 0).sum())
            remain = max(0, int(self._slot_pages_total[s]) - mapped)
            out += int(np.ceil(self.reserve_decode_frac * remain))
        return out

    def _admission_gate(self, r):
        if not self._adapter_gate(r):
            return False
        need = self._pages_needed(r) + self._outstanding_reservations()
        if self._alloc.pages_free < need and self._prefix is not None:
            self._prefix.reclaim(need)
        if self._alloc.pages_free >= need:
            return True
        self.metrics.record_page_wait()
        return False

    def _iteration_gauges(self):
        gauges = {"pages_in_use": self._alloc.pages_in_use,
                  "pages_free": self._alloc.pages_free}
        if self._apool is not None:
            gauges["tenant_slots"] = self._tenant_slot_counts()
        if self._prefix is not None:
            st = self._prefix.stats()
            gauges.update({"trie_nodes": st["nodes"],
                           "trie_pages": st["pages"]})
        active_toks = sum(int(self._index[s])
                          for s, r in enumerate(self.slots) if r is not None)
        if active_toks and self._page_bytes:
            gauges["bytes_per_active_token"] = \
                self._alloc.pages_in_use * self._page_bytes / active_toks
        return gauges

    # ---- join: prefill into pages, or attach shared prefix pages ----
    def _tenant_key(self, r):
        """The radix trie's tenant scope. Prompt K/V depend on the adapter
        that prefilled them (LoRA on the K/V projections), so adapter
        traffic gets its own subtree keyed by (adapter name, registration
        generation; never the recyclable bank row), while requests without
        an adapter share one base subtree."""
        name = getattr(r, "adapter", None)
        if name is None or self._apool is None:
            return None
        return (name, self._apool.generation(name))

    @staticmethod
    def _mem_key(r):
        """The request's memory on the host, for the prefix cache's
        digests (copied off the card once per request)."""
        host = getattr(r, "_mem_host", None)
        if host is None:
            host = r._mem_host = r.memory.detach().cpu().numpy()
        return host

    def _radix_partial_ok(self):
        """Partial (tail-prefill) reuse needs pages in the COMPUTE dtype:
        the pattach tail attends to the seed K/V as STORED, a cold
        prefill to full-precision K/V, so quantized pools keep whole-
        prompt reuse only."""
        if self._dtype is None:
            return False         # no pool yet: nothing cached to match
        storage, quantized = resolve_kv_dtype(self.kv_dtype, self._dtype)
        return not quantized and storage == self._dtype

    def _check_params(self):
        """Prefix-cache entries hold MODEL-DERIVED state (prompt K/V
        pages and the first greedy token): any in-place change of a
        parameter (its version counter moves) or a rebound parameter
        makes them stale, so the cache is flushed."""
        cur = tuple((p.data_ptr(), p._version)
                    for p in self._net.parameters())
        if self._prefix_params is not None and cur != self._prefix_params:
            self.flush_prefix_cache()
        self._prefix_params = cur

    def _join(self, s, r):
        memory = r.memory.to(self.device)
        self._ensure_state(memory)
        if self._prefix is not None:
            self._check_params()
        # idempotent: a half-joined earlier attempt's pages are released
        # before this one allocates
        self._release_slot(s)
        return self._pinned_join(
            s, r, lambda row: self._join_inner(s, r, memory, row))

    def _join_inner(self, s, r, memory, row):
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, Pb = pad_prompt_row(r.prompt, pad_id)
        self._slot_pages_total[s] = pages_for(
            Pb + r.max_new_tokens + self._spec_overhang(), self.page_size)
        res = None
        if self._prefix is not None:
            res = self._prefix.lookup(prompt_b[0, :P0], P0, Pb,
                                      self._mem_key(r), self._tenant_key(r),
                                      allow_partial=self._radix_partial_ok())
            kind = res[0] if res is not None else "miss"
            matched = (P0 if kind == "whole" else
                       res[1]["seed_len"] if kind == "partial" else 0)
            self.metrics.record_prefix(kind, matched_tokens=matched,
                                       prompt_tokens=P0)
        args = (s, r, prompt_b, P0, Pb, memory[None])
        if res is not None and res[0] == "whole":
            return self._attach_shared(res[1], *args)
        if res is not None:
            return self._pattach_join(res[1], *args, row)
        return self._prefill_join(*args, row)

    def _prefill_join(self, s, r, prompt_b, P0, Pb, memory, row):
        n_pp = pages_for(Pb, self.page_size)
        pages = self._alloc_pages(n_pp)
        try:
            tok0 = self.placement.run(
                self.layout.join, s, torch.as_tensor(prompt_b,
                                                     device=self.device),
                P0, memory, pages, row)
        except Exception:
            self._alloc.decref(pages)
            raise
        self._table[s, :n_pp] = pages
        self._index[s] = Pb
        self.prefill_count += 1
        # tok0 stays the device scalar: the trie stores it raw and
        # resolves it at the first whole hit
        if self._prefix is not None:
            self._prefix.insert(prompt_b[0, :P0], P0, Pb, self._mem_key(r),
                                self._tenant_key(r), pages, tok0)
        self._cow_tail(s, Pb)
        return tok0

    def _pattach_join(self, match, s, r, prompt_b, P0, Pb, memory, row):
        """Radix PARTIAL hit: map the matched prefix pages read-only, COW
        the mid-page divergence point (when the match ends inside a
        page), and prefill ONLY the divergent tail through
        `PagedLayout.pattach`: prefill work scales with the missed
        tokens, not the prompt. The extended prompt is inserted back into
        the trie."""
        psz = self.page_size
        matched = [int(p) for p in match["pages"]]
        m = len(matched)
        j = int(match["j"])
        seed_len = m * psz + j
        n_pp = pages_for(Pb, psz)
        self._alloc.incref(matched)
        owned = []       # pages THIS join allocated (released on failure)
        try:
            if j:
                dst = self._alloc_pages(1)[0]
                owned.append(dst)
                self.placement.run(self.layout.cow, int(match["cow_src"]),
                                   dst)
                self.metrics.record_cow_copy()
                head = matched + [dst]
            else:
                head = list(matched)
            fresh = self._alloc_pages(n_pp - len(head)) \
                if n_pp > len(head) else []
            owned.extend(fresh)
            full_pages = head + fresh
            n_tail = P0 - seed_len
            # >= 2: the tail block takes the verify path, never the
            # single-token decode path
            Tb = max(2, bucket_size(n_tail))
            Mb = bucket_size(m + (1 if j else 0), minimum=1)
            W = min(self.max_pages, Mb + pages_for(Tb, psz))
            trow = np.full((1, W), self.num_pages, np.int32)
            k = min(W, n_pp)
            trow[0, :k] = full_pages[:k]
            tail = np.full((1, Tb), int(r.eos_id) if r.eos_id is not None
                           else 0, np.int64)
            tail[0, :n_tail] = prompt_b[0, seed_len:P0]
            dev = self.device
            tok0 = self.placement.run(
                self.layout.pattach, s, torch.as_tensor(trow, device=dev),
                torch.as_tensor(tail, device=dev), seed_len, P0, Pb, memory,
                torch.as_tensor(prompt_b, device=dev), row)
        except Exception:
            if owned:
                self._alloc.decref(owned)
            self._alloc.decref(matched)
            raise
        self._table[s, :n_pp] = full_pages
        self._index[s] = Pb
        # insert BEFORE the tail COW, so the trie adopts the slot's pages
        # while they are still the canonical prompt pages
        self._prefix.insert(prompt_b[0, :P0], P0, Pb, self._mem_key(r),
                            self._tenant_key(r), full_pages, tok0)
        self._cow_tail(s, Pb)
        return tok0

    def _attach_shared(self, hit, s, r, prompt_b, P0, Pb, memory):
        """Whole prefix hit: map the shared prompt pages read-only and
        splice only the per-request rows; zero self-attention prefill."""
        pages = hit["pages"]
        self._alloc.incref(pages)
        try:
            tok0 = self.placement.run(
                self.layout.attach, s, int(hit["tok0"]), P0, Pb, memory,
                torch.as_tensor(prompt_b, device=self.device))
        except Exception:
            self._alloc.decref(pages)
            raise
        self._table[s, :len(pages)] = pages
        self._index[s] = Pb
        self._cow_tail(s, Pb)
        return tok0

    def _cow_tail(self, s, Pb):
        """Copy-on-write: when the bucket boundary falls mid-page, the
        first decode write lands inside the last prompt page; if that
        page is shared (prefix cache or a co-resident holder), give this
        slot a private copy first so the shared original stays
        immutable."""
        if Pb % self.page_size == 0:
            return
        pi = Pb // self.page_size
        src = int(self._table[s, pi])
        if src < 0 or self._alloc.refcount[src] <= 1:
            return
        dst = self._alloc_pages(1)[0]
        try:
            self.placement.run(self.layout.cow, src, dst)
        except Exception:
            self._alloc.decref([dst])
            raise
        self._alloc.decref([src])
        self._table[s, pi] = dst
        self.metrics.record_cow_copy()

    def _evict_oom(self, s, exc, now):
        """The pool ran dry mid-decode: the starved slot ends with its
        partial tokens and the `OutOfPages` cause; the pool keeps
        serving."""
        r = self.slots[s]
        self.slots[s] = None
        self._evict(s)
        self.metrics.record_oom_eviction()
        self.metrics.record_error("out_of_pages", exc)
        self.metrics.record_finish("error")
        r.finish("error", now, error=exc)

