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
  * `prefill_chunk=C` on either: chunked prefill. A prompt longer than C
    joins as a pending slot. One C-token chunk runs an iteration, between
    decode steps, the pending slots taking turns, so co-resident decodes
    wait for one chunk at most, whatever the number of long prompts in
    flight.
  * `precompile(memory, prompt_buckets=, cache=)`: every serving program
    of the pool config readied before the first request (one run each on
    a scratch pool); with an AOT cache directory, a restart copies the
    kernel libraries out of it and runs no program until it serves
    (`tuning/aot_cache.py`, the `cold_start` metrics).
  * Preemption (paged pools with the prefix cache): under a
    `ShapingScheduler` a full pool parks a lower-class running request's
    prompt pages in the radix trie, frees its slot and requeues it; the
    resume attaches the parked prefix with no prefill and re-decodes the
    tokens already delivered, which the engine absorbs after checking
    each against the token it replaces (`ReplayDiverged` otherwise).

Numerics contract: every slot reproduces `generate_eager` for its own
prompt token for token (under a `lora_scope` of its tenant's bank row),
speculation, chunking and preemption included (greedy acceptance). All
per-slot operations are row-wise, so co-resident requests cannot perturb
each other's output.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bucketing import bucket_size, pad_prompt_row
from ..core.device import resolve_device
from ..profiler import costs as _costs
from ..profiler import trace as _trace
from ..testing import faults
from . import tracing as _rt
from .layers import (DenseLayout, PagedLayout, PlainStepper, SinglePlacement,
                     SpecStepper)
from .metrics import CallbackList, ServingMetrics
from .paging import (PageAllocator, RadixPrefixCache, pages_for,
                     resolve_kv_dtype)

__all__ = ["ServingEngine", "PagedServingEngine", "WatchdogTimeout",
           "ReplayDiverged"]

#: fault points of the slot lifecycle (armed only by tests and chaos
#: runs; a disarmed hit reads one boolean)
_PT_SLOT_JOIN = faults.point("serving.slot_join")
_PT_PREFILL = faults.point("serving.prefill")
_PT_PATTACH = faults.point("serving.pattach")
_PT_DECODE = faults.point("serving.decode_step")
_PT_CHUNK = faults.point("serving.prefill_chunk")
_PT_PREEMPT = faults.point("serving.preempt")


def _tensor_bytes(x):
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _reject_sharded_params(net, engine):
    """A one-card engine refuses layers whose parameters are mesh blocks
    (cut by `parallel.shard_layer` or a sharded serving engine): it would
    serve a slice of the model silently. `ShardedServingEngine` takes
    them."""
    from ..parallel.layers import (ColumnParallelLinear, RowParallelLinear,
                                   VocabParallelEmbedding)

    cut = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    for name, mod in net.named_modules():
        if isinstance(mod, cut) or getattr(mod, "_serving_block", False):
            raise ValueError(
                f"{engine}: {name or 'the model'} holds mesh-sharded "
                f"weights ({type(mod).__name__}); a one-card engine would "
                f"serve a slice of it. Serve sharded layers with "
                f"ShardedServingEngine(mesh=...)")


class WatchdogTimeout(TimeoutError):
    """An engine op returned but overran its `watchdog_s` wall budget: it
    counts as a failed attempt (retried with backoff, then failed
    cleanly), so one slow or hung dispatch cannot wedge the pool
    silently."""


class ReplayDiverged(RuntimeError):
    """A resumed request re-decoded a token other than the one its caller
    already holds (a near-tie resolved the other way beside different
    slots). The request fails with the tokens it delivered, rather than
    joining them to a different continuation."""


class _EngineBase:
    """Slot lifecycle and the per-iteration orchestration. One
    `run_iteration(scheduler)` is the continuous-batching unit: (1)
    cancelled / past-deadline requests leave their slots with partial
    output; (2) up to `max_joins_per_iter` queued requests prefill into
    free slots (a full pool may first preempt a lower-class slot when the
    scheduler names one); (3) one prefill chunk, the slots in the middle
    of a chunked prefill taking turns; (4) one batched decode step over the
    active mask. Not thread-safe: drive it from one thread (the
    `ServingServer` loop or a synchronous drain).

    Fault isolation: every join, chunk and decode step runs under
    `_guarded`, up to `max_attempts` tries with capped exponential
    backoff (`backoff_base_s`, `backoff_cap_s`, `sleep`) and an optional
    wall-clock watchdog (`watchdog_s`, `WatchdogTimeout`). A join or
    chunk that fails every try fails its own request; a decode step that
    does ends every in-flight request with its partial tokens and
    rebuilds the pool. The engine's fault points (`testing.faults`) fire
    on the host before any mutation, so an injected failure leaves the
    pool as it was. The JAX engine's `PoolCarryLost` has no counterpart:
    the port writes its pool in place and donates no carry."""

    def __init__(self, num_slots, *, max_joins_per_iter=2, metrics=None,
                 callbacks=(), clock=time.monotonic, max_attempts=3,
                 backoff_base_s=0.01, backoff_cap_s=0.5, watchdog_s=None,
                 sleep=time.sleep, hbm_budget_bytes=None,
                 hbm_watermark=0.9):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.max_joins_per_iter = int(max_joins_per_iter)
        self.clock = clock
        self.metrics = metrics if metrics is not None else \
            ServingMetrics(clock=clock)
        # the ServingCallback hooks; a raising hook is recorded as the
        # error "callback.<hook>" and serving goes on
        self._cbs = CallbackList(
            callbacks, on_error=lambda hook, e: self.metrics.record_error(
                f"callback.{hook}", e))
        # token-0 delivery: the joins of an admission round return device
        # scalars that one host sync resolves after the last join;
        # sync_tok0 = True syncs each join's token 0 as it returns (the
        # JAX engine's before-and-after switch)
        self.sync_tok0 = False
        self.slots = [None] * self.num_slots   # Request | None
        # slots holding a request whose prompt is still being prefilled
        # chunk by chunk: occupied for admission, out of the decode step
        self._pending = set()
        self._last_step_done = None
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.watchdog_s = watchdog_s
        self._sleep = sleep
        # observable: the retrace sentinel / tracer see every increment
        # (one per program shape, on its first run) as it happens
        self.trace_counts = _trace.ObservedCounter(
            owner=type(self).__name__)
        self._step_cost_cache = None  # (book, key, ProgramCost)
        if hbm_budget_bytes is not None:
            self.metrics.budget_bytes = int(hbm_budget_bytes)
            self.metrics.watermark_frac = float(hbm_watermark)

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

    # ---- cost accounting (profiler.costs) ----
    def _step_cost_key(self):
        """The program-cache key of this engine's batched decode step
        (the identity the MFU gauges, the compile observer and the
        retrace sentinel share). None: no step program yet."""
        return None

    def cost_hint(self, key):
        """Analytic {flops, bytes_accessed, ...} for `key`; None: no
        estimate for this key."""
        return None

    def _record_step_cost(self, dt_s):
        """Armed only (the caller guards on the costs session): one
        decode step's roofline position into the MFU / bandwidth gauges.
        The ProgramCost lookup is cached per (book, key)."""
        key = self._step_cost_key()
        if key is None:
            return
        bk = _costs._BOOK
        if bk is None:
            return
        cached = self._step_cost_cache
        if cached is not None and cached[0] is bk and cached[1] == key:
            c = cached[2]
        else:
            c = _costs.cost_for(self, key)
            if c is None:
                return
            self._step_cost_cache = (bk, key, c)
        self.metrics.record_step_utilization(
            c.flops, c.bytes_accessed, dt_s, bk.spec, c.source)

    def _advance_chunks(self, now):
        """Run one prefill chunk, the slots in the middle of a chunked
        prefill taking turns; True when one ran. Default: no chunking."""
        return False

    def _poll_pending(self, now):
        """Advance asynchronous joins (the sharded engine's disaggregated
        prefill): land every prefill that is ready and activate its slot.
        True when any slot was activated. Default: joins are synchronous,
        nothing to poll."""
        return False

    def _choose_slot(self, free):
        """The slot a new request joins into (the sharded engine balances
        the dp shards of the slot axis)."""
        return free[0]

    def can_preempt(self, s):
        """True when slot `s` holds a request this engine could park
        (the mechanics only; class policy lives in the scheduler)."""
        return False

    def preempt_slot(self, s, now):
        """Park the running request of slot `s` so that its resume needs
        no prefill, free the slot, and return the request for requeueing;
        None when the engine has nowhere to park (dense pools)."""
        return None

    def _unpark(self, request):
        """Drop what a preemption holds for `request` (its parked prefix)
        when the request leaves without resuming."""

    def _preempt_for(self, scheduler, now):
        """Admission found no free slot: ask the scheduler (only a
        `ShapingScheduler` has the hook) for a victim, park it and
        requeue it. Returns the freed slot or None."""
        pick = getattr(scheduler, "pick_preempt_victim", None)
        if pick is None:
            return None
        s = pick(self, now)
        if s is None:
            return None
        try:
            r = self.preempt_slot(s, now)
        except Exception as e:
            # the preempt fault point fires before any mutation: slot,
            # pages and queue stay as they were; admission stops here
            self.metrics.record_error("preempt", e)
            return None
        if r is None:
            return None
        getattr(scheduler, "requeue_preempted", scheduler.push_front)(r)
        return s

    def _guarded(self, opname, fn, point, retry_tokens=0):
        """Run one engine op with up to `max_attempts` tries, capped
        exponential backoff between them and the wall-clock watchdog: an
        op that returns after more than `watchdog_s` counts as failed.
        Each try first fires the op's fault point, before the op mutates
        anything. The last failure propagates to the caller, which
        isolates it."""
        last = None
        for attempt in range(self.max_attempts):
            if attempt:
                self.metrics.record_retry(opname, retry_tokens)
                self._sleep(min(self.backoff_cap_s,
                                self.backoff_base_s * (2 ** (attempt - 1))))
            t0 = time.monotonic()
            try:
                point()
                out = fn()
            except Exception as e:
                last = e
                continue
            if self.watchdog_s is not None:
                dt = time.monotonic() - t0
                if dt > self.watchdog_s:
                    last = WatchdogTimeout(
                        f"{opname} took {dt:.3f}s > watchdog budget "
                        f"{self.watchdog_s}s")
                    continue
            return out
        raise last

    def occupancy(self):
        return sum(r is not None for r in self.slots)

    def _finish_slot(self, s, reason, now):
        r = self.slots[s]
        self.slots[s] = None
        self._evict(s)
        self.metrics.record_finish(reason, len(r.tokens))
        slo = getattr(r, "slo", None)
        if reason in ("eos", "length") and hasattr(slo, "ttft_target_s") \
                and r.first_token_at is not None \
                and r.submitted_at is not None:
            # a class the ShapingScheduler resolved: attainment against
            # its targets (a bare class name under the FIFO records none)
            n = len(r.tokens)
            tpot = (now - r.first_token_at) / (n - 1) if n > 1 else 0.0
            self.metrics.record_slo_finish(
                slo.name, r.first_token_at - r.submitted_at, tpot,
                slo.ttft_target_s, slo.tpot_target_s)
        r.finish(reason, now)
        self._cbs.emit("on_finish", r)

    def _release_failed(self, s, r, where, exc):
        """A join or chunk failed every attempt: THIS request frees its
        slot (its writes were slot-local, the pool keeps serving) and
        fails, unless a failed join degrades to the eager path
        (`_join_fallback`)."""
        self.slots[s] = None
        self._evict(s)
        self._unpark(r)
        r.slot = None
        self.metrics.record_error(where, exc)
        if where == "slot_join" and self._join_fallback(r):
            return
        r.fail(exc, self.clock())
        self.metrics.record_finish("error", len(r.tokens))
        self._cbs.emit("on_finish", r)

    def _join_fallback(self, r):
        """Serve a request whose join failed every attempt some other way;
        True when it did. Default: no fallback."""
        return False

    def _fail_active(self, exc):
        """A decode step failed every attempt: the batched step is
        all-or-nothing, so every in-flight request ends with its partial
        tokens and the cause, the pool is rebuilt, and serving
        continues."""
        now = self.clock()
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            self.slots[s] = None
            self._evict(s)
            self.metrics.record_finish("error", len(r.tokens))
            r.finish("error", now, error=exc)
            self._cbs.emit("on_finish", r)
        self._reset_pool()

    def _replay_diverged(self, r, i, tok, now):
        """A resumed slot re-decoded `tok` where the caller holds
        `r.tokens[i]`: the request fails with its delivered tokens."""
        e = ReplayDiverged(f"resumed request re-decoded token {tok} at "
                           f"position {i}, where it delivered "
                           f"{r.tokens[i]}")
        s = r.slot
        self.slots[s] = None
        self._evict(s)
        self._unpark(r)
        r.slot = None
        self.metrics.record_error("replay", e)
        self.metrics.record_finish("error", len(r.tokens))
        r.finish("error", now, error=e)
        self._cbs.emit("on_finish", r)

    def _emit_token(self, r, tok, now):
        """Hand one token to the request and its observers: the token
        list, the counters, the first-token time, the callbacks and the
        stream."""
        r.tokens.append(tok)
        self.metrics.record_token(self._tenant_of(r))
        if r.first_token_at is None:
            r.first_token_at = now
            if r._trace is not None:
                _rt.on_first_token(r)
            if r.submitted_at is not None:
                self.metrics.record_first_token(now - r.submitted_at)
        self._cbs.emit("on_token", r, tok)
        if r.stream_cb is not None:
            try:
                r.stream_cb(r, tok)
            except Exception as e:
                # a broken streaming callback must not stall the pool;
                # the failure is recorded, never swallowed
                self.metrics.record_error("stream_cb", e)

    def _deliver(self, r, tok, now):
        if r.state == "DONE":
            return
        if r._replay > 0:
            # a resumed request re-decodes the tokens its caller holds
            # (greedy decoding repeats them): absorb each after checking
            # it, with no append, no callback and no second TTFT
            i = len(r.tokens) - r._replay
            if tok != r.tokens[i]:
                self._replay_diverged(r, i, tok, now)
                return
            r._replay -= 1
            self.metrics.record_replay_token()
            return
        self._emit_token(r, tok, now)
        if r.eos_id is not None and tok == r.eos_id:
            self._finish_slot(r.slot, "eos", now)
        elif len(r.tokens) >= r.max_new_tokens:
            self._finish_slot(r.slot, "length", now)

    def run_iteration(self, scheduler):
        """One iteration: harvest, admit (preempting when the scheduler
        asks), one chunk of one chunked prefill, decode. Returns True
        when any work was done (False = idle). A speculative step
        delivers up to k tokens per slot, stopping the moment the slot
        finishes."""
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
        # asynchronous joins: land the finished disaggregated prefills
        if self._poll_pending(now):
            progress = True

        def _queue_death(req):   # cancelled / expired while queued
            self._unpark(req)
            self.metrics.record_finish(req.finish_reason, len(req.tokens))
            self._cbs.emit("on_finish", req)

        joins = 0
        tok0s = []   # (request, device token 0), synced after the loop
        while joins < self.max_joins_per_iter:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                s = self._preempt_for(scheduler, now)
                if s is None:
                    break
                free = [s]
                progress = True
            r = scheduler.pop_ready(now, on_dead=_queue_death)
            if r is None:
                break
            try:
                self.admit_check(r)
            except ValueError as e:
                self._unpark(r)
                self.metrics.record_error("admit", e)
                r.fail(e, now)
                self.metrics.record_finish("error", len(r.tokens))
                self._cbs.emit("on_finish", r)
                continue
            if not self._admission_gate(r):
                # resource backpressure: the request stays queued at the
                # head, joins stop for this iteration, decode drains
                scheduler.push_front(r)
                break
            s = self._choose_slot(free)
            r.state, r.slot = "RUNNING", s
            self.slots[s] = r
            if _trace._SESSION is not None:
                _rt.on_join_begin(r, s)
            try:
                tok = self._guarded("slot_join", lambda: self._join(s, r),
                                    _PT_SLOT_JOIN)
            except Exception as e:
                if r._trace is not None:
                    _rt.on_join_end(r, ok=False, error=e)
                self._release_failed(s, r, "slot_join", e)
                progress = True
                continue
            joins += 1
            progress = True
            if r._trace is not None:
                _rt.on_join_end(r, pending=s in self._pending)
            if r._replay > 0:
                # a preempted request re-joined: its replay count was
                # armed at the preemption
                self.metrics.record_resume()
            self.metrics.record_join()
            self._cbs.emit("on_join", r, s)
            if tok is None:          # a chunked prefill's token 0 comes
                continue             # with its final chunk
            if self.sync_tok0:
                self._deliver(r, int(tok), self.clock())
            else:
                tok0s.append((r, tok))
        if tok0s:
            # one host sync for the whole admission round's first tokens
            firsts = torch.stack([t for _, t in tok0s]).cpu().tolist()
            for (r, _), tok in zip(tok0s, firsts):
                self._deliver(r, int(tok), self.clock())
        # one chunk of one chunked prefill, BEFORE the decode step
        if self._advance_chunks(self.clock()):
            progress = True
        active = np.asarray([r is not None and s not in self._pending
                             for s, r in enumerate(self.slots)], bool)
        if active.any():
            t0 = self.clock()
            _ts0 = (time.perf_counter()
                    if _trace._SESSION is not None else 0.0)
            try:
                toks = self._guarded(
                    "decode_step", lambda: self._decode_step(active),
                    _PT_DECODE, retry_tokens=int(active.sum()))
            except Exception as e:
                self.metrics.record_error("decode_step", e)
                self._fail_active(e)
                progress = True
            else:
                now2 = self.clock()
                if _trace._SESSION is not None:
                    _rt.on_decode_step(self, _ts0, time.perf_counter(),
                                       active, scheduler)
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
                # roofline gauges: one global read disarmed; armed, the
                # step's analytic flops and bytes land in the MFU and
                # bandwidth reservoirs
                if _costs._BOOK is not None:
                    self._record_step_cost(now2 - t0)
                # the gap co-resident requests see between their tokens:
                # a long inline prefill widens it, chunking bounds it
                if self._last_step_done is not None:
                    self.metrics.record_step_gap(now2 - self._last_step_done)
                self._last_step_done = now2
                progress = True
        else:
            self._last_step_done = None
        self.metrics.record_iteration(scheduler.depth(),
                                      self.occupancy() / self.num_slots,
                                      **(self._iteration_gauges() or {}))
        lag_fn = getattr(scheduler, "wfq_lag_by_tenant", None)
        if lag_fn is not None:
            self.metrics.set_wfq_lag(lag_fn())
        self._cbs.emit("on_iteration", {
            "queue_depth": scheduler.depth(),
            "occupancy": self.occupancy(), "joins": joins})
        if self.metrics.budget_bytes > 0:
            ledger = self.memory_ledger()
            if ledger is not None:
                self.metrics.check_memory_watermark(ledger["in_use_bytes"])
        return progress

    def memory_ledger(self):
        """The `memory` section's components (None: not tracked)."""
        return None

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

    Chunked prefill: `prefill_chunk` (a power of two >= 2; on a paged
    pool also a multiple of `page_size`). A prompt longer than it joins
    as a pending slot. One chunk an iteration, the pending slots taking
    turns, runs through a batch-1 view of the slot's rows in verify mode
    (the flash verify at T = the chunk, the paged verify's tiled route on
    pages), and the final chunk gives token 0. Pending slots sit out the
    decode step.

    Fault isolation and retries: `max_attempts`, `backoff_base_s`,
    `backoff_cap_s`, `watchdog_s`, `sleep` (see `_EngineBase`);
    `hbm_budget_bytes` arms the memory watermark at `hbm_watermark` of
    it. `eager_fallback=True`: a request whose join fails every attempt
    is served alone by `text.generation.generate_eager` on the base
    model (the JAX engine's degradation: a tenant's request too), its
    tokens delivered at once (`fallbacks` counts them). `callbacks=`:
    `ServingCallback`s (`serving/metrics.py`).

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
                 quantize=None, prefill_chunk=None, eager_fallback=False,
                 **kw):
        super().__init__(num_slots, max_joins_per_iter=max_joins_per_iter,
                         metrics=metrics, clock=clock, **kw)
        self.eager_fallback = bool(eager_fallback)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 2 or prefill_chunk & (prefill_chunk - 1):
                raise ValueError(
                    f"prefill_chunk={prefill_chunk}: must be a power of two "
                    f">= 2 (compile-bucket granularity)")
        self.prefill_chunk = prefill_chunk
        self._chunking = {}         # slot -> chunked-prefill progress
        self._chunk_turn = -1       # the pending slot that ran last
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
        if not getattr(self, "_accepts_sharded_params", False):
            _reject_sharded_params(
                self._net, f"{type(self).__name__}"
                f"{'(paged=True)' if paged else ''}")
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
        self.placement = self._make_placement()
        self.stepper = SpecStepper(self) if spec_k else PlainStepper(self)
        self._state = None          # built on the first join
        self._mem_shape = None
        self._dtype = None
        self._pool_key = None
        self._weights_bytes = None
        self._n_params = None       # cached for cost_hint
        self._fingerprint = None    # the model part of the cache keys
        self._precompile_mem = None
        # the program cache the compile observer wraps: a program's first
        # run (one per key) surfaces as a "compile" span
        self._compiled = _trace.JitCache(self)
        self.metrics.set_memory_provider(self.memory_ledger)

    def _make_placement(self):
        """Where the bodies run (layers.py): one card here; the sharded
        engine's `ShardedPlacement` holds its dp shard of the slots."""
        return SinglePlacement(self)

    def _program(self, key, body):
        """`body` as the cached program at `key`: its first run bumps
        `trace_counts[key]` (the port's counterpart of a jit compile: the
        kernels build, the libraries plan, the allocator grows), and
        under an armed session the observer records that run as a
        ``compile`` span. The keys are the JAX engines' program keys."""
        fn = self._compiled.get(key)
        if fn is None:
            self._compiled[key] = _costs.first_run(self, key, body)
            fn = self._compiled[key]
        return fn

    # ---- zero-warmup startup: precompile + the AOT cache ----
    def precompile(self, memory, *, dtype="float32",
                   prompt_buckets=(8, 16, 32, 64), cache=None, persist=True):
        """Ready EVERY serving program of this pool config before the
        first request: one join program per prompt bucket plus the
        batched decode step (or the spec draft / verify pair; the paged
        pool adds attach / cow / pattach; chunked prefill its chunk
        program). A program comes out of the persistent `cache` (an
        `AotCompileCache` or a directory path) when its record and every
        kernel library it launches are valid there: the warm start, no
        nvcc process and no first run. Otherwise it is readied by one run
        on scratch state (the pool and its counters stay as they were),
        which builds the libraries it launches (through the cache, which
        keeps them and the program's record for the NEXT start when
        `persist`). `memory` is the cross-attention memory: an example [M,
        D] tensor or its shape tuple (+ `dtype`); it pins the pool config
        as the first join would. Returns the cold_start report (also in
        `metrics.snapshot()["cold_start"]`)."""
        if torch.is_tensor(memory) or isinstance(memory, np.ndarray):
            mem = torch.as_tensor(memory).to(self.device)
        else:
            M, Dm = memory
            mem = torch.zeros((int(M), int(Dm)),
                              dtype=getattr(torch, str(dtype)),
                              device=self.device)
        self._ensure_state(mem)
        self._precompile_mem = mem
        progs = self._startup_programs(prompt_buckets)
        return self._precompile_run(progs, cache, persist)

    def _program_fingerprint(self):
        """Identity folded into every persistent-cache key, so two engines
        with different models or pool configs never collide in one cache
        directory."""
        if self._fingerprint is None:
            from ..tuning.aot_cache import model_fingerprint

            self._fingerprint = model_fingerprint(
                [*self._net.named_parameters(), *self._net.named_buffers()])
        return (f"{type(self).__name__}|{self._fingerprint}|"
                f"{self._pool_key}")

    def _program_cache_key(self, key):
        return f"{self._program_fingerprint()}|{key!r}"

    def _startup_example(self):
        """(mem1 [1, M, D], active [S] bool, zero drafts [S, k - 1]) for the
        startup programs' example arguments."""
        S, dev = self.num_slots, self.device
        mem1 = self._precompile_mem[None]
        active = torch.zeros((S,), dtype=torch.bool, device=dev)
        drafts = torch.zeros((S, max(1, (self.spec_k or 2) - 1)),
                             dtype=torch.int32, device=dev)
        return mem1, active, drafts

    def _step_programs(self, step_key, spec_key):
        """The per-iteration programs: the n-gram draft and the verify
        step under spec_k, else the batched step."""
        lay = self.layout
        mem1, active, drafts = self._startup_example()
        if self.spec_k:
            return [(lay.draft_key(), lay.draft, ()),
                    (spec_key, lay.spec_step,
                     (drafts, active, active, self.spec_k))]
        return [(step_key, lay.step, (active,))]

    def _startup_programs(self, prompt_buckets):
        """[(key, body, example_args)] for every program this pool config
        serves with: the program-cache key (the JAX engine's), the layout
        body `_program` caches under it, and arguments shaped like the
        runtime calls."""
        lay, dev = self.layout, self.device
        mem1, _, _ = self._startup_example()
        progs = []
        for Pb in sorted({bucket_size(int(p)) for p in prompt_buckets}):
            progs.append((("join", Pb), lay.join,
                          (0, torch.zeros((1, Pb), dtype=torch.long,
                                          device=dev), 1, mem1, 0)))
        progs += self._step_programs(lay.step_key(), lay.spec_step_key())
        if self.prefill_chunk:
            # bucket-length prompts chunk in full-size chunks only, so ONE
            # cjoin program covers the precompile surface; ragged final
            # chunks first-run their smaller bucket on demand
            Cb = self.prefill_chunk
            progs.append((("cjoin", Cb), lay.chunk,
                          (0, torch.zeros((1, Cb), dtype=torch.long,
                                          device=dev), 0, 1, 2 * Cb, mem1,
                           torch.zeros((1, 2 * Cb), dtype=torch.long,
                                       device=dev), 0)))
        return progs

    def _inplace_state(self):
        """The pool leaves every program updates in place: all of them
        (the port writes its pool in place and donates no carry).
        `analysis.program` audits PTA102 against this set."""
        from ..analysis.program import _leaves

        return set(_leaves(self._state))

    def _scratch_swap(self):
        """Point the engine at a zeroed scratch pool (returns what to
        restore): a startup program's run writes there, never into the
        pool's live rows."""
        saved = (self._state,)
        self._state = self.placement.run(self.layout.build_state,
                                         self._precompile_mem)
        return saved

    def _scratch_restore(self, saved):
        (self._state,) = saved

    def _precompile_run(self, progs, cache, persist):
        """Ready every (key, body, args) program: from the persistent
        cache when its record and libraries are valid there, else by one
        first run on scratch state (the libraries it launches built
        through the cache), and install the body in the program cache, so
        serving adds no first run. Returns the cold_start report."""
        from ..ops import _build
        from ..tuning.aot_cache import AotCompileCache

        t_start = time.perf_counter()
        if cache is not None and not isinstance(cache, AotCompileCache):
            cache = AotCompileCache(cache)
        err0 = (cache.stats["corrupt"] + cache.stats["stale"]) \
            if cache is not None else 0
        cuda = self.device.type == "cuda"
        n_loaded = n_compiled = n_ready = n_failed = 0
        with _build.use_cache(cache):
            for key, body, args in progs:
                if key in self._compiled:
                    n_ready += 1
                    continue
                t0 = time.perf_counter()
                ck = self._program_cache_key(key)
                source = "cache" if self._program_from_cache(
                    ck, cache, cuda) else "compile"
                if source == "compile":
                    before = _build.launches()
                    try:
                        self._scratch_run(key, body, args)
                    except Exception as e:
                        # a program that cannot be readied here still runs
                        # lazily at first use: precompile must never take
                        # the pool down
                        self.metrics.record_error("precompile", e)
                        n_failed += 1
                        continue
                    stems = _build.launched_stems(before, _build.launches())
                    n_compiled += 1
                    if cache is not None and persist:
                        _build.persist(stems, cache)
                        cache.store_record(ck, {
                            "key": ck, "stems": stems,
                            "libraries": [_build.library_key(st)
                                          for st in stems]})
                else:
                    n_loaded += 1
                t1 = time.perf_counter()
                self._compiled[key] = body
                n_ready += 1
                if _trace._SESSION is not None:
                    _trace.record_precompile(self, key, t0, t1, source)
                if _costs._BOOK is not None:
                    _costs.capture_compiled(self, key, compile_s=t1 - t0)
        errs = ((cache.stats["corrupt"] + cache.stats["stale"])
                if cache is not None else 0) - err0
        report = {
            "time_to_ready_s": round(time.perf_counter() - t_start, 4),
            "programs": n_ready,
            "loaded_from_cache": n_loaded,
            "compiled": n_compiled,
            "cache_errors": errs,
            "build_failures": n_failed,
            "warm": int(n_compiled == 0 and n_failed == 0),
        }
        self.metrics.record_cold_start(report)
        return report

    def _program_from_cache(self, ck, cache, cuda):
        """Whether the program record `ck` and every kernel library it
        names come valid out of `cache` (the libraries are then bound, no
        nvcc started). A record of other sources or another toolchain
        (library keys of another build digest) reads as a miss."""
        if cache is None:
            return False
        rec = cache.load_record(ck)
        if rec is None or rec.get("key") != ck:
            return False
        stems = list(rec.get("stems", ()))
        from ..ops import _build

        if rec.get("libraries") != [_build.library_key(st) for st in stems]:
            return False
        if not cuda or not stems:
            return True
        n0 = len(_build.build_info().get("compiled", ()))
        _build.load(stems, cache=cache)
        return len(_build.build_info().get("compiled", ())) == n0

    def _scratch_run(self, key, body, args):
        """One first run of `body` (bumping `trace_counts[key]`) on a
        scratch pool."""
        saved = self._scratch_swap()
        try:
            self.placement.run(_costs.first_run(self, key, body), *args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self._scratch_restore(saved)

    def _pool_key_of(self, memory):
        """The pool component of the step-program keys, as the JAX
        engine spells it: (slots, pool length, M, D, memory dtype) +
        (paged: page size, pages, kv_dtype) + speculation + adapters."""
        M, Dm = memory.shape
        key = (self.num_slots, self._pool_len, M, Dm,
               str(memory.dtype).replace("torch.", ""))
        if isinstance(self, PagedServingEngine):
            key += (self.page_size, self.num_pages, str(self.kv_dtype))
        if self.spec_k:
            key += (("spec", self.spec_k, self.spec_ngram),)
        if self._apool is not None:
            p = self._apool
            key += (("lora", p.capacity, p.rank, len(p.targets)),)
        return key

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
        self._chunking.pop(s, None)
        self._pending.discard(s)
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
        """The `memory` section's components: weights, pool, adapter banks,
        the bytes in use, and the first-run temp high-water of the armed
        cost book (0 when accounting is off)."""
        w, a = self.weights_bytes(), self.adapter_bytes()
        return {"weights_bytes": w, "pool_bytes": self.pool_bytes(),
                "adapter_bytes": a,
                "in_use_bytes": w + a + self.pool_in_use_bytes(),
                "compile_temp_peak_bytes": _costs.temp_high_water()}

    # ---- analytic cost hints (profiler.costs) ----
    def _model_dims(self):
        """(n_params, n_layers, heads, head_dim, mem_len) for the
        analytic flop formulas."""
        if self._n_params is None:
            self._n_params = sum(
                t.numel() for t in [*self._net.parameters(),
                                    *self._net.buffers()])
        decoder = self._net.decoder
        h0 = decoder.layers[0].self_attn
        M = self._mem_shape[0] if self._mem_shape else 0
        return (self._n_params, len(decoder.layers), h0.num_heads,
                h0.head_dim, M)

    def _step_cost_key(self):
        if self._pool_key is None:
            return None
        return (self.layout.spec_step_key() if self.spec_k
                else self.layout.step_key())

    def cost_hint(self, key):
        """The JAX engine's analytic costs, key kind by key kind: the
        step computes all S rows over the full (masked) max_len window;
        the k-token verify feeds spec_k query rows through the same net;
        a join, chunk or tail prefill its bucket's query rows; the draft,
        attaches and page copies move bytes only."""
        kind = key[0] if isinstance(key, tuple) and key else key
        n_params, n_layers, heads, hd, M = self._model_dims()
        pool = self.pool_bytes()
        w = self.weights_bytes()
        if kind in ("step", "pstep", "sstep", "pverify"):
            flops = _costs.transformer_decode_flops(
                n_params, self.num_slots, self.max_len, n_layers,
                heads, hd, mem_len=M)
            if kind in ("sstep", "pverify"):
                flops *= (self.spec_k or 1)
            return {"flops": flops, "bytes_accessed": w + pool,
                    "argument_bytes": w + pool}
        if kind == "draft":
            return {"flops": 0.0, "bytes_accessed": pool,
                    "argument_bytes": pool}
        rows = {"join": 1, "pjoin": 1, "prefill": 1, "cjoin": 1,
                "pattach": 2, "pcjoin": 2}.get(kind)
        if rows is not None and len(key) > rows:
            flops = _costs.transformer_prefill_flops(
                n_params, 1, int(key[rows]), n_layers, heads, hd,
                mem_len=M)
            return {"flops": flops, "bytes_accessed": w + pool,
                    "argument_bytes": w + pool}
        if kind in ("attach", "cow", "splice"):
            return {"flops": 0.0, "bytes_accessed": pool,
                    "argument_bytes": pool}
        return None

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
            self._pool_key = self._pool_key_of(memory)
            self._post_state_build()

    def _post_state_build(self):
        """Hook once the pool state exists (paged: the page byte size)."""

    def _join(self, s, r):
        _PT_PREFILL()
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, Pb = pad_prompt_row(r.prompt, pad_id)
        memory = r.memory.to(self.device)
        self._ensure_state(memory)
        if r._trace is not None:
            _rt.on_join_attr(r, prompt_bucket=Pb)
        if self.prefill_chunk is not None and P0 > self.prefill_chunk:
            return self._pinned_join(s, r, lambda row: self._chunk_begin(
                s, r, prompt_b, P0, Pb, memory[None]))
        prompt = torch.as_tensor(prompt_b, device=self.device)
        join = self._program(("join", Pb), self.layout.join)
        return self._pinned_join(s, r, lambda row: self.placement.run(
            join, s, prompt, P0, memory[None], row))

    # ---- graceful degradation: a solo eager serve ----
    def _join_fallback(self, r):
        """`eager_fallback=True`: serve the request alone on the eager
        concat-cache path (slower, but the caller gets its exact tokens);
        a failing eager run is recorded and the request fails as it would
        have."""
        if not self.eager_fallback:
            return False
        try:
            toks, n = self._run_eager(r)
        except Exception as e:
            self.metrics.record_error("eager_fallback", e)
            return False
        self.metrics.record_fallback()
        now = self.clock()
        for t in toks[:n]:
            self._emit_token(r, int(t), now)
        reason = ("eos" if r.eos_id is not None and r.tokens and
                  r.tokens[-1] == r.eos_id else "length")
        self.metrics.record_finish(reason, len(r.tokens))
        r.finish(reason, now)
        self._cbs.emit("on_finish", r)
        return True

    def _run_eager(self, r):
        from ..text.generation import generate_eager

        net = self._net
        eos = int(r.eos_id) if r.eos_id is not None else -1
        P = int(r.prompt.shape[0])
        with torch.inference_mode():
            toks, lens = generate_eager(
                net.decoder, net.embed, net.project,
                r.memory.to(self.device)[None], r.prompt[None], [P],
                bos_id=0, eos_id=eos, max_new_tokens=r.max_new_tokens,
                pad_prompt_to=bucket_size(max(1, P)))
        return toks[0], min(int(lens[0]), r.max_new_tokens)

    # ---- chunked prefill ----
    def _chunk_begin(self, s, r, prompt_b, P0, Pb, memory):
        """Register slot `s` as a pending chunked prefill: no model runs
        at join time; `_advance_chunks` runs one chunk an iteration. The
        slot's write index moves to Pb now, so the masked writes the
        decode steps make for this inactive slot land past the prompt,
        where its own first decode write replaces them."""
        with torch.inference_mode():
            for c in self._state["inc"]:
                c.index[s] = Pb
        self._chunk_register(s, r, prompt_b, P0, Pb, memory, 0)
        return None

    def _chunk_register(self, s, r, prompt_b, P0, Pb, memory, pos):
        self._chunking[s] = {"r": r, "prompt_b": prompt_b, "P0": P0,
                             "Pb": Pb, "memory": memory, "pos": pos}
        self._pending.add(s)
        self.metrics.record_chunked_join()

    def _chunk_bucket(self, pos, P0):
        """(Cb, final) for the chunk starting at `pos`: `prefill_chunk`
        mid-prompt, the tail's power-of-two bucket (>= 2, the verify
        path) for the final chunk, which never crosses Pb."""
        if pos + self.prefill_chunk < P0:
            return self.prefill_chunk, False
        return max(2, bucket_size(P0 - pos)), True

    def _advance_chunks(self, now):
        # pending slots take turns: the next one after the last served
        order = sorted(self._chunking)
        turn = [s for s in order if s > self._chunk_turn] + \
            [s for s in order if s <= self._chunk_turn]
        for s in turn:
            info = self._chunking[s]
            r = info["r"]
            if self.slots[s] is not r or r.state == "DONE":
                continue   # harvested since it registered
            self._chunk_turn = s
            _ts0 = (time.perf_counter()
                    if _trace._SESSION is not None else 0.0)
            try:
                tok0 = self._guarded(
                    "prefill_chunk", lambda: self._chunk_step(s, info),
                    _PT_CHUNK)
            except Exception as e:
                self._release_failed(s, r, "prefill_chunk", e)
                return True
            self.metrics.record_chunk()
            if r._trace is not None:
                _rt.on_chunk(r, _ts0, time.perf_counter(), info["pos"],
                             info["pos"] >= info["P0"])
            if info["pos"] >= info["P0"]:
                self._chunking.pop(s, None)
                self._pending.discard(s)
                self._chunk_finalize(s, info)
                self._deliver(r, int(tok0), self.clock())
            return True
        return False

    def _chunk_step(self, s, info):
        """One chunk through the slot's pool rows; `info["pos"]` advances
        only after the chunk ran, so a retry re-runs the same chunk (its
        writes are position-idempotent)."""
        P0, Pb, pos = info["P0"], info["Pb"], info["pos"]
        Cb, _ = self._chunk_bucket(pos, P0)
        dev = self.device
        prompt = torch.as_tensor(info["prompt_b"], device=dev)
        tok0 = self.placement.run(
            self._program(("cjoin", Cb), self.layout.chunk), s,
            prompt[:, pos:pos + Cb], pos, P0, Pb, info["memory"], prompt,
            int(self._adapter_rows[s]))
        info["pos"] = pos + Cb
        return tok0

    def _chunk_finalize(self, s, info):
        """Host bookkeeping once the final chunk ran (paged: the prefix
        trie and the tail copy-on-write)."""

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
        time (in the kernels on the card);
      * chunked prefill writes each chunk straight into the slot's pages
        through a width-clipped table row (the verify path, as a partial
        hit's tail), and each finished chunk's full pages enter the trie
        at once, so a fault later in the sequence loses only its chunk;
      * preemption parks the victim's prompt pages in the trie, pinned
        against eviction until the request resumes, so the resume is a
        whole-prefix attach: `prefill_count` grows by cold prompts only.

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
        if self.prefill_chunk is not None and \
                self.prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be a multiple of "
                f"page_size={page_size}: chunk frontiers must be "
                f"page-aligned so every finished chunk is a "
                f"radix-trie-insertable run of full pages")
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

    def _parked_key(self, r):
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, Pb = pad_prompt_row(r.prompt, pad_id)
        return prompt_b[0, :P0], P0, Pb, self._mem_key(r), \
            self._tenant_key(r)

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

    def table_bytes(self):
        """The int32 page table shipped to the card every step."""
        return self.num_slots * self.max_pages * 4

    def pool_bytes(self):
        """The pages, the per-slot rows and the page table (as the JAX
        engine counts them; 0 before the first join)."""
        b = _tensor_bytes(self._state)
        return b + self.table_bytes() if b else 0

    def pool_in_use_bytes(self):
        """The pool less its free pages."""
        return self.pool_bytes() - \
            self._alloc.pages_free * (self._page_bytes or 0)

    # ---- zero-warmup startup (the paged program set) ----
    def _scratch_swap(self):
        saved = (self._state, self._table, self._index)
        self._state = self.placement.run(self.layout.build_state,
                                         self._precompile_mem)
        self._table = np.full_like(saved[1], -1)
        self._index = np.zeros_like(saved[2])
        return saved

    def _scratch_restore(self, saved):
        self._state, self._table, self._index = saved

    def _startup_programs(self, prompt_buckets):
        lay, dev = self.layout, self.device
        mem1, _, _ = self._startup_example()
        psz, npg = self.page_size, self.num_pages
        buckets = sorted({bucket_size(int(p)) for p in prompt_buckets})

        def zeros(n):
            return torch.zeros((1, n), dtype=torch.long, device=dev)

        def trash_row(W):
            return torch.full((1, W), npg, dtype=torch.int32, device=dev)

        progs = []
        for Pb in buckets:
            n_pp = pages_for(Pb, psz)
            progs.append((("pjoin", Pb), lay.join,
                          (0, zeros(Pb), 1, mem1,
                           np.arange(n_pp, dtype=np.int64), 0)))
        if self._prefix is not None:
            progs.append((("attach",), lay.attach,
                          (0, 0, 1, 1, mem1, zeros(1))))
            progs.append((("cow",), lay.cow, (0, 0)))
            if self._radix_partial_ok():
                # the partial-attach pairs the radix cache hits first: a
                # last-page divergence per admitted prompt bucket (matched
                # = all but one page, tail = one page)
                pairs = sorted({(bucket_size(max(1, pages_for(Pb, psz) - 1)),
                                 max(2, bucket_size(min(psz, Pb))))
                                for Pb in buckets})
                for Mb, Tb in pairs:
                    W = min(self.max_pages, Mb + pages_for(Tb, psz))
                    progs.append((("pattach", Mb, Tb), lay.pattach,
                                  (0, trash_row(W), zeros(Tb), 1, 1, Tb,
                                   mem1, zeros(Tb), 0)))
        if self.prefill_chunk:
            # one pcjoin per matched-page bucket the chunk walk of a
            # bucket-length prompt visits; ragged final chunks first-run
            # their smaller bucket on demand
            Cb = self.prefill_chunk
            mbs = set()
            for Pb in buckets:
                for pos in range(0, Pb, Cb) if Pb > Cb else ():
                    mbs.add(bucket_size(pos // psz, minimum=1))
            for Mb in sorted(mbs):
                W = min(self.max_pages, Mb + pages_for(Cb, psz))
                progs.append((("pcjoin", Mb, Cb), lay.pattach,
                              (0, trash_row(W), zeros(Cb), 0, 1, 2 * Cb,
                               mem1, zeros(2 * Cb), 0)))
        return progs + self._step_programs(lay.step_key(),
                                           lay.spec_step_key())

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
        if r._trace is not None:
            _rt.on_join_attr(r, prompt_bucket=Pb,
                             prefix_hit=res is not None and
                             res[0] == "whole")
            if self._prefix is not None:
                _rt.on_prefix_match(
                    r, kind, matched_pages=pages_for(matched, self.page_size)
                    if matched else 0, matched_tokens=matched)
        args = (s, r, prompt_b, P0, Pb, memory[None])
        if res is not None and res[0] == "whole":
            tok0 = self._attach_shared(res[1], *args)
            self._unpark(r)          # the slot holds the pages now
            return tok0
        # a parked prefix is pinned until the resume: only a pool reset
        # (a failed decode step flushes the trie) can make this a miss
        self._unpark(r)
        chunk = self.prefill_chunk
        if res is not None:
            if chunk is not None and \
                    P0 - len(res[1]["pages"]) * self.page_size > chunk:
                # a long divergent tail: chunk from the matched full pages
                # (a mid-page match re-prefills inside the first chunk)
                return self._chunk_begin(s, r, prompt_b, P0, Pb,
                                         memory[None], res[1]["pages"])
            return self._pattach_join(res[1], *args, row)
        if chunk is not None and P0 > chunk:
            return self._chunk_begin(s, r, prompt_b, P0, Pb, memory[None])
        return self._prefill_join(*args, row)

    def _prefill_join(self, s, r, prompt_b, P0, Pb, memory, row):
        _PT_PREFILL()
        n_pp = pages_for(Pb, self.page_size)
        pages = self._alloc_pages(n_pp)
        try:
            tok0 = self.placement.run(
                self._program(("pjoin", Pb), self.layout.join), s,
                torch.as_tensor(prompt_b, device=self.device), P0, memory,
                pages, row)
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
        _PT_PATTACH()
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
                self.placement.run(self._program(("cow",), self.layout.cow),
                                   int(match["cow_src"]), dst)
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
                self._program(("pattach", Mb, Tb), self.layout.pattach), s,
                torch.as_tensor(trow, device=dev),
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
                self._program(("attach",), self.layout.attach), s,
                int(hit["tok0"]), P0, Pb, memory,
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
            self.placement.run(self._program(("cow",), self.layout.cow),
                               src, dst)
        except Exception:
            self._alloc.decref([dst])
            raise
        self._alloc.decref([src])
        self._table[s, pi] = dst
        self.metrics.record_cow_copy()

    # ---- chunked prefill through the pages ----
    def _chunk_begin(self, s, r, prompt_b, P0, Pb, memory, matched=()):
        """Register a pending chunked prefill. The matched full pages of a
        radix partial hit map read-only first and seed the frontier. The
        host index follows the frontier mid-prompt: pending slots sit out
        the decode step and the page mapper, and their masked writes land
        on the unmapped (trash) page at the page-aligned frontier."""
        matched = [int(p) for p in matched]
        if matched:
            self._alloc.incref(matched)
            self._table[s, :len(matched)] = matched
        pos = len(matched) * self.page_size
        self._index[s] = pos
        self._chunk_register(s, r, prompt_b, P0, Pb, memory, pos)
        return None

    def _chunk_step(self, s, info):
        r = info["r"]
        P0, Pb, pos = info["P0"], info["Pb"], info["pos"]
        psz = self.page_size
        Cb, final = self._chunk_bucket(pos, P0)
        end = pos + Cb
        n_have = pos // psz       # chunk frontiers are page-aligned
        n_need = pages_for(end, psz) - n_have
        fresh = self._alloc_pages(n_need) if n_need > 0 else []
        Mb = bucket_size(n_have, minimum=1)
        W = min(self.max_pages, Mb + pages_for(Cb, psz))
        trow = np.full((1, W), self.num_pages, np.int32)
        pages_now = [int(p) for p in self._table[s, :n_have]] + fresh
        k = min(W, len(pages_now))
        trow[0, :k] = pages_now[:k]
        dev = self.device
        prompt = torch.as_tensor(info["prompt_b"], device=dev)
        try:
            tok0 = self.placement.run(
                self._program(("pcjoin", Mb, Cb), self.layout.pattach), s,
                torch.as_tensor(trow, device=dev), prompt[:, pos:end], pos,
                P0, Pb, info["memory"], prompt, int(self._adapter_rows[s]))
        except Exception:
            if fresh:
                self._alloc.decref(fresh)
            raise
        if fresh:
            self._table[s, n_have:n_have + len(fresh)] = fresh
        # mid-prompt the index sits at the frontier; the final chunk moves
        # it to Pb, past the pad hole
        self._index[s] = Pb if final else end
        info["pos"] = end
        if final:
            info["tok0"] = tok0
        elif self._prefix is not None:
            # every finished chunk's full pages enter the trie now: the
            # work survives a later failure of the sequence
            self._prefix.insert_prefix(
                info["prompt_b"][0, :end], self._mem_key(r),
                self._tenant_key(r),
                [int(p) for p in self._table[s, :end // psz]])
        return tok0

    def _chunk_finalize(self, s, info):
        r, P0, Pb = info["r"], info["P0"], info["Pb"]
        self.prefill_count += 1
        if self._prefix is not None:
            pages = [int(p) for p in self._table[s] if p >= 0]
            self._prefix.insert(info["prompt_b"][0, :P0], P0, Pb,
                                self._mem_key(r), self._tenant_key(r), pages,
                                info["tok0"])
        self._cow_tail(s, Pb)

    # ---- preemption: park the prompt pages in the prefix trie ----
    def can_preempt(self, s):
        """A running slot, out of any chunked prefill, with token 0
        delivered (its prompt pages are complete), on a pool with a prefix
        cache to park them in."""
        r = self.slots[s]
        return (self._prefix is not None and r is not None and
                s not in self._pending and r.state == "RUNNING" and
                len(r.tokens) >= 1)

    def preempt_slot(self, s, now):
        if not self.can_preempt(s):
            return None
        r = self.slots[s]
        _PT_PREEMPT()    # on the host, before any mutation
        tokens, P0, Pb, mem, tenant = self._parked_key(r)
        pages = []
        for p in self._table[s, :pages_for(Pb, self.page_size)]:
            if p < 0:
                break
            pages.append(int(p))
        # park the prompt K/V in the trie (an existing terminal is only
        # refreshed) and pin it until the resume, THEN release the slot:
        # the pages live on through the trie's references
        self._prefix.insert(tokens, P0, Pb, mem, tenant, pages,
                            int(r.tokens[0]), pin=True)
        if r._trace is not None:
            _rt.on_preempt(r, s, len(r.tokens))
        r._parked = True
        self.slots[s] = None
        self._evict(s)
        r.slot = None
        r.state = "QUEUED"
        # greedy decoding repeats the delivered tokens: the resumed slot
        # re-decodes them and `_deliver` absorbs exactly this many
        r._replay = len(r.tokens)
        r._preemptions += 1
        self.metrics.record_preemption()
        return r

    def _unpark(self, r):
        if getattr(r, "_parked", False):
            r._parked = False
            if self._prefix is not None:
                self._prefix.unpin(*self._parked_key(r))

    def _evict_oom(self, s, exc, now):
        """The pool ran dry mid-decode: the starved slot ends with its
        partial tokens and the `OutOfPages` cause; the pool keeps
        serving."""
        r = self.slots[s]
        self.slots[s] = None
        self._evict(s)
        self.metrics.record_oom_eviction()
        self.metrics.record_error("out_of_pages", exc)
        self.metrics.record_finish("error", len(r.tokens))
        r.finish("error", now, error=exc)
        self._cbs.emit("on_finish", r)

