"""Traffic shaping for the serving runtime: SLO classes, weighted fair
queueing over tenants, and fairness-aware preemption.

The port's copy of the JAX package's `serving/shaping.py`. The bounded
FIFO (`scheduler.Scheduler`) admits in arrival order, which is fine for
one traffic class and bad for mixed traffic: one batch tenant with long
prompts starves every interactive request behind it. The
`ShapingScheduler` is the control plane over what the serving stack
already has:

  * **SLO classes** — every request carries an `SLOClass` (interactive
    vs batch by default) with TTFT/TPOT targets. Admission is ordered
    by (class rank, TTFT deadline): an interactive request never waits
    behind queued batch work, and within a class the request closest
    to missing its target goes first.
  * **weighted fair queueing** — across tenants (adapter identities),
    a classic virtual-time WFQ: each pop charges the tenant
    `cost / weight` of virtual time (cost = prompt + max_new tokens,
    the slot-time the request will occupy), and the tenant whose
    backlog has the smallest finish tag is served next. Per-tenant
    lag (finish tag − pool virtual time) is published into the
    ServingMetrics "slo" section every iteration — the enforcement
    counterpart of the `tenancy.fairness` Jain gauge.
  * **preemption** — when the pool is full and the queue head outranks
    a running preemptible slot, `pick_preempt_victim` names the victim;
    the engine parks its prompt pages in the prefix cache, so the resume
    attaches them with no prefill.
    `max_preemptions` bounds per-request churn.
  * **admission gating** — batch-class admission closes while the HBM
    ledger sits above its watermark (`metrics.watermark_exceeded()`)
    or goodput degrades below `min_goodput`: under memory pressure the
    pool finishes what it has instead of thrashing preemptions.

The engine discovers the shaping hooks by duck typing
(`pick_preempt_victim` / `requeue_preempted` / `wfq_lag_by_tenant`);
the plain `Scheduler` has none of them, so a FIFO-driven engine runs
exactly the pre-shaping code path — the degenerate single-class
config. Chunked prefill (the `prefill_chunk` engine knob) is
independent of the scheduler choice; together they bound both halves
of interactive latency: chunking bounds decode-step inter-arrival,
shaping bounds time-to-slot."""
from __future__ import annotations

import collections
import threading
import time

from ..profiler import trace as _trace
from . import tracing as _rt
from .scheduler import _PT_ADMIT, QueueFull

__all__ = ["SLOClass", "INTERACTIVE", "BATCH", "ShapingScheduler"]


class SLOClass:
    """A traffic class and its latency contract. `rank` orders classes
    (lower = more latency-critical; admission and preemption both
    honor it); `preemptible` marks classes whose running slots may be
    evicted to the prefix cache for higher-ranked work."""

    __slots__ = ("name", "ttft_target_s", "tpot_target_s",
                 "preemptible", "rank")

    def __init__(self, name, *, ttft_target_s, tpot_target_s,
                 preemptible=False, rank=0):
        self.name = str(name)
        self.ttft_target_s = float(ttft_target_s)
        self.tpot_target_s = float(tpot_target_s)
        self.preemptible = bool(preemptible)
        self.rank = int(rank)

    def __repr__(self):
        return (f"SLOClass({self.name!r}, ttft={self.ttft_target_s}s, "
                f"tpot={self.tpot_target_s}s, rank={self.rank}, "
                f"preemptible={self.preemptible})")


#: the default two-class config: latency-bound chat traffic vs
#: throughput-bound batch jobs (summaries, evals, backfills)
INTERACTIVE = SLOClass("interactive", ttft_target_s=0.5,
                       tpot_target_s=0.1, rank=0)
BATCH = SLOClass("batch", ttft_target_s=30.0, tpot_target_s=1.0,
                 preemptible=True, rank=1)


def _tenant(r):
    """Fairness key: the adapter identity (matches the engine's
    tenancy accounting — base-model traffic is one tenant)."""
    return r.adapter if r.adapter is not None else "base"


def _cost(r):
    """WFQ service cost: the slot-time the request will occupy, in
    token units (prompt prefill + decode budget)."""
    return float(int(r.prompt.shape[0]) + r.max_new_tokens)


class ShapingScheduler:
    """Drop-in replacement for `Scheduler` (same surface: submit /
    pop_ready / push_front / depth / drain / pop_all / abort_queued)
    plus the shaping hooks the engine duck-types. Thread-safe."""

    def __init__(self, max_queue=64, clock=time.monotonic, *,
                 tenant_weights=None, default_weight=1.0,
                 classes=None, default_class=BATCH,
                 max_preemptions=2, min_goodput=0.0, metrics=None):
        self.max_queue = int(max_queue)
        self.clock = clock
        if classes is None:
            classes = (INTERACTIVE, BATCH)
        self.classes = {c.name: c for c in classes}
        self.default_class = (self.classes[default_class]
                              if isinstance(default_class, str)
                              else default_class)
        self.tenant_weights = dict(tenant_weights or {})
        self.default_weight = float(default_weight)
        self.max_preemptions = int(max_preemptions)
        self.min_goodput = float(min_goodput)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._draining = False
        self._seq = 0
        # per-tenant backlogs, each kept sorted by the within-tenant
        # priority key; _front is the engine's return lane (page
        # backpressure deferrals) — served first, never re-charged
        self._q = {}                       # tenant -> [request, ...]
        self._front = collections.deque()
        # WFQ virtual-time state: pool virtual time advances to each
        # served request's start tag; a tenant's finish tag trails it
        # by exactly the service its backlog has been charged
        self._vt = 0.0
        self._ft = {}                      # tenant -> finish tag

    # ---- class / priority plumbing ----
    def _resolve_class(self, r):
        slo = r.slo
        if slo is None:
            return self.default_class
        if isinstance(slo, str):
            try:
                return self.classes[slo]
            except KeyError:
                raise ValueError(
                    f"unknown SLO class {slo!r}; registered: "
                    f"{sorted(self.classes)}") from None
        return slo

    def _prio(self, r):
        """Within-tenant order: class rank, then the TTFT deadline
        (submit + target — the request closest to missing its target
        first), then arrival."""
        return (r.slo.rank, r.submitted_at + r.slo.ttft_target_s,
                r._shape_seq)

    def _weight(self, tenant):
        return float(self.tenant_weights.get(tenant,
                                             self.default_weight))

    def _goodput_ratio(self):
        m = self.metrics
        if m is None:
            return 1.0
        wasted_drafts = m.drafts_proposed - m.drafts_accepted
        denom = (m.useful_tokens + m.wasted_tokens + m.retry_tokens +
                 wasted_drafts)
        return m.useful_tokens / denom if denom else 1.0

    def _gated(self, cls):
        """Admission gate for low-priority classes: while the HBM
        ledger is above its watermark or goodput has degraded, batch
        admission closes (interactive traffic keeps flowing — it is
        what preemption protects)."""
        if cls.rank == 0 or self.metrics is None:
            return False
        if self.metrics.watermark_exceeded():
            return True
        return (self.min_goodput > 0.0 and
                self._goodput_ratio() < self.min_goodput)

    # ---- Scheduler surface ----
    def submit(self, request):
        """Enqueue under the request's SLO class (resolving string
        names), or raise QueueFull — at the high-water mark like the
        FIFO, and additionally for gated batch-class admission."""
        now = self.clock()
        _PT_ADMIT()
        cls = self._resolve_class(request)
        with self._lock:
            if self._draining:
                raise RuntimeError("scheduler is draining: admission "
                                   "closed")
            if self._depth_locked() >= self.max_queue:
                raise QueueFull(
                    f"request queue at high-water mark "
                    f"({self.max_queue}); shed load or retry")
            if self._gated(cls):
                raise QueueFull(
                    f"admission gated for class {cls.name!r}: pool "
                    f"under memory/goodput pressure; retry later")
            request.slo = cls
            request.submitted_at = now
            request._shape_seq = self._seq
            self._seq += 1
            self._insert(request)
        if _trace._SESSION is not None:
            _rt.on_submit(request)
        return request

    # caller (submit) holds the lock
    def _insert(self, r):       # analysis: single-threaded
        q = self._q.setdefault(_tenant(r), [])
        key = self._prio(r)
        lo, hi = 0, len(q)
        while lo < hi:            # insertion sort: queues are short
            mid = (lo + hi) // 2
            if self._prio(q[mid]) <= key:
                lo = mid + 1
            else:
                hi = mid
        q.insert(lo, r)

    def _select_tenant(self):
        """The tenant to serve next: strict class priority first (the
        best head rank present), then the smallest WFQ finish tag the
        head would be charged, then the earlier deadline."""
        best, best_key = None, None
        for t, q in self._q.items():
            if not q:
                continue
            h = q[0]
            tag = (max(self._vt, self._ft.get(t, 0.0)) +
                   _cost(h) / self._weight(t))
            key = (h.slo.rank, tag,
                   h.submitted_at + h.slo.ttft_target_s, h._shape_seq)
            if best_key is None or key < best_key:
                best, best_key = t, key
        return best

    # callers (pop_ready / drain) hold the lock — the _locked suffix
    # is the contract
    def _pop_locked(self):      # analysis: single-threaded
        """Next request under the lock: the return lane first (no WFQ
        charge — it was charged on its first pop), then the WFQ pick,
        charging its tenant's virtual time."""
        if self._front:
            return self._front.popleft()
        t = self._select_tenant()
        if t is None:
            return None
        r = self._q[t].pop(0)
        if not self._q[t]:
            del self._q[t]
        start = max(self._vt, self._ft.get(t, 0.0))
        self._ft[t] = start + _cost(r) / self._weight(t)
        self._vt = start
        return r

    def pop_ready(self, now=None, on_dead=None):
        """Next admissible request by shaping order, finalizing queued
        requests that died on the way (cancel/deadline — the FIFO's
        screening contract). Returns None when idle."""
        if now is None:
            now = self.clock()
        while True:
            with self._lock:
                r = self._pop_locked()
            if r is None:
                return None
            if r.cancelled or r.expired(now):
                r.finish("cancelled" if r.cancelled else "timeout", now)
                if on_dead is not None:
                    on_dead(r)
                continue
            if r._trace is not None:
                _rt.on_queue_exit(r)
            return r

    def push_front(self, request):
        """Return an admitted request to the head (resource
        backpressure deferral): served before any queued work, no
        second WFQ charge. Bypasses the high-water mark on purpose."""
        if request._trace is not None:
            _rt.on_requeue(request)
        with self._lock:
            self._front.appendleft(request)

    def depth(self):
        with self._lock:
            return self._depth_locked()

    def _depth_locked(self):
        return len(self._front) + sum(len(q) for q in self._q.values())

    # ---- drain / teardown (FIFO contract) ----
    def drain(self):
        with self._lock:
            self._draining = True

    @property
    def draining(self):
        return self._draining

    def pop_all(self):
        with self._lock:
            out = list(self._front)
            for t in sorted(self._q):
                out.extend(self._q[t])
            self._front.clear()
            self._q.clear()
        return out

    def abort_queued(self, reason, now=None):
        if now is None:
            now = self.clock()
        out = []
        while True:
            with self._lock:
                r = self._pop_locked()
            if r is None:
                return out
            r.finish(reason if not r.cancelled else "cancelled", now)
            out.append(r)

    # ---- shaping hooks (the engine duck-types these) ----
    def _peek(self):
        with self._lock:
            if self._front:
                return self._front[0]
            t = self._select_tenant()
            return None if t is None else self._q[t][0]

    def pick_preempt_victim(self, engine, now):
        """The pool is full and the engine asks whom to evict. A slot
        qualifies when the waiting head STRICTLY outranks it, its class
        is preemptible, it has churn budget left, and the engine can
        checkpoint it (`can_preempt`: paged pool + prefix cache + at
        least one delivered token). Among candidates, the one with the
        fewest delivered tokens loses — the cheapest replay."""
        head = self._peek()
        if head is None or head.slo is None:
            return None
        best, best_key = None, None
        for s, r in enumerate(engine.slots):
            if r is None:
                continue
            slo = getattr(r, "slo", None)
            if (slo is None or not slo.preemptible or
                    head.slo.rank >= slo.rank or
                    r._preemptions >= self.max_preemptions or
                    not engine.can_preempt(s)):
                continue
            key = (-slo.rank, len(r.tokens), r.id)
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def requeue_preempted(self, r):
        """A preempted request re-enters the backlog at its class
        priority (behind the interactive work it yielded to). The next
        pop charges its tenant again — re-admission occupies slot time
        twice, so WFQ accounts it twice."""
        with self._lock:
            self._insert(r)

    def wfq_lag_by_tenant(self):
        """Per-tenant virtual-time lag (finish tag − pool virtual
        time) for tenants with backlog or unspent charge: 0 means the
        tenant is keeping pace with its weight; a large lag means its
        demand exceeds its share. Published into the metrics "slo"
        section each iteration."""
        with self._lock:
            out = {}
            for t, ft in self._ft.items():
                lag = ft - self._vt
                if lag > 1e-9 or t in self._q:
                    out[t] = max(0.0, lag)
            return out
