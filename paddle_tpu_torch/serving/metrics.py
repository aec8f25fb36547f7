"""Serving metrics: requests, tokens, TTFT and slot occupancy; the
"paging" section (page occupancy, waits, out-of-pages evictions) once a
paged pool records, the "prefix" section (radix prefix-cache hits,
copy-on-write copies, trie size) once a paged join consults the trie,
the "speculation" section (draft acceptance, adaptive k, draft and
verify step latency) once a speculative step runs, the "tenancy"
section (tokens and slots by tenant, adapter loads, evictions, hit rate,
waits, fairness) once an engine with an AdapterPool records, and the
"memory" section (weights, pool and adapter-bank bytes, the budget
watermark) once an engine registers its ledger, and the "slo" section
(chunked prefills, preemptions, resumes, replayed tokens, per-class
TTFT / TPOT attainment, WFQ lag) once a traffic-shaping feature records.
The section and key names are the JAX package's (`serving/metrics.py`);
`SNAPSHOT_DOCS` documents every key a snapshot can hold. Thread-safe;
`snapshot()` may be called from any thread at any time.

`to_prometheus(snapshot, tracer=)` renders a snapshot in Prometheus'
text format; `ServingCallback` is the engines' hook surface (`callbacks=`
on every engine: on_submit, on_reject, on_join, on_token, on_finish,
on_iteration), fanned out by `CallbackList`, which records a raising
hook as an error instead of letting it stop the pool."""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["ServingMetrics", "SNAPSHOT_DOCS", "flatten_snapshot",
           "to_prometheus", "ServingCallback", "CallbackList"]

#: Every key `ServingMetrics.snapshot()` can emit, flattened with "."
#: (a reservoir summary is one key whose value is the {n, mean, p50, p99,
#: max} dict): (kind, meaning). A fully populated snapshot flattens to
#: exactly these keys (tests/test_torch_shaping.py).
SNAPSHOT_DOCS = {
    "requests.submitted": ("counter", "requests accepted by submit()"),
    "requests.rejected": ("counter", "QueueFull backpressure rejects"),
    "requests.completed": ("counter", "finished with eos / length / drain"),
    "requests.cancelled": ("counter", "caller-cancelled requests"),
    "requests.timeouts": ("counter",
                          "deadline evictions (queued or mid-decode)"),
    "requests.failed": ("counter", "finished with reason 'error'"),
    "requests.aborted": ("counter", "finalized by a non-drain shutdown"),
    "errors": ("counter", "internal failures recorded anywhere"),
    "last_error": ("info", "last recorded error {where, type, message, at}"),
    "retries": ("counter", "engine ops retried after a failed attempt"),
    "fallbacks": ("counter", "requests degraded to the solo eager path"),
    "joins": ("counter", "successful slot joins"),
    "iterations": ("counter", "engine iterations run"),
    "tokens_out": ("counter",
                   "delivered tokens incl. the prefill first token"),
    "decode_tokens": ("counter", "tokens out of batched decode steps"),
    "decode_tokens_per_s": ("gauge", "decode tokens / decode wall seconds"),
    "ttft_ms": ("summary", "time to first token (submit -> token 0)"),
    "token_latency_ms": ("summary", "batched decode-step wall latency"),
    "step_gap_ms": ("summary", "decode-step inter-arrival: the gap "
                               "co-resident requests see between tokens"),
    "queue_depth": ("summary", "scheduler depth sampled per iteration"),
    # sharded pools: the section appears once any of these record
    "sharding.prefill_step_ms": (
        "summary", "prefill-slice step: dispatch -> the splice lands"),
    "sharding.decode_step_ms": (
        "summary", "decode-step latency (the token_latency reservoir)"),
    "sharding.step_gap_ms": (
        "summary", "decode-step inter-arrival co-resident requests see"),
    "sharding.per_shard_occupancy": (
        "gauge", "last-iteration occupancy per dp shard of the pool"),
    "sharding.collective_ms": (
        "counter", "host-timed cross-slice transfer milliseconds"),
    "sharding.collective_events": (
        "counter", "cross-slice transfers (splices, weight placement)"),
    "sharding.collective_time_share": (
        "gauge", "collective / (collective + prefill + decode) time"),
    "occupancy": ("summary", "occupied-slot fraction per iteration"),
    "goodput.useful_tokens": ("counter",
                              "tokens of requests that completed"),
    "goodput.wasted_tokens": ("counter", "tokens of requests that ended "
                                         "otherwise (error, cancel, timeout)"),
    "goodput.retry_tokens": ("counter", "token-slots burned by retried "
                                        "decode attempts"),
    "goodput.ratio": ("gauge", "useful / (useful + wasted + retry + wasted "
                               "drafts)"),
    "memory.weights_bytes": ("gauge", "parameters and buffers served"),
    "memory.pool_bytes": ("gauge", "the slot pool's device state"),
    "memory.adapter_bytes": ("gauge", "the stacked LoRA banks"),
    "memory.total_bytes": ("gauge", "weights + pool + adapter banks"),
    "memory.in_use_bytes": ("gauge", "the live part (paged: less free "
                                     "pages)"),
    "memory.budget_bytes": ("gauge", "the configured device-memory budget "
                                     "(0: none)"),
    "memory.watermark_warnings": ("counter", "crossings of the budget "
                                             "watermark"),
    "memory.compile_temp_peak_bytes": (
        "gauge", "the armed cost book's largest first-run transient: the "
                 "allocator's peak above the live bytes (0 disarmed)"),
    # MFU / bandwidth gauges: the section appears while a profiler.costs
    # accounting session records per-step utilization
    "mfu.device": ("info",
                   "roofline spec {name, peak_tflops, peak_gbps, ...}"),
    "mfu.cost_source": ("info", "'analytic': the engine's cost_hint"),
    "mfu.flops_per_step": ("gauge", "decode-step flops (analytic)"),
    "mfu.bytes_per_step": ("gauge", "decode-step bytes accessed "
                                    "(analytic)"),
    "mfu.model_flops_util": (
        "summary", "per-step achieved flops / DeviceSpec peak"),
    "mfu.bandwidth_util": (
        "summary", "per-step bytes accessed / DeviceSpec peak bandwidth"),
    "tenancy.tenants": ("gauge", "tenants that received tokens"),
    "tenancy.active_slots_by_tenant": ("info", "last-iteration occupied "
                                               "slots per tenant"),
    "tenancy.tokens_by_tenant": ("info", "delivered tokens per tenant"),
    "tenancy.adapter_loads": ("counter", "adapter bank-row loads"),
    "tenancy.adapter_evictions": ("counter", "adapter bank-row evictions"),
    "tenancy.adapter_hit_rate": ("gauge", "acquires served by a hot row"),
    "tenancy.adapter_waits": ("counter", "admissions deferred on rows"),
    "tenancy.fairness": ("gauge", "Jain's index over per-tenant tokens"),
    "paging.pages_in_use": ("gauge", "pages referenced"),
    "paging.pages_free": ("gauge", "pages on the free list"),
    "paging.prefix_hits": ("counter", "joins that reused cached pages"),
    "paging.prefix_misses": ("counter", "joins that reused nothing"),
    "paging.prefix_hit_rate": ("gauge", "hits / (hits + misses)"),
    "paging.page_waits": ("counter", "admissions deferred on pages"),
    "paging.oom_evictions": ("counter", "mid-decode OutOfPages victims"),
    "paging.bytes_per_active_token": ("summary", "page bytes per live "
                                                 "token"),
    "prefix.whole_hits": ("counter", "joins with every prompt page cached"),
    "prefix.partial_hits": ("counter", "joins that prefilled only a tail"),
    "prefix.misses": ("counter", "joins with no cached prefix"),
    "prefix.hit_token_ratio": ("gauge", "prompt tokens served cached"),
    "prefix.cow_copies": ("counter", "copy-on-write page copies"),
    "prefix.trie_nodes": ("gauge", "radix trie nodes"),
    "prefix.trie_pages": ("gauge", "pages the trie references"),
    "speculation.rounds": ("counter", "draft + verify rounds"),
    "speculation.drafts_proposed": ("counter", "draft tokens verified"),
    "speculation.drafts_accepted": ("counter", "draft tokens accepted"),
    "speculation.acceptance_rate": ("gauge", "accepted / proposed"),
    "speculation.accepted_per_step": ("summary", "accepted drafts per "
                                                 "active slot a round"),
    "speculation.draft_step_ms": ("summary", "draft dispatch wall time"),
    "speculation.verify_step_ms": ("summary", "verify dispatch wall time"),
    "speculation.wasted_draft_tokens": ("counter", "proposed - accepted"),
    "speculation.effective_k": ("gauge", "the adaptive draft depth"),
    "speculation.k_shrink_events": ("counter", "adaptive k shrinks"),
    "speculation.k_grow_events": ("counter", "adaptive k regrowths"),
    "speculation.step_ms_by_variant": ("info", "draft / verify p50 by pool"),
    "slo.preemptions": ("counter", "batch-class slots evicted to the "
                                   "prefix cache under pressure"),
    "slo.resumes": ("counter", "preempted requests re-admitted (resume "
                               "attaches the parked prefix, no re-prefill)"),
    "slo.replay_tokens": ("counter", "already-delivered tokens a resumed "
                                     "request re-absorbed silently"),
    "slo.chunked_prefills": ("counter", "joins split into chunked prefill "
                                        "(prompt past prefill_chunk)"),
    "slo.chunks": ("counter", "prefill chunks dispatched between decode "
                              "steps"),
    "slo.ttft_attainment": ("info", "per-class share of finished requests "
                                    "that met their TTFT target"),
    "slo.tpot_attainment": ("info", "per-class share of finished requests "
                                    "that met their TPOT target"),
    "slo.wfq_lag_by_tenant": ("info", "per-tenant WFQ virtual-time lag "
                                      "(finish tag - pool virtual time)"),
    # cold start: the section appears once the engine runs precompile()
    "cold_start.time_to_ready_s": (
        "gauge", "precompile() wall seconds until every serving program "
                 "was ready"),
    "cold_start.programs": (
        "gauge", "serving programs readied at startup (join buckets + "
                 "steps + paged attach/cow)"),
    "cold_start.loaded_from_cache": (
        "gauge", "programs whose record and kernel libraries came valid "
                 "out of the AOT cache: no nvcc, no first run"),
    "cold_start.compiled": (
        "gauge", "programs readied by a first run at startup (a cache "
                 "miss or a cold start; their libraries built or loaded)"),
    "cold_start.cache_errors": (
        "counter", "corrupt / stale cache entries that fell back to a "
                   "fresh build (never a crash)"),
    "cold_start.warm": (
        "gauge", "1 when every program came from the cache: the warm "
                 "start"),
    "cold_start.first_ttft_ms": (
        "gauge", "TTFT of the very first request after start (the number "
                 "warm and cold starts compare)"),
}

_SUMMARY_KEYS = {"n", "mean", "p50", "p99", "max"}
_LEAF_DICTS = {"last_error", "speculation.step_ms_by_variant", "mfu.device",
               "tenancy.active_slots_by_tenant", "tenancy.tokens_by_tenant",
               "slo.ttft_attainment", "slo.tpot_attainment",
               "slo.wfq_lag_by_tenant"}


def flatten_snapshot(snap, _prefix=""):
    """Flatten a snapshot() dict to {dotted key: leaf}; reservoir
    summaries and the `_LEAF_DICTS` stay leaves."""
    out = {}
    for k, v in snap.items():
        key = f"{_prefix}{k}"
        if isinstance(v, dict) and key not in _LEAF_DICTS and \
                not set(v) <= _SUMMARY_KEYS:
            out.update(flatten_snapshot(v, key + "."))
        else:
            out[key] = v
    return out


def _prom_escape(s):
    return (str(s).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def to_prometheus(snapshot, tracer=None, prefix="paddle_tpu_serving"):
    """Render a snapshot() (plus, optionally, a `profiler.trace.Tracer`
    session's counters) in the Prometheus text exposition format, as the
    JAX package does: one HELP / TYPE head a key from `SNAPSHOT_DOCS`
    (unknown keys as gauges), reservoir summaries by `stat`, info dicts
    as labels, lists by `index`."""
    lines = []

    def head(name, kind, doc):
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} "
                     f"{'counter' if kind == 'counter' else 'gauge'}")

    flat = flatten_snapshot(snapshot)
    for key in sorted(flat):
        kind, doc = SNAPSHOT_DOCS.get(key, ("gauge", ""))
        v = flat[key]
        name = prefix + "_" + key.replace(".", "_")
        if v is None:
            continue
        if isinstance(v, dict) and set(v) <= _SUMMARY_KEYS:
            head(name, "gauge", doc)
            for stat in sorted(v):
                lines.append(f'{name}{{stat="{stat}"}} {float(v[stat])}')
        elif kind == "info" and isinstance(v, dict):
            head(name, "gauge", doc)
            labels = ",".join(f'{lk}="{_prom_escape(lv)}"'
                              for lk, lv in sorted(v.items()))
            lines.append(f"{name}{{{labels}}} 1")
        elif isinstance(v, (list, tuple)):
            head(name, kind, doc)
            for i, sv in enumerate(v):
                lines.append(f'{name}{{index="{i}"}} {float(sv)}')
        elif isinstance(v, (int, float)):
            head(name, kind, doc)
            lines.append(f"{name} {float(v)}")
    if tracer is not None:
        name = prefix + "_tracer_events"
        head(name, "counter", "tracer session counters")
        for cname in sorted(tracer.counters):
            lines.append(f'{name}{{counter="{_prom_escape(cname)}"}} '
                         f'{float(tracer.counters[cname])}')
        head(prefix + "_tracer_spans_dropped", "counter",
             "spans overwritten past the ring-buffer capacity")
        lines.append(f"{prefix}_tracer_spans_dropped "
                     f"{float(tracer.dropped)}")
    return "\n".join(lines) + "\n"


class ServingCallback:
    """hapi-style hooks: subclass, override what you need, pass instances
    to the engine (`callbacks=`). Every hook is a no-op by default; hooks
    run on the engine thread (`on_submit` / `on_reject` on the caller's),
    so keep them cheap."""

    def on_submit(self, request):
        pass

    def on_reject(self, request, reason):
        pass

    def on_join(self, request, slot):
        pass

    def on_token(self, request, token):
        pass

    def on_finish(self, request):
        pass

    def on_iteration(self, stats):
        pass


class CallbackList:
    """Fan-out invoker (as hapi.callbacks.CallbackList): an exception in
    one hook never stops the serving loop; it goes to `on_error(hook_name,
    exc)` (the engines record it as `callback.<hook>`)."""

    def __init__(self, callbacks=(), on_error=None):
        self.callbacks = list(callbacks)
        self.on_error = on_error

    def append(self, cb):
        self.callbacks.append(cb)

    def emit(self, name, *args):
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is None:
                continue
            try:
                fn(*args)
            except Exception as e:
                if self.on_error is not None:
                    self.on_error(name, e)


def _jain(tokens_by_tenant):
    """Jain's fairness index over per-tenant delivered tokens:
    (sum x)^2 / (n * sum x^2), 1.0 when every tenant got an equal share,
    1/n when one tenant took everything."""
    xs = [float(v) for v in tokens_by_tenant.values() if v > 0]
    if not xs:
        return 1.0
    s = sum(xs)
    return round((s * s) / (len(xs) * sum(x * x for x in xs)), 4)


class _Reservoir:
    """Bounded sample buffer (ring overwrite) with percentile reads."""

    def __init__(self, cap=2048):
        self.cap = int(cap)
        self._buf = []
        self._next = 0
        self.count = 0

    def add(self, x):
        x = float(x)
        if len(self._buf) < self.cap:
            self._buf.append(x)
        else:
            self._buf[self._next] = x
            self._next = (self._next + 1) % self.cap
        self.count += 1

    def summary(self, scale=1.0):
        if not self._buf:
            return {"n": 0}
        a = np.asarray(self._buf, dtype=np.float64) * scale
        return {"n": self.count, "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)), "max": float(a.max())}

    def p50(self, scale=1.0):
        return self.summary(scale).get("p50")


class ServingMetrics:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._memory_provider = None
        # the device-memory budget arms the watermark the shaping
        # scheduler's admission gate reads; identity, kept by reset()
        self.budget_bytes = 0
        self.watermark_frac = 0.9
        self._init_counters()

    def _init_counters(self):   # analysis: single-threaded
        # __init__ (no second thread yet) and reset() (under the lock)
        self.submitted = 0
        self.rejected = 0           # backpressure (QueueFull)
        self.completed = 0          # finished with "eos" / "length"
        self.cancelled = 0
        self.timeouts = 0
        self.failed = 0             # finished with reason "error"
        self.aborted = 0            # shutdown
        self.errors = 0             # internal failures of any kind
        self.last_error = None
        self.joins = 0
        self.iterations = 0
        self.tokens_out = 0         # every delivered token
        self.decode_tokens = 0      # tokens out of batched decode steps
        self.decode_time_s = 0.0
        self.ttft_s = _Reservoir()
        self.token_latency_s = _Reservoir()
        self.queue_depth = _Reservoir(512)
        self.occupancy = _Reservoir(512)
        # paging (the section appears once a paged pool records)
        self.pages_in_use = None          # last-iteration gauges
        self.pages_free = None
        self.page_waits = 0               # admissions deferred on pages
        self.oom_evictions = 0            # mid-decode OutOfPages victims
        self.bytes_per_token = _Reservoir(512)
        # the radix prefix cache (once a paged join consults the trie)
        self._prefix_recorded = False
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_whole_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_matched_tokens = 0    # prompt tokens served cached
        self.prefix_prompt_tokens = 0     # prompt tokens offered
        self.cow_copies = 0
        self.trie_nodes = None
        self.trie_pages = None
        # speculative decoding (once a draft / verify pair runs)
        self._spec_recorded = False
        self.spec_rounds = 0
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        self.accepted_per_step = _Reservoir(512)
        self.draft_step_s = _Reservoir(512)
        self.verify_step_s = _Reservoir(512)
        self.spec_k_eff = None
        self.spec_k_shrinks = 0
        self.spec_k_grows = 0
        self._spec_by_variant = {}
        # multi-tenant serving (once an engine with an AdapterPool records)
        self._tenancy = False
        self.tokens_by_tenant = {}
        self.tenant_slots = None          # last-iteration gauge
        self.adapter_loads = 0
        self.adapter_evictions = 0
        self.adapter_hits = 0
        self.adapter_misses = 0
        self.adapter_waits = 0
        # fault isolation (the retry layer) and the goodput split
        self.retries = 0
        self.fallbacks = 0          # requests degraded to the eager path
        self.retry_tokens = 0
        self.useful_tokens = 0
        self.wasted_tokens = 0
        self.watermark_warnings = 0
        self._above_watermark = False
        self.step_gap_s = _Reservoir()
        # sharded-serving accounting (the snapshot grows a "sharding"
        # section once any of these record): the prefill-slice step of a
        # disaggregated prefill (dispatch -> its splice lands), the
        # engine-driven cross-slice transfers, the dp shards' occupancy
        self._sharded = False
        self.prefill_step_s = _Reservoir()
        self.collective_s = 0.0
        self.collective_events = 0
        self.shard_occupancy = None
        # traffic shaping: chunked prefill, preemption, SLO classes, WFQ
        self._slo = False
        self.preemptions = 0
        self.resumes = 0
        self.replay_tokens = 0
        self.chunked_prefills = 0
        self.chunks = 0
        self.slo_finishes = {}      # class -> {n, ttft_ok, tpot_ok}
        self.wfq_lag = {}           # tenant -> virtual-time lag
        # cold start: the engine's precompile() report and the first
        # request's TTFT (what a restart costs callers)
        self._cold_start = None
        self.first_ttft_s = None
        # roofline gauges (while a cost-accounting session records)
        self._mfu = False
        self._spec = None
        self.cost_source = None
        self.flops_per_step = 0.0
        self.bytes_per_step = 0.0
        self.mfu_util = _Reservoir(512)
        self.bw_util = _Reservoir(512)

    def reset(self):
        """Start a fresh measurement epoch: every counter, reservoir and
        gauge back to zero; the clock, the ledger provider and the budget
        stay."""
        with self._lock:
            self._init_counters()

    def record_submit(self):
        with self._lock:
            self.submitted += 1

    def record_reject(self):
        with self._lock:
            self.rejected += 1

    def record_join(self):
        with self._lock:
            self.joins += 1

    def record_first_token(self, ttft_s):
        with self._lock:
            self.ttft_s.add(ttft_s)
            if self.first_ttft_s is None:
                # the first request ever: the cold-start comparison's number
                self.first_ttft_s = float(ttft_s)

    def record_token(self, tenant=None):
        """One delivered token; `tenant` (the adapter name, "base", or
        None when the engine carries no AdapterPool) feeds the tenancy
        section."""
        with self._lock:
            self.tokens_out += 1
            if tenant is not None:
                self._tenancy = True
                self.tokens_by_tenant[tenant] = \
                    self.tokens_by_tenant.get(tenant, 0) + 1

    def record_decode(self, n_tokens, dt_s):
        """One batched decode step delivered `n_tokens` in `dt_s`."""
        with self._lock:
            self.decode_tokens += n_tokens
            self.decode_time_s += dt_s
            if n_tokens:
                self.token_latency_s.add(dt_s)

    def record_finish(self, reason, n_tokens=0):
        """A request finished with `reason`; its `n_tokens` delivered
        tokens count as useful for a completion, as wasted otherwise."""
        with self._lock:
            if reason in ("eos", "length", "drain"):
                self.completed += 1
                self.useful_tokens += int(n_tokens)
                return
            self.wasted_tokens += int(n_tokens)
            if reason == "cancelled":
                self.cancelled += 1
            elif reason == "timeout":
                self.timeouts += 1
            elif reason == "error":
                self.failed += 1
            else:
                self.aborted += 1

    def record_error(self, where, exc):
        with self._lock:
            self.errors += 1
            self.last_error = {"where": where, "type": type(exc).__name__,
                               "message": str(exc), "at": self._clock()}

    def record_fallback(self):
        with self._lock:
            self.fallbacks += 1

    def record_retry(self, where, n_tokens=0):
        """A failed engine op is being retried; for a decode step
        `n_tokens` is the active-slot count the failed attempt burned."""
        with self._lock:
            self.retries += 1
            self.retry_tokens += int(n_tokens)

    def record_step_gap(self, dt_s):
        """Wall time between two consecutive decode steps' ends."""
        with self._lock:
            self.step_gap_s.add(dt_s)

    # ---- sharded serving ----
    def record_prefill_step(self, dt_s):
        """One disaggregated prefill landed: dispatch -> splice, polled at
        iteration granularity."""
        with self._lock:
            self._sharded = True
            self.prefill_step_s.add(dt_s)

    def record_collective(self, dt_s):
        """Host-timed cross-slice traffic the ENGINE moves: a prefill
        slice's K/V landing in the decode slice, or the weights' placement
        (a layer's own collectives inside a step are not counted here)."""
        with self._lock:
            self._sharded = True
            self.collective_s += float(dt_s)
            self.collective_events += 1

    # ---- traffic shaping ----
    def record_chunked_join(self):
        """A join went chunked: its prefill interleaves with decode steps
        one chunk an iteration."""
        with self._lock:
            self._slo = True
            self.chunked_prefills += 1

    def record_chunk(self):
        """One prefill chunk dispatched between decode steps."""
        with self._lock:
            self._slo = True
            self.chunks += 1

    def record_preemption(self):
        """A batch-class slot was parked in the prefix cache to free a
        slot for higher-ranked work."""
        with self._lock:
            self._slo = True
            self.preemptions += 1

    def record_resume(self):
        """A preempted request re-joined by attaching its parked prefix."""
        with self._lock:
            self._slo = True
            self.resumes += 1

    def record_replay_token(self):
        """A resumed request re-produced a token it had delivered; the
        engine absorbed it silently."""
        with self._lock:
            self._slo = True
            self.replay_tokens += 1

    def record_slo_finish(self, name, ttft_s, tpot_s, ttft_target_s,
                          tpot_target_s):
        """A classed request completed: fold its TTFT and TPOT against
        the class targets into the per-class attainment shares."""
        with self._lock:
            self._slo = True
            c = self.slo_finishes.setdefault(
                name, {"n": 0, "ttft_ok": 0, "tpot_ok": 0})
            c["n"] += 1
            if float(ttft_s) <= float(ttft_target_s):
                c["ttft_ok"] += 1
            if float(tpot_s) <= float(tpot_target_s):
                c["tpot_ok"] += 1

    def set_wfq_lag(self, lag_by_tenant):
        """The ShapingScheduler's per-tenant WFQ lag at the last
        iteration."""
        with self._lock:
            if lag_by_tenant:
                self._slo = True
            self.wfq_lag = {str(t): round(float(v), 4)
                            for t, v in lag_by_tenant.items()}

    def check_memory_watermark(self, in_use_bytes):
        """Hold the live bytes against the budget: the first crossing of
        watermark_frac * budget bumps `watermark_warnings` (once an
        excursion). Returns True while above the watermark."""
        if self.budget_bytes <= 0:
            return False
        above = in_use_bytes >= self.watermark_frac * self.budget_bytes
        with self._lock:
            if above and not self._above_watermark:
                self.watermark_warnings += 1
            self._above_watermark = above
        return above

    def watermark_exceeded(self):
        """True while the ledger last sat above the armed watermark (the
        shaping scheduler closes batch-class admission then)."""
        with self._lock:
            return self._above_watermark

    def record_iteration(self, queue_depth, occupancy, pages_in_use=None,
                         pages_free=None, bytes_per_active_token=None,
                         trie_nodes=None, trie_pages=None,
                         tenant_slots=None, shard_occupancy=None):
        with self._lock:
            self.iterations += 1
            if shard_occupancy is not None:
                self._sharded = True
                self.shard_occupancy = [round(float(x), 3)
                                        for x in shard_occupancy]
            self.queue_depth.add(queue_depth)
            self.occupancy.add(occupancy)
            if tenant_slots is not None:
                self._tenancy = True
                self.tenant_slots = dict(tenant_slots)
            if pages_in_use is not None:
                self.pages_in_use = int(pages_in_use)
            if pages_free is not None:
                self.pages_free = int(pages_free)
            if trie_nodes is not None:
                self.trie_nodes = int(trie_nodes)
            if trie_pages is not None:
                self.trie_pages = int(trie_pages)
            if bytes_per_active_token is not None:
                self.bytes_per_token.add(bytes_per_active_token)

    def record_prefix(self, kind, matched_tokens=0, prompt_tokens=0):
        """A paged join consulted the prefix cache: `kind` is "whole"
        (every prompt page mapped shared, zero prefill), "partial" (the
        matched prefix mapped, only the divergent tail prefilled) or
        "miss". The token counts feed hit_token_ratio."""
        with self._lock:
            self._prefix_recorded = True
            if kind == "whole":
                self.prefix_hits += 1
                self.prefix_whole_hits += 1
            elif kind == "partial":
                self.prefix_hits += 1
                self.prefix_partial_hits += 1
            else:
                self.prefix_misses += 1
            self.prefix_matched_tokens += int(matched_tokens)
            self.prefix_prompt_tokens += int(prompt_tokens)

    def record_cow_copy(self, n=1):
        with self._lock:
            self._prefix_recorded = True
            self.cow_copies += n

    def record_page_wait(self):
        """Admission deferred: too few free pages for the queue head."""
        with self._lock:
            self.page_waits += 1

    def record_oom_eviction(self, n=1):
        with self._lock:
            self.oom_evictions += n

    # ---- multi-tenant accounting (the AdapterPool mirrors its events) ----
    def record_adapter_acquire(self, hit):
        """An adapter acquire resolved: hit = the adapter's bank row was
        already hot (the adapter cache), miss = a load had to run."""
        with self._lock:
            self._tenancy = True
            if hit:
                self.adapter_hits += 1
            else:
                self.adapter_misses += 1

    def record_adapter_load(self):
        with self._lock:
            self._tenancy = True
            self.adapter_loads += 1

    def record_adapter_eviction(self):
        with self._lock:
            self._tenancy = True
            self.adapter_evictions += 1

    def record_adapter_wait(self):
        """Admission deferred: every adapter row is pinned by live
        slots."""
        with self._lock:
            self._tenancy = True
            self.adapter_waits += 1

    def set_memory_provider(self, provider, budget_bytes=None,
                            watermark_frac=None):
        """Register the engine's ledger: `provider()` returns
        {weights_bytes, pool_bytes, adapter_bytes, in_use_bytes} (or
        None); `snapshot()` calls it outside the metrics lock.
        `budget_bytes` arms the watermark at `watermark_frac` of it."""
        with self._lock:
            self._memory_provider = provider
            if budget_bytes is not None:
                self.budget_bytes = int(budget_bytes)
            if watermark_frac is not None:
                self.watermark_frac = float(watermark_frac)

    def record_spec_step(self, n_active, proposed, accepted, draft_s,
                         verify_s, k_eff=None, variant=None, k_shrinks=None,
                         k_grows=None):
        """One speculative iteration: `proposed` draft tokens went into
        the verify step for the spec-enabled active slots and `accepted`
        of them matched; `draft_s` / `verify_s` are the two dispatch wall
        times; `k_eff` the adaptive draft depth after this round, with
        the stepper's cumulative shrink / grow counts; `variant` the pool
        (dense / paged) keying the per-variant step-ms split."""
        with self._lock:
            self._spec_recorded = True
            self.spec_rounds += 1
            self.drafts_proposed += int(proposed)
            self.drafts_accepted += int(accepted)
            if n_active:
                self.accepted_per_step.add(accepted / n_active)
            self.draft_step_s.add(draft_s)
            self.verify_step_s.add(verify_s)
            if k_eff is not None:
                self.spec_k_eff = int(k_eff)
            if k_shrinks is not None:
                self.spec_k_shrinks = int(k_shrinks)
            if k_grows is not None:
                self.spec_k_grows = int(k_grows)
            if variant is not None:
                v = self._spec_by_variant.setdefault(
                    variant, {"draft": _Reservoir(256),
                              "verify": _Reservoir(256)})
                v["draft"].add(draft_s)
                v["verify"].add(verify_s)

    def snapshot(self):
        # the ledger walks engine state: read it OUTSIDE the metrics lock
        provider = self._memory_provider
        ledger = provider() if provider is not None else None
        with self._lock:
            tps = (self.decode_tokens / self.decode_time_s
                   if self.decode_time_s > 0 else 0.0)
            wasted_drafts = self.drafts_proposed - self.drafts_accepted
            good_denom = (self.useful_tokens + self.wasted_tokens +
                          self.retry_tokens + wasted_drafts)
            return {
                "requests": {"submitted": self.submitted,
                             "rejected": self.rejected,
                             "completed": self.completed,
                             "cancelled": self.cancelled,
                             "timeouts": self.timeouts,
                             "failed": self.failed,
                             "aborted": self.aborted},
                "errors": self.errors,
                "last_error": self.last_error,
                "retries": self.retries,
                "fallbacks": self.fallbacks,
                "joins": self.joins,
                "iterations": self.iterations,
                "tokens_out": self.tokens_out,
                "decode_tokens": self.decode_tokens,
                "decode_tokens_per_s": tps,
                "ttft_ms": self.ttft_s.summary(1e3),
                "token_latency_ms": self.token_latency_s.summary(1e3),
                "step_gap_ms": self.step_gap_s.summary(1e3),
                "queue_depth": self.queue_depth.summary(),
                "occupancy": self.occupancy.summary(),
                "goodput": {
                    "useful_tokens": self.useful_tokens,
                    "wasted_tokens": self.wasted_tokens,
                    "retry_tokens": self.retry_tokens,
                    "ratio": round(self.useful_tokens / good_denom, 4)
                    if good_denom else 1.0},
                **self._sections(ledger),
            }

    def record_step_utilization(self, flops, bytes_accessed, dt_s, spec,
                                source):
        """One decode step's roofline position: the step program's flops
        and bytes against the DeviceSpec peaks. Armed only (the engine
        guards on the costs session)."""
        with self._lock:
            self._mfu = True
            self._spec = spec
            self.cost_source = source
            self.flops_per_step = float(flops)
            self.bytes_per_step = float(bytes_accessed)
            if dt_s > 0:
                self.mfu_util.add(flops / dt_s / spec.peak_flops)
                self.bw_util.add(bytes_accessed / dt_s /
                                 spec.peak_bytes_per_s)

    def record_cold_start(self, report):
        """The engine's precompile() report: {time_to_ready_s, programs,
        loaded_from_cache, compiled, cache_errors, warm}. A second call
        (another precompile on the same engine) adds its program counts
        and keeps the first ready time."""
        with self._lock:
            if self._cold_start is None:
                self._cold_start = dict(report)
            else:
                c = self._cold_start
                for k in ("programs", "loaded_from_cache", "compiled",
                          "cache_errors"):
                    c[k] = c.get(k, 0) + int(report.get(k, 0))
                c["warm"] = int(bool(c.get("warm"))
                                and bool(report.get("warm")))

    def _sections(self, ledger):
        """The paging / prefix / speculation / tenancy / memory sections
        recorded so far (called under the lock)."""
        out = {}
        if ledger is not None:
            w, p = int(ledger["weights_bytes"]), int(ledger["pool_bytes"])
            a = int(ledger["adapter_bytes"])
            out["memory"] = {"weights_bytes": w, "pool_bytes": p,
                             "adapter_bytes": a, "total_bytes": w + p + a,
                             "in_use_bytes": int(ledger["in_use_bytes"]),
                             "budget_bytes": self.budget_bytes,
                             "watermark_warnings": self.watermark_warnings,
                             "compile_temp_peak_bytes": int(ledger.get(
                                 "compile_temp_peak_bytes", 0))}
        if self._mfu:
            out["mfu"] = {"device": self._spec.as_dict(),
                          "cost_source": self.cost_source,
                          "flops_per_step": self.flops_per_step,
                          "bytes_per_step": self.bytes_per_step,
                          "model_flops_util": self.mfu_util.summary(),
                          "bandwidth_util": self.bw_util.summary()}
        if self._sharded:
            out["sharding"] = {
                "prefill_step_ms": self.prefill_step_s.summary(1e3),
                "decode_step_ms": self.token_latency_s.summary(1e3),
                "step_gap_ms": self.step_gap_s.summary(1e3),
                "per_shard_occupancy": self.shard_occupancy,
                "collective_ms": round(self.collective_s * 1e3, 3),
                "collective_events": self.collective_events,
                "collective_time_share": round(
                    self.collective_s / max(
                        1e-9, self.collective_s + self.decode_time_s
                        + sum(self.prefill_step_s._buf)), 4)}
        if self._tenancy:
            out["tenancy"] = {
                "tenants": len(self.tokens_by_tenant),
                "active_slots_by_tenant": dict(self.tenant_slots or {}),
                "tokens_by_tenant": dict(self.tokens_by_tenant),
                "adapter_loads": self.adapter_loads,
                "adapter_evictions": self.adapter_evictions,
                "adapter_hit_rate": round(
                    self.adapter_hits /
                    max(1, self.adapter_hits + self.adapter_misses), 4),
                "adapter_waits": self.adapter_waits,
                "fairness": _jain(self.tokens_by_tenant)}
        if self.pages_in_use is not None:
            out["paging"] = {
                "pages_in_use": self.pages_in_use,
                "pages_free": self.pages_free,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": round(
                    self.prefix_hits /
                    max(1, self.prefix_hits + self.prefix_misses), 3),
                "page_waits": self.page_waits,
                "oom_evictions": self.oom_evictions,
                "bytes_per_active_token": self.bytes_per_token.summary()}
        if self._prefix_recorded:
            out["prefix"] = {
                "whole_hits": self.prefix_whole_hits,
                "partial_hits": self.prefix_partial_hits,
                "misses": self.prefix_misses,
                "hit_token_ratio": round(
                    self.prefix_matched_tokens /
                    max(1, self.prefix_prompt_tokens), 4),
                "cow_copies": self.cow_copies,
                "trie_nodes": self.trie_nodes or 0,
                "trie_pages": self.trie_pages or 0}
        if self._slo:
            out["slo"] = {
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "replay_tokens": self.replay_tokens,
                "chunked_prefills": self.chunked_prefills,
                "chunks": self.chunks,
                "ttft_attainment": {
                    n: round(c["ttft_ok"] / max(1, c["n"]), 4)
                    for n, c in self.slo_finishes.items()},
                "tpot_attainment": {
                    n: round(c["tpot_ok"] / max(1, c["n"]), 4)
                    for n, c in self.slo_finishes.items()},
                "wfq_lag_by_tenant": dict(self.wfq_lag)}
        if self._cold_start is not None:
            c = self._cold_start
            out["cold_start"] = {
                "time_to_ready_s": c.get("time_to_ready_s", 0.0),
                "programs": c.get("programs", 0),
                "loaded_from_cache": c.get("loaded_from_cache", 0),
                "compiled": c.get("compiled", 0),
                "cache_errors": c.get("cache_errors", 0),
                "warm": int(bool(c.get("warm"))),
                "first_ttft_ms": None if self.first_ttft_s is None else
                round(self.first_ttft_s * 1e3, 3)}
        if self._spec_recorded:
            out["speculation"] = {
                "rounds": self.spec_rounds,
                "drafts_proposed": self.drafts_proposed,
                "drafts_accepted": self.drafts_accepted,
                "acceptance_rate": round(
                    self.drafts_accepted / max(1, self.drafts_proposed), 4),
                "accepted_per_step": self.accepted_per_step.summary(),
                "draft_step_ms": self.draft_step_s.summary(1e3),
                "verify_step_ms": self.verify_step_s.summary(1e3),
                "wasted_draft_tokens":
                    self.drafts_proposed - self.drafts_accepted,
                "effective_k": self.spec_k_eff,
                "k_shrink_events": self.spec_k_shrinks,
                "k_grow_events": self.spec_k_grows,
                "step_ms_by_variant": {
                    v: {"draft_p50": r["draft"].p50(1e3),
                        "verify_p50": r["verify"].p50(1e3)}
                    for v, r in self._spec_by_variant.items()}}
        return out
