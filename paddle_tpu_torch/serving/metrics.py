"""Serving metrics: requests, tokens, TTFT and slot occupancy; the
"paging" section (page occupancy, waits, out-of-pages evictions) once a
paged pool records, the "prefix" section (radix prefix-cache hits,
copy-on-write copies, trie size) once a paged join consults the trie,
the "speculation" section (draft acceptance, adaptive k, draft and
verify step latency) once a speculative step runs, the "tenancy"
section (tokens and slots by tenant, adapter loads, evictions, hit rate,
waits, fairness) once an engine with an AdapterPool records, and the
"memory" section (weights, pool and adapter-bank bytes) once an engine
registers its ledger. The section and key names are the JAX package's
(`serving/metrics.py`). Thread-safe; `snapshot()` may be called from any
thread at any time."""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["ServingMetrics"]


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
        self._init_counters()

    def _init_counters(self):
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

    def reset(self):
        """Start a fresh measurement epoch."""
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

    def record_finish(self, reason):
        with self._lock:
            if reason in ("eos", "length", "drain"):
                self.completed += 1
            elif reason == "cancelled":
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

    def record_iteration(self, queue_depth, occupancy, pages_in_use=None,
                         pages_free=None, bytes_per_active_token=None,
                         trie_nodes=None, trie_pages=None,
                         tenant_slots=None):
        with self._lock:
            self.iterations += 1
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

    def set_memory_provider(self, provider):
        """Register the engine's ledger: `provider()` returns
        {weights_bytes, pool_bytes, adapter_bytes, in_use_bytes};
        `snapshot()` calls it outside the metrics lock."""
        with self._lock:
            self._memory_provider = provider

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
                "joins": self.joins,
                "iterations": self.iterations,
                "tokens_out": self.tokens_out,
                "decode_tokens": self.decode_tokens,
                "decode_tokens_per_s": tps,
                "ttft_ms": self.ttft_s.summary(1e3),
                "token_latency_ms": self.token_latency_s.summary(1e3),
                "queue_depth": self.queue_depth.summary(),
                "occupancy": self.occupancy.summary(),
                **self._sections(ledger),
            }

    def _sections(self, ledger):
        """The paging / prefix / speculation / tenancy / memory sections
        recorded so far (called under the lock)."""
        out = {}
        if ledger is not None:
            w, p = int(ledger["weights_bytes"]), int(ledger["pool_bytes"])
            a = int(ledger["adapter_bytes"])
            out["memory"] = {"weights_bytes": w, "pool_bytes": p,
                             "adapter_bytes": a, "total_bytes": w + p + a,
                             "in_use_bytes": int(ledger["in_use_bytes"])}
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
