"""Serving metrics the dense path records: requests, tokens, TTFT and
slot occupancy. Thread-safe; `snapshot()` may be called from any
thread at any time."""
from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["ServingMetrics"]


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


class ServingMetrics:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
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

    def record_token(self):
        with self._lock:
            self.tokens_out += 1

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

    def record_iteration(self, queue_depth, occupancy):
        with self._lock:
            self.iterations += 1
            self.queue_depth.add(queue_depth)
            self.occupancy.add(occupancy)

    def snapshot(self):
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
            }
