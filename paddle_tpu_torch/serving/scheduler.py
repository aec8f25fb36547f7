"""Admission control for the continuous-batching serving runtime.

A bounded FIFO between callers and the engine, with the serving-side
policies the engine should not know about: backpressure (`submit`
raises `QueueFull` past the high-water mark), deadline eviction,
cancellation and graceful drain. The scheduler never touches device
state; all methods are thread-safe. `Request.future` is a
`concurrent.futures.Future` resolving to a `RequestResult` (partial
tokens included for timeout / cancel).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from ..profiler import trace as _trace
from ..testing import faults
from . import tracing as _rt

__all__ = ["QueueFull", "Request", "RequestResult", "Scheduler",
           "FINISH_REASONS"]

#: fault point of admission: an injected raise is a submit that was lost
#: before queueing (the caller sees it; the server counts a reject)
_PT_ADMIT = faults.point("scheduler.admit")

#: terminal finish reasons
FINISH_REASONS = ("eos", "length", "cancelled", "timeout", "drain",
                  "shutdown", "error")


class QueueFull(RuntimeError):
    """Backpressure: the bounded request queue is at its high-water
    mark. Shed load or retry later."""


class RequestResult(collections.namedtuple(
        "RequestResult", ["tokens", "finish_reason", "ttft_s", "latency_s",
                          "error"])):
    """What a request's future resolves to: the generated int32 tokens
    (possibly partial), one of FINISH_REASONS, the request's own
    time-to-first-token and end-to-end latency (None when it never
    produced a token), and the cause of an engine-side eviction."""
    __slots__ = ()

    def __new__(cls, tokens, finish_reason, ttft_s=None, latency_s=None,
                error=None):
        return super().__new__(cls, tokens, finish_reason, ttft_s,
                               latency_s, error)

    @property
    def ok(self):
        return self.finish_reason in ("eos", "length", "drain")


class Request:
    """One generation request: a 1-D prompt and a [M, D] cross-attention
    memory (a tensor on any device, or an array). `spec=False` opts the
    request out of speculative drafts on a spec engine (same tokens, one
    a round). `adapter` names the registered tenant adapter it decodes
    under (None: the base model). `slo` is its traffic class: an
    `SLOClass`, or a class name a `ShapingScheduler` resolves at submit
    (the FIFO `Scheduler` ignores it)."""

    _ids = itertools.count()

    def __init__(self, prompt, memory=None, *, max_new_tokens=32, eos_id=1,
                 deadline=None, stream_cb=None, spec=True, adapter=None,
                 slo=None):
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D [P], got {prompt.shape}")
        self.id = next(Request._ids)
        self.prompt = prompt
        self.memory = None if memory is None else torch.as_tensor(memory)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_id = eos_id
        self.deadline = deadline      # absolute engine-clock seconds
        self.stream_cb = stream_cb    # called (request, token) per token
        self.spec = bool(spec)
        self.adapter = adapter
        self.slo = slo
        # preemption (paged pools): the delivered tokens a resumed slot
        # re-decodes and absorbs silently, and the preemptions so far
        self._replay = 0
        self._preemptions = 0
        self.tokens = []
        self.state = "QUEUED"         # QUEUED -> RUNNING -> DONE
        self.finish_reason = None
        self.future = Future()
        self.slot = None
        self.submitted_at = None
        self.first_token_at = None
        self.finished_at = None
        self._cancelled = threading.Event()
        self._trace = None            # _ReqTrace under a tracer session

    def cancel(self):
        """Queued requests die on the next scheduler pop; in-flight ones
        leave their slot at the next iteration boundary with their
        partial tokens."""
        self._cancelled.set()

    @property
    def cancelled(self):
        return self._cancelled.is_set()

    def result(self, timeout=None):
        return self.future.result(timeout)

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline

    def finish(self, reason, now, error=None):
        if self.state == "DONE":      # idempotent: harvest races drain
            return
        self.state = "DONE"
        self.finish_reason = reason
        self.finished_at = now
        if self._trace is not None:
            _rt.on_finish(self, reason, error)
        ttft = (None if self.first_token_at is None or
                self.submitted_at is None
                else self.first_token_at - self.submitted_at)
        lat = None if self.submitted_at is None else now - self.submitted_at
        try:
            self.future.set_result(RequestResult(
                np.asarray(self.tokens, np.int32), reason, ttft, lat,
                error))
        except InvalidStateError:
            pass   # already failed by a server-crash declaration

    def fail(self, exc, now):
        """Fail this request's future with the cause (per-request
        isolation). Idempotent against a concurrent finish()."""
        if self.state == "DONE":
            return
        self.state = "DONE"
        self.finish_reason = "error"
        self.finished_at = now
        if self._trace is not None:
            _rt.on_finish(self, "error", exc)
        try:
            self.future.set_exception(exc)
        except InvalidStateError:
            pass


class Scheduler:
    """Bounded FIFO with deadline / cancel screening and drain."""

    def __init__(self, max_queue=64, clock=time.monotonic):
        self.max_queue = int(max_queue)
        self.clock = clock
        self._q = collections.deque()
        self._lock = threading.Lock()
        self._draining = False

    def submit(self, request):
        """Enqueue, or raise QueueFull past the high-water mark /
        RuntimeError after drain started. Sets `submitted_at`."""
        now = self.clock()
        _PT_ADMIT()
        with self._lock:
            if self._draining:
                raise RuntimeError("scheduler is draining: admission "
                                   "closed")
            if len(self._q) >= self.max_queue:
                raise QueueFull(f"request queue at high-water mark "
                                f"({self.max_queue}); shed load or retry")
            request.submitted_at = now
            self._q.append(request)
        if _trace._SESSION is not None:
            _rt.on_submit(request)
        return request

    def pop_ready(self, now=None, on_dead=None):
        """Next admissible request (FIFO), finalizing any queued request
        that was cancelled or missed its deadline on the way
        (`on_dead(request)` fires for each). None when empty."""
        if now is None:
            now = self.clock()
        while True:
            with self._lock:
                if not self._q:
                    return None
                r = self._q.popleft()
            if r.cancelled or r.expired(now):
                r.finish("cancelled" if r.cancelled else "timeout", now)
                if on_dead is not None:
                    on_dead(r)
                continue
            if r._trace is not None:
                _rt.on_queue_exit(r)
            return r

    def push_front(self, request):
        """Return an already-admitted request to the HEAD of the queue
        (FIFO order kept): the paged engine's page-headroom gate defers
        the queue head when free pages cannot cover its prompt and
        reservation, so out-of-pages backpressure keeps it queued
        instead of failing it. Bypasses the high-water mark and the
        drain check on purpose: the request was admitted once already."""
        if request._trace is not None:
            _rt.on_requeue(request)
        with self._lock:
            self._q.appendleft(request)

    def depth(self):
        with self._lock:
            return len(self._q)

    def drain(self):
        """Close admission; queued and running work keeps flowing."""
        with self._lock:
            self._draining = True

    @property
    def draining(self):
        return self._draining

    def pop_all(self):
        """Drain the queue raw (server-crash path): the requests come
        back unfinalized for the caller to fail."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
        return out

    def abort_queued(self, reason, now=None):
        """Finalize everything still queued (non-drain shutdown)."""
        if now is None:
            now = self.clock()
        out = []
        while True:
            with self._lock:
                if not self._q:
                    return out
                r = self._q.popleft()
            r.finish(reason if not r.cancelled else "cancelled", now)
            out.append(r)
