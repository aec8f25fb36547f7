"""Thread-based serving frontend: submit(prompt) -> request with a future.

The engine is single-threaded by design; the server runs it in an
always-on loop thread and exposes a thread-safe `submit` to any number
of caller threads. Device work happens on the loop thread, on that
thread's current CUDA stream. `shutdown(drain=True)` lets everything
accepted run to completion; `drain=False` ends in-flight work at the
next iteration boundary with finish_reason "shutdown".
"""
from __future__ import annotations

import threading

from .scheduler import Request, Scheduler

__all__ = ["ServingServer", "ServerCrashed"]


class ServerCrashed(RuntimeError):
    """The serving loop died (or refused to stop in time). Every
    outstanding future has been failed with this as the cause; further
    `submit()` calls raise it immediately."""


class ServingServer:
    """Always-on generation frontend over a serving engine.

        server = ServingServer(engine)
        req = server.submit(prompt, memory=mem, max_new_tokens=32)
        result = req.result()          # RequestResult(tokens, ...)
        server.shutdown(drain=True)

    `submit` raises `QueueFull` past the queue's high-water mark and
    ValueError for requests the pool can never serve. `scheduler=` takes
    a caller-built scheduler (a `ShapingScheduler` with SLO classes and
    tenant weights); the default is the FIFO `Scheduler`."""

    def __init__(self, engine, *, max_queue=64, clock=None,
                 idle_wait_s=0.005, start=True, scheduler=None):
        self.engine = engine
        self.clock = clock if clock is not None else engine.clock
        self.scheduler = scheduler if scheduler is not None else \
            Scheduler(max_queue=max_queue, clock=self.clock)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._dead = False
        self._crash_cause = None
        self._idle_wait_s = float(idle_wait_s)
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-tpu-torch-serving",
                                        daemon=True)
        self._started = False
        if start:
            self.start()

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, prompt, memory=None, *, max_new_tokens=32, eos_id=1,
               deadline=None, timeout=None, stream_cb=None, spec=True,
               adapter=None, slo=None):
        """Enqueue one generation request; returns the `Request` whose
        `.result()` blocks for a RequestResult. `timeout` (seconds from
        now) is sugar for an absolute `deadline` on the engine clock.
        `spec=False` opts out of speculative drafts. `adapter` names the
        registered tenant adapter to decode under (None: the base model);
        an unknown name raises ValueError here. `slo` is the traffic
        class (an `SLOClass` or a name the scheduler resolves; an unknown
        name raises ValueError from a `ShapingScheduler`)."""
        if self._dead:
            raise ServerCrashed(f"server is dead ({self._crash_cause!r}); "
                                f"restart it")
        if timeout is not None:
            deadline = self.clock() + float(timeout)
        r = Request(prompt, memory, max_new_tokens=max_new_tokens,
                    eos_id=eos_id, deadline=deadline, stream_cb=stream_cb,
                    spec=spec, adapter=adapter, slo=slo)
        self.engine.admit_check(r)   # fail fast, before queueing
        try:
            self.scheduler.submit(r)
        except Exception:
            self.engine.metrics.record_reject()
            raise
        self.engine.metrics.record_submit()
        self._wake.set()
        return r

    def _idle(self):
        return self.scheduler.depth() == 0 and self.engine.occupancy() == 0

    def _loop(self):
        try:
            while not self._stop.is_set():
                progress = self.engine.run_iteration(self.scheduler)
                if self.scheduler.draining and self._idle():
                    break   # graceful drain complete
                if not progress:
                    self._wake.wait(self._idle_wait_s)
                    self._wake.clear()
        except BaseException as e:
            # the engine isolates per-request failures; anything that
            # still escapes is a loop-level crash: fail every future
            # rather than hang their callers
            self._declare_dead(e)

    def _declare_dead(self, cause):
        self._dead = True
        self._crash_cause = cause
        self._stop.set()
        self.scheduler.drain()
        self.engine.metrics.record_error("server_crash", cause)
        exc = ServerCrashed(f"serving loop crashed: {cause!r}")
        exc.__cause__ = cause
        now = self.clock()
        doomed = self.scheduler.pop_all() + \
            [r for r in self.engine.slots if r is not None]
        for r in doomed:
            r.fail(exc, now)
            self.engine.metrics.record_finish("error", len(r.tokens))

    def shutdown(self, drain=True, timeout=None):
        """drain=True: close admission, run accepted work to completion,
        then stop. drain=False: stop at the next iteration boundary and
        finalize queued and in-flight requests with "shutdown"."""
        if not self._started or self._dead:
            return
        if drain:
            self.scheduler.drain()
        else:
            self._stop.set()
        self._wake.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            self._declare_dead(TimeoutError(
                f"serving loop did not stop within {timeout}s"))
            raise TimeoutError("serving loop did not stop in time; server "
                               "marked dead, outstanding futures failed")
        if not drain:
            now = self.clock()
            self.scheduler.drain()
            for r in self.scheduler.abort_queued("shutdown", now):
                self.engine.metrics.record_finish(r.finish_reason,
                                                  len(r.tokens))
            self.engine.abort_active("shutdown", now)
        self._started = False
