"""Span-based host tracer: per-request timelines for the serving stack.

`ServingMetrics.snapshot()` gives aggregates; this module adds the
per-request dimension. A `Tracer` records nested spans (name, category,
trace id, monotonic start and end, attributes) into a thread-safe
bounded ring and exports them as Chrome-trace / Perfetto JSON that loads
next to the `torch.profiler` device trace (`profiler.start_profiler`).

Discipline: the hot paths pay ONE module-global read per hit when
nothing is armed. Production code guards every tracing call site with
``if trace._SESSION is not None:``: no function call, no allocation,
when disabled.

Three cooperating pieces:

  * **Tracer / sessions**: `start_session()` installs the module-wide
    tracer every instrumented call site reports into; `session_scope()`
    is the context-manager form. `Tracer.export_chrome_trace(path)`
    writes the Perfetto-loadable file.
  * **Compile observer**: the engines' program caches (`_compiled`,
    keyed identically to their `trace_counts` counters) are `JitCache`
    instances. The port has no tracing compiler, so its counterpart of
    a compile is the FIRST run of a program shape: each cached program
    bumps its `trace_counts` key once, on its first call, and that
    first run is where the kernels are built (`ops/_build.py`), the
    libraries pick their plans and the caching allocator grows. An
    observed call that bumps its key is recorded as a ``compile`` span
    with its wall duration and cache key, so the keys, and the soak's
    key set, are the JAX engines'.
  * **Retrace sentinel**: `retrace_sentinel(*engines)` turns the "never
    retraces" claims into a standing assertion: any key counting more
    than its declared budget (default: once) raises `RetraceError` (or
    records it, with ``mode="log"``). `ObservedCounter` (the
    `trace_counts` type) is what makes the sentinel see every count as
    it happens.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import threading
import time

__all__ = [
    "Span", "Tracer", "start_session", "end_session", "session",
    "session_scope", "ObservedCounter", "JitCache", "RetraceError",
    "RetraceSentinel", "retrace_sentinel", "add_compile_hook",
    "remove_compile_hook", "suppress_observation", "record_precompile",
]

_LOG = logging.getLogger("paddle_tpu_torch.trace")

_LOCK = threading.RLock()
#: the ONE global every instrumented hot path reads; None = disabled
_SESSION = None
#: True while a session OR a sentinel OR a compile hook (the cost
#: accounting layer, profiler.costs) is armed — gates the compile
#: observer and counter notifications (trace-time only, never hot)
_WATCH = False
_GLOBAL_SENTINELS = []
_SENTINEL_COUNT = 0
#: observers of every detected first run ("compile"): fn(owner, key,
#: raw_fn, args, kw, t0, t1). profiler.costs registers one while an
#: accounting session is armed: program costs attach to the SAME cache
#: keys the retrace sentinel and compile spans use.
_COMPILE_HOOKS = []
#: armed while a caller re-counts a program on purpose (a deliberate
#: second count must not look like a retrace)
_SUPPRESS = False


def _recompute_watch():
    global _WATCH
    _WATCH = (_SESSION is not None or _SENTINEL_COUNT > 0
              or len(_COMPILE_HOOKS) > 0)


def add_compile_hook(hook):
    """Register a compile observer: called as fn(owner, key, raw_fn,
    args, kw, t0, t1) after every detected first run while armed. Arms
    the program-cache observation (same switch as sessions and
    sentinels)."""
    with _LOCK:
        _COMPILE_HOOKS.append(hook)
        _recompute_watch()


def remove_compile_hook(hook):
    with _LOCK:
        if hook in _COMPILE_HOOKS:
            _COMPILE_HOOKS.remove(hook)
        _recompute_watch()


@contextlib.contextmanager
def suppress_observation():
    """Silence ObservedCounter notifications (sentinels, session trace
    counts) for the duration: a deliberate second count of a program
    that already ran must not fire the retrace sentinel or skew session
    counters."""
    global _SUPPRESS
    with _LOCK:
        prev, _SUPPRESS = _SUPPRESS, True
    try:
        yield
    finally:
        with _LOCK:
            _SUPPRESS = prev


def _key_str(key):
    s = str(key)
    return s if len(s) <= 120 else s[:117] + "..."


class Span:
    """One timed event. `t1 is None` while still open; times are
    `time.perf_counter()` seconds (monotonic, host-side)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "attrs")

    def __init__(self, name, cat, trace_id, span_id, parent_id, t0,
                 attrs):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs

    @property
    def duration_s(self):
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"dur={self.duration_s})")


class Tracer:
    """Thread-safe span sink with a bounded ring buffer (the oldest
    finished spans are overwritten past `capacity` — `dropped` counts
    them) plus a plain counter surface for scalar telemetry."""

    def __init__(self, capacity=65536, clock=time.perf_counter,
                 sample=None):
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=self.capacity)
        self._open = {}                 # span_id -> Span (not ended)
        self._ids = itertools.count(1)
        self.counters = collections.Counter()
        self.dropped = 0
        self.t_origin = clock()
        # request sampling: None = trace everything; a float in (0, 1]
        # traces ~that fraction of requests (deterministic in the
        # request id), bounding a multi-hour always-on session by
        # sampling rather than just ring capacity. An unsampled request
        # costs one branch at submit and nothing afterwards.
        if sample is not None:
            sample = float(sample)
            if not 0.0 < sample <= 1.0:
                raise ValueError(
                    f"sample must be in (0, 1], got {sample}")
        self.sample = sample

    def should_sample(self, trace_id):
        """Deterministic per-request sampling decision (Knuth
        multiplicative hash of the trace id vs the sample fraction), so
        a given request id samples identically across runs/processes."""
        if self.sample is None:
            return True
        h = (int(trace_id) * 2654435761) & 0xFFFFFFFF
        return h < self.sample * 4294967296.0

    # ---- recording ----
    def now(self):
        return self._clock()

    def begin(self, name, *, cat="span", trace_id=0, parent=None,
              attrs=None):
        sp = Span(name, cat, int(trace_id), next(self._ids),
                  None if parent is None else parent.span_id,
                  self._clock(), dict(attrs) if attrs else {})
        with self._lock:
            self._open[sp.span_id] = sp
        return sp

    def end(self, span, **attrs):
        if span is None or span.t1 is not None:
            return span
        span.t1 = self._clock()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._open.pop(span.span_id, None)
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)
        return span

    def add_complete(self, name, t0, t1, *, cat="span", trace_id=0,
                     parent=None, attrs=None):
        sp = Span(name, cat, int(trace_id), next(self._ids),
                  None if parent is None else parent.span_id,
                  t0, dict(attrs) if attrs else {})
        sp.t1 = t1
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(sp)
        return sp

    def instant(self, name, *, cat="span", trace_id=0, parent=None,
                attrs=None):
        t = self._clock()
        return self.add_complete(name, t, t, cat=cat, trace_id=trace_id,
                                 parent=parent, attrs=attrs)

    @contextlib.contextmanager
    def span(self, name, **kw):
        sp = self.begin(name, **kw)
        try:
            yield sp
        finally:
            self.end(sp)

    def count(self, name, n=1):
        with self._lock:
            self.counters[name] += n

    # ---- reading ----
    def spans(self, include_open=False):
        with self._lock:
            out = list(self._spans)
            if include_open:
                out.extend(self._open.values())
        return out

    def open_spans(self):
        with self._lock:
            return list(self._open.values())

    # ---- export ----
    def chrome_trace_events(self, include_open=True):
        """The Chrome Trace Event Format list (Perfetto/chrome://tracing
        loadable): one complete ("ph": "X") event per span on pid 1,
        tid = trace_id + 1 for request tracks (tid 0 is the engine
        track), timestamps in microseconds from the tracer origin."""
        evs = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "paddle_tpu.serving"}},
               {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "engine"}}]
        named = set()
        now = self._clock()
        for sp in self.spans(include_open=include_open):
            tid = 0 if sp.trace_id == 0 else int(sp.trace_id) + 1
            if tid and tid not in named:
                named.add(tid)
                evs.append({"name": "thread_name", "ph": "M", "pid": 1,
                            "tid": tid,
                            "args": {"name": f"req {sp.trace_id}"}})
            t1 = sp.t1 if sp.t1 is not None else now
            args = {k: v for k, v in sp.attrs.items()}
            args["trace_id"] = sp.trace_id
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            if sp.t1 is None:
                args["open"] = True
            evs.append({
                "name": sp.name, "cat": sp.cat, "ph": "X",
                "ts": round((sp.t0 - self.t_origin) * 1e6, 3),
                "dur": round((t1 - sp.t0) * 1e6, 3),
                "pid": 1, "tid": tid, "args": args})
        for name, v in sorted(self.counters.items()):
            evs.append({"name": _key_str(name), "ph": "C", "pid": 1,
                        "ts": round((now - self.t_origin) * 1e6, 3),
                        "args": {"value": v}})
        return evs

    def export_chrome_trace(self, path, include_open=True):
        """Write the trace as Chrome-trace JSON; load it in Perfetto
        (ui.perfetto.dev) or chrome://tracing, next to the XPlane dump
        `profiler.start_profiler` produces."""
        payload = {"traceEvents":
                   self.chrome_trace_events(include_open=include_open),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


# ----------------------------------------------------------------------
# session management
# ----------------------------------------------------------------------

def start_session(capacity=65536, tracer=None, sample=None):
    """Install the module-wide tracer session every instrumented call
    site reports into. Raises if a session is already active.
    `sample` (float in (0, 1], e.g. 1/16) traces only that fraction of
    requests — the always-on mode for multi-hour sessions."""
    global _SESSION
    with _LOCK:
        if _SESSION is not None:
            raise RuntimeError("a tracer session is already active; "
                               "end_session() it first")
        _SESSION = tracer if tracer is not None else \
            Tracer(capacity, sample=sample)
        _recompute_watch()
        return _SESSION


def end_session():
    """Tear down the active session; returns the Tracer (export it
    afterwards) or None when no session was active."""
    global _SESSION
    with _LOCK:
        tr = _SESSION
        _SESSION = None
        _recompute_watch()
        return tr


def session():
    """The active Tracer, or None. Hot paths read the module global
    `_SESSION` directly instead (one attribute load, no call)."""
    return _SESSION


@contextlib.contextmanager
def session_scope(capacity=65536, sample=None):
    tr = start_session(capacity, sample=sample)
    try:
        yield tr
    finally:
        end_session()


# ----------------------------------------------------------------------
# compile observation: trace_counts + jit caches
# ----------------------------------------------------------------------

class ObservedCounter(collections.Counter):
    """`trace_counts` Counter whose increments (one per program shape:
    the engines bump a key on the first run of its program) notify the
    active retrace sentinel / tracer. Disarmed cost is one module-global
    boolean read, and only on a first run (never on warm calls)."""

    def __init__(self, *args, owner=None, **kw):
        super().__init__(*args, **kw)
        self.owner = owner
        self._sentinels = []

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if _WATCH and not _SUPPRESS:
            _on_trace(self, key, value)


def _on_trace(counter, key, value):
    tr = _SESSION
    if tr is not None:
        tr.count("traces")
    for s in tuple(counter._sentinels) + tuple(_GLOBAL_SENTINELS):
        s._observe(counter, key, value)


class _CacheEntry:
    __slots__ = ("raw", "observed")

    def __init__(self, raw, observed):
        self.raw = raw
        self.observed = observed


class JitCache(dict):
    """The engines' `_compiled` dict. Lookups return the RAW program
    while nothing is armed (the disabled hot path has zero tracing
    frames and zero allocations) and an observing wrapper while a
    session / sentinel is active: a call that counts as a compile
    (detected by its trace_counts key bumping; cache keys and count keys
    coincide by construction) is recorded as a ``compile`` span with its
    wall duration."""

    def __init__(self, owner):
        super().__init__()
        self._owner = owner

    def __setitem__(self, key, fn):
        super().__setitem__(key, _CacheEntry(
            fn, _observed_compiled(self._owner, key, fn)))

    def __getitem__(self, key):
        e = dict.__getitem__(self, key)
        return e.observed if _WATCH else e.raw

    def get(self, key, default=None):
        e = dict.get(self, key)
        if e is None:
            return default
        return e.observed if _WATCH else e.raw


def record_precompile(owner, key, t0, t1, source):
    """Startup-precompile observability: one ``precompile`` span per
    program the engine readied before serving (cat "compile", on the
    track of the warm path's compiles), with `source` = "cache" (its
    record and libraries came from the AOT cache: no build, no first run)
    or "compile" (readied by a first run at startup). The warm-start
    proof reads the session's counters: a warm start shows only
    ``precompile_cache_hits``, and the ``compiles`` counter stays 0
    through the first token."""
    tr = _SESSION
    if tr is None:
        return
    tr.add_complete("precompile", t0, t1, cat="compile",
                    attrs={"engine": type(owner).__name__,
                           "key": _key_str(key), "source": source})
    tr.count("precompiles")
    if source == "cache":
        tr.count("precompile_cache_hits")


def _observed_compiled(owner, key, fn):
    def call(*args, **kw):
        tc = owner.trace_counts
        n0 = tc[key]
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        n1 = tc[key]
        if n1 != n0:
            t1 = time.perf_counter()
            tr = _SESSION
            if tr is not None:
                tr.add_complete(
                    "compile", t0, t1, cat="compile",
                    attrs={"engine": type(owner).__name__,
                           "key": _key_str(key), "count": n1})
                tr.count("compiles")
            for h in tuple(_COMPILE_HOOKS):
                try:
                    h(owner, key, fn, args, kw, t0, t1)
                except Exception:
                    _LOG.exception("compile hook %r failed", h)
        return out
    return call


# ----------------------------------------------------------------------
# retrace sentinel
# ----------------------------------------------------------------------

class RetraceError(RuntimeError):
    """A program-cache key counted more often than its declared budget:
    a retrace regression (joins, page maps and steps count once per key,
    ever)."""


class RetraceSentinel:
    """Standing "never retraces" assertion over one or more engines
    (anything with an `ObservedCounter` trace_counts — the serving
    engines and `DecodeEngine`), or globally with no engines given.

        with trace.retrace_sentinel(eng):      # budget 1 per key
            ... serve ...                      # any retrace raises

    `budget` is the allowed number of traces per exact cache key;
    `budgets` overrides per key *kind* (the tuple's leading element:
    "step", "join", "pjoin", "pstep", "attach", "cow", "prefill",
    "splice", ...). ``mode="log"`` records `violations` (and warns)
    instead of raising; `assert_ok()` turns them into a RetraceError.
    """

    def __init__(self, *engines, budget=1, budgets=None, mode="raise"):
        if mode not in ("raise", "log"):
            raise ValueError(f"mode must be 'raise' or 'log', got "
                             f"{mode!r}")
        self.engines = engines
        self.budget = int(budget)
        self.budgets = dict(budgets or {})
        self.mode = mode
        self.violations = []
        self._attached = []

    def budget_for(self, key):
        kind = key[0] if isinstance(key, tuple) and key else key
        return int(self.budgets.get(kind, self.budget))

    def _observe(self, counter, key, value):
        b = self.budget_for(key)
        if value <= b:
            return
        v = {"engine": getattr(counter, "owner", None) or
             "<unknown>", "key": key, "count": value, "budget": b}
        self.violations.append(v)
        tr = _SESSION
        if tr is not None:
            tr.instant("retrace", cat="compile",
                       attrs={"key": _key_str(key), "count": value,
                              "budget": b})
        msg = (f"retrace sentinel: key {key!r} on {v['engine']} "
               f"traced {value} times (budget {b})")
        if self.mode == "raise":
            raise RetraceError(msg)
        _LOG.warning(msg)

    def assert_ok(self):
        if self.violations:
            raise RetraceError(
                f"{len(self.violations)} retrace violation(s): "
                f"{self.violations}")

    # ---- arming ----
    def __enter__(self):
        global _SENTINEL_COUNT
        with _LOCK:
            if self.engines:
                for e in self.engines:
                    c = e.trace_counts
                    if not isinstance(c, ObservedCounter):
                        # engines built before this module: upgrade the
                        # counter in place (contents preserved)
                        c = ObservedCounter(c, owner=type(e).__name__)
                        e.trace_counts = c
                    c._sentinels.append(self)
                    self._attached.append(c)
            else:
                _GLOBAL_SENTINELS.append(self)
            _SENTINEL_COUNT += 1
            _recompute_watch()
        return self

    def __exit__(self, *exc):
        global _SENTINEL_COUNT
        with _LOCK:
            for c in self._attached:
                if self in c._sentinels:
                    c._sentinels.remove(self)
            self._attached = []
            if self in _GLOBAL_SENTINELS:
                _GLOBAL_SENTINELS.remove(self)
            _SENTINEL_COUNT -= 1
            _recompute_watch()
        return False


def retrace_sentinel(*engines, budget=1, budgets=None, mode="raise"):
    """Arm a `RetraceSentinel` (context manager) over the given
    engines, or over every engine when none are given."""
    return RetraceSentinel(*engines, budget=budget, budgets=budgets,
                           mode=mode)


def reset():
    """Drop the active session, every armed sentinel and compile hook,
    disarm the watch flag. Test teardowns call this (conftest autouse)
    so a failing test never leaks an armed tracer into the next."""
    global _SESSION, _SENTINEL_COUNT, _SUPPRESS
    with _LOCK:
        _SESSION = None
        _GLOBAL_SENTINELS.clear()
        _COMPILE_HOOKS.clear()
        _SENTINEL_COUNT = 0
        _SUPPRESS = False
        _recompute_watch()
