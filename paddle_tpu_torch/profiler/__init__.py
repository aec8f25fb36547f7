"""Profiler.

Reference parity: platform/profiler.h:126 RecordEvent RAII +
fluid/profiler.py (start_profiler / stop_profiler / profiler context).
Host annotations go to `torch.profiler.record_function`; device
timelines come from `torch.profiler.profile` (`start_profiler` starts one
whose Chrome trace loads in Perfetto beside the host spans).

`profiler.trace` is the span-based host tracer the serving stack reports
into (per-request timelines, compile observer, retrace sentinel);
`profiler.costs` the cost accounting. `start_profiler` / `stop_profiler`
start and stop a tracer session in lockstep with the torch profile, so
the host span dump (`<trace_dir>/host_trace.json`) loads in Perfetto
next to the device trace (`<trace_dir>/device_trace.json`).

The JAX package's native host recorder (`enable_host_trace`,
`export_chrome_tracing`) loads its C++ core library; the port has no
binding to that library yet, so those entry points raise.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

from . import costs, trace  # noqa: F401  (paddle_tpu_torch.profiler.*)

#: host RecordEvent ring: bounded so an always-on process can leave
#: profiling annotations in place without unbounded growth
_EVENTS_CAP = 65536
_events = collections.deque(maxlen=_EVENTS_CAP)
_trace_dir = None
_active = False
_own_tracer = False
_prof = None
last_host_trace = None
last_device_trace = None


def set_events_capacity(cap):
    """Resize the RecordEvent ring buffer (keeps the newest events)."""
    global _events, _EVENTS_CAP
    _EVENTS_CAP = int(cap)
    _events = collections.deque(_events, maxlen=_EVENTS_CAP)


def _annotation(name, span):
    """The record_function label: the event's name, and in a lockstep
    session its span identity, so the device trace's region names the
    host span it belongs to."""
    if span is None:
        return name
    return f"{name}#trace_id={span.trace_id},span_id={span.span_id}"


class RecordEvent:
    """platform/profiler.h:126 parity. Records (name, event_type,
    duration) host-side, opens a `torch.profiler.record_function` region
    of the name, and (when a
    `profiler.trace` session is active) surfaces the event as a span in
    the tracer.

    Span links: when the torch profile runs in lockstep with a tracer
    session (`start_profiler`), the span is opened at __enter__ so its
    (trace_id, span_id) identity EXISTS before the device work runs, and
    both ids are stamped into the record_function label
    (``name#trace_id=T,span_id=S``): the device trace's user annotation
    carries them, so a host span and its device region correlate by id.
    Pass `trace_id=` to link the event to a request's trace."""

    def __init__(self, name, event_type="op", trace_id=0):
        self.name = name
        self.event_type = event_type
        self.trace_id = int(trace_id)
        self._ann = None
        self._t0 = None
        self._span = None

    def __enter__(self):
        import torch

        tr = trace._SESSION
        if tr is not None:
            # open the span FIRST so its id can ride into the device trace
            self._span = tr.begin(self.name, cat="record_event",
                                  trace_id=self.trace_id,
                                  attrs={"event_type": self.event_type})
        self._ann = torch.profiler.record_function(
            _annotation(self.name, self._span if _active else None))
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _events.append((self.name, self.event_type, t1 - self._t0))
        tr = trace._SESSION
        if self._span is not None:
            if tr is not None:
                tr.end(self._span)
            self._span = None
        elif tr is not None:
            tr.add_complete(self.name, self._t0, t1, cat="record_event",
                            attrs={"event_type": self.event_type})
        self._ann.__exit__(*exc)
        return False


def _no_native(what):
    raise RuntimeError(
        f"profiler.{what}: the native host recorder lives in the C++ core "
        f"library, which the port does not bind yet; use RecordEvent with "
        f"start_profiler / stop_profiler (torch.profiler) instead")


def export_chrome_tracing(path):
    """The native recorder's Chrome dump: not in the port yet (raises)."""
    _no_native("export_chrome_tracing")


def enable_host_trace():
    """Arm the native host recorder: not in the port yet (raises)."""
    _no_native("enable_host_trace")


def disable_host_trace():
    """Disarm the native host recorder: not in the port yet (raises)."""
    _no_native("disable_host_trace")


def start_profiler(state="All", tracer_option="Default",
                   trace_dir="paddle_tpu_torch_trace"):
    """Start a `torch.profiler.profile` (CPU activity, and CUDA activity
    when a card is present) AND a `profiler.trace` span session in
    lockstep (unless a session is already active, which is then left
    under its owner's control). `trace_dir` is relative to the working
    directory unless absolute."""
    global _trace_dir, _active, _own_tracer, _prof
    import torch

    if _active:
        raise RuntimeError("start_profiler: a profile is already running; "
                           "stop_profiler() it first")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _trace_dir = trace_dir
    os.makedirs(trace_dir, exist_ok=True)
    _prof = torch.profiler.profile(activities=acts)
    _prof.__enter__()
    if trace._SESSION is None:
        trace.start_session()
        _own_tracer = True
    _active = True


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop the torch profile and write its Chrome trace to
    `<trace_dir>/device_trace.json` (`profiler.last_device_trace`); the
    lockstep tracer session (if this module started it) is ended and
    exported to `<trace_dir>/host_trace.json` (`last_host_trace`).
    Returns `summary()`."""
    global _active, _own_tracer, _prof, last_host_trace, last_device_trace
    if _active:
        _active = False
        prof, _prof = _prof, None
        prof.__exit__(None, None, None)
        last_device_trace = os.path.join(_trace_dir, "device_trace.json")
        prof.export_chrome_trace(last_device_trace)
        if _own_tracer:
            _own_tracer = False
            tr = trace.end_session()
            if tr is not None:
                last_host_trace = tr.export_chrome_trace(
                    os.path.join(_trace_dir, "host_trace.json"))
    return summary()


def reset_profiler():
    _events.clear()


def reset():
    """Clear the host RecordEvent buffer (alias of reset_profiler)."""
    reset_profiler()


def events():
    """The recorded (name, event_type, duration_s) host events, newest
    `set_events_capacity()` of them."""
    return list(_events)


def summary():
    agg = {}
    for name, etype, dt in _events:
        tot, cnt = agg.get((name, etype), (0.0, 0))
        agg[(name, etype)] = (tot + dt, cnt + 1)
    lines = ["Event                          Type     Calls    "
             "Total(ms)   Avg(ms)"]
    for (name, etype), (tot, cnt) in sorted(agg.items(),
                                            key=lambda kv: -kv[1][0]):
        lines.append(f"{name:<30} {etype:<8} {cnt:>6} "
                     f"{tot * 1e3:>11.3f} {tot / cnt * 1e3:>9.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             trace_dir="paddle_tpu_torch_trace"):
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
