"""Request-lifecycle tracing for the serving stack.

`profiler.trace` provides the tracer; this module is the serving-side
vocabulary (the JAX package's, name for name): one trace per request (trace id = request id), spans for
every lifecycle phase, engine-track spans for the batched decode step
and every compile, and the waterfall reconstruction the report tool
and tests share. Instrumented call sites in scheduler/engine/server
all guard with ``if _trace._SESSION is not None:`` — one module-global
read when tracing is off.

Span taxonomy (exported Chrome-trace names):

  request         per-request root: submit() -> finish/fail
  queue           admission queue wait: submit -> slot pop (re-opened
                  when page backpressure defers the request back to
                  the queue head)
  join            slot join: prefill / prefix attach / disaggregated
                  dispatch -> return (attrs: slot, prompt bucket,
                  prefix_hit)
  join.prefix_match  instant under the join: the radix prefix-cache
                  consult (attrs: kind whole/partial/miss,
                  matched_pages, matched_tokens)
  pending_splice  disaggregated only: prefill dispatched -> K/V
                  spliced into the live pool (the window the slot is
                  occupied-but-masked)
  decode          slot residency in batched decode: activation -> last
                  token (attrs: steps, tokens)
  first_token     instant: the request's first delivered token (TTFT)
  finish          terminal instant: finish_reason for completed
                  requests
  error           terminal instant: failed/evicted requests, with the
                  cause
  prefill_chunk   one chunked-prefill dispatch interleaved between
                  decode steps (attrs: pos, the post-chunk prompt
                  frontier, and done on the final chunk)
  preempt         instant: the slot was evicted to the prefix cache to
                  free capacity (attrs: slot, tokens so far)
  decode.step     engine track: one batched decode step (attrs:
                  n_active, slots, occupancy, queue depth, page-pool
                  and shard gauges)
  decode.draft    engine track: a speculative draft proposal dispatch
                  (attrs: n_active, proposed)
  decode.verify   engine track: the k-token verify dispatch (attrs:
                  n_active, proposed, accepted)
  compile         engine track: one program's first run, the port's
                  counterpart of a jit trace + compile (attrs: cache
                  key, duration, count)
  retrace         engine track instant: a retrace-sentinel violation
"""
from __future__ import annotations

import numpy as np

from ..profiler import trace as _trace

__all__ = [
    "SPAN_TAXONOMY", "retrace_sentinel", "RetraceSentinel",
    "RetraceError", "session_scope", "start_session", "end_session",
    "load_chrome_trace", "waterfalls", "waterfall_report",
]

# re-exported so serving code/tests have one import surface
RetraceError = _trace.RetraceError
RetraceSentinel = _trace.RetraceSentinel
retrace_sentinel = _trace.retrace_sentinel
session_scope = _trace.session_scope
start_session = _trace.start_session
end_session = _trace.end_session

#: (span name, meaning) — the README "Observability" table and the
#: report tool's legend both render from this
SPAN_TAXONOMY = (
    ("request", "per-request root: submit -> finish/fail"),
    ("queue", "admission queue wait: submit -> slot pop"),
    ("join", "slot join: prefill / prefix attach / disagg dispatch"),
    ("join.prefix_match", "instant: radix prefix-cache consult "
                          "(kind, matched pages/tokens)"),
    ("pending_splice", "disaggregated prefill in flight -> spliced"),
    ("decode", "slot residency in batched decode steps"),
    ("prefill_chunk", "one chunked-prefill dispatch interleaved "
                      "between decode steps (pos, done)"),
    ("preempt", "instant: slot evicted to the prefix cache for "
                "higher-priority work"),
    ("first_token", "instant: first delivered token (TTFT)"),
    ("finish", "terminal instant: finish_reason"),
    ("error", "terminal instant: failure cause"),
    ("decode.step", "engine track: one batched decode step"),
    ("decode.draft", "engine track: speculative draft proposal"),
    ("decode.verify", "engine track: k-token speculative verify"),
    ("compile", "engine track: one program's first run (the port's "
                "compile)"),
    ("precompile", "engine track: one startup program readied "
                   "(source: cache deserialize | AOT compile)"),
    ("retrace", "engine track: retrace-sentinel violation"),
)


class _ReqTrace:
    """Per-request span bookkeeping, attached as `Request._trace`."""

    __slots__ = ("tr", "tid", "root", "queue", "join", "splice",
                 "decode", "steps")

    def __init__(self, tr, tid, root, queue):
        self.tr = tr
        self.tid = tid
        self.root = root
        self.queue = queue
        self.join = None
        self.splice = None
        self.decode = None
        self.steps = 0


# ----------------------------------------------------------------------
# lifecycle hooks (call sites pre-check _trace._SESSION)
# ----------------------------------------------------------------------

def on_submit(r):
    tr = _trace._SESSION
    if tr is None:
        return
    # sampling mode (start_session(sample=...)): an unsampled request
    # costs exactly this one branch (r._trace stays None, so every
    # downstream hook short-circuits on the attribute it already reads)
    if tr.sample is not None and not tr.should_sample(r.id):
        tr.count("requests_unsampled")
        return
    if tr.sample is not None:
        tr.count("requests_sampled")
    root = tr.begin("request", cat="request", trace_id=r.id,
                    attrs={"prompt_len": int(r.prompt.shape[0]),
                           "max_new_tokens": r.max_new_tokens})
    queue = tr.begin("queue", cat="request", trace_id=r.id,
                     parent=root)
    r._trace = _ReqTrace(tr, r.id, root, queue)


def on_queue_exit(r):
    rt = r._trace
    if rt is not None:
        rt.tr.end(rt.queue)


def on_requeue(r):
    """Page backpressure deferred the request back to the queue head:
    re-open a queue span so the waterfall shows the extra wait."""
    rt = r._trace
    if rt is not None:
        rt.queue = rt.tr.begin("queue", cat="request", trace_id=rt.tid,
                               parent=rt.root,
                               attrs={"deferred": True})


def on_join_begin(r, slot):
    rt = r._trace
    if rt is not None:
        rt.tr.end(rt.queue)          # idempotent if already ended
        rt.join = rt.tr.begin("join", cat="request", trace_id=rt.tid,
                              parent=rt.root, attrs={"slot": slot})


def on_join_attr(r, **attrs):
    rt = r._trace
    if rt is not None and rt.join is not None:
        rt.join.attrs.update(attrs)


def on_prefix_match(r, kind, matched_pages=0, matched_tokens=0):
    """Instant span under the join: what the radix prefix cache
    returned for this request ("whole" / "partial" / "miss") and how
    much of the prompt it served — the per-request view of the
    hit_token_ratio gauge."""
    rt = r._trace
    if rt is not None:
        rt.tr.instant("join.prefix_match", cat="request",
                      trace_id=rt.tid, parent=rt.join or rt.root,
                      attrs={"kind": kind,
                             "matched_pages": int(matched_pages),
                             "matched_tokens": int(matched_tokens)})


def on_join_end(r, ok=True, pending=False, error=None):
    rt = r._trace
    if rt is None:
        return
    attrs = {}
    if error is not None:
        attrs = {"error": type(error).__name__}
    rt.tr.end(rt.join, ok=ok, **attrs)
    if ok and pending:
        rt.splice = rt.tr.begin("pending_splice", cat="request",
                                trace_id=rt.tid, parent=rt.root)
    elif ok:
        _begin_decode(rt)


def _begin_decode(rt):
    if rt.decode is None:
        rt.decode = rt.tr.begin("decode", cat="request",
                                trace_id=rt.tid, parent=rt.root)


def on_splice_end(r, ok=True, error=None):
    rt = r._trace
    if rt is None:
        return
    attrs = {} if error is None else {"error": type(error).__name__}
    rt.tr.end(rt.splice, ok=ok, **attrs)
    if ok:
        _begin_decode(rt)


def on_chunk(r, t0, t1, pos, done):
    """One chunked-prefill dispatch for this request's slot ([t0, t1],
    engine clock): `pos` is the POST-chunk prompt frontier, `done`
    marks the final chunk (the join is complete and the slot decodes
    from here on)."""
    rt = r._trace
    if rt is not None:
        rt.tr.add_complete("prefill_chunk", t0, t1, cat="request",
                           trace_id=rt.tid, parent=rt.root,
                           attrs={"pos": int(pos), "done": bool(done)})
        if done:
            _begin_decode(rt)


def on_preempt(r, slot, n_tokens):
    """The shaping scheduler evicted this request's slot to the prefix
    cache; the decode span closes here and a fresh queue span opens
    (the request re-enters admission and resumes via attach)."""
    rt = r._trace
    if rt is None:
        return
    rt.tr.instant("preempt", cat="request", trace_id=rt.tid,
                  parent=rt.root,
                  attrs={"slot": int(slot), "tokens": int(n_tokens)})
    rt.tr.end(rt.decode, steps=rt.steps, tokens=int(n_tokens))
    rt.decode = None
    rt.queue = rt.tr.begin("queue", cat="request", trace_id=rt.tid,
                           parent=rt.root, attrs={"preempted": True})


def on_first_token(r):
    rt = r._trace
    if rt is not None:
        rt.tr.instant("first_token", cat="request", trace_id=rt.tid,
                      parent=rt.root)


def on_finish(r, reason, error=None):
    """Terminal hook — fired from Request.finish()/fail(), so every
    path (eos/length, deadline, cancel, eviction, server crash) closes
    the trace. Evicted/failed requests end with an ``error`` span."""
    rt = r._trace
    if rt is None:
        return
    tr = rt.tr
    tr.end(rt.queue)
    tr.end(rt.join)
    tr.end(rt.splice)
    tr.end(rt.decode, steps=rt.steps, tokens=len(r.tokens))
    if reason == "error" or error is not None:
        attrs = {"reason": reason}
        if error is not None:
            attrs["error"] = type(error).__name__
            attrs["message"] = str(error)[:200]
        tr.instant("error", cat="request", trace_id=rt.tid,
                   parent=rt.root, attrs=attrs)
    else:
        tr.instant("finish", cat="request", trace_id=rt.tid,
                   parent=rt.root, attrs={"reason": reason})
    tr.end(rt.root, reason=reason, tokens=len(r.tokens))
    r._trace = None


def on_decode_step(engine, t0, t1, active, scheduler=None):
    """Engine-track span for one batched decode step, with the page
    pool / shard gauges as attributes and the co-resident requests'
    trace ids in ``slots``: every decode step a request co-resides in
    is recoverable from the trace."""
    tr = _trace._SESSION
    if tr is None:
        return
    tids = []
    for s, r in enumerate(engine.slots):
        if r is not None and active[s]:
            tids.append(r.id)
            rt = r._trace
            if rt is not None:
                _begin_decode(rt)
                rt.steps += 1
    attrs = {"n_active": len(tids), "slots": tids,
             "occupancy": engine.occupancy()}
    if scheduler is not None:
        attrs["queue_depth"] = scheduler.depth()
    for k, v in (engine._iteration_gauges() or {}).items():
        attrs[k] = (round(float(v), 3) if isinstance(v, float)
                    else list(v) if isinstance(v, (list, tuple))
                    else v)
    tr.add_complete("decode.step", t0, t1, cat="engine", attrs=attrs)


def on_spec_step(t0, t1, t2, n_active, proposed, accepted):
    """Engine-track spans for one speculative iteration's two
    dispatches: the draft proposal ([t0, t1]) and the k-token verify
    ([t1, t2]) with the device-side acceptance counts (the waterfall
    report's speculation-phase breakdown reads these)."""
    tr = _trace._SESSION
    if tr is None:
        return
    tr.add_complete("decode.draft", t0, t1, cat="engine",
                    attrs={"n_active": n_active, "proposed": proposed})
    tr.add_complete("decode.verify", t1, t2, cat="engine",
                    attrs={"n_active": n_active, "proposed": proposed,
                           "accepted": accepted})


# ----------------------------------------------------------------------
# waterfall reconstruction (shared by tools/trace_report.py and tests)
# ----------------------------------------------------------------------

_PHASES = ("queue", "join", "pending_splice", "decode")


def load_chrome_trace(path):
    """Read a chrome-trace JSON file back into its event list."""
    import json

    with open(path) as f:
        payload = json.load(f)
    return payload["traceEvents"] if isinstance(payload, dict) \
        else payload


def waterfalls(events):
    """Group request-track events into per-request waterfalls:
    {trace_id: {"spans": [...], "phases": {phase: total_ms},
    "total_ms", "reason", "tokens", "complete"}}. `complete` requires
    the root request span plus queue, join and a terminal
    finish/error event: the acceptance contract for every admitted
    request."""
    out = {}
    for ev in events:
        if ev.get("ph") not in ("X",) or ev.get("cat") != "request":
            continue
        tid = ev.get("args", {}).get("trace_id")
        if tid is None:
            continue
        out.setdefault(tid, []).append(ev)
    result = {}
    for tid, evs in out.items():
        evs.sort(key=lambda e: e["ts"])
        phases = {p: 0.0 for p in _PHASES}
        root = None
        reason = None
        terminal = None
        tokens = None
        for e in evs:
            n = e["name"]
            if n == "request":
                root = e
                reason = e["args"].get("reason", reason)
                tokens = e["args"].get("tokens", tokens)
            elif n in phases:
                phases[n] += e.get("dur", 0.0) / 1e3
            elif n in ("finish", "error"):
                terminal = n
                reason = e["args"].get("reason", reason)
        total = (root.get("dur", 0.0) / 1e3) if root else None
        result[tid] = {
            "spans": evs,
            "phases": {k: round(v, 3) for k, v in phases.items()},
            "total_ms": None if total is None else round(total, 3),
            "reason": reason,
            "terminal": terminal,
            "tokens": tokens,
            "complete": (root is not None and terminal is not None
                         and any(e["name"] == "queue" for e in evs)
                         and any(e["name"] == "join" for e in evs)),
        }
    return result


def waterfall_report(events, percentiles=(50, 95), top=0, width=48):
    """Render the per-request latency breakdown: per-phase
    p<percentiles> across all requests, then (optionally) the `top`
    slowest requests as ASCII waterfalls."""
    wf = waterfalls(events)
    lines = []
    done = [w for w in wf.values() if w["total_ms"] is not None]
    lines.append(f"requests: {len(wf)} traced, {len(done)} finished, "
                 f"{sum(1 for w in wf.values() if w['complete'])} "
                 f"complete waterfalls")
    if not done:
        return "\n".join(lines)
    hdr = "phase".ljust(16) + "".join(
        f"p{int(q)}(ms)".rjust(12) for q in percentiles) \
        + "mean(ms)".rjust(12)
    lines.append(hdr)
    for phase in _PHASES + ("total",):
        vals = np.asarray([w["total_ms"] if phase == "total"
                           else w["phases"][phase] for w in done])
        row = phase.ljust(16) + "".join(
            f"{float(np.percentile(vals, q)):12.2f}"
            for q in percentiles) + f"{float(vals.mean()):12.2f}"
        lines.append(row)
    if top:
        lines.append("")
        slowest = sorted(wf.items(),
                         key=lambda kv: -(kv[1]["total_ms"] or 0))[:top]
        scale = max(w["total_ms"] or 0 for _, w in slowest) or 1.0
        glyph = {"queue": ".", "join": "#", "pending_splice": "~",
                 "decode": "="}
        for tid, w in slowest:
            bar = ""
            for p in _PHASES:
                n = int(round(w["phases"][p] / scale * width))
                bar += glyph[p] * n
            lines.append(f"req {tid:>6} {w['total_ms'] or 0:9.2f}ms "
                         f"|{bar:<{width}}| {w['reason']}")
        lines.append("legend: .=queue  #=join  ~=pending_splice  "
                     "==decode")
    return "\n".join(lines)
