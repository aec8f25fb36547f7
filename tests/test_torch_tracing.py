"""The port's request tracing, compile observer and retrace sentinel
(`paddle_tpu_torch.profiler.trace`, `serving.tracing`), on the CPU.

The JAX package's `test_tracing.py` cases run on the port (the raw
tracer, the ring, sessions, the dense and paged waterfall soaks, an
evicted request's error span, the sentinel's modes and budgets, the
disabled mode's zero allocations, RecordEvent, sampling, the lockstep
profile's span links), then the JAX and port engines serve the same
seeded soak (dense, dense spec_k 4, paged with the prefix cache, paged
spec_k 4) under a session: each request's spans (names and attributes,
times and ids aside), the `trace_counts` key sets and each decode step's
co-residents and gauges are equal, and so are the tokens with and
without the session.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import trace as JT
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.profiler import costs
from paddle_tpu_torch.profiler import trace as T
from paddle_tpu_torch.serving import (Request, Scheduler, ServingEngine,
                                      tracing as rt)
from paddle_tpu_torch.testing import faults
from test_torch_paging import preamble_requests
from test_torch_serving import build_stacks
from test_torch_spec import spec_requests


@pytest.fixture(autouse=True)
def _reset_port_tracing():
    """The port's own session / sentinel / accounting state (the
    conftest resets the JAX package's)."""
    yield
    T.reset()
    costs.reset()
    faults.reset()


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def _small_stack(seed=7, D=32, H=2, V=17, layers=2):
    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    dec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D, H, 64, dropout=0.0, device="cpu", generator=g), layers)
    embed = tnn.Embedding(V, D, device="cpu", generator=g)
    proj = tnn.Linear(D, V, device="cpu", generator=g)
    for m in (dec, embed, proj):
        m.eval()
    return dec, embed, proj, D, V


def _mk_request(rs, D, V, pmax=6, nmax=10, **kw):
    P = int(rs.randint(1, pmax + 1))
    prompt = rs.randint(2, V, (P,)).astype(np.int32)
    prompt[0] = 0
    mem_seed = int(prompt.sum()) * 131 + P
    mem = np.random.RandomState(mem_seed).randn(4, D).astype("f4")
    n = int(rs.randint(2, nmax + 1))
    return Request(prompt, torch.from_numpy(mem), max_new_tokens=n,
                   eos_id=1, **kw)


def _ragged_soak(eng, stack, n_requests, seed, sched=None):
    """Submit `n_requests` in ragged waves between iterations; drive to
    idle; every future must resolve ok."""
    D, V = stack[3], stack[4]
    sched = sched or Scheduler(max_queue=4 * n_requests)
    rs = np.random.RandomState(seed)
    reqs = []

    def wave(k):
        for _ in range(k):
            r = _mk_request(rs, D, V)
            sched.submit(r)
            reqs.append(r)

    wave(4)
    it = 0
    while len(reqs) < n_requests or sched.depth() > 0 or \
            eng.occupancy() > 0:
        eng.run_iteration(sched)
        it += 1
        if len(reqs) < n_requests and it % 3 == 0:
            wave(int(rs.randint(1, 5)))
        assert it < 3000
    for r in reqs:
        assert r.result(timeout=5).ok
    return reqs


def _check_export(tr, reqs, tmp_path, tag):
    path = str(tmp_path / f"{tag}.json")
    tr.export_chrome_trace(path)
    payload = json.load(open(path))
    assert set(payload) == {"traceEvents", "displayTimeUnit"}
    events = payload["traceEvents"]
    for ev in events:
        assert ev["ph"] in ("X", "M", "C"), ev
        assert "name" in ev and "pid" in ev
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
    wf = rt.waterfalls(events)
    ids = {r.id for r in reqs}
    assert ids <= set(wf), (sorted(ids), sorted(wf))
    for r in reqs:
        w = wf[r.id]
        assert w["complete"], (r.id, sorted(e["name"] for e in w["spans"]))
        assert w["terminal"] == "finish"
        assert w["tokens"] == len(r.result().tokens)
        assert w["total_ms"] >= w["phases"]["queue"] >= 0
    rep = rt.waterfall_report(events, top=3)
    assert "phase" in rep and "p50(ms)" in rep and "req " in rep
    return events


# ----------------------------------------------------------------------
# the JAX package's cases on the port
# ----------------------------------------------------------------------

def test_span_nesting_ordering_and_roundtrip(tmp_path):
    tr = T.Tracer(capacity=16)
    root = tr.begin("request", cat="request", trace_id=9)
    child = tr.begin("queue", cat="request", trace_id=9, parent=root)
    with tr.span("inner", cat="span", trace_id=9, parent=child):
        pass
    tr.end(child)
    tr.instant("finish", cat="request", trace_id=9, parent=root)
    tr.end(root, reason="eos")
    spans = tr.spans()
    by_name = {s.name: s for s in spans}
    assert by_name["queue"].parent_id == root.span_id
    assert by_name["inner"].parent_id == child.span_id
    assert root.t0 <= child.t0 <= child.t1 <= root.t1
    assert child.t0 <= by_name["inner"].t0 <= by_name["inner"].t1 \
        <= child.t1
    names = [s.name for s in spans]
    assert names.index("inner") < names.index("queue") < \
        names.index("request")
    path = tr.export_chrome_trace(str(tmp_path / "t.json"))
    evs = rt.load_chrome_trace(path)
    req_evs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in req_evs} == {"request", "queue", "inner",
                                           "finish"}
    for e in req_evs:
        assert e["args"]["trace_id"] == 9
    q = next(e for e in req_evs if e["name"] == "queue")
    assert q["args"]["parent_id"] == root.span_id


def test_ring_buffer_caps_and_counts_drops():
    tr = T.Tracer(capacity=8)
    for i in range(20):
        tr.instant(f"e{i}")
    assert len(tr.spans()) == 8
    assert tr.dropped == 12
    assert [s.name for s in tr.spans()] == [f"e{i}" for i in range(12, 20)]


def test_session_management():
    assert T.session() is None
    tr = T.start_session()
    try:
        with pytest.raises(RuntimeError, match="already active"):
            T.start_session()
        assert T.session() is tr
    finally:
        assert T.end_session() is tr
    assert T.session() is None and T.end_session() is None


def test_waterfall_soak_dense_engine(tmp_path):
    """Ragged-arrival soak on the dense pool under a session and the
    retrace sentinel: complete waterfalls, one compile span per program
    key (its first run), decode.step spans carrying the co-residents."""
    stack = _small_stack(seed=121)
    eng = ServingEngine(*stack[:3], num_slots=4, max_len=32, device="cpu")
    with T.session_scope() as tr, rt.retrace_sentinel(eng):
        reqs = _ragged_soak(eng, stack, 16, seed=122)
    events = _check_export(tr, reqs, tmp_path, "dense")
    compiles = [e for e in events if e["name"] == "compile"]
    keys = {e["args"]["key"] for e in compiles}
    assert any("'step'" in k for k in keys), keys
    assert any("'join'" in k for k in keys), keys
    assert len(compiles) == len(eng.trace_counts)
    for e in compiles:
        assert e["dur"] > 0 and e["args"]["count"] == 1
    assert set(eng.trace_counts.values()) == {1}
    steps = [e for e in events if e["name"] == "decode.step"]
    assert steps
    seen = set()
    for e in steps:
        assert e["args"]["n_active"] == len(e["args"]["slots"])
        seen.update(e["args"]["slots"])
    decoded = {r.id for r in reqs if len(r.result().tokens) > 1}
    assert decoded <= seen


def test_waterfall_soak_paged_engine(tmp_path):
    """The soak through the paged pool: pjoin / pstep keys, prefix_hit
    on the join spans, the page gauges on decode.step."""
    stack = _small_stack(seed=131)
    D, V = stack[3], stack[4]
    eng = ServingEngine(*stack[:3], num_slots=4, max_len=32, paged=True,
                        page_size=8, device="cpu")
    sched = Scheduler(max_queue=64)
    rs = np.random.RandomState(132)
    protos = [_mk_request(rs, D, V) for _ in range(4)]
    with T.session_scope() as tr, rt.retrace_sentinel(eng):
        reqs = []
        for i in range(10):            # repeats ride the prefix cache
            p = protos[i % len(protos)]
            r = Request(p.prompt.copy(), p.memory,
                        max_new_tokens=p.max_new_tokens, eos_id=1)
            sched.submit(r)
            reqs.append(r)
            eng.run_iteration(sched)
        it = 0
        while sched.depth() > 0 or eng.occupancy() > 0:
            eng.run_iteration(sched)
            it += 1
            assert it < 2000
        for r in reqs:
            assert r.result(timeout=5).ok
    events = _check_export(tr, reqs, tmp_path, "paged")
    joins = [e for e in events if e["name"] == "join"]
    assert [e for e in joins if e["args"].get("prefix_hit")]
    assert [e for e in joins if e["args"].get("prefix_hit") is False]
    steps = [e for e in events if e["name"] == "decode.step"]
    assert all("pages_in_use" in e["args"] and "pages_free" in e["args"]
               for e in steps), steps[0]["args"]
    keys = {e["args"]["key"] for e in events if e["name"] == "compile"}
    assert any("'pstep'" in k for k in keys), keys


def test_evicted_request_trace_ends_with_error_span(tmp_path):
    stack = _small_stack(seed=151)
    D, V = stack[3], stack[4]
    eng = ServingEngine(*stack[:3], num_slots=2, max_len=32, device="cpu",
                        max_attempts=2, backoff_base_s=0.0)
    sched = Scheduler(max_queue=8)
    rs = np.random.RandomState(152)
    with T.session_scope() as tr:
        a = Request(np.asarray([0, 3, 4], np.int32),
                    torch.from_numpy(rs.randn(4, D).astype("f4")),
                    max_new_tokens=20, eos_id=None)
        sched.submit(a)
        for _ in range(3):
            eng.run_iteration(sched)
        assert len(a.tokens) >= 2
        with faults.inject("serving.decode_step", on="always",
                           max_fires=2):
            eng.run_iteration(sched)
        assert a.result(timeout=5).finish_reason == "error"
        b = _mk_request(rs, D, V)
        sched.submit(b)
        with faults.inject("serving.prefill", on="always"):
            eng.run_iteration(sched)
        with pytest.raises(faults.InjectedFault):
            b.result(timeout=5)
    wf = rt.waterfalls(tr.chrome_trace_events())
    for r in (a, b):
        w = wf[r.id]
        assert w["terminal"] == "error", w
        err = [e for e in w["spans"] if e["name"] == "error"]
        assert err and err[0]["args"]["error"] == "InjectedFault"
        assert w["spans"][-1]["name"] in ("error", "request")
    joins = [e for e in wf[b.id]["spans"] if e["name"] == "join"]
    assert joins and joins[-1]["args"]["ok"] is False


def test_retrace_sentinel_raise_log_and_budgets():
    stack = _small_stack(seed=161)
    D, V = stack[3], stack[4]
    eng = ServingEngine(*stack[:3], num_slots=2, max_len=32, device="cpu")
    sched = Scheduler(max_queue=8)
    rs = np.random.RandomState(162)
    with rt.retrace_sentinel(eng) as s:
        r = _mk_request(rs, D, V)
        sched.submit(r)
        eng.serve_until_idle(sched, max_iterations=200)
        assert r.result(timeout=5).ok
        assert not s.violations
    step_key = ("step",) + eng._pool_key
    assert eng.trace_counts[step_key] == 1
    with rt.retrace_sentinel(eng):
        with pytest.raises(T.RetraceError, match="traced 2 times"):
            eng.trace_counts[step_key] += 1
    eng.trace_counts[step_key] -= 1
    with rt.retrace_sentinel(eng, mode="log") as s:
        eng.trace_counts[step_key] += 1
        assert len(s.violations) == 1
        assert s.violations[0]["key"] == step_key
        with pytest.raises(T.RetraceError):
            s.assert_ok()
    eng.trace_counts[step_key] -= 1
    with rt.retrace_sentinel(eng, budgets={"step": 3}) as s:
        eng.trace_counts[step_key] += 1
        eng.trace_counts[("join", 2)] = 1
        assert not s.violations
    eng.trace_counts[step_key] -= 1
    eng.trace_counts[step_key] += 5
    eng.trace_counts[step_key] -= 5


def test_sentinel_violation_fails_request_loudly():
    """Dropping a cached program makes its next first run count again:
    under the sentinel the request fails, never a silent slowdown."""
    stack = _small_stack(seed=171)
    D, V = stack[3], stack[4]
    eng = ServingEngine(*stack[:3], num_slots=2, max_len=32, device="cpu",
                        max_attempts=1)
    sched = Scheduler(max_queue=8)
    rs = np.random.RandomState(172)
    r0 = _mk_request(rs, D, V)
    sched.submit(r0)
    eng.serve_until_idle(sched, max_iterations=200)
    assert r0.result(timeout=5).ok
    jkey = next(k for k in eng.trace_counts if k[0] == "join")
    raw = dict.__getitem__(eng._compiled, jkey)
    del eng._compiled[jkey]
    try:
        with rt.retrace_sentinel(eng):
            r1 = Request(r0.prompt.copy(), r0.memory, max_new_tokens=4,
                         eos_id=1)
            sched.submit(r1)
            for _ in range(3):
                eng.run_iteration(sched)
        with pytest.raises(T.RetraceError):
            r1.result(timeout=5)
    finally:
        dict.__setitem__(eng._compiled, jkey, raw)


def test_disabled_mode_records_and_allocates_nothing():
    import tracemalloc

    stack = _small_stack(seed=181)
    D = stack[3]
    eng = ServingEngine(*stack[:3], num_slots=2, max_len=128, device="cpu")
    sched = Scheduler(max_queue=8)
    rs = np.random.RandomState(182)
    r = Request(np.asarray([0, 3], np.int32),
                torch.from_numpy(rs.randn(4, D).astype("f4")),
                max_new_tokens=100, eos_id=None)
    sched.submit(r)
    for _ in range(5):
        eng.run_iteration(sched)
    assert r._trace is None
    tracemalloc.start()
    snap1 = tracemalloc.take_snapshot()
    for _ in range(20):
        eng.run_iteration(sched)
    snap2 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grew = [d for d in snap2.compare_to(snap1, "filename")
            if d.size_diff > 0 and any(
                m in (d.traceback[0].filename or "")
                for m in ("profiler/trace", "profiler/costs",
                          "serving/tracing"))]
    assert not grew, [str(g) for g in grew]
    assert T.session() is None and costs.book() is None
    r.cancel()
    eng.serve_until_idle(sched, max_iterations=50)


def test_record_event_type_capacity_and_tracer_surface():
    prof.reset()
    with prof.RecordEvent("unit_x", event_type="kernel"):
        pass
    evs = prof.events()
    assert evs and evs[-1][0] == "unit_x" and evs[-1][1] == "kernel"
    assert "kernel" in prof.summary()
    old_cap = prof._EVENTS_CAP
    try:
        prof.set_events_capacity(4)
        for i in range(7):
            with prof.RecordEvent(f"e{i}"):
                pass
        assert [e[0] for e in prof.events()] == ["e3", "e4", "e5", "e6"]
    finally:
        prof.set_events_capacity(old_cap)
    prof.reset()
    assert prof.events() == []
    with T.session_scope() as tr:
        with prof.RecordEvent("in_session", event_type="step"):
            pass
    spans = [s for s in tr.spans() if s.name == "in_session"]
    assert len(spans) == 1 and spans[0].cat == "record_event"
    assert spans[0].attrs["event_type"] == "step"


def test_sampling_deterministic_and_bounded():
    tr = T.Tracer(sample=0.5)
    picks = [tr.should_sample(i) for i in range(200)]
    assert picks == [tr.should_sample(i) for i in range(200)]
    assert 60 <= sum(picks) <= 140
    assert all(T.Tracer(sample=1.0).should_sample(i) for i in range(50))
    with pytest.raises(ValueError):
        T.Tracer(sample=0.0)
    with pytest.raises(ValueError):
        T.Tracer(sample=1.5)


def test_sampled_session_traces_only_sampled_requests():
    stack = _small_stack()
    D, V = stack[3], stack[4]
    eng = ServingEngine(*stack[:3], num_slots=4, max_len=32, device="cpu")
    sched = Scheduler(max_queue=64)
    rs = np.random.RandomState(3)
    with T.session_scope(sample=0.5) as tr:
        reqs = []
        for _ in range(12):
            r = _mk_request(rs, D, V)
            sched.submit(r)
            reqs.append(r)
        eng.serve_until_idle(sched, max_iterations=2000)
        for r in reqs:
            assert r.result(timeout=5).ok
    sampled = {r.id for r in reqs if tr.should_sample(r.id)}
    unsampled = {r.id for r in reqs} - sampled
    assert sampled and unsampled, "seed produced a degenerate split"
    wf = rt.waterfalls(tr.chrome_trace_events())
    assert sampled <= set(wf)
    assert not (unsampled & set(wf))
    for rid in sampled:
        assert wf[rid]["complete"]
    assert tr.counters["requests_sampled"] == len(sampled)
    assert tr.counters["requests_unsampled"] == len(unsampled)
    assert all(r._trace is None for r in reqs)


def test_record_event_span_links_in_lockstep_profile(tmp_path):
    """start_profiler runs torch.profiler beside a tracer session: the
    RecordEvent's span ids ride in its record_function label into the
    device trace, and host_trace.json carries the same span."""
    trace_dir = str(tmp_path / "prof")
    prof.start_profiler(trace_dir=trace_dir)
    try:
        assert T._SESSION is not None
        with prof.RecordEvent("linked_op", event_type="step", trace_id=42):
            torch.ones(4).sum()
    finally:
        prof.stop_profiler()
    host = rt.load_chrome_trace(prof.last_host_trace)
    linked = [e for e in host
              if e.get("name") == "linked_op" and e["ph"] == "X"]
    assert linked, [e.get("name") for e in host]
    args = linked[0]["args"]
    assert args["trace_id"] == 42 and args["span_id"] > 0
    assert args["event_type"] == "step"
    dev = rt.load_chrome_trace(prof.last_device_trace)
    label = f"linked_op#trace_id=42,span_id={args['span_id']}"
    assert any(e.get("name") == label for e in dev), \
        sorted({e.get("name") for e in dev})[:20]
    assert T._SESSION is None


def test_record_event_without_profiler_still_spans():
    with T.session_scope() as tr:
        with prof.RecordEvent("plain", event_type="op"):
            pass
    spans = [s for s in tr.spans() if s.name == "plain"]
    assert len(spans) == 1
    assert spans[0].cat == "record_event" and spans[0].t1 is not None


def test_native_host_recorder_is_refused():
    for fn in (prof.enable_host_trace, prof.disable_host_trace):
        with pytest.raises(RuntimeError, match="not bind"):
            fn()
    with pytest.raises(RuntimeError, match="not bind"):
        prof.export_chrome_tracing("x.json")


# ----------------------------------------------------------------------
# parity with the JAX engines on one seeded soak
# ----------------------------------------------------------------------

#: span attributes that carry times, ids or process-local names
_VOLATILE = {"trace_id", "span_id", "parent_id", "open"}


def _request_spans(events, rid):
    """[(name, {attrs})] of a request's trace in time order, times and
    ids aside."""
    evs = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "request"
                  and e["args"].get("trace_id") == rid),
                 key=lambda e: (e["ts"], e["name"]))
    return [(e["name"], {k: v for k, v in e["args"].items()
                         if k not in _VOLATILE}) for e in evs]


def _taxonomy(spans):
    """The span names with their attributes; a join's attribute order
    and a root's tail do not depend on the timing."""
    return sorted((n, json.dumps(a, sort_keys=True)) for n, a in spans)


def _soak(engine, reqs, jax, trace=True):
    """Serve `reqs` (prompt, memory, max_new) through `engine`'s package
    under a session (or none). Returns (tokens, request ids, events)."""
    mod = JT if jax else T
    sched = (JScheduler if jax else Scheduler)(max_queue=64)
    mk = JRequest if jax else Request
    ctx = mod.session_scope() if trace else None
    tr = ctx.__enter__() if trace else None
    try:
        rs = [mk(p, m, max_new_tokens=n, eos_id=1) for p, m, n in reqs]
        for i, r in enumerate(rs):
            sched.submit(r)
            if i % 3 == 2:
                engine.run_iteration(sched)
        engine.serve_until_idle(sched)
    finally:
        if trace:
            ctx.__exit__(None, None, None)
    toks = [list(map(int, r.result().tokens)) for r in rs]
    return toks, [r.id for r in rs], (tr.chrome_trace_events()
                                      if trace else None)


def _steps(events, ids):
    """Each decode step's co-residents as submission indices, with its
    other attributes (occupancy, queue depth, page and trie gauges)."""
    pos = {rid: i for i, rid in enumerate(ids)}
    return [(sorted(pos[s] for s in e["args"]["slots"]),
             {k: v for k, v in e["args"].items()
              if k not in _VOLATILE and k != "slots"})
            for e in sorted((e for e in events if e["name"] ==
                             "decode.step"), key=lambda e: e["ts"])]


CASES = {
    "dense": (dict(), "spec"),
    "dense_spec4": (dict(spec_k=4), "spec"),
    "paged": (dict(paged=True, page_size=8), "preamble"),
    "paged_spec4": (dict(paged=True, page_size=8, spec_k=4), "preamble"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_soak_matches_jax_engine(stacks, case):
    """The same seeded soak on the JAX and the port engine under a
    session: per request the same span taxonomy and attributes, the
    same trace_counts keys, every decode step with the same co-residents
    and gauges, the same draft / verify spans, and the tokens of an
    untraced port run."""
    kw, kind = CASES[case]
    kw = dict(num_slots=4, max_len=64, **kw)
    reqs = spec_requests(seed=11, n=9) if kind == "spec" else \
        preamble_requests(13, n=9)
    jeng = JServingEngine(*stacks[0], **kw)
    want, jids, jev = _soak(jeng, reqs, jax=True)
    eng = ServingEngine(*stacks[1], device="cpu", **kw)
    got, ids, ev = _soak(eng, reqs, jax=False)
    assert got == want
    plain, _, _ = _soak(ServingEngine(*stacks[1], device="cpu", **kw),
                        reqs, jax=False, trace=False)
    assert got == plain
    for jid, rid in zip(jids, ids):
        assert _taxonomy(_request_spans(ev, rid)) == \
            _taxonomy(_request_spans(jev, jid)), (case, rid)
    assert set(eng.trace_counts) == set(jeng.trace_counts)
    assert _steps(ev, ids) == _steps(jev, jids)
    spec = [e for e in ev if e["name"] in ("decode.draft", "decode.verify")]
    jspec = [e for e in jev if e["name"] in ("decode.draft",
                                             "decode.verify")]
    assert [(e["name"], e["args"]) for e in spec] == \
        [(e["name"], e["args"]) for e in jspec]
