"""The port's chunked prefill, preemption and traffic shaping against the
JAX package's, on the CPU.

Small model (2 decoder layers, d_model 32, 2 heads, vocabulary 17), built
in JAX and loaded into the port. Chunked prefill gives the whole-prompt
join's tokens bit for bit on the dense pool and on the paged pool over
chunk x page x spec_k, and both equal the JAX engine's tokens; each chunk
runs the verify path at T = the chunk. A request preempted for
interactive traffic and resumed (also when preempted again in the middle
of its replay) gives an unpreempted twin's tokens and the JAX engine's;
its resume attaches the parked prefix, so `prefill_count` grows by the
cold prompts only, even when the trie is at its capacity; a replayed
token that differs from the delivered one fails the request. Chunked
prefill runs one chunk an iteration, the pending slots taking turns.
The `ShapingScheduler` units of the JAX tests (class rank and deadline
order, WFQ weights and lag, the watermark gate, drain, queue full) run on
a fake clock, and seeded sequences of submits, pops, requeues, victim
picks and gate changes give the JAX scheduler's pops, victims, lags and
gate decisions exactly; under both engines the shaping policy admits and
preempts in the same order. The metrics' "slo" section and
`SNAPSHOT_DOCS` agree; the server carries a caller's scheduler and
`slo=`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.serving as jserving
import paddle_tpu_torch.serving as tserving
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.serving import (BATCH, INTERACTIVE, QueueFull,
                                      ReplayDiverged, Request, Scheduler,
                                      ServingEngine, ServingMetrics,
                                      ServingServer, ShapingScheduler)
from paddle_tpu_torch.serving import engine as E
from paddle_tpu_torch.serving.metrics import SNAPSHOT_DOCS, flatten_snapshot
from paddle_tpu_torch.testing import faults
from test_torch_decode import D, V, stacks
from test_torch_faults import _eager, _no_leak, _reqs, _serve, _specs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    faults.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def tokens(reqs):
    return [list(r.result(5).tokens) for r in reqs]


def jax_tokens(jstack, specs, num_slots=3, max_len=32):
    eng = JServingEngine(*jstack, num_slots=num_slots, max_len=max_len)
    sched = JScheduler(max_queue=len(specs) + 8)
    rs = [JRequest(p.copy(), m, max_new_tokens=n, eos_id=1)
          for p, m, n in specs]
    for r in rs:
        sched.submit(r)
    eng.serve_until_idle(sched, max_iterations=5000)
    return [list(r.result(5).tokens) for r in rs]


def verify_widths(monkeypatch):
    """Log the T of every verify-mode attention call (dense and paged)."""
    seen = []
    for name in ("verify_attention", "paged_verify_attention"):
        orig = getattr(A, name)

        def wrapped(q, *a, _orig=orig, _name=name, **kw):
            seen.append((_name, q.shape[2]))
            return _orig(q, *a, **kw)

        monkeypatch.setattr(A, name, wrapped)
    return seen


# ---- chunked prefill -------------------------------------------------

def test_chunked_prefill_equals_whole_prompt_dense(monkeypatch):
    jstack, stack = stacks(seed=21)
    specs = _specs(22, 8)
    want = jax_tokens(jstack, specs)
    plain = ServingEngine(*stack, num_slots=3, max_len=32, device="cpu")
    whole = tokens(_serve(plain, _reqs(specs)))
    seen = verify_widths(monkeypatch)
    eng = ServingEngine(*stack, num_slots=3, max_len=32, device="cpu",
                        prefill_chunk=4)
    reqs = _serve(eng, _reqs(specs))
    assert tokens(reqs) == whole == want
    for r in reqs:
        np.testing.assert_array_equal(r.result().tokens, _eager(stack, r))
    m = eng.metrics
    assert m.chunked_prefills == sum(len(p) > 4 for p, _, _ in specs) > 0
    assert m.chunks > m.chunked_prefills
    assert ("verify_attention", 4) in seen
    assert eng.metrics.snapshot()["slo"]["chunks"] == m.chunks


@pytest.fixture(scope="module")
def paged_model():
    jstack, stack = stacks(seed=31)
    specs = _specs(32, 8)
    return stack, specs, jax_tokens(jstack, specs)


@pytest.mark.parametrize("chunk,page,spec_k", [
    (4, 4, 0), (4, 4, 4), (8, 4, 0), (8, 8, 4)])
def test_chunked_prefill_equals_whole_prompt_paged(paged_model, chunk, page,
                                                   spec_k):
    """Chunks land page-aligned through the pages; k-wide verify writes
    of the co-resident slots never clobber a chunk boundary (the equality
    would show it); no page leaks."""
    stack, specs, want = paged_model
    kw = dict(paged=True, page_size=page, num_pages=64, device="cpu",
              spec_k=spec_k or None)
    plain = ServingEngine(*stack, num_slots=3, max_len=32, **kw)
    whole = tokens(_serve(plain, _reqs(specs)))
    eng = ServingEngine(*stack, num_slots=3, max_len=32,
                        prefill_chunk=chunk, **kw)
    got = tokens(_serve(eng, _reqs(specs)))
    assert got == whole == want
    assert eng.metrics.chunked_prefills > 0
    assert eng.prefill_count == plain.prefill_count
    _no_leak(eng)


@pytest.mark.parametrize("paged", [False, True])
def test_one_chunk_an_iteration(paged):
    """However many slots are mid-prefill, an iteration runs one chunk, so
    the co-resident decodes wait for one chunk at most; the pending slots
    take turns."""
    _, stack = stacks(seed=21)
    kw = dict(paged=True, page_size=4, num_pages=64) if paged else {}
    eng = ServingEngine(*stack, num_slots=3, max_len=32, device="cpu",
                        prefill_chunk=4, max_joins_per_iter=3, **kw)
    specs = _specs(22, 3, pmin=12, pmax=14)
    reqs = _reqs(specs)
    sched = Scheduler(max_queue=8)
    for r in reqs:
        sched.submit(r)
    ran, seen = [], []
    orig = eng._chunk_step

    def logged(s, info):
        seen.append(s)
        return orig(s, info)

    eng._chunk_step = logged
    while eng.run_iteration(sched):
        ran.append(len(seen))
    assert max(np.diff([0] + ran)) == 1
    assert seen[:3] == [0, 1, 2] and len(seen) == eng.metrics.chunks
    for r in reqs:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))


def test_finished_chunks_enter_the_trie():
    """A long prompt's finished chunks are partial-matchable before its
    final chunk: a second request sharing them attaches the pages."""
    _, stack = stacks(seed=31)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=64,
                        prefill_chunk=4)
    rs = np.random.RandomState(5)
    p = rs.randint(2, V, 14).astype(np.int32)
    p[0] = 0
    mem = rs.randn(4, D).astype(np.float32)
    first = Request(p.copy(), mem, max_new_tokens=3, eos_id=1)
    sched = Scheduler(max_queue=8)
    sched.submit(first)
    eng.run_iteration(sched)          # join + the first chunk
    eng.run_iteration(sched)          # the second chunk
    assert eng._prefix.stats()["nodes"] == 2
    second = Request(np.concatenate([p[:9], [3, 4]]).astype(np.int32), mem,
                     max_new_tokens=3, eos_id=1)
    sched.submit(second)
    eng.serve_until_idle(sched, max_iterations=100)
    assert eng.metrics.prefix_partial_hits == 1
    for r in (first, second):
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    _no_leak(eng)


def test_prefill_chunk_knob_validation():
    _, stack = stacks(seed=5)
    for bad in (6, 1, 12):
        with pytest.raises(ValueError, match="power of two"):
            ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                          prefill_chunk=bad)
    with pytest.raises(ValueError, match="multiple of"):
        ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                      paged=True, page_size=8, prefill_chunk=4)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        prefill_chunk=8)
    assert eng.prefill_chunk == 8
    with pytest.raises(TypeError):
        ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                      no_such_knob=1)


# ---- preemption ------------------------------------------------------

def _preempt_scenario(stack, spec_k, **kw):
    """Three batch requests fill two slots, then three interactive ones
    arrive: (engine, batch + interactive requests, prefills before the
    interactive wave, specs)."""
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=48,
                        spec_k=spec_k or None, **kw)
    bspecs = [(p, m, 12) for p, m, _ in _specs(42, 3, pmin=4, pmax=8)]
    ispecs = _specs(43, 3, pmin=1, pmax=4, nmax=6)
    batch = _reqs(bspecs, slo="batch")
    inter = _reqs(ispecs, slo="interactive")
    sched = ShapingScheduler(max_queue=32, metrics=eng.metrics)
    for r in batch:
        sched.submit(r)
    for _ in range(2):
        eng.run_iteration(sched)
    cold = eng.prefill_count
    for r in inter:
        sched.submit(r)
    eng.serve_until_idle(sched, max_iterations=5000)
    return eng, batch + inter, cold, bspecs + ispecs


@pytest.mark.parametrize("spec_k", [0, 4])
def test_preempt_resume_matches_twin_and_jax(monkeypatch, spec_k):
    """Batch slots preempted for interactive arrivals resume with the
    unpreempted twin's tokens and the JAX engine's. The resume attaches
    the parked prefix: no request that was preempted ever prefills again,
    and `prefill_count` counts each distinct prompt once. (The JAX
    test's bound `cold + interactive` leaves out the third batch prompt,
    which is cold too.)"""
    jstack, stack = stacks(seed=41)
    prefilled = []
    orig = E.PagedServingEngine._prefill_join

    def logged(self, s, r, *a):
        prefilled.append((r.id, r._preemptions))
        return orig(self, s, r, *a)

    monkeypatch.setattr(E.PagedServingEngine, "_prefill_join", logged)
    eng, reqs, cold, specs = _preempt_scenario(stack, spec_k)
    assert all(r.result(5).ok for r in reqs)
    m = eng.metrics
    assert m.preemptions >= 1 and m.resumes == m.preemptions
    assert m.replay_tokens > 0
    assert all(n == 0 for _, n in prefilled), prefilled
    assert cold == 2 and eng.prefill_count == len(specs) == 6
    twin = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                         paged=True, page_size=4, num_pages=48,
                         spec_k=spec_k or None)
    want = tokens(_serve(twin, _reqs(specs)))
    assert tokens(reqs) == want == jax_tokens(jstack, specs, num_slots=2)
    snap = m.snapshot()["slo"]
    assert snap["preemptions"] == snap["resumes"] == m.preemptions
    _no_leak(eng)


def test_parked_prefix_survives_trie_pressure():
    """A trie of capacity 1 evicts its least recent terminal at every
    insert, but not a parked one: the resumes still attach."""
    _, stack = stacks(seed=41)
    eng, reqs, cold, specs = _preempt_scenario(stack, 0, prefix_capacity=1)
    assert all(r.result(5).ok for r in reqs)
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.resumes == eng.metrics.preemptions
    assert eng.prefill_count == len(specs)
    _no_leak(eng)


def test_preempt_during_spec_replay():
    """A second preemption lands while the resumed request still replays
    its delivered tokens through the spec stepper: the replay count
    re-arms to the full delivered length and the tokens equal an
    unpreempted twin's."""
    _, stack = stacks(seed=51)
    kw = dict(paged=True, page_size=4, num_pages=48, spec_k=2, device="cpu")
    eng = ServingEngine(*stack, num_slots=2, max_len=32, **kw)
    spec = None
    for seed in range(52, 64):   # a prompt that never hits eos early
        p, m, _ = _specs(seed, 1, pmin=5, pmax=8)[0]
        cand = Request(p.copy(), m, max_new_tokens=8, eos_id=1)
        if len(_eager(stack, cand)) >= 8:
            spec = [(p, m, 8)]
            break
    assert spec is not None
    r = _reqs(spec, slo="batch")[0]
    sched = ShapingScheduler(max_queue=8, metrics=eng.metrics)
    sched.submit(r)
    while len(r.tokens) < 5:
        eng.run_iteration(sched)
    assert eng.can_preempt(r.slot)
    assert eng.preempt_slot(r.slot, eng.clock()) is r
    assert r._replay == len(r.tokens) > 0
    sched.requeue_preempted(r)
    eng.run_iteration(sched)                 # the resume attaches
    assert r.slot is not None
    while r._replay == 0 or r.state != "RUNNING":
        eng.run_iteration(sched)
        assert r.state != "DONE", "finished before a mid-replay preempt"
    n_before = len(r.tokens)
    assert eng.preempt_slot(r.slot, eng.clock()) is r
    assert r._replay == n_before             # re-armed to the full count
    sched.requeue_preempted(r)
    eng.serve_until_idle(sched, max_iterations=2000)
    assert r.result(5).ok and r._preemptions == 2
    twin = ServingEngine(*stack, num_slots=2, max_len=32, **kw)
    assert tokens([r]) == tokens(_serve(twin, _reqs(spec)))
    assert eng.metrics.resumes == eng.metrics.preemptions == 2
    assert eng.prefill_count == 1
    _no_leak(eng)


def test_replay_divergence_fails_the_request():
    """A resumed request whose re-decoded token differs from the one its
    caller holds fails with ReplayDiverged and keeps its delivered tokens;
    no page leaks and the pool serves on."""
    _, stack = stacks(seed=51)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=48)
    r = _reqs([(p, m, 10) for p, m, _ in _specs(53, 1, pmin=5, pmax=8)],
              slo="batch")[0]
    sched = ShapingScheduler(max_queue=8, metrics=eng.metrics)
    sched.submit(r)
    while len(r.tokens) < 4:
        eng.run_iteration(sched)
        assert r.state != "DONE"
    assert eng.preempt_slot(r.slot, eng.clock()) is r
    r.tokens[2] = (r.tokens[2] + 1) % V      # plant a mismatch
    held = list(r.tokens)
    sched.requeue_preempted(r)
    eng.serve_until_idle(sched, max_iterations=200)
    res = r.result(5)
    assert res.finish_reason == "error"
    assert isinstance(res.error, ReplayDiverged)
    assert "position 2" in str(res.error)
    assert list(res.tokens) == held
    assert eng.metrics.replay_tokens == 2
    assert eng.metrics.last_error["where"] == "replay"
    assert eng.metrics.last_error["type"] == "ReplayDiverged"
    _no_leak(eng)
    clean = _serve(eng, _reqs(_specs(54, 1)))
    np.testing.assert_array_equal(clean[0].result(5).tokens,
                                  _eager(stack, clean[0]))


@pytest.mark.parametrize("spec_k", [0, 4])
def test_shaping_policy_matches_jax_engine(spec_k):
    """The preemption scenario under both engines, each with its own
    ShapingScheduler on a frozen clock: the same requests are admitted in
    the same order, the same slots lose to the same victims, and every
    request is preempted as often."""
    jstack, stack = stacks(seed=41)
    bspecs = [(p, m, 12) for p, m, _ in _specs(42, 3, pmin=4, pmax=8)]
    ispecs = _specs(43, 3, pmin=1, pmax=4, nmax=6)

    def run(mod, eng):
        clk = FakeClock()
        sched = mod.ShapingScheduler(max_queue=32, clock=clk,
                                     metrics=eng.metrics)
        reqs = [mod.Request(p.copy(), m, max_new_tokens=n, eos_id=1,
                            slo=slo)
                for specs, slo in ((bspecs, "batch"),
                                   (ispecs, "interactive"))
                for p, m, n in specs]
        name = {id(r): i for i, r in enumerate(reqs)}
        log = []
        pop, pick = sched.pop_ready, sched.pick_preempt_victim

        def pop_ready(now=None, on_dead=None):
            r = pop(now, on_dead)
            log.append(("pop", None if r is None else name[id(r)]))
            return r

        def pick_preempt_victim(engine, now):
            s = pick(engine, now)
            log.append(("victim", None if s is None
                        else name[id(engine.slots[s])]))
            return s

        sched.pop_ready, sched.pick_preempt_victim = \
            pop_ready, pick_preempt_victim
        for r in reqs[:3]:
            sched.submit(r)
        for _ in range(2):
            eng.run_iteration(sched)
        for r in reqs[3:]:
            sched.submit(r)
        eng.serve_until_idle(sched, max_iterations=5000)
        return (log, [r._preemptions for r in reqs],
                [list(r.result(5).tokens) for r in reqs])

    kw = dict(num_slots=2, max_len=32, paged=True, page_size=4,
              num_pages=48, spec_k=spec_k or None)
    jlog, jn, jtoks = run(jserving, JServingEngine(*jstack, **kw))
    log, n, toks = run(tserving, ServingEngine(*stack, device="cpu", **kw))
    assert ("victim", None) != log[0] and sum(n) >= 1
    assert log == jlog and n == jn and toks == jtoks


def test_dense_pool_does_not_preempt():
    _, stack = stacks(seed=41)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu")
    reqs = _reqs(_specs(42, 2, pmin=4, pmax=8), slo="batch")
    sched = ShapingScheduler(max_queue=8)
    _serve(eng, reqs[:1], sched)
    assert not eng.can_preempt(0) and eng.preempt_slot(0, 0.0) is None


# ---- the scheduler (no engine) ----------------------------------------

def _tiny(tenant=None, slo=None, P=4, n=4):
    return Request(np.zeros(P, np.int32), None, max_new_tokens=n, eos_id=1,
                   adapter=tenant, slo=slo)


def test_class_priority_and_deadline_order():
    clk = FakeClock()
    sched = ShapingScheduler(max_queue=16, clock=clk)
    b1 = sched.submit(_tiny(slo="batch"))
    clk.advance(0.1)
    b2 = sched.submit(_tiny(slo="batch"))
    clk.advance(0.1)
    i1 = sched.submit(_tiny(slo="interactive"))
    assert sched.depth() == 3
    assert sched.pop_ready(clk()) is i1
    assert sched.pop_ready(clk()) is b1
    assert sched.pop_ready(clk()) is b2
    assert sched.pop_ready(clk()) is None
    assert b1.slo is BATCH and i1.slo is INTERACTIVE
    with pytest.raises(ValueError, match="unknown SLO class"):
        sched.submit(_tiny(slo="gold"))


def test_wfq_weights_and_lag():
    clk = FakeClock()
    sched = ShapingScheduler(max_queue=64, clock=clk,
                             tenant_weights={"a": 2.0, "b": 1.0})
    for _ in range(6):
        sched.submit(_tiny(tenant="a", slo="batch"))
        sched.submit(_tiny(tenant="b", slo="batch"))
    order = [sched.pop_ready(clk()).adapter for _ in range(9)]
    assert order.count("a") == 6 and order.count("b") == 3, order
    lag = sched.wfq_lag_by_tenant()
    assert lag["b"] >= lag["a"] >= 0.0
    r = sched.pop_ready(clk())
    sched.push_front(r)
    assert sched.pop_ready(clk()) is r
    order.append(r.adapter)
    while True:
        nxt = sched.pop_ready(clk())
        if nxt is None:
            break
        order.append(nxt.adapter)
    assert order.count("a") == 6 and order.count("b") == 6
    lag = sched.wfq_lag_by_tenant()
    assert lag.get("b", 0.0) > lag.get("a", 0.0) == 0.0


def test_admission_gates_and_drain():
    """Batch admission closes above the memory watermark or below
    `min_goodput`; interactive keeps flowing. Drain closes everything;
    abort_queued empties in shaping order."""
    m = ServingMetrics()
    m.set_memory_provider(lambda: None, budget_bytes=100, watermark_frac=0.9)
    clk = FakeClock()
    sched = ShapingScheduler(max_queue=16, clock=clk, metrics=m)
    assert m.check_memory_watermark(95) and m.watermark_exceeded()
    with pytest.raises(QueueFull, match="admission gated"):
        sched.submit(_tiny(slo="batch"))
    i1 = sched.submit(_tiny(slo="interactive"))
    m.check_memory_watermark(10)
    b1 = sched.submit(_tiny(slo="batch"))
    assert sched.depth() == 2 and m.watermark_warnings == 1
    m.record_finish("error", 9)
    m.record_finish("length", 1)
    gated = ShapingScheduler(max_queue=4, clock=clk, metrics=m,
                             min_goodput=0.5)
    with pytest.raises(QueueFull, match="admission gated"):
        gated.submit(_tiny(slo="batch"))
    gated.submit(_tiny(slo="interactive"))
    sched.drain()
    with pytest.raises(RuntimeError, match="draining"):
        sched.submit(_tiny(slo="interactive"))
    dead = sched.abort_queued("shutdown", clk())
    assert dead == [i1, b1]
    assert all(r.finish_reason == "shutdown" for r in dead)


def test_queue_full_and_pop_all():
    clk = FakeClock()
    sched = ShapingScheduler(max_queue=2, clock=clk)
    a = sched.submit(_tiny(tenant="x", slo="batch"))
    b = sched.submit(_tiny(tenant="y", slo="interactive"))
    with pytest.raises(QueueFull, match="high-water"):
        sched.submit(_tiny(slo="batch"))
    assert set(sched.pop_all()) == {a, b} and sched.depth() == 0


def _shaping_ops(seed, n=120):
    """A seeded sequence of scheduler operations on a fake clock."""
    rs = np.random.RandomState(seed)
    kinds = ["submit", "pop", "push_front", "requeue", "victim", "cancel",
             "advance", "pressure", "finish"]
    ops = []
    for _ in range(n):
        k = kinds[rs.choice(len(kinds), p=[.28, .24, .05, .07, .12, .04, .1,
                                           .05, .05])]
        if k == "submit":
            ops.append((k, ["a", "b", None][rs.randint(3)],
                        ["interactive", "batch", None, "gold"][
                            rs.choice(4, p=[.35, .5, .1, .05])],
                        int(rs.randint(1, 40)), int(rs.randint(1, 30)),
                        None if rs.rand() < .8 else float(rs.rand())))
        elif k == "victim":
            ops.append((k, [bool(x) for x in rs.rand(4) < .8],
                        [int(x) for x in rs.randint(0, 6, 4)],
                        [int(x) for x in rs.randint(0, 1000, 4)]))
        elif k == "cancel":
            ops.append((k, int(rs.randint(1000))))
        elif k == "advance":
            ops.append((k, float(rs.rand() * 0.6)))
        elif k == "pressure":
            ops.append((k, int(rs.randint(60, 100))))
        elif k == "finish":
            ops.append((k, ["error", "length"][rs.randint(2)],
                        int(rs.randint(1, 9))))
        else:
            ops.append((k,))
    return ops + [("drain",), ("submit", "a", "interactive", 3, 3, None),
                  ("pop",), ("pop",)]


class _SlotsView:
    """The two engine members `pick_preempt_victim` reads."""

    def __init__(self, slots, can):
        self.slots, self._can = slots, can

    def can_preempt(self, s):
        return self._can[s]


def _shaping_trace(mod, ops, **kw):
    """Run `ops` through `mod`'s ShapingScheduler (the port's serving
    package or the JAX one's): what each op observed, requests named by
    their submit order, then the queue that `abort_queued` empties."""
    clk = FakeClock()
    m = mod.ServingMetrics(clock=clk)
    m.set_memory_provider(lambda: None, budget_bytes=100,
                          watermark_frac=0.9)
    sched = mod.ShapingScheduler(max_queue=12, clock=clk, metrics=m, **kw)
    reqs, held, dead, out = [], [], [], []
    name = {}
    for op, *a in ops:
        got = None
        if op == "submit":
            tenant, slo, P, n, dl = a
            r = mod.Request(np.zeros(P, np.int32), None, max_new_tokens=n,
                            eos_id=1, adapter=tenant, slo=slo,
                            deadline=None if dl is None else clk() + dl)
            name[id(r)] = len(reqs)
            reqs.append(r)
            try:
                sched.submit(r)
                got = "queued"
            except Exception as e:   # QueueFull, draining, unknown class
                got = (type(e).__name__, str(e))
        elif op == "pop":
            r = sched.pop_ready(clk(), on_dead=lambda d: dead.append(
                (name[id(d)], d.finish_reason)))
            if r is not None:
                held.append(r)
            got = None if r is None else name[id(r)]
        elif op == "push_front" and held:
            got = name[id(held[-1])]
            sched.push_front(held.pop())
        elif op == "requeue" and held:
            r = held.pop(0)
            r._preemptions += 1
            sched.requeue_preempted(r)
            got = name[id(r)]
        elif op == "victim":
            can, ntok, pick = a
            slots = [held[i % len(held)] if held and i % 3 else None
                     for i in pick]
            for r, k in zip(slots, ntok):
                if r is not None:
                    r.tokens = [0] * k
            s = sched.pick_preempt_victim(_SlotsView(slots, can), clk())
            got = None if s is None else name[id(slots[s])]
        elif op == "cancel" and reqs:
            reqs[a[0] % len(reqs)].cancel()
        elif op == "advance":
            clk.advance(a[0])
        elif op == "pressure":
            got = m.check_memory_watermark(a[0])
        elif op == "finish":
            m.record_finish(*a)
        elif op == "drain":
            sched.drain()
        out.append((op, got, sched.depth(),
                    sorted(sched.wfq_lag_by_tenant().items()),
                    list(dead)))
    out.append([(name[id(r)], r.finish_reason)
                for r in sched.abort_queued("shutdown", clk())])
    return out


@pytest.mark.parametrize("seed", [0, 5, 6])
@pytest.mark.parametrize("kw", [
    {}, dict(tenant_weights={"a": 3.0, "b": 1.0}, max_preemptions=1),
    dict(min_goodput=0.6, default_class="interactive")],
    ids=["default", "weighted", "goodput_gate"])
def test_shaping_scheduler_matches_jax(seed, kw):
    """The same operations on one fake clock give the JAX
    ShapingScheduler's pops (class rank, deadline, WFQ), dead requests,
    victims, wfq_lag_by_tenant, queue depth and gate decisions exactly
    (both are float64 Python: no tolerance)."""
    ops = _shaping_ops(seed)
    want = _shaping_trace(jserving, ops, **kw)
    got = _shaping_trace(tserving, ops, **kw)
    assert got == want
    # each sequence pops, requeues, names a victim, gates a submit and
    # finalizes a request that died in the queue
    kinds = {(op, g is not None) for op, g, *_ in want[:-1]}
    assert {("pop", True), ("victim", True), ("requeue", True)} <= kinds
    assert any(op == "submit" and "gated" in str(g)
               for op, g, *_ in want[:-1])
    assert want[-2][4]


# ---- metrics ---------------------------------------------------------

def _ledger():
    return {"weights_bytes": 8, "pool_bytes": 8, "adapter_bytes": 0,
            "in_use_bytes": 16}


def test_metrics_reset_keeps_identity():
    m = ServingMetrics()
    called = []
    m.set_memory_provider(lambda: called.append(1) or _ledger(),
                          budget_bytes=1000)
    m.record_submit()
    m.record_preemption()
    m.record_chunk()
    m.record_slo_finish("interactive", 0.1, 0.05, 0.5, 0.1)
    snap = m.snapshot()
    assert snap["requests"]["submitted"] == 1
    assert snap["slo"]["preemptions"] == 1
    m.reset()
    snap = m.snapshot()
    assert snap["requests"]["submitted"] == 0 and "slo" not in snap
    assert snap["memory"]["budget_bytes"] == 1000 and called


def test_snapshot_keys_are_documented():
    """A snapshot with every section recorded flattens to exactly the
    keys of SNAPSHOT_DOCS, and the slo section has the JAX keys."""
    m = ServingMetrics()
    m.set_memory_provider(_ledger, budget_bytes=64)
    m.record_error("x", ValueError("y"))
    m.record_retry("decode_step", 2)
    m.record_token("base")
    m.record_iteration(1, 0.5, pages_in_use=1, pages_free=2,
                       bytes_per_active_token=3.0, trie_nodes=1,
                       trie_pages=1, tenant_slots={"base": 1})
    m.record_prefix("whole", 4, 4)
    m.record_spec_step(1, 3, 2, 0.001, 0.002, k_eff=4, variant="dense")
    m.record_chunked_join()
    m.record_chunk()
    m.record_preemption()
    m.record_resume()
    m.record_replay_token()
    m.record_step_gap(0.01)
    m.record_slo_finish("interactive", 0.1, 0.05, 0.5, 0.1)
    m.record_slo_finish("batch", 5.0, 0.5, 30.0, 1.0)
    m.set_wfq_lag({"base": 12.5})
    flat = flatten_snapshot(m.snapshot())
    assert set(flat) == set(SNAPSHOT_DOCS), \
        set(flat) ^ set(SNAPSHOT_DOCS)
    assert {k for k in flat if k.startswith("slo.")} == {
        "slo.preemptions", "slo.resumes", "slo.replay_tokens",
        "slo.chunked_prefills", "slo.chunks", "slo.ttft_attainment",
        "slo.tpot_attainment", "slo.wfq_lag_by_tenant"}
    assert flat["slo.ttft_attainment"] == {"interactive": 1.0, "batch": 1.0}
    assert flat["slo.wfq_lag_by_tenant"] == {"base": 12.5}


def test_engine_budget_arms_the_watermark_gate():
    """`hbm_budget_bytes` below the engine's footprint: the iteration's
    ledger check crosses the watermark once, and a ShapingScheduler on
    the engine's metrics then refuses batch-class work."""
    _, stack = stacks(seed=61)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        hbm_budget_bytes=1024, hbm_watermark=0.5)
    sched = ShapingScheduler(max_queue=8, metrics=eng.metrics)
    _serve(eng, _reqs(_specs(63, 2), slo="interactive"), sched)
    assert eng.metrics.watermark_exceeded()
    snap = eng.metrics.snapshot()["memory"]
    assert snap["budget_bytes"] == 1024 and snap["watermark_warnings"] == 1
    with pytest.raises(QueueFull, match="admission gated"):
        sched.submit(_reqs(_specs(64, 1), slo="batch")[0])


def test_engine_records_slo_attainment():
    _, stack = stacks(seed=61)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu")
    sched = ShapingScheduler(max_queue=8, metrics=eng.metrics)
    _serve(eng, _reqs(_specs(62, 2), slo="interactive"), sched)
    snap = eng.metrics.snapshot()
    att = snap["slo"]["ttft_attainment"]
    assert "interactive" in att and 0.0 <= att["interactive"] <= 1.0
    assert snap["slo"]["preemptions"] == 0


# ---- the server ------------------------------------------------------

def test_server_scheduler_and_slo_passthrough():
    """`ServingServer(eng, scheduler=ShapingScheduler(...))` runs the
    shaping policy on the server's loop; `submit(slo=, spec=)` reaches the
    Request; the FIFO stays the default."""
    _, stack = stacks(seed=91)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        prefill_chunk=4)
    sched = ShapingScheduler(max_queue=16, metrics=eng.metrics)
    server = ServingServer(eng, scheduler=sched)
    assert server.scheduler is sched
    try:
        specs = _specs(92, 4, pmin=2, pmax=10)
        reqs = [server.submit(p.copy(), m, max_new_tokens=n, eos_id=1,
                              spec=bool(i % 2),
                              slo="interactive" if i % 2 else "batch")
                for i, (p, m, n) in enumerate(specs)]
        assert all(r.result(timeout=60).ok for r in reqs)
        assert [r.slo.name for r in reqs] == ["batch", "interactive"] * 2
        assert [r.spec for r in reqs] == [False, True] * 2
        for r in reqs:
            np.testing.assert_array_equal(r.result().tokens, _eager(stack, r))
        with pytest.raises(ValueError, match="unknown SLO class"):
            server.submit(specs[0][0].copy(), specs[0][1], max_new_tokens=2,
                          eos_id=1, slo="platinum")
        assert eng.metrics.chunked_prefills >= 1
    finally:
        server.shutdown(drain=True, timeout=60)
    fifo = ServingServer(eng, start=False)
    assert isinstance(fifo.scheduler, Scheduler)
    assert not isinstance(fifo.scheduler, ShapingScheduler)
