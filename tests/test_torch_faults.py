"""The port's fault-injection harness and the serving engine's fault
isolation, on the CPU.

`paddle_tpu_torch.testing.faults` keeps the JAX harness's plan semantics
(nth / every-K / seeded-probabilistic / always, `max_fires`, the raise /
delay / corrupt actions, composition, removal, reset, disarmed hits that
cost one boolean read): the same plans over the same hits fire on the
same hits as the JAX package's harness, with the same payloads, messages,
counters and hit counts. The engine's six `serving.*` points fire on the
host before any mutation: an injected fault is retried under `_guarded`
(backoff, watchdog) or fails only its own request, the pool keeps
serving, and no page leaks. The two chaos cases of the JAX shaping tests
(a fault every third prefill chunk, a fault in the middle of a
preemption) run on the port: the survivors' tokens equal the port's
`generate_eager` exactly, and every page returns after a prefix flush.
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.core.bucketing import bucket_size
from paddle_tpu_torch.serving import (Request, Scheduler, ServingEngine,
                                      ShapingScheduler, WatchdogTimeout)
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.text.generation import generate_eager
from test_torch_decode import D, V, stacks

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    faults.reset()


def _drive_point(pt, n, payload=None):
    """Hit `pt` n times; (results, indices of the hits that raised)."""
    out, raised = [], []
    for i in range(n):
        try:
            out.append(pt(payload))
        except faults.InjectedFault:
            raised.append(i)
    return out, raised


# ---- plan semantics --------------------------------------------------

def _flip_tail(payload):
    return payload + b"!"


#: (plans armed on one point in install order, hits, payload)
_PARITY_PLANS = {
    "nth": ([dict(on="nth", n=3)], 10, None),
    "every": ([dict(on="every", k=4)], 13, None),
    "prob": ([dict(on="prob", p=0.3, seed=7)], 40, None),
    "prob_capped": ([dict(on="prob", p=0.5, seed=123, max_fires=5)], 40,
                    None),
    "always_capped": ([dict(on="always", max_fires=2)], 6, None),
    "every_capped": ([dict(on="every", k=2, max_fires=3)], 12, None),
    "corrupt_then_raise": ([dict(on="every", k=2, action="corrupt"),
                            dict(on="nth", n=5)], 9, b"abcdef"),
    "delay_then_raise": ([dict(on="always", action="delay", delay_s=0.0),
                          dict(on="every", k=3, max_fires=2)], 10, None),
    "custom": ([dict(on="every", k=3, action="corrupt",
                     corrupt=_flip_tail),
                dict(on="nth", n=4, exc=ValueError("boom"))], 8, b"xy"),
}


def _plan_trace(mod, name, plans, hits, payload):
    """Arm `plans` on point `name` of the harness `mod`, hit it `hits`
    times, disarm, hit once more: what every hit returned or raised, each
    injection's counters, the hit counts and the armed flag."""
    pt = mod.point(name)
    injs = [mod.inject(name, **plan) for plan in plans]
    seen = []
    try:
        for _ in range(hits):
            try:
                seen.append(("ok", pt(payload)))
            except Exception as e:
                seen.append((type(e).__name__, str(e)))
        counters = [(i.hits, i.fired) for i in injs]
        armed = mod.armed()
        for i in injs:
            i.remove()
        seen.append(("disarmed", pt(payload)))
        return (seen, counters, armed, mod.armed(),
                mod.hit_counts().get(name), name in mod.points())
    finally:
        mod.reset()


@pytest.mark.parametrize("case", sorted(_PARITY_PLANS))
def test_plans_match_the_jax_harness(case):
    """The port's harness against the JAX package's: the same plans on
    the same hits fire on the same hits (the seeded probabilistic plan
    draws the same stream), pass the same payloads, raise the same
    messages and count the same hits."""
    plans, hits, payload = _PARITY_PLANS[case]
    name = f"t.parity.{case}"
    want = _plan_trace(jfaults, name, plans, hits, payload)
    got = _plan_trace(faults, name, plans, hits, payload)
    assert got == want
    assert any(kind != "ok" or out != payload for kind, out in got[0])


@pytest.mark.parametrize("plan,n,want", [
    (dict(on="nth", n=3), 10, [2]),
    (dict(on="every", k=4), 12, [3, 7, 11]),
    (dict(on="always", max_fires=2), 6, [0, 1]),
    (dict(on="every", k=2, max_fires=2), 10, [1, 3]),
])
def test_plans_fire_on_the_planned_hits(plan, n, want):
    name = f"t.plan.{sorted(plan.items())}"
    pt = faults.point(name)
    inj = faults.inject(name, **plan)
    _, raised = _drive_point(pt, n)
    assert raised == want
    assert inj.hits == n and inj.fired == len(want)


def test_probabilistic_plan_is_seed_deterministic():
    pt = faults.point("t.prob")
    runs = []
    for _ in range(2):
        inj = faults.inject("t.prob", on="prob", p=0.3, seed=1234)
        runs.append(_drive_point(pt, 50)[1])
        inj.remove()
    assert runs[0] == runs[1] and 0 < len(runs[0]) < 50
    inj = faults.inject("t.prob", on="prob", p=0.3, seed=99)
    other = _drive_point(pt, 50)[1]
    inj.remove()
    assert other != runs[0]


def test_raise_delay_and_corrupt_actions():
    pt = faults.point("t.act")
    with faults.inject("t.act", exc=KeyError, max_fires=1):
        with pytest.raises(KeyError):
            pt()
    marker = OSError("exact instance")
    with faults.inject("t.act", exc=marker, max_fires=1):
        with pytest.raises(OSError) as ei:
            pt()
        assert ei.value is marker
    with faults.inject("t.act", action="delay", delay_s=0.05, max_fires=1):
        t0 = time.monotonic()
        pt()
        assert time.monotonic() - t0 >= 0.045
        t0 = time.monotonic()
        pt()
        assert time.monotonic() - t0 < 0.04
    data = b"hello checkpoint shard"
    with faults.inject("t.act", action="corrupt"):
        bad = pt(payload=data)
        assert bad != data and len(bad) == len(data)
        assert pt(payload=data) == bad
    with faults.inject("t.act", action="corrupt", corrupt=lambda b: b[::-1]):
        assert pt(payload=data) == data[::-1]
    assert pt(payload=data) == data
    with pytest.raises(ValueError, match="on must be one of"):
        faults.inject("t.act", on="sometimes")
    with pytest.raises(ValueError, match="action must be one of"):
        faults.inject("t.act", action="explode")


def test_injections_compose_in_install_order():
    pt = faults.point("t.compose")
    with faults.inject("t.compose", action="corrupt",
                       corrupt=lambda b: b + b"A"):
        with faults.inject("t.compose", action="corrupt",
                           corrupt=lambda b: b + b"B"):
            assert pt(payload=b"x") == b"xAB"
        assert pt(payload=b"x") == b"xA"
    assert pt(payload=b"x") == b"x" and not faults.armed()
    with faults.inject("t.compose", action="delay", delay_s=0.03):
        with faults.inject("t.compose", on="nth", n=2):
            t0 = time.monotonic()
            pt()
            assert time.monotonic() - t0 >= 0.025
            with pytest.raises(faults.InjectedFault):
                pt()


def test_reset_and_reproducible_scenarios():
    pt = faults.point("t.repro")
    faults.inject("t.repro", on="always")
    with pytest.raises(faults.InjectedFault):
        pt()
    assert faults.hit_counts().get("t.repro") == 1
    faults.reset()
    assert not faults.armed() and faults.hit_counts() == {}
    pt()

    def run():
        injs = [faults.inject("t.repro", on="every", k=3),
                faults.inject("t.repro", on="prob", p=0.4, seed=7),
                faults.inject("t.repro", on="nth", n=10)]
        raised = _drive_point(pt, 40)[1]
        fired = [i.fired for i in injs]
        for i in injs:
            i.remove()
        return raised, fired

    assert run() == run()


def test_disarmed_hits_are_invisible():
    """A disarmed hit passes the payload through, counts nothing and
    costs about one boolean read (a generous wall bound: it fails only
    when the disarmed path gains real work)."""
    pt = faults.point("t.overhead")
    payload = object()
    assert pt(payload) is payload
    assert "t.overhead" not in faults.hit_counts()
    n = 200_000
    t0 = time.monotonic()
    for _ in range(n):
        pt()
    assert time.monotonic() - t0 < 1.0


def test_the_engine_registers_its_six_points():
    assert {"serving.slot_join", "serving.prefill", "serving.pattach",
            "serving.decode_step", "serving.prefill_chunk",
            "serving.preempt"} <= set(faults.points())


# ---- the engine under faults -----------------------------------------

def _specs(seed, n, pmin=1, pmax=14, nmax=8):
    """The JAX shaping tests' request specs: (prompt, memory, budget)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        P = int(rs.randint(pmin, pmax + 1))
        prompt = rs.randint(2, V, (P,)).astype(np.int32)
        prompt[0] = 0
        mem = np.random.RandomState(int(prompt.sum()) * 131 + P).randn(
            4, D).astype("f4")
        out.append((prompt, mem, int(rs.randint(2, nmax + 1))))
    return out


def _reqs(specs, **kw):
    return [Request(p.copy(), m, max_new_tokens=n, eos_id=1, **kw)
            for p, m, n in specs]


def _eager(stack, r):
    toks, lens = generate_eager(
        *stack, torch.from_numpy(np.asarray(r.memory)[None]),
        r.prompt[None], [r.prompt.shape[0]], bos_id=0, eos_id=1,
        max_new_tokens=r.max_new_tokens,
        pad_prompt_to=bucket_size(r.prompt.shape[0]))
    return toks[0][:int(lens[0])]


def _serve(eng, reqs, sched=None):
    sched = sched or Scheduler(max_queue=len(reqs) + 8)
    for r in reqs:
        sched.submit(r)
    eng.serve_until_idle(sched, max_iterations=5000)
    return reqs


def _no_leak(eng):
    eng.flush_prefix_cache()
    eng._alloc.check()
    assert eng._alloc.pages_free == eng.num_pages


@pytest.mark.parametrize("point,paged", [
    ("serving.slot_join", False), ("serving.prefill", False),
    ("serving.decode_step", False), ("serving.prefill", True),
    ("serving.prefill_chunk", True), ("serving.decode_step", True)])
def test_one_fault_is_retried_and_serves_the_same_tokens(point, paged):
    """One injected raise at each point: the guarded retry runs the op
    again on an untouched pool (the point fires before any mutation), the
    backoff sleeps once, and every request gets the eager tokens."""
    _, stack = stacks(seed=21)
    slept = []
    kw = dict(paged=True, page_size=4, num_pages=64) if paged else {}
    eng = ServingEngine(*stack, num_slots=3, max_len=32, device="cpu",
                        prefill_chunk=8, backoff_base_s=0.02,
                        sleep=slept.append, **kw)
    reqs = _reqs(_specs(22, 5, pmin=3))
    assert {len(r.prompt) > 8 for r in reqs} == {True, False}
    with faults.inject(point, on="nth", n=1) as inj:
        _serve(eng, reqs)
        assert inj.fired == 1
    for r in reqs:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    assert eng.metrics.retries == 1 and slept == [0.02]
    if paged:
        _no_leak(eng)


def test_a_fault_on_every_attempt_fails_only_its_request():
    """slot_join raising on every attempt fails that request after
    max_attempts tries; a failed decode step ends the in-flight requests
    with their partial tokens and the rebuilt pool serves on."""
    _, stack = stacks(seed=21)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=48,
                        max_attempts=2, sleep=lambda s: None)
    reqs = _reqs(_specs(23, 3))
    with faults.inject("serving.slot_join", on="always", max_fires=2):
        _serve(eng, reqs)
    with pytest.raises(faults.InjectedFault):
        reqs[0].result(5)
    for r in reqs[1:]:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    reqs = _reqs(_specs(24, 2, nmax=6))
    with faults.inject("serving.decode_step", on="always", max_fires=2):
        _serve(eng, reqs)
    assert all(r.result(5).finish_reason == "error" for r in reqs)
    assert eng.metrics.snapshot()["goodput"]["wasted_tokens"] > 0
    _no_leak(eng)
    clean = _serve(eng, _reqs(_specs(25, 2)))
    for r in clean:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    _no_leak(eng)


def test_watchdog_fails_a_slow_attempt():
    _, stack = stacks(seed=21)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        max_attempts=1, watchdog_s=0.05)
    reqs = _reqs(_specs(26, 1))
    with faults.inject("serving.prefill", action="delay", delay_s=0.1,
                       max_fires=1):
        _serve(eng, reqs)
    with pytest.raises(WatchdogTimeout):
        reqs[0].result(5)


def test_chaos_fault_mid_chunk_sequence():
    """A raise on every third prefill chunk: each victim's future fails,
    its pages return, the chunks it finished stay in the trie, the
    survivors equal the eager tokens, and the pool revives."""
    _, stack = stacks(seed=71)
    eng = ServingEngine(*stack, num_slots=3, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=64,
                        prefill_chunk=4, max_attempts=1,
                        backoff_base_s=0.0)
    reqs = _reqs(_specs(72, 6, pmin=9, pmax=14))
    with faults.inject("serving.prefill_chunk", on="every", k=3) as inj:
        _serve(eng, reqs)
        assert inj.fired
    ok = [r for r in reqs if r.finish_reason in ("eos", "length")]
    failed = [r for r in reqs if r.finish_reason == "error"]
    assert ok and failed and len(ok) + len(failed) == len(reqs)
    for r in ok:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    _no_leak(eng)
    clean = _serve(eng, _reqs(_specs(73, 1, pmin=9, pmax=12)))
    np.testing.assert_array_equal(clean[0].result(5).tokens,
                                  _eager(stack, clean[0]))


def test_chaos_fault_mid_preemption():
    """A raise on serving.preempt leaves the victim running (the point
    fires before any mutation); the next preemption succeeds; every
    request completes with the eager tokens and no page leaks."""
    _, stack = stacks(seed=81)
    eng = ServingEngine(*stack, num_slots=2, max_len=32, device="cpu",
                        paged=True, page_size=4, num_pages=48)
    batch = _reqs([(p, m, 12) for p, m, _ in
                   _specs(82, 2, pmin=5, pmax=8)], slo="batch")
    inter = _reqs(_specs(83, 3, pmin=1, pmax=4, nmax=6), slo="interactive")
    sched = ShapingScheduler(max_queue=32, metrics=eng.metrics)
    with faults.inject("serving.preempt", on="nth", n=1,
                       max_fires=1) as inj:
        for r in batch:
            sched.submit(r)
        for _ in range(2):
            eng.run_iteration(sched)
        for r in inter:
            sched.submit(r)
        eng.serve_until_idle(sched, max_iterations=5000)
        assert inj.fired
    for r in batch + inter:
        np.testing.assert_array_equal(r.result(5).tokens, _eager(stack, r))
    assert eng.metrics.errors >= 1 and eng.metrics.preemptions >= 1
    assert eng.metrics.resumes == eng.metrics.preemptions
    _no_leak(eng)
