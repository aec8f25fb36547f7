"""The port's serving left-overs against the JAX package's, on the CPU
(the counterpart of `tests/test_serving.py:372` (metrics and callbacks)
and :665 (the eager fallback)).

One small model (2 decoder layers, d_model 64) built in JAX and loaded
into the port: a recording `ServingCallback` sees the JAX engine's
events in the JAX order (joins by slot, tokens, finishes, iterations),
through the scheduler and through `ServingServer` (on_submit first,
on_finish last, the stream equal to the tokens); `eager_fallback=True`
serves a request whose join fails every attempt with the JAX fallback's
tokens (and `generate_eager`'s), counted in `fallbacks`; `sync_tok0` gives
the same tokens; the `scheduler.admit` fault point rejects a submit as
in JAX; a raising hook is recorded, not raised; `to_prometheus` renders
a snapshot as the JAX function does.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingCallback as JCallback
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.metrics import to_prometheus as jprom
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.core.bucketing import bucket_size
from paddle_tpu_torch.serving import (Request, Scheduler, ServingCallback,
                                      ServingEngine, ServingServer,
                                      to_prometheus)
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.text.generation import generate_eager
from test_torch_serving import MAX_LEN, SLOTS, _requests, build_stacks

torch.set_num_threads(2)

from _torch_parity import keep_global_rng  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("keep_global_rng")


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


@pytest.fixture(autouse=True)
def _disarm_port_faults():
    yield
    faults.reset()


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.events = []

        def on_submit(self, r):
            self.events.append(("submit",))

        def on_reject(self, r, reason):
            self.events.append(("reject", reason))

        def on_join(self, r, slot):
            self.events.append(("join", slot))

        def on_token(self, r, tok):
            self.events.append(("token", int(tok)))

        def on_finish(self, r):
            self.events.append(("finish", r.finish_reason))

        def on_iteration(self, stats):
            self.events.append(("iteration", stats["queue_depth"],
                                stats["occupancy"], stats["joins"]))

    return Rec()


def _serve(eng, reqs, mk, sched):
    rs = [mk(p, m, max_new_tokens=n, eos_id=1) for p, m, n in reqs]
    for r in rs:
        sched.submit(r)
    eng.serve_until_idle(sched)
    return rs


def test_callback_events_equal_the_jax_engine(stacks):
    reqs = _requests(seed=31, n=6)
    jrec, trec = _recorder(JCallback), _recorder(ServingCallback)
    jeng = JServingEngine(*stacks[0], num_slots=SLOTS, max_len=MAX_LEN,
                          callbacks=[jrec])
    teng = ServingEngine(*stacks[1], num_slots=SLOTS, max_len=MAX_LEN,
                         callbacks=[trec], device="cpu")
    jr = _serve(jeng, reqs, JRequest, JScheduler(max_queue=64))
    tr = _serve(teng, reqs, Request, Scheduler(max_queue=64))
    assert [list(r.result().tokens) for r in tr] == \
        [list(r.result().tokens) for r in jr]
    assert trec.events == jrec.events
    kinds = [e[0] for e in trec.events]
    assert kinds.count("join") == kinds.count("finish") == len(reqs)
    assert kinds.count("token") == teng.metrics.snapshot()["tokens_out"]


def test_server_callbacks_and_stream(stacks):
    rec = _recorder(ServingCallback)
    eng = ServingEngine(*stacks[1], num_slots=2, max_len=MAX_LEN,
                        callbacks=[rec], device="cpu")
    srv = ServingServer(eng, max_queue=8)
    streamed = []
    p, m, _ = _requests(seed=41, n=1)[0]
    try:
        r = srv.submit(p, m, max_new_tokens=5, eos_id=None,
                       stream_cb=lambda req, t: streamed.append(t))
        res = r.result(timeout=30)
    finally:
        srv.shutdown(drain=True, timeout=30)
    assert res.ok and len(res.tokens) == 5
    np.testing.assert_array_equal(streamed, res.tokens)
    kinds = [e[0] for e in rec.events if e[0] != "iteration"]
    assert kinds[0] == "submit" and kinds[-1] == "finish"
    assert kinds.count("token") == 5 and "join" in kinds


def test_eager_fallback_on_persistent_join_failure(stacks):
    (p, m, _), = _requests(seed=51, n=1)
    n = 4
    got = {}
    for side in ("jax", "port"):
        if side == "jax":
            eng = JServingEngine(*stacks[0], num_slots=2, max_len=MAX_LEN,
                                 max_attempts=2, backoff_base_s=0.0,
                                 eager_fallback=True)
            r, sched = JRequest(p, m, max_new_tokens=n, eos_id=1), \
                JScheduler(max_queue=8)
            plan = jfaults.inject("serving.prefill", on="always")
        else:
            eng = ServingEngine(*stacks[1], num_slots=2, max_len=MAX_LEN,
                                max_attempts=2, backoff_base_s=0.0,
                                eager_fallback=True, device="cpu")
            r, sched = Request(p, m, max_new_tokens=n, eos_id=1), \
                Scheduler(max_queue=8)
            plan = faults.inject("serving.prefill", on="always")
        with plan:
            sched.submit(r)
            eng.serve_until_idle(sched, max_iterations=50)
        res = r.result(timeout=5)
        assert res.ok
        snap = eng.metrics.snapshot()
        got[side] = (list(res.tokens), res.finish_reason,
                     snap["errors"]["fallbacks"] if side == "jax"
                     else snap["fallbacks"], snap["requests"]["completed"])
    assert got["port"] == got["jax"]
    assert got["port"][2:] == (1, 1)
    toks, lens = generate_eager(*stacks[1], torch.from_numpy(m[None]),
                                p[None], [len(p)], eos_id=1,
                                max_new_tokens=n,
                                pad_prompt_to=bucket_size(len(p)))
    assert got["port"][0] == list(toks[0][:min(int(lens[0]), n)])
    # without the fallback the request fails with the join's fault
    eng = ServingEngine(*stacks[1], num_slots=2, max_len=MAX_LEN,
                        max_attempts=1, device="cpu")
    r, sched = Request(p, m, max_new_tokens=n, eos_id=1), \
        Scheduler(max_queue=8)
    with faults.inject("serving.prefill", on="always"):
        sched.submit(r)
        eng.serve_until_idle(sched, max_iterations=50)
    with pytest.raises(faults.InjectedFault):
        r.result(timeout=5)


def test_sync_tok0_gives_the_same_tokens(stacks):
    reqs = _requests(seed=61, n=6)
    out = []
    for sync in (False, True):
        eng = ServingEngine(*stacks[1], num_slots=SLOTS, max_len=MAX_LEN,
                            device="cpu")
        eng.sync_tok0 = sync
        rs = _serve(eng, reqs, Request, Scheduler(max_queue=64))
        out.append([list(r.result().tokens) for r in rs])
    jeng = JServingEngine(*stacks[0], num_slots=SLOTS, max_len=MAX_LEN)
    jeng.sync_tok0 = True
    jr = _serve(jeng, reqs, JRequest, JScheduler(max_queue=64))
    assert out[0] == out[1] == [list(r.result().tokens) for r in jr]


def test_admission_fault_rejects_at_submit(stacks):
    rec = _recorder(ServingCallback)
    eng = ServingEngine(*stacks[1], num_slots=1, max_len=MAX_LEN,
                        callbacks=[rec], device="cpu")
    srv = ServingServer(eng, max_queue=8, start=False)
    p, m, _ = _requests(seed=71, n=1)[0]
    with faults.inject("scheduler.admit", on="nth", n=1):
        with pytest.raises(faults.InjectedFault):
            srv.submit(p, m, max_new_tokens=3)
        srv.submit(p, m, max_new_tokens=3)       # recovered: queued
    snap = eng.metrics.snapshot()["requests"]
    assert snap["rejected"] == 1 and snap["submitted"] == 1
    assert rec.events == [("reject", "InjectedFault"), ("submit",)]
    assert srv.scheduler.depth() == 1


def test_a_raising_hook_is_recorded_not_raised(stacks):
    class Bad(ServingCallback):
        def on_token(self, r, tok):
            raise RuntimeError("consumer bug")

    eng = ServingEngine(*stacks[1], num_slots=1, max_len=MAX_LEN,
                        callbacks=[Bad()], device="cpu")
    (p, m, _), = _requests(seed=81, n=1)
    r = Request(p, m, max_new_tokens=3, eos_id=None)
    sched = Scheduler(max_queue=4)
    sched.submit(r)
    eng.serve_until_idle(sched)
    assert r.result(timeout=5).ok
    snap = eng.metrics.snapshot()
    assert snap["errors"] == 3
    assert snap["last_error"]["where"] == "callback.on_token"


def test_prometheus_rendering_matches_jax(stacks):
    from paddle_tpu.profiler import trace as JT
    from paddle_tpu_torch.profiler import trace as TT

    snap = {"requests": {"submitted": 3, "completed": 2},
            "tokens_out": 17, "queue_depth": {"n": 2, "mean": 0.5,
                                              "p50": 0.5, "p99": 1.0,
                                              "max": 1.0},
            "sharding": {"per_shard_occupancy": [0.5, 0.25]},
            "paging": None}
    jtr, ttr = JT.Tracer(), TT.Tracer()
    for tr in (jtr, ttr):
        tr.count("compiles", 3)
    assert to_prometheus(snap, tracer=ttr) == jprom(snap, tracer=jtr)
    eng = ServingEngine(*stacks[1], num_slots=2, max_len=MAX_LEN,
                        device="cpu")
    _serve(eng, _requests(seed=91, n=2), Request, Scheduler(max_queue=8))
    text = to_prometheus(eng.metrics.snapshot())
    assert "# TYPE paddle_tpu_serving_requests_submitted counter" in text
    assert 'paddle_tpu_serving_ttft_ms{stat="p50"}' in text
    assert "paddle_tpu_serving_fallbacks 0.0" in text
