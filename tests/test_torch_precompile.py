"""`ServingEngine.precompile` and the AOT cache of the port, against the
JAX package's engines, on the CPU, at the `_tiny_engine` width (d_model
32, 2 heads, 2 layers, vocab 17).

The program keys a port engine readies are the JAX engine's
`_startup_programs` keys (read through `paddle_tpu.analysis.program.
engine_programs`, which compiles nothing) for the dense, paged, spec and
chunked pools. Tokens after precompile equal the JAX engine's and the
port's without precompile. The cold, warm and corrupt-then-heal sequence
of the JAX tests holds: a cold start readies every program by one first
run (serving adds none), a warm restart from the populated cache readies
them with no first run (the tracer counts only cache hits), a corrupting
fault plan on every cache read rebuilds and counts cache_errors without
touching the tokens, and the next start is warm again. The assertion that
a warm start is faster than a cold one is left to the card (chip_smoke
phase 37 (c)): on the CPU the port builds nothing.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import nn as jnn
from paddle_tpu.analysis.program import engine_programs
from paddle_tpu.nn.layer.transformer import (TransformerDecoder,
                                             TransformerDecoderLayer)
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.profiler import costs
from paddle_tpu_torch.profiler import trace as T
from paddle_tpu_torch.serving import Request, Scheduler, ServingEngine
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.tuning import table as TBL

D, H, FF, V = 32, 2, 64, 17
CASES = {
    "dense": {},
    "paged": {"paged": True, "page_size": 8},
    "spec": {"spec_k": 4},
    "chunked": {"prefill_chunk": 4},
    "chunked_paged": {"paged": True, "page_size": 4, "prefill_chunk": 8},
}


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    T.reset()
    costs.reset()
    faults.reset()
    TBL.reset()


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


@pytest.fixture(scope="module")
def stacks():
    """(JAX decoder, embed, project) and the port's copy of the weights."""
    np.random.seed(0)
    jp.seed(0)
    jdec = TransformerDecoder(TransformerDecoderLayer(D, H, FF, dropout=0.0),
                              2)
    jdec.eval()
    jemb, jproj = jnn.Embedding(V, D), jnn.Linear(D, V)
    state = [_np_state(m) for m in (jdec, jemb, jproj)]
    return (jdec, jemb, jproj), state


def _port(state, **kw):
    dec = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2)
    emb = tnn.Embedding(V, D, device="cpu")
    proj = tnn.Linear(D, V, device="cpu")
    for m, s in zip((dec, emb, proj), state):
        m.load_state_dict(from_jax_state(s))
        m.eval()
    return ServingEngine(dec, emb, proj, num_slots=4, max_len=32,
                         device="cpu", **kw)


def _requests(n=2):
    rs = np.random.RandomState(1)
    out = []
    for _ in range(n):
        prompt = rs.randint(2, V, (3,)).astype(np.int32)
        prompt[0] = 0
        out.append((prompt, rs.randn(4, D).astype("f4")))
    return out


def _serve(eng, n=1, max_new=5):
    sched = Scheduler(max_queue=8)
    reqs = [Request(p, torch.from_numpy(m), max_new_tokens=max_new,
                    eos_id=1) for p, m in _requests(n)]
    for r in reqs:
        sched.submit(r)
    eng.serve_until_idle(sched, max_iterations=300)
    assert all(r.result(timeout=10).ok for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_keys_equal_the_jax_engines(stacks, case):
    jeng = JServingEngine(*stacks[0], num_slots=4, max_len=32, **CASES[case])
    want = [k for k, _, _ in engine_programs(jeng, (4, 32),
                                             prompt_buckets=(4,))]
    eng = _port(stacks[1], **CASES[case])
    eng._ensure_state(torch.zeros(4, D))
    eng._precompile_mem = torch.zeros(4, D)
    got = [k for k, _, _ in eng._startup_programs((4,))]
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    # dense: join + step; paged: pjoin, attach, cow, pattach, pstep;
    # spec: join, draft, sstep; chunked: + cjoin
    assert len(got) == {"dense": 2, "paged": 5, "spec": 3, "chunked": 3,
                        "chunked_paged": 5}[case]
    # the cache key of a program: the JAX form
    k = got[0]
    assert eng._program_cache_key(k).endswith(f"|{k!r}")
    assert eng._program_cache_key(k).split("|")[0] == "PagedServingEngine" \
        if CASES[case].get("paged") else "ServingEngine"


def test_tokens_after_precompile_equal_jax_and_the_lazy_port(stacks,
                                                             tmp_path):
    jeng = JServingEngine(*stacks[0], num_slots=4, max_len=32)
    sched = JScheduler(max_queue=8)
    jreqs = [JRequest(p, m, max_new_tokens=5, eos_id=1)
             for p, m in _requests(2)]
    for r in jreqs:
        sched.submit(r)
    jeng.serve_until_idle(sched, max_iterations=300)
    want = [list(r.result().tokens) for r in jreqs]
    lazy = _serve(_port(stacks[1]), n=2)
    eng = _port(stacks[1])
    eng.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                   cache=str(tmp_path / "aot"))
    assert _serve(eng, n=2) == lazy == want


def test_dense_cold_then_warm_start(stacks, tmp_path):
    cache = str(tmp_path / "aot")
    eng = _port(stacks[1])
    with costs.accounting_scope() as bk:
        rep = eng.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                             cache=cache)
        # every readied program is in the cost book, analytic
        assert len(bk.keys()) == rep["programs"]
        assert {c.source for c in bk.costs()} == {"analytic"}
    assert rep["compiled"] == rep["programs"] == 2 and rep["warm"] == 0
    assert rep["loaded_from_cache"] == 0 and rep["build_failures"] == 0
    toks_cold = _serve(eng)
    # precompile ran every first run: serving added none
    assert sum(eng.trace_counts.values()) == rep["programs"]

    eng2 = _port(stacks[1])
    tr = T.start_session()
    try:
        with T.retrace_sentinel(eng2):
            rep2 = eng2.precompile((4, D), dtype="float32",
                                   prompt_buckets=(4,), cache=cache)
            toks_warm = _serve(eng2)
    finally:
        T.end_session()
    assert rep2["warm"] == 1 and rep2["compiled"] == 0
    assert rep2["loaded_from_cache"] == rep["programs"]
    assert tr.counters.get("compiles", 0) == 0
    assert tr.counters.get("precompile_cache_hits") == rep["programs"]
    assert sum(eng2.trace_counts.values()) == 0
    spans = [s for s in tr.spans() if s.name == "precompile"]
    assert len(spans) == 2 and {s.attrs["source"] for s in spans} == \
        {"cache"}
    assert toks_warm == toks_cold
    snap = eng2.metrics.snapshot()["cold_start"]
    assert snap["warm"] == 1 and snap["first_ttft_ms"] > 0
    assert set(snap) == {"time_to_ready_s", "programs", "loaded_from_cache",
                         "compiled", "cache_errors", "warm",
                         "first_ttft_ms"}


def test_paged_warm_start_with_prefix_attach(stacks, tmp_path):
    cache = str(tmp_path / "aot")
    eng = _port(stacks[1], paged=True, page_size=8)
    rep = eng.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                         cache=cache)
    # pjoin + attach + cow + pattach + pstep
    assert rep["programs"] == 5 and rep["compiled"] == 5
    toks_cold = [_serve(eng) for _ in range(2)]     # the repeat attaches
    eng2 = _port(stacks[1], paged=True, page_size=8)
    with T.retrace_sentinel(eng2):
        rep2 = eng2.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                               cache=cache)
        toks_warm = [_serve(eng2) for _ in range(2)]
    assert rep2["warm"] == 1 and rep2["loaded_from_cache"] == 5
    assert sum(eng2.trace_counts.values()) == 0
    assert toks_warm == toks_cold
    assert eng2.metrics.prefix_hits >= 1
    eng2._alloc.check()


def test_corrupt_cache_rebuilds_then_heals(stacks, tmp_path):
    """tuning.cache_load corrupting every read: each record fails its CRC,
    every program is readied fresh (cache_errors), the tokens do not move,
    and the re-stored cache makes the next start warm."""
    cache = str(tmp_path / "aot")
    eng = _port(stacks[1])
    eng.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                   cache=cache)
    toks_cold = _serve(eng)
    eng2 = _port(stacks[1])
    with faults.inject("tuning.cache_load", action="corrupt"):
        rep2 = eng2.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                               cache=cache)
        assert faults.hit_counts().get("tuning.cache_load", 0) >= 2
    assert rep2["warm"] == 0
    assert rep2["cache_errors"] == 2 and rep2["compiled"] == 2
    assert _serve(eng2) == toks_cold
    eng3 = _port(stacks[1])
    rep3 = eng3.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                           cache=cache)
    assert rep3["warm"] == 1 and rep3["loaded_from_cache"] == 2
    assert _serve(eng3) == toks_cold


def test_cache_load_raise_is_not_swallowed(stacks, tmp_path):
    cache = str(tmp_path / "aot")
    _port(stacks[1]).precompile((4, D), dtype="float32",
                                prompt_buckets=(4,), cache=cache)
    eng2 = _port(stacks[1])
    with faults.inject("tuning.cache_load", on="nth", n=1):
        with pytest.raises(faults.InjectedFault):
            eng2.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                            cache=cache)


def test_spec_engine_precompiles_the_draft_verify_pair(stacks, tmp_path):
    eng = _port(stacks[1], spec_k=4)
    rep = eng.precompile((4, D), dtype="float32", prompt_buckets=(4,),
                         cache=str(tmp_path / "aot"))
    keys = set(eng._compiled)
    assert ("join", 4) in keys
    assert any(k[0] == "draft" for k in keys)
    assert any(k[0] == "sstep" for k in keys)
    assert rep["programs"] == 3
    with T.retrace_sentinel(eng):
        _serve(eng)
    assert sum(eng.trace_counts.values()) == rep["programs"]


def test_precompile_leaves_the_pool_and_its_counters(stacks):
    """Each program runs once on a scratch pool: a live pool's rows, page
    table, allocator and metrics are as they were."""
    eng = _port(stacks[1], paged=True, page_size=8)
    sched = Scheduler(max_queue=8)
    p, m = _requests(1)[0]
    r = Request(p, torch.from_numpy(m), max_new_tokens=8, eos_id=None)
    sched.submit(r)
    eng.run_iteration(sched)
    eng.run_iteration(sched)
    before = {k: v.clone() for k, v in _flat(eng._state).items()}
    table, index = eng._table.copy(), eng._index.copy()
    free = eng._alloc.pages_free
    snap = eng.metrics.snapshot()
    ready = len(eng._compiled)
    rep = eng.precompile((4, D), dtype="float32", prompt_buckets=(4,))
    # the programs the serve ran are ready already; the rest run once
    assert ready >= 2 and rep["programs"] == 5
    assert rep["compiled"] == 5 - ready
    after = _flat(eng._state)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert (eng._table == table).all() and (eng._index == index).all()
    assert eng._alloc.pages_free == free
    snap2 = eng.metrics.snapshot()
    for key in ("joins", "tokens_out", "iterations", "requests"):
        assert snap2[key] == snap[key]
    eng.serve_until_idle(sched, max_iterations=100)
    assert r.result(timeout=5).ok and len(r.tokens) == 8


def _flat(x, path=""):
    from paddle_tpu_torch.analysis.program import _leaves

    return _leaves(x, path)
