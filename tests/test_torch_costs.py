"""The port's cost accounting (`paddle_tpu_torch.profiler.costs`) against
the JAX package's `profiler.costs`, on the CPU.

Exact equalities (the same float64 arithmetic on the same inputs): the
flop formulas, `mfu`, `bw_util`, the CPU roofline, `fit_report`'s MFU
on the same fit statistics, and every `cost_hint` flop count of the
serving soak's program keys and of the DecodeEngine's. The hints' bytes
are each engine's weights plus pool: the weights are the JAX engine's
byte for byte, the pools differ by the leaves the JAX pool holds and
the port's does not (the cross-attention memory rows [S, M, D]; the
pending tokens are int32 there, int64 here), which the test accounts
for leaf by leaf. No cost is labelled "xla": the port compiles no
program that could report one.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.profiler import costs as JC
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text.generation import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import Model
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.profiler import costs as C
from paddle_tpu_torch.profiler import trace as T
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.generation import DecodeEngine
from test_torch_decode import inputs, stacks as decode_stacks
from test_torch_tracing import CASES, _soak, build_stacks
from test_torch_paging import preamble_requests
from test_torch_spec import spec_requests


@pytest.fixture(autouse=True)
def _reset_port_accounting():
    yield
    T.reset()
    C.reset()


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def test_formulas_mfu_bw_and_specs_equal_jax():
    rs = np.random.RandomState(0)
    for _ in range(20):
        n, b, kv, L, h, d, m = (int(x) for x in rs.randint(1, 10**6, 7))
        assert C.transformer_decode_flops(n, b, kv, L, h, d, m) == \
            JC.transformer_decode_flops(n, b, kv, L, h, d, m)
        assert C.transformer_prefill_flops(n, b, kv, L, h, d, m) == \
            JC.transformer_prefill_flops(n, b, kv, L, h, d, m)
        f, by, dt = rs.rand() * 1e12, rs.rand() * 1e9, rs.rand()
        for spec, jspec in ((C.CPU_SPEC, JC.CPU_SPEC),):
            assert C.mfu(f, dt, spec) == JC.mfu(f, dt, jspec)
            assert C.bw_util(by, dt, spec) == JC.bw_util(by, dt, jspec)
    assert C.mfu(1.0, 0.0, C.CPU_SPEC) == 0.0
    assert C.bw_util(1.0, -1.0, C.CPU_SPEC) == 0.0
    assert C.CPU_SPEC.as_dict() == JC.CPU_SPEC.as_dict()
    assert repr(C.CPU_SPEC) == repr(JC.CPU_SPEC)
    # the card's row (NVIDIA's H100 SXM datasheet) and the CPU default
    h100 = C.DEVICE_SPECS["NVIDIA H100"]
    assert (h100.peak_flops, h100.peak_bytes_per_s, h100.hbm_bytes) == \
        (989e12, 3.35e12, 80 * 10**9)
    assert set(C.DEVICE_SPECS) == {"cpu", "NVIDIA H100"}
    assert C.detect_spec() is C.CPU_SPEC       # no card here


def _pool_leaf_gap(jeng, eng):
    """JAX pool bytes minus the port's, leaf by leaf: the JAX pool's
    memory rows (none in the port's pool) and its int32 pending tokens
    (int64 in the port's)."""
    st = jeng._state
    mem = int(np.asarray(st["mem"]).nbytes)
    tok = int(np.asarray(st["tok"]).nbytes) - \
        eng._state["tok"].numel() * eng._state["tok"].element_size()
    return mem + tok


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_hint_equals_jax_for_every_key(stacks, case):
    kw, kind = CASES[case]
    kw = dict(num_slots=4, max_len=64, **kw)
    reqs = spec_requests(seed=11, n=9) if kind == "spec" else \
        preamble_requests(13, n=9)
    jeng = JServingEngine(*stacks[0], **kw)
    _soak(jeng, reqs, jax=True, trace=False)
    eng = ServingEngine(*stacks[1], device="cpu", **kw)
    _soak(eng, reqs, jax=False, trace=False)
    assert set(eng.trace_counts) == set(jeng.trace_counts)
    assert eng.weights_bytes() == jeng.weights_bytes()
    assert eng._model_dims() == jeng._model_dims()
    gap = _pool_leaf_gap(jeng, eng)
    assert eng.pool_bytes() == jeng.pool_bytes() - gap
    for key in jeng.trace_counts:
        want, got = jeng.cost_hint(key), eng.cost_hint(key)
        assert got["flops"] == want["flops"], key
        for f in ("bytes_accessed", "argument_bytes"):
            assert got[f] == want[f] - gap, (key, f)
    assert eng.cost_hint(("nope",)) is None
    step = eng._step_cost_key()
    assert step == jeng._step_cost_key() and step in eng.trace_counts


def test_accounting_session_records_analytic_costs_and_mfu(stacks):
    """Under an armed session every program's first run is costed (the
    book's keys are the engine's trace_counts keys, as the JAX book's
    are), every cost is "analytic", and the snapshot's mfu section reads
    the step's hint against the spec; on the CPU the first-run temp
    high-water is 0."""
    kw = dict(num_slots=4, max_len=64, paged=True, page_size=8, spec_k=4)
    reqs = preamble_requests(13, n=9)
    with JC.accounting_scope(spec=JC.CPU_SPEC, capture_xla=False) as jbk:
        jeng = JServingEngine(*stacks[0], **kw)
        _soak(jeng, reqs, jax=True, trace=False)
    with C.accounting_scope(spec=C.CPU_SPEC) as bk:
        eng = ServingEngine(*stacks[1], device="cpu", **kw)
        _soak(eng, reqs, jax=False, trace=False)
        snap = eng.metrics.snapshot()
    assert C.book() is None
    assert {k for _, k in bk.keys()} == set(eng.trace_counts)
    assert {k for _, k in bk.keys()} == {k for _, k in jbk.keys()}
    assert bk.compiles == len(eng.trace_counts) == jbk.compiles
    assert {c.source for c in bk.costs()} == {"analytic"}
    for c in bk.costs():
        assert c.flops == eng.cost_hint(c.key)["flops"]
        assert c.temp_bytes == 0 and c.compile_s > 0
    rows = bk.report()
    assert [r["flops"] for r in rows] == sorted(
        (r["flops"] for r in rows), reverse=True)
    mfu = snap["mfu"]
    step = eng.cost_hint(eng._step_cost_key())
    assert mfu["cost_source"] == "analytic"
    assert mfu["device"] == C.CPU_SPEC.as_dict()
    assert mfu["flops_per_step"] == step["flops"]
    assert mfu["bytes_per_step"] == step["bytes_accessed"]
    assert 0 < mfu["model_flops_util"]["n"] <= snap["iterations"]
    assert mfu["model_flops_util"]["max"] > 0
    assert snap["memory"]["compile_temp_peak_bytes"] == 0
    with pytest.raises(RuntimeError, match="already armed"):
        with C.accounting_scope():
            C.start_accounting()


def test_first_run_counts_once_and_cost_for_materializes():
    class Owner:
        device = torch.device("cpu")

        def __init__(self):
            self.trace_counts = T.ObservedCounter(owner="Owner")

        def cost_hint(self, key):
            return {"flops": 2.0 * key[1], "bytes_accessed": 8.0}

    o = Owner()
    fn = C.first_run(o, ("k", 3), lambda x: x + 1)
    assert [fn(1), fn(2), fn(3)] == [2, 3, 4]
    assert o.trace_counts == {("k", 3): 1}
    assert C.cost_for(o, ("k", 3)) is None          # disarmed
    with C.accounting_scope(spec=C.CPU_SPEC) as bk:
        c = C.cost_for(o, ("k", 3))
        assert (c.flops, c.bytes_accessed, c.source) == (6.0, 8.0,
                                                         "analytic")
        assert bk.get("Owner", ("k", 3)) is c
        assert C.temp_high_water() == 0
    assert C.temp_high_water() == 0


def test_decode_engine_trace_counts_and_cost_hint_match_jax():
    import jax.numpy as jnp

    jstack, tstack = decode_stacks(layers=2)
    memory, prompt, plens = inputs()
    jeng, eng = JDecodeEngine(*jstack), DecodeEngine(*tstack, device="cpu")
    calls = [dict(max_new_tokens=6), dict(max_new_tokens=6, beam_size=2),
             dict(max_new_tokens=5, spec_k=3), dict(max_new_tokens=6)]
    for kw in calls:
        jeng.generate(jnp.asarray(memory), jnp.asarray(prompt),
                      jnp.asarray(plens), **kw)
        eng.generate(memory, prompt, plens, **kw)
    assert dict(eng.trace_counts) == dict(jeng.trace_counts)
    assert len(eng.trace_counts) == 3               # the repeat is warm
    for key in jeng.trace_counts:
        assert eng.cost_hint(key) == jeng.cost_hint(key), key
    assert eng.cost_hint(("short",)) is None


def test_fit_report_mfu_equals_jax_on_the_same_stats():
    net = tnn.Linear(4, 3, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    m = Model(net)
    from paddle_tpu_torch.optimizer import SGD

    m.prepare(SGD(0.1, parameters=net.parameters()), tnn.MSELoss())
    rs = np.random.RandomState(0)
    x = rs.randn(16, 4).astype(np.float32)
    y = rs.randn(16, 3).astype(np.float32)
    m.fit(TensorDataset([x, y]), batch_size=8, verbose=0)
    jm = jp.Model(jp.nn.Linear(4, 3))
    jm.fit_stats = dict(m.fit_stats)
    got = m.fit_report(flops_per_step=3.5e8, spec=C.CPU_SPEC)
    want = jm.fit_report(flops_per_step=3.5e8, spec=JC.CPU_SPEC)
    assert got == want and got["mfu"] > 0
    assert m.fit_report() == dict(m.fit_stats)
