"""The port's multi-tenant serving against the JAX package's, on the CPU.

Small model (2 decoder layers, d_model 64, 4 heads, vocab 97, 4 slots,
max_len 64), built in JAX and loaded into the port; both packages'
`AdapterPool`s draw the same adapters (`register_random`, rank 4) and
capacity 3 (two adapter rows for three tenants), so the serves load,
hit, evict and wait for rows. The port's `ServingEngine(adapters=...)`
serves the JAX engine's tokens request for request, with equal
`tenancy` counters, on the dense pool, the dense pool with `spec_k=4`
and the paged pool (equal `prefix` counters, the same prompt under two
tenants and the base never sharing a prefix), each in float32 and with
`quantize="int8"` (equal `weights_bytes` and `adapter_bytes`, the int8
weights at least 1.9x smaller). `OutOfAdapters` defers the queue head
as in JAX; re-registering a tenant drops its hot row and its prefix
subtree; the float32 factored pool serves the tokens of solo engines
whose weights hold the tenants' merged W + A @ B.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu.serving import AdapterPool as JAdapterPool
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.serving import (AdapterPool, Request, Scheduler,
                                      ServingEngine, ServingServer)
from paddle_tpu_torch.serving.adapters import decoder_lora_targets
from test_torch_serving import build_stacks
from test_torch_spec import sections_equal

torch.set_num_threads(2)
D, V, SLOTS, MAX_LEN, PSZ = 64, 97, 4, 64, 8
TENANTS = ("t1", "t2", "t3")
PREFIX_KEYS = ("whole_hits", "partial_hits", "misses", "hit_token_ratio",
               "cow_copies", "trie_nodes", "trie_pages")


def pools(jdec, tdec, capacity=3, tenants=TENANTS):
    jp = JAdapterPool(jdec, capacity=capacity, rank=4)
    tp = AdapterPool(tdec, capacity=capacity, rank=4)
    for i, name in enumerate(tenants):
        jp.register_random(name, seed=100 + i)
        tp.register_random(name, seed=100 + i)
    return jp, tp


def tenant_requests(seed=5, n=9):
    """Ragged prompts over several buckets for the base and three
    tenants, more requests than slots; the last three repeat one prompt
    and memory under t1, t2 and the base (the paged prefix-isolation
    case)."""
    rs = np.random.RandomState(seed)
    names = [None, "t1", "t2", "t1", "t3", "t2"]
    out = []
    for i in range(n - 3):
        P = int(rs.randint(1, 21))
        prompt = rs.randint(2, V, (P,)).astype(np.int32)
        prompt[0] = 0
        out.append((prompt, rs.randn(5, D).astype(np.float32),
                    int(rs.randint(2, 13)), names[i]))
    shared = rs.randint(2, V, (19,)).astype(np.int32)
    shared[0] = 0
    mem = rs.randn(5, D).astype(np.float32)
    out += [(shared, mem, 8, name) for name in ("t1", "t2", None)]
    return out


def serve(engine, reqs, jax=False):
    """(tokens per request, metrics snapshot) of a synchronous drain."""
    sched = (JScheduler if jax else Scheduler)(max_queue=64)
    R = JRequest if jax else Request
    rs = [R(p, m, max_new_tokens=n, eos_id=1, adapter=a)
          for p, m, n, a in reqs]
    for r in rs:
        sched.submit(r)
    engine.serve_until_idle(sched)
    return [list(r.result().tokens) for r in rs], engine.metrics.snapshot()


CASES = {"dense": {}, "dense_spec": {"spec_k": 4},
         "paged": {"paged": True, "page_size": PSZ}}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multitenant_engine_equals_jax_engine(case, quantize):
    (jdec, jemb, jproj), (tdec, temb, tproj) = build_stacks()
    jp, tp = pools(jdec, tdec)
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, quantize=quantize,
              **CASES[case])
    reqs = tenant_requests()
    want, jsnap = serve(JServingEngine(jdec, jemb, jproj, adapters=jp, **kw),
                        reqs, jax=True)
    eng = ServingEngine(tdec, temb, tproj, device="cpu", adapters=tp, **kw)
    got, snap = serve(eng, reqs)
    assert got == want
    sections_equal(jsnap, snap, {"tenancy": None})
    ten = snap["tenancy"]
    assert set(ten["tokens_by_tenant"]) == {"base", *TENANTS}
    assert ten["adapter_loads"] >= 4 and ten["adapter_evictions"] >= 1
    for key in ("weights_bytes", "adapter_bytes"):
        assert snap["memory"][key] == jsnap["memory"][key]
    assert snap["memory"]["adapter_bytes"] == tp.bytes() == sum(
        3 * (din + dout) * 4 * 4 for din, dout in tp._dims)
    tp.check()
    assert tp.refcount.sum() == 0
    if quantize:
        fp32 = ServingEngine(*build_stacks()[1], device="cpu",
                             num_slots=SLOTS, max_len=MAX_LEN)
        assert fp32.weights_bytes() / eng.weights_bytes() >= 1.9
    if case == "paged":
        sections_equal(jsnap, snap, {"prefix": PREFIX_KEYS})
        # the shared prompt under t1, t2 and the base: three scopes, so
        # three misses and no hit across them
        assert snap["prefix"]["misses"] == len(reqs)
        assert got[-3] != got[-2]           # the adapters differ
        eng.flush_prefix_cache()
        eng._alloc.check()
        assert eng._alloc.pages_free == eng.num_pages


def test_server_serves_tenants_and_refuses_unknown_adapters():
    (jdec, jemb, jproj), (tdec, temb, tproj) = build_stacks()
    jp, tp = pools(jdec, tdec)
    reqs = tenant_requests(seed=8)
    want, _ = serve(JServingEngine(jdec, jemb, jproj, num_slots=SLOTS,
                                   max_len=MAX_LEN, adapters=jp), reqs,
                    jax=True)
    eng = ServingEngine(tdec, temb, tproj, num_slots=SLOTS, max_len=MAX_LEN,
                        adapters=tp, device="cpu")
    server = ServingServer(eng)
    try:
        with pytest.raises(ValueError, match="not registered"):
            server.submit(reqs[0][0], reqs[0][1], adapter="nobody")
        rs = [server.submit(p, m, max_new_tokens=n, eos_id=1, adapter=a)
              for p, m, n, a in reqs]
        got = [list(r.result(timeout=60).tokens) for r in rs]
    finally:
        server.shutdown(drain=True, timeout=60)
    assert got == want
    plain = ServingEngine(*build_stacks()[1], device="cpu", num_slots=SLOTS,
                          max_len=MAX_LEN)
    with pytest.raises(ValueError, match="no AdapterPool"):
        plain.admit_check(Request(reqs[0][0], reqs[0][1], adapter="t1"))
    other = AdapterPool(build_stacks()[1][0], capacity=2, rank=4)
    with pytest.raises(ValueError, match="different decoder"):
        ServingEngine(tdec, temb, tproj, device="cpu", adapters=other)
    with pytest.raises(ValueError, match="only 'int8'"):
        ServingEngine(tdec, temb, tproj, device="cpu", quantize="int4")


def test_out_of_adapters_defers_the_queue_head_like_jax():
    """One adapter row, two tenants: the second tenant's request waits at
    the queue head (`adapter_waits`) while the first holds the row, and
    completes once it frees; iteration by iteration as in JAX."""
    (jdec, jemb, jproj), (tdec, temb, tproj) = build_stacks()
    jp, tp = pools(jdec, tdec, capacity=2, tenants=("t1", "t2"))
    reqs = tenant_requests(seed=11, n=5)[:2]
    reqs = [(p, m, n, name)
            for (p, m, n, _), name in zip(reqs, ("t1", "t2"))]
    trace = {}
    for key, eng, R, S in (
            ("jax", JServingEngine(jdec, jemb, jproj, num_slots=2,
                                   max_len=MAX_LEN, adapters=jp), JRequest,
             JScheduler),
            ("port", ServingEngine(tdec, temb, tproj, num_slots=2,
                                   max_len=MAX_LEN, adapters=tp,
                                   device="cpu"), Request, Scheduler)):
        sched = S(max_queue=8)
        rs = [R(p, m, max_new_tokens=n, eos_id=1, adapter=a)
              for p, m, n, a in reqs]
        for r in rs:
            sched.submit(r)
        states = []
        while sched.depth() > 0 or eng.occupancy() > 0:
            eng.run_iteration(sched)
            states.append((tuple(r.state for r in rs), sched.depth()))
        trace[key] = (states, [list(r.result().tokens) for r in rs],
                      eng.metrics.snapshot()["tenancy"]["adapter_waits"])
    assert trace["port"] == trace["jax"]
    states, _, waits = trace["port"]
    assert states[0] == (("RUNNING", "QUEUED"), 1) and waits >= 1
    tp.check()
    assert tp.refcount.sum() == 0


def test_reregistration_drops_hot_row_and_tenant_prefixes():
    (jdec, jemb, jproj), (tdec, temb, tproj) = build_stacks()
    jp, tp = pools(jdec, tdec, tenants=("t1",))
    prompt = np.asarray([0, 5, 9, 3, 7, 7, 2, 11, 4, 6], np.int32)
    mem = np.random.RandomState(9).randn(5, D).astype(np.float32)
    reqs = [(prompt, mem, 5, "t1")]
    res = {}
    for key, eng, pool in (
            ("jax", JServingEngine(jdec, jemb, jproj, num_slots=1,
                                   max_len=MAX_LEN, paged=True,
                                   page_size=PSZ, adapters=jp), jp),
            ("port", ServingEngine(tdec, temb, tproj, num_slots=1,
                                   max_len=MAX_LEN, paged=True,
                                   page_size=PSZ, adapters=tp,
                                   device="cpu"), tp)):
        first, _ = serve(eng, reqs, jax=key == "jax")
        again, _ = serve(eng, reqs, jax=key == "jax")
        pages_before = eng._alloc.pages_free
        pool.register_random("t1", seed=999, scale=0.2)    # new weights
        dropped = eng._alloc.pages_free - pages_before
        new, snap = serve(eng, reqs, jax=key == "jax")
        res[key] = (first, again, new, dropped, pool.loads,
                    {k: snap["prefix"][k] for k in PREFIX_KEYS})
        row = pool.acquire("t1")
        with pytest.raises(ValueError, match="pinned"):
            pool.register_random("t1", seed=7)
        pool.release(row)
        pool.check()
    assert res["port"] == res["jax"]
    first, again, new, dropped, loads, prefix = res["port"]
    assert first == again and new != first
    assert dropped > 0 and loads == 2        # subtree freed, row reloaded
    assert prefix["whole_hits"] == 1 and prefix["misses"] == 2


def test_factored_pool_equals_merged_weight_engines():
    """The float32 factored delta served by one pool gives the tokens of
    a solo engine per tenant whose target weights hold W + A @ B."""
    (jdec, _, _), stack = build_stacks()
    base = copy.deepcopy(stack)       # the same weights, before any merge
    _, tp = pools(jdec, stack[0], capacity=4)
    reqs = tenant_requests(seed=13)[:6]
    got, _ = serve(ServingEngine(*stack, num_slots=SLOTS, max_len=MAX_LEN,
                                 adapters=tp, device="cpu"), reqs)
    for name in (None, *TENANTS):
        mine = [i for i, r in enumerate(reqs) if r[3] == name]
        solo_stack = copy.deepcopy(base)
        if name is not None:
            targets = decoder_lora_targets(solo_stack[0])
            with torch.no_grad():
                for i, w in tp.merged_weights(name):
                    targets[i].weight.copy_(w)
        solo, _ = serve(ServingEngine(*solo_stack, num_slots=SLOTS,
                                      max_len=MAX_LEN, device="cpu"),
                        [reqs[i][:3] + (None,) for i in mine])
        assert mine and solo == [got[i] for i in mine], name
