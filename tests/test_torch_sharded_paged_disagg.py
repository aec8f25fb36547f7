"""The port's sharded paged pool, disaggregated prefill and chaos cells
against the JAX package's, on the CPU (the rest of
`tests/test_serving_sharded.py`; the dense cases are in
`test_torch_sharded_serving.py`, whose helpers this module uses).

The port's ranks (gloo, 4 processes) run `ShardedServingEngine` on
dp2 x tp2 while this process runs the JAX engine on 4 of its 8 CPU
devices. Limits: tokens and finish reasons equal request for request on
every rank (float32), the prefix-cache counters equal the JAX engine's,
and the pools are leak-free after every drain (the page allocator back
to all free, no pending slot, no occupied slot).
"""
import jax
import numpy as np
import pytest

from paddle_tpu.parallel import init_mesh as jax_init_mesh
from paddle_tpu.serving import ShardedServingEngine as JShardedEngine

import _torch_dist_ranks as R
from test_torch_sharded_serving import (D, V, SPEC_KEYS, assert_same,
                                        jax_serve, jax_stack, rank_spec,
                                        requests)

PREFIX_KEYS = ("whole_hits", "partial_hits", "misses", "cow_copies")
MESH = {"dp": 2, "tp": 2}


@pytest.fixture(scope="module")
def pool():
    p = R.RankPool(4)
    yield p
    p.close()


def jax_mesh():
    return jax_init_mesh(dp=2, tp=2, devices=jax.devices()[:4])


@pytest.mark.parametrize("spec_k", [None, 4], ids=["paged", "paged_spec"])
def test_sharded_paged_prefix_hits_and_leak_free_pools(pool, spec_k):
    """The paged pool on dp2 x tp2: the pages and slot rows whole on every
    rank (every join, prefix attach and copy-on-write runs on each), the
    steps on each rank's shard; repeated prompts ride the prefix cache;
    the tokens and prefix counters are the JAX sharded paged engine's
    and every rank's allocator drains back to all free."""
    stack = jax_stack(61)
    protos = requests(62, 5, pmax=6, nmax=6)
    reqs = [protos[i % len(protos)] for i in range(10)]
    kw = dict(num_slots=4, max_len=32, paged=True, page_size=8,
              spec_k=spec_k)
    task = pool.submit(4, "sharded_serve", rank_spec(stack, reqs, MESH, kw,
                                                     waves=[4, 3, 3]))
    jeng = JShardedEngine(*stack, mesh=jax_mesh(), **kw)
    want, jsnap, jeng = jax_serve(jeng, reqs, waves=[4, 3, 3])
    got = pool.collect(task)
    sections = [("prefix", PREFIX_KEYS)]
    if spec_k:
        sections.append(("speculation", SPEC_KEYS))
    assert_same(got, want, jsnap, jeng, sections)
    assert got[0]["prefix"]["whole_hits"] >= 4
    for g in got:
        assert g["pages_free"][0] == g["pages_free"][1]


def test_disaggregated_prefill_and_batched_splice(pool):
    """prefill="disaggregated" on dp2 x tp2: dp row 1 prefills (its own
    weight blocks), dp row 0 decodes; a four-request burst in one prompt
    bucket lands through one ("bsplice", Pb, 4) program. Tokens equal the
    JAX engine's; the sharding section carries both phases; nothing
    stays pending."""
    stack = jax_stack(97)
    rs = np.random.RandomState(98)
    burst = []
    for _ in range(4):
        P = int(rs.randint(3, 5))                     # bucket 4
        prompt = rs.randint(2, V, (P,)).astype(np.int32)
        prompt[0] = 0
        burst.append((prompt, rs.randn(4, D).astype(np.float32), 6, None))
    reqs = burst + requests(99, 4)
    kw = dict(num_slots=2, max_len=32, prefill="disaggregated",
              max_joins_per_iter=4)
    task = pool.submit(4, "sharded_serve", rank_spec(stack, reqs, MESH, kw))
    want, jsnap, _ = jax_serve(JShardedEngine(*stack, mesh=jax_mesh(), **kw),
                               reqs)
    got = pool.collect(task)
    for g in got:
        assert g["results"] == want
        assert g["pending"] == 0 and g["occupancy"] == 0
    dec = [g for g in got if g["decodes"]]
    pre = [g for g in got if not g["decodes"]]
    assert len(dec) == 2 and len(pre) == 2
    assert any(k.startswith("('prefill'") for k in pre[0]["trace_keys"])
    bs = [k for k in dec[0]["trace_keys"] if k.startswith("('bsplice'")]
    assert bs and all(k.endswith((", 2)", ", 4)")) for k in bs)
    sh = dec[0]["sharding"]
    assert sh["prefill_step_ms"]["n"] == len(reqs) == \
        jsnap["sharding"]["prefill_step_ms"]["n"]
    assert sh["decode_step_ms"]["n"] > 0
    assert sh["collective_events"] >= 2
    assert 0.0 <= sh["collective_time_share"] <= 1.0
    assert dec[0]["weights_bytes"] == jsnap["memory"]["weights_bytes"]


CHAOS = {
    # a transient join fault is retried through
    "slot_join": dict(kw=dict(num_slots=4, max_len=32, backoff_base_s=0.0),
                      plans=[("serving.slot_join", {"on": "nth", "n": 1})]),
    # a persistent decode fault evicts every in-flight request with its
    # cause; the pool revives without a second first run
    "decode_step": dict(kw=dict(num_slots=4, max_len=32,
                                backoff_base_s=0.0),
                        plans=[("serving.decode_step",
                                {"action": "raise", "max_fires": 3})],
                        iters=4),
    # a failed splice fails its own request only
    "prefill_splice": dict(kw=dict(num_slots=2, max_len=32,
                                   prefill="disaggregated"),
                           plans=[("serving.prefill_splice",
                                   {"on": "nth", "n": 1})]),
    # join faults on the sharded paged pool leak no page
    "paged_slot_join": dict(kw=dict(num_slots=4, max_len=32, paged=True,
                                    page_size=8, backoff_base_s=0.0),
                            plans=[("serving.slot_join",
                                    {"on": "every", "k": 3})]),
}


@pytest.mark.parametrize("cell", sorted(CHAOS))
def test_chaos_cells_stay_replicated_and_leak_free(pool, cell):
    """The chaos cells on the sharded engines: a warm request, the fault
    cell, then a revival request. Every rank ends each phase alike;
    requests that were not failed by the cell serve the JAX engine's
    fault-free tokens; no slot, pending splice or page leaks, and no
    program key runs a second first run."""
    c = CHAOS[cell]
    stack = jax_stack(81)
    warm, cell_reqs, revive = (requests(82, 1), requests(83, 3),
                               requests(84, 1))
    phases = [(warm, [], None), (cell_reqs, c["plans"], c.get("iters")),
              (revive, [], None)]
    task = pool.submit(4, "sharded_chaos", rank_spec(
        stack, None, MESH, c["kw"], phases=phases))
    want, _, _ = jax_serve(JShardedEngine(*stack, mesh=jax_mesh(),
                                          **c["kw"]),
                           warm + cell_reqs + revive)
    got = pool.collect(task)
    flat = [r for ph in got[0]["phases"] for r in ph]
    for g in got:
        assert g["phases"] == got[0]["phases"]
        assert g["pending"] == 0 and g["occupancy"] == 0
        assert g["trace_max"] == 1
        if "pages_free" in g:
            assert g["pages_free"][0] == g["pages_free"][1]
    failed = 0
    for r, w in zip(flat, want):
        if r.get("error") is not None or r.get("reason") == "error":
            failed += 1
            continue
        assert r == w
    assert flat[0] == want[0] and flat[-1] == want[-1]
    if cell == "slot_join":
        assert failed == 0 and got[0]["retries"] >= 1
    elif cell == "prefill_splice":
        assert flat[1] == {"error": "InjectedFault"} and failed == 1
    elif cell == "decode_step":
        assert failed >= 1
