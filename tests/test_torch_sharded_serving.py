"""The port's mesh-sharded serving against the JAX package's, on the CPU:
`ShardedServingEngine` in the "gathered" layout on dp2 x fsdp2 x tp2 (8
gloo ranks), in the "megatron" layout and with `spec_k=4` on dp2 x tp2,
multi-tenant int8 + LoRA on dp2 x tp2, the sharded-weights guard, the
validation errors, and the sharded engines' precompile (the counterparts
of `tests/test_serving_sharded.py`; the paged, disaggregated and chaos
cases are in `test_torch_sharded_paged_disagg.py`).

The JAX side runs in this process on the 8 CPU devices `conftest.py`
pins, its weights made from a numpy seed; the port's side runs in gloo
ranks of `_torch_dist_ranks.RankPool` (8 processes for the module),
every rank building the engine over the JAX weights
(`convert.from_jax_state`) and serving the same requests in the same
waves. While the ranks serve, this process runs the JAX engine.

Limits. Tokens and finish reasons equal request for request on every
rank (float32; the gathered layout's column blocks and the megatron
layout's row sums leave each token's argmax where it is at these
sizes); the counters the ranks hold alike (joins, tokens, requests,
per-shard occupancy, speculation and tenancy counters) equal the JAX
engine's.
"""
import numpy as np
import pytest

import jax
from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer.transformer import (TransformerDecoder,
                                             TransformerDecoderLayer)
from paddle_tpu.parallel import init_mesh as jax_init_mesh
from paddle_tpu.serving import AdapterPool as JAdapterPool
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ShardedServingEngine as JShardedEngine

import _torch_dist_ranks as R
from _torch_parity import np_state

D, H, FF, V, L = 32, 2, 64, 32, 2
SPEC_KEYS = ("rounds", "drafts_proposed", "drafts_accepted",
             "effective_k", "k_shrink_events", "k_grow_events")
TENANCY_KEYS = ("tenants", "tokens_by_tenant", "adapter_loads",
                "adapter_evictions", "adapter_hit_rate")


@pytest.fixture(scope="module")
def pool():
    p = R.RankPool(8)
    yield p
    p.close()


def jax_stack(seed):
    np.random.seed(seed)
    dec = TransformerDecoder(TransformerDecoderLayer(D, H, FF, dropout=0.0),
                             L)
    dec.eval()
    return dec, jnn.Embedding(V, D), jnn.Linear(D, V)


def rank_spec(stack, reqs, mesh, kw, **extra):
    """What the ranks need: the weights as numpy, the requests, the
    port's mesh and engine kwargs."""
    return dict(dims=(D, H, FF, V, L), state=[np_state(m) for m in stack],
                reqs=reqs, mesh=mesh, kw=kw, **extra)


def requests(seed, n, pmax=6, nmax=10, tenants=None):
    """(prompt, memory [4, D], max_new_tokens, adapter) with ragged
    prompts of pmax tokens at most (buckets 1 .. 8)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        P = int(rs.randint(1, pmax + 1))
        prompt = rs.randint(2, V, (P,)).astype(np.int32)
        prompt[0] = 0
        out.append((prompt, rs.randn(4, D).astype(np.float32),
                    int(rs.randint(2, nmax + 1)),
                    None if tenants is None else tenants[i % len(tenants)]))
    return out


def jax_serve(eng, reqs, waves=None):
    """The JAX engine over the requests, submitted as the ranks submit
    them (`_torch_dist_ranks._serve_requests`): results and snapshot."""
    sched = JScheduler(max_queue=256)
    out = [JRequest(p, m, max_new_tokens=n, eos_id=1, adapter=a)
           for p, m, n, a in reqs]
    pending, waves, it = list(out), list(waves or [len(out)]), 0
    while pending or sched.depth() > 0 or eng.occupancy() > 0:
        if pending and it % 3 == 0:
            k = waves.pop(0) if waves else len(pending)
            for r in pending[:k]:
                sched.submit(r)
            pending = pending[k:]
        eng.run_iteration(sched)
        it += 1
        assert it < 3000
    results = []
    for r in out:
        try:
            res = r.result(timeout=5)
        except Exception as e:
            results.append({"error": type(e).__name__})
            continue
        results.append({"tokens": [int(t) for t in res.tokens],
                        "reason": res.finish_reason,
                        "error": None if res.error is None
                        else type(res.error).__name__})
    return results, eng.metrics.snapshot(), eng


def assert_same(got, want_results, jsnap, jeng, sections=()):
    """Every rank's results equal the JAX engine's, request for request;
    the leader rank's counters and program keys equal the JAX engine's
    (the union over the ranks, where the ranks run different programs)."""
    for g in got:
        assert g["results"] == want_results
        assert g["pending"] == 0 and g["occupancy"] == 0
    lead = got[0]
    for k in ("joins", "tokens_out"):
        assert lead[k] == jsnap[k], (k, lead[k], jsnap[k])
    for k in ("submitted", "completed", "failed"):
        assert lead["requests"][k] == jsnap["requests"][k], k
    assert lead["sharding"]["per_shard_occupancy"] == \
        jsnap["sharding"]["per_shard_occupancy"]
    for name, keys in sections:
        w = {k: jsnap[name][k] for k in keys}
        p = {k: lead[name][k] for k in keys}
        assert p == w, (name, p, w)
    keys = set().union(*(g["trace_keys"] for g in got))
    assert keys == set(map(repr, jeng.trace_counts)), \
        (keys, set(map(repr, jeng.trace_counts)))
    # one first run a program key on each rank (the single-trace proof)
    assert all(g["trace_max"] == 1 for g in got)


def test_gathered_dp2_fsdp2_tp2_equals_the_jax_sharded_engine(pool):
    """Ragged waves through 4 slots on the dp2 x fsdp2 x tp2 mesh: each
    rank holds its (fsdp, tp) column blocks and its dp shard of the
    slots; the tokens, counters and per-shard occupancy are the JAX
    engine's on its 8-device mesh."""
    stack = jax_stack(21)
    reqs = requests(22, 10)
    kw = dict(num_slots=4, max_len=32)
    task = pool.submit(8, "sharded_serve", rank_spec(
        stack, reqs, {"dp": 2, "fsdp": 2, "tp": 2}, kw, waves=[3, 2, 3, 2]))
    want, jsnap, jeng = jax_serve(
        JShardedEngine(*stack, mesh=jax_init_mesh(dp=2, fsdp=2, tp=2),
                       **kw), reqs, waves=[3, 2, 3, 2])
    got = pool.collect(task)
    assert_same(got, want, jsnap, jeng)
    assert sum(len(r["tokens"]) for r in want) == got[0]["tokens_out"]
    assert got[0]["weights_bytes"] == jeng.weights_bytes()


def test_sync_tok0_and_callbacks_on_dp2_equal_the_jax_sharded_engine(pool):
    """`sync_tok0 = True` (each join's token 0 synced as it returns) and a
    recording `ServingCallback` on the dp2 mesh: the tokens are the JAX
    sharded engine's under the same switch, and every rank's hooks saw
    one join a request, one token a delivered token and one finish a
    request, with the JAX engine's slots."""
    from paddle_tpu.serving import ServingCallback as JCallback

    stack = jax_stack(23)
    reqs = requests(24, 6)
    kw = dict(num_slots=4, max_len=32)
    task = pool.submit(2, "sharded_serve", rank_spec(
        stack, reqs, {"dp": 2}, kw, sync_tok0=True, record_callbacks=True))
    events = []

    class Rec(JCallback):
        def on_join(self, request, slot):
            events.append(("join", slot))

        def on_token(self, request, token):
            events.append(("token", int(token)))

        def on_finish(self, request):
            events.append(("finish", request.finish_reason))

    jeng = JShardedEngine(*stack, mesh=jax_init_mesh(
        dp=2, devices=jax.devices()[:2]), callbacks=[Rec()], **kw)
    jeng.sync_tok0 = True
    want, jsnap, jeng = jax_serve(jeng, reqs)
    got = pool.collect(task)
    assert_same(got, want, jsnap, jeng)
    for g in got:
        assert g["events"] == events
    assert [e[0] for e in events].count("finish") == len(reqs)


@pytest.mark.parametrize("case", ["megatron", "spec"])
def test_megatron_and_spec_on_dp2_tp2_equal_the_jax_sharded_engine(pool,
                                                                   case):
    """The megatron layout (row blocks' partial products summed over tp)
    and speculative decoding (draft and verify on each rank's shard,
    tokens and acceptance gathered) on dp2 x tp2."""
    stack = jax_stack(33)
    reqs = requests(34, 8, pmax=4, nmax=6)
    kw = dict(num_slots=4, max_len=32)
    kw.update({"layout": "megatron"} if case == "megatron"
              else {"spec_k": 4})
    task = pool.submit(4, "sharded_serve", rank_spec(
        stack, reqs, {"dp": 2, "tp": 2}, kw))
    mesh = jax_init_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    want, jsnap, jeng = jax_serve(JShardedEngine(*stack, mesh=mesh, **kw),
                                  reqs)
    got = pool.collect(task)
    assert_same(got, want, jsnap, jeng,
                [("speculation", SPEC_KEYS)] if case == "spec" else [])


def test_multitenant_int8_lora_on_dp2_tp2_equals_the_jax_sharded_engine(
        pool):
    """int8 weights (quantized whole, then cut with their scales: the int8
    matmul on a column block) and three LoRA tenants over two bank rows
    (loads, hits and waits), the banks whole on every rank and each
    target's B cut to its columns."""
    stack = jax_stack(41)
    reqs = requests(42, 9, tenants=[None, "t1", "t2", "t3"])
    tenants = (3, 4, {"t1": 100, "t2": 101, "t3": 102})
    kw = dict(num_slots=4, max_len=32, quantize="int8")
    task = pool.submit(4, "sharded_serve", rank_spec(
        stack, reqs, {"dp": 2, "tp": 2}, kw, tenants=tenants))
    jp = JAdapterPool(stack[0], capacity=3, rank=4)
    for name, seed in tenants[2].items():
        jp.register_random(name, seed=seed)
    mesh = jax_init_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    want, jsnap, jeng = jax_serve(
        JShardedEngine(*stack, mesh=mesh, adapters=jp, **kw), reqs)
    got = pool.collect(task)
    assert_same(got, want, jsnap, jeng, [("tenancy", TENANCY_KEYS)])


def test_sharded_weights_guard_and_validation_errors(pool):
    """A one-card engine refuses layers that `shard_layer` cut into mesh
    blocks, pointing at ShardedServingEngine, which gathers them back and
    serves the one-card tokens; the JAX engine's validation errors."""
    stack = jax_stack(55)
    reqs = requests(56, 4)
    one = pool.run(1, "sharded_serve", rank_spec(
        stack, reqs, {}, dict(num_slots=4, max_len=32)))[0]
    got = pool.run(4, "sharded_guard", rank_spec(
        stack, reqs, {"dp": 2, "tp": 2}, dict(num_slots=4, max_len=32)))
    for g in got:
        assert "ShardedServingEngine" in g["one_card"]
        assert "ShardedServingEngine" in g["one_card_paged"]
        assert g["results"] == one["results"]
    errs = pool.run(4, "sharded_validation", rank_spec(
        stack, reqs, {"dp": 1, "fsdp": 2, "tp": 2}, {}))[0]
    assert "dp >= 2" in errs["dp"]
    assert "prefill policy" in errs["policy"]
    assert "inline" in errs["paged_disaggregated"]
    assert "prefill_chunk" in errs["chunk"]
    errs = pool.run(4, "sharded_validation", rank_spec(
        stack, reqs, {"dp": 4}, {}))[0]
    assert "divisible" in errs["slots"]


@pytest.mark.parametrize("prefill", ["inline", "disaggregated"])
def test_sharded_precompile_warm_restart_runs_no_program(pool, tmp_path,
                                                         prefill):
    """precompile through an AOT cache directory: a second engine with the
    same weights, mesh, policy and layout takes every program from the
    cache (every rank agrees), runs none before it serves, and then
    serves with one first run a key at most; the cache keys carry the
    mesh geometry, the rank's place, the prefill policy and the
    layout."""
    stack = jax_stack(61)
    reqs = requests(62, 6)
    got = pool.run(4, "sharded_precompile", rank_spec(
        stack, reqs, {"dp": 2, "tp": 2},
        dict(num_slots=2 if prefill != "inline" else 4, max_len=32,
             prefill=prefill), cache=str(tmp_path)))
    one = pool.run(1, "sharded_serve", rank_spec(
        stack, reqs, {}, dict(num_slots=4, max_len=32)))[0]
    for g in got:
        assert g["cold"]["warm"] == 0 and g["cold"]["compiled"] > 0
        assert g["warm"]["warm"] == 1 and g["warm"]["compiled"] == 0
        assert g["warm"]["programs"] == g["cold"]["programs"]
        assert g["trace_after_warm"] == []
        assert g["results"] == one["results"]
        assert g["trace_max"] <= 1
        assert "|mesh2x1x2x1x1@dp" in g["fingerprint"]
        assert g["fingerprint"].endswith(f"|{prefill}|gathered")


def test_convert_carries_a_ranks_serving_blocks_across(pool):
    """`convert.from_jax_state(np_state, serving_param_rules(layout), mesh,
    fitted=True)` gives each rank of dp1 x fsdp2 x tp2 the blocks its
    sharded engine holds, in both layouts (the vocabulary of 32 splits
    over fsdp x tp, the attention and feed-forward over both axes)."""
    stack = jax_stack(71)
    got = pool.run(4, "serving_blocks", rank_spec(
        stack, [], {"dp": 1, "fsdp": 2, "tp": 2}, {}))
    for g in got:
        for layout in ("gathered", "megatron"):
            assert g[layout]["equal"], layout
            assert "embed.weight" in g[layout]["split"]
            assert "decoder.layers.0.linear1.weight" in g[layout]["split"]
