"""The port's speculative decoding against the JAX package's, on the CPU.

Small model (2 decoder layers, d_model 64, 4 heads, vocab 97, 4 slots,
max_len 64), built in JAX and loaded into the port. Numpy in, numpy out:
`greedy_accept`, `ngram_propose`, `write_hist` and `rollback_index` give
the JAX functions' answers exactly; the flash-verify kernel's plain
version matches the JAX Pallas kernel in interpret mode (fp32, rtol /
atol 1e-5); the port's `ServingEngine(spec_k=...)` serves the JAX
engine's tokens request for request with equal `speculation.*` counters,
and the port's own dense engine's tokens.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.text import speculative as JSP
from paddle_tpu.text.decode import greedy_accept as j_greedy_accept
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.serving import Request, Scheduler, ServingEngine
from paddle_tpu_torch.text import speculative as TSP
from paddle_tpu_torch.text.decode import greedy_accept

torch.set_num_threads(2)
D, H, FF, V, SLOTS, MAX_LEN = 64, 4, 128, 97, 4, 64
RTOL = ATOL = 1e-5
#: the speculation counters that do not depend on wall time
SPEC_KEYS = ("rounds", "drafts_proposed", "drafts_accepted",
             "acceptance_rate", "wasted_draft_tokens", "effective_k",
             "k_shrink_events", "k_grow_events")


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def test_greedy_accept_matches_jax():
    rs = np.random.RandomState(0)
    for K in (2, 4, 6):
        preds = rs.randint(0, 5, (16, K)).astype(np.int32)
        drafts = np.where(rs.rand(16, K - 1) < 0.6, preds[:, :-1],
                          rs.randint(0, 5, (16, K - 1))).astype(np.int32)
        drafts[3] = -1                       # a force-rejected row
        want = j_greedy_accept(_j(drafts), _j(preds))
        got = greedy_accept(_t(drafts), _t(preds).long())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_propose_matches_jax(ngram):
    rs = np.random.RandomState(ngram)
    B, L = 6, 48
    period = rs.randint(2, 9, (B, 5))
    hist = np.stack([np.resize(p, L) for p in period]).astype(np.int32)
    hist[1] = rs.randint(2, 9, L)                    # no structure
    lengths = np.asarray([5, 9, 3, 16, 1, 7], np.int32)
    Pb = np.asarray([8, 16, 4, 16, 1, 8], np.int32)
    gen_len = np.asarray([10, 0, 20, 5, 30, 2], np.int32)
    pending = hist[np.arange(B), Pb + gen_len].astype(np.int32)
    pending[4] = 99                                  # never seen: no match
    for n_new in (1, 3, 5):
        want = JSP.ngram_propose(_j(hist), _j(pending), _j(lengths), _j(Pb),
                                 n_new, _j(gen_len), ngram)
        got = TSP.ngram_propose(_t(hist), _t(pending), _t(lengths), _t(Pb),
                                n_new, _t(gen_len), ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_hist_and_rollback_index_match_jax():
    rs = np.random.RandomState(1)
    hist = rs.randint(0, 50, (4, 20)).astype(np.int32)
    fed = rs.randint(0, 50, (4, 3)).astype(np.int32)
    index = np.asarray([0, 5, 17, 19], np.int32)     # the last ones clamp
    want = JSP.write_hist(_j(hist), _j(fed), _j(index))
    got = TSP.write_hist(_t(hist.copy()), _t(fed), _t(index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_match = np.asarray([0, 2, 1, 2], np.int32)
    active = np.asarray([True, True, False, True])
    want = JSP.rollback_index(_j(index + 3), 3, _j(n_match), _j(active))
    got = TSP.rollback_index(_t(index + 3), 3, _t(n_match), _t(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_flash_verify_plain_matches_jax_kernel(T, with_bias):
    """The verify kernel's plain version against the JAX Pallas kernel in
    interpret mode (grid b*h x splits = 4 x 2) and the reference: rows at
    their own offsets, splits straddling and past the written region, a
    ragged cache length (port only: the JAX kernel needs L % 128 == 0)."""
    rs = np.random.RandomState(T)
    b, h, L, d = 2, 2, 256, 16
    q = rs.randn(b, h, T, d).astype(np.float32)
    k = rs.randn(b, h, L, d).astype(np.float32)
    v = rs.randn(b, h, L, d).astype(np.float32)
    length = np.asarray([T + 3, 130], np.int32)
    bias = (rs.randn(b, L) * 0.5).astype(np.float32) if with_bias else None
    want = JA.flash_verify(_j(q), _j(k), _j(v), _j(length), _j(bias),
                           split_k=2, interpret=True)
    got = TA.flash_verify(_t(q), _t(k), _t(v), _t(length), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ref = TA.verify_attention_reference(_t(q), _t(k), _t(v), _t(length),
                                        _t(bias))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    Lr = 200                                   # a ragged last split
    got = TA.flash_verify(_t(q), _t(k[:, :, :Lr]), _t(v[:, :, :Lr]),
                          _t(length), None if bias is None else
                          _t(bias[:, :Lr]))
    want = JA.verify_attention_reference(
        _j(q), _j(k[:, :, :Lr]), _j(v[:, :, :Lr]), _j(length),
        None if bias is None else _j(bias[:, :Lr]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_verify_partials_skip_value():
    """A split wholly past a row's written length is the TPU kernel's
    exact-zero partial (acc 0, m -1e30, l 0)."""
    rs = np.random.RandomState(4)
    q, k = rs.randn(2, 1, 4, 8), rs.randn(2, 1, 300, 8)
    acc, m, l = TA._verify_partials_plain(
        _t(q).float(), _t(k).float(), _t(k).float(),
        torch.tensor([100, 300], dtype=torch.int32), None, None, 128)
    assert torch.all(acc[0, 1:] == 0) and torch.all(m[0, 1:] == -1e30)
    assert torch.all(l[0, 1:] == 0) and torch.all(l[1] > 0)


def test_verify_scope_routes_multi_token_static_kv():
    """Inside kv_verify_scope a multi-token StaticKVCache call writes at
    each row's offset and attends causally within the block: it equals
    the same tokens fed one decode step at a time."""
    rs = np.random.RandomState(2)
    B, L, T = 2, 24, 3
    mha = tnn.MultiHeadAttention(16, 2, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    mha.eval()
    x0 = torch.from_numpy(rs.randn(B, 4, 16).astype(np.float32))
    xT = torch.from_numpy(rs.randn(B, T, 16).astype(np.float32))
    with torch.inference_mode():
        outs = {}
        for mode in ("block", "steps"):
            cache = mha.gen_cache(x0, max_length=L)
            _, cache = mha(x0, None, None, None, cache)
            cache = cache._replace(index=torch.tensor([4, 9],
                                                      dtype=torch.int32))
            if mode == "block":
                with TA.kv_verify_scope():
                    out, cache = mha(xT, None, None, None, cache)
            else:
                parts = []
                for i in range(T):
                    o, cache = mha(xT[:, i:i + 1], None, None, None, cache)
                    parts.append(o)
                out = torch.cat(parts, 1)
            outs[mode] = (out, cache)
    assert outs["block"][1].index.tolist() == [4 + T, 9 + T]
    torch.testing.assert_close(outs["block"][0], outs["steps"][0],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs["block"][1].k, outs["steps"][1].k,
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def stacks():
    from test_torch_serving import build_stacks

    return build_stacks()


def spec_requests(seed=5, n=10):
    """Prompts that repeat a short seeded period (the n-gram draft's
    case), over several buckets, more requests than slots."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        period = rs.randint(2, V, int(rs.randint(3, 7)))
        prompt = np.resize(period, int(rs.randint(4, 30))).astype(np.int32)
        prompt[0] = 0
        out.append((prompt, rs.randn(5, D).astype(np.float32),
                    int(rs.randint(4, 20))))
    return out


def serve(engine, reqs, jax=False):
    """(tokens per request, metrics snapshot) of a synchronous drain."""
    sched = (JScheduler if jax else Scheduler)(max_queue=64)
    rs = [(JRequest if jax else Request)(p, m, max_new_tokens=n, eos_id=1)
          for p, m, n in reqs]
    for r in rs:
        sched.submit(r)
    engine.serve_until_idle(sched)
    return [list(r.result().tokens) for r in rs], engine.metrics.snapshot()


def sections_equal(want, got, names):
    for name, keys in names.items():
        w = {k: want[name][k] for k in keys or want[name]}
        g = {k: got[name][k] for k in keys or want[name]}
        assert g == w, f"{name}: port {g} != JAX {w}"


@pytest.mark.parametrize("spec_k", [2, 4])
def test_dense_spec_engine_equals_jax_engine(stacks, spec_k):
    reqs = spec_requests()
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, spec_k=spec_k)
    want, jsnap = serve(JServingEngine(*stacks[0], **kw), reqs, jax=True)
    got, snap = serve(ServingEngine(*stacks[1], device="cpu", **kw), reqs)
    assert got == want
    sections_equal(jsnap, snap, {"speculation": SPEC_KEYS})
    assert snap["speculation"]["drafts_accepted"] > 0
    plain, _ = serve(ServingEngine(*stacks[1], num_slots=SLOTS,
                                   max_len=MAX_LEN, device="cpu"), reqs)
    assert got == plain
    assert snap["tokens_out"] == sum(len(t) for t in got)


def test_spec_adapts_k_and_opt_out_rows_like_jax(stacks):
    """The adaptive effective k shrinks under a tight acceptance band and
    a request with `spec = False` accepts one oracle token a round; both
    as in the JAX engine."""
    reqs = spec_requests(seed=9, n=6)
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, spec_k=4,
              spec_adapt_low=0.9, spec_adapt_patience=1)
    res = {}
    for name, eng, R, S in (
            ("jax", JServingEngine(*stacks[0], **kw), JRequest, JScheduler),
            ("port", ServingEngine(*stacks[1], device="cpu", **kw), Request,
             Scheduler)):
        sched = S(max_queue=64)
        rs = [R(p, m, max_new_tokens=n, eos_id=1) for p, m, n in reqs]
        rs[1].spec = False
        for r in rs:
            sched.submit(r)
        eng.serve_until_idle(sched)
        res[name] = ([list(r.result().tokens) for r in rs],
                     eng.metrics.snapshot())
    assert res["port"][0] == res["jax"][0]
    sections_equal(res["jax"][1], res["port"][1], {"speculation": SPEC_KEYS})
    assert res["port"][1]["speculation"]["k_shrink_events"] >= 1
