"""The port's paged KV pool against the JAX package's, on the CPU.

Kernels: the plain versions of the paged decode and verify kernels match
the JAX Pallas kernels in interpret mode (fp32 and int8 pages with
scales, a key bias, trash and unmapped table entries, T in {1, 2, 4, 8}
and the tail-prefill widths {16, 32, 64}; rtol / atol 1e-5; grids
S*h*mp <= 64), and the CPU dispatch is the
gather + dense plain read bit for bit. Host side, numpy in and out: the
allocator, the flat prefix cache and both radix-cache policies give the
JAX answers over scripted sequences of operations, and the page writers (the grow-only
int8 rescale of `write_tokens` included) give the JAX pages exactly.
Engines (2 decoder layers, d_model 64, 4 heads, vocab 97, 4 slots,
max_len 64): the port's paged engine, with and without speculation and
under page pressure, serves the JAX engine's tokens request for request
with equal `prefix.*`, `paging.*` and `speculation.*` counters, and the
port's own dense engine's tokens; after the drain and a prefix flush
every page is free.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import paging as JPG
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.serving import ServingEngine, ServingServer
from paddle_tpu_torch.serving import paging as TPG
from test_torch_spec import SPEC_KEYS, sections_equal, serve

torch.set_num_threads(2)
D, V, SLOTS, MAX_LEN, PSZ = 64, 97, 4, 64, 8
RTOL = ATOL = 1e-5
PREFIX_KEYS = ("whole_hits", "partial_hits", "misses", "hit_token_ratio",
               "cow_copies", "trie_nodes", "trie_pages")
PAGING_KEYS = ("pages_in_use", "pages_free", "prefix_hits", "prefix_misses",
               "prefix_hit_rate", "page_waits", "oom_evictions")


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _paged_inputs(T, quant, with_bias, seed=0):
    """S 3, h 2, psz 16, d 8; up to T 8 mp 4 (grid 24); at the tail
    widths (T > 8, the tiled route on the card) mp grows to hold the
    longest slot, and slot 1 has no seed (n_valid == T). A shuffled table
    whose dead entries point at the trash row N or are unmapped (-1)."""
    rs = np.random.RandomState(seed + T)
    S, h, psz, d = 3, 2, 16, 8
    if T <= 8:
        mp, lengths = 4, [T + 20, 33, 64]
    else:
        lengths = [T + 20, T, T + 40]
        mp = -(-(T + 40) // psz) + 1
    N = S * mp + 2
    table = rs.permutation(N)[:S * mp].reshape(S, mp).astype(np.int32)
    table[0, -(-lengths[0] // psz):] = N
    table[1, -(-lengths[1] // psz):] = -1
    length = np.asarray(lengths, np.int32)     # after the write
    raw = [rs.randn(N + 1, h, psz, d).astype(np.float32) for _ in range(2)]
    if quant:
        kp, ks = (np.asarray(x) for x in
                  JPG.quantize_chunks(_j(raw[0]), np.int8, True))
        vp, vs = (np.asarray(x) for x in
                  JPG.quantize_chunks(_j(raw[1]), np.int8, True))
    else:
        (kp, vp), ks, vs = raw, None, None
    q = rs.randn(S, h, T, d).astype(np.float32)
    bias = (rs.randn(S, mp * psz) * 0.1).astype(np.float32) \
        if with_bias else None
    return q, kp, vp, ks, vs, table, length, bias


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 32, 64])
def test_paged_plain_versions_match_jax_kernels(T, quant):
    """The paged decode (T = 1) and verify kernels' plain versions against
    the JAX kernels in interpret mode, with and without a key bias."""
    for with_bias in (False, True):
        q, kp, vp, ks, vs, table, length, bias = _paged_inputs(
            T, quant, with_bias)
        # the JAX kernels take a trash-clipped table
        jtable = np.where(table < 0, kp.shape[0] - 1, table)
        jfn = JA.paged_flash_decode if T == 1 else JA.paged_flash_verify
        want = jfn(_j(q), _j(kp), _j(vp), _j(ks), _j(vs), _j(jtable),
                   _j(length), _j(bias), interpret=True)
        tfn = TA.paged_flash_decode if T == 1 else TA.paged_flash_verify
        args = [_t(x) for x in (q, kp, vp, ks, vs, table, length, bias)]
        got = tfn(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        plain = (TA.paged_flash_decode_plain if T == 1 else
                 TA.paged_flash_verify_plain)(*args)
        np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_paged_gather_matches_jax():
    q, kp, vp, ks, vs, table, length, _ = _paged_inputs(4, True, False)
    jtable = np.where(table < 0, kp.shape[0] - 1, table)
    want = JA.paged_gather_kv(_j(kp), _j(ks), _j(jtable), np.float32)
    got = TA.paged_gather_kv(_t(kp), _t(ks), _t(table), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T", [1, 3])
def test_paged_dispatch_on_the_cpu_is_gather_plus_dense_plain(T):
    """Off the card the dispatchers gather the dense logical view and run
    the dense pool's plain decode / verify, bit for bit (what makes fp32
    pages serve the dense pool's tokens); both agree with the JAX CPU
    dispatch."""
    q, kp, vp, ks, vs, table, length, bias = _paged_inputs(T, False, True)
    args = [_t(x) for x in (q, kp, vp, ks, vs, table, length, bias)]
    kd = TA.paged_gather_kv(args[1], None, args[5], torch.float32)
    vd = TA.paged_gather_kv(args[2], None, args[5], torch.float32)
    if T == 1:
        got = TA.paged_decode_attention(*args)
        dense = TA.flash_decode(args[0], kd, vd, args[6], args[7])
        jfn = JA.paged_decode_attention
    else:
        got = TA.paged_verify_attention(*args)
        dense = TA.flash_verify(args[0], kd, vd, args[6], args[7])
        jfn = JA.paged_verify_attention
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    jtable = np.where(table < 0, kp.shape[0] - 1, table)
    want = jfn(_j(q), _j(kp), _j(vp), None, None, _j(jtable), _j(length),
               _j(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mid_page", ["round_down", "cow"])
def test_allocator_and_radix_cache_answer_like_jax(mid_page):
    """One scripted sequence of inserts, lookups (whole, partial ending
    mid-page and on a page boundary, miss, another memory scope), peeks,
    capacity eviction, reclaim and flush, on both implementations: every
    answer, the stats and the allocator state agree."""
    rs = np.random.RandomState(7)
    psz = 4
    mem_a = rs.randn(3, 4).astype(np.float32)
    mem_b = rs.randn(3, 4).astype(np.float32)
    base = list(rs.randint(2, 50, 13))
    prompts = [base, base[:9] + [77, 78], base, base[:6] + [90] * 5,
               base[:12] + [60], list(rs.randint(2, 50, 7)), base]
    sides = {}
    for name, PG in (("jax", JPG), ("port", TPG)):
        alloc = PG.PageAllocator(40, psz)
        cache = PG.RadixPrefixCache(alloc, capacity=3, page_size=psz,
                                    mid_page=mid_page)
        log = []
        for i, p in enumerate(prompts):
            mem = mem_b if i == 5 else mem_a
            P0 = len(p)
            Pb = 1 << (P0 - 1).bit_length()
            log.append(("peek", cache.peek(p, P0, Pb, mem)))
            res = cache.lookup(p, P0, Pb, mem)
            log.append(("lookup", res))
            pages = alloc.alloc(-(-Pb // psz))
            cache.insert(p, P0, Pb, mem, None, pages, 100 + i)
            alloc.decref(pages)                 # the "slot" finishes
            log.append(("stats", cache.stats(), alloc.pages_free))
        log.append(("reclaim", cache.reclaim(alloc.n_pages),
                    alloc.pages_free))
        cache.flush()
        alloc.check()
        log.append(("end", cache.stats(), alloc.pages_free,
                    alloc.refcount.tolist(), cache.whole_hits,
                    cache.partial_hits, cache.misses))
        sides[name] = log
    assert sides["port"] == sides["jax"]
    kinds = [e[1][0] for e in sides["port"] if e[0] == "lookup" and e[1]]
    assert "whole" in kinds and "partial" in kinds


def test_flat_cache_and_insert_prefix_answer_like_jax():
    """The flat whole-prompt `PrefixCache` (keys, peek, lookup, LRU over
    capacity, reclaim, flush) and the radix trie's page-only
    `insert_prefix` (a partially prefilled prompt becomes matchable
    before its terminal lands) give the JAX answers and allocator
    states."""
    rs = np.random.RandomState(9)
    psz = 4
    mem = rs.randn(3, 4).astype(np.float32)
    prompts = [list(rs.randint(2, 50, n)) for n in (5, 9, 5, 12)]
    prompts[2] = prompts[0]
    long = list(rs.randint(2, 50, 14))
    sides = {}
    for name, PG in (("jax", JPG), ("port", TPG)):
        alloc = PG.PageAllocator(24, psz)
        flat = PG.PrefixCache(alloc, capacity=2)
        log = []
        for i, p in enumerate(prompts):
            key = flat.key_of(p, mem)
            log.append(("peek", flat.peek(key)))
            log.append(("lookup", flat.lookup(key)))
            pages = alloc.alloc(-(-len(p) // psz))
            flat.insert(key, pages, 200 + i, len(p), len(p))
            alloc.decref(pages)
            log.append(("flat", len(flat), alloc.pages_free, flat.hit_rate))
        log.append(("reclaim", flat.reclaim(alloc.n_pages),
                    alloc.pages_free))
        flat.flush()
        radix = PG.RadixPrefixCache(alloc, capacity=4, page_size=psz)
        pages = alloc.alloc(4)
        radix.insert_prefix(long[:8], mem, None, pages[:2])
        log.append(("partial before the terminal",
                    radix.lookup(long[:13] + [1], 14, 16, mem),
                    radix.stats()))
        radix.insert(long, 14, 16, mem, None, pages, 7)
        alloc.decref(pages)
        log.append(("whole", radix.lookup(long, 14, 16, mem), radix.stats()))
        radix.flush()
        alloc.check()
        log.append(("end", alloc.pages_free, alloc.refcount.tolist()))
        sides[name] = log
    assert sides["port"] == sides["jax"]
    assert sides["port"][-3][1][0] == "partial"
    assert sides["port"][-2][1][0] == "whole"


def test_page_writers_match_jax():
    """write_prompt_pages (int8: per-page quantize), write_tokens across a
    page boundary with a token that outranges its page (the grow-only
    rescale), write_token on fp32 pages, and copy_page: the same pages
    and scales as the JAX functions."""
    rs = np.random.RandomState(3)
    N, h, psz, d, S = 6, 2, 4, 8, 2
    pages = np.zeros((N + 1, h, psz, d), np.int8)
    scales = np.zeros((N + 1, h, 1, 1), np.float32)
    kv = rs.randn(1, h, 7, d).astype(np.float32)
    ids = np.asarray([3, 1], np.int32)
    jp, js = JPG.write_prompt_pages(_j(pages), _j(scales), _j(ids), _j(kv),
                                    True)
    tp, ts = _t(pages), _t(scales)
    TPG.write_prompt_pages(tp, ts, ids, _t(kv), True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    table = np.asarray([[3, 1, 5], [2, 4, N]], np.int32)
    index = np.asarray([3, 6], np.int32)
    toks = rs.randn(S, h, 3, d).astype(np.float32)
    toks[0, :, 1] *= 10.0                 # outranges page 1's scale
    jp, js = JPG.write_tokens(jp, js, _j(table), _j(index), _j(toks))
    TPG.write_tokens(tp, ts, _t(table), _t(index), _t(toks))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp, js = JPG.copy_page(jp, js, 1, 6)
    TPG.copy_page(tp, ts, 1, 6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    fp = rs.randn(N + 1, h, psz, d).astype(np.float32)
    tok = rs.randn(S, h, d).astype(np.float32)
    want, _ = JPG.write_token(_j(fp), None, _j(table), _j(index), _j(tok))
    got = _t(fp)
    TPG.write_token(got, None, _t(table), _t(index), _t(tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def stacks():
    from test_torch_serving import build_stacks

    return build_stacks()


def preamble_requests(seed, n=10, preamble=19, repeat=(3, 7)):
    """A shared seeded preamble plus distinct tails (partial hits), one
    memory for all (the prefix cache is scoped by it); requests `repeat`
    copy earlier prompts exactly (whole hits)."""
    rs = np.random.RandomState(seed)
    mem = rs.randn(5, D).astype(np.float32)
    pre = rs.randint(2, V, preamble)
    out = []
    for i in range(n):
        if i in repeat:
            out.append((out[i - 2][0], mem, int(rs.randint(4, 20))))
            continue
        p = np.concatenate([pre, rs.randint(2, V, int(rs.randint(1, 12)))])
        p[0] = 0
        out.append((p.astype(np.int32), mem, int(rs.randint(4, 20))))
    return out


def _engines(stacks, **kw):
    kw = dict(num_slots=SLOTS, max_len=MAX_LEN, paged=True, page_size=PSZ,
              **kw)
    return (JServingEngine(*stacks[0], **kw),
            ServingEngine(*stacks[1], device="cpu", **kw))


def _leak_free(eng):
    eng.flush_prefix_cache()
    eng._alloc.check()
    assert eng._alloc.pages_free == eng.num_pages


@pytest.mark.parametrize("mid_page", ["round_down", "cow"])
def test_paged_engine_equals_jax_engine(stacks, mid_page):
    reqs = preamble_requests(7)
    jeng, eng = _engines(stacks, radix_mid_page=mid_page)
    want, jsnap = serve(jeng, reqs, jax=True)
    got, snap = serve(eng, reqs)
    assert got == want
    sections_equal(jsnap, snap, {"prefix": PREFIX_KEYS,
                                 "paging": PAGING_KEYS})
    assert snap["prefix"]["whole_hits"] >= 1
    assert snap["prefix"]["partial_hits"] >= 1
    dense, _ = serve(ServingEngine(*stacks[1], num_slots=SLOTS,
                                   max_len=MAX_LEN, device="cpu"), reqs)
    assert got == dense
    _leak_free(eng)


def test_paged_spec_engine_equals_jax_engine(stacks):
    reqs = preamble_requests(8, preamble=17)
    jeng, eng = _engines(stacks, spec_k=3)
    want, jsnap = serve(jeng, reqs, jax=True)
    got, snap = serve(eng, reqs)
    assert got == want
    sections_equal(jsnap, snap, {"prefix": PREFIX_KEYS,
                                 "paging": PAGING_KEYS,
                                 "speculation": SPEC_KEYS})
    assert snap["speculation"]["drafts_accepted"] > 0
    _leak_free(eng)


def test_page_pressure_defers_and_evicts_like_jax(stacks):
    """A pool of 12 pages with no decode reservation: admission defers
    the queue head (page_waits) and a dry pool evicts a starved slot
    mid-decode (oom_evictions, finish reason "error" with partial
    tokens); the survivors' tokens and every counter equal JAX's."""
    reqs = preamble_requests(11, n=8, preamble=9, repeat=())
    out = {}
    for name, eng in zip(("jax", "port"), _engines(
            stacks, num_pages=12, reserve_decode_frac=0.0)):
        from paddle_tpu.serving import Request as JRequest
        from paddle_tpu.serving import Scheduler as JScheduler
        from paddle_tpu_torch.serving import Request, Scheduler

        R, S = (JRequest, JScheduler) if name == "jax" else (Request,
                                                             Scheduler)
        sched = S(max_queue=64)
        rs = [R(p, m, max_new_tokens=n + 20, eos_id=None)
              for p, m, n in reqs]
        for r in rs:
            sched.submit(r)
        eng.serve_until_idle(sched)
        out[name] = ([(list(r.tokens), r.finish_reason) for r in rs],
                     eng.metrics.snapshot())
    assert out["port"][0] == out["jax"][0]
    sections_equal(out["jax"][1], out["port"][1], {"paging": PAGING_KEYS})
    assert out["port"][1]["paging"]["page_waits"] >= 1
    assert out["port"][1]["paging"]["oom_evictions"] >= 1


def test_int8_pages_equal_jax_engine(stacks):
    """int8 pages (prefix reuse: whole hits only) through the server:
    the JAX engine's tokens (identical quantization arithmetic on both
    sides)."""
    reqs = preamble_requests(12, n=6)
    jeng, eng = _engines(stacks, kv_dtype="int8")
    want, jsnap = serve(jeng, reqs, jax=True)
    server = ServingServer(eng)
    try:
        handles = [server.submit(p, m, max_new_tokens=n, eos_id=1)
                   for p, m, n in reqs]
        got = [list(h.result(timeout=60).tokens) for h in handles]
    finally:
        server.shutdown(drain=True, timeout=60)
    assert got == want
    snap = eng.metrics.snapshot()
    sections_equal(jsnap, snap, {"prefix": PREFIX_KEYS})
    assert snap["prefix"]["partial_hits"] == 0
    assert eng._state["paged"][0]["k"].dtype == torch.int8
    _leak_free(eng)
