"""The port's serving path against the JAX package's, on the CPU.

One small model (2 decoder layers, d_model 64, 4 heads, vocab 97) is
built in JAX and loaded into the port with `convert.from_jax_state`.
The same requests (ragged prompts over several buckets, more requests
than the 4 slots, so slots are reused) go through the JAX
`ServingEngine`, the port's `ServingEngine` and `ServingServer`, and the
port's `generate_eager`: the tokens must be equal request for request.
Prefill logits agree within atol 1e-5 (float32, reordered sums).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import to_tensor
from paddle_tpu.nn.layer.transformer import (TransformerDecoder,
                                             TransformerDecoderLayer)
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.core.bucketing import bucket_size, pad_prompt_row
from paddle_tpu_torch.serving import (PagedServingEngine, Request,
                                      Scheduler, ServingEngine, ServingServer)
from paddle_tpu_torch.text.generation import generate_eager

torch.set_num_threads(2)
D, H, FF, V, SLOTS, MAX_LEN = 64, 4, 128, 97, 4, 64


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def build_stacks():
    """(JAX decoder, embed, project) and the port's copy."""
    np.random.seed(3)
    jdec = TransformerDecoder(TransformerDecoderLayer(D, H, FF, dropout=0.0),
                              2)
    jdec.eval()
    jemb, jproj = jnn.Embedding(V, D), jnn.Linear(D, V)
    tdec = tnn.TransformerDecoder(
        tnn.TransformerDecoderLayer(D, H, FF, dropout=0.0, device="cpu"), 2)
    temb = tnn.Embedding(V, D, device="cpu")
    tproj = tnn.Linear(D, V, device="cpu")
    for t, j in ((tdec, jdec), (temb, jemb), (tproj, jproj)):
        t.load_state_dict(from_jax_state(_np_state(j)))
        t.eval()
    return (jdec, jemb, jproj), (tdec, temb, tproj)


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def _requests(seed=5, n=10):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        P = int(rs.randint(1, 21))                 # buckets 1 .. 32
        prompt = rs.randint(2, V, (P,)).astype(np.int32)
        prompt[0] = 0
        mem = rs.randn(5, D).astype(np.float32)
        out.append((prompt, mem, int(rs.randint(2, 13))))
    return out


def _jax_tokens(jstack, reqs):
    eng = JServingEngine(*jstack, num_slots=SLOTS, max_len=MAX_LEN)
    sched = JScheduler(max_queue=64)
    rs = [JRequest(p, m, max_new_tokens=n, eos_id=1) for p, m, n in reqs]
    for r in rs:
        sched.submit(r)
    eng.serve_until_idle(sched)
    return [list(r.result().tokens) for r in rs]


@pytest.fixture(scope="module")
def jax_tokens(stacks):
    return _jax_tokens(stacks[0], _requests())


def test_engine_tokens_equal_jax_engine(stacks, jax_tokens):
    eng = ServingEngine(*stacks[1], num_slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    sched = Scheduler(max_queue=64)
    reqs = [Request(p, m, max_new_tokens=n, eos_id=1)
            for p, m, n in _requests()]
    for r in reqs:
        sched.submit(r)
    eng.serve_until_idle(sched)
    got = [list(r.result().tokens) for r in reqs]
    assert got == jax_tokens
    snap = eng.metrics.snapshot()
    assert snap["requests"]["completed"] == len(reqs)
    assert snap["joins"] == len(reqs) > SLOTS          # slots were reused
    assert snap["tokens_out"] == sum(len(t) for t in got)
    assert snap["ttft_ms"]["n"] == len(reqs)


def test_server_tokens_equal_jax_engine(stacks, jax_tokens):
    eng = ServingEngine(*stacks[1], num_slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    server = ServingServer(eng)
    try:
        reqs = [server.submit(p, m, max_new_tokens=n, eos_id=1)
                for p, m, n in _requests()]
        got = [list(r.result(timeout=60).tokens) for r in reqs]
    finally:
        server.shutdown(drain=True, timeout=60)
    assert got == jax_tokens
    assert all(r.result().ok for r in reqs)


def test_generate_eager_tokens_equal_jax_engine(stacks, jax_tokens):
    tdec, temb, tproj = stacks[1]
    for (prompt, mem, n), want in zip(_requests(), jax_tokens):
        toks, lens = generate_eager(
            tdec, temb, tproj, torch.from_numpy(mem[None]), prompt[None],
            [len(prompt)], bos_id=0, eos_id=1, max_new_tokens=n,
            pad_prompt_to=bucket_size(len(prompt)))
        assert list(toks[0][:int(lens[0])]) == want


def test_prefill_logits_match_jax(stacks):
    (jdec, jemb, jproj), (tdec, temb, tproj) = stacks
    eng = ServingEngine(tdec, temb, tproj, num_slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    for prompt, mem, _ in _requests()[:3]:
        row, P0, Pb = pad_prompt_row(prompt, 1)
        mask = np.where(np.tril(np.ones((Pb, Pb), bool)), 0.0, -1e30)
        mask = (mask + np.where(np.arange(Pb) >= P0, -1e30, 0.0)[None])
        out = jdec(jemb(to_tensor(row)), to_tensor(mem[None]),
                   to_tensor(mask.astype(np.float32)[None, None]))
        want = np.asarray(jproj(out)._data)[0, :P0]
        caches = [layer.self_attn.gen_cache(None, max_length=Pb,
                                            batch_size=1)
                  for layer in tdec.layers]
        with torch.inference_mode():
            logits = eng._net.prefill(torch.from_numpy(row), P0,
                                      torch.from_numpy(mem[None]), caches,
                                      MAX_LEN)[0]
        np.testing.assert_allclose(logits[0, :P0].numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_engine_refuses_later_slices_and_unservable_requests(stacks):
    # chunked prefill is ported: a power-of-two chunk is taken, any other
    # is refused
    assert ServingEngine(*stacks[1], device="cpu",
                         prefill_chunk=8).prefill_chunk == 8
    with pytest.raises(ValueError, match="power of two"):
        ServingEngine(*stacks[1], device="cpu", prefill_chunk=6)
    with pytest.raises(ValueError, match="only 'int8'"):
        ServingEngine(*stacks[1], device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(*stacks[1], device="cpu", spec_k=1)
    paged = ServingEngine(*stacks[1], device="cpu", paged=True, num_pages=3,
                          max_len=MAX_LEN, page_size=8)
    assert isinstance(paged, PagedServingEngine)
    with pytest.raises(ValueError, match="pages"):
        paged.admit_check(Request(np.zeros(20, np.int32), np.zeros((5, D)),
                                  max_new_tokens=8))
    eng = ServingEngine(*stacks[1], num_slots=SLOTS, max_len=MAX_LEN,
                        device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.admit_check(Request(np.zeros(40, np.int32), np.zeros((5, D)),
                                max_new_tokens=8))
    with pytest.raises(ValueError, match="memory"):
        eng.admit_check(Request(np.zeros(4, np.int32), np.zeros((1, 5, D))))
