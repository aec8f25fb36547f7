"""The port's decoding against the JAX package's, on the CPU.

Small model (2 decoder layers, d_model 32, 2 heads, FFN 64, vocabulary
17), built in JAX and loaded into the port with `convert.from_jax_state`.
On a fixed Markov logits table the port's `greedy_search` and
`beam_search` give the JAX functions' tokens and lengths exactly and
their scores within rtol 1e-5 (float32 log-softmax sums in another
order). The port's `DecodeEngine` gives the JAX engine's tokens and
lengths exactly for greedy, beam 2 and 4 (scores rtol 1e-5), the n-gram
and the `DraftModel` speculative routes (equal to greedy too, with equal
round / proposal / acceptance counts), eos-shortened rows and
`TransformerDecoder.generate`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer.transformer import (TransformerDecoder,
                                             TransformerDecoderLayer)
from paddle_tpu.text import decode as JD
from paddle_tpu.text.generation import DecodeEngine as JDecodeEngine
from paddle_tpu.text.speculative import DraftModel as JDraftModel
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state
from paddle_tpu_torch.text import decode as TD
from paddle_tpu_torch.text.generation import DecodeEngine, generate_eager
from paddle_tpu_torch.text.speculative import DraftModel

torch.set_num_threads(1)
D, H, FF, V = 32, 2, 64, 17
RTOL = 1e-5


def stacks(seed=7, layers=2, heads=H, ff=FF):
    """(JAX decoder, embed, project) and the port's copy of it."""
    np.random.seed(seed)
    jdec = TransformerDecoder(TransformerDecoderLayer(D, heads, ff,
                                                      dropout=0.0), layers)
    jdec.eval()
    jemb, jproj = jnn.Embedding(V, D), jnn.Linear(D, V)
    tdec = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D, heads, ff, dropout=0.0, device="cpu"), layers)
    temb = tnn.Embedding(V, D, device="cpu")
    tproj = tnn.Linear(D, V, device="cpu")
    for t, j in ((tdec, jdec), (temb, jemb), (tproj, jproj)):
        t.load_state_dict(from_jax_state(
            {k: np.asarray(v) for k, v in j.state_dict().items()}))
        t.eval()
    return (jdec, jemb, jproj), (tdec, temb, tproj)


def inputs(B=3, Pmax=5, M=4, seed=8):
    rs = np.random.RandomState(seed)
    memory = rs.randn(B, M, D).astype(np.float32)
    prompt = rs.randint(2, V, (B, Pmax)).astype(np.int32)
    prompt[:, 0] = 0
    plens = np.asarray([Pmax, Pmax - 2, Pmax - 1][:B], np.int32)
    return memory, prompt, plens


def jax_generate(jstack, memory, prompt, plens, **kw):
    import jax.numpy as jnp

    eng = JDecodeEngine(*jstack)
    out = eng.generate(jnp.asarray(memory), jnp.asarray(prompt),
                       jnp.asarray(plens), **kw)
    return tuple(o if isinstance(o, dict) else np.asarray(o) for o in out)


@pytest.fixture(scope="module")
def model():
    return stacks()


# ---- the searches on a fixed logits table ----------------------------

def _tables(seed, B=3, Vt=7):
    rs = np.random.RandomState(seed)
    trans = (rs.randn(Vt, Vt) * 2).astype(np.float32)
    trans[:, 3] = trans[:, 4]          # exact ties: the lower index wins
    init = (rs.randn(B, Vt) * 2).astype(np.float32)
    return trans, init


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_searches_match_jax_on_a_logits_table(seed):
    import jax.numpy as jnp

    trans, init = _tables(seed)
    jt, tt = jnp.asarray(trans), torch.from_numpy(trans)

    def jstep(tok, st):
        return jt[tok], st

    def tstep(tok, st):
        return tt[tok], st

    B, eos, bos, L = init.shape[0], 0, 1, 6
    for init_logits in (None, init):
        ji = None if init_logits is None else jnp.asarray(init_logits)
        ti = None if init_logits is None else torch.from_numpy(init_logits)
        want = JD.greedy_search(jstep, (), B, bos, eos, L, init_logits=ji)
        got = TD.greedy_search(tstep, (), B, bos, eos, L, init_logits=ti)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for K, lp in ((2, 0.0), (3, 0.6), (4, 1.0)):
            want = JD.beam_search(jstep, (), B, bos, eos, K, L,
                                  length_penalty=lp, init_logits=ji)
            got = TD.beam_search(tstep, (), B, bos, eos, K, L,
                                 length_penalty=lp, init_logits=ti)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=RTOL)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_beam_search_regathers_the_state_by_parent():
    """Logits that depend on the state (the counts of the tokens fed so
    far) give the JAX tokens only if every beam's state row follows its
    parent each step."""
    import jax.numpy as jnp

    trans, init = _tables(5, B=2)
    Vt, K, L = trans.shape[0], 3, 6
    jt, tt = jnp.asarray(trans), torch.from_numpy(trans)

    def jstep(tok, hist):
        hist = hist.at[jnp.arange(hist.shape[0]), tok].add(1.0)
        return jt[tok] - 0.7 * hist, hist

    def tstep(tok, hist):
        hist = hist.clone()
        hist[torch.arange(hist.shape[0]), tok] += 1.0
        return tt[tok] - 0.7 * hist, hist

    want = JD.beam_search(jstep, jnp.zeros((2, Vt), jnp.float32), 2, 1, 0,
                          K, L, init_logits=jnp.asarray(init))
    got = TD.beam_search(tstep, torch.zeros((2, Vt)), 2, 1, 0, K, L,
                         init_logits=torch.from_numpy(init))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL)


# ---- the engine ------------------------------------------------------

def test_greedy_engine_matches_jax_and_eager(model):
    jstack, tstack = model
    memory, prompt, plens = inputs()
    want = jax_generate(jstack, memory, prompt, plens, bos_id=0, eos_id=1,
                        max_new_tokens=8)
    eng = DecodeEngine(*tstack, device="cpu")
    got = eng.generate(memory, prompt, plens, bos_id=0, eos_id=1,
                       max_new_tokens=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    et, el = generate_eager(*tstack, torch.from_numpy(memory), prompt, plens,
                            bos_id=0, eos_id=1, max_new_tokens=8)
    np.testing.assert_array_equal(got[0], et)
    np.testing.assert_array_equal(got[1], el)
    # an unbucketed batch and a one-token prompt (the decode-branch
    # prefill) give the same rows
    g2 = eng.generate(memory, prompt, plens, bos_id=0, eos_id=1,
                      max_new_tokens=8, bucket_batch=False)
    np.testing.assert_array_equal(g2[0], got[0])
    g1 = eng.generate(memory[:2], None, None, bos_id=0, eos_id=1,
                      max_new_tokens=4)
    e1 = generate_eager(*tstack, torch.from_numpy(memory[:2]), None, None,
                        bos_id=0, eos_id=1, max_new_tokens=4)
    np.testing.assert_array_equal(g1[0], e1[0])


@pytest.mark.parametrize("K,lp", [(2, 0.0), (4, 0.7)])
def test_beam_engine_matches_jax(model, K, lp):
    jstack, tstack = model
    memory, prompt, plens = inputs(seed=10)
    want = jax_generate(jstack, memory, prompt, plens, bos_id=0, eos_id=1,
                        max_new_tokens=6, beam_size=K, length_penalty=lp)
    got = DecodeEngine(*tstack, device="cpu").generate(
        memory, prompt, plens, bos_id=0, eos_id=1, max_new_tokens=6,
        beam_size=K, length_penalty=lp)
    assert got[0].shape == (3, K, 6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("k", [2, 4])
def test_ngram_spec_engine_matches_jax_and_greedy(model, k):
    jstack, tstack = model
    memory, prompt, plens = inputs()
    kw = dict(bos_id=0, eos_id=1, max_new_tokens=8)
    want = jax_generate(jstack, memory, prompt, plens, spec_k=k,
                        return_spec_stats=True, **kw)
    eng = DecodeEngine(*tstack, device="cpu")
    got = eng.generate(memory, prompt, plens, spec_k=k,
                       return_spec_stats=True, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    plain = eng.generate(memory, prompt, plens, **kw)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])


def test_draft_model_spec_engine_matches_jax_and_greedy():
    """A draft of one layer on other weights disagrees with the target:
    drafts are rejected, and the tokens still equal plain greedy's."""
    jstack, tstack = stacks(seed=9)
    jdraft, tdraft = stacks(seed=33, layers=1, ff=32)
    memory, prompt, plens = inputs(seed=10)
    kw = dict(bos_id=0, eos_id=1, max_new_tokens=10, spec_k=4,
              return_spec_stats=True)
    want = jax_generate(jstack, memory, prompt, plens,
                        draft_model=JDraftModel(*jdraft), **kw)
    eng = DecodeEngine(*tstack, device="cpu")
    got = eng.generate(memory, prompt, plens, draft_model=DraftModel(*tdraft),
                       **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[2]["accepted"] < got[2]["proposed"]
    plain = eng.generate(memory, prompt, plens, bos_id=0, eos_id=1,
                         max_new_tokens=10)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])


def test_eos_lengths_match_jax(model):
    """eos set to a token the model emits: rows stop early, the tail is
    eos, lengths as the JAX engine's, greedy and beam."""
    jstack, tstack = model
    memory, prompt, plens = inputs(seed=16)
    eng = DecodeEngine(*tstack, device="cpu")
    probe, _ = eng.generate(memory, prompt, plens, bos_id=0, eos_id=1,
                            max_new_tokens=8)
    eos = int(probe[0, 2])
    for kw in (dict(), dict(beam_size=2)):
        want = jax_generate(jstack, memory, prompt, plens, bos_id=0,
                            eos_id=eos, max_new_tokens=8, **kw)
        got = eng.generate(memory, prompt, plens, bos_id=0, eos_id=eos,
                           max_new_tokens=8, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[-1], want[-1])
    toks, lens = eng.generate(memory, prompt, plens, bos_id=0, eos_id=eos,
                              max_new_tokens=8)
    n = list(probe[0]).index(eos) + 1
    assert n <= 3 and lens[0] == n and (toks[0, n:] == eos).all()


def test_transformer_decoder_generate(model):
    _, (tdec, temb, tproj) = model
    memory, prompt, plens = inputs(seed=14)
    kw = dict(prompt=prompt, prompt_lengths=plens, bos_id=0, eos_id=1,
              max_new_tokens=5)
    toks, lens = tdec.generate(memory, temb, tproj, device="cpu", **kw)
    eng = tdec._decode_engine
    t2, l2 = tdec.generate(memory, temb, tproj, device="cpu", **kw)
    assert tdec._decode_engine is eng
    want = DecodeEngine(tdec, temb, tproj, device="cpu").generate(
        memory, prompt, plens, bos_id=0, eos_id=1, max_new_tokens=5)
    for got in ((toks, lens), (t2, l2)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_generate_validation(model):
    _, tstack = model
    memory, prompt, plens = inputs()
    eng = DecodeEngine(*tstack, device="cpu")
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        eng.generate(memory, prompt, plens, spec_k=1)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.generate(memory, prompt, plens, spec_k=2, beam_size=2)
    with pytest.raises(ValueError, match="lives on"):
        DecodeEngine(*tstack, device="meta")
