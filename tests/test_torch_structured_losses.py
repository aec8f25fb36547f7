"""Parity of the port's structured losses (`ops/sequence_losses.py`,
`F.ctc_loss`, `text.viterbi_decode`) with the JAX package's, on the same
seeded numpy inputs: float64 values and gradients within rtol 1e-10
(atol 1e-12), paths equal. F.ctc_loss log-softmaxes in float32 on both
sides, so it is held to rtol 1e-6 (its gradient to 1e-6 of the largest
entry). Also: the CTC recursion against
`torch.nn.functional.ctc_loss` as an independent oracle (1e-9), and a
port copy of the JAX package's CRF tagger (tests/test_structured_losses.py)
giving the JAX losses step for step from the same weights."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import sequence as JS
from paddle_tpu.ops import sequence_losses as JL
from paddle_tpu.text import viterbi as JV
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import sequence as TS
from paddle_tpu_torch.ops import sequence_losses as TL
from paddle_tpu_torch.text import viterbi_decode

from _torch_op_parity import compare
from _torch_parity import run_jax, run_port

def _log_softmax(x):
    return x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - x.max(-1, keepdims=True)


def _ctc_case(seed, T=7, B=4, C=5, L=3):
    rs = np.random.RandomState(seed)
    logp = _log_softmax(rs.randn(T, B, C))
    labels = rs.randint(1, C, (B, L))
    labels[1, 1] = labels[1, 0]                 # a repeat: no skip there
    in_len = np.array([7, 6, 5, 7])
    lab_len = np.array([3, 2, 1, 3])
    return logp, labels, in_len, lab_len


def test_ctc_loss_values_and_gradients():
    logp, labels, il, ll = _ctc_case(0)
    compare(lambda lp: JL.ctc_loss(lp, labels, il, ll),
            lambda lp: TL.ctc_loss(lp, labels, il, ll), [logp], wrt=(0,))
    compare(lambda lp: JL.ctc_loss(lp, labels, il, ll, blank=2),
            lambda lp: TL.ctc_loss(lp, labels, il, ll, blank=2), [logp],
            wrt=(0,))


def test_ctc_loss_no_alignment_is_finite_like_jax():
    """A row no alignment fits (3 labels with a repeat in 3 steps) gives
    ~1e30, not inf; its gradient is the JAX function's too (the
    logaddexp gradient of JAX, where both inputs sit at NEG)."""
    logp, labels, il, ll = _ctc_case(1)
    labels[0] = [2, 2, 3]
    il = np.array([3, 6, 5, 7])
    pv, _ = compare(lambda lp: JL.ctc_loss(lp, labels, il, ll),
                    lambda lp: TL.ctc_loss(lp, labels, il, ll), [logp],
                    wrt=(0,))
    assert 1e29 < pv[0][0] < 1e31 and np.isfinite(pv[0]).all()


def test_ctc_loss_against_torch_oracle():
    """torch.nn.functional.ctc_loss (reduction none) on rows an
    alignment fits: within 1e-9."""
    logp, labels, il, ll = _ctc_case(2, T=12, B=6, C=6, L=4)
    il, ll = np.array([12, 11, 9, 12, 8, 10]), np.array([4, 3, 1, 2, 4, 3])
    lp = torch.from_numpy(logp)
    got = TL.ctc_loss(lp, torch.from_numpy(labels), il, ll)
    want = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels), torch.from_numpy(il),
        torch.from_numpy(ll), blank=0, reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", False),
                                            ("none", True)])
def test_functional_ctc_loss(reduction, norm):
    """F.ctc_loss: raw logits, log-softmaxed inside in float32 (both
    packages), the plain mean for "mean" (the JAX function's quirk)."""
    rs = np.random.RandomState(3)
    T, B, C = 6, 3, 5
    logits = rs.randn(T, B, C)
    labels = np.array([[1, 2], [3, 3], [4, 0]])
    il, ll = np.array([6, 5, 4], "int32"), np.array([2, 2, 1], "int32")

    def jf(x):
        return JF.ctc_loss(x, paddle.to_tensor(labels), paddle.to_tensor(il),
                           paddle.to_tensor(ll), reduction=reduction,
                           norm_by_times=norm)

    def tf(x):
        return TF.ctc_loss(x, torch.tensor(labels), torch.tensor(il),
                           torch.tensor(ll), reduction=reduction,
                           norm_by_times=norm)

    jv, jg = run_jax(jf, [logits], (0,))
    pv, pg = run_port(tf, [logits], (0,))
    assert pv[0].dtype == np.float64
    np.testing.assert_allclose(pv[0], jv[0], rtol=1e-6)
    np.testing.assert_allclose(pg[0], jg[0], rtol=0,
                               atol=1e-6 * np.abs(jg[0]).max())


def _crf_case(seed, B=4, T=5, C=4):
    rs = np.random.RandomState(seed)
    em = rs.randn(B, T, C)
    trans = rs.randn(C + 2, C) * 0.5
    lens = np.array([5, 3, 1, 4])
    labels = rs.randint(0, C, (B, T))
    return em, trans, labels, lens


def test_crf_log_likelihood():
    em, trans, labels, lens = _crf_case(4)
    compare(lambda e, t: JL.crf_log_likelihood(e, t, labels, lens),
            lambda e, t: TL.crf_log_likelihood(e, t, labels, lens),
            [em, trans], wrt=(0, 1))


@pytest.mark.parametrize("seed", [5, 6])
def test_crf_decode(seed):
    """Paths equal (zero past each length), scores within 1e-10."""
    em, trans, _, lens = _crf_case(seed, T=6)
    compare(lambda e, t: JL.crf_decode(e, t, lens),
            lambda e, t: TL.crf_decode(e, t, lens), [em, trans])


def test_crf_decode_ties_take_the_first_label():
    """Equal scores everywhere: argmax takes the first maximum on both
    sides, so the paths agree."""
    em, trans = np.zeros((2, 4, 3)), np.zeros((5, 3))
    compare(lambda e, t: JL.crf_decode(e, t, np.array([4, 2])),
            lambda e, t: TL.crf_decode(e, t, np.array([4, 2])), [em, trans])


def test_viterbi_decode():
    """(scores, paths) in that order, a [C, C] transition, no start or
    stop row; equal to crf_decode with zero start and stop rows on
    full-length rows."""
    rs = np.random.RandomState(7)
    pot, trans = rs.randn(3, 6, 4), rs.randn(4, 4)
    compare(lambda p, t: JV.viterbi_decode(paddle.to_tensor(p),
                                           paddle.to_tensor(t)),
            lambda p, t: viterbi_decode(p, t), [pot, trans], ops=False)
    s, path = viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans))
    full = torch.cat([torch.zeros(2, 4, dtype=torch.float64),
                      torch.from_numpy(trans)])
    cpath, cs = TL.crf_decode(torch.from_numpy(pot), full, [6, 6, 6])
    assert torch.equal(path, cpath.long())
    torch.testing.assert_close(s, cs, rtol=1e-12, atol=0)


def test_viterbi_decode_refuses_lengths():
    """The JAX function takes `lengths` and decodes every row over all T
    steps; the port raises on it."""
    with pytest.raises(NotImplementedError):
        viterbi_decode(torch.zeros(1, 2, 3), torch.zeros(3, 3),
                       lengths=torch.tensor([1]))


def _tagger_weights(rs, V, C, E, H):
    return {"emb": rs.randn(V, E) * 0.3, "proj": rs.randn(E, 3 * H) * 0.2,
            "w": rs.randn(H, 3 * H) * 0.2, "b": rs.randn(1, 3 * H) * 0.05,
            "out": rs.randn(H, C) * 0.2, "out_b": np.zeros(C),
            "crf": rs.randn(C + 2, C) * 0.1}


def _tagger_batch(rs, V, C, B, T):
    lens = rs.randint(2, T + 1, B)
    words = rs.randint(0, V, (B, T))
    return words, words % C, lens


def test_crf_tagger_matches_jax_step_for_step():
    """A port copy of the JAX package's CRF tagger (embedding -> fc ->
    dynamic_gru -> fc -> linear-chain CRF, Adam 0.02; its static-graph
    test at tests/test_structured_losses.py:151), composed of the ops on
    both sides in float64 from the same weights and batches: the losses
    of 5 steps within 1e-9, and the port's tagger learns the rule."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.optimizer import functional as JO
    from paddle_tpu_torch.optimizer import functional as TO

    V, C, E, H, B, T = 20, 3, 12, 12, 6, 5
    rs = np.random.RandomState(8)
    init = _tagger_weights(rs, V, C, E, H)

    def j_loss(p, words, tags, lens):
        x = p["emb"][words] @ p["proj"]
        h = JS.dynamic_gru(x, lens, p["w"], p["b"])
        em = h @ p["out"] + p["out_b"]
        return -JL.crf_log_likelihood(em, p["crf"], tags, lens).mean()

    def t_loss(p, words, tags, lens):
        x = p["emb"][words] @ p["proj"]
        h = TS.dynamic_gru(x, lens, p["w"], p["b"])
        em = h @ p["out"] + p["out_b"]
        return -TL.crf_log_likelihood(em, p["crf"], tags, lens).mean()

    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    jtx, ttx = JO.adam(0.02), TO.adam(0.02)
    js, ts = jtx.init(jp), ttx.init(tp)
    jgrad = jax.jit(jax.value_and_grad(j_loss))
    data = np.random.RandomState(9)
    losses = []
    for step in range(60):
        words, tags, lens = _tagger_batch(data, V, C, B, T)
        leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        tl = t_loss(leaves, torch.from_numpy(words), tags, lens)
        tg = dict(zip(leaves, torch.autograd.grad(tl, list(
            leaves.values()))))
        tp, ts = ttx.update(tp, tg, ts)
        losses.append(float(tl.detach()))
        if step < 5:
            jl, jg = jgrad(jp, words, tags, lens)
            jp, js = jtx.update(jp, jg, js)
            np.testing.assert_allclose(float(tl.detach()), float(jl),
                                       rtol=1e-9)
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10]), losses
    words, tags, lens = _tagger_batch(data, V, C, 32, T)
    x = tp["emb"][torch.from_numpy(words)] @ tp["proj"]
    em = TS.dynamic_gru(x, lens, tp["w"], tp["b"]) @ tp["out"] + tp["out_b"]
    path, _ = TL.crf_decode(em, tp["crf"], lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    assert (path.numpy() == tags)[mask].mean() > 0.8
