"""The port's ring attention over sp and GPipe schedule over pp on the CPU,
against the JAX package's (`tests/test_parallel.py`: the ring, contiguous
and zigzag, causal or not, forward and gradients, against
`sdpa_reference`; the pipeline's forward and gradients against the
serial model), and the 8-rank mirror of `dryrun_multichip(8)`.

The port's side runs in gloo ranks of one module-wide
`_torch_dist_ranks.RankPool` (8 processes, one intra-op thread each);
each rank holds its shard of the sequence, and rank 0 gathers the output
and gradients. The reference side is the JAX `sdpa_reference` and
`jax.grad` on the global arrays in this process. Limits: the JAX
tests' own, 2e-5 relative / 2e-6 absolute on outputs and 2e-5 on
gradients (the online softmax sums the keys in another order); the
GPipe outputs 1e-5 / 1e-6 and gradients 2e-5 against the serial model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.ops.attention import sdpa_reference

import paddle_tpu as paddle
from paddle_tpu.parallel import functionalize as jax_functionalize
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForSequenceClassification as JaxErnie

import _torch_dist_ranks as R
from _torch_parity import np_state
from paddle_tpu_torch.parallel import ring_attention
from paddle_tpu_torch.parallel.ring import zigzag_permutation


@pytest.fixture(scope="module", autouse=True)
def pool():
    """Started with the module's first test, so that the ranks' start-up
    overlaps the tests that need no rank (they come first)."""
    p = R.RankPool(8)
    yield p
    p.close()


def qkv(seed, b, h, s, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def reference(q, k, v, causal, grads=True):
    """The JAX sdpa_reference's output (and the gradients of its sum),
    jitted: one compile in place of one a primitive."""
    def f(q, k, v):
        return sdpa_reference(q, k, v, None, causal, None)

    out = [np.asarray(jax.jit(f)(q, k, v))]
    if grads:
        g = jax.jit(jax.grad(lambda *t: f(*t).astype(jnp.float32).sum(),
                             (0, 1, 2)))(q, k, v)
        out += [np.asarray(x) for x in g]
    return out


def test_ring_layout_checks():
    fwd, inv = zigzag_permutation(64, 4)
    np.testing.assert_array_equal(fwd[inv], np.arange(64))
    with pytest.raises(ValueError, match="divisible"):
        zigzag_permutation(60, 4)
    x = np.zeros((1, 1, 8, 4), np.float32)
    import torch

    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="unknown ring layout"):
        ring_attention(t, t, t, is_causal=True, layout="zig-zag")
    with pytest.raises(ValueError, match="CAUSAL"):
        ring_attention(t, t, t, is_causal=False, layout="zigzag")


@pytest.mark.parametrize("causal,layout,pre", [
    (False, "contiguous", False), (True, "contiguous", False),
    (True, "zigzag", False), (True, "zigzag", True)],
    ids=["bidirectional", "causal", "zigzag", "zigzag-pre-striped"])
def test_ring_matches_reference_forward_and_gradients(pool, causal, layout,
                                                      pre):
    q, k, v = qkv(5, 2, 4, 64, 16)
    got = pool.run(4, "ring_case", q, k, v, causal, layout, pre)[0]
    want = reference(q, k, v, causal)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-6)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                   err_msg=f"grad {name}")


def test_ring_on_a_dp_x_sp_mesh(pool):
    """sp=2 beside dp=2: each ring runs over its own dp row."""
    q, k, v = qkv(1, 1, 2, 32, 8)
    got = pool.run(4, "ring_case", q, k, v, True, "contiguous", False,
                   "sp", {"dp": 2, "sp": 2})[0]
    np.testing.assert_allclose(got[0], reference(q, k, v, True, False)[0],
                               rtol=2e-5, atol=2e-6)


def test_gpipe_matches_sequential_and_differentiates(pool):
    rs = np.random.RandomState(0)
    stages = [{"w": rs.randn(8, 8).astype(np.float32) * 0.3}
              for _ in range(4)]
    mb = rs.randn(4, 2, 8).astype(np.float32)
    got = pool.run(4, "gpipe_case", stages, mb)[0]
    import torch

    ws = [torch.from_numpy(s["w"]).requires_grad_(True) for s in stages]
    x = torch.from_numpy(mb)
    for w in ws:
        x = torch.tanh(x @ w)
    (x ** 2).sum().backward()
    np.testing.assert_allclose(got["out"], x.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad"],
                               np.stack([w.grad.numpy() for w in ws]),
                               rtol=2e-5, atol=1e-6)
    assert np.abs(got["grad"]).sum() > 0


def test_eight_ranks_mirror_dryrun_multichip(pool):
    """`__graft_entry__.dryrun_multichip(8)` on 8 gloo ranks, in one world:
    the mesh (dp=2 x tp=2 x pp=2's shape and groups, `auto_mesh(8)`, a
    mesh that does not fit the world refused); (1) two SGD steps of tiny
    ERNIE on dp=4 x tp=2 with remat and a global-norm clip: the first
    loss the JAX model's on the batch, the parameters the one-rank
    run's (which `test_torch_mesh.py` holds to the JAX mesh trainer);
    (2) the causal ring over sp=8, contiguous and zigzag, against the JAX
    reference and each other; (3) a 2-stage GPipe ERNIE over pp=2 x dp=4,
    whose microbatch losses equal the JAX model's and whose gradients
    equal the serial model's. Everything finite."""
    paddle.seed(1)
    kw = dict(hidden_dropout=0.0, attn_dropout=0.0)
    jnet = JaxErnie(JaxConfig.tiny(**kw))        # two layers: one a stage
    state = np_state(jnet)
    fm = jax_functionalize(jnet)
    rs = np.random.RandomState(0)
    M, mbs = 4, 2
    ids = rs.randint(1, 512, (M, mbs, 16)).astype(np.int64)
    lbl = rs.randint(0, 2, (M, mbs)).astype(np.int64)
    flat_ids, flat_lbl = ids.reshape(M * mbs, 16), lbl.reshape(M * mbs)
    logits = np.asarray(jax.jit(lambda p, x: fm.apply(
        p, {}, None, x, training=False)[0])(fm.params(), flat_ids))

    def ce(lg, y):
        lg = lg - lg.max(-1, keepdims=True)
        logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        return float(-logp[np.arange(len(y)), y].mean())

    step = dict(model="ernie", cfg=kw, state=state,
                batch=((flat_ids,), flat_lbl), steps=2, rules=True,
                remat=True, lean=True,
                opt=("sgd", {"learning_rate": 0.5}), clip=1.0)
    q, k, v = (rs.randn(1, 2, 64, 8).astype(np.float32) for _ in range(3))
    pipe_spec = dict(model="ernie", cfg=kw, state=state, micro=(ids, lbl),
                     mesh={"pp": 2, "dp": 4})
    outs = pool.run(8, "many", [
        ("mesh_facts", ()),
        ("train", (dict(step, mesh={"dp": 4, "tp": 2}),)),
        ("ring_case", (q, k, v, True, "contiguous")),
        ("ring_case", (q, k, v, True, "zigzag")),
        ("pipeline_ernie", (pipe_spec,))])
    facts, got, ring_c, ring_z, _ = outs[0]
    one = pool.run(1, "train", dict(step, mesh={"dp": 1}))[0]

    assert facts["shape"] == {"dp": 2, "pp": 2, "tp": 2, "sp": 1, "ep": 1}
    assert np.prod(list(facts["auto"].values())) == 8
    assert facts["auto"]["tp"] >= 2
    assert facts["bad"].startswith("ValueError")
    # tp peers are adjacent ranks, dp peers 4 apart (row-major over dp,
    # pp, tp, as JAX's devices.reshape)
    assert facts["tp_ranks"] == [0, 1] and facts["dp_ranks"] == [0, 4]

    assert np.isfinite(got["losses"]).all()
    assert R.rel_l2(got["losses"][0], ce(logits, flat_lbl)) <= R.REL
    assert R.rel_l2(got["losses"], one["losses"]) <= R.REL
    R.assert_params(got["params"], one["params"])

    want = np.asarray(jax.jit(lambda *t: sdpa_reference(
        *t, None, True, None))(q, k, v))
    for out in (ring_c[0], ring_z[0]):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ring_c[0], ring_z[0], rtol=2e-5, atol=2e-6)

    jax_losses = [ce(lg, y) for lg, y in zip(logits.reshape(M, mbs, -1),
                                             lbl)]
    for r, o in enumerate(outs):
        out = o[4]
        assert out["stage"] == r % 2      # rank = dp index * 2 + stage
        assert np.isfinite(out["losses"]).all()
        np.testing.assert_allclose(out["losses"], jax_losses, rtol=1e-5)
        np.testing.assert_allclose(out["losses"], out["serial"], rtol=1e-6)
        assert out["covered"] and out["n_grads"] > 0
        assert max(out["errs"].values()) <= 2e-5, out["errs"]
