"""The port's mesh trainer against the JAX package's on the CPU: the mesh,
the sharding rules, `functionalize`, `SpmdTrainer` over dp, tp, dp x tp
and ep, the MoE layer over ep, `SyncBatchNorm` and
`DevicePrefetcher(sharding=)` (the counterparts of `tests/test_parallel.py`
and the ep and SyncBatchNorm cases of the multi-GPU slice).

The JAX side runs in this process on the 8 CPU devices that
`conftest.py` pins; the port's side runs in gloo ranks of one module-wide
`_torch_dist_ranks.RankPool` (4 processes, each on one intra-op thread,
a fresh `file://` rendezvous a task). Inputs come from a numpy seed, the
port's weights from the JAX model's (`convert.from_jax_state`), and the
whole-model runs use dropout 0.

Limits. A world of one rank is bit for bit the one-device trainer.
Data and tensor parallelism move float32 reductions (the gradient mean,
the row-parallel sums): losses and the parameter vector after the steps
are held to the JAX run within 1e-5 relative L2 (`rel_l2`), each
parameter within 1e-5 of its norm (or of 1, for a key bias whose
gradient is zero up to rounding; `assert_params`); so is the ep=2 MoE
step, whose expert rows join exactly but whose gradients go through the
same means.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu.parallel import COMMON_TP_RULES as JAX_TP_RULES
from paddle_tpu.parallel import SpmdTrainer as JaxTrainer
from paddle_tpu.parallel import functionalize as jax_functionalize
from paddle_tpu.parallel import init_mesh as jax_init_mesh
from paddle_tpu.text import ErnieConfig as JaxConfig
from paddle_tpu.text import ErnieForSequenceClassification as JaxErnie

import _torch_dist_ranks as R
from _torch_parity import np_state
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.parallel import (COMMON_TP_RULES, SpmdTrainer,
                                       auto_mesh, batch_sharding,
                                       functionalize, infer_param_specs,
                                       init_mesh, named_sharding,
                                       serving_param_rules)

REL = R.REL
rel_l2, assert_params = R.rel_l2, R.assert_params
NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def pool():
    """Started with the module's first test, so that the ranks' start-up
    overlaps the tests that need no rank (they come first)."""
    p = R.RankPool(4)
    yield p
    p.close()


def jax_ce(logits, labels):
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.take_along_axis(logp, labels[:, None], -1).mean()


# ------------------------------------------------------------ the mesh
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dropout_address_shard_is_the_slice_of_the_full_call(dtype):
    """The flash kernels' plain versions on a (batch, head) shard with its
    address (b0, h0, heads) give the slice of the full call's out, lse,
    dq, dk and dv bit for bit, and the shard's keep mask is the JAX
    dropout_keep_reference's rows; the address of an unsharded call
    (0, 0, H) changes nothing."""
    from paddle_tpu.ops.attention import \
        dropout_keep_reference as jax_keep

    from paddle_tpu_torch.ops import attention as A

    B, H, s, d, p, seed = 4, 6, 48, 16, 0.2, 1234
    rs = np.random.RandomState(2)
    q, k, v, g = (torch.from_numpy(rs.randn(B, H, s, d).astype(np.float32))
                  .to(dtype) for _ in range(4))
    bias = torch.from_numpy(np.where(rs.rand(B, s) < 0.2, -1e4, 0.0)
                            .astype(np.float32))
    full = A.drop_spec(p, seed, s, s, 16, 16)
    assert A.drop_spec(p, seed, s, s, 16, 16, (0, 0, H)) == \
        full._replace(heads=H)
    out, lse = A.flash_attention_fwd_plain(q, k, v, bias, True, None, full)
    grads = A.flash_attention_bwd_plain(q, k, v, bias, out, lse, g, True,
                                        None, full)[:3]
    keep_full = jax_keep(seed, B, H, s, s, 16, 16, p).reshape(B, H, s, s)
    for b0, nb, h0, nh in ((2, 2, 3, 3), (1, 1, 0, 2), (0, 4, 4, 2)):
        sl = (slice(b0, b0 + nb), slice(h0, h0 + nh))
        spec = A.drop_spec(p, seed, s, s, 16, 16, (b0, h0, H))
        ts = [t[sl] for t in (q, k, v, g)]
        o2, l2 = A.flash_attention_fwd_plain(ts[0], ts[1], ts[2],
                                             bias[b0:b0 + nb], True, None,
                                             spec)
        assert torch.equal(o2, out[sl])
        assert torch.equal(l2.reshape(nb, nh, s, 1),
                           lse.reshape(B, H, s, 1)[sl])
        g2 = A.flash_attention_bwd_plain(ts[0], ts[1], ts[2],
                                         bias[b0:b0 + nb], o2, l2, ts[3],
                                         True, None, spec)[:3]
        for a, want in zip(g2, grads):
            assert torch.equal(a, want[sl])
        keep = A.dropout_keep_reference(seed, nb, nh, s, s, 16, 16, p,
                                        b0=b0, h0=h0, heads=H)
        np.testing.assert_array_equal(
            keep.reshape(nb, nh, s, s).numpy(), keep_full[sl])
    # the unsharded address is the old hash
    np.testing.assert_array_equal(
        A.dropout_keep_reference(seed, B, H, s, s, 16, 16, p).numpy(),
        keep_full.reshape(B * H, s, s))


def test_mesh_without_a_device_raises_on_a_box_with_no_card():
    """A mesh resolves its device as every entry point does: None is the
    card (or `init_parallel_env`'s device), which a box without one
    refuses."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        auto_mesh(1)
    assert auto_mesh.__module__ == "paddle_tpu_torch.parallel.mesh"


def test_one_process_mesh_and_a_mesh_that_does_not_fit():
    """No group: a mesh of one rank; a mesh of more ranks than the world
    raises (the JAX `test_bad_mesh`)."""
    m = init_mesh(devices="cpu")
    assert m.shape == {"dp": 1, "pp": 1, "tp": 1, "sp": 1, "ep": 1}
    with pytest.raises(ValueError, match="needs 15 ranks"):
        init_mesh(dp=3, tp=5, devices="cpu")


def test_sharding_rules_are_the_jax_tables():
    for port, ref in ((COMMON_TP_RULES, JAX_TP_RULES),):
        assert [(p.pattern, s) for p, s in port.rules] == \
            [(p.pattern, s) for p, s in ref.rules]
    from paddle_tpu.parallel import serving_param_rules as jax_serving

    for layout in ("gathered", "megatron"):
        assert [(p.pattern, s) for p, s in serving_param_rules(layout)
                .rules] == [(p.pattern, s) for p, s in jax_serving(layout)
                            .rules]
    specs = infer_param_specs({"a.q_proj.weight": torch.zeros(4, 4),
                               "x.bias": torch.zeros(3)}, COMMON_TP_RULES)
    assert specs == {"a.q_proj.weight": (None, "tp"), "x.bias": (None,)}
    # on a mesh of one rank nothing splits
    m = init_mesh(devices="cpu")
    assert not named_sharding((None, "tp"), m).is_split
    assert batch_sharding(m).spec == (None,)


# ------------------------------------------------------- functionalize
def test_functionalize_pure_apply_state_buffers_and_rng():
    net = R.mlp()
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8)
                         .astype(np.float32))
    fm = functionalize(net)
    out, _ = fm.apply(fm.params(), fm.buffers(), None, x, training=False)
    torch.testing.assert_close(out, net(x), rtol=0, atol=0)
    before = {k: v.detach().clone() for k, v in fm.params().items()}
    fm.apply({k: v * 0 for k, v in fm.params().items()}, fm.buffers(),
             None, torch.zeros(2, 8), training=False)
    for k, v in fm.params().items():
        assert torch.equal(v, before[k])
    bn = torch.nn.Sequential(tnn.Linear(8, 8, device="cpu"),
                             tnn.BatchNorm1D(8, device="cpu"))
    fb = functionalize(bn)
    _, new = fb.apply(fb.params(), fb.buffers(), None,
                      torch.randn(16, 8), training=True)
    assert any(not torch.equal(new[k], fb.buffers()[k]) for k in new)
    assert torch.equal(fb.buffers()["1._mean"], torch.zeros(8))
    drop = tnn.Dropout(0.5)
    fd = functionalize(drop)
    a, _ = fd.apply({}, {}, 0, torch.ones(64))
    b, _ = fd.apply({}, {}, 1, torch.ones(64))
    a2, _ = fd.apply({}, {}, 0, torch.ones(64))
    assert not torch.equal(a, b) and torch.equal(a, a2)
    assert bool(((a == 0) | (a == 2.0)).all())


# ------------------------------------------------------------ training
def mlp_case(seed=0):
    paddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    rs = np.random.RandomState(seed)
    x = rs.randn(16, 8).astype("float32")
    y = (x.sum(1) > 0).astype("int64")
    return net, x, y


def test_world_of_one_is_the_one_device_trainer_bitwise(pool):
    jnet, x, y = mlp_case()
    spec = dict(model="mlp", state=np_state(jnet), batch=((x,), y), steps=3,
                mesh={"dp": 1}, opt=("adamw", {"learning_rate": 1e-2}),
                clip=1.0)
    got = pool.run(1, "train", spec)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = SpmdTrainer(R.build(spec), R.ce, R.optimizer(spec),
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
        losses = [float(tr.step((x,), y)) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    assert got["losses"] == losses
    for n, p in tr.params.items():
        assert np.array_equal(got["params"][n], p.detach().numpy()), n


@pytest.fixture(scope="module")
def mlp_jax():
    """Five SGD steps of the MLP on the JAX dp=8 mesh."""
    jnet, x, y = mlp_case()
    state = np_state(jnet)
    jax_init_mesh(dp=8)
    jtr = JaxTrainer(jnet, jax_ce, jfopt.sgd(0.1))
    losses = [float(jtr.step((x,), y, rng=jax.random.PRNGKey(7)))
              for _ in range(5)]
    return dict(state=state, x=x, y=y, losses=losses,
                params={n: np.asarray(v) for n, v in jtr.params.items()})


def test_dp_matches_the_jax_mesh_and_one_device(pool, mlp_jax):
    j = mlp_jax
    spec = dict(model="mlp", state=j["state"], batch=((j["x"],), j["y"]),
                steps=5, mesh={"dp": 4})
    got = pool.run(4, "train", spec)[0]
    assert rel_l2(got["losses"], j["losses"]) <= REL
    assert_params(got["params"], j["params"])


def test_grad_accum_remat_and_run_epoch_on_the_mesh(pool, mlp_jax):
    """grad_accum=2 over dp=2 (each rank takes its rows of each
    micro-batch) equals the JAX big-batch steps; remat changes nothing;
    run_epoch through DevicePrefetcher(sharding=) equals stepping."""
    j = mlp_jax
    base = dict(model="mlp", state=j["state"], batch=((j["x"],), j["y"]),
                steps=5, mesh={"dp": 2})
    acc, plain, remat, epoch = pool.run(2, "many", [
        ("train", (dict(base, grad_accum=2, eval=True),)),
        ("train", (dict(base, eval=True),)),
        ("train", (dict(base, remat=True),)),
        ("train", (dict(base, epoch=True),))])[0]
    assert rel_l2(acc["losses"], j["losses"]) <= REL
    assert_params(acc["params"], j["params"])
    # eval_step gathers the global batch's outputs in its order, whatever
    # grad_accum interleaves for the steps
    assert acc["eval"].shape == (16, 4)
    np.testing.assert_allclose(acc["eval"], plain["eval"], rtol=1e-5,
                               atol=1e-6)
    for n in plain["params"]:
        assert np.array_equal(plain["params"][n], remat["params"][n]), n
    assert epoch["losses"][-1] == plain["losses"][-1]
    for n in plain["params"]:
        assert np.array_equal(plain["params"][n], epoch["params"][n]), n


def test_schedule_and_clip_carried_over_on_the_mesh(pool, mlp_jax):
    """An eager optimizer's schedule and global-norm clip reach the mesh
    trainer's rule (the JAX `TestFromEager` cases, on dp=2)."""
    j = mlp_jax
    got = pool.run(2, "schedule_and_clip", dict(
        model="mlp", state=j["state"], batch=((j["x"],), j["y"]),
        mesh={"dp": 2}))[0]
    assert got["small"] < got["big"] * 0.5       # lr 0.5 -> 0.05
    assert got["clipped"] < 1e-3                 # clip_norm 1e-6, lr 10


def ernie_case(seed=0, **cfg):
    paddle.seed(seed)
    kw = dict(NO_DROPOUT, **cfg)
    jnet = JaxErnie(JaxConfig.tiny(**kw))
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 1000, (8, 16)).astype("int64")
    y = rs.randint(0, 2, (8,)).astype("int64")
    return jnet, kw, ids, y


@pytest.fixture(scope="module")
def ernie_jax():
    """Two SGD steps of tiny ERNIE (one encoder layer: half the compile)
    on a JAX tp=2 mesh with the Megatron rules, clipped by the global
    norm (the port's tp and dp x tp runs are held to it: the JAX mesh
    program computes the global batch's step on any mesh)."""
    jnet, kw, ids, y = ernie_case(num_layers=1)
    state = np_state(jnet)
    jax_init_mesh(tp=2, devices=jax.devices()[:2])
    from paddle_tpu.optimizer import SGD

    opt = SGD(0.5, parameters=jnet.parameters(),
              grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jtr = JaxTrainer(jnet, jax_ce, opt, rules=JAX_TP_RULES)
    losses = [float(jtr.step((ids,), y)) for _ in range(2)]
    return dict(state=state, cfg=kw, ids=ids, y=y, losses=losses,
                params={n: np.asarray(v) for n, v in jtr.params.items()})


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "dp2xtp2"])
def test_tp_sharded_params_and_step_match_jax(pool, ernie_jax, mesh):
    e = ernie_jax
    spec = dict(model="ernie", cfg=e["cfg"], state=e["state"],
                batch=((e["ids"],), e["y"]), steps=2, mesh=mesh, rules=True,
                opt=("sgd", {"learning_rate": 0.5}), clip=1.0)
    world = int(np.prod(list(mesh.values())))
    got = pool.run(world, "train", spec)[0]
    q = "ernie.encoder.layers.0.self_attn.q_proj.weight"
    assert got["local"][q] == (64, 32)
    assert got["local"]["ernie.embeddings.word_embeddings.weight"] == \
        (512, 64)
    assert got["local"]["ernie.encoder.layers.0.linear2.weight"] == (64, 64)
    assert rel_l2(got["losses"], e["losses"]) <= REL
    assert_params(got["params"], e["params"])
    # sync_to_layer gathered the same full parameters into the layer
    for n, p in got["params"].items():
        assert np.array_equal(got["synced"][n], p), n
    # convert.from_jax_state / from_jax_optimizer_state with the rules
    # cut the JAX state into the blocks the trainer holds
    assert got["convert_ok"] is True


def _pretrain_batch(b=4, s=16, vocab=512, seed=3):
    """(ids, token types, mask), labels [b, s + 1]: the same count of
    masked-LM targets in every row, so the dp mean of the rows' means is
    the batch's mean."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(4, vocab, (b, s)).astype(np.int64)
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    mask = np.ones((b, s), np.float32)
    labels = np.full((b, s + 1), -1, np.int64)
    for row in range(b):
        pos = rs.choice(s, 3, replace=False)
        labels[row, pos] = ids[row, pos]
        ids[row, pos] = 3
    labels[:, s] = rs.randint(0, 2, b)
    return (ids, tt, mask), labels


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "dp2xtp2"])
def test_tp_pretraining_tied_decoder_is_the_one_rank_step(pool, mesh):
    """ErnieForPretraining's masked-LM decoder is tied to the word table,
    which tp splits over vocabulary rows: each rank's logits of its rows
    are gathered into the whole vocabulary, so the loss and every
    gradient (the tied table's rows getting both the lookup's and the
    decoder's parts) are the one-rank step's, within 1e-5 relative L2."""
    spec = dict(cfg=dict(NO_DROPOUT, vocab_size=512), seed=5,
                batch=_pretrain_batch())
    one = pool.run(1, "pretrain_grads", dict(spec, mesh={"dp": 1}))[0]
    world = int(np.prod(list(mesh.values())))
    got = pool.run(world, "pretrain_grads", dict(spec, mesh=mesh))[0]
    assert got["table"][0] == 512 // 2 and one["table"][0] == 512
    assert rel_l2([got["loss"]], [one["loss"]]) <= REL
    assert set(got["grads"]) == set(one["grads"])
    for n, g in one["grads"].items():
        err = rel_l2(got["grads"][n], g) if np.linalg.norm(g) > 1e-6 \
            else float(np.abs(got["grads"][n] - g).max())
        assert err <= REL, (n, err)


def test_lamb_on_tp_takes_the_whole_parameters_norms(pool, ernie_jax):
    """Lamb's trust ratio ||p|| / ||r|| over a tp=2 mesh is the whole
    parameter's (the blocks' squared norms summed over tp), as on one
    rank."""
    e = ernie_jax
    spec = dict(model="ernie", cfg=e["cfg"], state=e["state"],
                batch=((e["ids"],), e["y"]), rules=True)
    one = pool.run(1, "lamb_on_mesh", dict(spec, mesh={"dp": 1}))[0]
    two = pool.run(2, "lamb_on_mesh", dict(spec, mesh={"tp": 2}))[0]
    # the key biases' gradient is zero but for rounding (softmax ignores
    # a shift of a row's logits), and Lamb's r = m / (sqrt(v) + eps)
    # turns that rounding into an update of lr a step, of either sign:
    # they are left out of the comparison
    keep = [n for n in one if not n.endswith("k_proj.bias")]
    assert len(keep) == len(one) - 1
    assert_params({n: two[n] for n in keep}, {n: one[n] for n in keep})


def test_remat_on_tp_with_dropout_replays_every_mask(pool, ernie_jax):
    """remat on a tp=2 mesh with hidden and attention dropout 0.1: the
    recompute replays the trainer's generators (the attention seeds',
    the hidden masks' and the split feed-forward's), so two steps with
    remat give the losses and parameters of two without, bit for bit;
    the dropout is live (the losses move off the dropout-0 run's)."""
    e = ernie_jax
    spec = dict(model="ernie", state=e["state"],
                cfg=dict(e["cfg"], hidden_dropout=0.1, attn_dropout=0.1),
                batch=((e["ids"],), e["y"]), steps=2, mesh={"tp": 2},
                rules=True, lean=True)
    plain, remat, off = pool.run(2, "many", [
        ("train", (spec,)), ("train", (dict(spec, remat=True),)),
        ("train", (dict(spec, cfg=e["cfg"]),))])[0]
    assert remat["losses"] == plain["losses"]
    for n in plain["params"]:
        assert np.array_equal(remat["params"][n], plain["params"][n]), n
    assert rel_l2(plain["losses"], off["losses"]) > 1e-3


def test_attention_dropout_on_dp_x_tp_is_the_one_rank_step(pool, ernie_jax):
    """Attention dropout 0.1 (hidden dropout 0) at dp2 x tp2: each rank's
    shard draws the one-rank call's keep bits of its rows and heads
    (`shard_layer`'s dropout address), so two clipped SGD steps equal
    the one-rank steps within 1e-5; the dropout is live (the losses move
    off the JAX dropout-0 run's)."""
    e = ernie_jax
    spec = dict(model="ernie", state=e["state"],
                cfg=dict(e["cfg"], attn_dropout=0.1),
                batch=((e["ids"],), e["y"]), steps=2, rules=True,
                lean=True, opt=("sgd", {"learning_rate": 0.5}), clip=1.0)
    one = pool.run(1, "train", dict(spec, mesh={"dp": 1}))[0]
    four = pool.run(4, "train", dict(spec, mesh={"dp": 2, "tp": 2}))[0]
    assert rel_l2(one["losses"], e["losses"]) > 1e-3
    assert rel_l2(four["losses"], one["losses"]) <= REL
    assert_params(four["params"], one["params"])


def test_optimizer_slots_take_their_parameters_blocks(pool, ernie_jax):
    e = ernie_jax
    spec = dict(model="ernie", cfg=e["cfg"], state=e["state"],
                batch=((e["ids"],), e["y"]), steps=1, mesh={"tp": 2},
                rules=True, opt=("adamw", {"learning_rate": 1e-3,
                                           "epsilon": 1e-4}))
    got = pool.run(2, "train", spec)[0]
    assert got["slots"] == got["local"]
    assert got["slots"]["ernie.encoder.layers.0.linear1.weight"] == (64, 64)


def test_ep_moe_step_matches_the_jax_ep_mesh(pool):
    """MoE ERNIE (4 experts) one AdamW step: the JAX ep=2 mesh against
    the port at ep=2 (the ep peers hold the same tokens) and at
    dp=2 x ep=2 with ep splitting the batch too (all-to-all; the routing
    over the global batch)."""
    jnet, kw, ids, y = ernie_case(3, moe_experts=4, num_layers=1)
    state = np_state(jnet)
    jax_init_mesh(ep=2, devices=jax.devices()[:2])
    jtr = JaxTrainer(jnet, jax_ce, jfopt.adamw(1e-3, epsilon=1e-4),
                     rules=JAX_TP_RULES)
    assert "ep" in str(jtr.param_specs[
        "ernie.encoder.layers.0.moe.experts.weight_in"])
    want = float(jtr.step((ids,), y))
    spec = dict(model="ernie", cfg=kw, state=state, batch=((ids,), y),
                steps=1, rules=True,
                opt=("adamw", {"learning_rate": 1e-3, "epsilon": 1e-4}))
    for mesh, axes in (({"ep": 2}, ("dp",)),
                       ({"dp": 2, "ep": 2}, ("dp", "ep"))):
        world = int(np.prod(list(mesh.values())))
        got = pool.run(world, "train", dict(spec, mesh=mesh,
                                            batch_axes=axes))[0]
        w = "ernie.encoder.layers.0.moe.experts.weight_in"
        assert got["local"][w] == (2, 64, 128), (mesh, axes)
        assert rel_l2(got["losses"], [want]) <= REL, (mesh, axes)
        assert_params(got["params"], {n: np.asarray(v)
                                      for n, v in jtr.params.items()})


def test_sync_batchnorm_matches_batchnorm_on_the_whole_batch(pool):
    rs = np.random.RandomState(0)
    x = rs.randn(8, 6, 5, 5).astype(np.float32)
    w = rs.rand(6).astype(np.float32) + 0.5
    b = rs.randn(6).astype(np.float32)
    got = pool.run(2, "sync_bn", x, w, b)[0]
    bn = tnn.BatchNorm2D(6, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = bn(tx)
    cot = torch.from_numpy(np.random.RandomState(1).randn(*x.shape)
                           .astype(np.float32))
    (ty * cot).sum().backward()
    want = {"y": ty, "dx": tx.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn._mean, "var": bn._variance}
    for k, v in want.items():
        assert rel_l2(got[k], v.detach().numpy()) <= REL, k
    # and the JAX layer (one process, its whole batch)
    jl = jnn.SyncBatchNorm(6)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    fm = jax_functionalize(jl)

    @jax.jit
    def jax_bn(xs, c):
        y, vjp = jax.vjp(lambda t: fm.apply(fm.params(), fm.buffers(), None,
                                            t, training=True)[0], xs)
        return y, vjp(c)[0]

    jy, jdx = jax_bn(x, cot.numpy())
    assert rel_l2(got["y"], np.asarray(jy)) <= REL
    assert rel_l2(got["dx"], np.asarray(jdx)) <= REL
    # one rank: SyncBatchNorm is BatchNorm
    one = tnn.SyncBatchNorm(6, device="cpu")
    with torch.no_grad():
        one.weight.copy_(torch.from_numpy(w))
        one.bias.copy_(torch.from_numpy(b))
    assert torch.equal(one(torch.from_numpy(x)), ty.detach())
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(
        torch.nn.Sequential(tnn.BatchNorm2D(6, device="cpu")))
    assert isinstance(conv[0], tnn.SyncBatchNorm)
