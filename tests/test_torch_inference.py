"""The port's `inference.create_predictor` against the JAX `Predictor` on
the CPU: one `save_inference_model` artifact (written by the port, the
JAX package's bytes) served by both, with the IR passes on and off, at
the JAX test's limits (rtol 2e-4, atol 2e-5; `tests/test_ir_passes.py`).
The JAX Predictor reads the artifact's params through the pure-Python
`ptc_format` (`_torch_static.jax_predictor_loader`). Also: the rewrite
to `fused_sdpa`, batch bucketing, greedy `generate`, the device rule,
fleet's static metrics and `minimize`, and the raises of what waits."""
import numpy as np
import pytest

from _torch_parity import keep_global_rng  # noqa: F401
from _torch_static import (static_feed, fluids, jax_predictor_loader,  # noqa
                           no_cuda, static_params, static_ernie)

pytestmark = pytest.mark.usefixtures("keep_global_rng",
                                     "jax_predictor_loader")

TINY = dict(vocab=1024, hidden=64, layers=2, heads=4, ffn=128, max_pos=128,
            type_vocab=2, seq=16)


def _save(tmp_path, build, params_seed=0, name="m"):
    """Save the port-built program with random weights; returns the
    artifact's directory."""
    from paddle_tpu_torch.convert import from_jax_scope

    jf, tf = fluids()
    main, startup, feeds, outs = build(tf)
    scope = from_jax_scope(static_params(startup, params_seed), tf.Scope(),
                           "cpu")
    d = str(tmp_path / name)
    with tf.scope_guard(scope):
        tf.io.save_inference_model(d, feeds, outs,
                                   tf.Executor(tf.CPUPlace()),
                                   main_program=main)
    return d


def _run_both(tpred, jpred, feed):
    jf, _ = fluids()
    got = tpred.run([feed[n] for n in tpred.get_input_names()])
    with jf.scope_guard(jpred._scope_holder):
        want = jpred.run([feed[n] for n in jpred.get_input_names()])
    return got, want


def _jax_predictor(d, ir_optim=True):
    """The JAX Predictor of `d`, its params in a scope of its own."""
    import paddle_tpu.inference as JI

    jf, _ = fluids()
    scope = jf.Scope()
    with jf.scope_guard(scope):
        jc = JI.Config(d)
        jc.switch_ir_optim(ir_optim)
        pred = JI.create_predictor(jc)
    pred._scope_holder = scope
    return pred


def _ernie(fluid):
    return static_ernie(fluid, **TINY)


@pytest.mark.parametrize("ir_optim", [True, False], ids=["ir", "no_ir"])
def test_static_ernie_predictor_matches_the_jax_predictor(tmp_path,
                                                          ir_optim):
    import paddle_tpu_torch.inference as TI

    d = _save(tmp_path, _ernie)
    tc = TI.Config(d)
    tc.disable_gpu()
    tc.switch_ir_optim(ir_optim)
    tpred = TI.create_predictor(tc)
    jpred = _jax_predictor(d, ir_optim)
    assert [op.type for op in tpred._program.global_block().ops] == \
        [op.type for op in jpred._program.global_block().ops]
    assert tpred.get_input_names() == jpred.get_input_names()
    assert tpred.get_output_names() == jpred.get_output_names()
    feed = static_feed(1, 4, TINY["seq"], TINY["vocab"])
    got, want = _run_both(tpred, jpred, feed)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_loaded_program_runs_attention_through_fused_sdpa(tmp_path):
    """The passes turn every layer's matmul-add-softmax-matmul into one
    fused_sdpa with the key-padding bias as its mask; the valid rows are
    unchanged bit for bit when the padded positions' ids change."""
    import paddle_tpu_torch.inference as TI

    d = _save(tmp_path, _ernie, 2)
    cfg = TI.Config(d)
    cfg.disable_gpu()
    pred = TI.create_predictor(cfg)
    types = [op.type for op in pred._program.global_block().ops]
    assert types.count("fused_sdpa") == TINY["layers"]
    assert "softmax" not in types and "matmul" not in types
    sdpa = [op for op in pred._program.global_block().ops
            if op.type == "fused_sdpa"]
    assert all(op.input("Mask") for op in sdpa)
    assert sdpa[0].attrs["scale"] == pytest.approx(
        (TINY["hidden"] // TINY["heads"]) ** -0.5)
    feed = static_feed(3, 4, TINY["seq"], TINY["vocab"])
    seq, pooled = pred.run([feed[n] for n in pred.get_input_names()])
    other = dict(feed)
    rs = np.random.RandomState(9)
    pad = feed["input_mask"] == 0
    other["src_ids"] = np.where(pad, rs.randint(1, TINY["vocab"],
                                                pad.shape), feed["src_ids"])
    assert (other["src_ids"] != feed["src_ids"]).any()
    seq2, pooled2 = pred.run([other[n] for n in pred.get_input_names()])
    valid = ~pad
    assert np.array_equal(seq[valid], seq2[valid])
    assert np.array_equal(pooled, pooled2)


def _attention_prog(fluid, with_scale, with_mask):
    """tests/test_ir_passes.py's raw attention program."""
    H, T, D = 2, 4, 8
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        blk = main.global_block()
        q = fluid.layers.data("q", [H, T, D])
        k = fluid.layers.data("k", [H, T, D])
        v = fluid.layers.data("v", [H, T, D])
        mask = fluid.layers.data("mask", [1, T, T])

        def op(t, ins, attrs=None):
            o = blk.create_var(name=f"{t}_{len(blk.ops)}")
            blk.append_op(type=t, inputs=ins, outputs={"Out": [o]},
                          attrs=attrs or {})
            return o

        cur = op("matmul", {"X": [q], "Y": [k]}, {"transpose_Y": True})
        if with_scale:
            cur = op("scale", {"X": [cur]}, {"scale": D ** -0.5,
                                             "bias": 0.0})
        if with_mask:
            cur = op("elementwise_add", {"X": [cur], "Y": [mask]},
                     {"axis": -1})
        sm = op("softmax", {"X": [cur]}, {"axis": -1})
        out = op("matmul", {"X": [sm], "Y": [v]}, {"transpose_Y": False})
    return main, startup, ["q", "k", "v", "mask"], [out]


@pytest.mark.parametrize("with_scale,with_mask",
                         [(True, True), (True, False), (False, False)])
def test_attention_artifact_fuses_and_matches(tmp_path, with_scale,
                                              with_mask):
    d = _save(tmp_path, lambda f: _attention_prog(f, with_scale, with_mask))
    import paddle_tpu_torch.inference as TI

    cfg = TI.Config(d)
    cfg.disable_gpu()
    tpred = TI.create_predictor(cfg)
    jpred = _jax_predictor(d)
    types = [o.type for o in tpred._program.global_block().ops]
    assert "fused_sdpa" in types and "softmax" not in types
    rs = np.random.RandomState(0)
    B, H, T, D = 2, 2, 4, 8
    mask = np.zeros((B, 1, T, T), np.float32)
    mask[1, ..., 3] = -10000.0
    feed = {"q": rs.randn(B, H, T, D).astype("float32"),
            "k": rs.randn(B, H, T, D).astype("float32"),
            "v": rs.randn(B, H, T, D).astype("float32"), "mask": mask}
    for n, v in feed.items():
        tpred.get_input_handle(n).copy_from_cpu(v)
    tpred.run()
    got = tpred.get_output_handle(tpred.get_output_names()[0]).copy_to_cpu()
    _, want = _run_both(tpred, jpred, feed)
    np.testing.assert_allclose(got, want[0], rtol=2e-4, atol=2e-5)


def test_batch_bucketing_pads_and_slices_as_jax(tmp_path):
    d = _save(tmp_path, _ernie, 4)
    import paddle_tpu_torch.inference as TI

    tpred = TI.create_predictor(_cpu(TI.Config(d)))
    jpred = _jax_predictor(d)
    feed = static_feed(5, 3, TINY["seq"], TINY["vocab"])
    got, want = _run_both(tpred, jpred, feed)
    assert got[0].shape[0] == 3
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-5)
    off = TI.Config(d)
    off.switch_batch_bucketing(False)
    plain = TI.create_predictor(_cpu(off)).run(
        [feed[n] for n in tpred.get_input_names()])
    np.testing.assert_allclose(plain[0], got[0], rtol=1e-6, atol=1e-6)


def _cpu(cfg):
    cfg.disable_gpu()
    return cfg


def _tiny_lm(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("tok", [-1, -1], dtype="int64",
                                append_batch_size=False)
        h = fluid.layers.embedding(ids, [11, 8], param_attr="lm_emb")
        logits = fluid.layers.fc(fluid.layers.tanh(h), 11,
                                 num_flatten_dims=2)
    return main, startup, ["tok"], [logits]


def test_generate_greedy_tokens_equal_the_jax_predictor(tmp_path):
    d = _save(tmp_path, _tiny_lm, 7)
    import paddle_tpu_torch.inference as TI

    tpred = TI.create_predictor(_cpu(TI.Config(d)))
    jpred = _jax_predictor(d)
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int64)
    toks, lens = tpred.generate(prompt, max_new_tokens=5, eos_id=None)
    jf, _ = fluids()
    with jf.scope_guard(jpred._scope_holder):
        jtoks, jlens = jpred.generate(prompt, max_new_tokens=5, eos_id=None)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(lens, jlens)


def test_predictor_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    import paddle_tpu_torch.inference as TI

    d = _save(tmp_path, _ernie, 6)
    cfg = TI.Config(d)
    assert cfg.use_gpu()
    if no_cuda():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TI.create_predictor(cfg)
    else:
        assert TI.create_predictor(cfg).device.type == "cuda"
    cfg.disable_gpu()
    assert not cfg.use_gpu()
    assert TI.create_paddle_predictor(cfg).device.type == "cpu"
    assert TI.AnalysisConfig is TI.Config


def test_what_waits_raises_with_its_sub_item(tmp_path):
    import paddle_tpu_torch.inference as TI

    d = _save(tmp_path, _ernie, 8)
    cfg = _cpu(TI.Config(d))
    for call, item in ((cfg.enable_native_engine, "8e"),
                       (cfg.enable_serving_engine, "8d")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            call()
    pred = TI.create_predictor(cfg)
    for call, item in ((lambda: pred.serve(), "8d"),
                       (lambda: pred.export_stablehlo({}), "8d"),
                       (lambda: pred._generate_serving(None, 1, None), "8d"),
                       (lambda: TI.ArtifactServingEngine(None), "8d"),
                       (lambda: pred.get_input_handle("src_ids").set_lod(
                           [[0, 1]]), "8b")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            call()


def test_fleet_metrics_read_static_vars_and_minimize_a_program():
    """fleet.metrics takes a static variable (or its name) from the
    scope; MetaOptimizer.minimize on a program's loss runs the inner
    fluid optimizer (with recompute's checkpoints on the autodiff op)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import metrics

    jf, tf = fluids()
    main, startup = tf.Program(), tf.Program()
    with tf.unique_name.guard(), tf.program_guard(main, startup):
        x = tf.layers.data("x", [3], dtype="float32")
        h = tf.layers.fc(x, 4, act="relu")
        loss = tf.layers.mean(h)
        strategy = fleet.DistributedStrategy()
        strategy.recompute = True
        strategy.recompute_configs = {"checkpoints": [h.name]}
        opt = fleet.MetaOptimizer(tf.optimizer.SGD(0.1), strategy, None)
        opt.minimize(loss)
    ad = [op for op in main.global_block().ops
          if op.type == "jax_autodiff"][0]
    assert ad.attrs["checkpoints"] == [h.name]
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).rand(5, 3).astype(np.float32)}
    first = exe.run(main, feed, [loss], scope=scope)[0]
    for _ in range(3):
        last = exe.run(main, feed, [loss], scope=scope)[0]
    assert last < first
    with tf.scope_guard(scope):
        w = scope.get_value("fc_0.w_0").numpy()
        # one trainer: the all-reduce is the identity
        np.testing.assert_array_equal(metrics.sum("fc_0.w_0"), w)
        np.testing.assert_array_equal(
            metrics.max(main.global_block().var("fc_0.w_0")), w)
        with pytest.raises(KeyError, match="not in scope"):
            metrics.sum("nope")
