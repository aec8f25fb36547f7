"""The port's fleet against the JAX package's, on the CPU:
`StrategyCompiler`'s order, conflicts and requirements over every pair of
strategies (and each alone) under three inner optimizers; the meta
optimizers' trainer kwargs; `build_spmd_trainer` with amp, recompute and
gradient_merge (k_steps 2) against the JAX trainer's step on the same
weights and batch, and bit for bit against the port's `SpmdTrainer` with
the same kwargs; the distributed metrics as all-reduces over two gloo
ranks (the port of `tests/test_fleet_metrics.py`); `LocalSGDSync`; the
file systems; the static-graph saves, which delegate to `fluid.io`.

Limits: the amp step runs bfloat16 products on float32 masters in both
packages, whose CPU matmuls round the bf16 products in their own order:
the loss within 2e-3 relative and the parameters after the steps within
2e-3 relative L2 of the JAX trainer's.
"""
import itertools
import stat

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.distributed.fleet.strategy_compiler import \
    StrategyCompiler as JCompiler
from paddle_tpu.optimizer import functional as jfopt
from paddle_tpu.parallel import init_mesh as jax_init_mesh

import _torch_dist_ranks as R
from _torch_parity import np_state
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.distributed.fleet.strategy_compiler import \
    StrategyCompiler
from paddle_tpu_torch.optimizer import functional as fopt
from paddle_tpu_torch.parallel import SpmdTrainer

NAMES = [k for k in meta._ORDER if k != "graph_execution"]


class Momentum:
    pass


class Adam:
    pass


def _compile(compiler_cls, strategy, inner):
    try:
        return compiler_cls().generate_optimizer(strategy, inner)
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("inner", [None, Momentum(), Adam()],
                         ids=["none", "momentum", "adam"])
def test_strategy_compiler_order_and_conflicts_equal_jax(inner):
    assert meta._ORDER == jmeta._ORDER
    combos = [()] + [(a,) for a in NAMES] + \
        list(itertools.combinations(NAMES, 2))
    for combo in combos:
        js, ts = JStrategy(), DistributedStrategy()
        for k in combo:
            setattr(js, k, True)
            setattr(ts, k, True)
        assert _compile(StrategyCompiler, ts, inner) == \
            _compile(JCompiler, js, inner), combo
        assert meta.applied_meta_list(ts) == jmeta.applied_meta_list(js)
    assert DistributedStrategy().to_dict().keys() == \
        JStrategy().to_dict().keys()


def mlp_case(seed=0):
    paddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    rs = np.random.RandomState(seed)
    x = rs.randn(16, 8).astype("float32")
    return net, x, (x.sum(1) > 0).astype("int64")


def jax_ce(logits, labels):
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.take_along_axis(logp, labels[:, None], -1).mean()


def test_build_spmd_trainer_amp_recompute_gradient_merge_is_the_jax_step():
    jnet, x, y = mlp_case()
    spec = dict(model="mlp", state=np_state(jnet))
    kw = {}
    strategies = []
    for S in (JStrategy, DistributedStrategy):
        st = S()
        st.amp = st.recompute = st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": 2, "avg": True}
        strategies.append(st)
        kw[S] = (jmeta if S is JStrategy else meta).spmd_trainer_kwargs(st)
    assert kw[JStrategy] == kw[DistributedStrategy] == {
        "compute_dtype": "bfloat16", "remat": True, "grad_accum": 2}
    mesh = jax_init_mesh(dp=1, devices=jax.devices()[:1])
    jtr = jmeta.build_spmd_trainer(jnet, jax_ce, strategies[0],
                                   base_optimizer=jfopt.sgd(0.1), mesh=mesh)
    want = [float(jtr.step((x,), y)) for _ in range(2)]

    def port(build):
        tr = build(R.build(spec))
        return tr, [float(tr.step((x,), y)) for _ in range(2)]

    tr, got = port(lambda net: meta.build_spmd_trainer(
        net, R.ce, strategies[1], fopt.sgd(0.1), device="cpu",
        generator=torch.Generator().manual_seed(0)))
    assert tr.compute_dtype == torch.bfloat16 and tr.remat and \
        tr.grad_accum == 2
    assert R.rel_l2(got, want) <= 2e-3
    R.assert_params({n: p.detach().numpy() for n, p in tr.params.items()},
                    {n: np.asarray(v) for n, v in jtr.params.items()},
                    limit=2e-3)
    tr2, got2 = port(lambda net: SpmdTrainer(
        net, R.ce, fopt.sgd(0.1), device="cpu", compute_dtype="bfloat16",
        remat=True, grad_accum=2, generator=torch.Generator().manual_seed(0)))
    assert got2 == got
    for n, p in tr.params.items():
        assert torch.equal(p, tr2.params[n]), n


def test_lamb_lars_dgc_transforms_follow_the_strategy():
    """lamb, and lars wrapped in dgc, are the functional rules with the
    strategy's settings (bitwise: the same Transform)."""
    p = {"w": torch.linspace(-1, 1, 6).reshape(2, 3)}
    g = {"w": torch.linspace(0.5, -0.3, 6).reshape(2, 3)}

    def step(tx):
        return tx.update(p, g, tx.init(p))[0]["w"]

    st = DistributedStrategy()
    st.lamb = True
    st.lamb_configs = {"lamb_weight_decay": 0.02}
    assert torch.equal(step(meta.transform_from_strategy(st, None, 0.1)),
                       step(fopt.lamb(0.1, weight_decay=0.02)))
    st = DistributedStrategy()
    st.lars = st.dgc = True
    assert torch.equal(step(meta.transform_from_strategy(st, None, 0.1)),
                       step(fopt.dgc(fopt.lars_momentum(
                           0.1, lars_coeff=0.001,
                           lars_weight_decay=5e-4))))


@pytest.fixture(scope="module")
def pool():
    p = R.RankPool(2)
    yield p
    p.close()


def test_fleet_metrics_all_reduce_over_two_ranks(pool):
    got = pool.run(2, "fleet_metrics")
    for g in got:
        assert g["sum"] == [3.0, 30.0]
        assert g["max"] == [2.0, 20.0] and g["min"] == [1.0, 10.0]
        assert g["auc"] == got[0]["auc"]
        assert g["acc"] == pytest.approx((8 + 9) / 20.0)
        assert g["mae"] == pytest.approx(3.0 / 4.0)
        assert g["mse"] == pytest.approx(12.0 / 4.0)
        assert g["rmse"] == pytest.approx(np.sqrt(3.0))
    assert 0.8 < got[0]["auc"] <= 1.0
    # one process: the identity, as in JAX
    from paddle_tpu_torch.distributed.fleet import metrics

    metrics.init_metric_context(None, 0, 1)
    np.testing.assert_array_equal(metrics.sum(np.array([2.0, 4.0])),
                                  [2.0, 4.0])
    assert metrics.mse(np.array([16.0]), np.array([4.0])) == 4.0
    np.testing.assert_array_equal(fleet.util.all_reduce(np.array([1.0])),
                                  [1.0])


def test_local_sgd_averages_every_k_steps(pool):
    got = pool.run(2, "local_sgd", 2)
    # step 1: local (1 and 2); step 2: averaged ((2 + 4) / 2 = 3), ...
    assert got[0][0] == [1.0] * 3 and got[1][0] == [2.0] * 3
    assert got[0][1] == got[1][1] == [3.0] * 3
    assert got[0][3] == got[1][3] == [6.0] * 3


def test_local_fs_hdfs_shell_pipe_and_static_saves(tmp_path):
    from paddle_tpu_torch.distributed.fleet.utils import HDFSClient, LocalFS
    from paddle_tpu_torch.distributed.fleet.utils.fs import ExecuteError

    fs = LocalFS()
    d = tmp_path / "sub"
    fs.mkdirs(str(d))
    fs.touch(str(d / "a.txt"))
    (d / "b.txt").write_text("hello")
    assert fs.ls_dir(str(tmp_path)) == (["sub"], [])
    assert fs.ls_dir(str(d))[1] == ["a.txt", "b.txt"]
    assert fs.is_file(str(d / "b.txt")) and fs.cat(str(d / "b.txt")) == \
        b"hello"
    fs.mv(str(d / "b.txt"), str(d / "c.txt"))
    with pytest.raises(ExecuteError, match="exists"):
        fs.mv(str(d / "a.txt"), str(d / "c.txt"))
    fs.delete(str(d))
    assert not fs.is_exist(str(d))
    log, shim = tmp_path / "calls.log", tmp_path / "fakefs"
    shim.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'case "$1" in\n'
        '  -ls) echo "drwxr-xr-x - u g 0 2026-01-01 00:00 /data/sub";'
        ' echo "-rw-r--r-- 1 u g 9 2026-01-01 00:00 /data/f.txt";;\n'
        '  -test) exit 0;;\n'
        '  -cat) echo "content";;\n'
        'esac\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    client = HDFSClient(cmd_prefix=[str(shim)])
    assert client.ls_dir("/data") == (["sub"], ["f.txt"])
    assert client.is_exist("/data/f.txt")
    assert client.cat("/data/f.txt").strip() == b"content"
    client.mkdirs("/data/new")
    assert "-mkdir -p /data/new" in log.read_text()
    with pytest.raises(ExecuteError, match="not found"):
        HDFSClient(cmd_prefix=[str(tmp_path / "nope")]).mkdirs("/x")
    # the static-graph saves delegate to fluid.io, as the JAX fleet's do
    import paddle_tpu_torch.fluid as tfluid

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [3], dtype="float32")
        y = tfluid.layers.fc(x, 2)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        fleet.save_inference_model(exe, str(tmp_path / "inf"), ["x"], [y],
                                   main_program=main)
        fleet.save_persistables(exe, str(tmp_path / "pers"), main)
        tfluid.io.save_inference_model(str(tmp_path / "ref"), ["x"], [y],
                                       exe, main_program=main)
    for name in ("__model__", "__params__"):
        assert (tmp_path / "inf" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    assert (tmp_path / "pers" / "__params__").exists()
