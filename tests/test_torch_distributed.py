"""The port's `distributed` package on the CPU: the eager collectives and
the `c_*` ops against numpy, `DataParallel` against the mean of the
ranks' gradients, `spawn` and `launch_collective` with two processes,
`FileStore` and `TCPStore` (the JAX package's `distributed/`).

The ranks are gloo processes of one module-wide
`_torch_dist_ranks.RankPool` (4 of them, one intra-op thread each, a
fresh `file://` rendezvous a task). A one-process world (no group) makes
every collective the identity, as in the JAX package. Collectives of
float32 sums are held to numpy's float64 within 1e-6 relative; the
others are exact.
"""
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn

import _torch_dist_ranks as R
from _torch_parity import np_state
from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.distributed import launch, rendezvous

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def pool():
    """Started with the module's first test, so that the ranks' start-up
    overlaps the tests that need no rank (they come first)."""
    p = R.RankPool(4)
    yield p
    p.close()


_SCRIPT = """
import os, sys
import torch
from paddle_tpu_torch import distributed as D
torch.set_num_threads(1)
D.init_parallel_env(device="cpu")
t = D.all_reduce(torch.tensor([float(D.get_rank() + 1)]))
with open(os.path.join(sys.argv[1], f"rank{D.get_rank()}"), "w") as f:
    f.write(f"{D.get_world_size()} {float(t[0])} {os.environ['LOCAL_RANK']}")
"""


def test_spawn_and_launch_collective_run_two_ranks_each(tmp_path):
    """`spawn` (two processes running a function) and `launch_collective`
    (two processes running a script), side by side: every rank joins its
    world of two and all-reduces its id + 1."""
    spawned = tmp_path / "spawned"
    spawned.mkdir()
    procs = D.spawn(R.spawn_worker, args=(str(spawned),), nprocs=2,
                    join=False)
    script = tmp_path / "train.py"
    script.write_text(_SCRIPT)
    out = tmp_path / "out"
    out.mkdir()
    env = {"PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    rc = launch.launch_collective([str(script), str(out)], nproc=2,
                                  extra_env=env)
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        assert (spawned / f"rank{r}").read_text() == "2 3.0"
    assert rc == 0
    for r in range(2):
        assert (out / f"rank{r}").read_text() == f"2 3.0 {r}"
    # a rank that fails ends the job with its code
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    assert launch.launch_collective([str(bad)], nproc=2) == 3
    # the parameter-server mode: a trainer that fails ends the job with
    # its code and the pserver is stopped (the full launch_ps run is in
    # test_torch_ps.py)
    assert launch.main(["--server_num", "1", "--worker_num", "1",
                        str(bad)]) == 3
    assert launch._free_ports(2)[0] > 0


def test_file_store_and_tcp_store():
    with tempfile.TemporaryDirectory() as d:
        fs = rendezvous.FileStore(d, world_size=2)
        fs.set("k", "v")
        assert fs.get("k") == b"v"
        with pytest.raises(TimeoutError):
            fs.get("missing", timeout=0.05)
        done = []
        t = threading.Thread(target=lambda: done.append(
            rendezvous.FileStore(d, 2).barrier(1, timeout=10)))
        t.start()
        fs.barrier(0, timeout=10)
        t.join()
        assert done == [None]
    master = rendezvous.TCPStore(is_master=True, world_size=2, timeout=10)
    try:
        peer = rendezvous.TCPStore(master.host, master.port, world_size=2,
                                   timeout=10)
        peer.set("a", b"1")
        assert master.get("a") == "1"
        assert peer.add("n", 2) == 2 and master.add("n", 3) == 5
        peer.delete("a")
        with pytest.raises(TimeoutError):
            master.get("a", timeout=0.05)
        t = threading.Thread(target=lambda: peer.barrier("b"))
        t.start()
        master.barrier("b")
        t.join()
    finally:
        master.shutdown()


def test_init_parallel_env_without_a_device_raises_on_a_box_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_parallel_env()


def test_one_process_world_is_the_identity():
    x = torch.arange(3.0)
    assert D.get_world_size() == 1 and D.get_rank() == 0
    assert D.all_reduce(x) is x and D.broadcast(x, 0) is x
    assert [t.tolist() for t in D.all_gather([], x)] == [x.tolist()]
    assert D.all_reduce_mean_tree({"a": x})["a"] is x
    D.barrier()


def base(rank):
    return np.arange(6, dtype=np.float64).reshape(2, 3) + rank + 1


def test_eager_collectives_match_numpy(pool):
    world = 4
    outs = pool.run(world, "eager_collectives")
    every = np.stack([base(r) for r in range(world)])
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"]) == (r, world)
        np.testing.assert_allclose(out["sum"], every.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(out["max"], every.max(0))
        np.testing.assert_array_equal(out["min"], every.min(0))
        np.testing.assert_allclose(out["prod"], every.prod(0), rtol=1e-6)
        np.testing.assert_array_equal(out["broadcast"], base(1))
        np.testing.assert_array_equal(np.stack(out["all_gather"]), every)
        np.testing.assert_array_equal(out["scatter"], np.full(3, 10.0 * r))
        np.testing.assert_allclose(out["reduce"], every.sum(0), rtol=1e-6)
        np.testing.assert_allclose(out["mean_tree"], every.mean(0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["shift"], base((r - 1) % world))
        a2a = np.stack([np.arange(world * 2) + 100 * s
                        for s in range(world)])
        np.testing.assert_array_equal(out["all_to_all"],
                                      a2a[:, 2 * r:2 * r + 2].reshape(-1))
        rs = sum(np.arange(world * 2) + s for s in range(world))
        np.testing.assert_array_equal(out["reduce_scatter"],
                                      rs[2 * r:2 * r + 2])


def test_c_collectives_over_mesh_axes_match_numpy(pool):
    outs = pool.run(4, "c_collectives")
    xs = [np.arange(4, dtype=np.float64) + 1 + r for r in range(4)]
    for r, out in enumerate(outs):
        # dp=2 x tp=2, row-major: tp peers r ^ 1, dp peers r ^ 2
        for axis, peers in (("tp", sorted([r, r ^ 1])),
                            ("dp", sorted([r, r ^ 2]))):
            o, grp = out[axis], [xs[p] for p in peers]
            i = peers.index(r)
            np.testing.assert_allclose(o["sum"], sum(grp), rtol=1e-6)
            np.testing.assert_array_equal(o["max"], np.maximum(*grp))
            np.testing.assert_array_equal(o["min"], np.minimum(*grp))
            np.testing.assert_allclose(o["prod"], grp[0] * grp[1],
                                       rtol=1e-5)
            np.testing.assert_array_equal(o["gather"], np.concatenate(grp))
            np.testing.assert_array_equal(o["gather_stacked"],
                                          np.stack(grp))
            np.testing.assert_allclose(o["scatter"],
                                       (grp[0] + grp[1])[2 * i:2 * i + 2],
                                       rtol=1e-6)
            np.testing.assert_array_equal(o["bcast"], grp[1])
            np.testing.assert_array_equal(o["perm"], grp[1 - i])
            # d/dx of sum(allreduce) summed over the group's 2 losses: 2;
            # of sum(gather * arange) over both ranks: this rank's slice
            # of 2 * arange(8)
            want = 2.0 + 2.0 * np.arange(8)[4 * i:4 * i + 4]
            np.testing.assert_allclose(o["grad"], want, rtol=1e-6)


def test_data_parallel_grads_are_the_mean_of_the_ranks(pool):
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    state = np_state(jnet)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randint(0, 4, 16).astype(np.int64)
    outs = pool.run(2, "data_parallel", state, x, y)
    net = R.mlp()
    from paddle_tpu_torch import convert

    net.load_state_dict(convert.from_jax_state(state))
    halves = []
    for sl in (slice(0, 8), slice(8, 16)):
        net.zero_grad()
        R.ce(net(torch.from_numpy(x[sl])), torch.from_numpy(y[sl])) \
            .backward()
        halves.append({k: p.grad.numpy().copy()
                       for k, p in net.named_parameters()})
    assert outs[0]["buckets"] > 1
    for k in halves[0]:
        want = (halves[0][k] + halves[1][k]) / 2
        for out in outs:
            np.testing.assert_allclose(out["grads"][k], want, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    dp = D.DataParallel(net)
    assert dp.scale_loss(torch.tensor(3.0)) == 3.0   # a world of one
    assert dp.state_dict().keys() == net.state_dict().keys()
