"""The port's parameter server against the JAX package's, on the CPU (the
counterpart of `tests/test_ps.py`, `train_from_dataset` left out: it
waits for the port's static stack).

Both packages drive the same C server (`csrc/ptcore/ps_server.cc`): the
JAX package through its `libptcore`, the port through its own build of
that one file (`distributed/ps/_native.py`). For the same pushes the
port's pulls equal the JAX client's bit for bit, dense and sparse, under
each server rule; the bf16 wire's bytes equal the JAX client's (torch's
bfloat16 rounds to nearest even, as ml_dtypes does); a JAX server's
snapshot loads into the port's server. `launch_ps` runs one pserver and
two trainers to the JAX test's convergence; `TrainEpochRange(
ps_communicator=)` restores the tables after a restart. Where a test
checks an update against its formula, the limits are the JAX test's.
"""
import os
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.core import native
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.distributed.ps import (Communicator,
                                             DistributedLookupTable,
                                             MergedSparseStream, PsClient,
                                             PsServer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = np.dtype(ml_dtypes.bfloat16)


def _server(trainers=1, optimizer="sgd", lr=0.1):
    return PsServer(port=0, trainers=trainers, optimizer=optimizer, lr=lr)


def _jax_server(**kw):
    from paddle_tpu.distributed.ps import PsServer as JServer

    if not native.available():
        pytest.skip("the JAX package's native library is unavailable")
    return JServer(port=0, **kw)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_pulls_equal_the_jax_client_bit_for_bit(rule):
    """The same init, dense pushes and sparse pushes through a JAX server
    with the JAX client and through a port server with the port client:
    every dense and sparse pull equal bit for bit (and the port client
    reads the JAX server alike)."""
    from paddle_tpu.distributed.ps import PsClient as JClient

    rs = np.random.RandomState(0)
    w0 = rs.randn(6, 5).astype(np.float32)
    grads = [rs.randn(6, 5).astype(np.float32) for _ in range(4)]
    keys = [rs.randint(0, 40, 12).astype(np.int64) for _ in range(4)]
    sgrads = [rs.randn(12, 8).astype(np.float32) for _ in range(4)]
    probe = np.arange(40, dtype=np.int64)
    js, ts = _jax_server(optimizer=rule, lr=0.05), _server(optimizer=rule,
                                                          lr=0.05)
    try:
        jc, tc = JClient("127.0.0.1", js.port), PsClient("127.0.0.1",
                                                         ts.port)
        cross = PsClient("127.0.0.1", js.port)
        for c in (jc, tc):
            c.init_dense("w", w0)
        for g, k, sg in zip(grads, keys, sgrads):
            for c in (jc, tc):
                c.push_dense("w", g)
                c.pull_sparse("emb", k, 8)
                c.push_sparse("emb", k, sg)
            np.testing.assert_array_equal(tc.pull_dense("w", (6, 5)),
                                          jc.pull_dense("w", (6, 5)))
        np.testing.assert_array_equal(tc.pull_sparse("emb", probe, 8),
                                      jc.pull_sparse("emb", probe, 8))
        np.testing.assert_array_equal(cross.pull_sparse("emb", probe, 8),
                                      jc.pull_sparse("emb", probe, 8))
        for c in (jc, tc, cross):
            c.close()
    finally:
        js.stop()
        ts.stop()


def test_bf16_wire_bytes_equal_the_jax_client():
    """(1) pull_sparse_bf16's 16-bit patterns equal the JAX client's and
    the rounding of the fp32 rows; (2) a push of bf16 gradients (a torch
    bfloat16 tensor here, an ml_dtypes array there) applies alike on
    both servers; (3) MergedSparseStream's unique wire rides the bf16
    wire and keeps its exact-merge contract."""
    from paddle_tpu.distributed.ps import PsClient as JClient

    VOCAB, Dm, LR = 96, 8, 0.2
    rs = np.random.RandomState(2)
    ids = np.arange(VOCAB, dtype=np.int64)
    js, ts = _jax_server(optimizer="sgd", lr=LR), _server(lr=LR)
    try:
        jc, tc = JClient("127.0.0.1", js.port), PsClient("127.0.0.1",
                                                         ts.port)
        rows32 = tc.pull_sparse("emb", ids, Dm)
        np.testing.assert_array_equal(jc.pull_sparse("emb", ids, Dm),
                                      rows32)
        tb = tc.pull_sparse_bf16("emb", ids, Dm)
        assert tb.dtype == torch.bfloat16
        jb = jc.pull_sparse_bf16("emb", ids, Dm)
        bits = tb.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits, jb.view(np.uint16))
        np.testing.assert_array_equal(
            bits, rows32.astype(BF16).view(np.uint16))
        g = rs.randn(VOCAB, Dm).astype(np.float32)
        tc.push_sparse_bf16("emb", ids, torch.from_numpy(g).bfloat16())
        jc.push_sparse_bf16("emb", ids, g.astype(BF16))
        after = tc.pull_sparse("emb", ids, Dm)
        np.testing.assert_array_equal(after, jc.pull_sparse("emb", ids, Dm))
        gw = g.astype(BF16).astype(np.float32)
        np.testing.assert_allclose(
            after, rows32 - LR * gw / (np.sqrt(gw * gw) + 1e-8),
            rtol=1e-5, atol=1e-6)
        jc.close()
        tc.close()

        comm = Communicator([f"127.0.0.1:{ts.port}"], mode="async")
        comm.start()
        ms = MergedSparseStream(comm, "emb2", Dm, height=VOCAB,
                                to_device="cpu", unique_wire=True,
                                pad_rows=32)
        assert ms._bf16_wire()
        ids0 = rs.randint(0, VOCAB, (2, 8, 4)).astype(np.int64)
        ms.prime(ids0)
        rows, inv, uniq = ms.get()
        assert rows.dtype == torch.bfloat16 and inv.dtype == torch.int32
        ref = torch.from_numpy(ms._table.lookup(ids0)).bfloat16()
        assert torch.equal(rows[inv.long()], ref)
        before = ms._table.lookup(np.arange(VOCAB))
        gacc = torch.randn(rows.shape, generator=torch.Generator()
                           .manual_seed(1)).bfloat16()
        ms.push_async(uniq, gacc)
        ms.drain()
        n = int((uniq < VOCAB).sum())
        gw = gacc[:n].float().numpy()
        expect = before.copy()
        expect[uniq[:n]] -= LR * gw / (np.sqrt(gw * gw) + 1e-8)
        np.testing.assert_allclose(ms._table.lookup(np.arange(VOCAB)),
                                   expect, rtol=1e-4, atol=1e-5)
        ms.close()
        comm.stop()
    finally:
        js.stop()
        ts.stop()


def test_dense_init_push_pull_and_adam_rule():
    srv = _server()
    srv2 = _server(optimizer="adam", lr=0.01)
    try:
        c = PsClient("127.0.0.1", srv.port)
        w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
        c.init_dense("w", w0)
        np.testing.assert_array_equal(c.pull_dense("w", (2, 3)), w0)
        c.push_dense("w", torch.ones(2, 3))           # sgd lr=0.1
        np.testing.assert_allclose(c.pull_dense("w", (2, 3)), w0 - 0.1)
        c.close()
        c = PsClient("127.0.0.1", srv2.port)
        c.init_dense("w", np.zeros(4, np.float32))
        for _ in range(3):
            c.push_dense("w", np.ones(4, np.float32))
        w = c.pull_dense("w", (4,))
        # adam with a constant gradient of 1 moves about lr a step
        assert (w < 0).all() and (w > -0.05).all()
        c.close()
    finally:
        srv.stop()
        srv2.stop()


def test_sparse_lookup_geo_delta_and_heartbeat():
    srv = _server(lr=0.5)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"])
        table = DistributedLookupTable(comm, "emb", dim=4)
        ids = np.array([[3, 7], [3, 11]])
        rows = table.lookup(ids)
        assert rows.shape == (2, 2, 4)
        np.testing.assert_array_equal(rows[0, 0], rows[1, 0])
        assert (np.abs(rows) <= 0.05 + 1e-6).all()
        table.push_grad(torch.as_tensor(ids), torch.ones(2, 2, 4))
        assert (table.lookup(ids)[0, 0] < rows[0, 0]).all()
        comm.close()
        geo = Communicator([f"127.0.0.1:{srv.port}"], mode="geo", geo_k=2)
        w = np.zeros(3, np.float32)
        geo.init_params({"w": w})
        w = w + 1
        np.testing.assert_array_equal(geo.geo_step({"w": w})["w"], w)
        w = w + 1
        np.testing.assert_allclose(geo.geo_step({"w": w})["w"],
                                   np.full(3, 2.0))
        geo.close()
        c = PsClient("127.0.0.1", srv.port)
        c.heartbeat(0)
        assert srv.stale_trainers(timeout_ms=60000) == 0
        time.sleep(0.05)
        assert srv.stale_trainers(timeout_ms=10) == 1
        c.close()
    finally:
        srv.stop()


def test_selected_rows_push_waits_and_rows_push_merges():
    """A SelectedRows gradient (and the torch sparse COO tensor an
    `Embedding(sparse=True)` leaves in `.grad`) goes to push_sparse as
    rows: duplicates merged before the push, as the JAX test of the
    communicator asserts (row 3 sees ONE adagrad gradient of 2, delta 1,
    not two of 1), with the same pulls as the JAX client pushing the JAX
    SelectedRows; fill rows past the height are dropped."""
    from paddle_tpu.distributed.ps import Communicator as JComm
    from paddle_tpu.sparse import SelectedRows as JRows
    from paddle_tpu_torch.sparse import SelectedRows

    D = 4
    rows = np.array([3, 3, 8])
    vals = np.arange(12, dtype=np.float32).reshape(3, D) / 7
    got = {}
    for side in ("jax", "port"):
        srv = _jax_server(trainers=1, optimizer="adagrad", lr=1.0) \
            if side == "jax" else _server(optimizer="adagrad", lr=1.0)
        try:
            cls = JComm if side == "jax" else Communicator
            comm = cls([f"127.0.0.1:{srv.port}"], mode="sync")
            cli = comm.clients[0]
            before = cli.pull_sparse("emb", np.array([3, 8], np.int64), D)
            g = JRows(rows, vals, 100) if side == "jax" else \
                SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                             100)
            comm.push({"emb": g})
            after = cli.pull_sparse("emb", np.array([3, 8], np.int64), D)
            got[side] = (before, after)
            if side == "port":
                ones = SelectedRows(torch.tensor([3, 3, 8]),
                                    torch.ones(3, D), 100)
                b1 = cli.pull_sparse("ones", np.array([3, 8], np.int64), D)
                comm.push({"ones": ones.to_sparse()})
                a1 = cli.pull_sparse("ones", np.array([3, 8], np.int64), D)
                np.testing.assert_allclose(b1 - a1, 1.0, atol=1e-5)
        finally:
            srv.stop()
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])

    srv = _server(lr=0.5)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"])
        table = DistributedLookupTable(comm, "emb", dim=4)
        before = table.lookup(np.arange(3))
        comm.push({"emb": SelectedRows(torch.tensor([1, 1, 2, 9]),
                                       torch.ones(4, 4), 8)})
        after = table.lookup(np.arange(3))
        np.testing.assert_array_equal(after[0], before[0])
        assert (after[1:] < before[1:]).all()
        # the sparse rule is adagrad (delta = lr * g / sqrt(sum g^2)):
        # row 1's two ones merged into one gradient of 2 move it by lr,
        # as row 2's single one does (unmerged: 0.5 + 0.5 / sqrt(2))
        np.testing.assert_allclose(before[1:] - after[1:], 0.5, rtol=1e-6)
        comm.close()
    finally:
        srv.stop()


_TRAINER = """
import os, sys
import numpy as np
from paddle_tpu_torch.distributed import fleet

fleet.init(is_collective=False)
comm = fleet.init_worker()
tid = fleet.fleet._role_maker._worker_index()
rs = np.random.RandomState(42)
X = rs.rand(64, 4).astype(np.float32)
Y = X @ np.array([1.0, -2.0, 3.0, 0.5], np.float32)
X, Y = X[tid::2], Y[tid::2]
comm.init_params({"w": np.zeros(4, np.float32)})
losses = []
for step in range(150):
    w = comm.pull()["w"]
    err = X @ w - Y
    losses.append(float((err ** 2).mean()))
    comm.push({"w": 2 * X.T @ err / len(Y)})
    comm.barrier(10 + step % 2)
with open(os.path.join(sys.argv[1], f"losses{tid}"), "w") as f:
    f.write(" ".join(map(repr, losses)))
if tid == 0:
    comm.barrier(99)
    comm.clients[0].shutdown_server()
else:
    comm.barrier(99)
fleet.stop_worker()
"""


_EARLY_SHUTDOWN = """
import sys, time
from paddle_tpu_torch.distributed import fleet

fleet.init(is_collective=False)
comm = fleet.init_worker()
comm.barrier(1)
if fleet.fleet._role_maker._worker_index() == 0:
    comm.clients[0].shutdown_server()
time.sleep(1.5)        # still finishing when the pserver has exited 0
"""


def test_launch_ps_a_pserver_shut_down_by_a_trainer_ends_nothing(tmp_path):
    """A trainer's `shutdown_server` makes the pserver exit 0 while the
    trainers are still finishing: the job waits for them and ends 0 (it
    used to read the clean exit as a death and end 1)."""
    script = tmp_path / "early.py"
    script.write_text(_EARLY_SHUTDOWN)
    env = {"PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    assert launch.launch_ps([str(script)], num_servers=1, num_trainers=2,
                            extra_env=env) == 0


def test_launch_ps_one_pserver_two_trainers_converge(tmp_path):
    """`launch_ps`: one pserver process and two trainer processes (each
    through fleet.init_worker from the launcher's environment) train the
    JAX test's sharded linear regression in lockstep: the loss drops more
    than 100x on each trainer, and the job ends with code 0."""
    script = tmp_path / "train_ps.py"
    script.write_text(_TRAINER)
    env = {"PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    rc = launch.launch_ps([str(script), str(tmp_path)], num_servers=1,
                          num_trainers=2, server_lr=0.1, extra_env=env)
    assert rc == 0
    for tid in range(2):
        losses = [float(x) for x in
                  (tmp_path / f"losses{tid}").read_text().split()]
        assert len(losses) == 150
        assert losses[-1] < losses[0] / 100, (tid, losses[0], losses[-1])


def test_fleet_ps_runtime_roles_from_the_environment(monkeypatch):
    from paddle_tpu_torch.distributed import fleet as fleet_mod
    from paddle_tpu_torch.distributed.fleet.parameter_server import runtime

    srv = runtime.init_server(fleet_mod.fleet)
    try:
        monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS", f"127.0.0.1:{srv.port}")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
        comm = runtime.init_worker(fleet_mod.fleet)
        assert comm is not None and comm.mode == "sync"
        comm.init_params({"w": np.zeros(3, np.float32)})
        comm.push({"w": np.ones(3, np.float32)})
        assert comm.pull()["w"].shape == (3,)
        runtime.stop_worker(fleet_mod.fleet)
    finally:
        srv.stop()


def test_ctr_sparse_dense_convergence():
    """The CTR workload: the embedding rows on the pserver (adagrad), the
    dense tower's gradient by torch autograd on the worker, both through
    the PS: the loss drops more than 3x."""
    srv = _server(trainers=1, optimizer="sgd", lr=0.2)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"])
        emb = DistributedLookupTable(comm, "slot_emb", dim=8)
        rs = np.random.RandomState(1)
        ids = rs.randint(0, 50, (256, 3)).astype(np.int64)
        truth = rs.rand(50) > 0.5
        labels = torch.as_tensor((truth[ids].sum(1) >= 2).astype(np.float32))
        comm.init_params({"w": np.zeros(8, np.float32)})
        losses = []
        for _ in range(40):
            rows = torch.tensor(emb.lookup(ids), requires_grad=True)
            w = torch.tensor(comm.pull()["w"], requires_grad=True)
            p = torch.sigmoid(rows.sum(1) @ w)
            loss = -(labels * torch.log(p + 1e-6) +
                     (1 - labels) * torch.log(1 - p + 1e-6)).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            emb.push_grad(ids, rows.grad)
            comm.push({"w": w.grad})
        assert losses[-1] < losses[0] / 3, (losses[0], losses[-1])
        comm.close()
    finally:
        srv.stop()


def test_shutdown_rpc_delta_gated_pull_and_async_recv():
    srv = PsServer(port=0, trainers=1)
    cli = PsClient("127.0.0.1", srv.port)
    cli.init_dense("w", np.zeros(4, np.float32))
    assert not srv.shutdown_requested()
    cli.shutdown_server()
    assert srv.shutdown_requested()
    cli.close()
    srv.stop()                       # must not abort the process

    srv = _server(lr=0.1)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"], mode="sync")
        c = comm.clients[0]
        c.init_dense("w", np.ones(6, np.float32))
        arr, v1 = c.pull_dense_if_newer("w", (6,), 0)
        assert arr is not None and v1 >= 1
        arr2, v2 = c.pull_dense_if_newer("w", (6,), v1)
        assert arr2 is None and v2 == v1
        c.push_dense("w", np.full(6, 0.5, np.float32))
        arr3, v3 = c.pull_dense_if_newer("w", (6,), v2)
        assert arr3 is not None and v3 > v2
        np.testing.assert_allclose(arr3, 1.0 - 0.1 * 0.5, rtol=1e-6)
        comm2 = Communicator([f"127.0.0.1:{srv.port}"], mode="async",
                             recv_interval=0.01)
        comm2._dense_shapes["w"] = (6,)
        comm2.start()
        c.push_dense("w", np.full(6, 0.5, np.float32))
        deadline = time.time() + 5
        while time.time() < deadline and "w" not in comm2._latest:
            time.sleep(0.02)
        assert "w" in comm2._latest
        comm2.stop()
        comm.close()
    finally:
        srv.stop()


def _ctr_chunk(rs, truth, K, B, S, VOCAB):
    ids = rs.randint(0, VOCAB, (K, B, S)).astype(np.int64)
    return ids, torch.as_tensor(truth[ids].sum(-1, keepdims=True))


@pytest.mark.parametrize("unique_wire", [False, True],
                         ids=["rows", "unique_wire"])
def test_merged_sparse_stream_converges(unique_wire):
    """MergedSparseStream, K batches a pull and a push over the bf16 wire
    (rows per occurrence, or the unique rows with the merge on the
    device side as an index_add): the tower's loss falls below 0.7 of
    its start and the table moves."""
    from paddle_tpu_torch.optimizer import functional as fopt

    B, S, Dm, K, VOCAB = 32, 4, 8, 4, 128
    srv = _server(optimizer="sgd", lr=0.2)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"], mode="async")
        comm.start()
        ms = MergedSparseStream(comm, "emb", Dm, height=VOCAB,
                                to_device="cpu", unique_wire=unique_wire,
                                pad_rows=32)
        rs = np.random.RandomState(0)
        params = {"w": torch.as_tensor(
            (rs.randn(S * Dm, 1) * 0.1).astype(np.float32))}
        tx = fopt.adam(5e-2)
        state = tx.init(params)
        truth = (rs.randn(VOCAB) * 0.5).astype(np.float32)
        ids, ys = _ctr_chunk(rs, truth, K, B, S, VOCAB)
        ms.prime(ids)
        losses = []
        for _ in range(30):
            got = ms.get()
            nxt = _ctr_chunk(rs, truth, K, B, S, VOCAB)
            ms.prefetch(nxt[0])
            if unique_wire:
                rows_u, inv, uniq = got
                rows_u = rows_u.float().requires_grad_()
            else:
                assert got.dtype == torch.bfloat16
                assert tuple(got.shape) == (K, B, S, Dm)
            gembs = []
            for k in range(K):
                w = params["w"].clone().requires_grad_()
                emb = rows_u[inv[k].long()] if unique_wire else \
                    got[k].float().requires_grad_()
                loss = ((emb.reshape(B, -1) @ w - ys[k]) ** 2).mean()
                gw, gemb = torch.autograd.grad(
                    loss, [w, rows_u if unique_wire else emb])
                params, state = tx.update(params, {"w": gw}, state)
                gembs.append(gemb)
            if unique_wire:
                ms.push_async(uniq, torch.stack(gembs).sum(0).bfloat16())
            else:
                ms.push_async(ids, torch.stack(gembs).bfloat16())
            ms.drain()
            losses.append(float(loss.detach()))
            ids, ys = nxt
        assert np.abs(ms._table.lookup(np.arange(64))).sum() > 0.0
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        assert last < first * 0.7, (first, last)
        ms.close()
        comm.stop()
    finally:
        srv.stop()


def test_snapshot_restore_resume_and_a_jax_snapshot_loads(tmp_path):
    """A pserver killed and replaced from its snapshot continues to the
    uninterrupted run's tables exactly; `convert.to_pserver` carries a JAX
    job's tables across: its servers' snapshot (the same file format)
    loads into the port's server with the same rows, and dense numpy
    parameters initialise the dense tables."""
    from paddle_tpu.distributed.ps import Communicator as JComm

    Dm, VOCAB = 8, 256
    rs = np.random.RandomState(7)
    ids_seq = [rs.randint(0, VOCAB, 64).astype(np.int64) for _ in range(20)]
    dense0 = rs.randn(32).astype(np.float32)
    probe = np.arange(VOCAB).astype(np.int64)

    def step(comm, i):
        c = comm._client_for("emb")
        rows = c.pull_sparse("emb", ids_seq[i], Dm)
        c.push_sparse("emb", ids_seq[i], 0.1 * rows + 0.01)
        c.push_dense("w", np.full(32, 0.5, np.float32))

    def run(interrupt):
        srv = _server(optimizer="adam", lr=0.05)
        comm = Communicator([f"127.0.0.1:{srv.port}"])
        comm._client_for("w").init_dense("w", dense0)
        for i in range(20):
            if interrupt and i == 10:
                paths = comm.checkpoint_notify(tmp_path / "snap")
                assert paths[0].endswith("pserver_0.ptps")
                comm.close()
                srv.stop()
                srv = _server(optimizer="adam", lr=0.05)
                comm = Communicator([f"127.0.0.1:{srv.port}"])
                comm.checkpoint_notify(tmp_path / "snap", load=True)
            step(comm, i)
        out = (comm._client_for("emb").pull_sparse("emb", probe, Dm),
               comm._client_for("w").pull_dense("w", (32,)))
        comm.close()
        srv.stop()
        return out

    (tmp_path / "snap").mkdir()
    want, got = run(False), run(True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    js = _jax_server(optimizer="adam", lr=0.05)
    jcomm = JComm([f"127.0.0.1:{js.port}"])
    jcomm._client_for("w").init_dense("w", dense0)
    for i in range(5):
        step(jcomm, i)
    (tmp_path / "jax").mkdir()
    jcomm.checkpoint_notify(str(tmp_path / "jax"))
    jrows = jcomm._client_for("emb").pull_sparse("emb", probe, Dm)
    jcomm.close()
    js.stop()
    srv = _server(optimizer="adam", lr=0.05)
    try:
        from paddle_tpu_torch import convert

        comm = Communicator([f"127.0.0.1:{srv.port}"])
        convert.to_pserver(comm, dense={"d": dense0[:4].astype(np.float64)},
                           snapshot_dir=tmp_path / "jax")
        np.testing.assert_array_equal(
            comm._client_for("emb").pull_sparse("emb", probe, Dm), jrows)
        np.testing.assert_array_equal(comm.pull()["d"], dense0[:4])
        comm.close()
    finally:
        srv.stop()


def test_train_epoch_range_restores_ps_tables(tmp_path, monkeypatch):
    """TrainEpochRange with ps_communicator: a restarted job resumes at the
    next epoch and the replacement pserver gets the snapshotted table
    (exactly one adagrad push of ones, as in the JAX test)."""
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange

    monkeypatch.setenv("PADDLE_JOB_ID", "job42")
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path))
    Dm = 4
    ids = np.arange(16).astype(np.int64)
    srv = _server(optimizer="sgd", lr=0.1)
    comm = Communicator([f"127.0.0.1:{srv.port}"])
    for ep in TrainEpochRange(4, "ctr", ps_communicator=comm).get():
        c = comm._client_for("emb")
        rows = c.pull_sparse("emb", ids, Dm)
        c.push_sparse("emb", ids, np.ones_like(rows))
        if ep == 1:
            break
    after_ep1 = comm._client_for("emb").pull_sparse("emb", ids, Dm)
    comm.close()
    srv.stop()
    srv2 = _server(optimizer="sgd", lr=0.1)
    comm2 = Communicator([f"127.0.0.1:{srv2.port}"])
    resumed = list(TrainEpochRange(4, "ctr", ps_communicator=comm2).get())
    assert resumed[0] in (1, 2) and resumed[-1] == 3
    restored = comm2._client_for("emb").pull_sparse("emb", ids, Dm)
    comm2.close()
    srv2.stop()
    np.testing.assert_allclose(after_ep1, restored - 0.1 / np.sqrt(2.0),
                               atol=1e-5)


def test_load_rejects_a_corrupt_snapshot_atomically(tmp_path):
    ids = np.arange(8).astype(np.int64)
    srv = _server(optimizer="sgd", lr=0.1)
    try:
        comm = Communicator([f"127.0.0.1:{srv.port}"])
        c = comm._client_for("emb")
        c.push_sparse("emb", ids, np.ones_like(c.pull_sparse("emb", ids, 4)))
        before = c.pull_sparse("emb", ids, 4)
        good = tmp_path / "pserver_0.ptps"
        c.save(str(good))
        raw = good.read_bytes()
        (tmp_path / "bad.ptps").write_bytes(raw[: len(raw) // 2])
        with pytest.raises(RuntimeError, match="corrupt|truncated"):
            c.load(str(tmp_path / "bad.ptps"))
        (tmp_path / "bad2.ptps").write_bytes(b"\x00" * 64)
        with pytest.raises(RuntimeError, match="PTPS1|corrupt"):
            c.load(str(tmp_path / "bad2.ptps"))
        np.testing.assert_array_equal(c.pull_sparse("emb", ids, 4), before)
        c.load(str(good))
        np.testing.assert_array_equal(c.pull_sparse("emb", ids, 4), before)
        comm.close()
    finally:
        srv.stop()


def test_the_library_builds_from_the_one_source_and_a_failed_build_raises(
        tmp_path):
    """The pserver library is `csrc/ptcore/ps_server.cc` built alone (no
    libptcore, no protobuf) into a hashed directory under the build root;
    a compiler that fails raises with its output."""
    from paddle_tpu_torch.distributed.ps import _native

    _native.load()
    info = _native.build_info()
    assert os.path.basename(os.path.dirname(info["path"])) == \
        f"ps_{info['digest']}"
    assert _native.SOURCE.endswith(os.path.join("csrc", "ptcore",
                                                "ps_server.cc"))
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
            "from paddle_tpu_torch.distributed.ps import _native\n"
            "try:\n    _native.load()\nexcept RuntimeError as e:\n"
            "    print('raised', 'failed' in str(e))\n")
    env = dict(os.environ, CXX="false", PT_BUILD_ROOT=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "raised True" in out.stdout, out.stdout + out.stderr
