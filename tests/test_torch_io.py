"""The port's data pipeline against the JAX package's `io`, on the CPU:
samplers and `DataLoader` (0 and 2 worker processes), worker errors,
`DevicePrefetcher`, the `save` / `load` file format in both directions
(bfloat16 included) and the crash-safe `CheckpointManager`.

Exactness: every comparison here is exact. The same numpy seed gives
both packages the same batches in the same order; files written by one
package load in the other bit for bit.

Every test that starts worker processes runs under its own deadline
(`_torch_io_datasets.deadline`, 120 s) and gives its DataLoader a 60 s timeout a batch,
so a hung worker fails its test instead of hanging the suite. The
worker datasets live in `_torch_io_datasets.py`, which imports no JAX.
"""
import os

import numpy as np
import pytest
import torch

import _torch_io_datasets as D
import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.io.checkpoint import CheckpointManager as JaxManager
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io.checkpoint import (CheckpointCorrupt,
                                            CheckpointError,
                                            CheckpointManager)
from paddle_tpu_torch.testing import faults

WORKER_TIMEOUT = 60


@pytest.fixture(autouse=True)
def _port_faults():
    yield
    faults.reset()


def _jax_batches(dl):
    return [tuple(np.asarray(t.numpy()) for t in b) for b in dl]


def _port_batches(dl):
    out = []
    for b in dl:
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in b)
        out.append(tuple(t.numpy() for t in b))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------- batches against JAX

@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_dataloader_batches_equal_jax_under_one_numpy_seed(workers, shuffle,
                                                           drop_last):
    with D.deadline():
        kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
                  num_workers=workers, timeout=WORKER_TIMEOUT)
        np.random.seed(11)
        want = _jax_batches(jio.DataLoader(D.Seq(), **kw)) + \
            _jax_batches(jio.DataLoader(D.Seq(), **kw))     # two epochs
        np.random.seed(11)
        got = _port_batches(tio.DataLoader(D.Seq(), **kw)) + \
            _port_batches(tio.DataLoader(D.Seq(), **kw))
        _assert_same(got, want)
        assert len(tio.DataLoader(D.Seq(), **kw)) == len(
            jio.DataLoader(D.Seq(), **kw))


def test_samplers_draw_what_jax_draws():
    ds = D.Seq(10)
    for make in (lambda m: m.RandomSampler(ds),
                 lambda m: m.RandomSampler(ds, replacement=True,
                                           num_samples=7),
                 lambda m: m.WeightedRandomSampler([0.1, 2.0, 0.5, 1.0], 9),
                 lambda m: m.SequenceSampler(ds),
                 lambda m: m.BatchSampler(ds, shuffle=True, batch_size=3),
                 lambda m: m.BatchSampler(sampler=m.SequenceSampler(ds),
                                          batch_size=4, drop_last=True)):
        np.random.seed(3)
        want = list(make(jio))
        np.random.seed(3)
        assert list(make(tio)) == want
        assert len(make(tio)) == len(make(jio))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_distributed_batch_sampler_rank_arithmetic_equals_jax(shuffle,
                                                              drop_last):
    ds = D.Seq(11)
    seen = []
    for rank in range(3):
        kw = dict(batch_size=2, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j, t = jio.DistributedBatchSampler(ds, **kw), \
            tio.DistributedBatchSampler(ds, **kw)
        j.set_epoch(4)
        t.set_epoch(4)
        assert list(t) == list(j) and len(t) == len(j)
        seen += [i for b in t for i in b]
    if not drop_last:
        assert set(seen) == set(range(11))   # padded by its own head


def test_one_rank_without_a_process_group():
    s = tio.DistributedBatchSampler(D.Seq(5), batch_size=2)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert [i for b in s for i in b] == list(range(5))


def test_dataset_combinators_and_collate_equal_jax():
    ds = D.Seq(10)
    np.random.seed(5)
    ja, jb = jio.random_split(ds, [7, 3])
    np.random.seed(5)
    ta, tb = tio.random_split(ds, [7, 3])
    assert ta.indices == ja.indices and tb.indices == jb.indices
    with pytest.raises(ValueError):
        tio.random_split(ds, [3, 3])
    sub = tio.Subset(ds, [2, 5])
    assert int(sub[1][1]) == 5 and len(sub) == 2
    comp = tio.ComposeDataset([ds, ds])
    assert len(comp[0]) == 4 and len(comp) == 10
    chain = tio.ChainDataset([D.Stream(), D.Stream()])
    assert len(list(chain)) == 20
    td = tio.TensorDataset([torch.arange(6).reshape(3, 2),
                            np.arange(3)])
    assert len(td) == 3 and td[2][0].tolist() == [4, 5]
    batch = [{"x": np.ones((2,), np.float32), "y": 1, "z": 0.5,
              "t": torch.ones(2)},
             {"x": np.zeros((2,), np.float32), "y": 2, "z": 1.5,
              "t": torch.zeros(2)}]
    got, want = tio.default_collate_fn(batch), jio.default_collate_fn(
        [{k: v for k, v in b.items() if k != "t"} for b in batch])
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert isinstance(got["t"], np.ndarray) and got["t"].shape == (2, 2)
    with pytest.raises(TypeError):
        len(tio.IterableDataset())


def test_tensor_dataset_loader_yields_cpu_tensors():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    dl = tio.DataLoader(tio.TensorDataset([x, np.arange(6)]), batch_size=4)
    b = next(iter(dl))
    assert isinstance(b, tuple) and b[0].dtype == torch.float32 and \
        b[1].dtype == torch.int64
    np.testing.assert_array_equal(b[0].numpy(), x[:4])


# --------------------------------------------------------- the workers

def test_workers_keep_order_and_stay_off_cuda():
    with D.deadline():
        dl = tio.DataLoader(D.Seq(), batch_size=4, num_workers=2,
                            timeout=WORKER_TIMEOUT)
        ys = [int(v) for _, y in dl for v in y.numpy().ravel()]
        assert ys == list(range(23))
        state = list(tio.DataLoader(D.CudaState(), batch_size=2,
                                    num_workers=2, timeout=WORKER_TIMEOUT))
        hidden = np.concatenate([b[0].numpy() for b in state])
        opened = np.concatenate([b[1].numpy() for b in state])
        assert hidden.tolist() == [1] * 4 and opened.tolist() == [0] * 4


def test_fork_is_refused(monkeypatch):
    monkeypatch.setenv("PT_DATALOADER_START_METHOD", "fork")
    with pytest.raises(ValueError, match="never by fork"):
        list(tio.DataLoader(D.Seq(4), batch_size=2, num_workers=1))


def test_spawn_workers_load_the_same_batches(monkeypatch):
    with D.deadline():
        monkeypatch.setenv("PT_DATALOADER_START_METHOD", "spawn")
        got = _port_batches(tio.DataLoader(D.Seq(9), batch_size=4,
                                           num_workers=2,
                                           timeout=WORKER_TIMEOUT))
        _assert_same(got, _port_batches(tio.DataLoader(D.Seq(9),
                                                       batch_size=4)))


def test_worker_error_reaches_the_caller():
    with D.deadline():
        with pytest.raises(ValueError, match="boom"):
            list(tio.DataLoader(D.BadItem(), batch_size=2, num_workers=1,
                                timeout=WORKER_TIMEOUT))
        with pytest.raises(RuntimeError, match="worker_init_fn"):
            list(tio.DataLoader(D.Seq(8), batch_size=2, num_workers=2,
                                worker_init_fn=D.bad_init,
                                timeout=WORKER_TIMEOUT))


def test_worker_info_and_iterable_streams():
    with D.deadline():
        kw = dict(num_workers=2, timeout=WORKER_TIMEOUT)
        ids = {int(v) for b in tio.DataLoader(D.WorkerId(), batch_size=2,
                                              **kw)
               for v in b.numpy().ravel()}
        assert ids <= {0, 1} and -1 not in ids
        assert tio.get_worker_info() is None
        vals = sorted(float(v) for b in tio.DataLoader(D.Stream(),
                                                       batch_size=5, **kw)
                      for v in b.numpy().ravel())
        assert vals == sorted([float(i) for i in range(10)] * 2)
        vals = sorted(float(v) for b in tio.DataLoader(
            D.ShardedStream(), batch_size=3, **kw) for v in b.numpy().ravel())
        assert vals == [float(i) for i in range(10)]
        n = sum(b.numpy().size for b in tio.DataLoader(
            D.Stream(), batch_size=3, drop_last=True, **kw))
        assert n == 18
        vals = sorted(float(v) for b in tio.DataLoader(
            D.UnbalancedStream(), batch_size=2, **kw)
            for v in b.numpy().ravel())
        assert vals == sorted([float(i) for i in range(2)] +
                              [float(1000 + i) for i in range(20)])


def test_thread_prefetch_and_the_dataloader_fault_point():
    dl = tio.DataLoader(D.Seq(9), batch_size=4, num_workers=2,
                        use_multiprocess=False)
    ys = [int(v) for _, y in dl for v in y.numpy().ravel()]
    assert ys == list(range(9))
    with faults.inject("dataloader.next", on="nth", n=2):
        with pytest.raises(faults.InjectedFault):
            list(tio.DataLoader(D.Seq(9), batch_size=4))


# ------------------------------------------------------ DevicePrefetcher

def test_device_prefetcher_passes_batches_in_order_on_the_cpu():
    src = tio.DataLoader(D.Seq(10), batch_size=3)
    got = list(tio.DevicePrefetcher(iter(src), depth=2, device="cpu"))
    _assert_same([tuple(t.numpy() for t in b) for b in got],
                 _port_batches(src))
    nested = list(tio.DevicePrefetcher(iter([{"a": np.ones(2), "b": [
        np.zeros(1), "tag"]}]), device="cpu"))
    assert isinstance(nested[0]["a"], torch.Tensor)
    assert nested[0]["b"][1] == "tag"


def test_device_prefetcher_raises_source_errors_and_refuses_sharding():
    def bad():
        yield (np.ones(2),)
        raise ValueError("source broke")

    it = iter(tio.DevicePrefetcher(bad(), device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="source broke"):
        next(it)
    # a sharding is a parallel.sharding.Sharding (the multi-GPU slice
    # ports it); an axis name alone is refused
    with pytest.raises(TypeError, match="Sharding"):
        tio.DevicePrefetcher(iter([]), sharding="dp", device="cpu")
    p = tio.DevicePrefetcher(iter(range(100)), depth=1, device="cpu")
    p.close()
    assert not p._thread.is_alive()


# ------------------------------------------------------ the file format

def _port_tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7,
            "h": (torch.arange(4, dtype=torch.float32) / 3).to(
                torch.bfloat16),
            "i": torch.arange(3, dtype=torch.int64),
            "nested": [torch.ones(2, dtype=torch.float16),
                       {"deep": torch.zeros(1, dtype=torch.int32)}],
            "step": 3, "note": "x", "arr": np.arange(2)}


def test_port_file_loads_in_jax_with_names_and_bfloat16(tmp_path):
    path = str(tmp_path / "port.pdparams")
    tree = _port_tree()
    tio.save(tree, path)
    got = paddle.load(path)
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    assert got["w"].name == "w"                  # the structured name
    assert str(got["h"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["h"].numpy(), np.float32),
                                  tree["h"].float().numpy())
    assert got["i"].numpy().dtype == np.int64
    assert str(got["nested"][0].numpy().dtype) == "float16"
    assert got["nested"][1]["deep"].numpy().dtype == np.int32
    assert got["step"] == 3 and got["note"] == "x"
    np.testing.assert_array_equal(got["arr"], np.arange(2))


def test_jax_file_loads_in_the_port_with_bfloat16(tmp_path):
    path = str(tmp_path / "jax.pdopt")
    w = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    paddle.save({"w": paddle.to_tensor(w),
                 "h": paddle.to_tensor(np.arange(4, dtype="f4") / 3).astype(
                     "bfloat16"),
                 "l": [paddle.to_tensor(np.arange(2, dtype="i8"))],
                 "_step_count": 5}, path)
    got = tio.load(path)
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), w)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].float().numpy(),
        (torch.tensor(np.arange(4, dtype="f4") / 3).to(torch.bfloat16)
         .float().numpy()))
    assert got["l"][0].dtype == torch.int64 and got["_step_count"] == 5
    raw = tio.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray) and raw["h"].dtype == np.float32


def test_port_round_trip_keeps_every_dtype(tmp_path):
    path = str(tmp_path / "a" / "b.pdparams")         # makes the folders
    tree = _port_tree()
    tio.save(tree, path)
    got = tio.load(path)
    for k in ("w", "h", "i"):
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["nested"][0], tree["nested"][0])


# --------------------------------------------------- CheckpointManager

def test_checkpoint_roundtrip_retention_and_tensor_payloads(tmp_path):
    m = CheckpointManager(tmp_path, max_to_keep=2)
    for s in range(4):
        m.save(s, {"w": torch.full((3,), float(s)),
                   "meta": {"epoch": s, "note": "x"}})
    assert m.all_steps() == [2, 3]
    st = m.restore()
    assert torch.equal(st["w"], torch.full((3,), 3.0))
    assert st["meta"] == {"epoch": 3, "note": "x"}
    st2 = m.restore(step=2, return_numpy=True)
    np.testing.assert_array_equal(st2["w"], np.full((3,), 2, "f4"))
    with pytest.raises(CheckpointError, match="already exists"):
        m.save(3, {"w": 1})
    m.save(3, {"w": torch.zeros(1)}, force=True)
    assert m.latest_step() == 3


def test_checkpoint_torn_write_leaves_no_checkpoint(tmp_path):
    m = CheckpointManager(tmp_path, max_to_keep=None)
    m.save(0, {"a": np.arange(4)})
    with faults.inject("checkpoint.write", on="nth", n=1):
        with pytest.raises(faults.InjectedFault):
            m.save(1, {"a": np.arange(8)})
    assert m.all_steps() == [0]
    assert not [x for x in os.listdir(tmp_path) if x.startswith("_tmp")]
    np.testing.assert_array_equal(m.restore()["a"], np.arange(4))


def test_checkpoint_corrupt_shard_skipped_with_fallback(tmp_path):
    m = CheckpointManager(tmp_path, max_to_keep=None)
    m.save(0, {"a": np.arange(3)})
    m.save(1, {"a": np.arange(3) + 1})
    with faults.inject("checkpoint.write", action="corrupt"):
        m.save(2, {"a": np.arange(3) + 2})
    assert m.all_steps() == [0, 1, 2] and m.valid_steps() == [0, 1]
    assert m.latest_step() == 1
    with pytest.warns(UserWarning, match="fell back"):
        st = m.restore()
    np.testing.assert_array_equal(st["a"], np.arange(3) + 1)
    assert m.last_restore_report["step"] == 1
    assert [s for s, _ in m.last_restore_report["skipped"]] == [2]
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        m.restore(step=2)


def test_checkpoint_read_side_corruption_detected(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save(0, {"a": np.arange(16)})
    with faults.inject("checkpoint.read", action="corrupt"):
        with pytest.raises(CheckpointCorrupt, match="checksum"):
            m.restore(step=0)
    np.testing.assert_array_equal(m.restore()["a"], np.arange(16))


def test_checkpoint_async_error_surfaces_on_wait_and_next_save(tmp_path):
    m = CheckpointManager(tmp_path, async_save=True)
    with faults.inject("checkpoint.write", on="nth", n=1):
        m.save(0, {"a": 1})
        with pytest.raises(faults.InjectedFault):
            m.wait()
    m.save(1, {"a": 2})
    m.wait()
    assert m.restore()["a"] == 2 and m.valid_steps() == [1]
    with faults.inject("checkpoint.write", on="nth", n=1):
        m.save(2, {"a": 3})
        with pytest.raises(faults.InjectedFault):
            m.save(3, {"a": 4})              # the next save re-raises
    with m:
        m.save(4, {"a": 5})
    assert m.latest_step() == 4


def test_checkpoint_no_valid_step_raises(tmp_path):
    m = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        m.restore()
    with faults.inject("checkpoint.write", action="corrupt"):
        m.save(0, {"a": 1})
    with pytest.raises(FileNotFoundError, match="skipped corrupt"):
        m.restore()


def test_checkpoint_directories_cross_between_the_packages(tmp_path):
    """The two managers write the same files: each restores the other's
    steps, tensors as its own type."""
    t = CheckpointManager(tmp_path / "port")
    t.save(5, {"model": {"w": torch.arange(4.0)}, "epoch": 5})
    j = JaxManager(tmp_path / "port")
    st = j.restore()
    np.testing.assert_array_equal(st["model"]["w"].numpy(), np.arange(4.0))
    assert st["epoch"] == 5 and j.latest_step() == 5
    j2 = JaxManager(tmp_path / "jax")
    j2.save(2, {"model": {"w": paddle.to_tensor(np.ones(3, "f4"))}})
    st = CheckpointManager(tmp_path / "jax").restore()
    assert torch.equal(st["model"]["w"], torch.ones(3))
