"""The port's `AsyncCheckpointer`, `save_sharded` and `load_sharded`
against the JAX package's orbax-backed ones, on the CPU.

The port builds them on its `CheckpointManager` (atomic staging and
rename, CRC32 per shard), no orbax: an async save snapshots to the host
and writes on a background thread, then restores bitwise; `max_to_keep`
prunes as the JAX class does; an error on the writer thread surfaces on
`wait`. `save_sharded` on four gloo ranks (dp2 x tp2, blocks split over
tp, dp replicas writing once) and `load_sharded` give the global arrays
the JAX package's `save_sharded` / `load_sharded` give for the same
state, bit for bit; a rank cuts its blocks back out of them.
"""
import numpy as np
import pytest
import torch

import _torch_dist_ranks as R
from paddle_tpu_torch.io.checkpoint import (AsyncCheckpointer,
                                            CheckpointCorrupt, load_sharded)
from paddle_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    faults.reset()


def state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(4, 6, generator=g),
                      "h": torch.randn(3, generator=g).bfloat16(),
                      "i": torch.arange(5)},
            "step": torch.tensor(seed)}


def test_async_save_restores_bitwise_and_keeps_max_to_keep(tmp_path):
    from paddle_tpu.io.checkpoint import AsyncCheckpointer as JAsync

    ck = AsyncCheckpointer(tmp_path / "port", max_to_keep=2)
    states = [state(s) for s in range(4)]
    for s, st in enumerate(states):
        ck.save(s, st)          # returns at once; the write is behind it
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    got = ck.restore()
    assert np.array_equal(got["model"]["w"], states[3]["model"]["w"].numpy())
    assert np.array_equal(got["model"]["i"], np.arange(5))
    assert np.array_equal(got["model"]["h"],
                          states[3]["model"]["h"].float().numpy())
    assert int(got["step"]) == 3
    assert int(ck.restore(2)["step"]) == 2
    ck.close()
    # the JAX class's retention and step listing on the same saves
    jk = JAsync(str(tmp_path / "jax"), max_to_keep=2)
    for s, st in enumerate(states):
        jk.save(s, {"w": st["model"]["w"].numpy(), "step": np.int64(s)})
    jk.wait()
    assert jk.all_steps() == ck.all_steps()
    assert jk.latest_step() == ck.latest_step()
    assert np.array_equal(jk.restore()["w"], got["model"]["w"])
    jk.close()


def test_an_error_on_the_writer_thread_surfaces_on_wait(tmp_path):
    ck = AsyncCheckpointer(tmp_path, max_to_keep=3)
    faults.inject("checkpoint.write", on="always")
    ck.save(1, state(1))             # no raise here: the write is async
    with pytest.raises(faults.InjectedFault):
        ck.wait()
    faults.reset()
    assert ck.all_steps() == []
    ck.save(2, state(2))
    ck.wait()
    assert ck.all_steps() == [2]
    with pytest.raises(FileNotFoundError):
        AsyncCheckpointer(tmp_path / "empty").restore()


def test_save_sharded_on_four_ranks_loads_the_jax_arrays(tmp_path):
    from paddle_tpu.io.checkpoint import load_sharded as jload
    from paddle_tpu.io.checkpoint import save_sharded as jsave

    rs = np.random.RandomState(3)
    full = {"w": rs.randn(8, 6).astype(np.float32),
            "emb": rs.randn(16, 4).astype(np.float32),
            "b": rs.randn(6).astype(np.float32)}
    specs = {"w": (None, "tp"), "emb": ("tp", None)}
    pool = R.RankPool(4)
    try:
        got = pool.run(4, "sharded_save", dict(
            state=full, specs=specs, mesh={"dp": 2, "tp": 2},
            dir=str(tmp_path / "port")))
    finally:
        pool.close()
    assert all(g["cut_back_equal"] for g in got)
    assert got[0]["local"] == {"w": (8, 3), "emb": (8, 4), "b": (6,)}
    port = load_sharded(tmp_path / "port")
    jsave({"params": full, "step": np.int64(7)}, str(tmp_path / "jax"))
    want = jload(str(tmp_path / "jax"))
    assert int(port["step"]) == int(want["step"]) == 7
    for n, arr in full.items():
        assert np.array_equal(port["params"][n], np.asarray(
            want["params"][n])), n
        assert np.array_equal(port["params"][n], arr), n
    # a rank file that rots fails its checksum
    f = tmp_path / "port" / "rank_00001.bin"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        load_sharded(tmp_path / "port")
