"""The port's `incubate/` against the JAX package's, on the CPU.

`checkpoint.TrainEpochRange`: a killed epoch loop resumes at the epoch
after the last finished one, restoring the model saved by the caller's
`save_checkpoint_fn` (`paddle_tpu_torch.save`) bit for bit, and the
meta file it writes is the JAX module's; a torn meta restarts from
epoch 0 with a warning. `data_generator`: the text wire and the PTMB1
binary file of the same seeded generator equal the JAX module's byte for
byte (the port's own copy of `write_multislot_binary`).
"""
import io
import os

import numpy as np
import pytest
import torch

import paddle_tpu.incubate.checkpoint as jckpt
import paddle_tpu.incubate.data_generator as jdg
from paddle_tpu.fluid.dataset import write_multislot_binary as jwrite
import paddle_tpu_torch as tp
import paddle_tpu_torch.incubate.checkpoint as tckpt
import paddle_tpu_torch.incubate.data_generator as tdg


def _gen_class(mod, string=False):
    base = mod.MultiSlotStringDataGenerator if string else \
        mod.MultiSlotDataGenerator

    class Gen(base):
        def __init__(self, n=11, seed=0):
            super().__init__()
            self._n = n
            self._rs = np.random.RandomState(seed)

        def generate_sample(self, line):
            def it():
                reps = 1 if line is None else len(line.split())
                for _ in range(self._n * reps):
                    ids = self._rs.randint(0, 50, int(
                        self._rs.randint(1, 5))).tolist()
                    dense = [round(float(x), 4)
                             for x in self._rs.rand(3)]
                    lbl = [int(sum(ids) % 2)]
                    if string:
                        yield [("words", [str(i) for i in ids]),
                               ("label", [str(i) for i in lbl])]
                    else:
                        yield [("words", ids), ("dense", dense),
                               ("label", lbl)]
            return it

        def generate_batch(self, samples):
            def it():
                for s in reversed(samples):     # a batch-level rewrite
                    yield s
            return it
    return Gen


@pytest.mark.parametrize("string", [False, True])
def test_generator_text_wire_equals_jax(string):
    outs = []
    for mod in (jdg, tdg):
        gen = _gen_class(mod, string)()
        gen.set_batch(4)
        mem = io.StringIO()
        gen.run_from_memory(out=mem)
        gen2 = _gen_class(mod, string)(n=2, seed=3)
        gen2._set_line_limit(2)
        std = io.StringIO()
        gen2.run_from_stdin(inp=io.StringIO("a b\nc\nd e f\n"), out=std)
        outs.append((mem.getvalue(), std.getvalue()))
    assert outs[1] == outs[0]
    assert outs[1][0].count("\n") == 11 and outs[1][1].count("\n") == 6


@pytest.mark.parametrize("binary", [False, True])
def test_generator_file_equals_jax_byte_for_byte(tmp_path, binary):
    paths = []
    for tag, mod in (("jax", jdg), ("port", tdg)):
        gen = _gen_class(mod)(n=13, seed=5)
        gen.set_batch(5)
        path = tmp_path / f"{tag}.{'bin' if binary else 'txt'}"
        n = gen.write_to_file(str(path), lines=["x y", "z"],
                              binary=binary)
        assert n == 13 * 3
        paths.append(path)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    if binary:
        assert paths[1].read_bytes()[:5] == b"PTMB\x01"


def test_multislot_binary_writer_equals_jax(tmp_path):
    rs = np.random.RandomState(7)
    recs = [[rs.randint(0, 9, int(rs.randint(1, 4))).tolist(),
             rs.rand(2).tolist()] for _ in range(9)]
    types = ["int64", "float32"]
    jwrite(str(tmp_path / "j"), recs, types)
    tdg.write_multislot_binary(str(tmp_path / "t"), recs, types)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    with pytest.raises(ValueError, match="slots"):
        tdg.write_multislot_binary(str(tmp_path / "bad"), [[1]], types)


def test_generator_refusals_match_jax():
    for mod in (jdg, tdg):
        class Bad(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    yield [("a", [1])]
                    yield [("b", [2])]          # slot order changed
                return it
        with pytest.raises(ValueError, match="slot order"):
            Bad().run_from_memory(out=io.StringIO())
        with pytest.raises(ValueError, match="positive"):
            Bad()._set_line_limit(0)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))


def _train(path_env, monkeypatch, max_epoch, kill_at=None):
    """An epoch loop under TrainEpochRange whose checkpoint is the
    model's state dict (`tp.save` / `tp.load`): epoch e adds e + 1 to
    w. Returns (epochs run, w)."""
    monkeypatch.setenv("PADDLE_JOB_ID", "job")
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(path_env))
    net = _Net()

    def save(p):
        tp.save(net.state_dict(), p)

    def load(p):
        net.load_state_dict(tp.load(p))

    ran = []
    tr = tckpt.TrainEpochRange(max_epoch, "fit", save_checkpoint_fn=save,
                               load_checkpoint_fn=load)
    for e in tr.get():
        if e == kill_at:
            break                        # the job dies inside epoch e
        with torch.no_grad():
            net.w += e + 1
        ran.append(e)
    return ran, net.w.detach().clone()


def test_train_epoch_range_resumes_bitwise(tmp_path, monkeypatch):
    full, w_full = _train(tmp_path / "a", monkeypatch, 5)
    first, _ = _train(tmp_path / "b", monkeypatch, 5, kill_at=3)
    second, w_resumed = _train(tmp_path / "b", monkeypatch, 5)
    assert full == [0, 1, 2, 3, 4]
    assert first == [0, 1, 2] and second == [3, 4]
    assert torch.equal(w_resumed, w_full)
    assert float(w_full[0]) == 15.0
    # the meta file the port writes is the JAX module's, and the JAX
    # module resumes from it
    import json
    meta = json.loads((tmp_path / "b" / "job_fit.json").read_text())
    assert set(meta) == {"epoch", "payload", "ps_dir"}
    assert meta["epoch"] == 4 and meta["ps_dir"] is None
    assert [e for e in jckpt.TrainEpochRange(6, "fit").get()] == [5]


def test_train_epoch_range_torn_meta_and_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "job1")
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path))
    assert [e for e in tckpt.TrainEpochRange(3, "t").get()] == [0, 1, 2]
    meta = tmp_path / "job1_t.json"
    assert meta.exists() and not (tmp_path / "job1_t.json.tmp").exists()
    assert [e for e in tckpt.TrainEpochRange(4, "t").get()] == [3]
    meta.write_text("{torn")
    with pytest.warns(UserWarning, match="unreadable"):
        tr = tckpt.TrainEpochRange(2, "t")
    assert [e for e in tr.get()] == [0, 1]
    # a parameter-server communicator snapshots its tables each epoch
    # (the real servers' round trip is in test_torch_ps.py)
    notes = []

    class Comm:
        def checkpoint_notify(self, dirname, load=False):
            notes.append((os.path.basename(dirname), load))

    monkeypatch.setenv("PADDLE_JOB_ID", "job2")
    assert [e for e in tckpt.TrainEpochRange(
        2, "t", ps_communicator=Comm()).get()] == [0, 1]
    assert notes == [("job2_t_ps_e0", False), ("job2_t_ps_e1", False)]
    assert [e for e in tckpt.TrainEpochRange(
        3, "t", ps_communicator=Comm()).get()] == [2]
    assert notes[2] == ("job2_t_ps_e1", True)
    monkeypatch.delenv("PADDLE_JOB_ID")
    assert not tckpt.AutoCheckpointChecker().valid()
    assert [e for e in tckpt.TrainEpochRange(2, "t").get()] == [0, 1]
