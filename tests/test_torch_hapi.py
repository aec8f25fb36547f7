"""The port's high-level API against the JAX package's `hapi`, on the CPU:
`Model.fit` / `evaluate` / `predict` on the same data and weights, the
crash-safe `fit(resume=)`, the callbacks, `save` / `load` across the
packages, and the multi-tensor optimizer step under `train_batch`.

Tolerances:
  * `fit` against the JAX `fit` (a 2-layer MLP, Adam 1e-2, 3 epochs of 4
    shuffled batches): every step's loss and the final weights rtol 1e-4,
    atol 1e-6 (float32 forward, backward and Adam in another order of
    summation; twelve updates grow a 1e-7 difference to ~1e-6); the
    per-step accuracies, the batch order and the evaluate accuracy
    exactly;
  * `fit(resume=)` after a kill in the middle of a checkpoint: bit for
    bit the port's uninterrupted run (model and optimizer state), with
    and without dropout;
  * weights and predictions through `save` / `load` (either package's
    files): bit for bit.
Tests that start DataLoader workers give the loader a 60 s timeout a
batch and run under a 120 s deadline (`_torch_io_datasets.deadline`).
"""
import numpy as np
import pytest
import torch

import _torch_io_datasets as D
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.io import TensorDataset as JaxTensorDataset
import paddle_tpu_torch as tp
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.io import DevicePrefetcher, TensorDataset
from paddle_tpu_torch.io.checkpoint import CheckpointManager
from paddle_tpu_torch.optimizer import fused
from paddle_tpu_torch.testing import faults

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_faults():
    yield
    faults.reset()


def _data(n=16, seed=123):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 4).astype("f4"), rs.randint(0, 3, (n, 1)).astype("i8")


def _jax_model(seed=0):
    paddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 3))
    m = paddle.Model(net)
    m.prepare(paddle.optimizer.Adam(0.01, parameters=net.parameters()),
              jnn.CrossEntropyLoss(), paddle.metric.Accuracy())
    return m


def _port_model(state=None, seed=0, dropout=0.0):
    g = torch.Generator().manual_seed(seed)
    layers = [tnn.Linear(4, 8, device="cpu", generator=g), tnn.ReLU()]
    if dropout:
        layers.append(tnn.Dropout(dropout))
    layers.append(tnn.Linear(8, 3, device="cpu", generator=g))
    net = tnn.Sequential(*layers)
    if state is not None:
        net.load_state_dict(convert.from_jax_state(state))
    m = tp.Model(net)
    m.prepare(tp.optimizer.Adam(0.01, parameters=net.named_parameters()),
              tnn.CrossEntropyLoss(), tp.metric.Accuracy())
    return m


def _np_state(net):
    return {k: np.asarray(v) for k, v in net.state_dict().items()}


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.logs = []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append((float(np.ravel(logs["loss"])[0]),
                              float(logs["acc"])))
    return Rec()


# ------------------------------------------------------ fit against JAX

def test_fit_tracks_the_jax_fit_loss_for_loss():
    x, y = _data()
    jm = _jax_model()
    tm = _port_model(_np_state(jm.network))
    jrec, trec = _recorder(paddle.callbacks.Callback), \
        _recorder(tp.callbacks.Callback)
    kw = dict(batch_size=4, epochs=3, shuffle=True, verbose=0)
    np.random.seed(9)
    jhist = jm.fit(JaxTensorDataset([x, y]), callbacks=[jrec], **kw)
    np.random.seed(9)
    thist = tm.fit(TensorDataset([x, y]), callbacks=[trec], **kw)
    assert len(trec.logs) == len(jrec.logs) == 12
    got, want = np.array(trec.logs), np.array(jrec.logs)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    jsd = _np_state(jm.network)
    for k, v in tm.network.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jsd[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    je = jm.evaluate(JaxTensorDataset([x, y]), batch_size=8, verbose=0)
    te = tm.evaluate(TensorDataset([x, y]), batch_size=8, verbose=0)
    assert te["acc"] == je["acc"]
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4)
    jp = jm.predict(JaxTensorDataset([x, y]), batch_size=8,
                    stack_outputs=True)
    tpred = tm.predict(TensorDataset([x, y]), batch_size=8,
                       stack_outputs=True)
    np.testing.assert_allclose(tpred[0], jp[0], rtol=1e-4, atol=1e-5)
    stats = tm.fit_report()
    assert stats["steps"] == 12 and 0 < stats["goodput"] <= 1
    assert stats["wait_s"] >= 0 and stats["train_s"] <= stats["wall_s"]


def test_fit_with_workers_eval_data_and_a_prefetcher_gives_the_same_steps():
    """Two loader workers, or batches handed over by DevicePrefetcher,
    give the same losses as loading in the calling thread."""
    with D.deadline():
        x, y = _data(24)
        ds = TensorDataset([x, y])
        runs = []
        for loader in ("inline", "workers", "prefetch"):
            m = _port_model(seed=3)
            rec = _recorder(tp.callbacks.Callback)
            np.random.seed(4)
            if loader == "prefetch":
                src = tp.io.DataLoader(ds, batch_size=6, shuffle=True)
                m.fit(DevicePrefetcher(iter(src), device="cpu"), epochs=1,
                      callbacks=[rec], verbose=0)
            else:
                m.fit(ds, ds, batch_size=6, epochs=1, callbacks=[rec],
                      verbose=0, num_workers=2 if loader == "workers" else 0)
            runs.append(rec.logs)
        assert runs[0] == runs[1] == runs[2]


def test_train_batch_takes_the_multi_tensor_path(monkeypatch):
    calls = []
    real = fused.apply

    def spy(opt, dense):
        calls.append(len(dense))
        return real(opt, dense)

    monkeypatch.setattr(fused, "apply", spy)
    m = _port_model()
    m._optimizer._grad_clip = tnn.ClipGradByGlobalNorm(1.0)
    x, y = _data()
    for i in range(0, 16, 4):
        out = m.train_batch([x[i:i + 4]], [y[i:i + 4]])
        assert np.isfinite(out[0][0])
    assert calls == [4] * 4


# ------------------------------------------------------------ resume

def _weights_and_slots(m):
    out = {k: v.numpy().copy() for k, v in m.network.state_dict().items()}
    for k, v in m._optimizer.state_dict().items():
        out["opt." + k] = v.numpy().copy() if isinstance(v, torch.Tensor) \
            else v
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fit_resume_bitmatch_after_a_kill_mid_checkpoint(tmp_path, dropout):
    """A run killed in the middle of its epoch-2 checkpoint resumes from
    the newest valid step (epoch 1) and ends bit for bit as the
    uninterrupted run: model and optimizer state, with the shuffle's
    numpy RNG and, under dropout, torch's RNG restored."""
    x, y = _data()
    ds = TensorDataset([x, y])
    kw = dict(epochs=4, batch_size=4, shuffle=True, verbose=0)
    torch.manual_seed(0)
    np.random.seed(0)
    ref = _port_model(seed=0, dropout=dropout)
    ref.fit(ds, resume=str(tmp_path / "ref"), **kw)
    want = _weights_and_slots(ref)

    # a save writes one shard a top-level key: epoch, model, numpy_rng,
    # opt (and torch_rng under dropout); this hit is the second shard of
    # the third save (epoch 2)
    shards = 5 if dropout else 4
    torch.manual_seed(0)
    np.random.seed(0)
    crashed = _port_model(seed=0, dropout=dropout)
    with faults.inject("checkpoint.write", on="nth", n=2 * shards + 2):
        with pytest.raises(faults.InjectedFault):
            crashed.fit(ds, resume=str(tmp_path / "b"), **kw)
    assert CheckpointManager(tmp_path / "b").latest_step() == 1

    torch.manual_seed(123)                  # a fresh process: other RNGs
    np.random.seed(7)
    resumed = _port_model(seed=7, dropout=dropout)
    resumed.fit(ds, resume=str(tmp_path / "b"), **kw)
    got = _weights_and_slots(resumed)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert CheckpointManager(tmp_path / "b").latest_step() == 3
    snap = CheckpointManager(tmp_path / "b").restore()
    assert ("torch_rng" in snap) == bool(dropout)


def test_fit_resume_on_a_fresh_directory_trains_from_scratch(tmp_path):
    x, y = _data()
    m = _port_model()
    m.fit(TensorDataset([x, y]), epochs=2, batch_size=8, verbose=0,
          resume=str(tmp_path / "r"))
    assert CheckpointManager(tmp_path / "r").all_steps() == [0, 1]


# --------------------------------------------------------- callbacks

def test_model_checkpoint_callback_retention_and_best_only(tmp_path):
    x, y = _data()
    m = _port_model()
    cb = tp.callbacks.ModelCheckpoint(save_dir=str(tmp_path / "all"),
                                      max_to_keep=2)
    m.fit(TensorDataset([x, y]), epochs=4, batch_size=4, verbose=0,
          callbacks=[cb])
    mgr = CheckpointManager(tmp_path / "all")
    assert mgr.all_steps() == [2, 3]
    st = mgr.restore()
    assert st["epoch"] == 3 and "opt" in st
    assert torch.equal(st["model"]["2.weight"],
                       m.network.state_dict()["2.weight"])
    best = tp.callbacks.ModelCheckpoint(save_dir=str(tmp_path / "best"),
                                        save_best_only=True, monitor="loss")
    best.set_model(m)
    for epoch, loss in enumerate([1.0, 0.5, 0.8, 0.3]):
        best.on_epoch_end(epoch, {"loss": [loss]})
    best.on_train_end()
    assert CheckpointManager(tmp_path / "best", max_to_keep=None
                             ).all_steps() == [0, 1, 3]
    assert best.best == 0.3


def test_early_stopping_lr_scheduler_and_progbar(capsys):
    x, y = _data()
    g = torch.Generator().manual_seed(0)
    net = tnn.Sequential(tnn.Linear(4, 3, device="cpu", generator=g))
    sched = tp.optimizer.lr.CosineAnnealingDecay(0.1, T_max=8)
    m = tp.Model(net)
    m.prepare(tp.optimizer.Momentum(sched, 0.9,
                                    parameters=net.named_parameters()),
              tnn.CrossEntropyLoss())
    m.fit(TensorDataset([x, y]), batch_size=8, epochs=3, verbose=1,
          log_freq=1, callbacks=[tp.callbacks.LRScheduler()])
    assert sched.last_epoch == 6                 # stepped once a batch
    out = capsys.readouterr().out
    assert "Epoch 0 step 0" in out and "Epoch 2 done" in out

    class Worse(tp.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            logs["loss"] = [float(epoch)]        # worse every epoch

    stop = tp.callbacks.EarlyStopping(monitor="loss", patience=1)
    hist = m.fit(TensorDataset([x, y]), batch_size=8, epochs=10, verbose=0,
                 callbacks=[Worse(), stop])
    assert len(hist) == 2 and m.stop_training


# ------------------------------------------------- files and the rest

def test_save_load_across_the_packages_bitwise(tmp_path):
    x, y = _data()
    tm = _port_model(seed=5)
    tm.fit(TensorDataset([x, y]), batch_size=4, epochs=1, verbose=0)
    tm.save(str(tmp_path / "port"))
    jm = _jax_model(seed=1)
    jm.load(str(tmp_path / "port"), reset_optimizer=True)
    jsd = _np_state(jm.network)
    for k, v in tm.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)

    jm2 = _jax_model(seed=2)
    jm2.fit(JaxTensorDataset([x, y]), batch_size=4, epochs=1, verbose=0)
    jm2.save(str(tmp_path / "jax"))
    tm2 = _port_model(seed=6)
    tm2.load(str(tmp_path / "jax"))
    jsd2 = _np_state(jm2.network)
    for k, v in tm2.network.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd2[k], err_msg=k)
    assert tm2._optimizer._step_count == 4       # the .pdopt came along
    want = tm.predict(TensorDataset([x, y]), batch_size=16)
    tm3 = _port_model(seed=8)
    tm3.load(str(tmp_path / "port"))
    got = tm3.predict(TensorDataset([x, y]), batch_size=16)
    np.testing.assert_array_equal(got[0][0], want[0][0])


def test_prepare_amp_and_fit_report_mfu_wait_for_their_slices():
    m = _port_model()
    with pytest.raises(NotImplementedError, match="amp"):
        m.prepare(amp_configs={"level": "O1"})
    with pytest.raises(RuntimeError, match="fit"):
        m.fit_report()
    x, y = _data()
    m.fit(TensorDataset([x, y]), batch_size=8, verbose=0)
    # the MFU came with profiler.costs: the mean step's flop rate against
    # the spec's peak (exact arithmetic on fit_stats)
    from paddle_tpu_torch.profiler import costs
    rep = m.fit_report(flops_per_step=1e9, spec=costs.CPU_SPEC)
    st = m.fit_stats
    assert rep["device"] == costs.CPU_SPEC.as_dict()
    assert rep["mfu"] == round(1e9 / (st["train_s"] / st["steps"]) /
                               costs.CPU_SPEC.peak_flops, 6)


def test_summary_generate_parameters_and_device(capsys):
    m = _port_model()
    res = tp.summary(m.network, (2, 4))
    assert res == {"total_params": 4 * 8 + 8 + 8 * 3 + 3,
                   "trainable_params": 67, "output_shape": [2, 3]}
    assert "Total params: 67" in capsys.readouterr().out
    assert m.summary()["total_params"] == 67
    assert len(list(m.parameters())) == 4
    assert m.device == torch.device("cpu")
    with pytest.raises(AttributeError, match="generate"):
        m.generate()

    class Gen(torch.nn.Module):
        def generate(self, *a, **k):
            return ("generated", self.training, a, k)

    g = tp.Model(Gen())
    assert g.generate(1, beam_size=2) == ("generated", False, (1,),
                                          {"beam_size": 2})
    out = m.predict_batch([np.ones((2, 4), "f4")])
    assert isinstance(out[0], np.ndarray) and out[0].shape == (2, 3)
    loss, acc = m.eval_batch([np.ones((2, 4), "f4")], [np.zeros((2, 1),
                                                                "i8")])
    assert len(loss) == 1 and len(acc) == 1


def test_workers_never_see_the_card_under_fit():
    """fit's loader workers hide the cards (the CudaState dataset reports
    what a worker sees)."""
    with D.deadline():
        dl = tp.io.DataLoader(D.CudaState(), batch_size=2, num_workers=2,
                              timeout=60)
        for hidden, opened in dl:
            assert hidden.tolist() == [1, 1] and opened.tolist() == [0, 0]
