"""The high-level API (the JAX package's `hapi/model.py`): `Model` wraps
a network with its optimizer, loss and metrics, and trains it batch by
batch (`train_batch`) or over datasets (`fit`, `evaluate`, `predict`),
with callbacks, checkpoints in the shared file format (`save` / `load`)
and crash-safe resume (`fit(resume=)`).

    model = Model(net)
    model.prepare(optimizer, loss, metrics)
    model.fit(train_dataset, eval_dataset, batch_size=64, epochs=2)

The model runs where the network's parameters are (build the network
with `device=None` for the card, `device="cpu"` for the CPU): each batch
from the loader (CPU tensors, or numpy) is pinned and copied there, or
used as it is when it is there already (`io.DevicePrefetcher`). There
is no CPU fallback. A step syncs with the card once for the loss's
`float()` and once a metric (`metric` copies the outputs to the host).
`train_batch` steps the eager optimizer, which runs its multi-tensor
update (`optimizer/fused.py`).

`prepare(amp_configs=...)` is refused: the JAX package takes it and
applies nothing; mixed precision is `amp.auto_cast` around the steps.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..io import DataLoader, Dataset
from ..io.serialization import load as _load
from ..io.serialization import save as _save
from . import callbacks as cbks

__all__ = ["Model", "summary"]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self.stop_training = False
        # the last fit()'s step timing (see fit_report())
        self.fit_stats = None

    @property
    def device(self):
        """The device of the network's parameters (or buffers); the card
        for a network that has neither."""
        for t in (*self.network.parameters(), *self.network.buffers()):
            return t.device
        from ..core.device import resolve_device

        return resolve_device(None)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "prepare(amp_configs=...): the reference takes it and "
                "applies nothing; run the steps under "
                "paddle_tpu_torch.amp.auto_cast(...) instead")
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]

    # ------------------------------------------------------------------
    def _place(self, x):
        """x as a tensor on the model's device: numpy is wrapped, a CPU
        tensor pinned and copied without blocking the host."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        dev = self.device
        if x.device == dev:
            return x
        if dev.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(dev, non_blocking=True)

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = [self._place(x) for x in _as_list(inputs)]
        labels = [self._place(y) for y in _as_list(labels)]
        outputs = self.network(*inputs)
        losses = self._loss(*_as_list(outputs), *labels)
        loss = losses if isinstance(losses, torch.Tensor) else sum(losses)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        value = float(loss.detach())
        return ([value], metrics) if metrics else [value]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = [self._place(x) for x in _as_list(inputs)]
        labels = [self._place(y) for y in _as_list(labels)]
        with torch.no_grad():
            outputs = self.network(*inputs)
            losses = self._loss(*_as_list(outputs), *labels) \
                if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        loss_val = [float(losses)] if losses is not None else []
        return (loss_val, metrics) if metrics else loss_val

    def generate(self, *args, **kwargs):
        """Generation through the network's own `generate`
        (`nn.TransformerDecoder.generate`, the `text.decode` engine)."""
        net = self.network
        if not hasattr(net, "generate"):
            raise AttributeError(
                f"{type(net).__name__} has no generate(); use a decoder "
                "stack with TransformerDecoder.generate")
        net.eval()
        return net.generate(*args, **kwargs)

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            out = self.network(*[self._place(x) for x in _as_list(inputs)])
        return [o.detach().cpu().numpy() for o in _as_list(out)]

    def _update_metrics(self, outputs, labels):
        vals = []
        for m in self._metrics:
            state = m.compute(*_as_list(outputs), *labels)
            vals.append(m.update(*_as_list(state)))
        return vals

    # ------------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            resume=None):
        """Train the prepared model. `resume` names a crash-safe checkpoint
        directory (`io.checkpoint.CheckpointManager`): every finished
        epoch is checkpointed atomically (`_train_state`: the model, the
        optimizer, numpy's RNG state and, for a network that draws
        dropout, torch's), and a rerun with the same `resume` directory
        restores the newest VALID checkpoint (torn or corrupt steps of a
        kill mid-save are skipped) and continues from the next epoch,
        bit-matching the uninterrupted run where the step itself is
        deterministic (on the card: under
        `torch.use_deterministic_algorithms(True)`).

        `fit_stats` afterwards: steps, train_s (the steps, their syncs
        included), wait_s (waiting for the loader), wall_s, step_ms_p50
        and goodput (train_s / wall_s)."""
        train_loader = _as_loader(train_data, batch_size, shuffle, drop_last,
                                  num_workers)
        eval_loader = _as_loader(eval_data, batch_size, False, False,
                                 num_workers) if eval_data is not None \
            else None
        ckpt_mgr = None
        start_epoch = 0
        if resume:
            from ..io.checkpoint import CheckpointManager

            ckpt_mgr = CheckpointManager(resume, max_to_keep=3)
            if ckpt_mgr.latest_step() is not None:
                snap = ckpt_mgr.restore()
                self._load_train_state(snap)
                start_epoch = int(snap["epoch"]) + 1
        cbk_list = cbks.config_callbacks(callbacks, self, epochs, verbose,
                                         log_freq)
        cbk_list.on_train_begin()
        history = []
        t_fit0 = time.perf_counter()
        n_steps = 0
        train_s = wait_s = 0.0
        step_times = []            # bounded: the last 2048 step walls
        for epoch in range(start_epoch, epochs):
            cbk_list.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            it = iter(train_loader)
            step = 0
            while True:
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t0 = time.perf_counter()
                wait_s += t0 - t_wait
                ins, lbs = _split_batch(batch, self._n_inputs())
                res = self.train_batch(ins, lbs)
                dt = time.perf_counter() - t0
                n_steps += 1
                train_s += dt
                if len(step_times) < 2048:
                    step_times.append(dt)
                else:
                    step_times[n_steps % 2048] = dt
                logs = _logs_from(res, self._metrics)
                cbk_list.on_batch_end("train", step, logs)
                step += 1
                if num_iters is not None and step >= num_iters:
                    break
            if hasattr(it, "close"):     # ends a loader's workers early
                it.close()
            history.append(logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=0)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            if ckpt_mgr is not None:
                # the epoch's last act, so the snapshot (RNG states
                # included) is exactly what the next epoch starts from
                ckpt_mgr.save(epoch, self._train_state(epoch), force=True)
            cbk_list.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbk_list.on_train_end()
        wall_s = time.perf_counter() - t_fit0
        self.fit_stats = {
            "steps": n_steps,
            "train_s": round(train_s, 6),
            "wait_s": round(wait_s, 6),
            "wall_s": round(wall_s, 6),
            "step_ms_p50": round(float(np.median(step_times)) * 1e3, 3)
            if step_times else 0.0,
            # the share of fit's wall time in the steps proper (the loader,
            # eval, checkpoints and callbacks take the rest)
            "goodput": round(train_s / wall_s, 4) if wall_s > 0 else 0.0,
        }
        return history

    def fit_report(self, flops_per_step=None, spec=None):
        """The last fit()'s step timing (`fit_stats`), and with
        `flops_per_step` the training MFU: the mean achieved flop rate
        over the steps against `spec`'s peak (`profiler.costs`; default
        `detect_spec()`, the card's)."""
        if self.fit_stats is None:
            raise RuntimeError("fit() has not run yet")
        out = dict(self.fit_stats)
        if flops_per_step is not None and out["steps"]:
            from ..profiler import costs as _costs

            spec = spec if spec is not None else _costs.detect_spec()
            mean_dt = out["train_s"] / out["steps"]
            out["device"] = spec.as_dict()
            out["mfu"] = round(
                _costs.mfu(float(flops_per_step), mean_dt, spec), 6)
        return out

    def _train_state(self, epoch):
        """Everything fit(resume=...) needs to continue bit for bit: the
        model, the optimizer's slots, numpy's RNG (the samplers shuffle
        with it) and, where the network draws dropout, torch's RNG
        states. The JAX snapshot has no torch part: its dropout keys come
        from its own key stream, which the model state carries."""
        state = {"epoch": int(epoch),
                 "model": self.network.state_dict(),
                 "numpy_rng": np.random.get_state()}
        if self._optimizer is not None:
            state["opt"] = self._optimizer.state_dict()
        rng = _torch_rng_state(self.network, self.device)
        if rng is not None:
            state["torch_rng"] = rng
        return state

    def _load_train_state(self, state):
        self.network.load_state_dict(state["model"])
        if self._optimizer is not None and "opt" in state:
            self._optimizer.set_state_dict(state["opt"])
        if "numpy_rng" in state:
            np.random.set_state(state["numpy_rng"])
        if "torch_rng" in state:
            _set_torch_rng_state(self.network, self.device,
                                 state["torch_rng"])

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = _as_loader(eval_data, batch_size, False, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        it = iter(loader)
        for step, batch in enumerate(it):
            ins, lbs = _split_batch(batch, self._n_inputs())
            res = self.eval_batch(ins, lbs)
            losses.extend(res[0] if isinstance(res, tuple) else res)
            if num_iters is not None and step + 1 >= num_iters:
                break
        if hasattr(it, "close"):
            it.close()
        out = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            out[_name_of(m)] = m.accumulate()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = _as_loader(test_data, batch_size, False, False, num_workers)
        outs = []
        for batch in loader:
            ins = batch[0] if isinstance(batch, tuple) else batch
            outs.append(self.predict_batch(ins))
        if stack_outputs:
            n = len(outs[0])
            return [np.concatenate([o[i] for o in outs]) for i in range(n)]
        return outs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """`path.pdparams` (and `path.pdopt` with the optimizer) in the
        file format both packages read."""
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load `path.pdparams` (the port's or the JAX package's; names
        must match unless `skip_mismatch`) and, unless `reset_optimizer`,
        `path.pdopt` where it exists."""
        self.network.load_state_dict(_load(path + ".pdparams"),
                                     strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)

    def _n_inputs(self):
        if self._inputs is None:
            return 1
        return len(_as_list(self._inputs))


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_loader(data, batch_size, shuffle, drop_last, num_workers):
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)
    return data


def _split_batch(batch, n_inputs):
    if isinstance(batch, (list, tuple)):
        return list(batch[:n_inputs]), list(batch[n_inputs:])
    return [batch], []


def _logs_from(res, metrics):
    logs = {}
    if isinstance(res, tuple):
        losses, mvals = res
        logs["loss"] = losses
        for m, v in zip(metrics, mvals):
            logs[_name_of(m)] = v
    else:
        logs["loss"] = res
    return logs


def _name_of(m):
    n = m.name()
    return n if isinstance(n, str) else n[0]


def _random_layers(net):
    """[(module name, generator or None), ...] of the layers that draw
    random numbers in training: Dropout with p > 0 (its mask generator)
    and MultiHeadAttention with dropout (its seed generator)."""
    from ..nn.layer.common import Dropout
    from ..nn.layer.transformer import MultiHeadAttention

    out = []
    for name, m in net.named_modules():
        if isinstance(m, Dropout) and m.p:
            out.append((name, m.generator))
        elif isinstance(m, MultiHeadAttention) and m.dropout:
            out.append((name, m.seed_generator))
    return out


def _torch_rng_state(net, device):
    """None for a network that draws no random numbers; else the states
    of torch's default CPU generator (attention-dropout seeds), the
    default generator of the network's card (dropout masks) and every
    generator a layer holds, by layer name."""
    layers = _random_layers(net)
    if not layers:
        return None
    state = {"cpu": torch.get_rng_state(),
             "layers": {name: g.get_state() for name, g in layers
                        if g is not None}}
    if device.type == "cuda":
        state["cuda"] = torch.cuda.get_rng_state(device)
    return state


def _set_torch_rng_state(net, device, state):
    torch.set_rng_state(state["cpu"].to(torch.uint8))
    if "cuda" in state and device.type == "cuda":
        torch.cuda.set_rng_state(state["cuda"].to(torch.uint8), device)
    for name, g in _random_layers(net):
        if g is not None and name in state["layers"]:
            g.set_state(state["layers"][name].to(torch.uint8))


def summary(net, input_size=None, dtypes=None, input=None):
    """The parameter table and totals; with `input_size` (or a concrete
    `input`) a forward in eval mode on the network's device reports the
    output shape too."""
    lines = [f"{type(net).__name__}:"]
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape))
        total += n
        if p.requires_grad:
            trainable += n
        lines.append(f"  {name:<40} {str(list(p.shape)):<20} {n}")
    lines.append(f"Total params: {total}")
    lines.append(f"Trainable params: {trainable}")
    lines.append(f"Non-trainable params: {total - trainable}")
    out_shape = None
    try:
        if input is None and input_size is not None:
            dev = next(iter(net.parameters())).device
            dtype = getattr(torch, dtypes if isinstance(dtypes, str)
                            else "float32")
            input = torch.zeros(list(input_size), dtype=dtype, device=dev)
        if input is not None:
            was_training = net.training
            net.eval()
            try:
                with torch.no_grad():
                    out = net(input)
            finally:
                net.train(was_training)
            first = out[0] if isinstance(out, (list, tuple)) else out
            out_shape = list(first.shape)
            lines.append(f"Output shape: {out_shape}")
    except Exception as e:  # the shape probe is best-effort
        lines.append(f"(forward probe skipped: {e})")
    print("\n".join(lines))
    res = {"total_params": total, "trainable_params": trainable}
    if out_shape is not None:
        res["output_shape"] = out_shape
    return res
