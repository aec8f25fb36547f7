"""`hapi.Model` callbacks (the JAX package's `hapi/callbacks.py`, the
port's own copy): `ProgBarLogger`, `ModelCheckpoint` on the crash-safe
`io.checkpoint.CheckpointManager`, `EarlyStopping`, `LRScheduler` (steps
the optimizer's `optimizer.lr` schedule), `CallbackList` and
`config_callbacks`."""
from __future__ import annotations

import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "CallbackList", "config_callbacks"]


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and step % self.log_freq == 0:
            msg = " - ".join(f"{k}: {_fmt(v)}"
                             for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch} step {step}: {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            msg = " - ".join(f"{k}: {_fmt(v)}"
                             for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done in {dt:.1f}s: {msg}")


def _fmt(v):
    if isinstance(v, (list, tuple)):
        return ", ".join(f"{float(x):.4f}" for x in np.ravel(v))
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    """Epoch-end checkpointing through the crash-safe
    `io.checkpoint.CheckpointManager`: atomic tmp+rename publishes with
    per-shard checksums (a kill mid-save can never leave a torn
    checkpoint), `max_to_keep` retention, optional monitor-metric
    "save best only", and async saves whose errors surface at train
    end instead of being lost."""

    def __init__(self, save_freq=1, save_dir=None, *, max_to_keep=None,
                 monitor="loss", mode="min", save_best_only=False,
                 async_save=False):
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = "min" if mode in ("auto", "min") else "max"
        self.save_best_only = save_best_only
        self.async_save = async_save
        self.best = None
        self._mgr = None

    def _manager(self):
        if self._mgr is None:
            from ..io.checkpoint import CheckpointManager

            self._mgr = CheckpointManager(
                self.save_dir, max_to_keep=self.max_to_keep,
                async_save=self.async_save)
        return self._mgr

    def _is_better(self, v):
        if self.best is None:
            return True
        return v < self.best if self.mode == "min" else v > self.best

    def on_epoch_end(self, epoch, logs=None):
        if not self.save_dir or epoch % self.save_freq != 0:
            return
        if self.save_best_only:
            v = (logs or {}).get(self.monitor)
            if v is not None:
                v = float(np.ravel(v)[0])
                if not self._is_better(v):
                    return
                self.best = v
        state = {"epoch": int(epoch),
                 "model": self.model.network.state_dict()}
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None:
            state["opt"] = opt.state_dict()
        self._manager().save(epoch, state, force=True)

    def on_train_end(self, logs=None):
        if self._mgr is not None:
            self._mgr.wait()   # surface async-save errors, don't lose


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        v = float(np.ravel(v)[0])
        better = (self.best is None or
                  (v < self.best - self.min_delta if self.mode == "min"
                   else v > self.best + self.min_delta))
        if better:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's learning-rate schedule (an
    `optimizer.lr.LRScheduler` passed as its `learning_rate`) after each
    training batch (`by_step`) and/or each epoch (`by_epoch`); a float
    rate is left alone."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            self._step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            self._step()

    def _step(self):
        opt = self.model._optimizer
        lr = getattr(opt, "_lr", None)
        if hasattr(lr, "step"):
            lr.step()


class CallbackList:
    def __init__(self, callbacks, model):
        self.callbacks = callbacks
        for c in callbacks:
            c.set_model(model)

    def on_train_begin(self):
        for c in self.callbacks:
            c.on_train_begin()

    def on_train_end(self):
        for c in self.callbacks:
            c.on_train_end()

    def on_epoch_begin(self, epoch):
        for c in self.callbacks:
            c.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_train_batch_end(step, logs)


def config_callbacks(callbacks, model, epochs, verbose, log_freq):
    cbs = list(callbacks or [])
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
        cbs.insert(0, ProgBarLogger(log_freq, verbose))
    return CallbackList(cbs, model)
