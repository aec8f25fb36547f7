"""Auto-checkpoint for elastic restart.

Reference parity: fluid/incubate/checkpoint/auto_checkpoint.py
(AutoCheckpointChecker :71, TrainEpochRange :265: wraps the epoch loop,
snapshots state, resumes after reschedule), env-driven like the reference
(PADDLE_JOB_ID, PADDLE_CHECKPOINT_DIR). The snapshot is the caller's
`save_checkpoint_fn(path)` (typically `paddle_tpu_torch.save` of a state
dict, `io.serialization`) and the resume its `load_checkpoint_fn(path)`;
the epoch pointer is a JSON meta file published atomically. The JAX
package's parameter-server snapshot (`ps_communicator=`) waits for the
port's parameter server and is refused.
"""
from __future__ import annotations

import json
import os


class AutoCheckpointChecker:
    def __init__(self):
        self.job_id = os.environ.get("PADDLE_JOB_ID", "")
        self.ckpt_dir = os.environ.get("PADDLE_CHECKPOINT_DIR", "")

    def valid(self):
        return bool(self.job_id and self.ckpt_dir)


class TrainEpochRange:
    """for epoch in TrainEpochRange(n, name).get(): ... — resumes from the
    last completed epoch after a restart."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_checkpoint_fn=None, load_checkpoint_fn=None,
                 ps_communicator=None):
        """ps_communicator: the JAX package's parameter-server snapshot;
        the port has no parameter server yet, so anything but None
        raises."""
        if ps_communicator is not None:
            raise NotImplementedError(
                "TrainEpochRange(ps_communicator=...): the port has no "
                "parameter server yet")
        self._max = max_epoch_num
        self._name = name
        self._checker = AutoCheckpointChecker()
        self._save_fn = save_checkpoint_fn
        self._load_fn = load_checkpoint_fn
        self._start = 0
        if self._checker.valid():
            meta = self._meta_path()
            if os.path.exists(meta):
                try:
                    with open(meta) as f:
                        state = json.load(f)
                except (OSError, ValueError):
                    # torn/corrupt meta (killed mid-write before this
                    # file became atomic): start fresh rather than die
                    import warnings

                    warnings.warn(
                        f"auto-checkpoint meta {meta!r} unreadable; "
                        f"restarting from epoch 0")
                    state = {}
                self._start = state.get("epoch", -1) + 1
                if self._load_fn and state.get("payload"):
                    self._load_fn(state["payload"])

    def _meta_path(self):
        return os.path.join(self._checker.ckpt_dir,
                            f"{self._checker.job_id}_{self._name}.json")

    def get(self):
        for epoch in range(self._start, self._max):
            yield epoch
            self.save_checkpoint(epoch)

    def save_checkpoint(self, epoch):
        if not self._checker.valid():
            return
        os.makedirs(self._checker.ckpt_dir, exist_ok=True)
        payload = None
        if self._save_fn:
            payload = os.path.join(
                self._checker.ckpt_dir,
                f"{self._checker.job_id}_{self._name}_e{epoch}.pdparams")
            self._save_fn(payload)
        # atomic meta publish: tmp + os.replace, so a kill mid-write
        # leaves the previous epoch's meta intact instead of torn JSON
        meta = self._meta_path()
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            # "ps_dir": the JAX meta's parameter-server field
            json.dump({"epoch": epoch, "payload": payload,
                       "ps_dir": None}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta)
