"""Auto-checkpoint for elastic restart.

Reference parity: fluid/incubate/checkpoint/auto_checkpoint.py
(AutoCheckpointChecker :71, TrainEpochRange :265: wraps the epoch loop,
snapshots state, resumes after reschedule), env-driven like the reference
(PADDLE_JOB_ID, PADDLE_CHECKPOINT_DIR). The snapshot is the caller's
`save_checkpoint_fn(path)` (typically `paddle_tpu_torch.save` of a state
dict, `io.serialization`) and the resume its `load_checkpoint_fn(path)`;
the epoch pointer is a JSON meta file published atomically. With
`ps_communicator=` (a `distributed.ps.Communicator`) every checkpoint
also snapshots the pservers' tables (`checkpoint_notify`, one directory
an epoch) and a restart restores them, so a CTR job resumes with its
embedding table instead of a re-initialised one.
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
        """ps_communicator: a `distributed.ps.Communicator`: every
        checkpoint also snapshots the PSERVER tables (dense and sparse
        shards, the checkpoint_notify_op.cc:66 role) and a restart
        restores them."""
        self._max = max_epoch_num
        self._name = name
        self._checker = AutoCheckpointChecker()
        self._save_fn = save_checkpoint_fn
        self._load_fn = load_checkpoint_fn
        self._ps_comm = ps_communicator
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
                if self._ps_comm is not None and state.get("ps_dir"):
                    self._ps_comm.checkpoint_notify(state["ps_dir"],
                                                    load=True)

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
        ps_dir = None
        if self._ps_comm is not None:
            # one directory an epoch: a crash between the snapshot and the
            # meta write leaves the PREVIOUS epoch's snapshot intact (an
            # in-place overwrite would apply an epoch twice on resume)
            ps_dir = os.path.join(
                self._checker.ckpt_dir,
                f"{self._checker.job_id}_{self._name}_ps_e{epoch}")
            os.makedirs(ps_dir, exist_ok=True)
            self._ps_comm.checkpoint_notify(ps_dir)
        # atomic meta publish: tmp + os.replace, so a kill mid-write
        # leaves the previous epoch's meta intact instead of torn JSON
        meta = self._meta_path()
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "payload": payload,
                       "ps_dir": ps_dir}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta)
        if ps_dir is not None:
            # the snapshots older than the one the meta now points at go
            import glob
            import shutil

            pat = os.path.join(
                self._checker.ckpt_dir,
                f"{self._checker.job_id}_{self._name}_ps_e*")
            for d in glob.glob(pat):
                if d != ps_dir:
                    shutil.rmtree(d, ignore_errors=True)
