"""The crash-safe checkpoint store (the JAX package's
`io/checkpoint.py` `CheckpointManager`, the port's own copy; the two
write the same files).

Every step is a directory of shards (one per top-level state key)
published ATOMICALLY: shards and a manifest with per-shard CRC32
checksums are written into a `_tmp.*` staging directory, fsynced, then
`os.rename`d into place, so a crash at any byte leaves either the
complete previous step or an ignorable staging directory, never a torn
checkpoint. `restore()` validates the checksums and falls back to the
newest VALID step, reporting what it skipped (`last_restore_report`);
`async_save=True` snapshots the state on the caller's thread and writes
in the background, and a background error is re-raised on `wait()` or
on the next `save()`, never lost. The `checkpoint.write` and
`checkpoint.read` fault points (`testing/faults.py`) make torn-write
and corrupt-shard recovery testable.

Tensors are stored in the `save` / `load` file form (`serialization`):
a device tensor is copied to the host as numpy when `save()` is called,
and comes back from `restore()` as a CPU tensor, which the caller loads
onto its device (`load_state_dict` copies it into the parameters).

The JAX package's orbax-backed `AsyncCheckpointer`, `save_sharded` and
`load_sharded` (sharded arrays) come with the multi-GPU slice.

API:
    mgr = CheckpointManager(dir, max_to_keep=3, async_save=True)
    mgr.save(step, {"model": model.state_dict(), "opt": ...})
    mgr.wait()                      # barrier; raises background errors
    state = mgr.restore()           # newest VALID step
    steps = mgr.all_steps()
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import warnings
import zlib

from ..testing import faults
from .serialization import _pack, _unpack

_PT_WRITE = faults.point("checkpoint.write")
_PT_READ = faults.point("checkpoint.read")

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointCorrupt"]


class CheckpointError(RuntimeError):
    """Checkpoint IO failed."""


class CheckpointCorrupt(CheckpointError):
    """A step failed validation (missing/unreadable manifest, missing
    shard, size or CRC32 mismatch)."""


_STEP_PREFIX = "step_"
_TMP_PREFIX = "_tmp."
_MANIFEST = "manifest.json"


class CheckpointManager:
    """Atomic, checksummed, retained checkpoint directory.

    Layout (one dir per step, manifest written last, dir renamed into
    place as the commit point):

        <dir>/step_00000012/
            shard_0000.bin        # pickle of the packed subtree
            ...
            manifest.json         # {"step", "shards": {key: {file,
                                  #   crc32, size}}, "wrapped"}

    `max_to_keep` prunes the oldest finalized steps after each
    successful save (and sweeps stale `_tmp.*` staging dirs left by
    crashes). Not safe for concurrent writers on one directory; any
    number of readers is fine."""

    def __init__(self, directory, *, max_to_keep=3, async_save=False):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = None if max_to_keep is None else \
            int(max_to_keep)
        self.async_save = bool(async_save)
        self._pending = None
        self._async_error = None
        #: report of the last fallback restore: {"step", "skipped"}
        self.last_restore_report = None

    # ---- paths ----
    def _step_dir(self, step):
        return os.path.join(self._dir, f"{_STEP_PREFIX}{int(step):08d}")

    def all_steps(self):
        """Every finalized (renamed-into-place) step, sorted — validity
        is checked lazily by `restore()`/`validate()`."""
        out = []
        for name in os.listdir(self._dir):
            if name.startswith(_STEP_PREFIX):
                try:
                    out.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def valid_steps(self):
        return [s for s in self.all_steps() if self.validate(s) is None]

    def latest_step(self, valid_only=True):
        steps = self.valid_steps() if valid_only else self.all_steps()
        return steps[-1] if steps else None

    # ---- save ----
    def save(self, step, state, *, force=False):
        """Checkpoint `state` (nested dicts, lists and tuples of tensors,
        arrays and host data) as `step`. Sync mode blocks until the step is durably
        published. Async mode snapshots the tree to host memory NOW and
        returns; the write happens on a background thread and any
        failure surfaces on `wait()` or the next `save()`."""
        self.wait()          # serialize saves; surfaces prior errors
        tree = _pack(state)  # host snapshot, device-independent
        if not self.async_save:
            self._write(int(step), tree, force)
            return
        t = threading.Thread(
            target=self._write_guarded, args=(int(step), tree, force),
            name="paddle-tpu-ckpt-save", daemon=True)
        self._pending = t
        t.start()

    def _write_guarded(self, step, tree, force):
        try:
            self._write(step, tree, force)
        except BaseException as e:   # surfaced on wait()/next save
            self._async_error = e

    def wait(self):
        """Barrier for an in-flight async save; re-raises any error the
        background write hit (a failed checkpoint must never be
        silently dropped)."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        e, self._async_error = self._async_error, None
        if e is not None:
            raise e

    def _write(self, step, tree, force):
        final = self._step_dir(step)
        if os.path.exists(final):
            if not force:
                raise CheckpointError(
                    f"step {step} already exists at {final!r} "
                    f"(pass force=True to overwrite)")
            shutil.rmtree(final)
        tmp = os.path.join(self._dir,
                           _TMP_PREFIX + os.path.basename(final))
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            wrapped = not isinstance(tree, dict) or not tree
            shards = {"state": tree} if wrapped else tree
            manifest = {"format": 1, "step": step, "wrapped": wrapped,
                        "shards": {}}
            for i, (key, sub) in enumerate(shards.items()):
                fname = f"shard_{i:04d}.bin"
                buf = pickle.dumps(sub, protocol=4)
                crc = zlib.crc32(buf) & 0xFFFFFFFF
                size = len(buf)
                # fault point: raise = crash mid-save (staging dir is
                # all that's left), corrupt = torn bytes the manifest
                # checksum will catch on restore
                buf = _PT_WRITE(payload=buf)
                with open(os.path.join(tmp, fname), "wb") as f:
                    f.write(buf)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["shards"][str(key)] = {
                    "file": fname, "crc32": crc, "size": size}
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)   # the atomic commit point
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune(keep=step)

    def _prune(self, keep):
        for name in os.listdir(self._dir):
            if name.startswith(_TMP_PREFIX):   # stale staging dirs
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            if s != keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----
    def validate(self, step):
        """None when the step is intact, else the reason string (no
        exception: callers decide whether a bad step is fatal)."""
        try:
            self._read(step)
        except CheckpointError as e:
            return str(e)
        return None

    def _read(self, step):
        d = self._step_dir(step)
        mpath = os.path.join(d, _MANIFEST)
        if not os.path.isdir(d):
            raise CheckpointError(f"step {step}: no such checkpoint")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(
                f"step {step}: missing/unreadable manifest ({e})")
        shards = {}
        for key, meta in manifest.get("shards", {}).items():
            fpath = os.path.join(d, meta["file"])
            try:
                with open(fpath, "rb") as f:
                    buf = f.read()
            except OSError as e:
                raise CheckpointCorrupt(
                    f"step {step}: shard {key!r} unreadable ({e})")
            buf = _PT_READ(payload=buf)   # fault point: read-side rot
            if len(buf) != meta["size"] or \
                    (zlib.crc32(buf) & 0xFFFFFFFF) != meta["crc32"]:
                raise CheckpointCorrupt(
                    f"step {step}: shard {key!r} failed checksum "
                    f"(torn or corrupt write)")
            shards[key] = pickle.loads(buf)
        if manifest.get("wrapped"):
            return shards["state"]
        return shards

    def restore(self, step=None, *, return_numpy=False):
        """Load a checkpoint. With an explicit `step`, corruption is an
        error (`CheckpointCorrupt`). With `step=None`, walks steps
        newest-first, SKIPS corrupt/torn ones (flagged via a warning +
        `last_restore_report`), and returns the newest valid state —
        the crash-recovery path."""
        if step is not None:
            return _unpack(self._read(int(step)), return_numpy)
        skipped = []
        for s in reversed(self.all_steps()):
            try:
                tree = self._read(s)
            except CheckpointError as e:
                skipped.append((s, str(e)))
                continue
            self.last_restore_report = {"step": s, "skipped": skipped}
            if skipped:
                warnings.warn(
                    f"checkpoint restore fell back to step {s}; "
                    f"skipped corrupt step(s) "
                    f"{[x[0] for x in skipped]}")
            return _unpack(tree, return_numpy)
        self.last_restore_report = {"step": None, "skipped": skipped}
        raise FileNotFoundError(
            f"no valid checkpoints under {self._dir!r}"
            + (f" (skipped corrupt: {[x[0] for x in skipped]})"
               if skipped else ""))

    # ---- lifecycle ----
    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False
