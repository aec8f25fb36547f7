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

`AsyncCheckpointer`, `save_sharded` and `load_sharded` are the JAX
package's orbax-backed API, built here on `CheckpointManager` (no
orbax): `AsyncCheckpointer` snapshots to host memory in `save` and
writes on a background thread, with `max_to_keep` retention; under
`save_sharded` every rank of a mesh writes the blocks it holds, with the
split each carries, and `load_sharded` puts the global (logical) arrays
back together in any process, as the JAX restore returns them. A mesh
trainer takes its blocks back through the shard cut
(`convert.from_jax_state(arrays, rules, mesh)` or
`parallel.shard_tensor`).

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

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointCorrupt",
           "AsyncCheckpointer", "save_sharded", "load_sharded"]


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


class AsyncCheckpointer:
    """The JAX package's async checkpoint manager (save_persistables and
    auto-checkpoint with background IO) on `CheckpointManager`: `save`
    snapshots the tensors to host memory and returns, a background thread
    writes the step (atomic, checksummed), an error there surfaces on
    `wait` (or the next `save`), and the oldest steps beyond `max_to_keep`
    are pruned. `restore` returns the newest valid step (or `step`) as
    numpy arrays, as the orbax restore does."""

    def __init__(self, directory, max_to_keep=3):
        self._dir = os.path.abspath(directory)
        self._mgr = CheckpointManager(self._dir, max_to_keep=max_to_keep,
                                      async_save=True)

    def save(self, step, state, force=False):
        """Non-blocking: returns once the tensors are copied to the host;
        the write continues in the background."""
        self._mgr.save(int(step), state, force=force)

    def wait(self):
        self._mgr.wait()

    def all_steps(self):
        return self._mgr.all_steps()

    def latest_step(self):
        return self._mgr.latest_step()

    def restore(self, step=None):
        self._mgr.wait()
        return self._mgr.restore(step, return_numpy=True)

    def close(self):
        self._mgr.close()


_SHARDED_MANIFEST = "sharded.json"


def _flatten(tree, prefix=""):
    """A nested dict of tensors / arrays -> {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _host_array(x):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), None
    return np.asarray(x), None


def save_sharded(state, directory, shardings=None):
    """One-shot sharded save (collective over the world's ranks when a
    process group is up, else this process alone): every rank writes the
    blocks it holds. `state` is a nested dict of tensors or arrays;
    `shardings` maps a leaf's "/"-joined path (e.g.
    ``"params/linear.weight"``) to the `parallel.Sharding` its block was
    cut with (e.g. from `SpmdTrainer.param_shardings`); a leaf without
    one is whole on every rank and rank 0 writes it. Of the ranks holding
    the same block (replicas over the axes that do not split it) only the
    first writes. Each rank's file carries its blocks' indices and a
    CRC32; rank 0 publishes the manifest (the global shapes and splits)
    once every rank has written, and renames the directory into place."""
    import pickle

    import torch.distributed as dist

    from .serialization import _pack

    path = os.path.abspath(directory)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tmp = path + ".tmp_sharded"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if world > 1:
        dist.barrier()
    shardings = shardings or {}
    entries, blocks = {}, {}
    for name, leaf in _flatten(state).items():
        arr, tag = _host_array(leaf)
        sh = shardings.get(name)
        splits = [] if sh is None or not sh.is_split else [
            (int(d), list(ax)) for d, ax in sh.splits]
        if splits:
            shape = list(arr.shape)
            for d, ax in splits:
                shape[d] *= sh.parts(ax)
            split_axes = {a for _, ax in splits for a in ax}
            replica = any(sh.mesh.coord(a) for a in sh.mesh.axis_names
                          if a not in split_axes)
            index = [int(sh.mesh.coord(tuple(ax))) for _, ax in splits]
        else:
            shape, replica, index = list(arr.shape), rank != 0, []
        entries[name] = {"shape": shape, "dtype": tag or str(arr.dtype),
                         "splits": splits,
                         "parts": [int(sh.parts(ax)) for _, ax in splits]
                         if splits else []}
        if not replica:
            blocks[name] = {"index": index, "data": _pack(arr)}
    buf = pickle.dumps(blocks, protocol=4)
    fname = f"rank_{rank:05d}.bin"
    with open(os.path.join(tmp, fname), "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    meta = {"file": fname, "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
            "size": len(buf)}
    if world > 1:
        metas = [None] * world
        dist.all_gather_object(metas, meta)
    else:
        metas = [meta]
    if rank == 0:
        with open(os.path.join(tmp, _SHARDED_MANIFEST), "w") as f:
            json.dump({"format": 1, "world": world, "entries": entries,
                       "ranks": metas}, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
    if world > 1:
        dist.barrier()


def load_sharded(directory):
    """The global (logical) arrays of a `save_sharded` directory, as a
    nested dict of numpy arrays (bfloat16 leaves come back as float32);
    every rank file is checked against its CRC32. No collective: any
    process can read it."""
    import pickle

    import numpy as np

    from .serialization import _unpack

    path = os.path.abspath(directory)
    try:
        with open(os.path.join(path, _SHARDED_MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{path}: missing/unreadable sharded "
                                f"manifest ({e})")
    entries = manifest["entries"]
    out = {}
    for name, e in entries.items():
        dt = np.float32 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
        out[name] = (np.zeros(e["shape"], dt), np.zeros(
            [int(np.prod(e["parts"] or [1]))], bool))
    for meta in manifest["ranks"]:
        with open(os.path.join(path, meta["file"]), "rb") as f:
            buf = f.read()
        if len(buf) != meta["size"] or \
                (zlib.crc32(buf) & 0xFFFFFFFF) != meta["crc32"]:
            raise CheckpointCorrupt(f"{path}: {meta['file']} failed its "
                                    f"checksum (torn or corrupt write)")
        for name, blk in pickle.loads(buf).items():
            e = entries[name]
            full, seen = out[name]
            data = np.asarray(_unpack(blk["data"], True))
            sl = [slice(None)] * len(e["shape"])
            flat = 0
            for (d, _), n, i in zip(e["splits"], e["parts"], blk["index"]):
                step = e["shape"][d] // n
                sl[d] = slice(i * step, (i + 1) * step)
                flat = flat * n + i
            full[tuple(sl)] = data
            seen[flat] = True
    for name, (full, seen) in out.items():
        if not seen.all():
            raise CheckpointCorrupt(f"{path}: {name!r} is missing blocks")
    return _unflatten({n: v[0] for n, v in out.items()})
