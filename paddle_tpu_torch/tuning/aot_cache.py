"""Persistent AOT cache: built kernel libraries and program records on disk.

A cold start of the port pays for its programs once: `nvcc` builds the
kernel libraries a serving program launches, and each program's first run
plans and allocates. `AotCompileCache` keeps what outlives the process:

  * each built kernel library (`ops/_build.py`), keyed by its stem and
    the build digest (sources, flags, toolchain; `_build.library_key`),
    so a restart copies it out instead of running nvcc;
  * one record per serving program, keyed by the engine's
    `_program_cache_key(key)` (the JAX form: "{type}|{model
    fingerprint}|{pool key}|{key!r}"), naming the library keys that
    program launches. `ServingEngine.precompile()` on a restarted server
    finds every record and every library it names valid, and readies the
    programs with no nvcc process and no first run.

Layout (the JAX package's; every write staged to a tmp file and
`os.replace`d, so a torn write can never leave a half entry that parses):

    <dir>/MANIFEST.json          {"version", "fingerprint", "entries":
                                  {digest: {"key", "crc32", "size"}}}
    <dir>/entries/<digest>.bin   the entry's bytes

Robustness contract: a torn or corrupt entry (CRC or size mismatch), or a
manifest written for another environment, NEVER crashes a start: the
entry counts as a miss (`stats["corrupt"]` / `stats["stale"]`), the
library is rebuilt or the program run, and a store refreshes the entry.
The `tuning.cache_load` fault point lets tests corrupt a blob in flight
(read as a miss) or raise (propagated).

Identity: entries are valid only for the environment that wrote them:
`env_fingerprint()` pins the schema, torch's version and CUDA version,
nvcc's version where there is one, the backend, the card's name and the
card count.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib

from ..testing import faults

__all__ = ["AotCompileCache", "CacheCorrupt", "env_fingerprint",
           "model_fingerprint", "CACHE_SCHEMA"]

#: armed by chaos tests to corrupt / raise / delay on every cache-entry
#: read (payload = the raw entry bytes, before the CRC check)
_PT_CACHE_LOAD = faults.point("tuning.cache_load")

#: bump when the entry format changes: old caches read as stale (rebuilt
#: and overwritten), never as garbage
CACHE_SCHEMA = 1


class CacheCorrupt(RuntimeError):
    """A cache entry failed its CRC / size check: an internal signal that
    `load()` turns into a miss and a counter."""


def env_fingerprint():
    """Everything a built library and a program record are only valid
    for."""
    import torch

    from ..ops import _build

    cuda = torch.cuda.is_available()
    try:
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        n = torch.cuda.device_count() if cuda else 0
    except Exception:
        kind, n = "unknown", 0
    return {"schema": CACHE_SCHEMA,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": _build.toolchain()["nvcc"],
            "backend": "cuda" if cuda else "cpu",
            "device_kind": kind,
            "n_devices": n}


def model_fingerprint(named_tensors):
    """sha256 over sorted (name, shape, dtype) of a model's parameters and
    buffers (`(name, tensor)` pairs): two models with different weight
    SHAPES never share an entry (values do not matter: weights are
    runtime arguments)."""
    h = hashlib.sha256()
    for name, v in sorted(named_tensors, key=lambda kv: kv[0]):
        dtype = str(getattr(v, "dtype", "?")).replace("torch.", "")
        h.update(f"{name}:{tuple(getattr(v, 'shape', ()))}:{dtype};"
                 .encode())
    return h.hexdigest()[:16]


class AotCompileCache:
    """One cache directory of byte entries. Thread-safe; the counters in
    `stats` make the cold-start metrics exact:

        loaded   entries read valid
        saved    entries written
        misses   keys with no entry
        corrupt  CRC / size failures (read as misses)
        stale    entries of a manifest written for another environment
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, path):
        self.path = str(path)
        self._entries_dir = os.path.join(self.path, "entries")
        self._lock = threading.Lock()
        self._fp = env_fingerprint()
        self.stats = {"loaded": 0, "saved": 0, "misses": 0,
                      "corrupt": 0, "stale": 0}
        self._manifest = self._read_manifest()

    # ---- manifest ----
    def _manifest_path(self):
        return os.path.join(self.path, self.MANIFEST)

    def _read_manifest(self):   # analysis: single-threaded
        # construction-time only: no second thread can hold the cache
        # while __init__ is still populating it
        try:
            with open(self._manifest_path()) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict) or \
                raw.get("version") != CACHE_SCHEMA or \
                raw.get("fingerprint") != self._fp:
            # another torch / toolchain / card / schema wrote this cache:
            # every entry is unusable here. Start empty; stores rebuild
            # the manifest under the current fingerprint
            if isinstance(raw, dict) and isinstance(raw.get("entries"),
                                                    dict):
                self.stats["stale"] += len(raw["entries"])
            return {}
        ent = raw.get("entries")
        return dict(ent) if isinstance(ent, dict) else {}

    def _write_manifest(self):
        os.makedirs(self.path, exist_ok=True)
        payload = json.dumps({"version": CACHE_SCHEMA,
                              "fingerprint": self._fp,
                              "entries": self._manifest},
                             indent=1, sort_keys=True)
        tmp = os.path.join(self.path,
                           f".{self.MANIFEST}.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self._manifest_path())

    @staticmethod
    def _digest(key_str):
        return hashlib.sha256(key_str.encode()).hexdigest()[:32]

    def __len__(self):
        with self._lock:
            return len(self._manifest)

    def keys(self):
        with self._lock:
            return sorted(m["key"] for m in self._manifest.values())

    # ---- load / store ----
    def _meta(self, key_str):
        dg = self._digest(key_str)
        with self._lock:
            meta = self._manifest.get(dg)
        if meta is None or meta.get("key") != key_str:
            return dg, None
        return dg, meta

    def _drop(self, dg):
        # a torn entry leaves the manifest, so a refreshing store is not
        # shadowed by it
        with self._lock:
            self.stats["corrupt"] += 1
            self._manifest.pop(dg, None)
            try:
                self._write_manifest()
            except OSError:
                pass

    def load(self, key_str):
        """The entry's bytes for `key_str`, or None (a miss, a corrupt
        entry: counted, never raised). An injected raise propagates."""
        dg, meta = self._meta(key_str)
        if meta is None:
            with self._lock:
                self.stats["misses"] += 1
            return None
        try:
            with open(os.path.join(self._entries_dir, dg + ".bin"),
                      "rb") as f:
                blob = f.read()
            blob = _PT_CACHE_LOAD(payload=blob)
            if zlib.crc32(blob) != meta.get("crc32") or \
                    len(blob) != meta.get("size"):
                raise CacheCorrupt(f"entry {dg} failed its CRC/size check "
                                   f"(torn write or bit rot)")
        except faults.InjectedFault:
            raise
        except (OSError, CacheCorrupt):
            self._drop(dg)
            return None
        with self._lock:
            self.stats["loaded"] += 1
        return blob

    def check_file(self, key_str, path):
        """Whether the file at `path` holds the entry's bytes: True (its
        CRC and size match the manifest), False (they do not: a torn or
        corrupt copy), or None (the cache has no such entry)."""
        _, meta = self._meta(key_str)
        if meta is None:
            return None
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return False
        return zlib.crc32(blob) == meta.get("crc32") and \
            len(blob) == meta.get("size")

    def store(self, key_str, blob):
        """Persist one entry's bytes. Returns True on success; False when
        the disk write fails (the start proceeds, only the NEXT start pays
        for this entry again)."""
        blob = bytes(blob)
        dg = self._digest(key_str)
        try:
            os.makedirs(self._entries_dir, exist_ok=True)
            tmp = os.path.join(self._entries_dir,
                               f".{dg}.tmp-{os.getpid()}")
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(self._entries_dir, dg + ".bin"))
            with self._lock:
                self._manifest[dg] = {"key": key_str,
                                      "crc32": zlib.crc32(blob),
                                      "size": len(blob)}
                self._write_manifest()
        except OSError:
            return False
        with self._lock:
            self.stats["saved"] += 1
        return True

    # ---- program records ----
    def load_record(self, key_str):
        """A program record (a dict) for `key_str`, or None."""
        blob = self.load(key_str)
        if blob is None:
            return None
        try:
            rec = json.loads(blob.decode())
        except (UnicodeDecodeError, ValueError):
            rec = None
        if not isinstance(rec, dict):
            self._drop(self._digest(key_str))
            return None
        return rec

    def store_record(self, key_str, record):
        return self.store(key_str, json.dumps(record, sort_keys=True)
                          .encode())
