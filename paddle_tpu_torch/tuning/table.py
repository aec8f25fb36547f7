"""Versioned on-disk table of tuned kernel plans, keyed by card.

The port's kernels plan their launches with rules written in C (the
clusters of `csrc/attn_merge.cuh`, `paged_verify.cu`'s tiled plan, the
int8 matmul's skinny plan, the LoRA gather's cluster), each chosen by a
hand sweep on one card. This table makes a plan *data*: the kernels'
consult sites (`ops.attention`, `ops.quant`) call `lookup(kernel, key)`
before a launch and pass a tuned entry's knob to the C entry point as
its plan override; a miss passes 0, which is the rule. A device-specific
sweep (`python -m paddle_tpu_torch.tuning.autotune`) adds entries for one
card without touching kernel code.

The schema and `TABLE_VERSION` are the JAX package's (`tuning/table.py`),
so a table file written by either package loads in the other:

    {"version": 1,
     "devices": {
       "any": {},
       "NVIDIA H100 80GB HBM3": {"flash_decode": {"64/64/2048/float32":
                                   {"split_k": 4, "step_us": 7.9,
                                    "source": "sweep"}}}}}

Lookup order: the exact device tier, then a tier whose name starts the
card's name (the prefix match of `profiler.costs.detect_spec`), then
"any". Key tuples are joined with "/"; their size components are
bucketed to powers of two (`seq_bucket`).

The port's knobs (`KERNEL_KNOBS`) and where each goes:

    flash_decode, flash_verify  {"split_k"}  blocks of the key-split
                                cluster, 1..8
    paged_flash_decode  {"kernel", "split_k"}  kernel False is the JAX
                        gather route: `paged_gather_kv` and the dense
                        decode kernel
    paged_flash_verify  {"kernel", "split_k", "tiles_per_split"}
                        split_k for the split route (T <= 8),
                        tiles_per_split for the tiled route
    int8_matmul         {"split_k"}  the skinny route's k-split cluster
    lora_matmul         {"kernel", "cluster"}

`flash_fwd` and `flash_bwd` keep their names in `KERNELS`, but the port's
tiles are fixed: `put()` refuses them. A JAX entry that carries only TPU
knobs (`block_q`, `block_m`, ...) loads, and reads as a miss at the
consult site (the JAX rule that a tuned entry that does not fit falls
back).

Env switches: ``PT_TUNING=0`` disables every lookup (the rules, zero
table reads); ``PT_TUNING_TABLE=/path.json`` layers an extra table over
the committed default (its entries win).
"""
from __future__ import annotations

import json
import os
import threading

__all__ = ["TuningTable", "TableError", "KERNELS", "KERNEL_KNOBS",
           "TABLE_VERSION", "seq_bucket", "key_str", "get_table",
           "set_table", "lookup", "reset", "current_device_kind",
           "committed_table_path", "state_token", "tuned"]

KERNELS = ("flash_fwd", "flash_bwd", "flash_decode", "flash_verify",
           "paged_flash_decode", "paged_flash_verify", "int8_matmul",
           "lora_matmul")

#: knob names each kernel's config may carry in the port (schema check:
#: unknown keys are tolerated, but a config naming none of its kernel's
#: knobs is refused at put() time)
KERNEL_KNOBS = {
    "flash_fwd": (),
    "flash_bwd": (),
    "flash_decode": ("split_k",),
    "flash_verify": ("split_k",),
    "paged_flash_decode": ("kernel", "split_k"),
    "paged_flash_verify": ("kernel", "split_k", "tiles_per_split"),
    "int8_matmul": ("split_k",),
    "lora_matmul": ("kernel", "cluster"),
}

#: why a kernel takes no entry in the port
FIXED_TILES = {
    "flash_fwd": "the port's flash forward has fixed tiles (64-key tiles, "
                 "query tiles by route); its only plan, the key cluster, "
                 "is the C rule pt_flash_fwd_cluster",
    "flash_bwd": "the port's flash backward kernels have fixed tiles",
}

#: bump when the key layout or knob semantics change: a mismatched
#: table is IGNORED (the rules apply), never misread
TABLE_VERSION = 1


class TableError(ValueError):
    """Malformed / version-mismatched tuning table."""


def seq_bucket(n):
    """Power-of-two bucket for size key components (the policy of
    core.bucketing.bucket_size, inlined so the table has no package
    dependencies)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def key_str(parts):
    """Canonical string form of a key tuple: '64/64/2048/float32'."""
    if isinstance(parts, str):
        return parts
    return "/".join(str(p) for p in parts)


_KIND = []


def current_device_kind():
    """The card's name (`torch.cuda.get_device_name`, e.g. "NVIDIA H100
    80GB HBM3"), or "cpu" without one: the table's device tier. Read once
    a process."""
    if not _KIND:
        try:
            import torch

            _KIND.append(torch.cuda.get_device_name(0)
                         if torch.cuda.is_available() else "cpu")
        except Exception:
            _KIND.append("cpu")
    return _KIND[0]


class TuningTable:
    """{device_kind: {kernel: {key_str: config}}} with atomic JSON
    persistence. Thread-safe for concurrent lookup/put."""

    def __init__(self, devices=None):
        self._lock = threading.Lock()
        self._devices = {}
        self.version = 0          # bumped by every put (consult memos)
        for dev, kernels in (devices or {}).items():
            for kern, entries in kernels.items():
                for k, cfg in entries.items():
                    self.put(kern, k, cfg, device_kind=dev,
                             _validate=False)

    # ---- access ----
    def _tiers(self, device_kind):
        tiers = [device_kind]
        low = str(device_kind).lower()
        tiers += sorted((t for t in self._devices
                         if t not in (device_kind, "any")
                         and low.startswith(t.lower())),
                        key=len, reverse=True)
        return tiers + ["any"]

    def lookup(self, kernel, key, device_kind=None):
        """The tuned config for (kernel, key): the exact device tier
        first, then a tier naming a prefix of the card, then 'any'.
        Returns None on a miss (the caller runs its rule)."""
        ks = key_str(key)
        if device_kind is None:
            device_kind = current_device_kind()
        with self._lock:
            for tier in self._tiers(device_kind):
                cfg = self._devices.get(tier, {}).get(kernel, {}).get(ks)
                if cfg is not None:
                    return dict(cfg)
        return None

    def put(self, kernel, key, config, device_kind="any", _validate=True):
        """Install one entry. `config` keeps extra metadata fields
        (step_us, source, ...) alongside the knobs."""
        if _validate:
            if kernel not in KERNELS:
                raise TableError(f"unknown kernel {kernel!r} (one of "
                                 f"{KERNELS})")
            if kernel in FIXED_TILES:
                raise TableError(f"{kernel!r} takes no tuned entry in the "
                                 f"port: {FIXED_TILES[kernel]}")
            knobs = KERNEL_KNOBS[kernel]
            if not any(k in config for k in knobs):
                raise TableError(
                    f"config for {kernel!r} names none of its knobs "
                    f"{knobs}: {config!r}")
        with self._lock:
            self._devices.setdefault(str(device_kind), {}) \
                .setdefault(str(kernel), {})[key_str(key)] = dict(config)
            self.version += 1

    def merge(self, other):
        """Layer `other`'s entries over this table (other wins)."""
        for dev, kernels in other.as_dict()["devices"].items():
            with self._lock:
                self._devices.setdefault(dev, {})
            for kern, entries in kernels.items():
                for k, cfg in entries.items():
                    self.put(kern, k, cfg, device_kind=dev,
                             _validate=False)
        return self

    def clear(self, device_kind):
        """Empty one device tier (it stays in the file, with no entry)."""
        with self._lock:
            self._devices[str(device_kind)] = {}
            self.version += 1

    def entries(self, device_kind=None, kernel=None):
        """Flat [(device_kind, kernel, key_str, config)] rows (the CLI
        renders these)."""
        out = []
        with self._lock:
            for dev, kernels in sorted(self._devices.items()):
                if device_kind is not None and dev != device_kind:
                    continue
                for kern, ent in sorted(kernels.items()):
                    if kernel is not None and kern != kernel:
                        continue
                    for k, cfg in sorted(ent.items()):
                        out.append((dev, kern, k, dict(cfg)))
        return out

    def __len__(self):
        return len(self.entries())

    # ---- persistence ----
    def as_dict(self):
        with self._lock:
            return {"version": TABLE_VERSION,
                    "devices": {d: {k: {kk: dict(c)
                                        for kk, c in e.items()}
                                    for k, e in kernels.items()}
                                for d, kernels in self._devices.items()}}

    def save(self, path):
        """Atomic write: tmp in the target dir, then os.replace (a torn
        write can never leave a half-table behind)."""
        payload = json.dumps(self.as_dict(), indent=1, sort_keys=True)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(payload + "\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path):
        """Parse and version-check a table file. Raises TableError on a
        malformed/mismatched file; get_table() turns that into a warning
        and the rules, never a crash."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError) as e:
            raise TableError(f"unreadable tuning table {path}: {e}")
        if not isinstance(raw, dict) or \
                raw.get("version") != TABLE_VERSION:
            raise TableError(
                f"tuning table {path} version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'}"
                f" != {TABLE_VERSION}")
        devices = raw.get("devices")
        if not isinstance(devices, dict):
            raise TableError(f"tuning table {path} has no devices map")
        t = cls(devices)
        with t._lock:
            for dev in devices:
                t._devices.setdefault(dev, {})
        return t


# ----------------------------------------------------------------------
# the module-wide table the kernels consult
# ----------------------------------------------------------------------

def committed_table_path():
    """The in-repo default table: an empty 'any' tier (the C rules are
    the fallback) and the tiers of the cards swept so far."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tables", "default.json")


_LOCK = threading.Lock()
_UNSET = object()
_TABLE = _UNSET
_WARNED = set()
#: bumped by set_table / reset (consult memos key on it)
_GENERATION = [0]


def _warn_once(tag, msg):
    if tag in _WARNED:
        return
    _WARNED.add(tag)
    import warnings

    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _load_default():
    table = TuningTable()
    try:
        table.merge(TuningTable.load(committed_table_path()))
    except TableError as e:
        _warn_once("default", f"committed tuning table unusable "
                              f"({e}); kernel rules apply")
    extra = os.environ.get("PT_TUNING_TABLE")
    if extra:
        try:
            table.merge(TuningTable.load(extra))
        except TableError as e:
            _warn_once("env", f"PT_TUNING_TABLE unusable ({e}); "
                              f"entry ignored")
    return table


def get_table():
    """The active TuningTable (lazily loaded; None when PT_TUNING=0)."""
    global _TABLE
    if os.environ.get("PT_TUNING", "1") == "0":
        return None
    t = _TABLE
    if t is _UNSET:
        with _LOCK:
            if _TABLE is _UNSET:
                _TABLE = _load_default()
            t = _TABLE
    return t


def set_table(table):
    """Install a table explicitly (tests / after a sweep). None means
    re-load lazily on next use."""
    global _TABLE
    with _LOCK:
        _TABLE = table if table is not None else _UNSET
        _GENERATION[0] += 1


def reset():
    """Back to lazy default loading (test teardown symmetry)."""
    set_table(None)


def state_token():
    """What a memo of lookups depends on: the switches, the installed
    table and its entries. Equal tokens give equal lookups."""
    t = _TABLE
    return (os.environ.get("PT_TUNING", "1"),
            os.environ.get("PT_TUNING_TABLE"), _GENERATION[0],
            None if t is _UNSET else t.version)


def lookup(kernel, key, device_kind=None):
    """The one call consult sites make: the tuned config dict, or None
    (run the rule). Returns None unconditionally under PT_TUNING=0."""
    t = get_table()
    if t is None:
        return None
    return t.lookup(kernel, key, device_kind=device_kind)


_MEMO = {}


def tuned(kernel, key):
    """`lookup` as the kernels' consult sites make it: memoized per
    (kernel, key) while `state_token()` holds, and any failure of the
    tuning layer (an unreadable table, a bad entry) reads as a miss
    (None), as the JAX package's `_tuned` reads it. The returned dict is
    shared: do not change it."""
    try:
        tok = state_token()
        hit = _MEMO.get((kernel, key))
        if hit is not None and hit[0] == tok:
            return hit[1]
        cfg = lookup(kernel, key)
        _MEMO[(kernel, key)] = (tok, cfg)
        return cfg
    except Exception:
        return None
