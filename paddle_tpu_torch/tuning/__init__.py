"""Kernel plan tuning and the persistent cache of built kernels.

Two coupled halves, as in the JAX package's `tuning/`:

  * **The tuning table and the sweep** (`table.py`, `autotune.py`): the
    Hopper kernels' launch plans (key-split clusters, the tiled verify's
    tiles a split, the skinny int8 k-split, the LoRA cluster) come from C
    rules picked by hand; the consult sites in `ops.attention` and
    `ops.quant` look each launch's key up in a card-tiered `TuningTable`
    and pass a tuned entry to the C entry point as the plan's override (0,
    the rule, on a miss). `python -m paddle_tpu_torch.tuning.autotune`
    times the legal overrides against the rule on the card and keeps a
    winner only where it beats the rule by more than its pairs' spread.
  * **The AOT cache** (`aot_cache.py`): `ServingEngine.precompile()`
    readies every serving program of a pool config before the first
    request. Its cold start builds the kernel libraries the programs
    launch and stores them, with one record per program, in an
    `AotCompileCache` (a directory with a CRC-manifested index, every
    write staged and renamed); a warm restart copies the libraries out
    and starts no `nvcc` process.
"""
from .aot_cache import (AotCompileCache, CacheCorrupt, env_fingerprint,
                        model_fingerprint)
from .table import (KERNELS, TableError, TuningTable, committed_table_path,
                    current_device_kind, get_table, key_str, lookup, reset,
                    seq_bucket, set_table)

__all__ = [
    "TuningTable", "TableError", "KERNELS", "get_table", "set_table",
    "lookup", "reset", "current_device_kind", "committed_table_path",
    "seq_bucket", "key_str", "AotCompileCache", "CacheCorrupt",
    "env_fingerprint", "model_fingerprint",
]
