"""Cost and memory accounting over every program the engines run.

`profiler.trace` makes the serving stack traceable (who did what, when);
this module makes it accountable (what did it cost). Three views, all
keyed by the SAME cache keys the engines' `trace_counts` counters and the
retrace sentinel use, so cost, compile and trace records join on one
identity:

  * **Program costs**: while an accounting session is armed
    (`accounting_scope()`), every program's first run records a
    `ProgramCost` into the session's `CostBook`. The port compiles no
    program that could report its own cost (the JAX package reads XLA's
    `cost_analysis()`), so every cost is the owner's `cost_hint(key)`:
    analytic flops and bytes for the known decode, prefill and join
    shapes, tagged ``source="analytic"``.
  * **DeviceSpec / MFU**: `mfu(flops, dt, spec)` and `bw_util(bytes, dt,
    spec)` turn per-step costs into model-flops-utilization and
    bandwidth-utilization gauges against a device roofline. `CPU_SPEC`
    ships for deterministic tests (the JAX package's constants); the
    H100 is tabled in `DEVICE_SPECS` and `detect_spec()` picks by
    `torch.cuda.get_device_name()`.
  * **Memory ledger plumbing**: `temp_high_water()` is the largest
    transient footprint of any program's first run across the book: the
    caching allocator's peak above the bytes live when the run started
    (the JAX package reports XLA's compile temp buffers here). To read
    it, an armed session resets the allocator's peak statistic
    (`torch.cuda.reset_peak_memory_stats`) at each first run on a card,
    so a caller's own `max_memory_allocated()` across an armed session
    reads the largest since the last first run.

Discipline (as in profiler.trace): a disarmed hot path pays ONE
module-global read (`costs._BOOK is None`), and an armed one pays only
at a program's first run, never on warm calls.
"""
from __future__ import annotations

import contextlib
import threading

from . import trace as _trace

__all__ = [
    "DeviceSpec", "ProgramCost", "CostBook", "CPU_SPEC", "H100_SXM_SPEC",
    "DEVICE_SPECS", "detect_spec", "start_accounting", "end_accounting",
    "accounting_scope", "book", "mfu", "bw_util", "temp_high_water",
    "transformer_decode_flops", "transformer_prefill_flops", "cost_for",
    "analytic_cost", "first_run", "capture_compiled",
]


class DeviceSpec:
    """Peak-rate roofline for one accelerator: the denominators of the
    MFU / bandwidth-utilization gauges plus the device memory the memory
    ledger budgets against."""

    __slots__ = ("name", "peak_flops", "peak_bytes_per_s", "hbm_bytes")

    def __init__(self, name, peak_flops, peak_bytes_per_s, hbm_bytes):
        self.name = name
        self.peak_flops = float(peak_flops)
        self.peak_bytes_per_s = float(peak_bytes_per_s)
        self.hbm_bytes = int(hbm_bytes)

    def as_dict(self):
        return {"name": self.name,
                "peak_tflops": round(self.peak_flops / 1e12, 3),
                "peak_gbps": round(self.peak_bytes_per_s / 1e9, 1),
                "hbm_gb": round(self.hbm_bytes / 2**30, 1)}

    def __repr__(self):
        return (f"DeviceSpec({self.name!r}, "
                f"{self.peak_flops / 1e12:.2f} TFLOP/s, "
                f"{self.peak_bytes_per_s / 1e9:.0f} GB/s)")


#: NOMINAL single-core CPU roofline: a fixed constant, not a
#: measurement, so MFU numbers in tests are deterministic functions of
#: (flops, dt). ~one AVX2 core: 8 lanes x 2 FMA ports x 2 flops @ 3GHz.
CPU_SPEC = DeviceSpec("cpu", 96e9, 40e9, 16 * 2**30)

#: NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
#: 989 TFLOP/s dense bf16 (and fp16) on the tensor cores (the sheet's
#: 1,979 counts 2:4 sparsity), 3.35 TB/s HBM3, 80 GB of device memory.
H100_SXM_SPEC = DeviceSpec("NVIDIA H100", 989e12, 3.35e12, 80 * 10**9)

#: published peaks (dense 16-bit matmul flops, memory bandwidth, memory)
DEVICE_SPECS = {
    "cpu": CPU_SPEC,
    "NVIDIA H100": H100_SXM_SPEC,
}


def detect_spec(default=CPU_SPEC):
    """Spec for the current CUDA card by `torch.cuda.get_device_name()`
    (prefix match, so "NVIDIA H100 80GB HBM3" resolves); `default`
    without a card or for an unknown one."""
    import torch

    if not torch.cuda.is_available():
        return default
    kind = torch.cuda.get_device_name()
    for name, spec in DEVICE_SPECS.items():
        if kind.lower().startswith(name.lower()):
            return spec
    return default


def mfu(flops, dt_s, spec):
    """Model-flops-utilization: achieved flop rate / the spec peak."""
    if dt_s <= 0:
        return 0.0
    return flops / dt_s / spec.peak_flops


def bw_util(bytes_accessed, dt_s, spec):
    """Achieved memory traffic / the spec's peak memory bandwidth."""
    if dt_s <= 0:
        return 0.0
    return bytes_accessed / dt_s / spec.peak_bytes_per_s


# ----------------------------------------------------------------------
# analytic transformer costs (the hint vocabulary)
# ----------------------------------------------------------------------

def transformer_decode_flops(n_params, batch, kv_len, n_layers,
                             n_heads, head_dim, mem_len=0):
    """One decode step over `batch` rows: 2 flops per (dense param,
    row) for the matmul stack, plus attention reads over `kv_len` live
    keys (QK^T + AV = 4 per key position per head dim) and `mem_len`
    cross-attention keys."""
    dense = 2.0 * float(n_params) * batch
    attn = 4.0 * n_layers * batch * n_heads * head_dim * \
        (kv_len + mem_len)
    return dense + attn


def transformer_prefill_flops(n_params, batch, prompt_len, n_layers,
                              n_heads, head_dim, mem_len=0):
    """Prefill over a `prompt_len`-token (bucketed) prompt: the dense
    stack touches every token; self-attention is causal quadratic."""
    dense = 2.0 * float(n_params) * batch * prompt_len
    attn = 4.0 * n_layers * batch * n_heads * head_dim * \
        (prompt_len * (prompt_len + 1) / 2.0 + prompt_len * mem_len)
    return dense + attn


class ProgramCost:
    """Cost / memory record for ONE program (one cache key). `temp_bytes`
    is the allocator's peak above the live bytes during the program's
    first run (0 on the CPU, or when the first run came before arming)."""

    __slots__ = ("owner", "key", "flops", "bytes_accessed",
                 "argument_bytes", "output_bytes", "temp_bytes",
                 "generated_code_bytes", "compile_s", "source")

    def __init__(self, owner, key, *, flops=0.0, bytes_accessed=0.0,
                 argument_bytes=0, output_bytes=0, temp_bytes=0,
                 generated_code_bytes=0, compile_s=0.0, source="analytic"):
        self.owner = owner
        self.key = key
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.argument_bytes = int(argument_bytes)
        self.output_bytes = int(output_bytes)
        self.temp_bytes = int(temp_bytes)
        self.generated_code_bytes = int(generated_code_bytes)
        self.compile_s = float(compile_s)
        self.source = source

    def as_dict(self):
        return {"owner": self.owner, "key": _trace._key_str(self.key),
                "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "generated_code_bytes": self.generated_code_bytes,
                "compile_s": round(self.compile_s, 4),
                "source": self.source}

    def __repr__(self):
        return (f"ProgramCost({self.owner}:{self.key!r}, "
                f"{self.flops:.3g} flops, "
                f"{self.bytes_accessed:.3g} B, {self.source})")


class CostBook:
    """Thread-safe {(owner_name, cache_key): ProgramCost}: the armed
    accounting session's sink. Keys are the engines' program-cache /
    trace_counts keys verbatim, so cost records join the retrace
    sentinel's counters and the tracer's compile spans on one
    identity."""

    def __init__(self, spec=None):
        self.spec = spec if spec is not None else detect_spec()
        self._lock = threading.Lock()
        self._costs = {}
        self._temps = {}      # (owner_name, key) -> first-run temp bytes
        self.compiles = 0

    def get(self, owner_name, key):
        with self._lock:
            return self._costs.get((owner_name, key))

    def put(self, cost):
        with self._lock:
            self._costs[(cost.owner, cost.key)] = cost
        return cost

    def note_temp(self, owner_name, key, nbytes):
        """The allocator's peak above the live bytes during a first run
        (`first_run`), for the key's ProgramCost."""
        with self._lock:
            self._temps[(owner_name, key)] = int(nbytes)
            c = self._costs.get((owner_name, key))
            if c is not None:
                c.temp_bytes = int(nbytes)

    def temp_of(self, owner_name, key):
        with self._lock:
            return self._temps.get((owner_name, key), 0)

    def keys(self):
        with self._lock:
            return list(self._costs)

    def costs(self):
        with self._lock:
            return list(self._costs.values())

    def temp_high_water(self):
        """Peak first-run temp bytes across every recorded program:
        programs don't run concurrently, so the max (not the sum) is
        what the allocator must hold in reserve."""
        with self._lock:
            return max((c.temp_bytes for c in self._costs.values()),
                       default=0)

    def report(self):
        """Rows sorted by flops, heaviest first (tools render this)."""
        with self._lock:
            rows = sorted(self._costs.values(),
                          key=lambda c: -c.flops)
        return [c.as_dict() for c in rows]


# ----------------------------------------------------------------------
# the armed accounting session
# ----------------------------------------------------------------------

#: the ONE global the hot paths read; None = accounting disarmed
_BOOK = None
_LOCK = threading.Lock()


def book():
    """The armed CostBook, or None."""
    return _BOOK


def analytic_cost(owner, key, compile_s=0.0):
    """The owner's `cost_hint(key)` as a ProgramCost (source
    "analytic"), or None when the owner declines the key."""
    hint = getattr(owner, "cost_hint", None)
    if hint is None:
        return None
    try:
        h = hint(key)
    except Exception:
        _trace._LOG.exception("cost_hint(%r) of %s failed", key,
                              type(owner).__name__)
        return None
    if h is None:
        return None
    bk = _BOOK
    temp = bk.temp_of(type(owner).__name__, key) if bk is not None else 0
    return ProgramCost(type(owner).__name__, key,
                       flops=h.get("flops", 0.0),
                       bytes_accessed=h.get("bytes_accessed", 0.0),
                       temp_bytes=max(temp, h.get("temp_bytes", 0)),
                       argument_bytes=h.get("argument_bytes", 0),
                       compile_s=compile_s, source="analytic")


def _on_compile(owner, key, fn, args, kw, t0, t1):
    bk = _BOOK
    if bk is None:
        return
    bk.compiles += 1
    if bk.get(type(owner).__name__, key) is not None:
        return
    cost = analytic_cost(owner, key, compile_s=t1 - t0)
    if cost is not None:
        bk.put(cost)


def capture_compiled(owner, key, compiled=None, compile_s=0.0):
    """Record one program that `ServingEngine.precompile()` readied into
    the armed book (no-op when accounting is disarmed), the ones readied
    from the AOT cache included, which never pass through a first run:
    a warm start still arrives with a fully populated cost book. The port
    compiles no program that could report its own cost, so `compiled` is
    unused and the record is the owner's analytic hint (source
    "analytic")."""
    bk = _BOOK
    if bk is None:
        return None
    name = type(owner).__name__
    cost = bk.get(name, key)
    if cost is not None:
        return cost
    cost = analytic_cost(owner, key, compile_s=compile_s)
    if cost is not None:
        bk.put(cost)
    return cost


def cost_for(owner, key):
    """The armed book's record for (owner, key), materializing the
    analytic cost on first ask (programs first run BEFORE arming have
    no record; the hint keeps the MFU gauges live). None when disarmed
    or unknowable."""
    bk = _BOOK
    if bk is None:
        return None
    name = type(owner).__name__
    c = bk.get(name, key)
    if c is None:
        c = analytic_cost(owner, key)
        if c is not None:
            bk.put(c)
    return c


def first_run(owner, key, fn):
    """`fn` as a program of `owner`'s cache at `key`: its first call
    bumps `owner.trace_counts[key]` (the port's counterpart of a
    compile) and, under an armed session on a card, records the
    allocator's peak above the bytes live when the run started
    (`CostBook.note_temp`). Later calls are `fn` behind one flag
    read."""
    done = []

    def call(*args, **kw):
        if done:
            return fn(*args, **kw)
        done.append(True)
        owner.trace_counts[key] += 1
        bk = _BOOK
        dev = getattr(owner, "device", None)
        if bk is None or dev is None or dev.type != "cuda":
            return fn(*args, **kw)
        import torch

        live = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*args, **kw)
        bk.note_temp(type(owner).__name__, key,
                     torch.cuda.max_memory_allocated(dev) - live)
        return out
    return call


def start_accounting(spec=None, book=None):
    """Arm the module-wide accounting session: every program's first
    run in any `trace.JitCache` is costed into the returned CostBook,
    and the engines' per-step MFU gauges start recording. One session at
    a time."""
    global _BOOK
    with _LOCK:
        if _BOOK is not None:
            raise RuntimeError("a cost-accounting session is already "
                               "armed; end_accounting() it first")
        _BOOK = book if book is not None else CostBook(spec=spec)
        _trace.add_compile_hook(_on_compile)
        return _BOOK


def end_accounting():
    """Disarm; returns the CostBook (or None if nothing was armed)."""
    global _BOOK
    with _LOCK:
        bk = _BOOK
        _BOOK = None
        _trace.remove_compile_hook(_on_compile)
        return bk


@contextlib.contextmanager
def accounting_scope(spec=None):
    bk = start_accounting(spec=spec)
    try:
        yield bk
    finally:
        end_accounting()


def temp_high_water():
    """First-run temp high-water of the armed book (0 when disarmed)."""
    bk = _BOOK
    return 0 if bk is None else bk.temp_high_water()


def reset():
    """Disarm unconditionally (test teardown symmetry)."""
    global _BOOK
    with _LOCK:
        _BOOK = None
        _trace.remove_compile_hook(_on_compile)
