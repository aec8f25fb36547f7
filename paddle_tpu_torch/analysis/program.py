"""Program analyzer: the program half of the static checker, over the aten
ops one run of a program dispatches (the JAX package's
`analysis/program.py` lints the closed jaxprs instead).

A port program is eager PyTorch: the body a serving engine caches under a
program key (`ServingEngine._program`). `analyze_program` runs it once
under a recording `TorchDispatchMode` (which sees every aten op on the
CPU and on the card) and lints what it dispatched:

  PTA102  a large pool carry the program REPLACES instead of updating in
          place: a state leaf whose storage changes across the run (the
          port's counterpart of an un-donated carry: a copy of the pool
          every dispatch), audited against the engine's declared in-place
          set (`ServingEngine._inplace_state`: every leaf of the pool)
  PTA103  float widening beyond the engine's dtype (an op whose float
          output is wider than its narrowest float input and than the
          engine's dtype), and any float64
  PTA104  host transfers inside the program: `aten.item` /
          `aten._local_scalar_dense` and copies from the card to the CPU

PTA101 (baked-in constants) has no eager counterpart: a program's
constants are Python values read at each call, never folded into a
compiled artifact. PTA105 (sharded carries) waits for the port's
multi-card serving.

`analyze_engine` runs every program `precompile()` would ready, each on
a scratch pool (the engine's own pool, its counters and `trace_counts`
stay as they were: the same discipline as precompile).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..profiler import trace as _trace
from .findings import Finding

__all__ = ["analyze_program", "analyze_engine", "analyze_fused_optimizer",
           "engine_programs", "OpRecorder", "HOST_OPS"]

#: ops that read a device value on the host (a sync)
HOST_OPS = frozenset({"aten.item", "aten._local_scalar_dense"})

_FLOATS = (torch.bfloat16, torch.float16, torch.float32, torch.float64)
_WIDTH = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4,
          torch.float64: 8}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class OpRecorder(TorchDispatchMode):
    """Records (op, input float dtypes, output float dtypes, input
    devices, output devices) of every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = list(_tensors((args, kwargs or {})))
        outs = list(_tensors(out))
        self.ops.append((str(func.overloadpacket),
                         [t.dtype for t in ins],
                         [t.dtype for t in outs],
                         {t.device.type for t in ins},
                         {t.device.type for t in outs}))
        return out


def _kind_of(key):
    return key[0] if isinstance(key, tuple) and key else str(key)


def _leaves(x, path=""):
    """{path: tensor} of every tensor in a nested pool state (dicts,
    lists, tuples, cache objects with tensor attributes)."""
    out = {}
    if isinstance(x, torch.Tensor):
        out[path] = x
    elif isinstance(x, dict):
        for k, v in x.items():
            out.update(_leaves(v, f"{path}.{k}" if path else str(k)))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            out.update(_leaves(v, f"{path}[{i}]"))
    elif hasattr(x, "__dict__") or hasattr(x, "_fields"):
        fields = getattr(x, "_fields", None) or \
            [k for k in vars(x) if not k.startswith("_")]
        for k in fields:
            out.update(_leaves(getattr(x, k), f"{path}.{k}"))
    return out


def _nbytes(t):
    return t.numel() * t.element_size()


def analyze_program(key, fn, args=(), *, owner="program", dtype=None,
                    state=None, declared_inplace=None, large_bytes=1 << 20):
    """Run ONE program `fn(*args)` and lint the aten ops it dispatched.
    `state` (a nested dict / list of tensors, the pool the program
    carries) is audited for PTA102: every large leaf named in
    `declared_inplace` (all of its leaves when None) must keep its
    storage. `dtype` is the engine's compute dtype (float32 when None).
    Returns findings."""
    kind = _kind_of(key)
    where = f"{owner}:{key!r}"
    dtype = dtype or torch.float32
    before = {p: (t.data_ptr(), t) for p, t in _leaves(state).items()}
    rec = OpRecorder()
    with rec:
        fn(*args)
    findings = []

    # ---- PTA102: large carries replaced instead of written in place ----
    after = _leaves(state)
    declared = set(before) if declared_inplace is None \
        else set(declared_inplace)
    replaced = []
    for path, (ptr, t0) in sorted(before.items()):
        if path not in declared or _nbytes(t0) < large_bytes:
            continue
        t1 = after.get(path)
        if t1 is None or t1.data_ptr() != ptr:
            replaced.append(path)
    if replaced:
        findings.append(Finding(
            "PTA102", where,
            f"{len(replaced)} large carry leaf(s) replaced instead of "
            f"updated in place (e.g. {replaced[0]}): the program writes a "
            f"new pool every dispatch",
            baseline_key=f"{owner}:{kind}:state"))

    # ---- PTA103 / PTA104: the op sweep ----
    seen = set()
    f64 = False
    for op, din, dout, devin, devout in rec.ops:
        if op in HOST_OPS or ("cuda" in devin and "cpu" in devout):
            bk = f"{owner}:{kind}:{op}"
            if bk not in seen:
                seen.add(bk)
                findings.append(Finding(
                    "PTA104", where,
                    f"host transfer `{op}` inside the program — a device "
                    f"sync on every dispatch",
                    baseline_key=bk))
        fin = [d for d in din if d in _FLOATS]
        for d in dout:
            if d == torch.float64 and not f64:
                f64 = True
                findings.append(Finding(
                    "PTA103", where,
                    "float64 value inside the program (an x64 upcast: 2x "
                    "memory and off the tensor cores)",
                    baseline_key=f"{owner}:{kind}:f64"))
            if d not in _FLOATS or not fin:
                continue
            src = min(fin, key=lambda x: _WIDTH[x])
            if _WIDTH[d] > _WIDTH[src] and _WIDTH[d] > _WIDTH[dtype] and \
                    d != torch.float64:
                s_name = str(src).replace("torch.", "")
                d_name = str(d).replace("torch.", "")
                bk = f"{owner}:{kind}:promote:{s_name}->{d_name}"
                if bk not in seen:
                    seen.add(bk)
                    findings.append(Finding(
                        "PTA103", where,
                        f"float widening {s_name} -> {d_name} inside the "
                        f"program (`{op}`) — check for a mixed-precision "
                        f"promotion surprise",
                        baseline_key=bk))
    return findings


def engine_programs(engine, memory=(4, 32), *, dtype="float32",
                    prompt_buckets=(8,)):
    """The `(key, body, example_args)` enumeration `precompile()`
    readies, with the pool pinned exactly the way precompile pins it
    (a memory shape tuple or an example tensor): nothing runs."""
    if torch.is_tensor(memory):
        mem = memory.to(engine.device)
    else:
        M, Dm = memory
        mem = torch.zeros((int(M), int(Dm)), dtype=getattr(torch, dtype),
                          device=engine.device)
    engine._ensure_state(mem)
    engine._precompile_mem = mem
    return engine._startup_programs(prompt_buckets)


def analyze_engine(engine, memory=(4, 32), *, dtype="float32",
                   prompt_buckets=(8,), large_bytes=4096):
    """`analyze_program` over every program of one engine's pool config,
    each run once on a scratch pool. `large_bytes` defaults low enough
    that the tiny check stacks' pools count as large (production pools
    are GBs). The engine's `trace_counts` and its pool stay as they
    were."""
    owner = type(engine).__name__
    findings = []
    for key, body, args in engine_programs(
            engine, memory, dtype=dtype, prompt_buckets=prompt_buckets):
        saved = engine._scratch_swap()
        try:
            with _trace.suppress_observation():
                findings.extend(engine.placement.run(
                    lambda: analyze_program(
                        key, body, args, owner=owner, dtype=engine._dtype,
                        state=engine._state,
                        declared_inplace=engine._inplace_state(),
                        large_bytes=large_bytes)))
        finally:
            engine._scratch_restore(saved)
    return findings


def analyze_fused_optimizer(large_bytes=4096, n=64, device=None):
    """Lint the multi-tensor optimizer step (optimizer/fused.py): one Adam
    step over a small dense bag on `device` (None: the card), audited
    like a serving program. The parameters and the moment slots are the
    carries: each must be updated in place."""
    from .. import optimizer as opt_mod
    from ..core.device import resolve_device
    from ..optimizer import fused

    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(n, n, generator=g).to(dev))
              for _ in range(2)]
    opt = opt_mod.Adam(0.01, parameters=params)
    for p in params:
        p.grad = torch.randn(n, n, generator=g).to(dev)
    opt.step()           # the slots exist after the first step
    dense = [(p, p.grad) for p in params]
    state = {"params": params,
             "slots": [dict(v) for v in opt._accumulators.values()]
             if isinstance(opt._accumulators, dict) else []}
    with torch.no_grad():
        return analyze_program(
            ("fused_opt", "adam", n), fused.apply, (opt, dense),
            owner="FusedOptimizerStep", state=state,
            large_bytes=large_bytes)
