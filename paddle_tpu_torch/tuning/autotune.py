"""Plan sweep for the port's Hopper kernels, and its CLI.

The JAX package's sweep (`tuning/autotune.py`) searched Pallas block
shapes; the port's kernels keep their tiles and plan their launches with
C rules (the key-split cluster of `csrc/attn_merge.cuh`, the tiled plan of
`paged_verify.cu`, the skinny int8 k-split, the LoRA cluster). For each
(kernel, key) the sweep:

  1. enumerates the legal candidate overrides (`candidates()`: the same
     checks the C entry points make, so no candidate is refused there);
  2. prunes candidates whose ANALYTIC roofline lower bound
     (`analytic_cost()` bytes and flops against the `DeviceSpec` of
     `profiler.costs`, the H100's on the card) already exceeds the rule's
     measured time;
  3. times the rule and each survivor in `repeats` pairs, rule then
     candidate, with CUDA events after a warm-up (`default_measurer`);
  4. stops early once the incumbent sits within `stop_factor` of the
     key's roofline;
  5. names a winner only where its median beats the rule's by more than
     the largest spread of its pairs (the spread of rule minus candidate
     over the pairs): a candidate the noise could explain leaves the rule.

`fallback_config()` is the rule written out (the Python mirrors of the C
plans at the key's shape on an H100). Unlike the JAX package, whose
committed "any" tier holds the hand-picked block constants, the port's
committed "any" tier holds NO plan entries: the Hopper rules read the SM
count and the exact row count, which no bucketed key fixes, so a miss
runs the C rule itself and `fallback_config` only reports it.

    python -m paddle_tpu_torch.tuning.autotune --sweep all --dry-run
    python -m paddle_tpu_torch.tuning.autotune --sweep all --merge
    python -m paddle_tpu_torch.tuning.autotune --show

`--merge` folds the winners into the committed table
(`tuning/tables/default.json`) under this card's tier; `--out PATH`
writes them to a file instead; `--init` resets the committed "any" tier
to empty. Run a sweep alone on the card.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import table as _table

__all__ = ["candidates", "fallback_config", "fallback_entries",
           "analytic_cost", "roofline_seconds", "prune", "sweep_key",
           "build_runner", "default_measurer", "apply_report",
           "DEFAULT_KEYS", "table_key", "main"]

#: the merge kernels' cluster ladder (portable clusters)
SPLIT_LADDER = (1, 2, 3, 4, 5, 6, 7, 8)
#: the LoRA cluster ladder (the rule's powers of two)
CLUSTER_LADDER = (1, 2, 4, 8)
#: the tiled route's tiles a split
TILES_LADDER = (1, 2, 3, 4, 5, 6, 7, 8)
#: heads of the keys' rows (Transformer-base)
HEADS = 8


# ----------------------------------------------------------------------
# keys, candidates, fallbacks
# ----------------------------------------------------------------------

def _dims_of(kernel, key):
    """Parse a key tuple into named dims. Key layouts (the consult sites'
    `ops.attention.decode_key` / `paged_key`, `ops.quant.int8_key` /
    `lora_key`; the table stores them bucketed, a sweep may pass exact
    sizes):

        flash_decode        (d, rows, L, dtype)
        flash_verify        (d, rows, L, dtype, T)
        paged_flash_decode  (d, rows, psz, mp, dtype)
        paged_flash_verify  (d, rows, psz, mp, dtype, T)
        int8_matmul         (d, n, dtype, m)
        lora_matmul         (d, r, dtype, b, s)
    """
    if isinstance(key, str):
        key = tuple(int(p) if p.isdigit() else p for p in key.split("/"))
    if kernel == "flash_decode":
        d, rows, L, dt = key
        return {"d": int(d), "rows": int(rows), "L": int(L),
                "dtype": str(dt), "T": 1}
    if kernel == "flash_verify":
        d, rows, L, dt, T = key
        return {"d": int(d), "rows": int(rows), "L": int(L),
                "dtype": str(dt), "T": int(T)}
    if kernel == "paged_flash_decode":
        d, rows, psz, mp, dt = key
        return {"d": int(d), "rows": int(rows), "psz": int(psz),
                "mp": int(mp), "dtype": str(dt), "T": 1}
    if kernel == "paged_flash_verify":
        d, rows, psz, mp, dt, T = key
        return {"d": int(d), "rows": int(rows), "psz": int(psz),
                "mp": int(mp), "dtype": str(dt), "T": int(T)}
    if kernel == "int8_matmul":
        d, n, dt, m = key
        return {"d": int(d), "n": int(n), "dtype": str(dt), "m": int(m)}
    if kernel == "lora_matmul":
        d, r, dt, b, s = key
        return {"d": int(d), "r": int(r), "dtype": str(dt), "b": int(b),
                "s": int(s)}
    raise ValueError(f"unknown kernel {kernel!r}")


def table_key(kernel, key):
    """The bucketed key the consult sites look up for a key of exact
    sizes (idempotent on a bucketed key)."""
    from ..ops import attention as A
    from ..ops import quant as Q

    x = _dims_of(kernel, key)
    if kernel in ("flash_decode", "flash_verify"):
        return A.decode_key(kernel, x["d"], x["rows"], x["L"], x["dtype"],
                            x["T"])
    if kernel in ("paged_flash_decode", "paged_flash_verify"):
        return A.paged_key(kernel, x["d"], x["rows"], x["psz"], x["mp"],
                           x["dtype"], x["T"])
    if kernel == "int8_matmul":
        return Q.int8_key(x["m"], x["d"], x["n"], x["dtype"])
    return Q.lora_key(x["b"], x["s"], x["d"], x["r"], x["dtype"])


def _units(kernel, x):
    """The work units a plan override may not exceed, and the route."""
    from ..ops import attention as A

    if kernel in ("flash_decode", "flash_verify"):
        return -(-x["L"] // A._DECODE_UNIT), "split"
    if kernel == "paged_flash_decode":
        return x["mp"], "split"
    if kernel == "paged_flash_verify":
        if x["T"] <= A.PAGED_SPLIT_MAX_T:
            return x["mp"], "split"
        return max(1, -(-x["mp"] * x["psz"] // A._PAGED_TILE)), "tiled"
    if kernel == "int8_matmul":
        return max(1, -(-x["d"] // 64)), "skinny"
    return None, "lora"


def candidates(kernel, key, gather=False):
    """Legal plan overrides for (kernel, key): the C entry points' own
    checks applied up front, so the sweep never times a refused one.
    `gather=True` adds the `kernel: False` routes the JAX package swept
    (the paged gather route, the LoRA einsum); a card's sweep leaves them
    out."""
    x = _dims_of(kernel, key)
    if kernel in ("flash_fwd", "flash_bwd"):
        return []
    units, route = _units(kernel, x)
    if kernel == "lora_matmul":
        from ..ops import quant as Q

        out = [{"cluster": c} for c in CLUSTER_LADDER
               if Q._legal_lora_cluster(c, x["d"], x["d"])]
        return out + ([{"kernel": False}] if gather else [])
    if kernel == "int8_matmul" and x["m"] > 32:
        return []                       # the tiled route has no override
    if route == "tiled":
        from ..ops import attention as A

        out = [{"tiles_per_split": t} for t in TILES_LADDER
               if A._legal_tiles(t, units)]
    else:
        out = [{"split_k": s} for s in SPLIT_LADDER if s <= units]
    if gather and kernel in ("paged_flash_decode", "paged_flash_verify"):
        out.append({"kernel": False})
    return out


def fallback_config(kernel, key, sms=None):
    """The plan the C rule gives (kernel, key) on a card of `sms` SMs (an
    H100's by default), as a config of the kernel's knobs: what a miss,
    or PT_TUNING=0, launches. Written out by the kernels' own Python
    mirrors, so the two cannot drift."""
    from ..ops import _build
    from ..ops import attention as A
    from ..ops import quant as Q

    sms = sms or _build.H100_SMS
    x = _dims_of(kernel, key)
    if kernel in ("flash_decode", "flash_verify"):
        h = HEADS if x["rows"] % HEADS == 0 else 1
        return {"split_k": A.flash_decode_plan(x["rows"] // h, h, x["L"],
                                               sms)[0]}
    if kernel == "paged_flash_decode":
        return {"split_k": A.paged_decode_plan(x["rows"], 1, x["mp"],
                                               sms)[0]}
    if kernel == "paged_flash_verify":
        if _units(kernel, x)[1] == "split":
            return {"split_k": A.paged_decode_plan(x["rows"], 1, x["mp"],
                                                   sms)[0]}
        h = HEADS if x["rows"] % HEADS == 0 else 1
        _, _, keys = A.paged_tiled_plan(x["rows"] // h, h, x["T"],
                                        x["mp"] * x["psz"], sms)
        return {"tiles_per_split": keys // A._PAGED_TILE}
    if kernel == "int8_matmul":
        if x["m"] > 32:
            return {"split_k": 0}
        return {"split_k": Q.skinny_plan(x["m"], x["d"], x["n"], sms)[1]}
    if kernel == "lora_matmul":
        return {"cluster": Q.lora_plan(x["b"], x["s"], x["d"], x["d"],
                                       sms)[1]}
    raise ValueError(f"{kernel!r} has no plan override in the port")


#: the keys the card's sweep covers: every tunable kernel at the shapes
#: its Transformer-base serving phase runs (exact sizes; the table stores
#: them bucketed): decode b8 h8 L1056, spec verify T4 (L1060), paged S8 h8
#: page 16 mp67, the tiled tail prefill S1 h8 T256 over 48 pages, int8 m8
#: and m32 at 512x2048, 2048x512 and 512x37000, LoRA rank 8 b8 s1 / s4
DEFAULT_KEYS = {
    "flash_decode": [(64, 64, 1056, "float32")],
    "flash_verify": [(64, 64, 1060, "float32", 4)],
    "paged_flash_decode": [(64, 64, 16, 67, "float32")],
    "paged_flash_verify": [(64, 64, 16, 67, "float32", 4),
                           (64, 8, 16, 48, "float32", 256)],
    "int8_matmul": [(d, n, "float32", m) for m in (8, 32)
                    for d, n in ((512, 2048), (2048, 512), (512, 37000))],
    "lora_matmul": [(512, 8, "float32", 8, s) for s in (1, 4)],
}


def fallback_entries():
    """[(kernel, key, config)]: the rule at every DEFAULT_KEYS key, with
    source='fallback'. The port does not commit these (its "any" tier is
    empty: the C rule is the fallback); they report what a miss runs."""
    out = []
    for kernel, keys in DEFAULT_KEYS.items():
        for key in keys:
            cfg = dict(fallback_config(kernel, key))
            cfg["source"] = "fallback"
            out.append((kernel, key, cfg))
    return out


# ----------------------------------------------------------------------
# analytic roofline (the prune, the stop condition, the printed bound)
# ----------------------------------------------------------------------

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def analytic_cost(kernel, key, config=None, heads=None):
    """{flops, bytes} LOWER BOUND of one launch at (kernel, key) under
    `config`: each input read once, each output written once, and the
    products it must do. A plan override changes only the merge (in
    shared memory and registers), so the bound is the same for every
    candidate of a key."""
    x = _dims_of(kernel, key)
    if kernel in ("flash_decode", "flash_verify", "paged_flash_decode",
                  "paged_flash_verify"):
        d, rows, T = x["d"], x["rows"], x["T"]
        L = x["L"] if "L" in x else x["mp"] * x["psz"]
        eb = _BYTES.get(x["dtype"], 4)
        qb = 4 if eb == 1 else eb
        byt = rows * (2.0 * L * d * eb + 2.0 * T * d * qb)
        if eb == 1:
            byt += 2.0 * rows * x["mp"] * 4        # the page scales
        return {"flops": rows * 4.0 * T * L * d, "bytes": byt}
    if kernel == "int8_matmul":
        m, d, n = x["m"], x["d"], x["n"]
        return {"flops": 2.0 * m * d * n,
                "bytes": d * n * 1.0 + n * 4.0 + m * (d + n) * 4.0}
    if kernel == "lora_matmul":
        b, s, d, r = x["b"], x["s"], x["d"], x["r"]
        n = d
        return {"flops": 2.0 * b * s * (d * r + r * n),
                "bytes": 4.0 * (b * (d * r + r * n) + b * s * (d + n))}
    raise ValueError(f"unknown kernel {kernel!r}")


def roofline_seconds(cost, spec):
    """The device's floor for a {flops, bytes} cost: compute-bound or
    bandwidth-bound, whichever binds."""
    return max(cost["flops"] / spec.peak_flops,
               cost["bytes"] / spec.peak_bytes_per_s)


def prune(kernel, key, cands, incumbent_s, spec, heads=None):
    """Split candidates into (survivors, pruned): a candidate whose
    roofline floor already exceeds the incumbent's MEASURED time can
    never win and is never timed."""
    if incumbent_s is None:
        return list(cands), []
    keep, cut = [], []
    for c in cands:
        floor = roofline_seconds(analytic_cost(kernel, key, c, heads), spec)
        (cut if floor > incumbent_s else keep).append(c)
    return keep, cut


# ----------------------------------------------------------------------
# measurement
# ----------------------------------------------------------------------

def build_runner(kernel, key, config, device=None, seed=0):
    """Zero-arg closure that runs ONE launch of (kernel, key) under
    `config` (an override of 0 is the rule) over fixed random operands of
    the key's sizes, through the kernel's wrapper on a CUDA `device` (the
    card by default), or its plain version on the CPU (where every config
    computes the same)."""
    import torch

    from ..core.device import resolve_device
    from ..ops import attention as A
    from ..ops import quant as Q

    dev = resolve_device(device)
    x = _dims_of(kernel, key)
    g = torch.Generator(device=dev).manual_seed(seed)
    cuda = dev.type == "cuda"

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale) \
            .to(dtype)

    if kernel in ("flash_decode", "flash_verify"):
        h = HEADS if x["rows"] % HEADS == 0 else 1
        b, d, L, T = x["rows"] // h, x["d"], x["L"], x["T"]
        dt = getattr(torch, x["dtype"])
        q = rnd(b, h, T, d, dtype=dt)
        k, v = rnd(b, h, L, d, dtype=dt), rnd(b, h, L, d, dtype=dt)
        length = torch.full((b,), L, dtype=torch.int32, device=dev)
        split = int(config.get("split_k", 0))
        if kernel == "flash_decode":
            if cuda:
                return lambda: A._flash_decode_cuda(q, k, v, length, None,
                                                    None, split)
            return lambda: A.flash_decode(q, k, v, length)
        if cuda:
            return lambda: A._flash_verify_cuda(q, k, v, length, None, None,
                                                split)
        return lambda: A.flash_verify(q, k, v, length)
    if kernel in ("paged_flash_decode", "paged_flash_verify"):
        h = HEADS if x["rows"] % HEADS == 0 else 1
        S, d, psz, mp, T = x["rows"] // h, x["d"], x["psz"], x["mp"], x["T"]
        n_pages = S * mp
        kv = getattr(torch, x["dtype"])
        kp = rnd(n_pages + 1, h, psz, d, dtype=torch.float32)
        vp = rnd(n_pages + 1, h, psz, d, dtype=torch.float32)
        ks = vs = None
        if kv == torch.int8:
            ks = torch.full((n_pages + 1, h, 1, 1), 0.02, device=dev)
            vs = ks.clone()
            kp = (kp * 40).clamp(-127, 127).to(torch.int8)
            vp = (vp * 40).clamp(-127, 127).to(torch.int8)
        else:
            kp, vp = kp.to(kv), vp.to(kv)
        perm = torch.randperm(n_pages, generator=torch.Generator()
                              .manual_seed(seed))
        table = perm.reshape(S, mp).to(torch.int32).to(dev)
        q = rnd(S, h, T, d)
        length = torch.full((S,), mp * psz, dtype=torch.int32, device=dev)
        if config.get("kernel", True) is False or not cuda:
            disp = (A.paged_decode_attention if T == 1
                    else A.paged_verify_attention)
            return lambda: disp(q, kp, vp, ks, vs, table, length)
        if kernel == "paged_flash_decode":
            split = int(config.get("split_k", 0))
            return lambda: A._paged_decode_cuda(q, kp, vp, ks, vs, table,
                                                length, None, None, split)
        split = int(config.get("split_k", 0))
        tps = int(config.get("tiles_per_split", 0))
        return lambda: A._paged_verify_cuda(q, kp, vp, ks, vs, table,
                                            length, None, None, split, tps)
    if kernel == "int8_matmul":
        m, d, n = x["m"], x["d"], x["n"]
        xin = rnd(m, d)
        wq, ws = Q.quantize_int8_weight(rnd(d, n, scale=0.05))
        split = int(config.get("split_k", 0))
        if cuda:
            return lambda: Q._int8_matmul_cuda(xin, wq, ws, split)
        return lambda: Q.int8_matmul(xin, wq, ws)
    if kernel == "lora_matmul":
        b, s, d, r = x["b"], x["s"], x["d"], x["r"]
        cap = 5
        xin = rnd(b, s, d)
        Ab, Bb = rnd(cap, d, r, scale=0.05), rnd(cap, r, d, scale=0.05)
        ids = [i % cap for i in range(b)]
        if config.get("kernel", True) is False or not cuda:
            return lambda: Q.lora_delta_reference(xin, Ab, Bb, ids)
        dev_ids = torch.tensor(ids, dtype=torch.int32, device=dev)
        cluster = int(config.get("cluster", 0))
        return lambda: Q._lora_gather_cuda(xin, Ab, Bb, dev_ids, cluster)
    raise ValueError(f"unknown kernel {kernel!r}")


def default_measurer(steps=20, warmup=3, device=None):
    """measurer(kernel, key, config) -> seconds a launch: on the card,
    `steps` launches between two CUDA events, queued behind a device
    sleep so that the host's launch overhead is not timed, after
    `warmup` launches; on the CPU, the same launches on the host clock."""
    import time

    import torch

    from ..core.device import resolve_device

    dev = resolve_device(device)
    cache = {}

    def measurer(kernel, key, config):
        ck = (kernel, _table.key_str(key), json.dumps(config, sort_keys=True))
        fn = cache.get(ck)
        if fn is None:
            fn = cache[ck] = build_runner(kernel, key, config, dev)
        for _ in range(warmup):
            fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            return (time.perf_counter() - t0) / steps
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / 1e3 / steps

    return measurer


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def sweep_key(kernel, key, *, measurer, spec=None, heads=None,
              stop_factor=1.1, repeats=5, gather=False, log=None):
    """Sweep ONE (kernel, key). Returns a report dict

        {kernel, key, winner, step_us, fallback, fallback_us, bound_us,
         timed, pruned, stopped_at_roofline, candidates}

    `key` may hold exact sizes (the report's key is the bucketed table
    key). The rule (`fallback_config`) is timed first, then each
    surviving candidate in `repeats` pairs (rule, candidate). A
    candidate wins only where its median beats the rule's median by more
    than the largest spread of its pairs; `candidates` lists every timed
    one (median, rule median, spread) for the record."""
    from ..profiler import costs as _costs

    spec = spec if spec is not None else \
        _costs.detect_spec(default=_costs.H100_SXM_SPEC)
    fb = fallback_config(kernel, key)
    bound = roofline_seconds(analytic_cost(kernel, key, fb, heads), spec)
    t_fb = measurer(kernel, key, fb)
    best, t_best = dict(fb), t_fb
    cands = [c for c in candidates(kernel, key, gather=gather) if c != fb]
    keep, cut = prune(kernel, key, cands, t_fb, spec, heads)
    timed, rows, stopped = 1, [], False
    for c in keep:
        if t_best <= stop_factor * bound:
            stopped = True     # the incumbent already sits at the roofline
            break
        pairs = [(measurer(kernel, key, fb), measurer(kernel, key, c))
                 for _ in range(repeats)]
        timed += 1
        rule_med = _median([p[0] for p in pairs])
        med = _median([p[1] for p in pairs])
        diffs = [p[0] - p[1] for p in pairs]
        spread = max(diffs) - min(diffs)
        rows.append({"config": dict(c), "us": med * 1e6,
                     "rule_us": rule_med * 1e6, "spread_us": spread * 1e6,
                     "beats_rule": rule_med - med > spread})
        if log is not None:
            log(f"  {kernel} {_table.key_str(key)} {c}: {med * 1e6:.2f} us, "
                f"rule {rule_med * 1e6:.2f} us, spread {spread * 1e6:.2f} "
                f"us, bound {bound * 1e6:.2f} us")
        if rule_med - med > spread and med < t_best:
            best, t_best = dict(c), med
    return {"kernel": kernel, "key": _table.key_str(table_key(kernel, key)),
            "winner": best, "step_us": round(t_best * 1e6, 3),
            "fallback": fb, "fallback_us": round(t_fb * 1e6, 3),
            "bound_us": round(bound * 1e6, 3), "timed": timed,
            "pruned": len(cut), "stopped_at_roofline": stopped,
            "candidates": rows}


def apply_report(tbl, report, device_kind=None):
    """Install a sweep_key report's winner into `tbl` (device-keyed,
    source='sweep', its measured step_us beside it). A report whose
    winner is the rule installs nothing: the rule stays."""
    if report["winner"] == report["fallback"]:
        return tbl
    cfg = dict(report["winner"])
    cfg["source"] = "sweep"
    cfg["step_us"] = report["step_us"]
    cfg["rule_us"] = report["fallback_us"]
    tbl.put(report["kernel"], report["key"], cfg,
            device_kind=device_kind or _table.current_device_kind())
    return tbl


# ----------------------------------------------------------------------
# the CLI (the JAX package's tools/autotune.py)
# ----------------------------------------------------------------------

#: --smoke: one key of each sweep-worthy kernel family
SMOKE_KEYS = {
    "flash_decode": [(64, 64, 1056, "float32")],
    "int8_matmul": [(512, 2048, "float32", 8)],
    "lora_matmul": [(512, 8, "float32", 8, 1)],
}


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tuning.autotune",
        description="Sweep the Hopper kernels' plan overrides and persist "
                    "the winners.")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated kernels (or 'all'): "
                         + ",".join(DEFAULT_KEYS))
    ap.add_argument("--smoke", action="store_true",
                    help="one key per kernel family, short measurements")
    ap.add_argument("--dry-run", action="store_true",
                    help="print winners, write nothing")
    ap.add_argument("--merge", action="store_true",
                    help="fold winners into the committed default table "
                         "(this card's tier) instead of --out")
    ap.add_argument("--out", default=None,
                    help="write the swept table here (default: print)")
    ap.add_argument("--init", action="store_true",
                    help="reset the committed 'any' tier to empty (the C "
                         "rules are the fallback)")
    ap.add_argument("--show", action="store_true",
                    help="render the active table and exit")
    ap.add_argument("--steps", type=int, default=20,
                    help="launches a measurement")
    ap.add_argument("--k", type=int, default=5,
                    help="paired repeats a candidate")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (mechanics only: the plain "
                         "versions ignore the plan)")
    args = ap.parse_args(argv)

    if args.show:
        t = _table.get_table()
        rows = t.entries() if t is not None else []
        for dev, kern, key, cfg in rows:
            print(f"{dev:24s} {kern:20s} {key:28s} {json.dumps(cfg)}")
        print(f"# {len(rows)} entries (device tier: "
              f"{_table.current_device_kind()!r})")
        return 0
    if args.init:
        path = _table.committed_table_path()
        try:
            tbl = _table.TuningTable.load(path)
        except _table.TableError:
            tbl = _table.TuningTable()
        tbl.clear("any")
        tbl.save(path)
        _log(f"reset the 'any' tier of {path}")
        return 0
    if not args.sweep and not args.smoke:
        ap.error("one of --sweep/--smoke/--init/--show is required")
    if args.smoke:
        keysets = dict(SMOKE_KEYS)
        args.steps = min(args.steps, 10)
        args.k = min(args.k, 3)
    else:
        kernels = (list(DEFAULT_KEYS) if args.sweep == "all"
                   else args.sweep.split(","))
        keysets = {}
        for kern in kernels:
            if kern not in DEFAULT_KEYS:
                ap.error(f"unknown kernel {kern!r}")
            keysets[kern] = DEFAULT_KEYS[kern]
    measurer = default_measurer(steps=args.steps, device=args.device)
    device = _table.current_device_kind()
    swept = _table.TuningTable()
    reports = []
    for kernel, keys in keysets.items():
        for key in keys:
            _log(f"sweep {kernel} {_table.key_str(key)} "
                 f"({len(candidates(kernel, key))} candidates)")
            rep = sweep_key(kernel, key, measurer=measurer, repeats=args.k,
                            log=_log)
            reports.append(rep)
            apply_report(swept, rep, device_kind=device)
            _log(f"  winner {rep['winner']} {rep['step_us']} us (rule "
                 f"{rep['fallback']} {rep['fallback_us']} us, bound "
                 f"{rep['bound_us']} us)")
    print(json.dumps({"device_kind": device, "swept": len(reports),
                      "entries": len(swept), "reports": reports}, indent=1))
    if args.dry_run:
        _log("dry run: nothing written")
        return 0
    if args.merge:
        target = _table.committed_table_path()
        tbl = _table.TuningTable()
        try:
            tbl = _table.TuningTable.load(target)
        except _table.TableError:
            pass
        tbl.merge(swept).save(target)
        _log(f"merged {len(swept)} winners into {target}")
    elif args.out:
        swept.save(args.out)
        _log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
