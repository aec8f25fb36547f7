"""Orchestration: the whole-analyzer run the CLI gate and the tests share
(the JAX package's `analysis/runner.py`, over the port).

Two halves with different costs:

  * `static_findings(root)` — AST lints (PTA201 / PTA204 over the port's
    serving/, tuning/, profiler/ and optimizer/fused.py) + the repo rules
    (PTA202 snapshot/doc sync, PTA203 the fault-point registry against
    the injections in the port and in tests/test_torch_*.py). Pure
    source reads, sub-second.
  * `program_findings(device=)` — builds throwaway tiny engines on the
    card (device=None, through `core.device.resolve_device`) or on the
    CPU when asked (`device="cpu"`), at any width
    (`build_check_engines(device=, width=)`),
    runs every program `precompile()` would ready once on a scratch pool
    under the op recorder, plus the multi-tensor optimizer step, and
    applies the program rules. No sharded engine: the port serves on one
    card.

`run(device=)` combines them, filters against the committed baseline
(`paddle_tpu_torch/analysis/baseline.json`), and (for the fast mode)
caches program findings keyed on the device and a digest of every port
source: any edit under paddle_tpu_torch/ invalidates the cache. Like
every entry point, the program half runs on the card unless the caller
asks for the CPU; with no card it raises and lints nothing.
"""
from __future__ import annotations

import hashlib
import json
import os

from . import hoststate, repo_rules
from .findings import Baseline, Finding

__all__ = ["repo_root", "static_findings", "program_findings",
           "build_check_engines", "run", "BASELINE_PATH", "CACHE_NAME"]

#: the port's committed baseline (the root ANALYSIS_BASELINE.json is the
#: JAX package's)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")
CACHE_NAME = ".static_check_torch_cache.json"

#: tiny-stack program analysis treats buffers past this as "large" — low
#: on purpose so the check engines' pools qualify (production pools are
#: GBs; the invariant is the same)
CHECK_LARGE_BYTES = 4096


def repo_root():
    """The repository root (two levels above this package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _pkg_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------
# static half
# ----------------------------------------------------------------------

def _port_tests(root):
    tests = os.path.join(root, "tests")
    if not os.path.isdir(tests):
        return []
    return [os.path.join(tests, n) for n in sorted(os.listdir(tests))
            if n.startswith("test_torch_") and n.endswith(".py")]


def static_findings(root=None):
    root = root or repo_root()
    pkg = os.path.join(root, "paddle_tpu_torch")
    ast_paths = [os.path.join(pkg, d)
                 for d in ("serving", "tuning", "profiler")]
    ast_paths.append(os.path.join(pkg, "optimizer", "fused.py"))
    findings = hoststate.check_paths([p for p in ast_paths
                                      if os.path.exists(p)])
    findings += repo_rules.snapshot_doc_findings(
        os.path.join(pkg, "serving", "metrics.py"))
    findings += repo_rules.fault_point_findings(
        point_paths=[pkg], inject_paths=[pkg] + _port_tests(root))
    return findings


# ----------------------------------------------------------------------
# program half
# ----------------------------------------------------------------------

def _small_stack(seed=7, D=32, H=2, V=17, layers=2, ffn=64, device=None):
    import torch

    from .. import nn

    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    dec = nn.TransformerDecoder(nn.TransformerDecoderLayer(
        D, H, ffn, dropout=0.0, device=device, generator=g), layers)
    embed = nn.Embedding(V, D, device=device, generator=g)
    proj = nn.Linear(D, V, device=device, generator=g)
    for m in (dec, embed, proj):
        m.eval()
    return dec, embed, proj


def build_check_engines(device=None, width=None):
    """[(label, engine)] throwaway engines covering the program matrix:
    dense step, dense spec (draft + verify), paged (pjoin / attach / cow /
    pattach / pstep), paged spec (draft + pverify), multi-tenant (int8
    base weights and an adapter pool), radix with adapters, chunked dense
    and chunked paged. `width` = (D, heads, vocab, layers, ffn, slots,
    max_len, page) (default: the `_small_stack` tiny stack, 4 slots of 32
    positions); the card's phase runs Transformer-base. device=None is
    the card."""
    from ..core.device import resolve_device
    from ..serving import AdapterPool, ServingEngine

    device = resolve_device(device)
    D, H, V, layers, ffn, S, L, page = width or (32, 2, 17, 2, 64, 4, 32, 8)

    def stack(seed):
        return _small_stack(seed, D, H, V, layers, ffn, device)

    kw = dict(num_slots=S, max_len=L, device=device)
    out = [("dense", ServingEngine(*stack(7), **kw)),
           ("spec", ServingEngine(*stack(8), spec_k=4, **kw)),
           ("paged", ServingEngine(*stack(9), paged=True, page_size=page,
                                   **kw)),
           ("paged_spec", ServingEngine(*stack(12), paged=True,
                                        page_size=page, spec_k=4, **kw))]
    dec, emb, proj = stack(13)
    pool = AdapterPool(dec, capacity=3, rank=8)
    pool.register_random("t1", seed=1)
    out.append(("tenant", ServingEngine(dec, emb, proj, adapters=pool,
                                        quantize="int8", **kw)))
    dec, emb, proj = stack(14)
    pool = AdapterPool(dec, capacity=3, rank=8)
    pool.register_random("t1", seed=1)
    out.append(("radix", ServingEngine(dec, emb, proj, paged=True,
                                       page_size=page, adapters=pool, **kw)))
    out.append(("chunked", ServingEngine(*stack(15), prefill_chunk=4, **kw)))
    out.append(("chunked_paged", ServingEngine(
        *stack(16), paged=True, page_size=page // 2,
        prefill_chunk=page, **kw)))
    return out


def program_findings(large_bytes=CHECK_LARGE_BYTES, device=None,
                     width=None, memory=(4, 32), prompt_buckets=(8,)):
    from ..core.device import resolve_device
    from .program import analyze_engine, analyze_fused_optimizer

    device = resolve_device(device)
    findings = []
    mem = memory if width is None else (memory[0], width[0])
    for _label, eng in build_check_engines(device, width):
        findings.extend(analyze_engine(eng, mem,
                                       prompt_buckets=prompt_buckets,
                                       large_bytes=large_bytes))
    findings += analyze_fused_optimizer(large_bytes=large_bytes,
                                        device=device)
    return findings


# ----------------------------------------------------------------------
# the combined gate
# ----------------------------------------------------------------------

def _source_digest():
    """sha256 over every port source and torch's version: the fast
    cache's validity key (any paddle_tpu_torch edit invalidates it)."""
    import torch

    h = hashlib.sha256()
    h.update(torch.__version__.encode())
    pkg = _pkg_dir()
    for base, dirs, names in os.walk(pkg):
        if "__pycache__" in base or "_build" in base:
            continue
        dirs.sort()
        for n in sorted(names):
            if not n.endswith((".py", ".cu", ".cuh")):
                continue
            fp = os.path.join(base, n)
            h.update(fp.encode())
            with open(fp, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _cached_program_findings(root, fast, device):
    cache_path = os.path.join(root, CACHE_NAME)
    digest = f"{device}:{_source_digest()}"
    if fast and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                raw = json.load(f)
            if raw.get("digest") == digest:
                return [Finding(d["rule"], d["where"], d["message"],
                                d["baseline_key"])
                        for d in raw["findings"]], "hit"
        except (OSError, ValueError, KeyError):
            pass
    findings = program_findings(device=device)
    try:
        tmp = cache_path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"digest": digest,
                       "findings": [x.as_dict() for x in findings]}, f)
        os.replace(tmp, cache_path)
    except OSError:
        pass
    return findings, "miss"


def run(root=None, *, programs=True, fast=False, baseline_path=None,
        device=None):
    """The full gate; the program half on `device` (None: the card,
    raising without one; "cpu" when asked). Returns a report dict:

        {"findings", "new", "baselined", "stale_baseline", "cache", "ok"}

    `ok` is the gate verdict: no finding outside the baseline. Stale
    baseline entries are reported (delete them — the ratchet) but do
    not fail the gate on their own."""
    root = root or repo_root()
    cache = None
    if programs:
        from ..core.device import resolve_device

        # before any lint: no card and no explicit CPU is an error here,
        # never a quiet run on the host
        device = resolve_device(device)
    findings = static_findings(root)
    if programs:
        prog, cache = _cached_program_findings(root, fast, device)
        findings = findings + prog
    baseline_path = baseline_path or BASELINE_PATH
    baseline = Baseline.load(baseline_path) \
        if os.path.exists(baseline_path) else Baseline()
    new, baselined, stale = baseline.split(findings)
    return {"findings": findings, "new": new, "baselined": baselined,
            "stale_baseline": stale, "cache": cache, "ok": not new}
