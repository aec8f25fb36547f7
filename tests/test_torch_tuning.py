"""The port's tuning layer (`paddle_tpu_torch.tuning`) against the JAX
package's `tuning/`, on the CPU.

The table: a file either package saves loads in the other with the same
lookups across tiers and under PT_TUNING=0; `seq_bucket` and `key_str`
are the JAX ones. The plan mirrors: each Python mirror of a C plan rule
with its override equals the rule at 0, takes a legal override and reads
an illegal one as a miss. The consult sites: a table on or off gives the
plain path's bits (the plain versions have no plan), a tuned entry
reaches the launch's override only where it is legal, and a JAX entry of
TPU knobs reads as a miss. The sweep driver: deterministic injected
timings, the paired-spread rule, the roofline prune and stop. The AOT
cache and the cache-aware build, with fake library blobs from a stub
compiler (there is no nvcc here): the JAX cache contract (round trip,
miss, corrupt and healed, stale, both fault actions), a torn library
rebuilt, one rebuild on an OSError from ctypes.
"""
import json
import os
import zlib

import numpy as np
import pytest
import torch

from paddle_tpu.tuning import table as JT
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import quant as Q
from paddle_tpu_torch.profiler import costs
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.tuning import aot_cache as AC
from paddle_tpu_torch.tuning import autotune as AT
from paddle_tpu_torch.tuning import table as TBL


@pytest.fixture(autouse=True)
def _reset_tuning():
    yield
    TBL.reset()
    JT.reset()
    os.environ.pop("PT_TUNING", None)
    faults.reset()


# ----------------------------------------------------------------------
# the table
# ----------------------------------------------------------------------

def test_table_put_lookup_device_tiers_and_roundtrip(tmp_path):
    t = TBL.TuningTable()
    key = (64, 64, 2048, "float32")
    t.put("flash_decode", key, {"split_k": 7}, device_kind="any")
    t.put("flash_decode", key, {"split_k": 4},
          device_kind="NVIDIA H100 80GB HBM3")
    t.put("flash_decode", key, {"split_k": 5}, device_kind="NVIDIA H100")
    # exact tier, then the longest tier naming a prefix of the card, then
    # "any"; misses return None
    assert t.lookup("flash_decode", key,
                    "NVIDIA H100 80GB HBM3")["split_k"] == 4
    assert t.lookup("flash_decode", key,
                    "NVIDIA H100 PCIe")["split_k"] == 5
    assert t.lookup("flash_decode", key, "cpu")["split_k"] == 7
    assert t.lookup("flash_decode", (64, 64, 512, "float32"), "cpu") is None
    p = tmp_path / "t.json"
    t.save(str(p))
    t2 = TBL.TuningTable.load(str(p))
    assert t2.lookup("flash_decode", key, "NVIDIA H100 PCIe")["split_k"] == 5
    assert len(t2) == len(t) == 3
    bad = json.loads(p.read_text())
    bad["version"] = 999
    p.write_text(json.dumps(bad))
    with pytest.raises(TBL.TableError):
        TBL.TuningTable.load(str(p))
    p.write_text("{not json")
    with pytest.raises(TBL.TableError):
        TBL.TuningTable.load(str(p))
    with pytest.raises(TBL.TableError):
        t.put("flash_decode", key, {"bogus": 1})
    with pytest.raises(TBL.TableError):
        t.put("no_such_kernel", key, {"split_k": 1})


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
def test_fixed_tile_kernels_refuse_entries_and_say_why(kernel):
    assert kernel in TBL.KERNELS and kernel in JT.KERNELS
    with pytest.raises(TBL.TableError, match="fixed tiles"):
        TBL.TuningTable().put(kernel, (64, 512, 512, "float32"),
                              {"block_q": 128, "block_k": 128})


def test_jax_table_loads_in_the_port_and_the_reverse(tmp_path):
    """The JAX package's committed table (its "any" tier of hand-picked
    blocks) plus a device tier, saved by the JAX TuningTable, loads in
    the port's; a port table saved by the port loads in the JAX one; the
    same lookups give the same configs on every tier, and none under
    PT_TUNING=0 (module-level lookups of both packages)."""
    jt = JT.TuningTable.load(JT.committed_table_path())
    jt.put("flash_decode", (64, 2048, "float32"), {"split_k": 4},
           device_kind="TPU v5e")
    jt.put("int8_matmul", (256, 256, "float32"),
           {"block_m": 8, "block_n": 256}, device_kind="TPU v5e")
    p = tmp_path / "jax.json"
    jt.save(str(p))
    pt = TBL.TuningTable.load(str(p))
    for dev, kern, k, cfg in jt.entries():
        for tier in (dev, "cpu", "TPU v5e"):
            assert pt.lookup(kern, k, tier) == jt.lookup(kern, k, tier)
    assert len(pt) == len(jt)
    # the reverse: a port table with port knobs
    mine = TBL.TuningTable()
    mine.put("flash_decode", (64, 64, 2048, "float32"), {"split_k": 3},
             device_kind="NVIDIA H100 80GB HBM3")
    mine.put("paged_flash_verify", (64, 8, 16, 64, "float32", 256),
             {"tiles_per_split": 2, "source": "sweep"}, device_kind="any")
    q = tmp_path / "port.json"
    mine.save(str(q))
    back = JT.TuningTable.load(str(q))
    for dev, kern, k, cfg in mine.entries():
        for tier in (dev, "any", "cpu"):
            assert back.lookup(kern, k, tier) == mine.lookup(kern, k, tier)
    # the module-level switches: PT_TUNING_TABLE layers over the default,
    # PT_TUNING=0 reads nothing in both packages
    os.environ["PT_TUNING_TABLE"] = str(p)
    try:
        TBL.reset()
        JT.reset()
        key = (64, 2048, "float32")
        assert TBL.lookup("flash_decode", key, "TPU v5e") == \
            JT.lookup("flash_decode", key, "TPU v5e") == {"split_k": 4}
        os.environ["PT_TUNING"] = "0"
        assert TBL.lookup("flash_decode", key, "TPU v5e") is None
        assert JT.lookup("flash_decode", key, "TPU v5e") is None
        assert TBL.get_table() is None
    finally:
        os.environ.pop("PT_TUNING_TABLE")


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 64, 67, 1056, 1060, 37000])
def test_seq_bucket_and_key_str_agree_with_jax(n):
    assert TBL.seq_bucket(n) == JT.seq_bucket(n)
    key = (64, n, "float32", 4)
    assert TBL.key_str(key) == JT.key_str(key)
    assert TBL.key_str("64/8/float32") == JT.key_str("64/8/float32")


def test_committed_table_any_tier_holds_no_plan_entries():
    """The Hopper rules read the SM count and the exact row count, which
    no bucketed key fixes: the committed "any" tier is empty (a miss runs
    the C rule). Every card-tier entry names a legal override of its
    kernel, came from a sweep and beat the rule it replaces."""
    raw = json.load(open(TBL.committed_table_path()))
    assert raw["version"] == TBL.TABLE_VERSION == JT.TABLE_VERSION
    assert raw["devices"]["any"] == {}
    t = TBL.TuningTable.load(TBL.committed_table_path())
    for dev, kern, k, cfg in t.entries():
        assert dev != "any"
        assert cfg["source"] == "sweep" and cfg["step_us"] < cfg["rule_us"]
        assert cfg.get("kernel", True) is not False
        knobs = [n for n in TBL.KERNEL_KNOBS[kern] if n in cfg]
        assert knobs and cfg in [dict(c, source=cfg["source"],
                                      step_us=cfg["step_us"],
                                      rule_us=cfg["rule_us"])
                                 for c in AT.candidates(kern, k)], (kern, k)


# ----------------------------------------------------------------------
# the plan mirrors and their overrides
# ----------------------------------------------------------------------

_ILLEGAL = (-1, 0, 9, 2.0, "3", None, True)


@pytest.mark.parametrize("b,h,L", [(8, 8, 1056), (1, 8, 64), (64, 12, 512),
                                   (8, 8, 33)])
def test_dense_plan_override(b, h, L):
    rule = A.flash_decode_plan(b, h, L)
    units = -(-L // 32)
    assert A.flash_decode_plan(b, h, L, split_k=0) == rule
    for bad in _ILLEGAL + (units + 1,):
        assert A.flash_decode_plan(b, h, L, split_k=bad) == rule, bad
    for c in range(1, min(8, units) + 1):
        splits, keys = A.flash_decode_plan(b, h, L, split_k=c)
        assert splits <= c and splits * keys >= L and keys % 32 == 0
        assert keys == -(-units // c) * 32


@pytest.mark.parametrize("S,h,mp", [(8, 8, 67), (2, 8, 3), (64, 8, 128)])
def test_paged_plan_override(S, h, mp):
    rule = A.paged_decode_plan(S, h, mp)
    assert A.paged_decode_plan(S, h, mp, split_k=0) == rule
    for bad in _ILLEGAL + (mp + 1,):
        assert A.paged_decode_plan(S, h, mp, split_k=bad) == rule, bad
    for c in range(1, min(8, mp) + 1):
        splits, per = A.paged_decode_plan(S, h, mp, split_k=c)
        assert splits <= c and splits * per >= mp and per == -(-mp // c)


@pytest.mark.parametrize("S,h,T,L", [(1, 8, 256, 768), (8, 8, 256, 1072),
                                     (1, 8, 64, 576), (2, 8, 16, 96)])
def test_tiled_plan_override(S, h, T, L):
    rule = A.paged_tiled_plan(S, h, T, L)
    tiles = -(-L // 64)
    assert A.paged_tiled_plan(S, h, T, L, tiles_per_split=0) == rule
    for bad in (-1, 0, 2.0, "3", None, True, tiles + 1):
        assert A.paged_tiled_plan(S, h, T, L, tiles_per_split=bad) == rule
    for t in range(1, tiles + 1):
        rows, ns, keys = A.paged_tiled_plan(S, h, T, L, tiles_per_split=t)
        assert rows == rule[0] and keys == 64 * t and ns == -(-tiles // t)


@pytest.mark.parametrize("m,d,n", [(8, 512, 2048), (32, 2048, 512),
                                   (8, 512, 37000), (1, 100, 50)])
def test_skinny_plan_override(m, d, n):
    rule = Q.skinny_plan(m, d, n)
    chunks = -(-d // 64)
    assert Q.skinny_plan(m, d, n, split_k=0) == rule
    for bad in _ILLEGAL + (chunks + 1,):
        assert Q.skinny_plan(m, d, n, split_k=bad) == rule, bad
    for c in range(1, min(8, chunks) + 1):
        mt, cl, kps, warps = Q.skinny_plan(m, d, n, split_k=c)
        assert mt == rule[0] and cl <= c and cl * kps >= d


@pytest.mark.parametrize("b,s,d,n", [(8, 1, 512, 2048), (8, 4, 2048, 512),
                                     (1, 1024, 2048, 512), (2, 1, 8, 8)])
def test_lora_plan_override(b, s, d, n):
    rule = Q.lora_plan(b, s, d, n)
    assert Q.lora_plan(b, s, d, n, cluster=0) == rule
    for bad in _ILLEGAL + (16, -(-d // 4) + 1):
        assert Q.lora_plan(b, s, d, n, cluster=bad) == rule, bad
    for c in range(1, 9):
        want = (rule[0], c) if Q._legal_lora_cluster(c, d, n) else rule
        assert Q.lora_plan(b, s, d, n, cluster=c) == want


# ----------------------------------------------------------------------
# the consult sites
# ----------------------------------------------------------------------

def _table(*rows, tier=None):
    t = TBL.TuningTable()
    for kern, key, cfg in rows:
        t.put(kern, key, cfg, device_kind=tier or TBL.current_device_kind())
    return t


def test_consult_sites_read_legal_entries_and_miss_the_rest():
    q = torch.zeros(8, 8, 1, 64)
    kp = torch.zeros(8 * 67 + 1, 8, 16, 64)
    t = _table(
        ("flash_decode", A.decode_key("flash_decode", 64, 64, 1056,
                                      torch.float32), {"split_k": 5}),
        ("flash_verify", A.decode_key("flash_verify", 64, 64, 1060,
                                      torch.float32, 4), {"split_k": 99}),
        ("paged_flash_decode", A.paged_key("paged_flash_decode", 64, 64, 16,
                                           67, torch.float32),
         {"kernel": False, "split_k": 3}),
        ("paged_flash_verify", A.paged_key("paged_flash_verify", 64, 8, 16,
                                           48, torch.float32, 256),
         {"tiles_per_split": 2}),
        ("int8_matmul", Q.int8_key(8, 512, 2048, torch.float32),
         {"split_k": 6}),
        ("lora_matmul", Q.lora_key(8, 1, 512, 8, torch.float32),
         {"kernel": False, "cluster": 4}))
    TBL.set_table(t)
    assert A.decode_split("flash_decode", q, 1056) == 5
    # 99 is no cluster: the entry reads as a miss (the rule)
    assert A.decode_split("flash_verify", torch.zeros(8, 8, 4, 64),
                          1060) == 0
    assert A.paged_overrides("paged_flash_decode", q, kp, 67) == (False, 3,
                                                                   0)
    assert A.paged_overrides("paged_flash_verify",
                             torch.zeros(1, 8, 256, 64), kp, 48) == (True, 0,
                                                                      2)
    assert Q.int8_split(8, 512, 2048) == 6
    assert Q.int8_split(8, 64, 2048) == 0      # another key: a miss
    assert Q.lora_overrides(8, 1, 512, 8, 2048) == (False, 4)
    # PT_TUNING=0: every consult site runs its rule
    os.environ["PT_TUNING"] = "0"
    assert A.decode_split("flash_decode", q, 1056) == 0
    assert A.paged_overrides("paged_flash_decode", q, kp, 67) == (True, 0, 0)
    assert Q.int8_split(8, 512, 2048) == 0
    assert Q.lora_overrides(8, 1, 512, 8, 2048) == (True, 0)


def test_jax_entries_of_tpu_knobs_read_as_misses(tmp_path):
    """A JAX table entry of TPU knobs (block_m / block_n, a split_k of a
    JAX key layout) loads, and reads as a miss at the port's consult
    sites, whose keys carry the plan's row count."""
    jt = JT.TuningTable()
    jt.put("int8_matmul", (512, 2048, "float32"),
           {"block_m": 8, "block_n": 256}, device_kind="any")
    jt.put("flash_decode", (64, 2048, "float32"), {"split_k": 4},
           device_kind="any")
    p = tmp_path / "j.json"
    jt.save(str(p))
    TBL.set_table(TBL.TuningTable.load(str(p)))
    assert Q.int8_split(8, 512, 2048) == 0
    assert A.decode_split("flash_decode", torch.zeros(8, 8, 1, 64), 2048) \
        == 0
    # a TPU-knob entry under the port's own key loads (files are not
    # validated) and still reads as a miss
    TBL.set_table(TBL.TuningTable({"any": {"int8_matmul": {TBL.key_str(
        Q.int8_key(8, 512, 2048, torch.float32)): {"block_n": 256}}}}))
    assert Q.int8_split(8, 512, 2048) == 0


def test_consult_sites_table_on_and_off_give_the_plain_bits():
    """On the CPU every tunable path runs its plain version, which has no
    plan: a table of overrides (and the gather route) on or off gives the
    same bits."""
    rs = np.random.RandomState(0)
    S, h, psz, mp, d = 4, 2, 8, 5, 16
    q = torch.from_numpy(rs.randn(S, h, 1, d).astype("f4"))
    qv = torch.from_numpy(rs.randn(S, h, 4, d).astype("f4"))
    kp = torch.from_numpy(rs.randn(S * mp + 1, h, psz, d).astype("f4"))
    vp = torch.from_numpy(rs.randn(S * mp + 1, h, psz, d).astype("f4"))
    table = torch.arange(S * mp, dtype=torch.int32).reshape(S, mp)
    length = torch.tensor([1, 20, 33, 40], dtype=torch.int32)
    x = torch.from_numpy(rs.randn(4, 64).astype("f4"))
    wq, ws = Q.quantize_int8_weight(torch.from_numpy(
        rs.randn(64, 32).astype("f4")))
    xa = torch.from_numpy(rs.randn(4, 1, 64).astype("f4"))
    Ab = torch.from_numpy(rs.randn(3, 64, 8).astype("f4"))
    Bb = torch.from_numpy(rs.randn(3, 8, 32).astype("f4"))

    def run():
        return [A.paged_decode_attention(q, kp, vp, None, None, table,
                                         length),
                A.paged_verify_attention(qv, kp, vp, None, None, table,
                                         length + 3),
                A.decode_attention(q, kp[:S].transpose(0, 1)[:, :S]
                                   .reshape(S, h, psz, d), kp[:S]
                                   .reshape(S, h, psz, d), length.clamp(
                                       max=psz)),
                Q.int8_matmul(x, wq, ws),
                Q.lora_delta(xa, Ab, Bb, [0, 1, 2, 1])]

    os.environ["PT_TUNING"] = "0"
    off = run()
    os.environ.pop("PT_TUNING")
    TBL.set_table(_table(
        ("paged_flash_decode", A.paged_key("paged_flash_decode", d, S * h,
                                           psz, mp, torch.float32),
         {"kernel": False, "split_k": 2}),
        ("paged_flash_verify", A.paged_key("paged_flash_verify", d, S * h,
                                           psz, mp, torch.float32, 4),
         {"split_k": 3}),
        ("int8_matmul", Q.int8_key(4, 64, 32, torch.float32),
         {"split_k": 1}),
        ("lora_matmul", Q.lora_key(4, 1, 64, 8, torch.float32),
         {"kernel": False})))
    on = run()
    for a, b in zip(on, off):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the sweep driver
# ----------------------------------------------------------------------

def test_fallback_config_is_the_rule_written_out():
    for kernel, key, cfg in AT.fallback_entries():
        assert cfg["source"] == "fallback"
        x = AT._dims_of(kernel, key)
        if kernel == "flash_decode":
            assert cfg["split_k"] == A.flash_decode_plan(
                x["rows"] // 8, 8, x["L"])[0]
        if kernel == "int8_matmul":
            assert cfg["split_k"] == Q.skinny_plan(x["m"], x["d"], x["n"])[1]
        if kernel == "lora_matmul":
            assert cfg["cluster"] == Q.lora_plan(x["b"], x["s"], x["d"])[1]
        # the rule is one of the candidates, and the table key is bucketed
        assert cfg["source"] and dict(
            (k, v) for k, v in cfg.items() if k != "source") in \
            AT.candidates(kernel, key)
        tk = AT.table_key(kernel, key)
        assert AT.table_key(kernel, tk) == tk


def test_candidates_are_legal_and_leave_the_gather_routes_out():
    for kernel, keys in AT.DEFAULT_KEYS.items():
        for key in keys:
            cands = AT.candidates(kernel, key)
            assert cands and all(c.get("kernel", True) is not False
                                 for c in cands)
            with_gather = AT.candidates(kernel, key, gather=True)
            if kernel in ("paged_flash_decode", "paged_flash_verify",
                          "lora_matmul"):
                assert {"kernel": False} in with_gather
    assert AT.candidates("flash_decode", (64, 8, 64, "float32")) == \
        [{"split_k": 1}, {"split_k": 2}]
    assert AT.candidates("int8_matmul", (512, 2048, "float32", 64)) == []
    tiled = AT.candidates("paged_flash_verify",
                          (64, 8, 16, 48, "float32", 256))
    assert tiled == [{"tiles_per_split": t} for t in range(1, 9)]


def test_mini_sweep_keeps_a_winner_only_past_the_pairs_spread(tmp_path):
    key = (64, 64, 1056, "float32")
    rule = AT.fallback_config("flash_decode", key)["split_k"]
    noise = np.random.RandomState(0)

    def measurer(kernel, k, config):
        # split 2 is faster by 2 us, split 4 by 0.1 us; every time carries
        # up to 0.3 us of noise, so split 4's gain sits inside its spread
        return {2: 8e-6, 4: 9.9e-6}.get(config["split_k"], 10e-6) + \
            noise.uniform(-0.3e-6, 0.3e-6)

    fast = costs.DeviceSpec("fast", 1e18, 1e18, 1 << 40)
    rep = AT.sweep_key("flash_decode", key, measurer=measurer, spec=fast,
                       repeats=5)
    assert rep["fallback"] == {"split_k": rule}
    assert rep["winner"] == {"split_k": 2}
    rows = {r["config"]["split_k"]: r for r in rep["candidates"]}
    assert rows[2]["beats_rule"] and not rows[4]["beats_rule"]
    assert rep["key"] == "64/64/2048/float32"
    t = TBL.TuningTable()
    AT.apply_report(t, rep, device_kind="testdev")
    cfg = t.lookup("flash_decode", rep["key"], "testdev")
    assert cfg["split_k"] == 2 and cfg["source"] == "sweep"
    assert cfg["step_us"] < cfg["rule_us"]
    # a sweep whose candidates all sit inside the noise keeps the rule and
    # installs nothing
    flat = AT.sweep_key("flash_decode", key, spec=fast,
                        measurer=lambda kn, k, c: 10e-6, repeats=3)
    assert flat["winner"] == flat["fallback"]
    assert len(AT.apply_report(TBL.TuningTable(), flat)) == 0


def test_roofline_prune_and_stop():
    key = (64, 64, 1056, "float32")
    cands = AT.candidates("flash_decode", key)
    slow = costs.DeviceSpec("snail", 1e3, 1e3, 1 << 30)
    keep, cut = AT.prune("flash_decode", key, cands, 1e-6, slow)
    assert not keep and len(cut) == len(cands)
    keep2, cut2 = AT.prune("flash_decode", key, cands, 10.0, costs.CPU_SPEC)
    assert len(keep2) == len(cands) and not cut2
    keep3, _ = AT.prune("flash_decode", key, cands, None, slow)
    assert len(keep3) == len(cands)
    floor = AT.roofline_seconds(AT.analytic_cost("flash_decode", key),
                                costs.CPU_SPEC)
    calls = []

    def at_floor(kernel, k, config):
        calls.append(config)
        return 1.05 * floor

    rep = AT.sweep_key("flash_decode", key, measurer=at_floor,
                       spec=costs.CPU_SPEC)
    assert rep["stopped_at_roofline"] and len(calls) == 1
    assert rep["bound_us"] == round(floor * 1e6, 3)


def test_cli_smoke_on_the_cpu_writes_a_table(tmp_path, capsys):
    out = tmp_path / "swept.json"
    assert AT.main(["--smoke", "--device", "cpu", "--steps", "1", "--k", "1",
                    "--out", str(out)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["device_kind"] == "cpu" and rep["swept"] == 3
    TBL.TuningTable.load(str(out))
    assert AT.main(["--show"]) == 0


# ----------------------------------------------------------------------
# the AOT cache and the cache-aware build (a stub compiler)
# ----------------------------------------------------------------------

class _Done:
    """A finished 'compile' (the Popen interface `build` reads)."""

    def __init__(self, log):
        self.returncode = 0
        self._log = log

    def communicate(self):
        return self._log, None


class StubCompiler:
    """Writes a fake library blob per source and counts the compiles."""

    def __init__(self):
        self.built = []

    def __call__(self, src, out):
        stem = os.path.basename(src)[:-3]
        self.built.append(stem)
        with open(out, "wb") as f:
            f.write(f"fake library {stem} ".encode() * 64)
        return _Done(f"compiled {stem}")


@pytest.fixture
def build_env(tmp_path, monkeypatch):
    """A fresh build root, an empty binder and build record."""
    monkeypatch.setenv("PT_BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_kernels", _build._Kernels())
    monkeypatch.setattr(_build, "_info", {})
    return tmp_path


def test_aot_cache_roundtrip_corrupt_and_stale(tmp_path):
    path = str(tmp_path / "cache")
    c = AC.AotCompileCache(path)
    blob = b"\x7fELF" + bytes(range(256)) * 8
    assert c.store("k1", blob) and c.stats["saved"] == 1
    c2 = AC.AotCompileCache(path)
    assert c2.load("k1") == blob and c2.stats["loaded"] == 1
    assert c2.load("nope") is None and c2.stats["misses"] == 1
    # a byte flipped on disk: the CRC catches it, the load reads as a
    # miss, the manifest entry goes, a re-store lands (healed)
    dg = AC.AotCompileCache._digest("k1")
    entry = tmp_path / "cache" / "entries" / (dg + ".bin")
    raw = bytearray(entry.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    entry.write_bytes(bytes(raw))
    c3 = AC.AotCompileCache(path)
    assert c3.load("k1") is None and c3.stats["corrupt"] == 1
    assert c3.store("k1", blob)
    assert AC.AotCompileCache(path).load("k1") == blob
    # another environment wrote it: the whole cache reads as stale
    man = tmp_path / "cache" / "MANIFEST.json"
    m = json.loads(man.read_text())
    assert m["entries"][dg]["crc32"] == zlib.crc32(blob)
    m["fingerprint"]["torch"] = "0.0.0"
    man.write_text(json.dumps(m))
    c4 = AC.AotCompileCache(path)
    assert c4.stats["stale"] == 1 and len(c4) == 0
    assert c4.load("k1") is None


def test_env_fingerprint_names_the_environment():
    fp = AC.env_fingerprint()
    assert set(fp) == {"schema", "torch", "cuda", "nvcc", "backend",
                       "device_kind", "n_devices"}
    assert fp["torch"] == torch.__version__ and fp["backend"] == "cpu"
    assert AC.model_fingerprint([("a", torch.zeros(2, 3))]) != \
        AC.model_fingerprint([("a", torch.zeros(3, 2))])


def test_cache_fault_actions(tmp_path):
    """An injected corruption reads as a miss (counted corrupt); an
    injected raise propagates: it is the chaos harness's own signal."""
    path = str(tmp_path / "cache")
    AC.AotCompileCache(path).store("k", b"payload" * 10)
    c = AC.AotCompileCache(path)
    with faults.inject("tuning.cache_load", action="corrupt"):
        assert c.load("k") is None
    assert c.stats["corrupt"] == 1
    AC.AotCompileCache(path).store("k", b"payload" * 10)
    with faults.inject("tuning.cache_load", on="nth", n=1):
        with pytest.raises(faults.InjectedFault):
            AC.AotCompileCache(path).load("k")


def test_build_takes_valid_libraries_from_the_cache(build_env, tmp_path,
                                                    monkeypatch):
    cache = AC.AotCompileCache(str(tmp_path / "aot"))
    cc = StubCompiler()
    paths = _build.build(["flash_decode", "int8_matmul"], cache=cache,
                         compiler=cc)
    assert sorted(cc.built) == ["flash_decode", "int8_matmul"]
    assert sorted(_build.build_info()["compiled"]) == cc.built
    assert len(cache) == 2 and cache.keys() == sorted(
        _build.library_key(s) for s in ("flash_decode", "int8_matmul"))
    blob = open(paths["flash_decode"], "rb").read()
    # a fresh build root: the libraries come out of the cache, no compile
    monkeypatch.setenv("PT_BUILD_ROOT", str(tmp_path / "build2"))
    cc2 = StubCompiler()
    paths2 = _build.build(["flash_decode", "int8_matmul"],
                          cache=AC.AotCompileCache(str(tmp_path / "aot")),
                          compiler=cc2)
    assert cc2.built == [] and open(paths2["flash_decode"], "rb").read() \
        == blob
    assert sorted(_build.build_info()["loaded"]) == ["flash_decode",
                                                     "int8_matmul"]
    # a torn file in the build directory: its CRC disagrees with the
    # manifest, and it is replaced from the cache
    with open(paths2["int8_matmul"], "r+b") as f:
        f.truncate(10)
    cc3 = StubCompiler()
    _build.build(["int8_matmul"], cache=AC.AotCompileCache(
        str(tmp_path / "aot")), compiler=cc3)
    assert cc3.built == []
    assert os.path.getsize(paths2["int8_matmul"]) == len(
        AC.AotCompileCache(str(tmp_path / "aot")).load(
            _build.library_key("int8_matmul")))
    # a corrupt cache entry (fault plan): the library is compiled again
    # and stored anew
    monkeypatch.setenv("PT_BUILD_ROOT", str(tmp_path / "build3"))
    c4 = AC.AotCompileCache(str(tmp_path / "aot"))
    cc4 = StubCompiler()
    with faults.inject("tuning.cache_load", action="corrupt"):
        _build.build(["flash_decode"], cache=c4, compiler=cc4)
    assert cc4.built == ["flash_decode"] and c4.stats["corrupt"] == 1
    assert c4.stats["saved"] == 1


def test_build_digest_covers_the_toolchain(build_env, monkeypatch):
    d0 = _build._digest()
    tc = _build.toolchain()
    assert set(tc) == {"nvcc", "driver", "torch"}
    monkeypatch.setattr(_build, "_toolchain", dict(tc, nvcc="release 99"))
    assert _build._digest() != d0
    monkeypatch.setattr(_build, "_toolchain", dict(tc, driver=1))
    assert _build._digest() != d0


def test_load_rebuilds_once_on_an_oserror(build_env, monkeypatch):
    """ctypes refusing a library file (a torn .so) rebuilds that library
    once; a second refusal raises."""
    opened = []

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {"argtypes": None, "restype": None})()

    def flaky(path):
        opened.append(path)
        if len(opened) == 1:
            raise OSError("file too short")
        return Lib()

    cc = StubCompiler()
    monkeypatch.setattr(_build, "_open_library", flaky)
    k = _build.load(["lora_gather"], compiler=cc)
    assert cc.built == ["lora_gather", "lora_gather"]
    assert _build.build_info()["reopened"] == ["lora_gather"]
    assert "lora_gather" in k._libs and _build.loaded_stems() == \
        ["lora_gather"]

    def broken(path):
        raise OSError("file too short")

    monkeypatch.setattr(_build, "_open_library", broken)
    with pytest.raises(OSError):
        _build.load(["paged_decode"], compiler=StubCompiler())
