"""The port's static analyzer (`paddle_tpu_torch.analysis`) against the JAX
package's `analysis/`, on the CPU.

The JAX tests' fixtures for the host-state and repo rules (PTA201,
PTA202, PTA203) and the Baseline ratchet give the same rule ids and
baseline keys on the port. Each program rule the port applies (PTA102,
PTA103, PTA104: the aten ops one program run dispatches) and the port's
PTA204 (host calls in program bodies) has a fixture that fires and a twin
that does not. PTA101 and PTA105 keep their ids, and a test says why no
port fixture fires them. The real tree is green: `static_findings` is
empty and the program gate over the tiny check engines holds against the
package's baseline, every entry of which carries a justification.
"""
import textwrap

import pytest
import torch

from paddle_tpu import analysis as JAN
from paddle_tpu.analysis import repo_rules as JRR
from paddle_tpu_torch import analysis as AN
from paddle_tpu_torch.analysis import repo_rules as RR
from paddle_tpu_torch.analysis import runner
from paddle_tpu_torch.profiler import trace as T

LB = 4096


def _rules(findings, rule):
    return [f for f in findings if f.rule == rule]


def _keys(findings):
    return sorted((f.rule, f.baseline_key) for f in findings)


# ----------------------------------------------------------------------
# the rule vocabulary and the JAX fixtures
# ----------------------------------------------------------------------

def test_rule_ids_and_slugs_are_the_jax_ones():
    assert {k: v[0] for k, v in AN.RULES.items()} == \
        {k: v[0] for k, v in JAN.RULES.items()}


_LOCKED_SRC = textwrap.dedent('''
    import threading

    class Sink:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0
            self.stats = {"hits": 0}
            self.rows = []

        def locked(self):
            with self._lock:
                self.n += 1
                self.rows.append(1)

        def unlocked(self):
            self.n += 1
            self.stats["hits"] += 1
            self.rows.append(2)

        def exempt(self):   # analysis: single-threaded
            self.n = 0

        def exempt_stmt(self):
            self.n = 0      # analysis: single-threaded

    class Unlocked:
        def free(self):     # no lock attr => class not checked
            self.x = 1
''')


def test_pta201_lock_discipline_matches_jax():
    fs = AN.check_source(_LOCKED_SRC, "fixture.py")
    assert _keys(fs) == _keys(JAN.check_source(_LOCKED_SRC, "fixture.py"))
    assert sorted(f.baseline_key for f in _rules(fs, "PTA201")) == [
        "fixture.py:Sink.unlocked:n",
        "fixture.py:Sink.unlocked:rows",
        "fixture.py:Sink.unlocked:stats",
    ]


_SNAP_SRC = textwrap.dedent('''
    class ServingMetrics:
        def snapshot(self):
            mem = {"pool_bytes": 1}
            return {
                "joins": self.joins,
                "requests": {"submitted": 1, "ghost": 2},
                **({} if self.m is None else {"memory": mem}),
            }
''')


def test_pta202_snapshot_doc_drift_matches_jax(tmp_path):
    assert RR.snapshot_keys_from_source(_SNAP_SRC) == \
        JRR.snapshot_keys_from_source(_SNAP_SRC) == {
            "joins", "requests.submitted", "requests.ghost",
            "memory.pool_bytes"}
    p = tmp_path / "metrics.py"
    p.write_text(_SNAP_SRC)
    docs = {"joins": 0, "requests.submitted": 0,
            "memory.pool_bytes": 0, "requests.dropped_doc": 0}
    fs = RR.snapshot_doc_findings(str(p), docs=docs)
    assert _keys(fs) == _keys(JRR.snapshot_doc_findings(str(p), docs=docs))
    assert {f.baseline_key for f in fs} == {
        "snapshot:undocumented:requests.ghost",
        "snapshot:unemitted:requests.dropped_doc"}


def test_pta202_follows_the_ports_section_methods():
    """The port's snapshot() splices `**self._sections(...)`, which builds
    its sections as `out["name"] = {...}`: the extraction follows it."""
    src = textwrap.dedent('''
        class ServingMetrics:
            def snapshot(self):
                return {"joins": 1, **self._sections(None)}

            def _sections(self, ledger):
                out = {}
                if self.a:
                    out["paging"] = {"pages_free": 1, "waits": 2}
                out["cold_start"] = {"warm": 1}
                return out
    ''')
    assert RR.snapshot_keys_from_source(src) == {
        "joins", "paging.pages_free", "paging.waits", "cold_start.warm"}


def test_pta202_real_tree_in_sync():
    keys = RR.snapshot_keys_from_source(open(
        runner.os.path.join(runner.repo_root(), "paddle_tpu_torch",
                            "serving", "metrics.py")).read())
    assert {k for k in keys if k.startswith("cold_start.")} == {
        "cold_start.time_to_ready_s", "cold_start.programs",
        "cold_start.loaded_from_cache", "cold_start.compiled",
        "cold_start.cache_errors", "cold_start.warm",
        "cold_start.first_ttft_ms"}
    assert RR.snapshot_doc_findings() == []


def test_pta203_unregistered_fault_point_matches_jax(tmp_path):
    prod = tmp_path / "prod.py"
    prod.write_text('from x import faults\n'
                    '_PT = faults.point("serving.real")\n')
    t = tmp_path / "test_it.py"
    t.write_text('faults.inject("serving.real")\n'
                 'faults.inject("serving.typo")\n')
    fs = RR.fault_point_findings([str(prod)], [str(t)])
    assert _keys(fs) == _keys(JRR.fault_point_findings([str(prod)],
                                                       [str(t)]))
    assert [f.baseline_key for f in fs] == ["faults:serving.typo"]


def test_baseline_match_wildcard_and_stale_matches_jax(tmp_path):
    entries = [
        {"rule": "PTA102", "match": "*:join:arg2", "justification": "j"},
        {"rule": "PTA102", "match": "Dead:*", "justification": "j"},
    ]
    for mod in (AN, JAN):
        b = mod.Baseline(entries)
        f1 = mod.Finding("PTA102", "w", "m", baseline_key="Eng:join:arg2")
        f2 = mod.Finding("PTA102", "w", "m", baseline_key="Eng:step:arg2")
        f3 = mod.Finding("PTA101", "w", "m", baseline_key="Eng:join:arg2")
        new, baselined, stale = b.split([f1, f2, f3])
        assert baselined == [f1] and new == [f2, f3]
        assert stale == [entries[1]]
        p = tmp_path / f"{mod.__name__}.json"
        b.save(p)
        assert len(mod.Baseline.load(p).entries) == 2
        with pytest.raises(ValueError):
            mod.Baseline([{"rule": "PTA102", "match": "x"}])


# ----------------------------------------------------------------------
# PTA204: host calls in program bodies
# ----------------------------------------------------------------------

def test_pta204_host_calls_in_program_bodies():
    src = textwrap.dedent('''
        import numpy as np
        import time

        class DenseLayout:
            def step(self, active):
                x = np.asarray(active)       # host transfer
                t = time.time()              # host clock
                return active.item() + x     # a device sync

            def row_index(self):             # not a body: fine
                return np.zeros(3)

        class Engine:
            def _join(self, s):
                def body(a):
                    return a.cpu()           # handed to _program below
                def helper(a):
                    return np.ones(2)        # not a program: fine
                return self._program(("join", 8), body)(s)
    ''')
    fs = AN.check_source(src, "fixture.py")
    assert sorted(f.baseline_key for f in _rules(fs, "PTA204")) == [
        "fixture.py:body:.cpu",
        "fixture.py:step:.item",
        "fixture.py:step:np.asarray",
        "fixture.py:step:time.time",
    ]


def test_pta204_clean_bodies_do_not_fire():
    src = textwrap.dedent('''
        import numpy as np

        class PagedLayout:
            def cow(self, src, dst):
                return dst.copy_(src)

            def attach(self, slot, tok0):
                return int(tok0)                  # a host int: fine

        def _step_body(key):
            def fn(x):
                return x + 1
            return fn
    ''')
    assert not _rules(AN.check_source(src, "fixture.py"), "PTA204")


# ----------------------------------------------------------------------
# the program rules (a run under the op recorder)
# ----------------------------------------------------------------------

def test_pta102_carry_replaced_instead_of_updated_in_place():
    st = {"kv": torch.zeros(64, 64), "tok": torch.zeros(4)}

    def replaces(x):
        st["kv"] = st["kv"] + x

    fs = AN.analyze_program(("step", 1), replaces, (1.0,), owner="Fix",
                            state=st, large_bytes=LB)
    (f,) = _rules(fs, "PTA102")
    assert f.baseline_key == "Fix:step:state" and "kv" in f.message

    def in_place(x):
        st["kv"].add_(x)
        st["tok"] = st["tok"] + 1          # small: below the threshold

    fs = AN.analyze_program(("step", 1), in_place, (1.0,), state=st,
                            large_bytes=LB)
    assert not _rules(fs, "PTA102")
    # a leaf outside the declared in-place set is not audited
    fs = AN.analyze_program(("step", 1), replaces, (1.0,), state=st,
                            declared_inplace={"tok"}, large_bytes=LB)
    assert not _rules(fs, "PTA102")


def test_pta103_float_widening_and_float64():
    x = torch.zeros(4, dtype=torch.bfloat16)

    def widen(a):
        return a + torch.ones(4, dtype=torch.float32)

    fs = AN.analyze_program(("step", 1), widen, (x,),
                            dtype=torch.bfloat16, large_bytes=LB)
    assert any("bfloat16 -> float32" in f.message
               for f in _rules(fs, "PTA103"))

    def f64(a):
        return a.float().double() * 2

    fs = AN.analyze_program(("step", 1), f64, (x,), dtype=torch.bfloat16,
                            large_bytes=LB)
    assert any(f.baseline_key.endswith(":f64") for f in _rules(fs, "PTA103"))

    def clean(a):
        return torch.where(a > 0, a, a * 2)

    for fn, dt in ((clean, torch.bfloat16), (widen, torch.float32)):
        # float32 is the float32 engine's own dtype: not a widening past it
        fs = AN.analyze_program(("step", 1), fn, (x,), dtype=dt,
                                large_bytes=LB)
        assert not _rules(fs, "PTA103")


def test_pta104_host_transfer_inside_a_program():
    st = torch.arange(4.0)

    def reads(a):
        return int(a[0].item()) + 1

    fs = AN.analyze_program(("step", 1), reads, (st,), large_bytes=LB)
    hits = _rules(fs, "PTA104")
    assert hits and all(f.baseline_key.split(":")[-1] in
                        ("aten.item", "aten._local_scalar_dense")
                        for f in hits)

    def stays(a):
        return a[0] + 1

    assert not _rules(AN.analyze_program(("step", 1), stays, (st,),
                                         large_bytes=LB), "PTA104")


def test_pta101_has_no_eager_counterpart():
    """PTA101 flags a large constant XLA bakes into a compiled program (a
    retrace per value, a resident copy per executable). An eager port
    program reads a closed-over tensor at each call and compiles nothing,
    so the rule has nothing to find: the id stays reserved, and a program
    closing over a large tensor gives no finding."""
    big = torch.arange(4096.0)
    fs = AN.analyze_program(("step", 1), lambda a: a + big,
                            (torch.zeros(4096),), large_bytes=LB)
    assert "PTA101" in AN.RULES and not _rules(fs, "PTA101")


def test_pta105_waits_for_multi_card_serving():
    """PTA105 audits the layout constraints of sharded program carries.
    The port serves on one card (multi-GPU serving is a later slice), so
    no check engine is sharded and `analyze_program` takes no `sharded`
    flag: the id stays reserved until that slice."""
    import inspect

    assert "PTA105" in AN.RULES
    assert "sharded" not in inspect.signature(AN.analyze_program).parameters
    labels = [label for label, _ in
              runner.build_check_engines(device="cpu")]
    assert not any("shard" in label for label in labels)


# ----------------------------------------------------------------------
# the real tree
# ----------------------------------------------------------------------

def test_real_tree_static_findings_empty():
    assert AN.static_findings() == []


def test_real_tree_program_gate_green():
    """The program matrix (dense / spec / paged / paged spec / tenant /
    radix / chunked / chunked paged + the multi-tensor optimizer step):
    every finding carries a justified baseline entry, none is new, no
    entry is stale. The pools are written in place (no PTA102) and no
    program reads a device value on the host (no PTA104 outside the
    baselined optimizer helper)."""
    rep = AN.run(fast=False, device="cpu")
    assert rep["ok"], [f.as_dict() for f in rep["new"]]
    assert rep["stale_baseline"] == []
    assert all("FusedOptimizerStep" in f.baseline_key
               for f in rep["baselined"])
    assert all(e["justification"] for e in AN.Baseline.load(
        runner.BASELINE_PATH).entries)


def test_cli_exit_code_is_the_gate(tmp_path, capsys, monkeypatch):
    from paddle_tpu_torch.analysis.__main__ import main

    assert main(["--no-programs"]) == 0
    assert "PASS" in capsys.readouterr().out
    # a program finding the baseline does not justify fails the gate (the
    # static half is the test above's)
    monkeypatch.setattr(runner, "static_findings", lambda root=None: [])
    monkeypatch.setattr(runner, "program_findings", lambda device: [
        AN.Finding("PTA104", "Eng:('step',)", "m",
                   baseline_key="Eng:step:aten.item")])
    assert main(["--json", "--device", "cpu"]) == 1
    bad = tmp_path / "b.json"
    AN.Baseline([{"rule": "PTA104", "match": "Eng:step:*",
                  "justification": "j"}]).save(bad)
    assert main(["--baseline", str(bad), "--device", "cpu"]) == 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_program_lints_default_to_the_card_and_never_fall_back(monkeypatch):
    """With no device the program half is asked of the CUDA card: on a
    machine without one, `run()`, the CLI, `program_findings()` and
    `analyze_fused_optimizer()` raise `resolve_device`'s error, and no
    lint runs on the CPU in its place."""
    ran = []
    monkeypatch.setattr(runner, "static_findings",
                        lambda root=None: ran.append("static") or [])
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        AN.run(fast=False)
    from paddle_tpu_torch.analysis.__main__ import main

    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        main(["--json"])
    for fn in (runner.program_findings, runner.build_check_engines,
               AN.analyze_fused_optimizer):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            fn()
    assert ran == []
    # the source lints alone need no device
    assert AN.run(programs=False)["cache"] is None and ran == ["static"]


def test_analyze_engine_leaves_counters_and_sentinel_quiet():
    dec, emb, proj = runner._small_stack(seed=21, device="cpu")
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(dec, emb, proj, num_slots=2, max_len=32,
                        device="cpu")
    with T.retrace_sentinel(eng):
        AN.analyze_engine(eng, (4, 32), prompt_buckets=(8,))
        before = dict(eng.trace_counts)
        AN.analyze_engine(eng, (4, 32), prompt_buckets=(8,))
        assert dict(eng.trace_counts) == before == {}
    T.reset()
