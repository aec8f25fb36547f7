"""Static analyzer gate over the port's serving stack.

    python -m paddle_tpu_torch.analysis              # full run
    python -m paddle_tpu_torch.analysis --fast       # reuse cached program
                                                     #   results while no
                                                     #   port source changed
    python -m paddle_tpu_torch.analysis --json       # machine-readable
    python -m paddle_tpu_torch.analysis --no-programs  # AST/repo lints only
    python -m paddle_tpu_torch.analysis --device cpu   # the program lints
                                                     #   on the CPU (default:
                                                     #   the CUDA card)
    python -m paddle_tpu_torch.analysis --write-baseline  # re-seed the
                                                     #   allowlist (fill in
                                                     #   the justifications)

Two halves (the rule table is `paddle_tpu_torch.analysis.RULES`): AST and
repo lints (PTA201 lock discipline over serving/, tuning/, profiler/ and
optimizer/fused.py, PTA202 snapshot()/SNAPSHOT_DOCS sync, PTA203 the
fault-point registry, PTA204 host calls in program bodies), and the
program lints (every program `ServingEngine.precompile()` readies on the
tiny check engines, plus the multi-tensor optimizer step, run once under
an aten-op recorder: PTA102, PTA103, PTA104). The program half runs on
the CUDA card unless `--device cpu` asks for the host; with no card it
raises and lints nothing.

Exit status is the gate: 0 when every finding has a justified entry in
the committed `paddle_tpu_torch/analysis/baseline.json`, 1 otherwise.
Stale baseline entries (matching nothing) are reported so the allowlist
only ever ratchets DOWN.
"""
import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report on stdout")
    ap.add_argument("--fast", action="store_true",
                    help="reuse cached program analyses while no "
                         "paddle_tpu_torch/ source changed")
    ap.add_argument("--no-programs", action="store_true",
                    help="skip the program lints: AST + repo lints only")
    ap.add_argument("--device", default=None,
                    help="where the program lints run: the CUDA card "
                         "(default) or cpu")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: the package's "
                         "analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding into the baseline "
                         "(justification left as TODO) instead of gating")
    args = ap.parse_args(argv)

    from . import Baseline, render_text, runner

    report = runner.run(programs=not args.no_programs, fast=args.fast,
                        baseline_path=args.baseline, device=args.device)
    if args.write_baseline:
        path = args.baseline or runner.BASELINE_PATH
        entries, seen = [], set()
        for f in report["findings"]:
            k = (f.rule, f.baseline_key)
            if k in seen:
                continue
            seen.add(k)
            entries.append({"rule": f.rule, "match": f.baseline_key,
                            "justification": "TODO: justify or fix"})
        Baseline(entries).save(path)
        print(f"wrote {len(entries)} baseline entries to {path} — replace "
              f"every TODO justification before committing")
        return 0
    if args.json:
        json.dump({
            "ok": report["ok"], "cache": report["cache"],
            "findings": [f.as_dict() for f in report["findings"]],
            "new": [f.as_dict() for f in report["new"]],
            "baselined": [f.as_dict() for f in report["baselined"]],
            "stale_baseline": report["stale_baseline"],
        }, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        n = len(report["findings"])
        print(f"static_check: {n} finding(s) — "
              f"{len(report['baselined'])} baselined (justified), "
              f"{len(report['new'])} new"
              + (f"  [program cache {report['cache']}]"
                 if report["cache"] else ""))
        if report["new"]:
            print("NEW findings (fix, or baseline with a justification):")
            print(render_text(report["new"]))
        for e in report["stale_baseline"]:
            print(f"stale baseline entry (matches nothing — delete it): "
                  f"{e['rule']} {e['match']!r}")
        print("PASS" if report["ok"] else "FAIL")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
