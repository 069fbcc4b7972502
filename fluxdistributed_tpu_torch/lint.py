"""The port's lint CLI — its static-analysis gate (``bin/lint.py``'s
flags and exit codes).

    # the AST rules (FDT105, FDT106) + the concurrency rules (FDT3xx)
    # over the package and chip_smoke.py, baseline-aware:
    python -m fluxdistributed_tpu_torch.lint --check

    # lint specific files/dirs:
    python -m fluxdistributed_tpu_torch.lint tests/fixtures_analysis/fdt301_pos.py

    # accept the current findings as the new allowlist:
    python -m fluxdistributed_tpu_torch.lint --update-baseline

Exit codes: 0 = clean (or informational run), 1 = new findings under
``--check`` (each printed as ``file:line: severity [RULE] message``),
2 = usage/internal error.

``--jaxpr``, ``--no-jaxpr``, ``--variants`` and ``--execute`` are the
JAX CLI's switches for its jaxpr layer (FDT2xx), which checks traced
JAX programs; the port has none, so they are accepted and run nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.lint",
        description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: the port's package "
                        "and chip_smoke.py)")
    p.add_argument("--check", action="store_true",
                   help="fail (exit 1) on findings not in the baseline")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path (default: "
                        "fluxdistributed_tpu_torch/analysis/baseline.json)")
    p.add_argument("--update-baseline", action="store_true",
                   help="write the current findings to the baseline and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings + summary as one JSON object")
    p.add_argument("--no-jaxpr", action="store_true",
                   help="the JAX CLI's switch off its jaxpr layer; the port "
                        "has no jaxpr layer, so nothing changes")
    p.add_argument("--no-concurrency", action="store_true",
                   help="skip the FDT3xx concurrency layer (lock "
                        "coverage / lock order / thread lifecycle — "
                        "stdlib-ast, on by default even for explicit "
                        "paths)")
    p.add_argument("--jaxpr", action="store_true",
                   help="the JAX CLI's jaxpr layer (FDT2xx: traced JAX "
                        "programs); the port has none: accepted, runs "
                        "nothing")
    p.add_argument("--variants", default=None,
                   help="the JAX CLI's jaxpr variants; accepted, unused "
                        "(no jaxpr layer)")
    p.add_argument("--execute", action="store_true",
                   help="the JAX CLI's jaxpr execution switch; accepted, "
                        "unused (no jaxpr layer)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import analysis

    baseline_path = args.baseline or analysis.default_baseline_path()
    if args.baseline and not os.path.exists(baseline_path):
        # a mistyped --baseline must not silently become "empty
        # allowlist, everything is new"
        alt = os.path.join(analysis.repo_root(), args.baseline)
        if os.path.exists(alt):
            baseline_path = alt
        elif args.check:
            print(f"lint: baseline {args.baseline} not found", file=sys.stderr)
            return 2

    findings = (analysis.scan_paths(args.paths) if args.paths
                else analysis.scan_repo())
    run_conc = not args.no_concurrency
    if run_conc:
        findings += analysis.run_concurrency_checks(args.paths or None)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))

    if args.update_baseline:
        # a partial-scope run (explicit paths / --no-concurrency) must
        # not erase allowlist entries it could not have re-observed
        scanned = set(analysis.scanned_files(args.paths or None))

        def _keep(e: dict) -> bool:
            if e.get("rule", "").startswith("FDT3"):
                return not run_conc or e.get("file") not in scanned
            return e.get("file") not in scanned

        keep = [e for e in analysis.load_baseline(baseline_path)
                if _keep(e)]
        analysis.save_baseline(baseline_path, findings, keep=keep)
        print(f"lint: wrote {len(findings)} finding(s) + {len(keep)} "
              f"kept out-of-scope entr(ies) to {baseline_path}")
        return 0

    baseline = analysis.load_baseline(baseline_path)
    new, stale = analysis.diff_findings(findings, baseline)
    summary = analysis.summarize(findings, new)
    summary["baseline"] = len(baseline)
    summary["stale_baseline_entries"] = len(stale)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "summary": summary,
        }, indent=2))
    else:
        report = new if args.check else findings
        for f in report:
            print(analysis.format_finding(f))
        for e in stale:
            print(f"note: stale baseline entry {e.get('rule')} "
                  f"{e.get('file')} ({e.get('detail')}) — finding no "
                  "longer fires; shrink the baseline")
        kinds = ", ".join(f"{k}={v}" for k, v in summary["by_rule"].items())
        print(f"lint: {summary['findings']} finding(s) "
              f"({kinds or 'none'}), {len(new)} new vs baseline "
              f"({len(baseline)} entries)")

    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
