"""Cross-run trend tables, regression gating and postmortems.

The consumer side of the :mod:`.runs` ledger (``runs.jsonl``: one
record per training run / bench round / supervisor episode, keyed by
topology fingerprint); the port's counterpart of ``bin/trends.py``::

    # trend tables + newest records (the default view)
    python -m fluxdistributed_tpu_torch.obs.trends --ledger runs.jsonl

    # CI gate: exit 2 when the newest value of any gated metric moved
    # past tolerance in the BAD direction vs its per-topology rolling
    # baseline (good-direction moves are notes — re-record, don't gate)
    python -m fluxdistributed_tpu_torch.obs.trends --check

    # backfill the ledger from archived round files (idempotent by
    # source basename — phase/retryable/probe_attempts preserved)
    python -m fluxdistributed_tpu_torch.obs.trends \
        --ingest 'BENCH_r*.json' 'MULTICHIP_r*.json'

    # one human-readable account of how a round died: newest flight
    # dump + supervisor episode ledger + bench phase status merged
    python -m fluxdistributed_tpu_torch.obs.trends --postmortem \
        --flight run/flight.jsonl --supervisor-ledger run/ledger.json

The default ledger is the port's own (``runs_torch.jsonl`` at the root
of the checkout), not the JAX package's ``benchmarks/hw/runs.jsonl``:
the port's fingerprints digest torch and the card
(:func:`.runs.topology_fingerprint`), so a JAX ledger's per-topology
baselines never match a port run's.

Exit codes: 0 clean, 2 regression detected (``--check``), 1 usage /
missing ledger.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from . import runs as runs_lib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_LEDGER = os.path.join(REPO, "runs_torch.jsonl")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.obs.trends",
        description=__doc__.splitlines()[0])
    p.add_argument("--ledger", default=DEFAULT_LEDGER, metavar="PATH",
                   help="the runs.jsonl ledger to read/append "
                        f"(default: {DEFAULT_LEDGER})")
    p.add_argument("--check", action="store_true",
                   help="regression gate: exit 2 when any gated metric "
                        "regressed past tolerance vs its per-topology "
                        "rolling baseline")
    p.add_argument("--window", type=int, default=5, metavar="N",
                   help="rolling-baseline window: the median of up to N "
                        "predecessors (default 5)")
    p.add_argument("--ingest", nargs="+", default=None, metavar="GLOB",
                   help="backfill: ingest archived BENCH_r*.json / "
                        "MULTICHIP_r*.json round files into the ledger "
                        "(idempotent by source basename)")
    p.add_argument("--postmortem", action="store_true",
                   help="merge the evidence below into one "
                        "human-readable timeline of how a run died")
    p.add_argument("--flight", default=None, metavar="PATH",
                   help="flight dump for --postmortem")
    p.add_argument("--supervisor-ledger", default=None, metavar="PATH",
                   help="supervisor episode ledger for --postmortem")
    p.add_argument("--bench-status", default=None, metavar="PATH",
                   help="bench.py --resumable status JSON for "
                        "--postmortem")
    p.add_argument("--limit", type=int, default=20, metavar="N",
                   help="newest records to render (default 20)")
    args = p.parse_args(argv)

    if args.ingest:
        paths = []
        for pat in args.ingest:
            hits = glob.glob(pat)
            if not hits:
                print(f"ingest: no files match {pat!r}", file=sys.stderr)
            paths.extend(hits)
        added, skipped = runs_lib.ingest_paths(args.ledger, paths)
        print(f"ingested {added} record(s) into {args.ledger} "
              f"({skipped} skipped: already present or unparseable)")
        return 0

    if args.postmortem:
        print(runs_lib.postmortem_timeline(
            flight_path=args.flight,
            supervisor_ledger=args.supervisor_ledger,
            bench_status=args.bench_status,
            runs_path=args.ledger if os.path.exists(args.ledger)
            else None,
        ))
        return 0

    runs = runs_lib.load_runs(args.ledger)
    if not runs:
        print(f"no ledger at {args.ledger} (or it is empty) — run "
              "--ingest, or point --ledger at one", file=sys.stderr)
        return 1

    print(f"== {args.ledger}: {len(runs)} record(s) ==")
    print(runs_lib.render_runs(runs, limit=args.limit))
    print()
    print(runs_lib.trend_table(runs, window=args.window))
    verdicts = runs_lib.check_regressions(runs, window=args.window)
    for note in verdicts["notes"]:
        print(f"note: {note}")
    for fail in verdicts["failures"]:
        print(f"REGRESSION: {fail}")
    if args.check and verdicts["failures"]:
        return 2
    if args.check:
        print("check: no regressions "
              f"({len(verdicts['notes'])} note(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
