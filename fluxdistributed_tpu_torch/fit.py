"""The memory and collective fit checker: does variant X fit this card,
and with how much headroom?

Port of ``bin/fit.py``, with its flags and exit codes::

    # price every registered variant (analysis/variants.py) through the
    # real prepare_training / LMEngine paths on a fake world of 8 ranks
    # (one run on fake tensors each: no device memory) and write the
    # memory and collective report as a fdtpu-profile/v2 artifact:
    python -m fluxdistributed_tpu_torch.fit --collect p.json --host-devices 8

    # rank the variants by headroom under a budget (bytes per device;
    # default: the card's total memory; without a card pass --hbm-bytes):
    python -m fluxdistributed_tpu_torch.fit --profile p.json \\
        --host-devices 8 --hbm-bytes 16e9

    # gate on one variant, or on the committed memory baseline:
    python -m fluxdistributed_tpu_torch.fit --profile p.json \\
        --host-devices 8 --hbm-bytes 16e9 --require zero1
    python -m fluxdistributed_tpu_torch.fit --collect p.json --check
    python -m fluxdistributed_tpu_torch.fit --collect p.json --update-baseline

Exit codes: 0 = ok or informational, 1 = the baseline check failed,
2 = usage error, 3 = a ``--require``'d variant does not fit.

``--host-devices N`` is the size of the fake world the variants are
priced on and the fingerprint names (the registry's meshes span 8
ranks); without it the fingerprint is this process's real topology.
``--no-hlo`` leaves the collective ledger out of ``--collect``.  The
priced step is rank 0's.  ``obs.memstats.rank_memory`` is the one
ranking this CLI and the layout picker (``parallel.layout.pick``)
share.  Fake tensors live on ``--device`` (default ``cuda``; ``cpu``
prices the same program without a card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

__all__ = ["build_parser", "default_baseline_path", "main",
           "rank_variants"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.fit",
        description=__doc__.split("\n")[0])
    p.add_argument("--collect", metavar="OUT",
                   help="price the registered variants (one fake run "
                        "each) and write the memory and collective report "
                        "as a fdtpu-profile/v2 artifact")
    p.add_argument("--variants", default=None,
                   help="comma-separated variant subset for --collect "
                        "(default: all registered)")
    p.add_argument("--no-hlo", action="store_true",
                   help="leave the collective ledger out of --collect "
                        "(memory only)")
    p.add_argument("--host-devices", type=int, default=0,
                   help="the fake world's size: the ranks the variants "
                        "are priced on and the fingerprint names (the "
                        "registry spans 8); 0 = this process's real "
                        "topology")
    p.add_argument("--profile", metavar="PATH",
                   help="rank variants from an existing artifact "
                        "instead of pricing")
    p.add_argument("--allow-mismatch", action="store_true",
                   help="skip the topology-fingerprint gate when "
                        "loading --profile (offline analysis of a "
                        "foreign artifact only)")
    p.add_argument("--hbm-bytes", type=float, default=None,
                   help="per-device memory budget in bytes (default: the "
                        "card's total memory; REQUIRED without a card)")
    p.add_argument("--require", action="append", default=[],
                   metavar="VARIANT",
                   help="exit 3 unless this variant fits the budget "
                        "(repeatable)")
    p.add_argument("--check", action="store_true",
                   help="fail (exit 1) on memory regressions against the "
                        "committed baseline")
    p.add_argument("--baseline", default=None,
                   help="memory-baseline JSON (default: "
                        "fluxdistributed_tpu_torch/analysis/"
                        "memory_baseline.json)")
    p.add_argument("--update-baseline", action="store_true",
                   help="write the sweep's memory figures as the new "
                        "baseline")
    p.add_argument("--tolerance", type=float, default=None,
                   help="override the baseline's regression tolerance "
                        "(fraction, e.g. 0.5)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the ranking/check as one JSON object")
    p.add_argument("--device", default=None,
                   help="where the fake tensors live: cuda (the default) "
                        "or cpu")
    return p


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "analysis", "memory_baseline.json")


def _variant_memory(profile) -> dict:
    """``{variant: entry}`` with a memory dict, off a v2 artifact."""
    return dict(profile.memory.get("variants") or {})


def rank_variants(profile, budget) -> list:
    """Headroom ranking rows of an artifact's variants: a thin adapter
    over ``obs.memstats.rank_memory``, the one ranking this CLI and the
    layout picker share."""
    from .obs.memstats import rank_memory

    return rank_memory(_variant_memory(profile), budget)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.collect and not args.profile:
        print("fit: pass --collect OUT and/or --profile PATH",
              file=sys.stderr)
        return 2
    from .analysis.variants import WORLD
    from .obs import memstats
    from .obs.pricing import fake_world
    from .obs.profile import Profile, ProfileMismatch, describe_topology
    from .obs.runs import topology_fingerprint

    if args.host_devices and args.host_devices != WORLD and args.collect:
        print(f"fit: --host-devices {args.host_devices}: the registered "
              f"variants span {WORLD} ranks", file=sys.stderr)
        return 2
    # the topology the fingerprint names: the fake world, or this process
    world = (fake_world(args.host_devices) if args.host_devices
             else contextlib.nullcontext())
    if args.collect:
        names = args.variants.split(",") if args.variants else None
        report = memstats.variant_report(
            names, include_hlo=not args.no_hlo, device=args.device)
        with world:
            fingerprint, topology = topology_fingerprint(), describe_topology()
        prof = Profile(
            fingerprint=fingerprint, topology=topology,
            memory={"state": None, "step": None,
                    "variants": {n: {"memory": e.get("memory"),
                                     "args_bytes": e.get("args_bytes"),
                                     "source": e.get("source"),
                                     **({"unavailable": e["unavailable"]}
                                        if "unavailable" in e else {})}
                                 for n, e in report.items()}},
            comms={"step": {},
                   "variants": {n: e.get("comms", {})
                                for n, e in report.items()}},
            meta={"producer": "python -m fluxdistributed_tpu_torch.fit "
                              "--collect"},
        )
        prof.save(args.collect)
        print(f"fit: wrote {len(report)} variant(s) to {args.collect}")
    else:
        prof = Profile.load(args.profile)
        if args.allow_mismatch:
            print("fit: WARNING — topology gate skipped "
                  "(--allow-mismatch); headroom figures describe the "
                  f"artifact's topology {prof.topology}, not this machine",
                  file=sys.stderr)
        else:
            try:
                with world:
                    prof.verify()
            except ProfileMismatch as e:
                raise SystemExit(f"fit: {e}")

    rc = 0
    # -- the baseline workflow ----------------------------------------------
    baseline_path = args.baseline or default_baseline_path()
    current = _variant_memory(prof)
    if args.update_baseline:
        doc = memstats.build_baseline(
            current,
            tolerance=(args.tolerance if args.tolerance is not None
                       else memstats.DEFAULT_TOLERANCE))
        tmp = f"{baseline_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, baseline_path)
        print(f"fit: wrote {len(doc['variants'])} variant baseline "
              f"entr(ies) to {baseline_path}")
        return 0
    check = None
    if args.check:
        if not os.path.exists(baseline_path):
            print(f"fit: baseline {baseline_path} not found",
                  file=sys.stderr)
            return 2
        with open(baseline_path) as f:
            base = json.load(f)
        check = memstats.check_memory_baseline(
            current, base, tolerance=args.tolerance)
        for note in check["notes"]:
            print(f"note: {note}")
        for fail in check["failures"]:
            print(f"FAIL: {fail}")
        print(f"fit: baseline check — {check['checked']} variant(s) "
              f"checked at tolerance {check['tolerance']}, "
              f"{len(check['failures'])} failure(s)")
        if check["failures"]:
            rc = 1

    # -- the headroom ranking -----------------------------------------------
    budget = args.hbm_bytes
    if budget is None:
        limits = [d["bytes_limit"] for d in (memstats.hbm_device_stats()
                                             or []) if d["bytes_limit"] > 0]
        if limits:
            budget = float(min(limits))
    rows = rank_variants(prof, budget)
    if args.as_json:
        print(json.dumps({"budget_bytes": budget, "rows": rows,
                          "check": check}, indent=2))
    else:
        if budget is None:
            print("fit: no HBM budget — no card reports its memory here; "
                  "pass --hbm-bytes to rank fits (peak bytes still "
                  "listed)")
        else:
            print(f"fit: per-device HBM budget {budget:.3e} bytes")
        for r in rows:
            peak = (f"{r['peak_bytes']:>14,}" if r["peak_bytes"]
                    is not None else "   unavailable")
            verdict = {True: "FITS", False: "DOES NOT FIT",
                       None: "?"}[r["fits"]]
            head = (f"  headroom {r['headroom_bytes']:,}"
                    if r["headroom_bytes"] is not None else "")
            print(f"  {r['variant']:<24} peak {peak}  {verdict}{head}")
    for req in args.require:
        row = next((r for r in rows if r["variant"] == req), None)
        if row is None:
            print(f"fit: --require {req}: unknown variant in this "
                  f"artifact ({sorted(r['variant'] for r in rows)})",
                  file=sys.stderr)
            return 2
        if row["fits"] is not True:
            print(f"fit: --require {req}: peak "
                  f"{row['peak_bytes']} bytes does NOT fit the "
                  f"budget {budget} — pick a smaller variant or a "
                  "bigger topology", file=sys.stderr)
            return 3
    return rc


if __name__ == "__main__":
    sys.exit(main())
