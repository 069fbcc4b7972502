"""Cross-run history ledger + regression gating (``runs.jsonl``).

(A copy of the JAX package's stdlib-only ``obs/runs.py``, with the
port's own :func:`topology_fingerprint`, of torch and the card where
the JAX one digests jax and the TPU, and a ``torch`` label on the
run-info gauge where the JAX one has ``jax``.)

The within-run layers (metrics, spans, profile, memstats, flight
recorder) each explain ONE process.  This module is the memory ACROSS
processes: an append-only JSONL ledger with one record per training
run, bench round, multichip probe or supervisor episode, keyed by the
topology fingerprint (:func:`topology_fingerprint`), carrying
the phase reached, the retryable verdict, every forensic stamp the
bench JSON grew (lint/guard/memory/layout_pick), the throughput and
compile-seconds truths, and the path of the flight dump that can
explain the record in step-level detail.

Consumers (``bin/trends.py``):

* **trend tables** — per (metric, topology) history with a rolling
  baseline, so the first green hardware number lands as a defended
  trend row, not a lone point (ROADMAP item 1);
* **regression gating** — the newest value of each metric is compared
  against the rolling **median** of its per-topology predecessors with
  a per-metric tolerance; ``--check`` exits non-zero for CI.  Memory-
  baseline semantics apply: a metric *shrinking* past tolerance in the
  good direction is a NOTE (re-record the baseline), never a failure —
  only movement in the bad direction gates;
* **postmortems** — :func:`postmortem_timeline` merges the newest
  flight dump, the supervisor's episode ledger and the bench status
  file into one human-readable account of how a round died.

Records never lie by omission: a round that died carries ``error`` and
is excluded from baselines (a dead round's 0.0 img/s is not a
throughput observation), but stays in the ledger forever — the five
dead hardware rounds are rows 1-10 (``bin/trends.py --ingest``).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "RUNS_SCHEMA",
    "METRIC_SPECS",
    "run_record",
    "append_run",
    "load_runs",
    "check_regressions",
    "trend_table",
    "render_runs",
    "ingest_round_file",
    "ingest_paths",
    "postmortem_timeline",
    "set_run_info",
    "topology_fingerprint",
]

#: ledger record schema tag (every record carries it)
RUNS_SCHEMA = "fdtpu-runs/v1"

#: the gated metrics: direction + relative tolerance per metric.
#: ``higher_is_better`` decides which direction FAILS; movement past
#: tolerance in the good direction is a note (memory-baseline
#: semantics — re-record, don't gate).  Movement exactly AT tolerance
#: passes: the gate trips strictly beyond it.
METRIC_SPECS: Dict[str, Dict[str, Any]] = {
    "throughput": {"higher_is_better": True, "tolerance": 0.10},
    "mfu_pct": {"higher_is_better": True, "tolerance": 0.15},
    "steps_per_sec": {"higher_is_better": True, "tolerance": 0.10},
    "compile_seconds": {"higher_is_better": False, "tolerance": 0.50},
    "peak_hbm_bytes": {"higher_is_better": False, "tolerance": 0.10},
}


def topology_fingerprint(mesh=None, tag: str = "") -> str:
    """Digest of the topology a run's numbers belong to: the torch and
    CUDA versions, the device type and the card's name, the card count
    and the ranks of the process group, optionally the mesh shape and a
    caller tag (the JAX function digests jax, jaxlib and the TPU)."""
    import hashlib

    import torch

    if torch.cuda.is_available():
        kind, platform = torch.cuda.get_device_name(), "cuda"
        ndev = torch.cuda.device_count()
    else:
        kind, platform, ndev = "cpu", "cpu", 1
    ranks = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        ranks = torch.distributed.get_world_size()
    parts = [torch.__version__, str(torch.version.cuda), platform, kind,
             str(ndev), str(ranks)]
    if mesh is not None:
        parts.append(repr(sorted(dict(mesh.shape).items())))
    if tag:
        parts.append(tag)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def run_record(
    kind: str,
    *,
    fingerprint: Optional[str] = None,
    phase: Optional[str] = None,
    retryable: Optional[bool] = None,
    error: Optional[str] = None,
    metrics: Optional[Dict[str, float]] = None,
    stamps: Optional[Dict[str, Any]] = None,
    flight: Optional[str] = None,
    source: Optional[str] = None,
    ts: Optional[float] = None,
    **extra,
) -> dict:
    """Build one normalized ledger record.

    ``kind`` is the producer (``train`` / ``bench`` / ``multichip`` /
    ``episode``); ``metrics`` holds only FINITE numbers (everything
    else is dropped — NaN in a baseline poisons every later median);
    ``error`` marks the record dead for baseline purposes while keeping
    it forever as history.
    """
    clean_metrics: Dict[str, float] = {}
    for k, v in (metrics or {}).items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue
        if math.isfinite(fv):
            clean_metrics[k] = fv
    rec: dict = {
        "schema": RUNS_SCHEMA,
        "kind": str(kind),
        "ts": round(float(ts) if ts is not None else time.time(), 3),
        "fingerprint": fingerprint,
        "metrics": clean_metrics,
    }
    if phase is not None:
        rec["phase"] = phase
    if retryable is not None:
        rec["retryable"] = bool(retryable)
    if error:
        rec["error"] = str(error)[:500]
    if stamps:
        rec["stamps"] = stamps
    if flight:
        rec["flight"] = flight
    if source:
        rec["source"] = source
    rec.update(extra)
    return rec


def append_run(path: str, record: dict) -> bool:
    """Append one record as a JSON line, durably (flush + fsync).
    Best-effort by contract — the ledger must never be the reason a
    run, a bench round or a supervisor dies — so failures warn on
    stderr and return False instead of raising."""
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return True
    except Exception as e:  # noqa: BLE001 — the ledger is forensics
        print(f"obs.runs: append to {path} failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return False


def load_runs(path: str) -> List[dict]:
    """Read a ledger tolerantly: unparseable lines (a torn tail from a
    kill mid-append) are skipped, not fatal — this reader exists for
    exactly the files crashes leave behind."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except (json.JSONDecodeError, ValueError):
                    continue
                if isinstance(obj, dict):
                    out.append(obj)
    except OSError:
        return []
    return out


# ---------------------------------------------------------------------------
# regression gating
# ---------------------------------------------------------------------------


def _series(runs: Sequence[dict], metric: str) -> Dict[str, List[float]]:
    """Per-fingerprint value series (ledger order) of one metric over
    the runs that can honestly testify: records carrying ``error`` are
    history, not observations."""
    groups: Dict[str, List[float]] = {}
    for rec in runs:
        if rec.get("error"):
            continue
        v = (rec.get("metrics") or {}).get(metric)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            continue
        fp = rec.get("fingerprint") or "unknown"
        groups.setdefault(fp, []).append(float(v))
    return groups


def check_regressions(
    runs: Sequence[dict],
    specs: Optional[Dict[str, Dict[str, Any]]] = None,
    window: int = 5,
) -> dict:
    """Gate the NEWEST value of each (metric, topology) series against
    the rolling median of up to ``window`` predecessors.

    Returns ``{"failures", "notes", "rows"}``.  Failures are movement
    strictly beyond tolerance in the BAD direction (below for
    higher-is-better metrics, above for lower-is-better).  Notes cover
    everything an operator should see but CI must not gate on: a
    topology with no baseline yet (first run / unknown fingerprint),
    and movement past tolerance in the GOOD direction — the
    memory-baseline semantics, where a shrink means "re-record the
    baseline", not "fail the build".
    """
    specs = specs if specs is not None else METRIC_SPECS
    failures: List[str] = []
    notes: List[str] = []
    rows: List[dict] = []
    for metric, spec in specs.items():
        hib = bool(spec.get("higher_is_better", True))
        tol = float(spec.get("tolerance", 0.10))
        for fp, vals in sorted(_series(runs, metric).items()):
            short = fp[:12]
            if len(vals) < 2:
                notes.append(
                    f"{metric}@{short}: no baseline yet "
                    f"({len(vals)} observation) — first run on this "
                    "topology, nothing to gate against")
                rows.append({"metric": metric, "fingerprint": fp,
                             "n": len(vals), "newest": vals[-1],
                             "baseline": None, "verdict": "no-baseline"})
                continue
            newest = vals[-1]
            base_vals = vals[max(0, len(vals) - 1 - window):-1]
            baseline = statistics.median(base_vals)
            row = {"metric": metric, "fingerprint": fp, "n": len(vals),
                   "newest": newest, "baseline": baseline,
                   "tolerance": tol, "verdict": "ok"}
            if baseline == 0:
                row["verdict"] = "zero-baseline"
                notes.append(f"{metric}@{short}: zero baseline — "
                             "cannot express a relative tolerance")
                rows.append(row)
                continue
            ratio = newest / baseline
            # strictly beyond tolerance trips; exactly AT passes
            eps = 1e-12
            worse = ratio < (1 - tol) - eps if hib else (
                ratio > (1 + tol) + eps)
            better = ratio > (1 + tol) + eps if hib else (
                ratio < (1 - tol) - eps)
            if worse:
                row["verdict"] = "regression"
                failures.append(
                    f"{metric}@{short}: {newest:g} vs baseline "
                    f"{baseline:g} (x{ratio:.3f}) — beyond the "
                    f"{tol:.0%} tolerance in the bad direction")
            elif better:
                row["verdict"] = "improved"
                notes.append(
                    f"{metric}@{short}: {newest:g} vs baseline "
                    f"{baseline:g} (x{ratio:.3f}) — moved past "
                    f"tolerance in the GOOD direction; re-record the "
                    "baseline (memory-baseline semantics, not a "
                    "failure)")
            rows.append(row)
    return {"failures": failures, "notes": notes, "rows": rows}


def trend_table(runs: Sequence[dict], window: int = 5,
                specs: Optional[Dict[str, Dict[str, Any]]] = None) -> str:
    """Render the per-(metric, topology) trend rows as a text table."""
    verdicts = check_regressions(runs, specs=specs, window=window)
    lines = [f"{'metric':<18} {'topology':<14} {'n':>3} "
             f"{'baseline':>12} {'newest':>12} verdict",
             "-" * 72]
    for r in verdicts["rows"]:
        base = "-" if r.get("baseline") is None else f"{r['baseline']:g}"
        lines.append(
            f"{r['metric']:<18} {(r['fingerprint'] or 'unknown')[:12]:<14} "
            f"{r['n']:>3} {base:>12} {r['newest']:>12g} {r['verdict']}")
    if not verdicts["rows"]:
        lines.append("(no gateable observations yet — every record "
                     "carries an error, or no metrics matched)")
    return "\n".join(lines)


def render_runs(runs: Sequence[dict], limit: int = 20) -> str:
    """Render the newest ``limit`` ledger records, one line each."""
    lines = []
    for rec in runs[-limit:]:
        ts = time.strftime("%Y-%m-%d %H:%M",
                           time.localtime(rec.get("ts", 0)))
        fp = (rec.get("fingerprint") or "unknown")[:12]
        bits = [f"{ts}", f"{rec.get('kind', '?'):<10}", f"{fp:<12}"]
        m = rec.get("metrics") or {}
        if m:
            bits.append(" ".join(f"{k}={v:g}" for k, v in
                                 sorted(m.items())))
        if rec.get("phase"):
            bits.append(f"phase={rec['phase']}")
        if rec.get("retryable") is not None:
            bits.append(f"retryable={rec['retryable']}")
        if rec.get("error"):
            bits.append(f"ERROR: {rec['error'][:80]}")
        lines.append("  ".join(bits))
    return "\n".join(lines) if lines else "(empty ledger)"


# ---------------------------------------------------------------------------
# historical-round ingestion (BENCH_r*.json / MULTICHIP_r*.json backfill)
# ---------------------------------------------------------------------------


def _tail_error(tail: str) -> str:
    """Last non-empty line of a captured stdout/stderr tail — the raw
    pre-error-JSON rounds (r01) recorded only a traceback."""
    lines = [ln.strip() for ln in (tail or "").splitlines() if ln.strip()]
    return lines[-1][:300] if lines else "unknown"


def ingest_round_file(path: str) -> Optional[dict]:
    """One historical round file -> one ledger record.

    Handles both shapes the driver archived: ``BENCH_r*.json``
    (``{"n", "cmd", "rc", "tail", "parsed"}`` — ``parsed`` is the bench
    JSON line, null for pre-error-JSON rounds) and ``MULTICHIP_r*.json``
    (``{"n_devices", "rc", "ok", "skipped", "tail"}``).  Phase,
    retryable and probe_attempts are preserved verbatim; stamps ride
    whole except ``probe_logs`` (raw log tails stay in the archive
    files, the ledger keeps the counts)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    base = os.path.basename(path)
    try:
        ts = os.path.getmtime(path)
    except OSError:
        ts = time.time()

    if "n_devices" in doc:  # multichip probe round
        ok = bool(doc.get("ok"))
        return run_record(
            "multichip",
            source=base,
            ts=ts,
            error=None if ok else _tail_error(doc.get("tail", "")),
            rc=doc.get("rc"),
            n_devices=doc.get("n_devices"),
            skipped=doc.get("skipped"),
        )

    parsed = doc.get("parsed")
    if not isinstance(parsed, dict):
        # r01 shape: raw traceback only — the record still testifies
        return run_record(
            "bench",
            source=base,
            ts=ts,
            phase="unknown",
            error=_tail_error(doc.get("tail", "")),
            rc=doc.get("rc"),
            round=doc.get("n"),
        )
    metrics: Dict[str, float] = {}
    if parsed.get("value"):
        metrics["throughput"] = parsed["value"]
    if parsed.get("mfu_pct") is not None:
        metrics["mfu_pct"] = parsed["mfu_pct"]
    if parsed.get("compile_seconds"):
        metrics["compile_seconds"] = parsed["compile_seconds"]
    stamps = {k: parsed[k] for k in
              ("lint", "guard", "memory", "layout_pick", "pp_plan")
              if k in parsed}
    extra: dict = {"rc": doc.get("rc"), "round": doc.get("n")}
    for k in ("probe_attempts", "probe_last", "cache_hits",
              "cache_misses", "resumable", "unit"):
        if k in parsed:
            extra[k] = parsed[k]
    return run_record(
        "bench",
        source=base,
        ts=ts,
        phase=parsed.get("phase"),
        retryable=parsed.get("retryable"),
        error=parsed.get("error"),
        metrics=metrics,
        stamps=stamps or None,
        **extra,
    )


def ingest_paths(ledger: str, paths: Iterable[str],
                 dedupe: bool = True) -> Tuple[int, int]:
    """Ingest round files into ``ledger``; returns ``(added, skipped)``.
    Idempotent by ``source`` basename — re-running the backfill never
    duplicates history."""
    seen = {r.get("source") for r in load_runs(ledger)
            if r.get("source")} if dedupe else set()
    added = skipped = 0
    for p in sorted(paths):
        rec = ingest_round_file(p)
        if rec is None:
            skipped += 1
            continue
        if rec.get("source") in seen:
            skipped += 1
            continue
        if append_run(ledger, rec):
            seen.add(rec.get("source"))
            added += 1
        else:
            skipped += 1
    return added, skipped


# ---------------------------------------------------------------------------
# postmortem
# ---------------------------------------------------------------------------


def _fmt_flight_record(rec: dict) -> str:
    bits = []
    for key in ("step", "tick", "opt_step"):
        if key in rec:
            bits.append(f"{key}={rec[key]}")
    if "loss" in rec:
        bits.append(f"loss={rec['loss']:.5g}")
    if "guard_verdict" in rec:
        bits.append(f"guard={rec['guard_verdict']}")
    if "guard_z" in rec:
        bits.append(f"z={rec['guard_z']:.2f}")
    if rec.get("skipped"):
        bits.append("SKIPPED")
    if "headroom" in rec:
        bits.append(f"headroom={rec['headroom']:.1%}")
    ph = rec.get("phases") or {}
    if ph:
        bits.append("phases(ms) " + " ".join(
            f"{k}={1e3 * v:.0f}" for k, v in sorted(ph.items())))
    for key in ("emitted", "active_slots", "queue_depth", "oom_skipped",
                "compiles", "stalled"):
        if rec.get(key):
            bits.append(f"{key}={rec[key]}")
    return " ".join(bits) or json.dumps(
        {k: v for k, v in rec.items() if k not in ("kind", "t")})[:120]


def postmortem_timeline(
    flight_path: Optional[str] = None,
    supervisor_ledger: Optional[str] = None,
    bench_status: Optional[str] = None,
    runs_path: Optional[str] = None,
    tail: int = 12,
) -> str:
    """Merge the available evidence into ONE human-readable account of
    how a run/round died: the newest flight-dump records (step-level),
    the supervisor's episode ledger (process-level), the bench status
    file (phase-level) and the newest run-ledger row (history-level).
    Every source is optional and read tolerantly — the postmortem runs
    over whatever the crash left behind."""
    lines: List[str] = ["== fdtpu postmortem =="]
    verdict: Optional[str] = None

    if runs_path:
        runs = load_runs(runs_path)
        if runs:
            lines.append(f"-- run ledger ({runs_path}, {len(runs)} "
                         "records; newest last) --")
            lines.append(render_runs(runs, limit=3))

    if flight_path:
        lines.append(f"-- flight dump ({flight_path}) --")
        try:
            from .flight import read_flight

            fl = read_flight(flight_path)
        except OSError as e:
            fl = None
            lines.append(f"  unreadable: {type(e).__name__}: {e}")
        if fl is not None:
            hdr = fl.get("header") or {}
            recs = fl.get("records") or []
            flush_every = hdr.get("flush_every", "?")
            lines.append(
                f"  fingerprint={hdr.get('fingerprint')} "
                f"flush_every={flush_every} "
                f"records_flushed={len(recs)} torn={fl.get('torn', 0)}")
            for rec in recs[-tail:]:
                lines.append(f"  {_fmt_flight_record(rec)}")
            end = fl.get("end")
            if end is not None:
                lines.append(
                    f"  end: status={end.get('status')} "
                    f"records={end.get('records')}"
                    + (f" error={end.get('error')}" if end.get("error")
                       else ""))
                verdict = f"soft exit: {end.get('status')}"
            else:
                ck = fl.get("checkpoint") or {}
                lines.append(
                    "  end: MISSING — hard death (SIGKILL / os._exit / "
                    "power); the final record above is at most "
                    f"{flush_every} records (one flush interval) before "
                    "death"
                    + (f"; sidecar saw {ck.get('recorded')} recorded"
                       if ck else ""))
                verdict = "hard death mid-run (no flight footer)"

    if supervisor_ledger:
        lines.append(f"-- supervisor episodes ({supervisor_ledger}) --")
        try:
            with open(supervisor_ledger) as f:
                led = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            led = None
            lines.append(f"  unreadable: {type(e).__name__}: {e}")
        if isinstance(led, dict):
            for ep in led.get("episodes", []):
                lines.append(
                    f"  ep{ep.get('n')}: class={ep.get('class')} "
                    f"rc={ep.get('rc')} steps={ep.get('steps')} "
                    f"wall={ep.get('wall_seconds')}s -> "
                    f"{ep.get('action')}")
            lines.append(f"  result: {led.get('result')} "
                         f"(restarts={led.get('restarts')}, "
                         f"resumes={led.get('resumes')})")
            if led.get("result") and led.get("result") != "done":
                verdict = f"supervision ended: {led['result']}"

    if bench_status:
        lines.append(f"-- bench status ({bench_status}) --")
        try:
            with open(bench_status) as f:
                st = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            st = None
            lines.append(f"  unreadable: {type(e).__name__}: {e}")
        if isinstance(st, dict):
            lines.append(
                f"  phase={st.get('phase')} "
                f"compile_seconds={st.get('compile_seconds')} "
                f"cache_misses={st.get('cache_misses')}")
            if verdict is None:
                verdict = f"bench died in phase {st.get('phase')}"

    lines.append(f"verdict: {verdict or 'no evidence found'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the run-info stitch gauge
# ---------------------------------------------------------------------------


def set_run_info(registry, component: str, mode: str = "") -> None:
    """Register the ``fdtpu_run_info`` info-style gauge (value 1, the
    metadata in labels): topology fingerprint, component + spmd/layout
    mode, torch version and the flight/runs schema versions — the join
    key that lets a scrape, a flight dump and a ledger row be stitched
    to the SAME run.  Best-effort: a backend too dead to fingerprint
    must not take the registry down with it."""
    try:
        import torch

        from .flight import FLIGHT_SCHEMA, _lazy_fingerprint

        registry.gauge(
            "fdtpu_run_info",
            "info-style gauge (always 1): topology fingerprint, "
            "component/mode, torch version and obs schema versions — the "
            "stitch key between scrapes, flight dumps and run-ledger "
            "rows",
            labelnames=("component", "mode", "fingerprint", "torch",
                        "schemas"),
        ).labels(
            component=str(component),
            mode=str(mode or ""),
            fingerprint=_lazy_fingerprint() or "unknown",
            torch=torch.__version__,
            schemas=f"{FLIGHT_SCHEMA},{RUNS_SCHEMA}",
        ).set(1)
    except Exception as e:  # noqa: BLE001
        print(f"obs.runs: run_info gauge failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
