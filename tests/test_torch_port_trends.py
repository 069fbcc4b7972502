"""``python -m fluxdistributed_tpu_torch.obs.trends`` against the JAX
package's ``bin/trends.py`` on the CPU.

Both CLIs run in this process on the same inputs: a synthetic ledger
of three topologies made with the port's :mod:`obs.runs` from a seed,
the same ledger with a planted regression or a good-direction move, the
repository's archived ``BENCH_r*.json`` / ``MULTICHIP_r*.json`` round
files, and a postmortem over a flight dump the port's scheduler left
behind, a supervisor ledger the port's ``Supervisor`` wrote and a bench
status file.  Their exit codes, standard output and standard error
must be equal; the one difference of form (the default ledger path, the
port's own) shows only without ``--ledger``.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import random
import sys
from pathlib import Path

import pytest

from fluxdistributed_tpu_torch.obs import runs, trends
from fluxdistributed_tpu_torch.obs.flight import FlightRecorder
from fluxdistributed_tpu_torch.serve import Request, Scheduler
from fluxdistributed_tpu_torch.serve.testing import FakeLMEngine
from fluxdistributed_tpu_torch.supervise import Supervisor

ROOT = Path(__file__).resolve().parents[1]


def _load_jax_trends():
    spec = importlib.util.spec_from_file_location(
        "bin_trends_reference", ROOT / "bin" / "trends.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_trends = _load_jax_trends()


def _ledger(path, seed=0, tail=None):
    """Three topologies x six seeded rounds (one dead round each), and
    ``tail`` (a metrics dict) appended to the first topology."""
    rng = random.Random(seed)
    fps = [runs.topology_fingerprint(tag=f"cell{i}") for i in range(3)]
    t = 1_700_000_000.0
    for k in range(6):
        for i, fp in enumerate(fps):
            t += 60.0
            metrics = {
                "throughput": 1000.0 * (i + 1) * (1 + rng.uniform(-.03, .03)),
                "mfu_pct": 40.0 * (1 + rng.uniform(-.05, .05)),
                "peak_hbm_bytes": 2e10 * (1 + rng.uniform(-.02, .02)),
            }
            runs.append_run(str(path), runs.run_record(
                "bench", fingerprint=fp, ts=t, metrics=metrics,
                phase="measure",
                error="tunnel reset" if k == 2 and i == 1 else None,
                round=k))
    if tail is not None:
        runs.append_run(str(path), runs.run_record(
            "bench", fingerprint=fps[0], ts=t + 60.0, metrics=tail,
            phase="measure", round=6))
    return fps


def _both(capsys, argv):
    """Each CLI's (rc, stdout, stderr) on ``argv``."""
    out = {}
    for name, mod in (("jax", jax_trends), ("port", trends)):
        rc = mod.main(list(argv))
        got = capsys.readouterr()
        out[name] = (rc, got.out, got.err)
    return out


@pytest.mark.parametrize("flags", [
    [], ["--window", "2"], ["--limit", "4"], ["--check"],
], ids=["default", "window2", "limit4", "check_clean"])
def test_default_view_matches_jax(tmp_path, capsys, flags):
    ledger = tmp_path / "runs.jsonl"
    _ledger(ledger)
    out = _both(capsys, ["--ledger", str(ledger), *flags])
    assert out["port"] == out["jax"]
    rc, text, _ = out["port"]
    assert rc == 0
    assert f"== {ledger}: 18 record(s) ==" in text
    if "--check" in flags:
        assert "check: no regressions" in text


@pytest.mark.parametrize("factor,rc,marker", [
    (0.8, 2, "REGRESSION: throughput@"),
    (1.3, 0, "GOOD direction"),
], ids=["regression", "good_direction"])
def test_check_gates_like_jax(tmp_path, capsys, factor, rc, marker):
    """A throughput 20 % below its topology's rolling median exits 2; 30
    % above it exits 0 with a note, in both CLIs."""
    ledger = tmp_path / "runs.jsonl"
    _ledger(ledger, tail={"throughput": 1000.0 * factor})
    out = _both(capsys, ["--ledger", str(ledger), "--check"])
    assert out["port"] == out["jax"]
    got_rc, text, _ = out["port"]
    assert got_rc == rc
    assert marker in text


def test_missing_ledger_exits_1_like_jax(tmp_path, capsys):
    out = _both(capsys, ["--ledger", str(tmp_path / "none.jsonl")])
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1
    # the one difference of form: the default ledger is the port's own
    assert trends.DEFAULT_LEDGER == str(ROOT / "runs_torch.jsonl")
    assert jax_trends.DEFAULT_LEDGER == str(
        ROOT / "benchmarks" / "hw" / "runs.jsonl")


def test_ingest_round_files_like_jax(tmp_path, capsys):
    """``--ingest`` of the repository's archived round files writes the
    same records, says the same, and is idempotent in both."""
    pats = [str(ROOT / "BENCH_r*.json"), str(ROOT / "MULTICHIP_r*.json")]
    assert glob.glob(pats[0]) and glob.glob(pats[1])
    ledger = tmp_path / "ingested.jsonl"
    seen = {}
    for name, mod in (("jax", jax_trends), ("port", trends)):
        if ledger.exists():
            ledger.unlink()
        first = mod.main(["--ledger", str(ledger), "--ingest", *pats])
        first_out = capsys.readouterr().out
        again = mod.main(["--ledger", str(ledger), "--ingest", *pats])
        again_out = capsys.readouterr().out
        view = mod.main(["--ledger", str(ledger)])
        view_out = capsys.readouterr().out
        recs = [json.loads(x) for x in ledger.read_text().splitlines()]
        seen[name] = (first, first_out, again, again_out, view, view_out,
                      recs)
    assert seen["port"] == seen["jax"]
    first, first_out, again, again_out, view, _, recs = seen["port"]
    assert first == again == view == 0
    assert f"ingested {len(recs)} record(s)" in first_out
    assert len(recs) == 10
    assert "ingested 0 record(s)" in again_out


def _serve_flight(path):
    """A flight dump the port's scheduler leaves behind when its
    process dies hard: per-tick records, no footer."""
    fl = FlightRecorder(str(path), flush_every=4, fingerprint="fp-serve")
    sched = Scheduler(FakeLMEngine(max_slots=2, max_len=64), flight=fl)
    for p in ([3, 1, 4], [1, 5], [9, 2, 6]):
        sched.submit(Request(prompt=p, max_new_tokens=5))
    for _ in range(9):
        sched.step()
    fl.flush()


def _supervisor_ledger(path):
    sup = Supervisor([sys.executable, "-c", "pass"], ledger=str(path),
                     verbose=False)
    sup.episodes = [
        {"n": 1, "class": "preempted", "rc": 75, "steps": 12,
         "wall_seconds": 30.5, "action": "resume"},
        {"n": 2, "class": "crash", "rc": 1, "steps": 3,
         "wall_seconds": 4.25, "action": "restart"},
    ]
    sup.restarts, sup.resumes = 1, 1
    sup.write_ledger("gave_up")


@pytest.mark.parametrize("parts", [
    ("flight",), ("supervisor",), ("bench",),
    ("flight", "supervisor", "bench", "ledger"),
], ids=["flight", "supervisor", "bench", "all"])
def test_postmortem_like_jax(tmp_path, capsys, parts):
    flight = tmp_path / "flight.jsonl"
    sup = tmp_path / "supervisor.json"
    status = tmp_path / "status.json"
    ledger = tmp_path / "runs.jsonl"
    _serve_flight(flight)
    _supervisor_ledger(sup)
    status.write_text(json.dumps({"phase": "compile",
                                  "compile_seconds": 41.5,
                                  "cache_misses": 3}))
    _ledger(ledger)
    argv = ["--postmortem",
            "--ledger", str(ledger if "ledger" in parts
                            else tmp_path / "none.jsonl")]
    if "flight" in parts:
        argv += ["--flight", str(flight)]
    if "supervisor" in parts:
        argv += ["--supervisor-ledger", str(sup)]
    if "bench" in parts:
        argv += ["--bench-status", str(status)]
    out = _both(capsys, argv)
    assert out["port"] == out["jax"]
    rc, text, _ = out["port"]
    assert rc == 0 and text.startswith("== fdtpu postmortem ==")
    verdict = text.strip().splitlines()[-1]
    if "supervisor" in parts:
        assert verdict == "verdict: supervision ended: gave_up"
    elif "flight" in parts:
        assert verdict == "verdict: hard death mid-run (no flight footer)"
        assert "tick=8" in text
    else:
        assert verdict == "verdict: bench died in phase compile"
    if "ledger" in parts:
        assert "-- run ledger" in text


def test_trends_flags_match_bin_trends():
    """Every flag of ``bin/trends.py`` is the port CLI's, with the same
    defaults apart from the ledger path."""
    import argparse

    def flags(main):
        seen = {}

        class Stop(Exception):
            pass

        def capture(self, args=None, namespace=None):
            seen.update({a.dest: (tuple(a.option_strings), a.default)
                         for a in self._actions})
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = capture
        try:
            main([])
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    j, p = flags(jax_trends.main), flags(trends.main)
    assert set(j) == set(p)
    for dest in j:
        if dest == "ledger":
            assert j[dest][0] == p[dest][0]
        else:
            assert j[dest] == p[dest], dest
    assert os.path.basename(p["ledger"][1]) == "runs_torch.jsonl"
