"""Port parity: the observation layer ``train()`` threads, the loggers and
the rest of ``tree.py``, against the JAX package where it has the same
function.

* ``tree.*`` equals ``fluxdistributed_tpu.tree`` on the same inputs:
  bitwise (sums and products in the same order); ``div`` by a Python
  number bitwise with the JAX function under ``jit`` (the constant's
  f32 reciprocal, as the reference's compiled steps divide), by a
  tensor bitwise with a true division (a traced value).
* A CPU training run with :meth:`Observation.full` fills the registry's
  ``fdtpu_train_*`` counters and the phase histogram, writes a Chrome
  trace whose phase spans nest inside an enclosing span (and the
  loader's ``h2d`` spans on its worker threads), a flight dump with one
  record an item and its phase split, and JSONL snapshots;
  ``profile_dir`` exports a ``torch.profiler`` Chrome trace.
* ``/metrics`` and ``/healthz`` answer mid-run from the CLI.
* The flight recorder rotates its ring, flushes at its cadence,
  tolerates a torn tail, and ``read_flight`` gives what the JAX reader
  gives on the same file.
* The stall watchdog fires, escalates and re-arms on a fake clock
  exactly as the JAX one does.
* ``WandbLogger`` works through a stub ``wandb`` module.
* Without a card the memory gauges read "unavailable" (``None``, 0,
  NaN), as the JAX module does on its CPU backend.
"""

import importlib
import json
import sys
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu import tree as jtree
from fluxdistributed_tpu.obs import runs as jruns
from fluxdistributed_tpu.obs.flight import read_flight as jread_flight
from fluxdistributed_tpu.obs.metrics import Registry as JRegistry
from fluxdistributed_tpu.obs.watchdog import StepWatchdog as JWatchdog
from fluxdistributed_tpu_torch import optim, tree
from fluxdistributed_tpu_torch.data import SyntheticDataset
from fluxdistributed_tpu_torch.models import SimpleCNN
from fluxdistributed_tpu_torch.obs import (FlightRecorder, HbmGauges,
                                           Observation, Registry,
                                           StepWatchdog, memstats,
                                           read_flight, runs)
from fluxdistributed_tpu_torch.train import (NullLogger, WandbLogger,
                                             current_logger,
                                             prepare_training, train,
                                             with_logger)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")


# ---------------------------------------------------------------- tree.*


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ({"a": mk(5, 7), "b": {"w": mk(300), "frozen": None}},
            {"a": mk(5, 7), "b": {"w": None, "frozen": mk(3)}})


def _torch_tree(t):
    return tree.tree_map(torch.from_numpy, t)


def _jax_tree(t):
    return jax.tree.map(lambda x: None if x is None else jnp.asarray(x), t,
                        is_leaf=lambda x: x is None)


def _same(got, ref, path=""):
    """Leaf by leaf, by key (jax flattens dicts in sorted key order)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same(got[k], ref[k], f"{path}/{k}")
    else:
        assert (got is None) == (ref is None), path
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          err_msg=path)


@pytest.mark.parametrize("fn", ["zeros_like", "accum", "div_const",
                                "div_tensor", "scale", "add_scaled", "mean"])
def test_tree_ops_match_jax(fn):
    a, b = _trees()
    ta, tb, ja, jb = _torch_tree(a), _torch_tree(b), _jax_tree(a), _jax_tree(b)
    if fn == "zeros_like":
        got, ref = tree.zeros_like(ta), jtree.zeros_like(ja)
    elif fn == "accum":
        got, ref = tree.accum(ta, tb), jtree.accum(ja, jb)
    elif fn == "div_const":
        got = tree.div(ta, 3.0)
        ref = jax.jit(lambda t: jtree.div(t, 3.0))(ja)
    elif fn == "div_tensor":
        got = tree.div(ta, torch.tensor(3.0))
        ref = jtree.div(ja, jnp.float32(3.0))
    elif fn == "scale":
        got, ref = tree.scale(ta, 0.3), jtree.scale(ja, 0.3)
    elif fn == "add_scaled":
        got, ref = tree.add_scaled(ta, tb, 0.5), jtree.add_scaled(ja, jb, 0.5)
    else:
        trees = [_trees(s)[0] for s in range(3)]
        got = tree.mean([_torch_tree(t) for t in trees])
        ref = jax.jit(jtree.mean)([_jax_tree(t) for t in trees])
    _same(got, ref)


def test_tree_div_rounds_as_the_constant_rule():
    """At 3 the reciprocal product differs from a true division in
    about a third of the entries: the test can tell the two apart."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    assert not torch.equal(tree.div({"x": x}, 3.0)["x"], x / 3.0)
    assert torch.equal(tree.div({"x": x}, torch.tensor(3.0))["x"], x / 3.0)


def test_tree_getfirst_and_synchronize_match_jax():
    t = {"layer": {"bias": 1, "inner": {"weight": 2}}, "weight": 3,
         "seq": [{"kernel": 4}]}
    for name in ("weight", "bias", "kernel", "absent"):
        assert tree.getfirst(t, name) == jtree.getfirst(t, name)
    ta = _torch_tree(_trees()[0])
    assert tree.synchronize(ta) is ta  # CPU leaves are ready


# ------------------------------------------------------ train() observed


class _Capture:
    def __init__(self):
        self.records, self.infos = [], []

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))

    def info(self, msg):
        self.infos.append(msg)


def _task(cycles=6, spc=1):
    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    return prepare_training(SimpleCNN(num_classes=10, device="cpu"), ds,
                            optim.momentum(0.1, 0.9), batch_size=8,
                            cycles=cycles, steps_per_call=spc,
                            val_dataset=ds, val_samples=16, device="cpu")


@pytest.fixture(scope="module")
def observed_run(tmp_path_factory):
    """One SimpleCNN run (6 items of 2 steps) under Observation.full on a
    fresh registry, inside an enclosing ``run`` span, with a flight
    recorder, JSONL snapshots, a schedule callback, eval and a
    checkpoint."""
    d = tmp_path_factory.mktemp("obs")
    reg = Registry()
    obs = Observation.full(trace_path=str(d / "trace.json"), registry=reg,
                           flight_path=str(d / "flight.jsonl"),
                           jsonl_path=str(d / "metrics.jsonl"))
    cap, seen = _Capture(), []
    t = _task(cycles=12, spc=2)
    with obs.tracer.span("run"):
        train(t, print_every=2, eval_every=3, topk=(1, 5), logger=cap,
              checkpoint_dir=str(d / "ck"), checkpoint_every=4,
              verbose=True, observation=obs,
              sched=lambda s: seen.append(s) or 0.1 * s)
    obs.tracer.export_chrome_trace(str(d / "trace.json"))
    return d, reg, cap, seen, t


def test_observed_run_fills_the_registry(observed_run):
    _, reg, cap, seen, t = observed_run
    assert t.state.step == 12
    assert reg.value("fdtpu_train_steps_total") == 12
    assert reg.value("fdtpu_train_step") == 12
    text = reg.prometheus_text()
    for phase in ("data_wait", "dispatch", "eval", "checkpoint"):
        assert f'fdtpu_train_phase_seconds_count{{phase="{phase}"}}' in text
    assert "fdtpu_train_step_seconds_count 6" in text
    assert 'fdtpu_run_info{component="train"' in text
    assert "fdtpu_hbm_available 0" in text
    assert 'torch="' + torch.__version__ in text
    # the schedule is called once an item, in optimizer steps, and
    # logged with verbose; topk reaches the eval lines
    assert seen == [0, 2, 4, 6, 8, 10]
    lrs = [m["lr"] for _, m in cap.records if "lr" in m]
    assert lrs == pytest.approx([0.1 * s for s in seen])
    evals = [m for _, m in cap.records if "val_loss" in m]
    assert evals and set(evals[0]) == {"val_loss", "val_top1", "val_top5"}
    assert any("dispatching" in s for s in cap.infos)


def test_observed_run_writes_nested_spans_and_h2d_rows(observed_run):
    d = observed_run[0]
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    run = [e for e in events if e["name"] == "run"]
    assert len(run) == 1
    run = run[0]
    phases = [e for e in events if e["name"] in ("data_wait", "dispatch",
                                                 "eval", "checkpoint")]
    assert {e["name"] for e in phases} == {"data_wait", "dispatch", "eval",
                                           "checkpoint"}
    for e in phases:
        assert e["tid"] == run["tid"]
        assert run["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                         <= run["ts"] + run["dur"])
    h2d = [e for e in events if e["name"] == "h2d"]
    assert len(h2d) == 6 and all(e["tid"] != run["tid"] for e in h2d)
    assert sorted(e["args"]["batch"] for e in h2d) == list(range(6))


def test_observed_run_flight_and_jsonl(observed_run):
    d = observed_run[0]
    fl = read_flight(str(d / "flight.jsonl"))
    assert [r["step"] for r in fl["records"]] == list(range(6))
    assert all({"data_wait", "dispatch"} <= set(r["phases"])
               for r in fl["records"])
    assert fl["records"][-1]["opt_step"] == 12
    assert fl["end"]["status"] == "done" and fl["torn"] == 0
    lines = (d / "metrics.jsonl").read_text().splitlines()
    assert len(lines) >= 2 and json.loads(lines[-1])["final"] is True


def test_profile_dir_exports_a_chrome_trace(tmp_path):
    t = _task()
    cap = _Capture()
    train(t, print_every=0, eval_every=0, logger=cap,
          profile_dir=str(tmp_path), profile_start=1, profile_steps=2)
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert any("profiler trace written" in s for s in cap.infos)


def test_observation_default_and_unported_options():
    obs = Observation.default()
    assert obs.tracer is None and obs.watchdog is None
    assert obs.device_sync is False and obs.flight is None
    full = Observation.full()
    assert full.device_sync is True and full.tracer is not None
    # the steady-state flag reads obs.jaxmon's counters, now ported
    assert Observation(steady_after=3).steady_after == 3
    assert Observation.full(steady_after=2).steady_after == 2
    # the cost profile is ported: train() writes it when it ends
    assert Observation.full(profile_path="p.json").profile_path == "p.json"


def test_metrics_and_healthz_answer_mid_run_from_the_cli(monkeypatch,
                                                         capsys):
    """The CLI with --metrics-port 0: a scraper thread reads /metrics and
    /healthz while a fault plan holds item 3 for a second (the fault
    fires before the item is drawn, so 3 steps have run)."""
    from fluxdistributed_tpu_torch import obs as obs_pkg

    started, servers = threading.Event(), []
    real = obs_pkg.start_metrics_server

    def spy(**kw):
        srv = real(**kw)
        servers.append(srv)
        started.set()
        return srv

    monkeypatch.setattr(obs_pkg, "start_metrics_server", spy)
    scraped = {}

    def scrape():
        started.wait(60)
        base = f"http://127.0.0.1:{servers[0].port}"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            text = urllib.request.urlopen(base + "/metrics").read().decode()
            if "fdtpu_train_step 3" in text.splitlines():
                scraped["metrics"] = text
                scraped["health"] = json.loads(
                    urllib.request.urlopen(base + "/healthz").read())
                return
            time.sleep(0.05)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    rc = cli.main(["--model", "SimpleCNN", "--image-size", "8",
                   "--num-classes", "4", "--batch-size", "8", "--cycles", "6",
                   "--print-every", "0", "--eval-every", "0",
                   "--metrics-port", "0", "--guard", "--device", "cpu",
                   "--fault-plan", json.dumps({"fail": [
                       {"site": "step", "at": 3, "action": "sleep",
                        "delay": 1.0}]})])
    th.join(60)
    assert rc == 0
    assert "fdtpu_guard_quarantine_size 0" in scraped["metrics"]
    assert "fdtpu_hbm_headroom_ratio" in scraped["metrics"]
    h = scraped["health"]
    # the process registry's counters add up over the runs of this
    # process; the run's own gauge reads 3 during the held item
    assert h["ok"] is True and h["steps"] >= 3 and h["quarantined"] == 0
    assert "metrics: http://" in capsys.readouterr().out


# ------------------------------------------------------ flight recorder


def test_flight_rotates_flushes_and_reads_as_jax_reads(tmp_path):
    p = str(tmp_path / "f.jsonl")
    fr = FlightRecorder(p, ring=4, flush_every=3, fingerprint="fp",
                        meta={"component": "test"})
    for i in range(10):
        fr.record(step=i, loss=1.0 / (i + 1))
    assert [r["step"] for r in fr.records()] == [6, 7, 8, 9]  # the ring
    assert fr.recorded == 10 and fr.flushed == 9  # one record pending
    with open(p, "a") as f:
        f.write('{"kind": "record", "step": 10, "trunc')  # the tear
    got, ref = read_flight(p), jread_flight(p)
    assert got == ref
    assert [r["step"] for r in got["records"]] == list(range(9))
    assert got["torn"] == 1 and got["end"] is None
    assert got["checkpoint"]["flushed"] == 9
    p2 = str(tmp_path / "g.jsonl")
    fr = FlightRecorder(p2, flush_every=4, fingerprint="fp")
    for i in range(5):
        fr.record(step=i)
    fr.dump("done", steps=5)
    fr.record(step=99)  # after the dump: dropped
    got = read_flight(p2)
    assert got == jread_flight(p2)
    assert [r["step"] for r in got["records"]] == list(range(5))
    assert got["end"]["status"] == "done" and got["end"]["records"] == 5


# ------------------------------------------------------------- watchdog


def _drive_watchdog(cls, reg, monkeypatch, clock):
    events = []
    w = cls(factor=2.0, min_interval=0.01, warmup=2, registry=reg,
            escalate_after=2,
            on_stall=lambda e, th: events.append(("stall", e, th)),
            on_escalate=lambda e, th: events.append(("escalate", e, th)))
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    out = []
    for i in range(8):
        clock[0] += 0.1 + 0.01 * (i % 3)
        w.beat()
    out.append(w.threshold())
    for dt in (0.05, 0.3, 0.1, 0.5, 1.0):
        clock[0] += dt
        out.append((w.poll(), reg.value("fdtpu_watchdog_stalled")))
    with w.pause():
        clock[0] += 10.0
        out.append(w.poll())
    w.beat()
    out.append((reg.value("fdtpu_watchdog_stalls_total"),
                reg.value("fdtpu_watchdog_escalations_total"),
                reg.value("fdtpu_watchdog_stalled")))
    return out, events


def test_watchdog_on_a_fake_clock_matches_jax(monkeypatch):
    got, ev = _drive_watchdog(StepWatchdog, Registry(), monkeypatch, [100.0])
    ref, jev = _drive_watchdog(JWatchdog, JRegistry(), monkeypatch, [100.0])
    assert got == ref and ev == jev
    assert [e[0] for e in ev] == ["stall", "escalate"]
    assert got[-1] == (1, 1, 0)


# --------------------------------------------------------------- loggers


def test_wandb_logger_through_a_stub(monkeypatch):
    calls = []

    class _Config(dict):
        def update(self, d, allow_val_change=False):
            calls.append(("config", dict(d), allow_val_change))

    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: (calls.append(("init", kw))
                              or types.SimpleNamespace(config=_Config()))
    stub.log = lambda metrics, step: calls.append(("log", metrics, step))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    lg = WandbLogger(config={"model": "resnet50"}, project="p")
    lg.log({"loss": 1.5}, 3)
    lg.log_config({"ranks": 2})
    assert calls == [("init", {"project": "p",
                               "config": {"model": "resnet50"}}),
                     ("log", {"loss": 1.5}, 3),
                     ("config", {"ranks": 2}, True)]
    monkeypatch.delitem(sys.modules, "wandb")
    monkeypatch.setattr("builtins.__import__", _refuse("wandb"))
    with pytest.raises(ImportError):
        WandbLogger()


def _refuse(name):
    real = __import__

    def imp(n, *a, **kw):
        if n == name:
            raise ImportError(f"no module named {name}")
        return real(n, *a, **kw)

    return imp


def test_with_logger_routes_current_logger():
    inner = NullLogger()
    outer = current_logger()
    with with_logger(inner) as lg:
        assert lg is inner and current_logger() is inner
    assert current_logger() is outer


# ------------------------------------------------- memory gauges, ledger


def test_memory_gauges_read_unavailable_without_a_card():
    assert memstats.hbm_device_stats() is None
    assert memstats.min_headroom_ratio() is None
    assert memstats.hbm_summary() == {"available": False}
    reg = Registry()
    g = HbmGauges(reg)
    assert g.available is False
    assert reg.value("fdtpu_hbm_available") == 0
    assert "fdtpu_hbm_bytes_in_use" not in reg.prometheus_text()
    g.close()
    t = _task()
    sb = memstats.state_bytes(t.state)
    assert sb["param_bytes"] == sum(p.numel() * 4 for p in
                                    t.state.params.values())
    assert sb["total_bytes"] == (sb["param_bytes"] + sb["opt_state_bytes"]
                                 + sb["model_state_bytes"])


def test_runs_ledger_matches_jax(tmp_path):
    p = str(tmp_path / "runs.jsonl")
    recs = []
    for i, v in enumerate((100.0, 101.0, 99.0, 80.0)):
        kw = dict(fingerprint="fp", phase="train",
                  metrics={"throughput": v, "bad": float("nan")},
                  ts=1000.0 + i)
        a, b = runs.run_record("train", **kw), jruns.run_record("train", **kw)
        assert a == b
        assert runs.append_run(p, a)
        recs.append(a)
    with open(p, "a") as f:
        f.write('{"torn')
    assert runs.load_runs(p) == jruns.load_runs(p) == recs
    assert runs.check_regressions(recs) == jruns.check_regressions(recs)
    assert runs.trend_table(recs) == jruns.trend_table(recs)
    fp = runs.topology_fingerprint()
    assert len(fp) == 16 and fp == runs.topology_fingerprint()
