"""Graceful drain and the operability hooks of the port's serving stack
(``fluxdistributed_tpu_torch.serve``) on the CPU, against the JAX
package's.

The first four tests are ``tests/test_serve_drain.py``'s on the port's
``Scheduler`` and ``LMServer``: admissions stop (``Draining`` -> HTTP
503, distinct from 429 backpressure), in-flight requests finish within
the drain timeout, ``/healthz`` reports 503 with ``draining: true`` for
the whole window, and SIGTERM runs the drain and stops the HTTP server.
The router's rolling restart rests on them.

The rest hold the scheduler's hooks to the JAX scheduler's on the same
``FakeLMEngine`` stream: the ``serve.tick`` fault site, the per-tick
flight record and its ``closed`` footer, and the replica's ``/metrics``
series names (the HBM gauges and the run-info gauge included).
"""

from __future__ import annotations

import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from fluxdistributed_tpu import faults as jfaults
from fluxdistributed_tpu.obs.flight import FlightRecorder as JFlight
from fluxdistributed_tpu.serve import Request as JRequest
from fluxdistributed_tpu.serve import Scheduler as JScheduler
from fluxdistributed_tpu.serve.server import LMServer as JLMServer
from fluxdistributed_tpu.serve.testing import FakeLMEngine as JFake
from fluxdistributed_tpu_torch import faults
from fluxdistributed_tpu_torch.obs.flight import FlightRecorder, read_flight
from fluxdistributed_tpu_torch.serve import Draining, Request, Scheduler
from fluxdistributed_tpu_torch.serve.server import LMServer
from fluxdistributed_tpu_torch.serve.testing import FakeLMEngine, fake_tokens


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear_plan()
    jfaults.clear_plan()


class FakeEngine:
    """Pure-python engine: decode emits token 1 per live slot; a small
    sleep per step gives the drain window measurable width."""

    max_slots = 2

    def __init__(self, step_delay=0.0):
        self.step_delay = step_delay

    def validate_request(self, prompt_len, max_new_tokens):
        pass

    def prefill(self, slot, prompt, temperature, key):
        return 7, 8

    def step_decode(self):
        if self.step_delay:
            time.sleep(self.step_delay)
        return [1] * self.max_slots

    def reset_slot(self, slot):
        pass

    def compile_stats(self):
        return {"decode_compiles": 1, "prefill_compiles": 1,
                "insert_compiles": 1}


def test_drain_finishes_inflight_then_refuses_admissions():
    sched = Scheduler(FakeEngine(step_delay=0.005), max_queue=8)
    srv = LMServer(sched, vocab=256)
    reqs = [Request(prompt=[1, 2], max_new_tokens=20) for _ in range(3)]
    for r in reqs:
        sched.submit(r)
    srv.start_loop()
    try:
        drained = srv.drain(timeout=10.0)
        assert drained is True
        assert all(r.done.is_set() for r in reqs)
        assert all(len(r.generated) == 20 for r in reqs), (
            "drain must FINISH in-flight decodes, not abort them")
        with pytest.raises(Draining):
            sched.submit(Request(prompt=[3], max_new_tokens=2))
        assert sched.registry.value("fdtpu_serve_draining") == 1
    finally:
        srv.close()


def test_drain_timeout_cuts_short_and_reports_false():
    sched = Scheduler(FakeEngine(step_delay=0.05), max_queue=8)
    srv = LMServer(sched, vocab=256)
    req = Request(prompt=[1], max_new_tokens=10_000)
    sched.submit(req)
    srv.start_loop()
    try:
        t0 = time.monotonic()
        drained = srv.drain(timeout=0.3)
        assert drained is False
        assert time.monotonic() - t0 < 5.0
        assert not req.done.is_set()  # client sees its own timeout
    finally:
        srv.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_and_submit_report_503_while_draining():
    sched = Scheduler(FakeEngine(step_delay=0.02), max_queue=8)
    srv = LMServer(sched, vocab=256)
    httpd = srv.serve("127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        code, body = _get(f"{base}/healthz")
        assert code == 200 and body["ok"] and not body["draining"]
        # park one long request so the drain window is observable
        sched.submit(Request(prompt=[1], max_new_tokens=200))
        sched.begin_drain()
        code, body = _get(f"{base}/healthz")
        assert code == 503
        assert body["draining"] is True and body["ok"] is False
        code, body = _post(f"{base}/v1/generate",
                           {"prompt_tokens": [1, 2], "max_tokens": 2})
        assert code == 503, body
        assert body.get("draining") is True
        assert srv.drain(timeout=30.0) is True
    finally:
        httpd.shutdown()
        srv.close()


def test_sigterm_handler_drains_and_stops_http():
    """The serve CLI's wiring end-to-end in-process: SIGTERM -> drain ->
    httpd.shutdown -> serve_forever returns -> exit 0 path."""
    sched = Scheduler(FakeEngine(step_delay=0.01), max_queue=8)
    srv = LMServer(sched, vocab=256)
    httpd = srv.serve("127.0.0.1", 0)
    req = Request(prompt=[1, 2], max_new_tokens=30)
    sched.submit(req)
    uninstall = srv.install_drain_handler(httpd=httpd, timeout=10.0)
    served = threading.Event()

    def run():
        httpd.serve_forever()
        served.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert served.wait(timeout=30), "SIGTERM must stop serve_forever"
        assert req.done.is_set()
        assert len(req.generated) == 30
        assert sched.draining
    finally:
        uninstall()
        srv.close()


# ---------------------------------------------------------------------------
# the scheduler's hooks, held to the JAX scheduler's
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4], [1, 5], [9, 2, 6, 5], [3, 5, 8]]


def _drive(fake_cls, sched_cls, req_cls, **kw):
    """Two slots, four requests of 6 tokens: tick until idle; returns
    the scheduler, its requests and the ticks it took."""
    sched = sched_cls(fake_cls(max_slots=2, max_len=64), max_queue=8, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=6) for p in PROMPTS]
    for r in reqs:
        sched.submit(r)
    ticks = 0
    while not sched.idle:
        sched.step()
        ticks += 1
    return sched, reqs, ticks


def test_fake_engine_streams_match_jax():
    """The port's ``FakeLMEngine`` under the port's scheduler gives the
    JAX fake's streams under the JAX scheduler, tick for tick, and both
    equal ``fake_tokens``."""
    js, jreqs, jticks = _drive(JFake, JScheduler, JRequest)
    ps, preqs, pticks = _drive(FakeLMEngine, Scheduler, Request)
    assert pticks == jticks
    for p, jr, pr in zip(PROMPTS, jreqs, preqs):
        assert pr.generated == jr.generated == fake_tokens(p, 6)
    assert ps.engine.compile_stats() == js.engine.compile_stats()


@pytest.mark.parametrize("at", [0, 3, 7])
def test_serve_tick_fault_stops_the_loop_at_tick_k(at):
    """A plan that raises at ``serve.tick`` index k stops the engine
    loop at tick k, before that tick does any work — as the JAX
    scheduler's hook does."""
    out = {}
    for name, fx, fake, sched_cls, req_cls in (
            ("jax", jfaults, JFake, JScheduler, JRequest),
            ("port", faults, FakeLMEngine, Scheduler, Request)):
        fx.install_plan(fx.FaultPlan().fail("serve.tick", at=at))
        sched = sched_cls(fake(max_slots=2, max_len=64), max_queue=8)
        reqs = [req_cls(prompt=p, max_new_tokens=20) for p in PROMPTS]
        for r in reqs:
            sched.submit(r)
        done = 0
        with pytest.raises(fx.FaultInjected):
            for _ in range(100):
                sched.step()
                done += 1
        out[name] = (done, [list(r.generated) for r in reqs])
        fx.clear_plan()
    assert out["port"][0] == at
    assert out["port"] == out["jax"]


def _flight_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_flight_record_per_tick_matches_jax(tmp_path):
    """One flight record per tick with JAX's fields (tick, emitted,
    active_slots, queue_depth, chunks), equal to the JAX scheduler's
    record for record, and the ``closed`` footer on ``close()``."""
    rows = {}
    for name, rec_cls, fake, sched_cls, req_cls in (
            ("jax", JFlight, JFake, JScheduler, JRequest),
            ("port", FlightRecorder, FakeLMEngine, Scheduler, Request)):
        path = str(tmp_path / f"{name}.jsonl")
        fl = rec_cls(path, flush_every=4, fingerprint="fp")
        sched, _, ticks = _drive(fake, sched_cls, req_cls, flight=fl)
        sched.close()
        rows[name] = _flight_rows(path)
    keys = ("tick", "emitted", "active_slots", "queue_depth", "chunks")
    recs = {n: [{k: r[k] for k in keys} for r in rs if r["kind"] == "record"]
            for n, rs in rows.items()}
    assert recs["port"] == recs["jax"]
    assert [r["tick"] for r in recs["port"]] == list(range(ticks))
    assert sum(r["emitted"] for r in recs["port"]) == 6 * len(PROMPTS)
    for rs in rows.values():
        assert rs[-1]["kind"] == "end" and rs[-1]["status"] == "closed"
        assert rs[-1]["ticks"] == ticks
    end = read_flight(str(tmp_path / "port.jsonl"))["end"]
    assert end["status"] == "closed"


def _series(text):
    """Family names of a Prometheus page (its ``# TYPE`` lines)."""
    return {line.split(" ")[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _run_info(text):
    line = next(x for x in text.splitlines()
                if x.startswith("fdtpu_run_info{"))
    return dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', line))


def test_replica_metrics_series_match_jax():
    """A port replica's ``/metrics`` carries the JAX replica's series
    names on the same ``FakeLMEngine`` traffic: the serve series, the
    HBM gauges (on the CPU the availability flag and NaN headroom) and
    ``fdtpu_run_info``, whose labels name torch where JAX's name jax."""
    pages = {}
    for name, fake, sched_cls, srv_cls in (
            ("jax", JFake, JScheduler, JLMServer),
            ("port", FakeLMEngine, Scheduler, LMServer)):
        srv = srv_cls(sched_cls(fake(max_slots=2, max_len=64)), vocab=256)
        httpd = srv.serve("127.0.0.1", 0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, body = _post(f"{base}/v1/generate",
                               {"prompt_tokens": [1, 2], "max_tokens": 3})
            assert code == 200 and body["generated"] == fake_tokens(
                [1, 2], 3)
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                pages[name] = r.read().decode()
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.close()
    assert _series(pages["port"]) == _series(pages["jax"])
    assert {"fdtpu_hbm_available", "fdtpu_hbm_headroom_ratio",
            "fdtpu_run_info"} <= _series(pages["port"])
    lines = pages["port"].splitlines()
    assert "fdtpu_hbm_available 0" in lines
    assert "fdtpu_hbm_headroom_ratio nan" in lines
    jinfo, pinfo = _run_info(pages["jax"]), _run_info(pages["port"])
    assert set(jinfo) - {"jax"} == set(pinfo) - {"torch"}
    assert pinfo["component"] == jinfo["component"] == "serve"


def test_serve_cli_operability_flags_match_bin_serve():
    """``python -m fluxdistributed_tpu_torch.serve`` takes
    ``bin/serve.py``'s five operability flags with their defaults."""
    import importlib.util
    from pathlib import Path

    from fluxdistributed_tpu_torch.serve import __main__ as cli

    path = Path(__file__).resolve().parents[1] / "bin" / "serve.py"
    spec = importlib.util.spec_from_file_location("bin_serve_ref", path)
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type)
                for a in parser._actions}

    j, p = flags(jcli.build_parser()), flags(cli.build_parser())
    for dest in ("trace_requests", "drain_timeout", "fault_plan",
                 "fake_engine", "fake_step_delay"):
        assert p[dest] == j[dest], dest
