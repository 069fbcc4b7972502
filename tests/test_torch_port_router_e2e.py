"""The port's router end to end over replica PROCESSES on the CPU.

``tests/test_torch_port_router.py`` proves the state machines in one
process; this file proves them against real process death.  Replicas
are ``python -m fluxdistributed_tpu_torch.serve`` subprocesses spawned
through ``SupervisedReplica`` (the ``--port 0`` + ``FDTPU_SERVE_PORT=``
contract), started one after another; the mid-burst kill is a
deterministic fault plan (``serve.tick`` -> ``exit``, the SIGKILL/OOM
shape: no drain, no goodbye).

Three tests, each about processes: the kill and the breaker's recovery
over ``--fake-engine`` replicas (3 replica processes over the test), the
router CLI's ``--smoke`` as a subprocess (which spawns 5 replica
processes of its own, at most 2 alive at once), and a rolling restart
of two real ``lm_tiny`` replicas on the CPU (4 replica processes).  No
compile count is asserted on the CPU: the engine's decode graph exists
on the card only.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

from fluxdistributed_tpu_torch.serve.router import (Replica, Router,
                                                    SupervisedReplica,
                                                    wait_http_ready)
from fluxdistributed_tpu_torch.serve.testing import fake_tokens

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT)}
SERVE = [sys.executable, "-m", "fluxdistributed_tpu_torch.serve"]


def _fake_argv(extra=()):
    return [*SERVE, "--fake-engine", "--vocab", "256", "--max-slots", "4",
            "--max-len", "256", "--max-queue", "64",
            "--fake-step-delay", "0.004", "--port", "0", *extra]


def _spawn(argv, name, **kw):
    """One replica, started and healthy before the next is spawned.
    verbose=False: replica logs interleaving with pytest's progress
    lines corrupt the dot counting."""
    sup = SupervisedReplica(argv, name=name, env=ENV, verbose=False, **kw)
    url = sup.spawn()
    wait_http_ready(url + "/healthz", timeout=120)
    return sup, url


def _serve(router):
    httpd = router.serve("127.0.0.1", 0)
    threading.Thread(
        target=lambda: httpd.serve_forever(poll_interval=0.02),
        daemon=True).start()
    return httpd, f"http://127.0.0.1:{router.bound_port}"


def _post(base, body, rid=None, timeout=120):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(body).encode(),
        method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_kill_midburst_failover_and_breaker_recovery():
    """2-replica fleet over live HTTP, r0 hard-killed mid-burst by
    ``--fault-plan`` at scheduler tick 30.  Every request completes via
    failover with its X-Request-Id intact and byte-identical tokens; the
    dead replica's breaker opens; once r0 is respawned at its old port
    the breaker recovers."""
    kill_plan = json.dumps(
        {"fail": [{"site": "serve.tick", "at": 30, "action": "exit"}]})
    sup0, url0 = _spawn(_fake_argv(["--fault-plan", kill_plan]), "r0")
    sup1, url1 = _spawn(_fake_argv(), "r1")
    router = Router(
        [Replica("r0", url0, restart=sup0.restart),
         Replica("r1", url1, restart=sup1.restart)],
        probe_interval=3600.0, probe_timeout=5.0, failure_threshold=2,
        breaker_cooldown=0.2, dispatch_tries=4, dispatch_backoff=0.02,
        upstream_timeout=60.0)
    httpd, base = _serve(router)
    try:
        router.probe_now()
        results = {}

        def one(i):
            prompt = [i % 7 + 1, i % 5 + 1]
            try:
                results[i] = _post(
                    base, {"prompt_tokens": prompt, "max_tokens": 24},
                    rid=f"e2e-{i}")
            except Exception as e:  # noqa: BLE001 — asserted below
                results[i] = (None, f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, (code, body) in sorted(results.items()):
            assert code == 200, f"request {i}: {code} {body}"
            assert body["request_id"] == f"e2e-{i}"
            assert body["generated"] == fake_tokens(
                [i % 7 + 1, i % 5 + 1], 24)
        deadline = time.monotonic() + 15
        while sup0.alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not sup0.alive(), "the fault plan did not kill r0"
        r0 = router.replicas[0]
        router.probe_now()
        router.probe_now()
        assert r0.breaker == "open"
        assert router.registry.value(
            "fdtpu_router_breaker_opens_total", "r0") >= 1
        assert router.registry.value("fdtpu_router_failovers_total") >= 1
        assert router.health()["ok"]  # the survivor keeps the fleet up

        old_port = sup0.port
        sup0.stop()
        sup0.argv = _fake_argv()  # the successor carries no kill plan
        assert sup0.spawn(port=old_port) == url0
        wait_http_ready(url0 + "/healthz", timeout=120)
        time.sleep(0.25)  # past the breaker cooldown
        router.probe_now()
        assert r0.breaker == "closed" and r0.healthy
        code, body = _post(base, {"prompt_tokens": [9, 9],
                                  "max_tokens": 4}, rid="post-recovery")
        assert code == 200 and body["request_id"] == "post-recovery"
        assert body["generated"] == fake_tokens([9, 9], 4)
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
        sup0.stop()
        sup1.stop()


def test_router_cli_smoke_exits_0(tmp_path):
    """``python -m fluxdistributed_tpu_torch.serve.router --smoke``: the
    2-replica fake-engine failover demo, run as a user runs it."""
    trace = tmp_path / "fleet_trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fluxdistributed_tpu_torch.serve.router",
         "--smoke", "--trace-out", str(trace)],
        cwd=tmp_path, env=dict(os.environ, **ENV), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "smoke OK: 40 routed requests, 0 failures" in proc.stdout
    doc = json.loads(trace.read_text())
    assert len({e.get("pid") for e in doc["traceEvents"]}) == 2


def test_real_engine_rolling_restart_drops_nothing():
    """Two real lm_tiny replicas on the CPU restart one at a time under
    light load: no request fails, and every successor's greedy tokens
    equal its predecessor's."""
    argv = [*SERVE, "--model", "lm_tiny", "--device", "cpu", "--vocab",
            "256", "--max-slots", "2", "--max-len", "64", "--buckets",
            "8,16", "--port", "0"]
    sup0, url0 = _spawn(argv, "r0", startup_timeout=300.0)
    sup1, url1 = _spawn(argv, "r1", startup_timeout=300.0)
    router = Router(
        [Replica("r0", url0, restart=sup0.restart),
         Replica("r1", url1, restart=sup1.restart)],
        probe_interval=3600.0, failure_threshold=2,
        dispatch_backoff=0.02, upstream_timeout=300.0)
    httpd, base = _serve(router)
    body = {"prompt_tokens": [3, 1, 4], "max_tokens": 6}
    try:
        router.probe_now()
        golden = {}
        for name, url in (("r0", url0), ("r1", url1)):
            code, out = _post(url, body)
            assert code == 200 and len(out["generated"]) == 6
            golden[name] = out["generated"]
        assert golden["r0"] == golden["r1"]  # seed 0 weights on both

        stop = threading.Event()
        outcomes = []

        def load():
            while not stop.is_set():
                try:
                    outcomes.append(_post(base, body))
                except Exception as e:  # noqa: BLE001 — asserted below
                    outcomes.append((None, f"{type(e).__name__}: {e}"))
                time.sleep(0.05)

        t = threading.Thread(target=load, daemon=True)
        t.start()
        try:
            results = router.rolling_restart(drain_timeout=60.0,
                                             ready_timeout=300.0)
        finally:
            stop.set()
            t.join(timeout=120)
        assert not t.is_alive()
        assert [r["replica"] for r in results] == ["r0", "r1"]
        bad = [(c, b) for c, b in outcomes if c != 200]
        assert not bad, f"rolling restart dropped requests: {bad[:3]}"
        assert outcomes
        assert all(b["generated"] == golden["r0"] for _, b in outcomes)
        for rep in router.replicas:  # each successor, asked directly
            code, out = _post(rep.url, body)
            assert code == 200 and out["generated"] == golden["r0"]
        assert {rep.url for rep in router.replicas}.isdisjoint(
            {url0, url1})
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
        sup0.stop()
        sup1.stop()
