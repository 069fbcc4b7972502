"""The port's N-replica router (``fluxdistributed_tpu_torch.serve.router``)
on the CPU: ``tests/test_router.py``'s contract on port replicas, then
the cross-parity check against the JAX package's router.

Replicas are in-process ``FakeLMEngine`` schedulers behind live
``LMServer`` HTTP servers (no model, no device).  Probes are driven
manually (``probe_now``) throughout, so every transition is
deterministic.

The cross-parity check runs one scripted scenario (manual probes, a 5xx
replica, a replica killed before its first token, injected dispatch,
probe and tick faults, a drain, stale metrics, least-loaded dispatch, a
rolling restart) three times: the JAX router over port replicas, the
port router over JAX replicas, and all-JAX.  The router speaks HTTP
only, so each crossing must give the all-JAX run's outcome sequence
exactly: breaker states, the replica each dispatch went to, status
codes, token streams, the request ids on each replica's ``/trace``, the
``/healthz`` rollup's keys and the ``/metrics`` rollup's series names.
Each package keeps its own global fault plan: a step installs its plan
in the package whose code fires it (``serve.dispatch``/``serve.probe``
in the router's, ``serve.tick`` in the replicas').
"""

from __future__ import annotations

import http.server as hs
import json
import math
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import fluxdistributed_tpu.serve.router as jrouter
from fluxdistributed_tpu import faults as jfaults
from fluxdistributed_tpu.obs import RequestTracer as JRequestTracer
from fluxdistributed_tpu.serve import LMServer as JLMServer
from fluxdistributed_tpu.serve import Scheduler as JScheduler
from fluxdistributed_tpu.serve.testing import FakeLMEngine as JFake
from fluxdistributed_tpu_torch import faults
from fluxdistributed_tpu_torch.obs.reqtrace import RequestTracer
from fluxdistributed_tpu_torch.serve import (LMServer, Replica, Router,
                                             RouterError, Scheduler)
from fluxdistributed_tpu_torch.serve import router as prouter
from fluxdistributed_tpu_torch.serve.testing import FakeLMEngine, fake_tokens

PORT = types.SimpleNamespace(
    name="port", faults=faults, router=prouter, Scheduler=Scheduler,
    LMServer=LMServer, RequestTracer=RequestTracer, Fake=FakeLMEngine)
JAX = types.SimpleNamespace(
    name="jax", faults=jfaults, router=jrouter, Scheduler=JScheduler,
    LMServer=JLMServer, RequestTracer=JRequestTracer, Fake=JFake)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear_plan()
    jfaults.clear_plan()


class _Rep:
    """One in-process replica of ``kit``'s package: FakeLMEngine
    scheduler + LMServer + live ThreadingHTTPServer."""

    def __init__(self, step_delay=0.001, max_queue=16, trace=False,
                 max_slots=4, kit=PORT):
        self.engine = kit.Fake(step_delay=step_delay, max_slots=max_slots)
        self.sched = kit.Scheduler(
            self.engine, max_queue=max_queue,
            reqtrace=kit.RequestTracer() if trace else None)
        self.srv = kit.LMServer(self.sched, vocab=256)
        self.httpd = self.srv.serve("127.0.0.1", 0)
        self._serve()
        self.url = f"http://127.0.0.1:{self.srv.bound_port}"

    def _serve(self):
        # tight poll so teardown's shutdown() returns in ~ms, not 0.5s
        threading.Thread(
            target=lambda: self.httpd.serve_forever(poll_interval=0.02),
            daemon=True).start()

    def kill(self):
        """Hard in-process death: the port stops answering."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.stop_loop()

    def revive(self):
        """The replica returns on the SAME port (allow_reuse_address)."""
        self.httpd = self.srv.serve("127.0.0.1", self.srv.bound_port)
        self._serve()

    def close(self):
        try:
            self.kill()
        except OSError:
            pass
        self.srv.close()


@pytest.fixture
def fleet():
    made = []

    def make(n=2, **kw):
        reps = [_Rep(**kw) for _ in range(n)]
        made.extend(reps)
        return reps

    yield make
    for r in made:
        r.close()


def make_router(reps, **kw):
    """Router over in-process replicas with manual probing (the prober
    interval is effectively infinite; tests call probe_now)."""
    kw.setdefault("probe_interval", 3600.0)
    kw.setdefault("probe_timeout", 5.0)
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("breaker_cooldown", 0.2)
    kw.setdefault("dispatch_tries", 3)
    kw.setdefault("dispatch_backoff", 0.01)
    kw.setdefault("upstream_timeout", 60.0)
    return Router([Replica(f"r{i}", r.url) for i, r in enumerate(reps)],
                  **kw)


@pytest.fixture
def served():
    """Start a router's front HTTP server; yields a base-url factory."""
    started = []

    def start(router):
        httpd = router.serve("127.0.0.1", 0)
        threading.Thread(
            target=lambda: httpd.serve_forever(poll_interval=0.02),
            daemon=True).start()
        started.append((router, httpd))
        return f"http://127.0.0.1:{router.bound_port}"

    yield start
    for router, httpd in started:
        httpd.shutdown()
        httpd.server_close()
        router.close()


def _post(base, body, rid=None, timeout=30):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(body).encode(),
        method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _stream(base, body, rid, timeout=30):
    req = urllib.request.Request(
        f"{base}/v1/generate",
        data=json.dumps({**body, "stream": True}).encode(),
        method="POST", headers={"X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            lines = [json.loads(x)
                     for x in r.read().decode().strip().splitlines()]
            return r.status, lines, dict(r.headers)
    except urllib.error.HTTPError as e:  # failed before any token
        return e.code, [json.loads(e.read())], dict(e.headers)


def _get(base, path, timeout=10):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Broken(hs.BaseHTTPRequestHandler):
    """A replica whose /healthz looks perfectly healthy and whose every
    generate blows up server-side (HTTP 500)."""

    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._reply(200, {"ok": True, "draining": False})

    def do_POST(self):
        self._reply(500, {"error": "engine exploded"})


def _broken_server(port=0):
    srv = hs.ThreadingHTTPServer(("127.0.0.1", port), _Broken)
    threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.02),
                     daemon=True).start()
    return srv


# ---------------------------------------------------------------------------
# health + breaker state machine
# ---------------------------------------------------------------------------


def test_probe_health_then_failures_open_breaker(fleet):
    a, b = fleet(2)
    router = make_router([a, b])
    try:
        router.probe_now()
        r0, r1 = router.replicas
        assert r0.healthy and r1.healthy
        assert router.registry.value(
            "fdtpu_router_replica_healthy", "r0") == 1
        a.kill()
        # threshold is 2 consecutive failures: first probe degrades,
        # second opens
        router.probe_now()
        assert not r0.healthy and r0.breaker == "closed"
        router.probe_now()
        assert r0.breaker == "open"
        assert router.registry.value(
            "fdtpu_router_breaker_state", "r0") == 2
        assert router.registry.value(
            "fdtpu_router_breaker_opens_total", "r0") == 1
        # the healthy replica keeps the fleet serving
        h = router.health()
        assert h["ok"] and h["dispatchable"] == 1
    finally:
        router.close()


def test_half_open_trial_request_recloses_breaker(fleet, served):
    """open -> half-open -> closed driven by a TRIAL REQUEST (not a
    probe): after the cooldown the next dispatch is allowed one trial
    on the suspect replica; its success re-closes the breaker."""
    (a,) = fleet(1)
    router = make_router([a], failure_threshold=1, breaker_cooldown=0.05)
    base = served(router)
    router.probe_now()
    a.kill()
    code, body, _ = _post(base, {"prompt_tokens": [1], "max_tokens": 2})
    assert code in (502, 503), body
    assert router.replicas[0].breaker == "open"
    a.revive()  # only a trial request may discover that, probes are off
    time.sleep(0.06)  # past the cooldown
    code, body, _ = _post(base, {"prompt_tokens": [1, 2], "max_tokens": 3})
    assert code == 200, body
    assert body["generated"] == fake_tokens([1, 2], 3)
    assert router.replicas[0].breaker == "closed"


def test_probe_success_also_recovers_open_breaker(fleet):
    a, b = fleet(2)
    router = make_router([a, b], failure_threshold=1)
    try:
        router.probe_now()
        a.kill()
        router.probe_now()
        assert router.replicas[0].breaker == "open"
        a.revive()
        router.probe_now()
        assert router.replicas[0].breaker == "closed"
        assert router.replicas[0].healthy
    finally:
        router.close()


# ---------------------------------------------------------------------------
# dispatch: failover, request-id preservation, determinism
# ---------------------------------------------------------------------------


def test_failover_pre_first_token_preserves_request_id(fleet, served):
    """A replica that died since its last probe still LOOKS healthy —
    dispatch discovers the death, fails over, and the client sees one
    clean 200 with its own X-Request-Id and the exact tokens the dead
    replica would have produced."""
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()  # both healthy
    a.kill()            # ...but the router does not know yet
    for i in range(4):  # round-robin guarantees the dead one is tried
        rid = f"req-{i}"
        code, body, headers = _post(
            base, {"prompt_tokens": [i + 1, 2], "max_tokens": 5}, rid=rid)
        assert code == 200, body
        assert body["request_id"] == rid
        assert headers.get("X-Request-Id") == rid
        assert headers.get("X-Fdtpu-Replica") == "r1"
        assert body["generated"] == fake_tokens([i + 1, 2], 5)
    assert router.registry.value(
        "fdtpu_router_dispatch_failures_total", "r0") >= 1
    assert router.registry.value("fdtpu_router_failovers_total") >= 1


def test_injected_dispatch_fault_is_retried(fleet, served):
    """serve.dispatch injection: the first dispatch attempt raises
    inside the router (no replica involved) and the retry completes."""
    (a,) = fleet(1)
    router = make_router([a])
    base = served(router)
    router.probe_now()
    faults.install_plan(faults.FaultPlan().fail("serve.dispatch", times=1))
    code, body, _ = _post(base, {"prompt_tokens": [9], "max_tokens": 3})
    assert code == 200, body
    assert body["generated"] == fake_tokens([9], 3)
    assert router.registry.value("fdtpu_router_failovers_total") >= 1
    assert faults._metrics()["injected"].value("serve.dispatch") >= 1


def test_all_replicas_down_returns_503(fleet, served):
    (a,) = fleet(1)
    router = make_router([a], dispatch_tries=2, dispatch_backoff=0.0)
    base = served(router)
    router.probe_now()
    a.kill()
    router.probe_now()
    router.probe_now()  # breaker open; nothing dispatchable
    code, body, _ = _post(base, {"prompt_tokens": [1], "max_tokens": 2})
    assert code == 503, body
    assert "no dispatchable replica" in body["error"]
    assert "request_id" in body


def test_replica_5xx_fails_over_and_feeds_breaker(fleet, served):
    """A 5xx from a replica is the REPLICA's failure: nothing reached
    the client, so the router retries elsewhere and counts the failure
    — it does not pass the 500 through and reset the breaker."""
    broken = _broken_server()
    (good,) = fleet(1)
    router = Router(
        [Replica("r0", f"http://127.0.0.1:{broken.server_address[1]}"),
         Replica("r1", good.url)],
        probe_interval=3600.0, failure_threshold=2,
        dispatch_backoff=0.0, upstream_timeout=30.0)
    base = served(router)
    try:
        router.probe_now()
        for i in range(4):  # round-robin makes r0 answer 500 at least once
            code, body, headers = _post(
                base, {"prompt_tokens": [i + 1], "max_tokens": 3})
            assert code == 200, body
            assert headers.get("X-Fdtpu-Replica") == "r1"
            assert body["generated"] == fake_tokens([i + 1], 3)
        assert router.registry.value(
            "fdtpu_router_dispatch_failures_total", "r0") >= 1
        assert router.replicas[0].consecutive_failures >= 1
    finally:
        broken.shutdown()
        broken.server_close()


def test_client_errors_pass_through_without_failover(fleet, served):
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    code, body, _ = _post(base, {"max_tokens": 4})  # no prompt: 400
    assert code == 400
    assert router.registry.value("fdtpu_router_failovers_total") == 0
    # a replying replica is a LIVE replica — no breaker movement
    assert all(r.breaker == "closed" for r in router.replicas)


# ---------------------------------------------------------------------------
# streaming: retry before first token, fail fast after
# ---------------------------------------------------------------------------


def test_stream_failover_before_first_token(fleet, served):
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    a.kill()
    for i in range(3):
        code, lines, headers = _stream(
            base, {"prompt_tokens": [7, i], "max_tokens": 4}, f"s-{i}")
        assert headers["X-Request-Id"] == f"s-{i}"
        toks = [x["token"] for x in lines if "token" in x]
        assert toks == fake_tokens([7, i], 4)
        assert lines[-1]["done"] is True
    assert router.registry.value(
        "fdtpu_router_dispatch_failures_total", "r0") >= 1


def test_stream_after_first_token_fails_fast_naming_replica(fleet, served):
    """Once a token has been forwarded, an upstream stall cannot be
    transparently retried: the stream ends promptly with an error line
    naming the replica, not after the full request timeout."""
    (a,) = fleet(1)
    a.engine.step_delay = 0.01
    router = make_router([a], upstream_timeout=0.8)
    base = served(router)
    router.probe_now()

    def wedge_soon():
        time.sleep(0.1)  # a few tokens out first
        a.engine.step_delay = 2.0  # the replica wedges mid-decode

    threading.Thread(target=wedge_soon, daemon=True).start()
    t0 = time.monotonic()
    code, lines, _ = _stream(
        base, {"prompt_tokens": [3, 4], "max_tokens": 500}, "wedge")
    assert time.monotonic() - t0 < 10
    assert any("token" in x for x in lines), lines
    last = lines[-1]
    assert last["done"] is False
    assert "r0" in last["error"] and "mid-stream" in last["error"]
    assert last["replica"] == "r0" and last["request_id"] == "wedge"
    assert router.registry.value(
        "fdtpu_router_midstream_failures_total") == 1
    assert router.registry.value("fdtpu_router_failovers_total") == 0
    a.engine.step_delay = 0.0  # unwedge for teardown


def test_client_disconnect_midstream_does_not_blame_replica(fleet, served):
    """A CLIENT leaving mid-stream is not the replica's fault: no
    breaker movement, no mid-stream-failure tally."""
    import http.client as hc

    (a,) = fleet(1, step_delay=0.01)
    router = make_router([a], failure_threshold=1)
    served(router)
    router.probe_now()
    conn = hc.HTTPConnection("127.0.0.1", router.bound_port, timeout=10)
    conn.request("POST", "/v1/generate",
                 body=json.dumps({"prompt_tokens": [1, 2],
                                  "max_tokens": 200, "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read(8)  # a token or two have flowed
    conn.sock.close()  # the client walks away mid-stream
    deadline = time.monotonic() + 5
    while router.replicas[0].inflight and time.monotonic() < deadline:
        time.sleep(0.02)
    assert router.replicas[0].inflight == 0
    assert router.replicas[0].breaker == "closed"
    assert router.replicas[0].consecutive_failures == 0
    assert router.registry.value(
        "fdtpu_router_midstream_failures_total") == 0
    a.engine.step_delay = 0.0  # let the abandoned decode finish fast


# ---------------------------------------------------------------------------
# drain-under-load ordering (the rolling-restart building block)
# ---------------------------------------------------------------------------


def test_drain_under_load_streams_finish_and_router_routes_around(
        fleet, served):
    """The SIGTERM-shaped drain under live traffic: a stream in flight
    on the draining replica runs to completion, its own 503 carries
    draining: true, the router treats draining as out-of-rotation (NOT a
    breaker failure) and re-dispatches new work to the healthy one."""
    a, b = fleet(2, step_delay=0.01)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    stream_lines = []
    stream_done = threading.Event()

    def long_stream():
        req = urllib.request.Request(
            f"{a.url}/v1/generate",
            data=json.dumps({"prompt_tokens": [5, 6], "max_tokens": 60,
                             "stream": True}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            for line in r:
                stream_lines.append(json.loads(line))
        stream_done.set()

    threading.Thread(target=long_stream, daemon=True).start()
    deadline = time.monotonic() + 30
    while not any("token" in x for x in stream_lines):
        assert time.monotonic() < deadline, "the stream never started"
        time.sleep(0.005)  # mid-stream
    drain_result = {}
    dt = threading.Thread(
        target=lambda: drain_result.setdefault("ok", a.srv.drain(30.0)),
        daemon=True)
    dt.start()
    while not a.sched.draining:
        time.sleep(0.001)
    code, body, _ = _post(a.url, {"prompt_tokens": [1], "max_tokens": 2})
    assert code == 503 and body.get("draining") is True
    for i in range(4):
        code, body, headers = _post(
            base, {"prompt_tokens": [8, i], "max_tokens": 4}, rid=f"d-{i}")
        assert code == 200, body
        assert headers.get("X-Fdtpu-Replica") == "r1"
        assert body["generated"] == fake_tokens([8, i], 4)
    r0 = router.replicas[0]
    assert r0.draining is True
    assert r0.breaker == "closed" and r0.consecutive_failures == 0
    router.probe_now()
    assert r0.breaker == "closed"
    h = router.health()
    assert h["ok"] and h["dispatchable"] == 1
    dt.join(timeout=60)
    assert not dt.is_alive()
    assert stream_done.wait(timeout=60)
    toks = [x["token"] for x in stream_lines if "token" in x]
    assert toks == fake_tokens([5, 6], 60), "drain cut a stream short"
    assert stream_lines[-1]["done"] is True
    assert drain_result["ok"] is True


# ---------------------------------------------------------------------------
# least-loaded dispatch off the queue-wait rollup
# ---------------------------------------------------------------------------


def test_least_loaded_prefers_low_queue_wait_p50(fleet, served):
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    for _ in range(4):
        a.sched._h_queue_wait.observe(1.0)
    router.probe_now()  # scrapes both replicas' /metrics
    assert router.replicas[0].queue_wait_p50 > 0.1
    assert math.isnan(router.replicas[1].queue_wait_p50)
    for i in range(4):
        code, _, headers = _post(
            base, {"prompt_tokens": [i + 1], "max_tokens": 2})
        assert code == 200
        assert headers.get("X-Fdtpu-Replica") == "r1", (
            "least-loaded dispatch must prefer the unloaded replica")


def test_stale_metrics_fall_back_to_round_robin(fleet, served):
    a, b = fleet(2)
    router = make_router([a, b], metrics_stale_after=0.5)
    base = served(router)
    for _ in range(4):
        a.sched._h_queue_wait.observe(1.0)
    router.probe_now()
    with router._lock:
        for rep in router.replicas:
            rep.load_at -= 100.0  # both scrapes long stale
    seen = set()
    for i in range(4):
        code, _, headers = _post(
            base, {"prompt_tokens": [i + 1], "max_tokens": 2})
        assert code == 200
        seen.add(headers.get("X-Fdtpu-Replica"))
    assert seen == {"r0", "r1"}


# ---------------------------------------------------------------------------
# fleet rollups: /metrics names, /healthz, /trace stitching
# ---------------------------------------------------------------------------


def _family_names(text, prefix="fdtpu_serve_"):
    return {line.split(" ")[2] for line in text.splitlines()
            if line.startswith("# TYPE " + prefix)}


def test_metrics_rollup_names_byte_identical(fleet, served):
    """Every fdtpu_serve_* family a replica exposes appears under the
    SAME name in the router rollup (a replica label on each series),
    beside the router's own series."""
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    _post(base, {"prompt_tokens": [1, 2], "max_tokens": 3})
    direct = _get(a.url, "/metrics")[1].decode()
    rolled = _get(base, "/metrics")[1].decode()
    direct_names = _family_names(direct)
    assert direct_names  # the pin is vacuous if the scrape broke
    assert _family_names(rolled) == direct_names
    assert _family_names(rolled, "fdtpu_hbm_") == _family_names(
        direct, "fdtpu_hbm_") == {"fdtpu_hbm_available",
                                  "fdtpu_hbm_headroom_ratio"}
    for line in rolled.splitlines():
        if line.startswith("fdtpu_serve_"):
            assert 'replica="' in line, line
    assert "# TYPE fdtpu_router_breaker_state gauge" in rolled
    assert 'fdtpu_router_dispatches_total{replica="' in rolled


def test_healthz_rollup_shape(fleet, served):
    a, b = fleet(2)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    code, raw = _get(base, "/healthz")
    assert code == 200
    h = json.loads(raw)
    assert h["ok"] and h["dispatchable"] == 2 and h["role"] == "router"
    assert {r["name"] for r in h["replicas"]} == {"r0", "r1"}
    for r in h["replicas"]:
        assert r["breaker"] == "closed" and r["healthy"]
    a.kill()
    b.kill()
    router.probe_now()
    router.probe_now()
    code, raw = _get(base, "/healthz")
    assert code == 503
    assert json.loads(raw)["ok"] is False


def test_trace_rollup_stitches_replica_timelines(fleet, served):
    a, b = fleet(2, trace=True)
    router = make_router([a, b])
    base = served(router)
    router.probe_now()
    for i in range(4):
        code, _, _ = _post(base, {"prompt_tokens": [i + 1],
                                  "max_tokens": 2}, rid=f"tr-{i}")
        assert code == 200
    code, raw = _get(base, "/trace")
    assert code == 200
    doc = json.loads(raw)
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}
    labels = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert any("r0" in x for x in labels)
    assert any("r1" in x for x in labels)
    assert len([e for e in doc["traceEvents"]
                if e.get("name") == "enqueue"]) == 4
    assert _trace_ids(doc) == {f"tr-{i}" for i in range(4)}
    assert {r["name"] for r in doc["otherData"]["replicas"]} == {"r0", "r1"}
    assert doc["otherData"]["producer"] == (
        "fluxdistributed_tpu_torch.serve.router")


# ---------------------------------------------------------------------------
# rolling restart
# ---------------------------------------------------------------------------


def test_rolling_restart_zero_drops_under_load(fleet, served):
    """Each replica's restart hook tears the old server down and brings
    a successor up on a fresh port, one replica at a time, while a
    client keeps sending requests through the router — none may fail."""
    reps = fleet(2, step_delay=0.002)

    def make_restart(idx):
        def restart(replica):
            reps[idx].close()
            reps[idx] = _Rep(step_delay=0.002)
            return reps[idx].url
        return restart

    router = Router(
        [Replica(f"r{i}", r.url, restart=make_restart(i))
         for i, r in enumerate(reps)],
        probe_interval=3600.0, failure_threshold=2,
        dispatch_backoff=0.01, upstream_timeout=30.0)
    base = served(router)
    router.probe_now()
    stop = threading.Event()
    outcomes = []

    def load():
        i = 0
        while not stop.is_set():
            code, body, _ = _post(
                base, {"prompt_tokens": [i % 9 + 1], "max_tokens": 3},
                timeout=30)
            outcomes.append((i, code, body))
            i += 1
            time.sleep(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    old_urls = [r.url for r in router.replicas]
    try:
        results = router.rolling_restart(drain_timeout=10.0,
                                         ready_timeout=10.0)
    finally:
        stop.set()
        t.join(timeout=10)
    try:
        assert not t.is_alive()
        assert len(results) == 2
        assert set(r.url for r in router.replicas).isdisjoint(old_urls)
        assert all(r["drained_clean"] for r in results)
        bad = [(i, c, b) for i, c, b in outcomes if c != 200]
        assert not bad, f"rolling restart dropped requests: {bad[:3]}"
        assert outcomes
        assert all(rep.healthy and rep.breaker == "closed"
                   for rep in router.replicas)
        assert router.registry.value(
            "fdtpu_router_restarts_total", "r0") == 1
        code, body, _ = _post(base, {"prompt_tokens": [2, 3],
                                     "max_tokens": 4})
        assert code == 200 and body["generated"] == fake_tokens([2, 3], 4)
    finally:
        for r in reps:
            r.close()


@pytest.mark.parametrize("case", ["missing_restart_hook",
                                  "duplicate_name", "bad_arguments"])
def test_router_refusals(fleet, case):
    """Configuration the router refuses: a rolling restart without
    restart hooks, a duplicate replica name, and out-of-range
    arguments."""
    a, b = fleet(2)
    router = make_router([a, b])
    try:
        if case == "missing_restart_hook":
            router.probe_now()
            with pytest.raises(RouterError, match="restart hook"):
                router.rolling_restart()
        elif case == "duplicate_name":
            with pytest.raises(RouterError, match="duplicate"):
                router.add_replica(Replica("r0", a.url))
        else:
            with pytest.raises(ValueError, match="failure_threshold"):
                Router(failure_threshold=0)
            with pytest.raises(ValueError, match="dispatch_tries"):
                Router(dispatch_tries=0)
    finally:
        router.close()


def test_router_cli_flags_match_bin_router():
    """``python -m fluxdistributed_tpu_torch.serve.router`` takes every
    flag of ``bin/router.py`` with its default; the router's constants
    and argument defaults equal JAX's."""
    import importlib.util
    import inspect
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "bin" / "router.py"
    spec = importlib.util.spec_from_file_location("bin_router_ref", path)
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions}

    assert flags(prouter.build_parser()) == flags(jcli.build_parser())
    assert prouter.METRIC_PREFIX == jrouter.METRIC_PREFIX
    assert prouter.BREAKER_STATES == jrouter.BREAKER_STATES
    sig = lambda f: {k: v.default for k, v in  # noqa: E731
                     inspect.signature(f).parameters.items()}
    assert sig(prouter.Router.__init__) == sig(jrouter.Router.__init__)
    assert sig(prouter.Router.rolling_restart) == sig(
        jrouter.Router.rolling_restart)
    assert sig(prouter.SupervisedReplica.__init__) == sig(
        jrouter.SupervisedReplica.__init__)


# ---------------------------------------------------------------------------
# cross-parity: the JAX router over port replicas, the port router over
# JAX replicas, and all-JAX give one outcome sequence
# ---------------------------------------------------------------------------


def _trace_ids(doc) -> set:
    return {e["args"]["name"][len("request "):]
            for e in doc.get("traceEvents", [])
            if e.get("name") == "thread_name"
            and e["args"]["name"].startswith("request ")}


class _Scenario:
    """One scripted run of ``rkit``'s router over two ``pkit`` replicas
    (r0, r1) and a 5xx replica (r2), recording an outcome after each
    step."""

    def __init__(self, rkit, pkit):
        self.rkit, self.pkit = rkit, pkit
        self.reps = [_Rep(trace=True, kit=pkit) for _ in range(2)]
        self.broken = _broken_server()
        # identical queue-wait histories dominate each replica's p50, so
        # least-loaded ties break on the request counts alone, never on
        # how long this machine took to admit a request
        for rep in self.reps:
            for _ in range(20):
                rep.sched._h_queue_wait.observe(1.0)

        def restart_replica(idx):
            def restart(replica):
                self.reps[idx].close()
                self.reps[idx] = _Rep(trace=True, kit=pkit)
                return self.reps[idx].url
            return restart

        def restart_broken(replica):
            port = self.broken.server_address[1]
            self.broken.shutdown()
            self.broken.server_close()
            self.broken = _broken_server(port)
            return replica.url

        R = rkit.router
        self.router = R.Router(
            [R.Replica("r0", self.reps[0].url, restart=restart_replica(0)),
             R.Replica("r1", self.reps[1].url, restart=restart_replica(1)),
             R.Replica("r2",
                       f"http://127.0.0.1:{self.broken.server_address[1]}",
                       restart=restart_broken)],
            probe_interval=3600.0, probe_timeout=5.0, failure_threshold=2,
            breaker_cooldown=3600.0, metrics_stale_after=3600.0,
            dispatch_tries=3, dispatch_backoff=0.0, upstream_timeout=2.5)
        self.httpd = self.router.serve("127.0.0.1", 0)
        threading.Thread(
            target=lambda: self.httpd.serve_forever(poll_interval=0.02),
            daemon=True).start()
        self.base = f"http://127.0.0.1:{self.router.bound_port}"
        self.outcomes = []
        self.n = 0

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.router.close()
        for rep in self.reps:
            rep.close()
        self.broken.shutdown()
        self.broken.server_close()

    def requests(self, k, stream_every=0):
        """``k`` sequential requests through the router (every
        ``stream_every``-th streamed)."""
        out = []
        for _ in range(k):
            i = self.n
            self.n += 1
            rid = f"x-{i}"
            body = {"prompt_tokens": [i % 7 + 1, i % 3 + 2],
                    "max_tokens": 4}
            if stream_every and i % stream_every == 0:
                code, lines, headers = _stream(self.base, body, rid)
                out.append({
                    "rid": rid, "code": code, "stream": True,
                    "replica": headers.get("X-Fdtpu-Replica"),
                    "id": headers.get("X-Request-Id"),
                    "tokens": [x["token"] for x in lines if "token" in x],
                    "done": lines[-1].get("done"),
                    "failed_replica": lines[-1].get("replica")})
            else:
                code, resp, headers = _post(self.base, body, rid=rid)
                out.append({
                    "rid": rid, "code": code, "stream": False,
                    "replica": headers.get("X-Fdtpu-Replica"),
                    "id": resp.get("request_id"),
                    "tokens": resp.get("generated"),
                    "error": "no dispatchable" in resp.get("error", "")})
            want = fake_tokens(body["prompt_tokens"], 4)
            assert out[-1]["tokens"] in (None, want) or (
                want[:len(out[-1]["tokens"])] == out[-1]["tokens"])
        return out

    def record(self, step, dispatched=()):
        r = self.router
        h = r.health()
        metrics = r.metrics_text()
        trace_ids = {}
        for name, rep in zip(("r0", "r1"), self.reps):
            try:
                code, raw = _get(rep.url, "/trace")
            except urllib.error.URLError:  # a killed replica
                code = None
            trace_ids[name] = (sorted(_trace_ids(json.loads(raw)))
                               if code == 200 else None)
        reg = r.registry
        self.outcomes.append({
            "step": step,
            "breakers": {x.name: x.breaker for x in r.replicas},
            "healthy": {x.name: x.healthy for x in r.replicas},
            "draining": {x.name: x.draining for x in r.replicas},
            "failures": {x.name: x.consecutive_failures
                         for x in r.replicas},
            "dispatched": list(dispatched),
            "trace_ids": trace_ids,
            "healthz_keys": sorted(h),
            "healthz_replica_keys": sorted(h["replicas"][0]),
            "healthz_ok": (h["ok"], h["dispatchable"]),
            "metrics_names": sorted({line.split(" ")[2]
                                     for line in metrics.splitlines()
                                     if line.startswith("# TYPE ")}),
            "counters": {
                "failovers": reg.value("fdtpu_router_failovers_total"),
                "opens": {x.name: reg.value(
                    "fdtpu_router_breaker_opens_total", x.name)
                    for x in r.replicas},
                "dispatch_failures": {x.name: reg.value(
                    "fdtpu_router_dispatch_failures_total", x.name)
                    for x in r.replicas},
                "restarts": {x.name: reg.value(
                    "fdtpu_router_restarts_total", x.name)
                    for x in r.replicas},
            },
        })

    def run(self):
        rf, pf = self.rkit.faults, self.pkit.faults
        r = self.router
        r.probe_now()
        self.record("probe")
        # least-loaded: r2's scrape has no queue waits (NaN = unloaded),
        # so it draws dispatch until its 5xx answers open its breaker
        self.record("dispatch_and_5xx", self.requests(6, stream_every=3))
        self.reps[0].kill()  # dead, and the router does not know yet
        self.record("killed_before_first_token", self.requests(3))
        r.probe_now()
        self.record("probe_after_kill")
        rf.install_plan(rf.FaultPlan().fail("serve.dispatch", times=1))
        self.record("dispatch_fault", self.requests(2))
        rf.clear_plan()
        rf.install_plan(rf.FaultPlan().fail("serve.probe", times=2))
        r.probe_now()
        rf.clear_plan()
        self.record("probe_faults")
        self.reps[0].revive()
        r.probe_now()
        self.record("revived")
        # the replica that takes the next stream stalls after its first
        # token: the router fails fast naming it, it does not fail over
        plan = pf.FaultPlan()
        for k in sorted({rep.sched._ticks + 1 for rep in self.reps}):
            plan.fail("serve.tick", at=k, action="sleep", delay=3.5)
        pf.install_plan(plan)
        self.record("midstream_stall", self.requests(1, stream_every=1))
        pf.clear_plan()
        deadline = time.monotonic() + 30
        while not all(rep.sched.idle for rep in self.reps):
            assert time.monotonic() < deadline, "the stall never ended"
            time.sleep(0.01)
        pf.install_plan(pf.FaultPlan().fail("serve.tick", at=3))
        self.record("tick_fault", self.requests(4, stream_every=2))
        pf.clear_plan()
        assert self.reps[0].srv.drain(10.0) is True
        self.record("drain", self.requests(2))
        self._age_loads()  # round-robin now tries the draining r0
        self.record("stale_metrics_draining", self.requests(3))
        r.probe_now()
        self.record("probe_draining")
        restarted = r.rolling_restart(drain_timeout=10.0, ready_timeout=30.0)
        assert [x["replica"] for x in restarted] == ["r0", "r1", "r2"]
        assert all(x["drained_clean"] for x in restarted)
        self.record("rolling_restart", self.requests(4, stream_every=2))
        self._age_loads()
        self.record("stale_metrics", self.requests(4))
        return self.outcomes

    def _age_loads(self):
        with self.router._lock:
            for x in self.router.replicas:
                x.load_at -= 1e4  # every scrape long stale


def _scenario(rkit, pkit):
    s = _Scenario(rkit, pkit)
    try:
        return s.run()
    finally:
        s.close()
        faults.clear_plan()
        jfaults.clear_plan()


@pytest.fixture(scope="module")
def all_jax_outcomes():
    return _scenario(JAX, JAX)


@pytest.mark.parametrize("rkit,pkit", [(JAX, PORT), (PORT, JAX),
                                       (PORT, PORT)],
                         ids=["jax_router-port_replicas",
                              "port_router-jax_replicas",
                              "port_router-port_replicas"])
def test_cross_parity_outcome_sequence(all_jax_outcomes, rkit, pkit):
    got = _scenario(rkit, pkit)
    assert [o["step"] for o in got] == [o["step"] for o in all_jax_outcomes]
    for mine, ref in zip(got, all_jax_outcomes):
        assert mine == ref, mine["step"]


def test_cross_parity_scenario_exercises_every_path(all_jax_outcomes):
    """The reference run itself: the scenario reached every state it is
    meant to compare (so an equal sequence is not vacuous)."""
    by = {o["step"]: o for o in all_jax_outcomes}
    assert by["dispatch_and_5xx"]["breakers"]["r2"] == "open"
    assert {d["replica"] for d in by["dispatch_and_5xx"]["dispatched"]} \
        == {"r0", "r1"}
    assert any(d["stream"] for d in by["dispatch_and_5xx"]["dispatched"])
    assert by["killed_before_first_token"]["breakers"]["r0"] == "open"
    assert all(d["code"] == 200 and d["replica"] == "r1"
               for d in by["killed_before_first_token"]["dispatched"])
    assert by["probe_after_kill"]["breakers"]["r2"] == "closed"
    assert by["probe_faults"]["failures"] != by["probe_after_kill"][
        "failures"]
    assert by["revived"]["breakers"]["r0"] == "closed"
    (mid,) = by["midstream_stall"]["dispatched"]
    assert mid["stream"] and mid["done"] is False
    assert 0 < len(mid["tokens"]) < 4
    assert mid["failed_replica"] == mid["replica"]
    assert by["midstream_stall"]["counters"]["failovers"] == by[
        "revived"]["counters"]["failovers"] + 1  # r2's 5xx, before it
    stale = by["stale_metrics_draining"]
    assert stale["draining"]["r0"] is True
    assert stale["breakers"]["r0"] == "closed"
    assert all(d["code"] == 200 and d["replica"] == "r1"
               for d in stale["dispatched"])
    assert by["probe_draining"]["healthy"]["r0"] is False
    assert {d["replica"] for d in by["stale_metrics"]["dispatched"]} == {
        "r0", "r1"}
    assert by["rolling_restart"]["counters"]["restarts"] == {
        "r0": 1, "r1": 1, "r2": 1}
    assert by["rolling_restart"]["trace_ids"]["r0"] is not None
    ids = [d["id"] for o in all_jax_outcomes for d in o["dispatched"]
           if d["code"] == 200]
    rids = [d["rid"] for o in all_jax_outcomes for d in o["dispatched"]
            if d["code"] == 200]
    assert ids == rids and len(ids) > 20
    assert by["rolling_restart"]["counters"]["failovers"] > 0


# ---------------------------------------------------------------------------
# kernel launch counts with two replicas in one process
# ---------------------------------------------------------------------------


def test_launch_counts_exact_across_threads(monkeypatch):
    """Two replicas decode on two threads of one process, and one can
    capture its decode graph while the other replays: the kernel
    wrappers' counts take every launch once (added under a lock), and a
    launch onto the capturing stream goes to the capture, from whatever
    thread (autograd runs a captured backward on its own thread), not
    to the count."""
    import importlib
    import sys
    import types

    import torch

    counts = importlib.import_module("fluxdistributed_tpu_torch.ops.counts")
    fd = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_decode").flash_decode
    default, side = (types.SimpleNamespace(cuda_stream=1),
                     types.SimpleNamespace(cuda_stream=2))
    local = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: getattr(local, "stream", default))
    saved, old = fd.launches, sys.getswitchinterval()
    fd.launches = 0
    captured = []
    sys.setswitchinterval(1e-6)
    try:
        def backward_thread():  # launches onto the capture's stream
            local.stream = side
            for _ in range(12):
                counts.count(fd)

        def replica(i):
            for n in range(2000):
                if i == 0 and n == 1000:
                    with counts.capturing(side) as cap:
                        local.stream = side
                        counts.count(fd, 12)
                        t = threading.Thread(target=backward_thread)
                        t.start()
                        t.join(timeout=60)
                        local.stream = default
                    captured.append(dict(cap))
                counts.count(fd, 12 if i % 2 else 1)

        threads = [threading.Thread(target=replica, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert fd.launches == 2000 * (8 * 12 + 8 * 1)
        assert captured == [{fd: 24}]
    finally:
        sys.setswitchinterval(old)
        fd.launches = saved
