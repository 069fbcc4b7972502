"""Fault-tolerant N-replica serving router.

A single :class:`~.server.LMServer` is a single point of failure — the
paper's own parameter-server heritage (FluxDistributed.jl's hub
all-reduce) is the cautionary tale of one coordinator wedging
everything.  This module is the robustness layer above the engine:
a stdlib-HTTP front process over N replicas that keeps serving through
replica crashes, hangs, drains, and deliberate rolling restarts.

Port of ``fluxdistributed_tpu/serve/router.py`` (and, as
``python -m fluxdistributed_tpu_torch.serve.router``, of
``bin/router.py``).  The router speaks HTTP only: it builds no model
and touches no device, and it fronts the port's replicas and the JAX
package's alike.

Pieces, each independently testable without a real outage (every
failure path is drivable by :mod:`..faults` injection — sites
``serve.dispatch`` / ``serve.probe`` here, ``serve.tick`` in the
replica's scheduler):

* **health-checked replica registry** — a prober thread GETs every
  replica's ``/healthz`` each ``probe_interval``: 200 = healthy, 503
  with ``draining: true`` = *draining* (deliberately out of rotation —
  NOT a failure, the breaker ignores it), anything else counts toward a
  consecutive-failure threshold.  The same pass scrapes the replica's
  queue-wait rollup gauges off ``/metrics`` (the per-request latency
  truth :mod:`..obs.reqtrace` puts there) for least-loaded dispatch.
* **per-replica circuit breakers** — closed → open after
  ``failure_threshold`` consecutive probe/dispatch failures; after
  ``breaker_cooldown`` seconds the breaker half-opens and admits ONE
  trial request at a time (a probe success also closes it — the
  deterministic recovery path when healthy replicas are absorbing the
  traffic).  State rides the ``fdtpu_router_breaker_state`` gauge
  (0 closed / 1 half-open / 2 open) per replica.
* **dispatch with failover** — requests route to the replica with the
  lowest queue-wait p50 (ties broken by occupancy then round-robin;
  stale metrics fall back to pure round-robin).  A dispatch that dies
  before its first byte/token is transparently retried on another
  replica through :func:`..faults.with_retries` (site
  ``serve.dispatch`` — the one retry policy in the tree); once a
  streamed token has been forwarded the router fails FAST with the
  replica named (re-issuing would duplicate tokens).  The client's
  ``X-Request-Id`` (or a router-minted one) rides every hop, so a
  failed-over request appears on BOTH replicas' ``/trace`` timelines
  under one id and the stitched view tells the whole story.
* **rolling restarts** — :meth:`Router.rolling_restart` takes the fleet
  through drain → restart → ready, ONE replica at a time: the replica
  is pulled from dispatch, router-side in-flight requests to it
  complete, its ``restart`` hook (SIGTERM-drain + respawn for
  supervised subprocess replicas) brings a successor up, and traffic
  only moves on once the successor probes healthy.  A port successor
  captures its decode graph once, on its first decode step
  (``fdtpu_serve_decode_compiles`` reads 1 after serving).
* **fleet rollup** — ``GET /metrics`` re-exposes every replica's series
  with an added ``replica="<name>"`` label (names stay byte-identical
  to a direct scrape — aggregation semantics stay correct because no
  lossy sum is baked in) plus the router's own ``fdtpu_router_*``
  series; ``GET /healthz`` rolls up per-replica state; ``GET /trace``
  stitches the fleet's Perfetto timelines into one document (one
  process row per replica).

The command line (``bin/router.py``'s flags).  Front an existing
fleet::

    python -m fluxdistributed_tpu_torch.serve.router \
        --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002 \
        --port 8100

Supervise one (spawn the replicas yourself, restartable)::

    python -m fluxdistributed_tpu_torch.serve.router --spawn 2 \
        --port 8100 --replica-cmd "python -m fluxdistributed_tpu_torch.serve \
        --model lm_small --max-slots 4 --max-len 256 --port 0"

Zero-downtime redeploy of a supervised fleet (one replica at a time:
drain -> SIGTERM -> respawn -> wait healthy)::

    python -m fluxdistributed_tpu_torch.serve.router \
        --rolling-restart http://127.0.0.1:8100

``--smoke`` runs the self-contained 2-replica failover demo: fake-engine
replicas, one killed mid-burst by a deterministic fault plan, zero
failed requests asserted, breaker transitions checked, and the stitched
trace written out.
"""

from __future__ import annotations

import http.client
import http.server
import itertools
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from .. import faults
from ..obs.metrics import Registry
from .server import HTTPServer

__all__ = [
    "BREAKER_STATES",
    "METRIC_PREFIX",
    "NoReplicaAvailable",
    "Replica",
    "Router",
    "RouterError",
    "SupervisedReplica",
    "wait_http_ready",
]

#: every router-owned series carries this prefix (like the scheduler's
#: METRIC_PREFIX)
METRIC_PREFIX = "fdtpu_router_"

#: breaker states as the fdtpu_router_breaker_state gauge renders them
BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}

_request_ids = itertools.count()


class RouterError(RuntimeError):
    """Router operational failure (bad configuration, restart hook
    missing/failed)."""


class NoReplicaAvailable(RuntimeError):
    """No replica is currently dispatchable (all dead, draining,
    restarting, or circuit-open) — retried by the dispatch policy,
    HTTP 503 when retries exhaust."""


class _DispatchFailed(RuntimeError):
    """One dispatch attempt failed in a way another replica can absorb
    (connection error, 429, draining 503) — the retryable marker
    :func:`..faults.with_retries` keys on."""


@dataclass(eq=False)  # identity semantics: replicas live in sets/dicts
class Replica:
    """One replica's registry entry: identity, health/breaker state,
    and the load truth the prober scraped last."""

    name: str
    url: str  # base, e.g. http://127.0.0.1:8001 (no trailing slash)
    #: optional restart hook for rolling restarts: called with this
    #: Replica, must gracefully stop the backing process/server and
    #: bring a successor up, returning the (possibly new) base url
    restart: Optional[Callable[["Replica"], str]] = None

    # -- prober-owned state --------------------------------------------
    healthy: bool = False
    draining: bool = False
    restarting: bool = False
    consecutive_failures: int = 0
    last_error: Optional[str] = None
    last_probe_at: float = 0.0

    # -- circuit breaker -----------------------------------------------
    breaker: str = "closed"
    opened_at: float = 0.0
    trial_inflight: bool = False

    # -- load truth (least-loaded dispatch) ----------------------------
    queue_wait_p50: float = math.nan
    queue_depth: int = 0
    active_slots: int = 0
    load_at: float = 0.0  # monotonic stamp of the last metrics scrape

    # -- router-side bookkeeping ---------------------------------------
    inflight: int = 0

    def __post_init__(self):
        self.url = self.url.rstrip("/")


class Router:
    """The N-replica front process.  Lifecycle::

        router = Router([Replica("r0", url0), Replica("r1", url1)])
        router.start_probes()             # health/load prober thread
        httpd = router.serve("0.0.0.0", 8100)
        httpd.serve_forever()

    ``registry=None`` builds a PRIVATE metrics registry per router (the
    scheduler convention — tests spin several per process).
    """

    def __init__(self, replicas: Sequence[Replica] = (), *,
                 probe_interval: float = 0.5,
                 probe_timeout: float = 2.0,
                 failure_threshold: int = 3,
                 breaker_cooldown: float = 2.0,
                 metrics_stale_after: float = 3.0,
                 dispatch_tries: int = 3,
                 dispatch_backoff: float = 0.05,
                 upstream_timeout: float = 600.0,
                 registry: Optional[Registry] = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if dispatch_tries < 1:
            raise ValueError(
                f"dispatch_tries must be >= 1, got {dispatch_tries}")
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.failure_threshold = failure_threshold
        self.breaker_cooldown = breaker_cooldown
        self.metrics_stale_after = metrics_stale_after
        self.dispatch_tries = dispatch_tries
        self.dispatch_backoff = dispatch_backoff
        self.upstream_timeout = upstream_timeout
        self._replicas: List[Replica] = []
        self._lock = threading.RLock()
        self._rr = -1  # round-robin cursor
        self._probe_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._probe_index = 0  # running count, the serve.probe index
        self._dispatch_index = 0  # running count, the serve.dispatch index
        self.bound_port: Optional[int] = None

        r, p = (registry if registry is not None else Registry(),
                METRIC_PREFIX)
        self.registry = r
        self._c_requests = r.counter(
            p + "requests_total", "requests handled", labelnames=("code",))
        self._c_dispatches = r.counter(
            p + "dispatches_total", "upstream dispatch attempts",
            labelnames=("replica",))
        self._c_dispatch_failures = r.counter(
            p + "dispatch_failures_total",
            "dispatch attempts that failed over / errored",
            labelnames=("replica",))
        self._c_failovers = r.counter(
            p + "failovers_total",
            "requests that completed only via a retry on another attempt")
        self._c_midstream = r.counter(
            p + "midstream_failures_total",
            "streams cut after the first token (fail-fast, not retried)")
        self._c_probes = r.counter(
            p + "probes_total", "health probes", labelnames=("result",))
        self._c_breaker_opens = r.counter(
            p + "breaker_opens_total", "circuit-breaker open transitions",
            labelnames=("replica",))
        self._c_restarts = r.counter(
            p + "restarts_total", "replica restarts completed",
            labelnames=("replica",))
        self._c_scrape_failures = r.counter(
            p + "rollup_scrape_failures_total",
            "replica /metrics//trace scrapes that failed during a rollup")
        self._h_dispatch = r.histogram(
            p + "dispatch_seconds",
            "wall time of one successful upstream dispatch")
        self._g_breaker = r.gauge(
            p + "breaker_state",
            "per-replica breaker: 0 closed, 1 half-open, 2 open",
            labelnames=("replica",))
        self._g_healthy = r.gauge(
            p + "replica_healthy", "1 when the last probe succeeded",
            labelnames=("replica",))
        g = r.gauge
        g(p + "replicas", "registered replicas").set_function(
            lambda: len(self._replicas))
        g(p + "replicas_dispatchable",
          "replicas dispatch would consider right now").set_function(
            lambda: self._dispatchable_count())
        g(p + "inflight",
          "requests currently proxied to some replica").set_function(
            lambda: sum(rep.inflight for rep in self._replicas))
        self._callback_gauges = [
            p + k for k in ("replicas", "replicas_dispatchable", "inflight")]
        for rep in replicas:
            self.add_replica(rep)

    # ---- registry management ----------------------------------------------

    def add_replica(self, rep: Replica) -> Replica:
        with self._lock:
            if any(x.name == rep.name for x in self._replicas):
                raise RouterError(f"duplicate replica name {rep.name!r}")
            self._replicas.append(rep)
            self._g_breaker.labels(replica=rep.name).set(
                BREAKER_STATES[rep.breaker])
            self._g_healthy.labels(replica=rep.name).set(0)
        return rep

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def close(self) -> None:
        """Stop the prober and detach this router's scrape callbacks
        (the shared-registry retirement path, as ``Scheduler.close``)."""
        self.stop_probes()
        for name in self._callback_gauges:
            self.registry.unregister(name)

    # ---- breaker -----------------------------------------------------------

    def _set_breaker(self, rep: Replica, state: str) -> None:
        """Lock held by caller.  One gauge write per transition."""
        if rep.breaker == state:
            return
        if state == "open":
            rep.opened_at = time.monotonic()
            self._c_breaker_opens.labels(replica=rep.name).inc()
        rep.breaker = state
        rep.trial_inflight = False
        self._g_breaker.labels(replica=rep.name).set(BREAKER_STATES[state])

    def _record_failure(self, rep: Replica, err: str) -> None:
        with self._lock:
            rep.consecutive_failures += 1
            rep.last_error = err
            if rep.breaker == "half_open":
                self._set_breaker(rep, "open")  # trial failed: re-open
            elif (rep.breaker == "closed"
                  and rep.consecutive_failures >= self.failure_threshold):
                self._set_breaker(rep, "open")

    def _record_success(self, rep: Replica) -> None:
        with self._lock:
            rep.consecutive_failures = 0
            rep.last_error = None
            if rep.breaker != "closed":
                self._set_breaker(rep, "closed")

    # ---- probing -----------------------------------------------------------

    def start_probes(self) -> None:
        """One synchronous sweep (so the first dispatch after start sees
        real health), then the background prober thread."""
        if self._probe_thread is not None:
            return
        self.probe_now()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        self._probe_thread.start()

    def stop_probes(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10)
            self._probe_thread = None
        self._stop.clear()

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_now()
            self._stop.wait(self.probe_interval)

    def probe_now(self) -> None:
        """One probe sweep over the fleet (also the deterministic test
        hook — returns only when every probe finished).  Replicas are
        probed CONCURRENTLY: one wedged replica blocking its full
        probe_timeout must not stall health detection — or stale out
        the load scrapes — for the rest of the fleet."""
        todo = [rep for rep in self.replicas if not rep.restarting]
        if not todo:
            return
        if len(todo) == 1:
            self._probe_one(todo[0])
            return
        threads = [threading.Thread(target=self._probe_one, args=(rep,),
                                    daemon=True) for rep in todo]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _probe_one(self, rep: Replica) -> bool:
        with self._lock:  # deterministic fault indices under concurrency
            idx = self._probe_index
            self._probe_index += 1
        try:
            faults.fire("serve.probe", index=idx)
            body = self._http_json("GET", rep.url + "/healthz",
                                   timeout=self.probe_timeout)
            ok, draining = bool(body.get("ok")), bool(body.get("draining"))
        except _UpstreamHTTPError as e:
            # an HTTP response IS a live replica; only 503+draining is
            # the deliberate out-of-rotation signal, anything else is a
            # real failure (e.g. a dead engine loop behind /healthz)
            try:
                draining = bool(json.loads(e.body).get("draining"))
            except (ValueError, AttributeError):
                draining = False
            if e.code == 503 and draining:
                ok = True  # deliberate: breaker must NOT count it
            else:
                return self._probe_failed(rep, f"HTTP {e.code}")
        except Exception as e:  # noqa: BLE001 — any transport failure
            return self._probe_failed(rep, f"{type(e).__name__}: {e}")
        with self._lock:
            rep.last_probe_at = time.monotonic()
            rep.draining = draining
            rep.healthy = ok and not draining
            self._g_healthy.labels(replica=rep.name).set(
                1 if rep.healthy else 0)
        if draining:
            self._c_probes.labels(result="draining").inc()
            return True
        self._c_probes.labels(result="ok").inc()
        self._record_success(rep)
        self._scrape_load(rep)
        return True

    def _probe_failed(self, rep: Replica, err: str) -> bool:
        self._c_probes.labels(result="fail").inc()
        with self._lock:
            rep.last_probe_at = time.monotonic()
            rep.healthy = False
            rep.draining = False
            self._g_healthy.labels(replica=rep.name).set(0)
        self._record_failure(rep, err)
        return False

    def _scrape_load(self, rep: Replica) -> None:
        """Pull the least-loaded inputs off the replica's /metrics: the
        queue-wait p50 rollup gauge plus occupancy.  Best-effort — a
        failed scrape just leaves the load stale (round-robin covers
        it); it never counts toward the breaker (the probe that just
        succeeded is the liveness truth)."""
        try:
            text = self._http_text("GET", rep.url + "/metrics",
                                   timeout=self.probe_timeout)
        except Exception:  # noqa: BLE001
            self._c_scrape_failures.inc()
            return
        vals = _parse_gauges(text, (
            "fdtpu_serve_queue_wait_sec_p50",
            "fdtpu_serve_queue_depth",
            "fdtpu_serve_active_slots",
        ))
        with self._lock:
            rep.queue_wait_p50 = vals.get(
                "fdtpu_serve_queue_wait_sec_p50", math.nan)
            rep.queue_depth = int(vals.get("fdtpu_serve_queue_depth", 0))
            rep.active_slots = int(vals.get("fdtpu_serve_active_slots", 0))
            rep.load_at = time.monotonic()

    # ---- dispatch ----------------------------------------------------------

    def _dispatchable(self, rep: Replica, now: float) -> bool:
        """Lock held by caller.  Would pick() consider this replica?"""
        if rep.draining or rep.restarting:
            return False
        if rep.breaker == "open":
            if now - rep.opened_at < self.breaker_cooldown:
                return False
            self._set_breaker(rep, "half_open")
        if rep.breaker == "half_open":
            return not rep.trial_inflight
        return rep.healthy

    def _dispatchable_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(self._dispatchable(rep, now) for rep in self._replicas)

    def _pick(self, exclude) -> Replica:
        """Choose a replica and claim one in-flight ticket on it.

        Least-loaded by queue-wait p50 (NaN = no waits recorded yet =
        unloaded) with occupancy then round-robin tie-breaks, when every
        candidate's load scrape is fresh; pure round-robin otherwise.
        Half-open replicas are only used when no closed one is
        available — the trial request that would re-close the breaker
        must not jump the healthy fleet's queue."""
        now = time.monotonic()
        with self._lock:
            cands = [rep for rep in self._replicas
                     if rep not in exclude and self._dispatchable(rep, now)]
            closed = [rep for rep in cands if rep.breaker == "closed"]
            pool = closed or cands
            if not pool:
                raise NoReplicaAvailable(
                    "no dispatchable replica (dead, draining, restarting "
                    "or circuit-open); fleet size "
                    f"{len(self._replicas)}")
            fresh = all(now - rep.load_at <= self.metrics_stale_after
                        for rep in pool)
            # rotate so round-robin (and least-loaded ties) spread load
            start = (self._rr + 1) % len(pool)
            rotated = pool[start:] + pool[:start]
            if fresh:
                def load_key(rep: Replica):
                    p50 = rep.queue_wait_p50
                    return (0.0 if math.isnan(p50) else p50,
                            rep.queue_depth + rep.active_slots + rep.inflight)
                chosen = min(rotated, key=load_key)
            else:
                chosen = rotated[0]
            self._rr = pool.index(chosen)
            chosen.inflight += 1
            if chosen.breaker == "half_open":
                chosen.trial_inflight = True
            return chosen

    def _release(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            rep.trial_inflight = False

    def dispatch(self, payload: bytes, rid: str, stream: bool):
        """Route one /v1/generate body.  Returns either
        ``("json", code, body_bytes, replica_name)`` (response fully
        read — safe to have retried at any point) or
        ``("stream", response, first_line, replica_name)`` where
        ``response`` is the still-open upstream response positioned
        AFTER its first emitted line: everything up to and including the
        first token was covered by failover, everything after is the
        caller's fail-fast region.

        Raises :class:`..faults.RetryBudgetExceeded` when every attempt
        failed (``__cause__`` holds the last failure) — the HTTP layer
        maps it to 502/503."""
        exclude: set = set()
        state = {"attempts": 0}

        def attempt():
            with self._lock:  # deterministic fault indices
                idx = self._dispatch_index
                self._dispatch_index += 1
            state["attempts"] += 1
            faults.fire("serve.dispatch", index=idx)
            rep = self._pick(exclude)
            self._c_dispatches.labels(replica=rep.name).inc()
            t0 = time.monotonic()
            req = urllib.request.Request(
                rep.url + "/v1/generate", data=payload, method="POST",
                headers={"Content-Type": "application/json",
                         "X-Request-Id": rid})
            try:
                resp = urllib.request.urlopen(
                    req, timeout=self.upstream_timeout)
                if stream:
                    # the first line is the first token (or the terminal
                    # done/error line): reading it INSIDE the attempt
                    # keeps pre-first-token deaths retryable
                    first = resp.readline()
                    if not first:
                        raise ConnectionError(
                            "replica closed the stream before any token")
                    self._h_dispatch.observe(time.monotonic() - t0)
                    self._record_success(rep)
                    return ("stream", resp, first, rep)
                body = resp.read()
                code = resp.status
            except urllib.error.HTTPError as e:
                body = e.read()
                code = e.code
                if code == 503 and _body_draining(body):
                    # deliberate drain: route around, no breaker count
                    with self._lock:
                        rep.draining = True
                        rep.healthy = False
                    self._release(rep)
                    exclude.add(rep)
                    raise _DispatchFailed(
                        f"replica {rep.name} is draining") from e
                if code == 429:
                    # backpressure: the replica is healthy, just full —
                    # another replica may have room, so fail over
                    # without feeding the breaker
                    self._release(rep)
                    exclude.add(rep)
                    raise _DispatchFailed(
                        f"replica {rep.name} admission queue full") from e
                if code >= 500:
                    # a 5xx is the REPLICA's failure: nothing reached
                    # the client yet, so fail over — and feed the
                    # breaker instead of resetting it
                    self._release(rep)
                    self._c_dispatch_failures.labels(
                        replica=rep.name).inc()
                    self._record_failure(rep, f"HTTP {code}")
                    exclude.add(rep)
                    raise _DispatchFailed(
                        f"replica {rep.name} answered HTTP {code}") from e
                # 4xx: the CLIENT's error — passthrough, and the
                # replica answering at all is a liveness success
            except (OSError, urllib.error.URLError,
                    http.client.HTTPException) as e:
                # connection refused/reset, timeouts, half-written
                # responses: the replica-died-under-us family — count it
                # against the breaker and fail over
                self._release(rep)
                self._c_dispatch_failures.labels(replica=rep.name).inc()
                self._record_failure(rep, f"{type(e).__name__}: {e}")
                exclude.add(rep)
                raise _DispatchFailed(
                    f"replica {rep.name} ({rep.url}) failed before first "
                    f"token: {type(e).__name__}: {e}") from e
            self._h_dispatch.observe(time.monotonic() - t0)
            self._record_success(rep)
            # every "json" return is fully read — the ticket is done
            # (the stream return keeps it until the forward finishes)
            self._release(rep)
            return ("json", code, body, rep)

        result = faults.with_retries(
            attempt,
            tries=self.dispatch_tries,
            backoff=self.dispatch_backoff,
            site="serve.dispatch",
            retryable=lambda e: isinstance(
                e, (_DispatchFailed, NoReplicaAvailable,
                    faults.FaultInjected)),
        )
        if state["attempts"] > 1:
            self._c_failovers.inc()
        return result

    # ---- rollups -----------------------------------------------------------

    def health(self) -> dict:
        """The /healthz rollup: ok iff at least one replica is
        dispatchable, plus the full per-replica state table."""
        now = time.monotonic()
        entries = []
        with self._lock:
            reps = list(self._replicas)
            for rep in reps:
                p50 = rep.queue_wait_p50
                entries.append({
                    "name": rep.name,
                    "url": rep.url,
                    "healthy": rep.healthy,
                    "draining": rep.draining,
                    "restarting": rep.restarting,
                    "breaker": rep.breaker,
                    "consecutive_failures": rep.consecutive_failures,
                    "inflight": rep.inflight,
                    "queue_depth": rep.queue_depth,
                    "active_slots": rep.active_slots,
                    "queue_wait_sec_p50": (
                        None if math.isnan(p50) else p50),
                    "load_stale": now - rep.load_at
                    > self.metrics_stale_after,
                    "last_error": rep.last_error,
                })
        dispatchable = self._dispatchable_count()
        return {
            "ok": dispatchable > 0,
            "role": "router",
            "replicas": entries,
            "dispatchable": dispatchable,
        }

    def metrics_text(self) -> str:
        """The fleet /metrics rollup: every replica's exposition with an
        injected ``replica="<name>"`` label — series NAMES byte-identical
        to a direct replica scrape (parity-pinned in tests) — followed by
        the router's own registry."""
        fams: Dict[str, dict] = {}
        order: List[str] = []
        for rep in self.replicas:
            try:
                text = self._http_text("GET", rep.url + "/metrics",
                                       timeout=self.probe_timeout)
            except Exception:  # noqa: BLE001 — a dead replica must not
                self._c_scrape_failures.inc()  # kill the fleet scrape
                continue
            _merge_exposition(fams, order, text, rep.name)
        lines = []
        for name in order:
            fam = fams[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            lines.extend(fam["samples"])
        head = "\n".join(lines)
        return (head + "\n" if head else "") + self.registry.prometheus_text()

    def trace_document(self) -> dict:
        """The stitched fleet timeline: each replica's /trace document
        re-rooted on its own ``pid`` row (replica name in the process
        label), so one Perfetto load shows every replica's request
        tracks side by side — including a failed-over request's id on
        both its replicas."""
        events: List[dict] = []
        info = []
        for pid, rep in enumerate(self.replicas, start=1):
            try:
                doc = self._http_json("GET", rep.url + "/trace",
                                      timeout=self.probe_timeout)
            except _UpstreamHTTPError as e:
                info.append({"name": rep.name, "url": rep.url,
                             "error": f"HTTP {e.code}"})
                continue
            except Exception as e:  # noqa: BLE001
                self._c_scrape_failures.inc()
                info.append({"name": rep.name, "url": rep.url,
                             "error": f"{type(e).__name__}: {e}"})
                continue
            n = 0
            for ev in doc.get("traceEvents", []):
                ev = dict(ev)
                ev["pid"] = pid
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    ev["args"] = {
                        "name": f"replica {rep.name} ({rep.url})"}
                events.append(ev)
                n += 1
            other = doc.get("otherData", {})
            info.append({"name": rep.name, "url": rep.url, "pid": pid,
                         "events": n,
                         "dropped_events": other.get("dropped_events", 0)})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "fluxdistributed_tpu_torch.serve.router",
                "replicas": info,
            },
        }

    # ---- rolling restart ---------------------------------------------------

    def rolling_restart(self, drain_timeout: float = 30.0,
                        ready_timeout: float = 120.0,
                        poll: float = 0.05) -> List[dict]:
        """Restart every replica, one at a time, with traffic routed
        around the one in hand:

        1. mark it ``restarting`` (dispatch skips it from this instant);
        2. wait (bounded by ``drain_timeout``) for router-side in-flight
           requests to it to finish;
        3. call its ``restart`` hook — for supervised subprocess
           replicas that is SIGTERM (the replica's own graceful drain
           finishes anything the router didn't see) + respawn;
        4. probe until the successor reports healthy (bounded by
           ``ready_timeout``) before moving to the next replica.

        Returns one summary dict per replica.  Raises
        :class:`RouterError` if any replica lacks a restart hook or its
        successor never comes healthy — the fleet is left with the
        completed restarts in place."""
        with self._lock:
            reps = list(self._replicas)
            missing = [rep.name for rep in reps if rep.restart is None]
        if missing:
            raise RouterError(
                f"replicas {missing} have no restart hook — rolling "
                "restart needs supervised replicas (python -m "
                "fluxdistributed_tpu_torch.serve.router --spawn) or "
                "Replica(restart=...) callables")
        results = []
        for rep in reps:
            t0 = time.monotonic()
            with self._lock:
                rep.restarting = True
            deadline = t0 + drain_timeout
            while rep.inflight > 0 and time.monotonic() < deadline:
                time.sleep(poll)
            drained = rep.inflight == 0
            try:
                new_url = rep.restart(rep).rstrip("/")
            except Exception as e:
                with self._lock:
                    rep.restarting = False
                raise RouterError(
                    f"restart hook for replica {rep.name} failed: "
                    f"{type(e).__name__}: {e}") from e
            with self._lock:
                rep.url = new_url
                rep.consecutive_failures = 0
                rep.healthy = False
                rep.draining = False
                rep.load_at = 0.0
                self._set_breaker(rep, "closed")
            ready_deadline = time.monotonic() + ready_timeout
            while time.monotonic() < ready_deadline:
                if self._probe_one(rep) and rep.healthy:
                    break
                time.sleep(max(poll, 0.1))
            with self._lock:
                rep.restarting = False
            if not rep.healthy:
                raise RouterError(
                    f"replica {rep.name} did not come back healthy at "
                    f"{new_url} within {ready_timeout}s")
            self._c_restarts.labels(replica=rep.name).inc()
            results.append({
                "replica": rep.name,
                "url": new_url,
                "drained_clean": drained,
                "seconds": round(time.monotonic() - t0, 3),
            })
        return results

    # ---- HTTP plumbing -----------------------------------------------------

    @staticmethod
    def _http_text(method: str, url: str, timeout: float,
                   data: Optional[bytes] = None) -> str:
        req = urllib.request.Request(url, data=data, method=method)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode("utf-8", "replace")

    @staticmethod
    def _http_json(method: str, url: str, timeout: float,
                   data: Optional[bytes] = None) -> dict:
        req = urllib.request.Request(url, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise _UpstreamHTTPError(e.code, e.read()) from e

    # ---- the front HTTP server --------------------------------------------

    def make_handler(self):
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, body: bytes, ctype: str, rid=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if rid:
                    self.send_header("X-Request-Id", rid)
                self.end_headers()
                self.wfile.write(body)
                outer._c_requests.labels(code=str(code)).inc()

            def _send_json(self, code, obj, rid=None):
                self._send(code, json.dumps(obj).encode(),
                           "application/json", rid=rid)

            def do_GET(self):
                if self.path == "/healthz":
                    h = outer.health()
                    self._send_json(200 if h["ok"] else 503, h)
                elif self.path == "/metrics":
                    self._send(200, outer.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/trace":
                    self._send_json(200, outer.trace_document())
                elif self.path == "/admin/replicas":
                    self._send_json(200, outer.health()["replicas"])
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/v1/generate":
                    self._generate()
                elif self.path == "/admin/rolling_restart":
                    self._rolling_restart()
                elif self.path == "/admin/probe":
                    outer.probe_now()
                    self._send_json(200, outer.health())
                else:
                    self._send_json(404, {"error": "not found"})

            def _rolling_restart(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    results = outer.rolling_restart(
                        drain_timeout=float(body.get("drain_timeout", 30.0)),
                        ready_timeout=float(
                            body.get("ready_timeout", 120.0)))
                except RouterError as e:
                    self._send_json(500, {"error": str(e)})
                    return
                except (ValueError, TypeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(200, {"restarted": results})

            def _generate(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(n)
                try:
                    body = json.loads(payload or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                # the correlation id that stitches router logs to every
                # replica timeline this request touches: the client's,
                # or a router-minted one
                rid = str(self.headers.get("X-Request-Id")
                          or f"rt-{next(_request_ids)}-"
                             f"{uuid.uuid4().hex[:8]}")[:128]
                stream = bool(body.get("stream", False))
                try:
                    result = outer.dispatch(payload, rid, stream)
                except faults.RetryBudgetExceeded as e:
                    cause = e.__cause__
                    code = (503 if isinstance(cause, NoReplicaAvailable)
                            else 502)
                    self._send_json(code, {
                        "error": str(cause) if cause else str(e),
                        "request_id": rid,
                    }, rid=rid)
                    return
                if result[0] == "json":
                    _, code, data, rep = result
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("X-Request-Id", rid)
                    self.send_header("X-Fdtpu-Replica", rep.name)
                    self.end_headers()
                    self.wfile.write(data)
                    outer._c_requests.labels(code=str(code)).inc()
                    return
                _, resp, first, rep = result
                self._forward_stream(resp, first, rep, rid)

            def _forward_stream(self, resp, first: bytes, rep, rid: str):
                """Forward the already-open upstream stream.  The first
                token was read inside the (retryable) dispatch; from
                here an upstream death fails FAST with the replica
                named — tokens already forwarded cannot be replayed."""

                def chunk(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                code = 200
                try:
                    # header writes sit INSIDE the release scope: a
                    # client that vanished already would otherwise leak
                    # the replica's inflight ticket and the open
                    # upstream response
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/jsonlines")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Request-Id", rid)
                    self.send_header("X-Fdtpu-Replica", rep.name)
                    self.end_headers()
                    # upstream reads and downstream writes fail for
                    # DIFFERENT parties: only a read failure is the
                    # replica's fault (breaker + fail-fast error line);
                    # a write failure is the client leaving (499, and
                    # the replica stays innocent)
                    upstream_err = None
                    line = first
                    while line:
                        chunk(line)  # downstream: errors escape to 499
                        try:
                            line = resp.readline()
                        except (OSError,
                                http.client.HTTPException) as e:
                            upstream_err = e
                            break
                    if upstream_err is not None:
                        # mid-stream upstream death: no transparent
                        # retry possible, say exactly who died
                        outer._c_midstream.inc()
                        outer._c_dispatch_failures.labels(
                            replica=rep.name).inc()
                        outer._record_failure(
                            rep, f"mid-stream: "
                                 f"{type(upstream_err).__name__}: "
                                 f"{upstream_err}")
                        code = 502
                        chunk((json.dumps({
                            "done": False,
                            "error": f"replica {rep.name} ({rep.url}) "
                                     f"failed mid-stream after first "
                                     f"token: "
                                     f"{type(upstream_err).__name__}: "
                                     f"{upstream_err}",
                            "replica": rep.name,
                            "request_id": rid,
                        }) + "\n").encode())
                    chunk(b"")  # terminal zero-length chunk
                except (BrokenPipeError, ConnectionResetError):
                    code = 499  # client went away; nginx's convention
                finally:
                    try:
                        resp.close()
                    except OSError:
                        pass
                    outer._release(rep)
                    outer._c_requests.labels(code=str(code)).inc()

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8100):
        """Build the front ThreadingHTTPServer (probes started); caller
        runs ``serve_forever`` — the LMServer pattern."""
        self.start_probes()
        httpd = HTTPServer((host, port), self.make_handler())
        self.bound_port = httpd.server_address[1]
        return httpd


class _UpstreamHTTPError(RuntimeError):
    """An upstream replied with an HTTP error status (body preserved)."""

    def __init__(self, code: int, body: bytes):
        super().__init__(f"HTTP {code}")
        self.code = code
        self.body = body


def _body_draining(body: bytes) -> bool:
    try:
        return bool(json.loads(body).get("draining"))
    except (ValueError, AttributeError):
        return False


def _parse_gauges(text: str, names) -> Dict[str, float]:
    """Pull unlabeled series values out of exposition text (the load
    scrape: three gauges off a multi-KB page, no full parse needed)."""
    want = set(names)
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        if series in want:
            try:
                out[series] = float(value)
            except ValueError:
                pass
    return out


def _inject_replica_label(series: str, replica: str) -> str:
    esc = replica.replace("\\", "\\\\").replace('"', '\\"')
    i = series.find("{")
    if i == -1:
        return f'{series}{{replica="{esc}"}}'
    return f'{series[:i]}{{replica="{esc}",{series[i + 1:]}'


def _merge_exposition(fams: Dict[str, dict], order: List[str],
                      text: str, replica: str) -> None:
    """Fold one replica's Prometheus text into the family table with the
    ``replica`` label injected into every sample.  Relies on the
    registry's exposition shape (HELP/TYPE immediately precede their
    samples), which both ends of this scrape share."""
    cur: Optional[str] = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            fam = fams.get(name)
            if fam is None:
                fam = fams[name] = {"help": help_text, "type": "untyped",
                                    "samples": []}
                order.append(name)
            cur = name
        elif line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            fam = fams.get(name)
            if fam is None:
                fam = fams[name] = {"help": "", "type": kind, "samples": []}
                order.append(name)
            else:
                fam["type"] = kind
            cur = name
        elif line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            if cur is None:  # exposition without comments: family = name
                cur = series.split("{", 1)[0]
                if cur not in fams:
                    fams[cur] = {"help": "", "type": "untyped",
                                 "samples": []}
                    order.append(cur)
            fams[cur]["samples"].append(
                f"{_inject_replica_label(series, replica)} {value}")


# ---------------------------------------------------------------------------
# supervised subprocess replicas
# ---------------------------------------------------------------------------


class SupervisedReplica:
    """Spawn-and-restart manager for one replica subprocess (``python -m
    fluxdistributed_tpu_torch.serve ...``, or any server that keeps the
    same contract, ``bin/serve.py --lm`` included).

    The child is started with ``--port 0`` (unless ``port`` pins one)
    and announces its ephemeral port with a ``FDTPU_SERVE_PORT=<n>``
    stdout line — the race-free fleet-orchestration contract.  Its
    remaining stdout is pumped to our stderr (prefixed) so replica logs
    stay visible without deadlocking the pipe.

    :meth:`restart` is shaped as a :class:`Replica` restart hook:
    SIGTERM (the replica's graceful drain finishes in-flight work),
    bounded wait, then respawn.
    """

    def __init__(self, argv: Sequence[str], name: str = "replica",
                 env: Optional[dict] = None,
                 startup_timeout: float = 180.0,
                 stop_timeout: float = 45.0,
                 verbose: bool = True):
        self.argv = list(argv)
        self.name = name
        self.env = env
        self.startup_timeout = startup_timeout
        self.stop_timeout = stop_timeout
        #: forward the child's output to our stderr (prefixed).  Tests
        #: pass False: interleaved replica logs corrupt line-oriented
        #: consumers of the parent's output (e.g. pytest progress lines)
        self.verbose = verbose
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None

    def _argv_with_port(self, port: Optional[int]) -> List[str]:
        argv = list(self.argv)
        if "--port" in argv:
            i = argv.index("--port")
            if port is not None:
                argv[i + 1] = str(port)
        else:
            argv += ["--port", "0" if port is None else str(port)]
        return argv

    def spawn(self, port: Optional[int] = None) -> str:
        """Start the child and block until it announces its bound port
        (or dies / times out).  Returns the replica base url."""
        argv = self._argv_with_port(port)
        env = dict(os.environ, **(self.env or {}))
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1, env=env)
        proc = self.proc
        # a watchdog, not a deadline check between lines: a child that
        # hangs SILENTLY would park readline() forever otherwise
        timer = threading.Timer(
            self.startup_timeout,
            lambda: proc.poll() is None and proc.kill())
        timer.daemon = True
        timer.start()
        sock = None
        assert proc.stdout is not None
        try:
            for line in proc.stdout:
                if self.verbose:
                    sys.stderr.write(f"[{self.name}] {line}")
                if line.startswith("FDTPU_SERVE_PORT="):
                    sock = int(line.split("=", 1)[1].strip())
                    break
        finally:
            timer.cancel()
        if sock is None:
            rc = proc.poll()
            self.stop(sig=signal.SIGKILL)
            raise RouterError(
                f"replica {self.name} "
                + (f"exited (rc={rc})" if rc is not None
                   else f"hung for {self.startup_timeout}s")
                + f" before announcing its port: {' '.join(argv)}")
        self.port = sock
        threading.Thread(target=self._pump, name=f"{self.name}-stdout",
                         daemon=True).start()
        return f"http://127.0.0.1:{self.port}"

    def _pump(self) -> None:
        proc = self.proc
        if proc is None or proc.stdout is None:
            return
        try:
            for line in proc.stdout:
                if self.verbose:
                    sys.stderr.write(f"[{self.name}] {line}")
        except (ValueError, OSError):
            pass  # stream closed at teardown

    def stop(self, sig: int = signal.SIGTERM) -> Optional[int]:
        """Signal the child (SIGTERM = graceful drain) and wait for it,
        escalating to SIGKILL at ``stop_timeout``.  Returns the exit
        code (None if there was no child)."""
        proc = self.proc
        if proc is None:
            return None
        if proc.poll() is None:
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout=self.stop_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        rc = proc.returncode
        if proc.stdout is not None:
            try:
                proc.stdout.close()
            except OSError:
                pass
        self.proc = None
        return rc

    def restart(self, rep: Optional[Replica] = None,
                port: Optional[int] = None) -> str:
        """The :class:`Replica` restart hook: graceful stop, respawn,
        new url."""
        self.stop()
        return self.spawn(port=port)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def wait_http_ready(url: str, timeout: float = 60.0,
                    poll: float = 0.1) -> dict:
    """Poll ``url`` (a /healthz) until it answers 200, for fleet
    bring-up in scripts/tests.  Returns the body; raises on timeout."""
    deadline = time.monotonic() + timeout
    last = "never reached"
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            last = f"HTTP {e.code}"
        except (OSError, urllib.error.URLError, socket.timeout) as e:
            last = f"{type(e).__name__}: {e}"
        time.sleep(poll)
    raise TimeoutError(f"{url} not ready within {timeout}s ({last})")


# ---------------------------------------------------------------------------
# the command line: python -m fluxdistributed_tpu_torch.serve.router
# ---------------------------------------------------------------------------

#: the port's LM server; the default replica command of --smoke
SERVE_MODULE = "fluxdistributed_tpu_torch.serve"



def _replica_env() -> dict:
    """Env for spawned replica children: they import the package from
    the checkout this process runs from."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return {"PYTHONPATH": os.pathsep.join(
        x for x in (root, os.environ.get("PYTHONPATH")) if x)}


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.serve.router",
        description=__doc__.split("\n")[0])
    p.add_argument("--replica", action="append", default=[],
                   metavar="URL", dest="replicas",
                   help="replica base url (repeatable): front an "
                        "existing fleet")
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="supervise N replica subprocesses spawned from "
                        "--replica-cmd (--port 0 appended; the bound "
                        "port is read from the child's "
                        "FDTPU_SERVE_PORT= line) — enables rolling "
                        "restarts")
    p.add_argument("--replica-cmd", default=None, metavar="CMD",
                   help="command line for --spawn replicas, e.g. "
                        f"\"python -m {SERVE_MODULE} --model lm_small "
                        "--max-slots 4 --max-len 256\"")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100,
                   help="router port (0 = ephemeral, announced as "
                        "FDTPU_ROUTER_PORT=<n> on stdout)")
    p.add_argument("--probe-interval", type=float, default=0.5,
                   help="seconds between /healthz probe sweeps")
    p.add_argument("--probe-timeout", type=float, default=2.0)
    p.add_argument("--failure-threshold", type=int, default=3,
                   help="consecutive probe/dispatch failures that open "
                        "a replica's circuit breaker")
    p.add_argument("--breaker-cooldown", type=float, default=2.0,
                   help="seconds an open breaker waits before "
                        "half-opening for a trial request")
    p.add_argument("--dispatch-tries", type=int, default=3,
                   help="dispatch attempts per request (failover "
                        "budget, faults.with_retries semantics)")
    p.add_argument("--upstream-timeout", type=float, default=600.0,
                   help="socket timeout per upstream dispatch")
    p.add_argument("--metrics-stale-after", type=float, default=3.0,
                   help="seconds after which a replica's load scrape "
                        "is stale and dispatch falls back to "
                        "round-robin")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="per-replica in-flight drain bound during "
                        "--rolling-restart")
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="router-side deterministic fault injection "
                        "(sites serve.dispatch / serve.probe); JSON "
                        "object or @file")
    p.add_argument("--rolling-restart", default=None, metavar="ROUTER_URL",
                   help="client mode: ask the running router at "
                        "ROUTER_URL to rolling-restart its supervised "
                        "fleet, print the result, exit")
    p.add_argument("--smoke", action="store_true",
                   help="run the self-contained 2-replica failover "
                        "smoke (fake engines, deterministic mid-burst "
                        "kill, rolling restart) and exit nonzero on "
                        "any dropped request")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the stitched fleet Perfetto trace here "
                        "(smoke mode)")
    return p


def make_router(args):
    """Build the Router (+ spawned SupervisedReplicas in --spawn mode).
    Returns ``(router, supervisors)``."""
    import shlex

    router = Router(
        probe_interval=args.probe_interval,
        probe_timeout=args.probe_timeout,
        failure_threshold=args.failure_threshold,
        breaker_cooldown=args.breaker_cooldown,
        metrics_stale_after=args.metrics_stale_after,
        dispatch_tries=args.dispatch_tries,
        upstream_timeout=args.upstream_timeout,
    )
    sups = []
    for i, url in enumerate(args.replicas):
        router.add_replica(Replica(name=f"r{i}", url=url))
    if args.spawn:
        if not args.replica_cmd:
            raise SystemExit("--spawn needs --replica-cmd")
        base = len(args.replicas)
        argv = shlex.split(args.replica_cmd)
        for i in range(args.spawn):
            name = f"r{base + i}"
            sup = SupervisedReplica(argv, name=name, env=_replica_env())
            url = sup.spawn()
            sups.append(sup)
            router.add_replica(Replica(name=name, url=url,
                                       restart=sup.restart))
    if not router.replicas:
        raise SystemExit("no replicas: pass --replica URL and/or --spawn N")
    return router, sups


def rolling_restart_client(url: str, drain_timeout: float) -> int:
    req = urllib.request.Request(
        url.rstrip("/") + "/admin/rolling_restart",
        data=json.dumps({"drain_timeout": drain_timeout}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
    except urllib.error.HTTPError as e:
        print(e.read().decode(), file=sys.stderr)
        return 1
    print(json.dumps(body, indent=2))
    return 0


def run_smoke(args) -> int:
    """2 fake-engine replica subprocesses; replica r0 carries a fault
    plan that hard-kills it (``os._exit``) at scheduler tick 60 —
    mid-burst.  A 32-request concurrent burst through the router must
    complete with ZERO failures and byte-exact deterministic tokens
    (failed-over requests re-generate identically on the survivor);
    the dead replica's breaker must open, then recover through
    half-open once it is brought back; a rolling restart under light
    load must drop nothing.  The stitched /trace goes to --trace-out."""
    from .testing import fake_tokens

    env = _replica_env()
    kill_plan = json.dumps(
        {"fail": [{"site": "serve.tick", "at": 60, "action": "exit"}]})

    def replica_argv(extra):
        return ([sys.executable, "-m", SERVE_MODULE, "--fake-engine",
                 "--vocab", "256", "--max-slots", "4", "--max-len", "256",
                 "--max-queue", "64", "--fake-step-delay", "0.005",
                 "--trace-requests", os.devnull, "--port", "0"]
                + extra)

    sup0 = SupervisedReplica(replica_argv(["--fault-plan", kill_plan]),
                             name="r0", env=env)
    sup1 = SupervisedReplica(replica_argv([]), name="r1", env=env)
    url0, url1 = sup0.spawn(), sup1.spawn()
    wait_http_ready(url0 + "/healthz")
    wait_http_ready(url1 + "/healthz")

    router = Router(probe_interval=0.2, probe_timeout=2.0,
                    failure_threshold=2, breaker_cooldown=0.5,
                    dispatch_tries=4, upstream_timeout=60.0)
    rep0 = router.add_replica(Replica("r0", url0, restart=sup0.restart))
    router.add_replica(Replica("r1", url1, restart=sup1.restart))
    httpd = router.serve("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{router.bound_port}"
    failures = []

    def post(i, results):
        prompt = [i % 7 + 1, i % 5 + 1, i % 3 + 1]
        body = json.dumps({"prompt_tokens": prompt,
                           "max_tokens": 24}).encode()
        req = urllib.request.Request(
            f"{base}/v1/generate", data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Request-Id": f"smoke-{i}"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, json.loads(r.read()))
        except Exception as e:  # noqa: BLE001 — tallied below
            results[i] = (None, f"{type(e).__name__}: {e}")

    def burst(n, tag):
        results = {}
        threads = [threading.Thread(target=post, args=(i, results))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (code, body) in sorted(results.items()):
            if code != 200:
                failures.append(f"{tag} request {i}: {code} {body}")
                continue
            if body.get("request_id") != f"smoke-{i}":
                failures.append(
                    f"{tag} request {i}: X-Request-Id not preserved "
                    f"({body.get('request_id')!r})")
            prompt = [i % 7 + 1, i % 5 + 1, i % 3 + 1]
            want = fake_tokens(prompt, 24)
            if body.get("generated") != want:
                failures.append(
                    f"{tag} request {i}: tokens diverged after "
                    f"failover: {body.get('generated')} != {want}")
        return results

    print("smoke: mid-burst kill (r0 exits at tick 60)...")
    burst(32, "kill-burst")
    deadline = time.monotonic() + 10
    while sup0.alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    if sup0.alive():
        failures.append("fault plan did not kill r0")
    router.probe_now()
    opens = router.registry.value(
        "fdtpu_router_breaker_opens_total", "r0")
    if opens < 1:
        failures.append(f"breaker for r0 never opened (opens={opens})")

    print("smoke: r0 returns at its old port; breaker must recover...")
    old_port = sup0.port
    sup0.stop()  # reap the dead child
    sup0.argv = replica_argv([])  # successor WITHOUT the kill plan
    sup0.spawn(port=old_port)
    wait_http_ready(url0 + "/healthz")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        router.probe_now()
        if rep0.breaker == "closed" and rep0.healthy:
            break
        time.sleep(0.1)
    if rep0.breaker != "closed":
        failures.append(
            f"breaker for r0 did not re-close (state={rep0.breaker})")

    print("smoke: rolling restart under light load...")
    stop_load = threading.Event()
    load_results = {}

    def light_load():
        i = 1000
        while not stop_load.is_set():
            post(i, load_results)
            i += 1
            time.sleep(0.05)

    load_thread = threading.Thread(target=light_load, daemon=True)
    load_thread.start()
    try:
        restarted = router.rolling_restart(drain_timeout=20.0,
                                           ready_timeout=60.0)
    finally:
        stop_load.set()
        load_thread.join(timeout=10)
    for i, (code, body) in sorted(load_results.items()):
        if code != 200:
            failures.append(
                f"rolling-restart load request {i}: {code} {body}")
    if len(restarted) != 2:
        failures.append(f"rolling restart covered {len(restarted)}/2")

    burst(8, "post-restart")
    doc = router.trace_document()
    pids = {e.get("pid") for e in doc["traceEvents"]}
    if len(pids) < 2:
        failures.append(f"stitched trace has {len(pids)} replica rows")
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(doc, f)
        print(f"stitched trace ({len(doc['traceEvents'])} events, "
              f"{len(pids)} replica rows) written to {args.trace_out}")

    httpd.shutdown()
    router.close()
    for sup in (sup0, sup1):
        sup.stop()
    if failures:
        print("SMOKE FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("smoke OK: 40 routed requests, 0 failures, breaker opened "
          "on the kill and recovered, rolling restart dropped nothing")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fault_plan:
        faults.install_plan_arg(args.fault_plan)
    if args.rolling_restart:
        return rolling_restart_client(args.rolling_restart,
                                      args.drain_timeout)
    if args.smoke:
        return run_smoke(args)
    router, sups = make_router(args)
    httpd = router.serve(args.host, args.port)
    print(f"FDTPU_ROUTER_PORT={router.bound_port}", flush=True)
    print(f"routing {len(router.replicas)} replicas on "
          f"http://{args.host}:{router.bound_port}/v1/generate "
          f"(ctrl-c to stop)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
        for sup in sups:
            sup.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
