"""Observability: the port of the JAX package's ``obs`` layer.

* :mod:`.metrics` — the process-wide Counter/Gauge/Histogram registry
  with Prometheus text and JSONL snapshots;
* :mod:`.spans` — nested step-phase spans exported as Chrome/Perfetto
  trace-event JSON;
* :mod:`.watchdog` — rolling-median stall detection, the OOM-skip
  counter and the low-headroom alert;
* :mod:`.memstats` — the priced memory of a step (its static half) and
  live per-device memory gauges (``fdtpu_hbm_*``) off the CUDA caching
  allocator, ``None``-safe on the CPU;
* :mod:`.pricing` — a step run once on fake tensors over a fake world
  (what the static half, the ledger and the profile read);
* :mod:`.comms` — the collective ledger: the collectives a step issues,
  per mesh axis;
* :mod:`.profile` — the cost-profile artifact (``fdtpu-profile/v2``);
* :mod:`.server` — stdlib-HTTP ``/metrics`` and ``/healthz``;
* :mod:`.flight` — the black-box flight recorder;
* :mod:`.runs` — the cross-run ledger and the ``fdtpu_run_info`` gauge;
* :mod:`.reqtrace` — the serving tier's request tracer.

:class:`Observation` bundles the per-run pieces ``train`` threads
through its loop.  The JAX package's ``obs.jaxmon`` (the compile
counters) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import memstats, runs
from .flight import FlightRecorder, read_flight
from .memstats import HbmGauges
from .metrics import (Counter, Gauge, Histogram, JsonlSink, Registry,
                      bucket_percentile, get_registry)
from .reqtrace import RequestTracer
from .server import MetricsServer, start_metrics_server
from .spans import SpanTracer, current_span, innermost_active
from .watchdog import StepWatchdog

__all__ = ["Counter", "FlightRecorder", "Gauge", "HbmGauges", "Histogram",
           "JsonlSink", "MetricsServer", "Observation", "Registry",
           "RequestTracer", "SpanTracer", "StepWatchdog",
           "bucket_percentile", "current_span", "get_registry",
           "innermost_active", "memstats", "read_flight", "runs",
           "start_metrics_server"]


@dataclasses.dataclass
class Observation:
    """What the training loop instruments, bundled.

    Attributes
    ----------
    registry: where counters and histograms live (the process registry
        by default)
    tracer: a span tracer, or ``None`` for metrics only (no timeline)
    watchdog: a stall watchdog, or ``None``; ``train`` starts and stops
        it
    trace_path: write the tracer's Chrome trace JSON here when training
        ends (needs ``tracer``)
    device_sync: wait for each step's device work
        (``torch.cuda.synchronize``) inside a ``device`` phase.  That
        ends the host's run-ahead, so the device's time is attributed
        to the step that spent it: right for reading a breakdown, wrong
        as a default (it serialises the host and the card).
    steady_after: the JAX package's steady-state recompile flag, which
        reads the compile counters of ``obs.jaxmon``; not ported (must
        be ``None``)
    jsonl_path: append a registry snapshot line here at the print
        cadence and at exit
    profile_path: write the cost-profile artifact here when ``train``
        ends (:func:`.profile.collect_profile`: the static costs of the
        model and of the step at the run's shapes, priced on fake
        tensors, the step's priced memory and ledger, the measured
        phase histograms; the coordinator only)
    flight: a live :class:`FlightRecorder`, or ``flight_path`` for
        ``train`` to build one
    """

    registry: Registry = dataclasses.field(default_factory=get_registry)
    tracer: Optional[SpanTracer] = None
    watchdog: Optional[StepWatchdog] = None
    trace_path: Optional[str] = None
    device_sync: bool = False
    steady_after: Optional[int] = None
    jsonl_path: Optional[str] = None
    profile_path: Optional[str] = None
    flight: Optional[FlightRecorder] = None
    flight_path: Optional[str] = None

    def __post_init__(self):
        if self.steady_after is not None:
            raise NotImplementedError(
                "Observation(steady_after=...) flags steady-state "
                "recompiles through the compile counters of obs.jaxmon, "
                "which the port does not have yet (they come with its "
                "compilation cache, ROADMAP Queue A item 6); pass "
                "steady_after=None")

    @classmethod
    def default(cls) -> "Observation":
        """Metrics only: counters and phase histograms in the process
        registry; no span buffer, no watchdog thread, no device sync."""
        return cls()

    @classmethod
    def full(cls, trace_path: Optional[str] = None,
             registry: Optional[Registry] = None,
             watchdog_factor: float = 5.0,
             steady_after: Optional[int] = None,
             jsonl_path: Optional[str] = None,
             profile_path: Optional[str] = None,
             flight_path: Optional[str] = None) -> "Observation":
        """Everything on: spans (the trainer's phase histogram reads the
        same brackets), the stall watchdog and a device sync a step."""
        registry = registry or get_registry()
        return cls(registry=registry, tracer=SpanTracer(),
                   watchdog=StepWatchdog(factor=watchdog_factor,
                                         registry=registry),
                   trace_path=trace_path, device_sync=True,
                   steady_after=steady_after, jsonl_path=jsonl_path,
                   profile_path=profile_path, flight_path=flight_path)
