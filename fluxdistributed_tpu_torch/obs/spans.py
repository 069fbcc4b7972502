"""Nested step-phase spans with Chrome/Perfetto trace-event export.

(A copy of the JAX package's stdlib-only ``obs/spans.py``.)

``torch.profiler`` answers "what did the DEVICE do" at ~GB trace cost for
a fixed window; this tracer answers "where did the HOST loop's time go"
continuously and for pennies: the trainer brackets every phase of every
step (data-wait / h2d / dispatch / device / eval / checkpoint) in a
span, spans nest through a contextvar (so helper code can add spans
without threading a handle), and the buffer exports as Chrome
trace-event JSON — load it at ``chrome://tracing`` or ui.perfetto.dev
next to a device trace.

Overhead discipline:

* a **disabled** tracer hands out one shared no-op context manager —
  the instrumented hot loop pays an attribute load and a truthiness
  check, no allocation;
* an **enabled** tracer appends one small dict per span to a bounded
  ring (default 200k events ≈ a few hours of stepping) under a lock
  only at span END; timestamps come from ``perf_counter`` (monotonic,
  ns resolution).

Spans can simultaneously feed a registry :class:`~.metrics.Histogram`
labeled by phase, so the SAME brackets produce both the live
``/metrics`` percentiles and the offline timeline.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

from .metrics import Histogram

__all__ = ["SpanTracer", "current_span", "innermost_active", "phase_scope"]

# name of the innermost open span in this context ("" at top level);
# contextvars give correct nesting across threads AND async contexts
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "fdtpu_span_stack", default=()
)


def current_span() -> Optional[str]:
    """Innermost open span name in the calling context, or ``None``."""
    s = _stack.get()
    return s[-1] if s else None


# -- cross-thread active-span registry -------------------------------------
# The contextvar above answers "where am I" for the CALLING context; the
# stall watchdog needs "where is the LOOP" from its own daemon thread.
# Every open span (and every tracer-less phase bracket via phase_scope)
# also registers here: {thread_id: [(seq, name), ...]}, where seq is a
# global open-order counter so "innermost" is well-defined across
# threads.  One small lock + list op per span — phases tick a handful of
# times per step, never per token.
_active_lock = threading.Lock()
_active: dict = {}
_active_seq = itertools.count(1)


def _active_push(name: str) -> None:
    tid = threading.get_ident()
    with _active_lock:
        _active.setdefault(tid, []).append((next(_active_seq), name))


def _active_pop() -> None:
    tid = threading.get_ident()
    with _active_lock:
        stack = _active.get(tid)
        if stack:
            stack.pop()
        if not stack:
            _active.pop(tid, None)


def innermost_active() -> Optional[str]:
    """Name of the most recently OPENED still-open span/phase across all
    threads, or ``None`` — what the stall watchdog reports as "where the
    loop is wedged" (a stalled step is, by definition, inside whichever
    bracket opened last and never closed)."""
    with _active_lock:
        newest, name = 0, None
        for stack in _active.values():
            if stack and stack[-1][0] > newest:
                newest, name = stack[-1]
    return name


@contextlib.contextmanager
def phase_scope(name: str):
    """Register ``name`` as the active phase WITHOUT a tracer: the
    metrics-only trainer path brackets its phases with this so the
    watchdog can still name where a stall happened (no event buffer, no
    histogram — just the active-span registry above)."""
    _active_push(name)
    try:
        yield
    finally:
        _active_pop()


class _NullSpan:
    """The disabled path — one shared instance, __enter__/__exit__ only."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_token")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._token = _stack.set(_stack.get() + (self.name,))
        _active_push(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _active_pop()
        _stack.reset(self._token)
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class SpanTracer:
    """Collects spans; exports Chrome trace-event JSON.

    Parameters
    ----------
    enabled: hand out real spans (False = shared no-op, near-zero cost)
    max_events: ring capacity; oldest events drop first (a days-long run
        must not grow host memory without bound)
    histogram: optional labeled :class:`Histogram` — every completed
        span also observes its seconds under ``{label: name}`` so the
        same bracket feeds /metrics
    label: the histogram's label name (default ``"phase"``)
    """

    def __init__(
        self,
        enabled: bool = True,
        max_events: int = 200_000,
        histogram: Optional[Histogram] = None,
        label: str = "phase",
    ):
        self.enabled = enabled
        self.histogram = histogram
        self.label = label
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        # trace-event ts fields are µs relative to this origin; pairing
        # with wall time lets readers line the trace up with log stamps
        self._origin = time.perf_counter()
        self._origin_unix = time.time()
        self.dropped = 0

    def span(self, name: str, **args):
        """``with tracer.span("data_wait"):`` — bracket one phase."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def _record(self, name, t0, t1, args) -> None:
        if self.histogram is not None:
            self.histogram.labels(**{self.label: name}).observe(t1 - t0)
        ev = {
            "name": name,
            "ph": "X",  # complete event: begin ts + dur in one record
            "ts": (t0 - self._origin) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": 0,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "cat": "fdtpu",
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def trace_events(self) -> list:
        """The Chrome trace-event list (JSON-ready dicts, time-ordered
        per thread by construction)."""
        with self._lock:
            return list(self._events)

    def export_chrome_trace(self, path: str) -> int:
        """Write the buffer as a Chrome/Perfetto trace-event JSON file;
        returns the number of events written.

        The JSON Object Format (``{"traceEvents": [...]}``) is used
        rather than the bare array so metadata rides along; both load in
        chrome://tracing and Perfetto.
        """
        events = self.trace_events()
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "origin_unix_time": self._origin_unix,
                "dropped_events": self.dropped,
                "producer": "fluxdistributed_tpu_torch.obs.spans",
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)
