"""Request-scoped tracing for the serve stack (a copy of the JAX
package's stdlib-only ``obs/reqtrace.py``): one Perfetto track per
request, lifecycle events in a bounded ring.

The scheduler's aggregate metrics say how the FLEET is doing; routing
and tail-latency work need per-REQUEST truth — where did *this*
request's 900 ms go: queue wait, chunked prefill behind someone else's
long prompt, or slow decode ticks?  :class:`RequestTracer` is the data
layer for that question:

* every request gets a **trace id** (the client's ``X-Request-Id``
  header when given, the scheduler's request id otherwise) that rides
  HTTP → :class:`~..serve.scheduler.Scheduler` → the engine's prefill
  state, so every event along the way lands on the same timeline row;
* the scheduler emits **lifecycle events** — enqueue, queue_wait,
  prefill / prefill_chunk k, first_token, per-token decode ticks,
  finish / cancel / drain — into a bounded ring (a days-long server
  must not grow host memory without bound);
* :meth:`RequestTracer.export_chrome_trace` renders the ring as
  Chrome/Perfetto trace-event JSON where **each request is its own
  track** (``pid`` = the serve process row, ``tid`` = a per-request
  lane named by metadata events), so ui.perfetto.dev shows request
  timelines stacked the way a waterfall view should read.

Clocking: events are stamped with the SAME ``time.monotonic`` clock the
scheduler's ``submitted_at`` / ``first_token_at`` fields use, so spans
can be emitted retroactively from those fields without skew.

Overhead: one dict append per event under a short lock; per-token
events only exist while a tracer is attached (the default scheduler has
none), and even then the deque is bounded.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["RequestTracer"]

#: pid of the request-track rows in the exported trace (one synthetic
#: "process" that holds one thread-lane per request)
_TRACE_PID = 1


class RequestTracer:
    """Bounded ring of per-request lifecycle events.

    Parameters
    ----------
    max_events: ring capacity — oldest events drop first (the count of
        dropped events is exported in the trace metadata, so a
        truncated timeline says so)
    max_lanes: cap on remembered ``trace id → lane`` entries — a
        days-long server sees millions of request ids, and the lane map
        must not outgrow the bounded event ring it annotates.  Eviction
        is least-recently-USED (every event refreshes its lane), so the
        constantly-active scheduler lane and long-running streams keep
        their track; an evicted lane's ring events keep their tid
        number, only the pretty track name is lost.  Evictions are
        counted in the trace metadata.
    """

    def __init__(self, max_events: int = 100_000, max_lanes: int = 4096):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._tids: dict = {}  # trace id -> stable integer lane
        self._next_tid = 0  # monotonic: an evicted lane's tid never reuses
        self.max_lanes = max(int(max_lanes), 1)
        self._origin = time.monotonic()
        self._origin_unix = time.time()
        self.dropped = 0
        self.lanes_evicted = 0

    # -- producer side (scheduler / server threads) --------------------
    def _push(self, rid, ev: dict) -> None:
        """Assign the lane and append under ONE lock round-trip — this
        runs per decode token when a tracer is attached."""
        with self._lock:
            ev["tid"] = self._lane_locked(rid)
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def _us(self, t: Optional[float]) -> float:
        return ((t if t is not None else time.monotonic())
                - self._origin) * 1e6

    def event(self, rid, name: str, ts: Optional[float] = None,
              **args) -> None:
        """One instant event on ``rid``'s track (``ts`` in the
        scheduler's ``time.monotonic`` clock; default now)."""
        ev = {"name": name, "ph": "i", "s": "t", "ts": self._us(ts),
              "pid": _TRACE_PID, "cat": "fdtpu.request"}
        if args:
            ev["args"] = args
        self._push(rid, ev)

    def span(self, rid, name: str, t0: float, t1: float, **args) -> None:
        """One complete event (begin + duration) on ``rid``'s track —
        emitted retroactively from recorded monotonic timestamps."""
        ev = {"name": name, "ph": "X", "ts": self._us(t0),
              "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": _TRACE_PID, "cat": "fdtpu.request"}
        if args:
            ev["args"] = args
        self._push(rid, ev)

    def _lane_locked(self, rid) -> int:
        tid = self._tids.pop(rid, None)
        if tid is None:
            if len(self._tids) >= self.max_lanes:
                # LRU eviction: every event re-inserts its lane at the
                # end, so next(iter(...)) is the least-recently-used —
                # the hot scheduler lane and long streams never lose
                # their track to a flood of one-shot request ids
                self._tids.pop(next(iter(self._tids)))
                self.lanes_evicted += 1
            self._next_tid += 1
            tid = self._next_tid
        self._tids[rid] = tid  # (re-)insert at the recency end
        return tid

    # -- consumer side -------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self.dropped = 0
            self.lanes_evicted = 0

    def trace_events(self) -> List[dict]:
        """The trace-event list: per-request track-naming metadata
        (``thread_name`` per lane, a ``process_name`` for the group)
        followed by the ring's events."""
        with self._lock:
            events = list(self._events)
            lanes = dict(self._tids)
        meta = [{
            "name": "process_name", "ph": "M", "pid": _TRACE_PID, "tid": 0,
            "args": {"name": "fdtpu.serve requests"},
        }]
        for rid, tid in lanes.items():
            # the scheduler's own lane (decode ticks, drain marks) keeps
            # its bare name; everything else is a request track
            label = rid if rid == "scheduler" else f"request {rid}"
            meta.append({
                "name": "thread_name", "ph": "M", "pid": _TRACE_PID,
                "tid": tid, "args": {"name": label},
            })
            meta.append({
                # lanes sort by arrival, not by hash of the name
                "name": "thread_sort_index", "ph": "M", "pid": _TRACE_PID,
                "tid": tid, "args": {"sort_index": tid},
            })
        return meta + events

    def trace_document(self) -> dict:
        """The full Chrome trace JSON object (what ``GET /trace``
        serves and :meth:`export_chrome_trace` writes)."""
        return {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "origin_unix_time": self._origin_unix,
                "dropped_events": self.dropped,
                "evicted_lanes": self.lanes_evicted,
                "producer": "fluxdistributed_tpu_torch.obs.reqtrace",
            },
        }

    def export_chrome_trace(self, path: str) -> int:
        """Write the buffer as Chrome/Perfetto trace-event JSON; returns
        the number of (non-metadata) events written."""
        n = len(self)
        with open(path, "w") as f:
            json.dump(self.trace_document(), f)
        return n
