"""Black-box flight recorder: the last N steps survive a SIGKILL.

(A copy of the JAX package's stdlib-only ``obs/flight.py``; the
topology fingerprint is the port's, :func:`.runs.topology_fingerprint`.)

Every observability layer before this one is *within-run*: metrics are
scraped while the process lives, spans and profiles export in a
``finally`` block — and a SIGKILL (preemption, OOM-killer, a wedged
collective the supervisor shoots) runs no ``finally``.  All five
hardware bench rounds died exactly like that, and the evidence was
whatever stamps made it into one error JSON.  This module is the
aircraft recorder for that case: a bounded ring of per-step structured
records, flushed APPEND-ONLY to disk every ``flush_every`` records with
an atomically-replaced sidecar checkpoint, so a hard kill at any
instant loses at most one flush interval of history and can never tear
the already-flushed prefix.

Write path (crash-ordered by construction):

* :meth:`FlightRecorder.record` — O(1): append to the in-memory ring
  and a pending buffer; every ``flush_every`` records the buffer is
  appended to ``<path>`` (one JSON object per line) and fsync'd, then
  the tiny ``<path>.ckpt`` sidecar is atomically replaced (write tmp +
  ``os.replace``) with the flush summary.  A SIGKILL mid-append can
  tear only the final line — the reader tolerates that — and the
  sidecar is either the previous complete summary or the new one,
  never a hybrid.
* :meth:`FlightRecorder.dump` — the soft-exit path (done / guard halt /
  crash-with-traceback / preemption): flush the remainder and append a
  terminal ``end`` line carrying the exit status and the topology
  fingerprint.  A dump-less file IS the hard-death signature the
  postmortem keys on.

Read path: :func:`read_flight` parses a dump tolerantly (torn tail
line skipped, missing footer reported as ``end=None``) so forensics
works on exactly the files crashes leave behind.

The recorder is deliberately device-free on the hot path: the topology
fingerprint is resolved lazily (best-effort) at header time, and every
I/O error is swallowed after one stderr warning — a black box that can
crash the plane is worse than no black box.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FLIGHT_SCHEMA", "FlightRecorder", "read_flight"]

#: on-disk schema tag (header + every sidecar checkpoint carry it)
FLIGHT_SCHEMA = "fdtpu-flight/v1"


def _lazy_fingerprint() -> Optional[str]:
    """Topology fingerprint, best-effort: it asks the CUDA runtime for
    the card, so this only runs where the run already uses it
    (header/footer of an in-flight run) and any failure reads as
    ``None``, never a crash."""
    try:
        from .runs import topology_fingerprint

        return topology_fingerprint()
    except Exception:  # noqa: BLE001 — forensics must never raise
        return None


class FlightRecorder:
    """Bounded per-step black box with crash-durable flushes.

    Parameters
    ----------
    path: the append-only JSONL dump (``<path>.ckpt`` rides alongside)
    ring: in-memory record bound (the dump file is bounded by the run,
        not the ring — the ring exists so ``records()`` and the final
        checkpoint stay O(ring) however long the run)
    flush_every: records per durable flush — the maximum history a
        SIGKILL can lose
    fingerprint: topology fingerprint for the header/footer; ``None``
        resolves lazily (best-effort) at first flush
    meta: free-form run metadata for the header (component, argv, ...)
    """

    def __init__(
        self,
        path: str,
        *,
        ring: int = 512,
        flush_every: int = 8,
        fingerprint: Optional[str] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.path = path
        self.flush_every = flush_every
        self._ring: deque = deque(maxlen=ring)
        self._pending: List[dict] = []
        self._lock = threading.Lock()
        self._fh = None
        self._fingerprint = fingerprint
        self._meta = dict(meta or {})
        self._recorded = 0
        self._flushed = 0
        self._flushes = 0
        self._ended = False
        self._warned = False

    # -- producer side -------------------------------------------------
    def record(self, **fields) -> None:
        """Append one structured record (a step, a serve tick, ...).
        O(1) between flushes; never raises — a black box that can kill
        the loop it watches is a liability, not an instrument."""
        rec = {"kind": "record", "t": round(time.time(), 3), **fields}
        with self._lock:
            if self._ended:
                return
            self._ring.append(rec)
            self._pending.append(rec)
            self._recorded += 1
            if len(self._pending) >= self.flush_every:
                self._flush_locked()

    def flush(self) -> None:
        """Force-flush pending records (the cadence flush is automatic;
        this is for callers bracketing known-risky work)."""
        with self._lock:
            self._flush_locked()

    def dump(self, status: str, error: Optional[str] = None,
             **extra) -> Optional[str]:
        """The soft-exit dump: flush everything and append a terminal
        ``end`` line with ``status`` (done/halt/crash/preempted/stall/
        closed), the error text and the topology fingerprint.  Returns
        the dump path (None when writing failed).  Idempotent — only
        the first call writes the footer; a SIGKILL simply never calls
        it, which is itself the signal :func:`read_flight` reports."""
        with self._lock:
            if self._ended:
                return self.path
            self._ended = True
            foot = {
                "kind": "end",
                "t": round(time.time(), 3),
                "status": str(status),
                "records": self._recorded,
                "fingerprint": self._resolved_fingerprint(),
            }
            if error:
                foot["error"] = str(error)[:500]
            if extra:
                foot.update(extra)
            self._pending.append(foot)
            self._flush_locked(final=True)
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
        return self.path

    def close(self) -> None:
        """Flush-and-close without a status verdict (serve schedulers
        being retired mid-process)."""
        self.dump("closed")

    # -- introspection (tests / postmortem in-process) -----------------
    def records(self) -> List[dict]:
        """Snapshot of the in-memory ring (newest last)."""
        with self._lock:
            return list(self._ring)

    @property
    def recorded(self) -> int:
        return self._recorded

    @property
    def flushed(self) -> int:
        return self._flushed

    # -- internals -----------------------------------------------------
    def _resolved_fingerprint(self) -> Optional[str]:
        if self._fingerprint is None:
            self._fingerprint = _lazy_fingerprint()
        return self._fingerprint

    def _flush_locked(self, final: bool = False) -> None:
        if not self._pending and not final:
            return
        try:
            if self._fh is None:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                fresh = (not os.path.exists(self.path)
                         or os.path.getsize(self.path) == 0)
                self._fh = open(self.path, "a")
                if fresh:
                    header = {
                        "kind": "header",
                        "schema": FLIGHT_SCHEMA,
                        "t": round(time.time(), 3),
                        "flush_every": self.flush_every,
                        "fingerprint": self._resolved_fingerprint(),
                        "meta": self._meta,
                    }
                    self._fh.write(json.dumps(header) + "\n")
            for rec in self._pending:
                self._fh.write(json.dumps(rec) + "\n")
            self._flushed += len(
                [r for r in self._pending if r["kind"] == "record"])
            self._pending.clear()
            self._flushes += 1
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._checkpoint()
        except Exception as e:  # noqa: BLE001 — never kill the run
            self._pending.clear()
            if not self._warned:
                self._warned = True
                print(f"obs.flight: flush to {self.path} failed "
                      f"({type(e).__name__}: {e}) — recording continues "
                      "in memory only", file=sys.stderr)

    def _checkpoint(self) -> None:
        """Atomically replace the sidecar summary: a reader that finds
        a torn dump tail still gets a consistent (previous-or-current,
        never hybrid) snapshot of how far the recorder provably got."""
        ck = {
            "schema": FLIGHT_SCHEMA,
            "t": round(time.time(), 3),
            "fingerprint": self._fingerprint,
            "recorded": self._recorded,
            "flushed": self._flushed,
            "flushes": self._flushes,
            "last": self._ring[-1] if self._ring else None,
        }
        path = self.path + ".ckpt"
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(ck, f)
        os.replace(tmp, path)


def read_flight(path: str) -> dict:
    """Tolerant dump reader for exactly the files crashes leave behind.

    Returns ``{"header", "records", "end", "torn", "checkpoint"}``:
    ``header``/``end`` are the framing lines (either may be ``None`` —
    a missing ``end`` is the hard-death signature), ``records`` the
    per-step lines in order, ``torn`` counts unparseable lines (a
    SIGKILL mid-append tears at most the final one), ``checkpoint`` the
    sidecar summary when present."""
    out: dict = {"header": None, "records": [], "end": None, "torn": 0,
                 "checkpoint": None}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                out["torn"] += 1
                continue
            kind = obj.get("kind")
            if kind == "header" and out["header"] is None:
                out["header"] = obj
            elif kind == "end":
                out["end"] = obj
            elif kind == "record":
                out["records"].append(obj)
    try:
        with open(path + ".ckpt") as f:
            out["checkpoint"] = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        pass
    return out
