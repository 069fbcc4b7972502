"""Prefill/decode scheduler: FIFO admission, per-request stopping,
backpressure, and serving metrics.

One loop drives the engine's compiled programs:

* **decode phase** — if any slot is live, ONE fixed-shape step over all
  slots; per-slot next tokens are emitted, stop conditions checked
  (``max_new_tokens`` / EOS), and finished requests free their slot.
* **admit phase** — free slots are filled from the bounded FIFO queue.
  Admission is gated on the engine's ``can_admit`` (paged layout: the
  block pool must cover the request's worst case on top of every
  already-admitted slot's — pool exhaustion queues at the head instead
  of admitting a request that could then never run to its budget).
  Without chunked prefill an admission runs one bucketed prefill and
  splices the result into its slot; with it the admission only BEGINS
  the prefill.
* **chunk phase** — at most ``prefill_chunks_per_tick`` prefill chunks
  advance per tick, round-robin over prefilling slots.  A long prompt's
  ingestion is spread across ticks between decode steps, so it can no
  longer spike TTFT for every resident request; the first generated
  token still comes from the (final chunk's) prefill logits.

Decode-before-admit means a slot freed by an EOS in step N is re-filled
within the same ``step()`` call — continuous batching, not gang
scheduling.  Backpressure is the bounded queue: ``submit`` raises
:class:`QueueFull` (the HTTP front end maps it to 429).  ``cancel``
aborts a request (client disconnect): queued requests leave the queue
immediately, active ones are torn down — slot freed, paged blocks
returned to the pool — on the driver thread's next tick.

Thread model: ``submit``/``metrics``/``cancel`` may be called from any
thread; ``step``/``run_until_idle`` must run on ONE driver thread (the
server's engine loop, or the test body).

Port of ``fluxdistributed_tpu/serve/scheduler.py``.  Each request's
sampling key is a seeded ``torch.Generator``.  The fault-injection hook
(``faults.fire("serve.tick")``) and the HBM / run-info gauges belong to
the operability slice and are not here yet.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch

from ..obs.metrics import Registry
from ..obs.reqtrace import RequestTracer
from .engine import LMEngine

__all__ = ["Request", "Scheduler", "QueueFull", "Draining"]

# every serving series carries this prefix in Prometheus exposition;
# Scheduler.metrics() returns the same series WITHOUT it (the dict API
# predates the shared registry and its keys are stable)
METRIC_PREFIX = "fdtpu_serve_"

_ids = itertools.count()


class QueueFull(RuntimeError):
    """Admission queue at capacity — shed load (HTTP 429)."""


class Draining(RuntimeError):
    """Server is draining for shutdown — new admissions refused (HTTP
    503: unlike 429/QueueFull, retrying THIS instance is pointless;
    a load balancer should route elsewhere)."""


@dataclass
class Request:
    """One generation request riding the slot pool."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    # called from the scheduler thread per emitted token (streaming)
    on_token: Optional[Callable[["Request", int], None]] = None
    id: int = field(default_factory=lambda: next(_ids))
    # caller-supplied trace id (the HTTP layer forwards X-Request-Id
    # here); every reqtrace event for this request lands on the track
    # it names — None falls back to the scheduler id (see trace_id)
    rid: Optional[str] = None

    # scheduler-owned state
    generated: List[int] = field(default_factory=list)
    state: str = "queued"  # queued | prefilling | active | done
    cancelled: bool = False  # set by cancel(); serviced on driver thread
    slot: Optional[int] = None
    done: threading.Event = field(default_factory=threading.Event)
    submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        self._key = torch.Generator().manual_seed(self.seed)

    @property
    def trace_id(self) -> str:
        """The id request-scoped events carry end-to-end."""
        return self.rid if self.rid is not None else str(self.id)

    @property
    def tokens(self) -> List[int]:
        """Prompt + generated — the ``models.generate`` output layout."""
        return list(self.prompt) + list(self.generated)


class Scheduler:
    """``registry=None`` builds a PRIVATE :class:`~..obs.Registry` per
    scheduler — engine instances stay isolated (tests spin several per
    process); pass a shared registry (e.g. ``obs.get_registry()``) to
    co-expose serving metrics with other subsystems on one scrape."""

    def __init__(self, engine: LMEngine, max_queue: int = 64,
                 registry: Optional[Registry] = None,
                 prefill_chunks_per_tick: int = 1,
                 reqtrace: Optional[RequestTracer] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prefill_chunks_per_tick < 1:
            raise ValueError(f"prefill_chunks_per_tick must be >= 1, got "
                             f"{prefill_chunks_per_tick}")
        self.engine = engine
        self.max_queue = max_queue
        #: chunk budget per tick when the engine prefills incrementally —
        #: 1 keeps decode cadence tight (one chunk rides between steps);
        #: raise it to favor prompt ingestion over decode latency
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self._rr = -1  # round-robin cursor over prefilling slots
        #: graceful-drain latch (see :meth:`begin_drain`): True refuses
        #: NEW submissions while everything already accepted (queued or
        #: in a slot) runs to completion
        self.draining = False
        self._queue: deque[Request] = deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self.slots: List[Optional[Request]] = [None] * engine.max_slots
        #: request-scoped lifecycle tracer (obs.reqtrace), or None —
        #: events cost nothing when absent, a bounded ring when present
        self.reqtrace = reqtrace
        self.registry = registry if registry is not None else Registry()
        r, p = self.registry, METRIC_PREFIX
        c, g = r.counter, r.gauge
        self._c_submitted = c(p + "requests_submitted", "requests accepted into the queue")
        self._c_finished = c(p + "requests_finished", "requests fully generated")
        self._c_rejected = c(p + "requests_rejected", "requests shed with QueueFull (429)")
        self._c_prefill_tokens = c(p + "prefill_tokens", "real prompt tokens prefilled")
        self._c_prefill_padded = c(p + "prefill_padded_tokens", "bucket-padded tokens computed")
        self._c_prefill_sec = c(p + "prefill_sec", "seconds spent in prefill")
        self._c_decode_tokens = c(p + "decode_tokens", "live-slot tokens generated")
        self._c_decode_sec = c(p + "decode_sec", "seconds spent in decode steps")
        self._g_ttft_last = g(p + "ttft_sec_last", "most recent time-to-first-token")
        self._c_ttft_sum = c(p + "ttft_sec_sum", "sum of TTFT seconds")
        self._c_ttft_count = c(p + "ttft_count", "requests that produced a first token")
        self._h_ttft = r.histogram(
            p + "ttft_seconds", "time-to-first-token distribution")
        # the per-request latency truth the N-replica router needs and
        # aggregate counters cannot give: how long requests WAIT before
        # a slot admits them, and the inter-token (TBT) cadence once
        # they decode — both full histograms next to the TTFT one
        self._h_queue_wait = r.histogram(
            p + "queue_wait_seconds",
            "submit-to-admission wait distribution")
        self._h_tbt = r.histogram(
            p + "tbt_seconds",
            "inter-token (time-between-tokens) distribution")
        # chunked-prefill + paged-pool series (all zero / static for a
        # dense whole-prefill engine — the names are registered either
        # way so scrapes and close() are layout-independent)
        self._c_prefill_chunks = c(
            p + "prefill_chunks", "prefill chunks executed")
        self._g_chunks_last = g(
            p + "prefill_chunks_last_tick",
            "prefill chunks run in the most recent tick")
        self._c_cancelled = c(
            p + "requests_cancelled",
            "requests aborted (client disconnect / cancel)")
        self._c_prefix_hits = c(
            p + "prefix_cache_hits", "prefix-cache block hits")
        self._c_prefix_misses = c(
            p + "prefix_cache_misses", "prefix-cache block misses")
        self._c_prefix_evictions = c(
            p + "prefix_cache_evictions",
            "prefix-cached blocks evicted under pool pressure")
        # point-in-time values render at scrape time (zero hot-path cost);
        # the compile gauges make the engine's ONE-decode-compile
        # invariant a LIVE metric, not just an offline test assertion
        g(p + "queue_depth", "requests waiting for a slot").set_function(
            lambda: self.queue_depth)
        g(p + "active_slots", "slots generating right now").set_function(
            lambda: self.active_slots)
        g(p + "max_slots", "slot-pool capacity").set_function(
            lambda: self.engine.max_slots)
        g(p + "prefill_tokens_per_sec", "prefill throughput").set_function(
            lambda: self._rate(self._c_prefill_tokens, self._c_prefill_sec))
        g(p + "decode_tokens_per_sec", "decode throughput").set_function(
            lambda: self._rate(self._c_decode_tokens, self._c_decode_sec))
        g(p + "ttft_sec_avg", "mean time-to-first-token").set_function(
            lambda: self._rate(self._c_ttft_sum, self._c_ttft_count))
        for key in ("decode_compiles", "prefill_compiles", "insert_compiles"):
            g(p + key, "compiled-program count (steady state: decode "
                       "stays at 1)").set_function(
                lambda key=key: self.engine.compile_stats()[key])
        # block-pool occupancy (paged layout; reads 0 on dense engines):
        # free + cached is what admission reservations can draw on
        for key, txt in (
            ("kv_blocks_total", "KV block pool size per layer"),
            ("kv_blocks_free", "KV blocks on the free list"),
            ("kv_blocks_active", "KV blocks referenced by live slots"),
            ("kv_blocks_cached", "prefix-cached KV blocks (reclaimable)"),
        ):
            g(p + key, txt).set_function(
                lambda key=key: float(self._pool_stat(key)))
        # latency percentile rollups, computed AT SCRAPE TIME from the
        # histograms via the shared bucket_percentile helper (NaN while
        # empty — absence-of-data must not read as zero latency)
        for hist, stem in ((self._h_queue_wait, "queue_wait_sec"),
                           (self._h_tbt, "tbt_sec"),
                           (self._h_ttft, "ttft_hist_sec")):
            for q in (50, 95):
                g(p + f"{stem}_p{q}",
                  f"p{q} of {hist.name} (bucket-estimated)").set_function(
                    lambda hist=hist, q=q: hist.percentile(q))
        # KV-cache HBM truth next to the block-pool gauges: reserved =
        # what the cache tensors occupy, live = the fraction backing
        # live tokens (dense: equal; paged: the gap IS the layout win)
        self._kv_bytes_at = 0.0
        self._kv_bytes_memo: dict = {}
        for key, txt in (
            ("kv_cache_reserved_bytes",
             "HBM bytes the KV cache tensors occupy"),
            ("kv_cache_live_bytes",
             "KV cache bytes backing LIVE tokens"),
        ):
            g(p + key, txt).set_function(
                lambda key=key: float(self._kv_bytes(key)))
        self._callback_gauges = [
            p + k for k in (
                "queue_depth", "active_slots", "max_slots",
                "prefill_tokens_per_sec", "decode_tokens_per_sec",
                "ttft_sec_avg", "decode_compiles", "prefill_compiles",
                "insert_compiles", "kv_blocks_total", "kv_blocks_free",
                "kv_blocks_active", "kv_blocks_cached",
                "kv_cache_reserved_bytes", "kv_cache_live_bytes",
                "queue_wait_sec_p50", "queue_wait_sec_p95",
                "tbt_sec_p50", "tbt_sec_p95",
                "ttft_hist_sec_p50", "ttft_hist_sec_p95",
            )
        ]

    def _pool_stat(self, key: str) -> float:
        ps = getattr(self.engine, "pool_stats", None)
        return (ps() if callable(ps) else {}).get(key, 0)

    def _kv_bytes(self, key: str) -> float:
        # one kv_cache_bytes() tree walk serves BOTH gauges of a scrape
        # (each /metrics render reads reserved then live back-to-back)
        kb = getattr(self.engine, "kv_cache_bytes", None)
        if not callable(kb):
            return 0.0
        now = time.monotonic()
        if now - self._kv_bytes_at > 0.1:
            self._kv_bytes_memo = kb()
            self._kv_bytes_at = now
        return float(self._kv_bytes_memo.get(
            "reserved" if key.endswith("reserved_bytes") else "live", 0))

    def _sync_prefix_counters(self) -> None:
        """Fold the engine's cumulative prefix-cache tallies into the
        registry counters (delta-sync keeps Prometheus counter
        semantics — a shared registry's totals stay monotone across
        scheduler restarts)."""
        ps = getattr(self.engine, "pool_stats", None)
        if not callable(ps):
            return
        s = ps()
        for ctr, key in ((self._c_prefix_hits, "prefix_cache_hits"),
                         (self._c_prefix_misses, "prefix_cache_misses"),
                         (self._c_prefix_evictions,
                          "prefix_cache_evictions")):
            d = s.get(key, 0) - ctr.value()
            if d > 0:
                ctr.inc(d)

    @staticmethod
    def _rate(num, den) -> float:
        d = den.value()
        return num.value() / d if d else 0.0

    def close(self) -> None:
        """Detach this scheduler's scrape-time callbacks from the
        registry.  Irrelevant for the default PRIVATE registry (it dies
        with the scheduler), but with a shared registry the callback
        closures would otherwise pin the retired engine — and its slot
        KV cache — forever, and keep scraping its stale stats.  Plain
        counters stay registered deliberately: process-cumulative
        totals are correct Prometheus semantics across restarts (a
        successor scheduler's get-or-create continues them)."""
        for name in self._callback_gauges:
            self.registry.unregister(name)

    # ---- producer side (any thread) ---------------------------------------

    def begin_drain(self) -> None:
        """Stop admissions for graceful shutdown.  Requests already
        accepted (queued or decoding) run to completion — bounding that
        is the caller's job (:meth:`LMServer.drain`'s timeout)."""
        if self.reqtrace is not None:
            self.reqtrace.event("scheduler", "drain_begin",
                                active=self.active_slots,
                                queued=self.queue_depth)
        # under the lock: submit() checks the latch inside its locked
        # region, so the store must be ordered against in-flight
        # admissions.  The gauge/tracer calls stay OUTSIDE — they take
        # the registry lock, and nesting it under the scheduler lock
        # would create a lock-order edge FDT302 exists to forbid.
        with self._lock:
            self.draining = True
        self.registry.gauge(
            "fdtpu_serve_draining",
            "1 while the scheduler refuses new admissions for shutdown",
        ).set(1)
        self._work.set()

    def submit(self, req: Request) -> Request:
        """Validate + enqueue; raises ``ValueError`` (bad shape),
        :class:`QueueFull` (backpressure) or :class:`Draining`
        (shutting down)."""
        self.engine.validate_request(len(req.prompt), req.max_new_tokens)
        with self._lock:
            if self.draining:
                self._c_rejected.inc()
                raise Draining(
                    "server is draining for shutdown; route elsewhere")
            if len(self._queue) >= self.max_queue:
                self._c_rejected.inc()
                raise QueueFull(
                    f"admission queue full ({self.max_queue} waiting)")
            req.state = "queued"
            req.submitted_at = time.monotonic()
            self._queue.append(req)
            self._c_submitted.inc()
            depth = len(self._queue)
        if self.reqtrace is not None:
            self.reqtrace.event(req.trace_id, "enqueue",
                                ts=req.submitted_at,
                                prompt_tokens=len(req.prompt),
                                max_new_tokens=req.max_new_tokens,
                                queue_depth=depth)
        self._work.set()
        return req

    def wait_for_work(self, timeout: float = 0.05) -> None:
        """Block the driver thread until a submit arrives (or timeout)."""
        self._work.wait(timeout)
        self._work.clear()

    def cancel(self, req: Request) -> bool:
        """Abort a request (client disconnect).  A queued request leaves
        the queue immediately (returns True); a prefilling/active one is
        flagged and torn down — slot freed, paged KV blocks back to the
        pool — at the start of the driver thread's next tick (returns
        False; ``req.done`` is set once the teardown ran)."""
        with self._lock:
            if req.state == "queued":
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass  # raced with admission; fall through to the flag
                else:
                    req.state = "done"
                    req.finished_at = time.monotonic()
                    self._c_cancelled.inc()
                    if self.reqtrace is not None:
                        # a queued cancel must close its track too — an
                        # enqueue with no terminal event reads as a
                        # lost request in the timeline
                        self.reqtrace.event(req.trace_id, "cancel",
                                            ts=req.finished_at,
                                            generated=0)
                    req.done.set()
                    return True
            if req.state == "done":
                return True
            req.cancelled = True
        self._work.set()
        return False

    def _service_cancels(self) -> None:
        """Driver-thread half of :meth:`cancel`: free the slot and the
        engine-side resources of every flagged request."""
        for s, r in enumerate(self.slots):
            if r is not None and r.cancelled:
                self.slots[s] = None
                self.engine.reset_slot(s)
                r.slot = None
                r.state = "done"
                r.finished_at = time.monotonic()
                self._c_cancelled.inc()
                if self.reqtrace is not None:
                    self.reqtrace.event(r.trace_id, "cancel",
                                        ts=r.finished_at,
                                        generated=len(r.generated))
                r.done.set()

    def _admitted(self, req: Request) -> None:
        """Admission bookkeeping shared by both prefill paths: stamp
        the admission, observe the queue wait, close the request's
        queue_wait span."""
        now = time.monotonic()
        req.admitted_at = now
        if req.submitted_at is not None:
            self._h_queue_wait.observe(now - req.submitted_at)
            if self.reqtrace is not None:
                self.reqtrace.span(req.trace_id, "queue_wait",
                                   req.submitted_at, now)

    # ---- driver side (one thread) -----------------------------------------

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def idle(self) -> bool:
        return self.active_slots == 0 and self.queue_depth == 0

    def step(self) -> int:
        """One scheduler tick: tear down cancelled requests, decode live
        slots, admit from the queue into whatever is free (including
        slots freed THIS tick), then advance at most
        ``prefill_chunks_per_tick`` prefill chunks (chunked engines).
        Returns the number of tokens emitted."""
        emitted = 0
        self._service_cancels()
        live = [s for s, r in enumerate(self.slots)
                if r is not None and r.state == "active"]
        if live:
            t0 = time.monotonic()
            nxt = self.engine.step_decode()
            t1 = time.monotonic()
            self._c_decode_sec.inc(t1 - t0)
            self._c_decode_tokens.inc(len(live))
            if self.reqtrace is not None:
                # the engine-program dispatch on its own scheduler lane:
                # request tracks show WHOSE token, this shows the tick
                self.reqtrace.span("scheduler", "decode_step", t0, t1,
                                   live=len(live))
            for s in live:
                self._emit(self.slots[s], int(nxt[s]))
                emitted += 1
        # admit into free slots (possibly just freed by EOS above).
        # Admission is FIFO: when the HEAD cannot be admitted (paged
        # block-pool reservation would overcommit), it WAITS — no
        # head-of-line skipping, so a big request cannot be starved by
        # a stream of small ones.
        incremental = bool(getattr(self.engine, "prefill_incremental",
                                   False))
        can_admit = getattr(self.engine, "can_admit", None)
        while True:
            try:
                free = self.slots.index(None)
            except ValueError:
                break
            with self._lock:
                if not self._queue:
                    break
                req = self._queue[0]
                if (can_admit is not None
                        and not can_admit(req.prompt, req.max_new_tokens)):
                    break
                self._queue.popleft()
            self._admitted(req)
            if incremental:
                # the request id rides INTO the engine on the prefill
                # state, so engine-side chunk advances stay attributable
                req._pf = self.engine.prefill_begin(
                    free, req.prompt, req.temperature, req._key,
                    max_new_tokens=req.max_new_tokens,
                    rid=req.trace_id)
                req.state = "prefilling"
                req.slot = free
                self.slots[free] = req
                continue
            t0 = time.monotonic()
            first, bucket = self.engine.prefill(
                free, req.prompt, req.temperature, req._key)
            t1 = time.monotonic()
            self._c_prefill_sec.inc(t1 - t0)
            self._c_prefill_tokens.inc(len(req.prompt))
            self._c_prefill_padded.inc(bucket)
            if self.reqtrace is not None:
                self.reqtrace.span(req.trace_id, "prefill", t0, t1,
                                   tokens=len(req.prompt), padded=bucket)
            req.state = "active"
            req.slot = free
            self.slots[free] = req
            self._emit(req, first)
            emitted += 1
        # chunk phase: round-robin the budget over prefilling slots so a
        # long prompt shares the tick with everyone else's chunks
        chunks_run = 0
        if incremental:
            for _ in range(self.prefill_chunks_per_tick):
                pf = [s for s, r in enumerate(self.slots)
                      if r is not None and r.state == "prefilling"]
                if not pf:
                    break
                s = next((x for x in pf if x > self._rr), pf[0])
                self._rr = s
                req = self.slots[s]
                t0 = time.monotonic()
                first, nreal, npad = self.engine.prefill_step(req._pf)
                t1 = time.monotonic()
                self._c_prefill_sec.inc(t1 - t0)
                self._c_prefill_tokens.inc(nreal)
                self._c_prefill_padded.inc(npad)
                self._c_prefill_chunks.inc()
                if self.reqtrace is not None:
                    self.reqtrace.span(
                        req.trace_id, "prefill_chunk", t0, t1,
                        pos=getattr(req._pf, "pos", None),
                        tokens=nreal, padded=npad)
                chunks_run += 1
                if first is not None:
                    req.state = "active"
                    self._emit(req, first)
                    emitted += 1
            self._g_chunks_last.set(chunks_run)
        self._sync_prefix_counters()
        return emitted

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    def generate_all(self, requests: Sequence[Request]) -> List[List[int]]:
        """Convenience (tests/bench): submit everything, drain, return
        each request's prompt+generated token list."""
        for r in requests:
            self.submit(r)
        self.run_until_idle()
        return [r.tokens for r in requests]

    # ---- internals --------------------------------------------------------

    def _emit(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        req.generated.append(tok)
        if req.first_token_at is None:
            req.first_token_at = now
            if req.submitted_at is not None:
                ttft = now - req.submitted_at
                self._g_ttft_last.set(ttft)
                self._c_ttft_sum.inc(ttft)
                self._c_ttft_count.inc()
                self._h_ttft.observe(ttft)
            if self.reqtrace is not None:
                self.reqtrace.event(req.trace_id, "first_token", ts=now)
        else:
            if req.last_token_at is not None:
                self._h_tbt.observe(now - req.last_token_at)
            if self.reqtrace is not None:
                # decode ticks on the request's own track — bounded by
                # the ring, only recorded while a tracer is attached
                self.reqtrace.event(req.trace_id, "token", ts=now,
                                    n=len(req.generated))
        req.last_token_at = now
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:  # noqa: BLE001
                # a streaming callback must not be able to kill the
                # whole serving loop (or skip this request's stop check)
                print(f"serve: on_token callback failed for request "
                      f"{req.id}: {type(e).__name__}: {e}", file=sys.stderr)
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.state = "done"
        req.finished_at = time.monotonic()
        if req.slot is not None:
            self.slots[req.slot] = None
            self.engine.reset_slot(req.slot)
            req.slot = None
        self._c_finished.inc()
        if self.reqtrace is not None:
            if req.first_token_at is not None:
                self.reqtrace.span(req.trace_id, "decode",
                                   req.first_token_at, req.finished_at,
                                   tokens=len(req.generated))
            self.reqtrace.event(req.trace_id, "finish",
                                ts=req.finished_at,
                                generated=len(req.generated))
        req.done.set()

    def metrics(self) -> dict:
        """Serving counters + derived rates + engine compile stats —
        the pre-registry dict API, now a READ of the registry (same
        keys as ever, sans the ``fdtpu_serve_`` exposition prefix)."""
        m = {
            "requests_submitted": self._c_submitted.value(),
            "requests_finished": self._c_finished.value(),
            "requests_rejected": self._c_rejected.value(),
            "prefill_tokens": self._c_prefill_tokens.value(),
            "prefill_padded_tokens": self._c_prefill_padded.value(),
            "prefill_sec": self._c_prefill_sec.value(),
            "decode_tokens": self._c_decode_tokens.value(),
            "decode_sec": self._c_decode_sec.value(),
            "ttft_sec_last": self._g_ttft_last.value(),
            "ttft_sec_sum": self._c_ttft_sum.value(),
            "ttft_count": self._c_ttft_count.value(),
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "max_slots": self.engine.max_slots,
            "prefill_tokens_per_sec": self._rate(
                self._c_prefill_tokens, self._c_prefill_sec),
            "decode_tokens_per_sec": self._rate(
                self._c_decode_tokens, self._c_decode_sec),
            # averaged over requests that GOT a first token — dividing
            # by requests_finished would overstate the average whenever
            # active requests have already produced TTFT samples
            "ttft_sec_avg": self._rate(self._c_ttft_sum, self._c_ttft_count),
        }
        self._sync_prefix_counters()
        m["prefill_chunks"] = self._c_prefill_chunks.value()
        m["requests_cancelled"] = self._c_cancelled.value()
        # per-request latency rollups (NaN while no sample exists):
        # bucket-estimated percentiles through the SHARED helper
        m["queue_wait_count"] = self._h_queue_wait.cell_count()
        m["queue_wait_sec_p50"] = self._h_queue_wait.percentile(50)
        m["queue_wait_sec_p95"] = self._h_queue_wait.percentile(95)
        m["tbt_count"] = self._h_tbt.cell_count()
        m["tbt_sec_p50"] = self._h_tbt.percentile(50)
        m["tbt_sec_p95"] = self._h_tbt.percentile(95)
        ps = getattr(self.engine, "pool_stats", None)
        if callable(ps):
            m.update(ps())
        m.update(self.engine.compile_stats())
        return m
