"""Stall watchdog: warn when the step cadence breaks.

(A copy of the JAX package's stdlib-only ``obs/watchdog.py``.)

MPMD-style distributed training lives or dies on straggler visibility
(arXiv:2412.14374): a hung collective, a wedged data loader or a
preempted host shows up as... nothing — the loop simply stops printing.
This watchdog turns "nothing" into a signal: the trainer calls
:meth:`StepWatchdog.beat` once per step, a daemon thread compares the
time since the last beat against ``factor ×`` the **rolling median**
step time (median, not mean: one slow checkpoint step must not inflate
the baseline), and a breach fires ``on_stall`` — by default a warning
plus ``fdtpu_watchdog_stalls_total`` in the registry, so a scraper can
alert on it remotely.  The warning names the innermost ACTIVE
span/phase at stall time (:func:`..obs.spans.innermost_active` — the
trainer's phase brackets register there even without a tracer), so an
episode says "stalled in 'dispatch'" instead of just "stalled";
:attr:`last_where` keeps it readable for ``on_stall`` callbacks.

A stall that persists ``escalate_after`` further threshold windows
fires ONE **escalation** (``fdtpu_watchdog_escalations_total`` + the
``on_escalate`` abort callback): the warn says "slow", the escalation
says "wedged for good" — the signal ``bin/supervise.py`` SIGKILLs and
elastically resumes on.

The existing OOM-skip counter folds in through :meth:`note_skip`: a
skipped batch both keeps the heartbeat alive (the loop IS making
progress) and increments ``fdtpu_train_oom_skipped_total`` — one place
to watch for "training is quietly throwing work away".  Its PROACTIVE
sibling is :meth:`note_headroom`: the loop reports the minimum HBM
headroom ratio (``obs.memstats.min_headroom_ratio``) and the watchdog
keeps the ``fdtpu_hbm_headroom_ratio`` gauge current and fires ONE
low-headroom warning per episode when it drops under ``headroom_warn``
— the OOM-margin alarm that rings BEFORE the allocator loses, next to
the counter that tallies the batches lost after.

The check logic lives in :meth:`poll` so tests drive it synchronously;
the thread is just ``poll`` on a timer.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

from .metrics import Registry, get_registry

__all__ = ["StepWatchdog"]


class StepWatchdog:
    """Heartbeat monitor for a stepping loop.

    Parameters
    ----------
    factor: stall threshold as a multiple of the rolling-median step
        time (default 5× — cadence jitter from eval/checkpoint cycles
        stays under it, a wedged collective does not)
    min_interval: floor on the threshold in seconds (median decode steps
        can be sub-millisecond; waking ops for a 5 ms "stall" is noise)
    window: number of recent step intervals in the rolling median
    check_every: watchdog thread poll period in seconds
    warmup: beats to observe before arming (the first steps include
        compiles and are not cadence)
    on_stall: ``fn(elapsed_sec, threshold_sec)`` — defaults to a stderr
        warning; fired ONCE per stall episode (a beat re-arms it)
    escalate_after: a stall that persists this many FURTHER threshold
        windows (i.e. ``elapsed > (1 + escalate_after) × threshold``)
        counts an ESCALATION — ``fdtpu_watchdog_escalations_total``
        increments and ``on_escalate`` fires, once per stall (a beat
        re-arms).  This is the wedged-collective signal: a one-off warn
        says "slow", the escalation says "this loop is never coming
        back" — the counter a supervisor (``bin/supervise.py``)
        SIGKILLs on.  0 (default) preserves the warn-once behavior.
    on_escalate: ``fn(elapsed_sec, threshold_sec)`` abort callback run
        at escalation — e.g. dump state and ``os._exit``; default is a
        stderr warning (the counter alone is the remote signal)
    headroom_warn: minimum HBM headroom ratio below which
        :meth:`note_headroom` fires its once-per-episode warning (an
        episode ends when headroom recovers above the threshold);
        0 disables the alert while the gauge stays live
    registry: metrics registry (default: the process registry)
    """

    def __init__(
        self,
        factor: float = 5.0,
        min_interval: float = 1.0,
        window: int = 64,
        check_every: float = 0.5,
        warmup: int = 3,
        on_stall: Optional[Callable[[float, float], None]] = None,
        escalate_after: int = 0,
        on_escalate: Optional[Callable[[float, float], None]] = None,
        headroom_warn: float = 0.05,
        registry: Optional[Registry] = None,
        name_prefix: str = "fdtpu",
    ):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        if escalate_after < 0:
            raise ValueError(
                f"escalate_after must be >= 0, got {escalate_after}")
        if not 0.0 <= headroom_warn < 1.0:
            raise ValueError(
                f"headroom_warn must be in [0, 1), got {headroom_warn}")
        self.factor = factor
        self.min_interval = min_interval
        self.check_every = check_every
        self.warmup = warmup
        self.on_stall = on_stall
        self.escalate_after = escalate_after
        self.on_escalate = on_escalate
        self.registry = registry or get_registry()
        self._intervals: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self._beats = 0
        self._fired = False  # one warning per stall episode
        self._escalated = False  # one escalation per stall episode
        self._paused = 0  # pause() nesting depth
        # the beat ending a pause-containing iteration measures only the
        # post-pause remainder — a bogus near-zero interval that would
        # collapse the median; skip recording it (once)
        self._skip_interval = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalls = self.registry.counter(
            f"{name_prefix}_watchdog_stalls_total",
            "stall episodes (no step within factor x rolling-median step time)",
        )
        self._stalled = self.registry.gauge(
            f"{name_prefix}_watchdog_stalled",
            "1 while the loop is currently stalled, 0 otherwise",
        )
        self._skips = self.registry.counter(
            f"{name_prefix}_train_oom_skipped_total",
            "batches skipped by OOM fault tolerance",
        )
        self._escalations = self.registry.counter(
            f"{name_prefix}_watchdog_escalations_total",
            "stalls that persisted past escalate_after further threshold "
            "windows (the wedged-collective signal supervisors kill on)",
        )
        # the OOM-margin pair: the gauge is the live margin, the
        # counter tallies low-headroom EPISODES (warn-once semantics,
        # mirroring the stall counter)
        self.headroom_warn = headroom_warn
        self._headroom_low = False
        self._headroom = self.registry.gauge(
            f"{name_prefix}_hbm_headroom_ratio",
            "min over devices of (bytes_limit - bytes_in_use) / "
            "bytes_limit — the OOM margin; NaN when unavailable",
        )
        self._low_headroom_total = self.registry.counter(
            f"{name_prefix}_watchdog_low_headroom_total",
            "episodes where HBM headroom dropped below headroom_warn "
            "(the proactive sibling of the OOM-skip counter)",
        )
        self._stalled.set(0)
        # NaN until the loop reports a real margin: 0.0 would read as
        # "about to OOM" on backends that simply have no memory stats
        self._headroom.set(float("nan"))
        #: innermost active span/phase at the most recent stall fire
        #: (None when nothing was bracketed) — set BEFORE on_stall runs
        self.last_where: Optional[str] = None

    # -- loop side -----------------------------------------------------
    def beat(self) -> None:
        """One step completed (call from the training/serving loop)."""
        now = time.monotonic()
        with self._lock:
            if self._last_beat is not None and not self._skip_interval:
                self._intervals.append(now - self._last_beat)
            self._skip_interval = False
            self._last_beat = now
            self._beats += 1
            if self._fired:
                self._fired = False
                self._escalated = False
                self._stalled.set(0)

    def note_skip(self, n: int = 1) -> None:
        """An OOM-skipped batch: progress (heartbeat) + a counted loss
        of work (the reference's dead ``num_missed``, now scrapeable)."""
        self._skips.inc(n)
        self.beat()

    def note_headroom(self, ratio: Optional[float]) -> bool:
        """Report the current minimum HBM headroom ratio (the trainer
        samples ``obs.memstats.min_headroom_ratio()`` per step).  Keeps
        the ``fdtpu_hbm_headroom_ratio`` gauge current and fires ONE
        warning + counter tick per low-headroom EPISODE — an episode
        opens when the ratio drops under ``headroom_warn`` and closes
        when it recovers, so a run hovering at 3% margin pages once,
        not once per step.  ``None`` (no memory stats on this backend)
        is a no-op: the gauge stays NaN, never a fake alarm.  Returns
        True iff a new episode fired."""
        if ratio is None:
            return False
        ratio = float(ratio)
        self._headroom.set(ratio)
        if not self.headroom_warn:
            return False
        if ratio >= self.headroom_warn:
            self._headroom_low = False
            return False
        if self._headroom_low:
            return False
        self._headroom_low = True
        self._low_headroom_total.inc()
        print(
            f"obs.watchdog: LOW HBM HEADROOM — min device margin "
            f"{ratio:.1%} (< {self.headroom_warn:.1%}); the next "
            "allocation spike (longer batch, eval, checkpoint "
            "snapshot) may OOM — shrink the batch or re-plan the "
            "layout (bin/fit.py)",
            file=sys.stderr,
        )
        return True

    @contextlib.contextmanager
    def pause(self):
        """Suspend stall detection around KNOWN-long legitimate work
        (a checkpoint's synchronous device→host snapshot, a full eval
        pass).  Without this, any in-loop phase longer than the
        threshold reads as a stall and flips /healthz to 503 — paging
        an operator about a checkpoint is how watchdogs get disabled.
        The interval restarts on exit so the paused phase neither fires
        nor pollutes the rolling median.  Nests."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            now = time.monotonic()
            with self._lock:
                self._paused -= 1
                # restart the measurement window; NEITHER the paused
                # phase's duration NOR the post-pause remainder of this
                # iteration may enter the cadence intervals (the first
                # would inflate the median, the second collapse it)
                self._last_beat = now
                self._skip_interval = True

    # -- watchdog side -------------------------------------------------
    def threshold(self) -> Optional[float]:
        """Current stall threshold in seconds (None while unarmed)."""
        with self._lock:
            if self._beats <= self.warmup or len(self._intervals) < 2:
                return None
            med = statistics.median(self._intervals)
        return max(self.factor * med, self.min_interval)

    def poll(self, now: Optional[float] = None) -> bool:
        """One check; returns True iff a NEW stall episode fired.
        (Public so tests — or a caller without threads — drive it
        synchronously.)  A stall that persists ``escalate_after``
        further threshold windows additionally fires ONE escalation —
        without it a permanent stall would warn once and then sit
        silent forever, indistinguishable from a slow phase."""
        thr = self.threshold()
        with self._lock:
            last = self._last_beat
            already = self._fired
            paused = self._paused > 0
        if thr is None or last is None or paused:
            return False
        elapsed = (now if now is not None else time.monotonic()) - last
        if already:
            self._maybe_escalate(elapsed, thr)
            return False
        if elapsed <= thr:
            return False
        with self._lock:
            if self._fired:  # lost the race with another poll
                return False
            self._fired = True
        from .spans import innermost_active

        self.last_where = innermost_active()
        where = (f" — stalled inside span/phase {self.last_where!r}"
                 if self.last_where else "")
        self._stalls.inc()
        self._stalled.set(1)
        if self.on_stall is not None:
            self.on_stall(elapsed, thr)
        else:
            print(
                f"obs.watchdog: STALL — no step for {elapsed:.1f}s "
                f"(threshold {thr:.1f}s = {self.factor} x median step); "
                "a collective, the data loader, or a checkpoint write "
                f"may be wedged{where}",
                file=sys.stderr,
            )
        return True

    def _maybe_escalate(self, elapsed: float, thr: float) -> None:
        if not self.escalate_after or elapsed <= thr * (
                1 + self.escalate_after):
            return
        with self._lock:
            if self._escalated or not self._fired:
                return
            self._escalated = True
        from .spans import innermost_active

        self.last_where = innermost_active()
        where = (f" inside span/phase {self.last_where!r}"
                 if self.last_where else "")
        self._escalations.inc()
        if self.on_escalate is not None:
            self.on_escalate(elapsed, thr)
        else:
            print(
                f"obs.watchdog: ESCALATION — the stall{where} has "
                f"persisted {elapsed:.1f}s (> {1 + self.escalate_after} x "
                f"the {thr:.1f}s threshold); this loop is likely wedged "
                "for good (hung collective / dead backend) — a "
                "supervisor should SIGKILL and resume elastically",
                file=sys.stderr,
            )

    def _run(self) -> None:
        while not self._stop.wait(self.check_every):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — a watchdog that can
                # crash is a watchdog that silently stops watching
                print(f"obs.watchdog: poll failed: {type(e).__name__}: {e}",
                      file=sys.stderr)

    def start(self) -> "StepWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fdtpu-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 4 * self.check_every))
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
