"""Deterministic-schedule race harness — the dynamic half of the
FDT3xx concurrency layer (a copy of the JAX package's
``analysis/schedules.py``, run over the port's objects).

Static rules (:mod:`.concurrency`) *predict* interleavings;
this module *forces* them.  A :class:`SchedulePlan` interposes on a
live object's threading primitives (:func:`instrument` swaps the
``threading.Lock``/``RLock``/``Event`` instances in its ``__dict__``
for traced wrappers) and injects preemption — a sleep long enough for
every other runnable thread to race ahead — at chosen **lock
boundaries**: the k-th crossing of ``"<Type>.<attr>.acquire"``,
``".held"`` (just after acquisition) or ``".release"``.  Under CPython's
5 ms GIL switch interval a racy window of a few bytecodes essentially
never interleaves on its own; a forced preemption inside it manifests
the race on the first run, every run — runnable over the real
Scheduler / Router / StepWatchdog / FlightRecorder objects with
``FakeLMEngine``.

Injection follows ``faults.py``'s factory-hook contract exactly: tests
build a plan, ``install_schedule`` it,
run, ``clear_schedule`` in a ``finally``.  Instrumented objects call
the module-level :func:`cross` hook, which is a single global ``None``
check when no plan is installed — production code never pays for the
harness.

Reproducers: a plan serializes to JSON (:meth:`SchedulePlan.spec`), and
:func:`run_under_schedule` dumps that spec — seed, preemption table,
full crossing log — next to the obs artifacts when the function under
test fails, so a CI schedule failure ships its exact interleaving::

    plan = SchedulePlan(seed=7).preempt_at("Scheduler._lock.release",
                                           at=1, delay=0.05)
    instrument(sched)
    run_under_schedule(plan, lambda: hammer(sched))  # dumps on raise
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Preemption",
    "SchedulePlan",
    "TracedEvent",
    "TracedLock",
    "active_schedule",
    "clear_schedule",
    "cross",
    "install_schedule",
    "instrument",
    "run_under_schedule",
]

#: concrete primitive types instrument() swaps (threading.Lock/RLock
#: are factory functions — the types only exist via construction)
_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))

#: env var naming a directory for schedule-failure reproducer JSON —
#: CI points it at the obs-artifacts dir so a failed harness run
#: uploads its exact interleaving
REPRO_DIR_ENV = "FDTPU_SCHEDULE_REPRO_DIR"


@dataclasses.dataclass
class Preemption:
    """Stall the crossing thread at the ``at``-th (1-based) crossing of
    ``site``, ``times`` consecutive crossings, ``delay`` seconds each —
    long enough for every other runnable thread to race past."""

    site: str
    at: int = 1
    times: int = 1
    delay: float = 0.05

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SchedulePlan:
    """A seeded preemption schedule over lock-boundary crossings.

    Two modes compose:

    * **explicit** — :meth:`preempt_at` pins a stall to the k-th
      crossing of one site: the deterministic-reproduction mode tests
      assert with;
    * **seeded fuzz** — :meth:`fuzz` derives, per ``(site, count)``
      crossing identity, whether/how long to stall from a hash of the
      seed.  The same seed injects the same stalls at the same
      crossings regardless of wall clock — an exploration mode whose
      failures replay exactly.

    The plan is also the flight recorder of the run: every crossing is
    logged (site, per-site index, thread name, stall applied), and
    :meth:`spec` serializes seed + table + log as the reproducer JSON.
    """

    def __init__(self, seed: int = 0, max_log: int = 4096):
        self.seed = int(seed)
        self.max_log = int(max_log)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._preempts: List[Preemption] = []
        self._fuzz: Optional[Tuple[float, float]] = None  # (prob, delay)
        self._log: List[dict] = []
        self._fired = 0

    # -- construction ---------------------------------------------------
    def preempt_at(self, site: str, at: int = 1, times: int = 1,
                   delay: float = 0.05) -> "SchedulePlan":
        if at < 1 or times < 1 or delay < 0:
            raise ValueError(
                f"need at>=1, times>=1, delay>=0; got {at}/{times}/{delay}")
        # plans are normally built before installation, but arming a
        # preemption mid-run must not race cross()'s table scan
        with self._lock:
            self._preempts.append(Preemption(site, at, times, float(delay)))
        return self

    def fuzz(self, prob: float = 0.25,
             delay: float = 0.005) -> "SchedulePlan":
        """Stall a seeded ``prob`` fraction of ALL crossings by
        ``delay`` — which crossings is a pure function of
        ``(seed, site, index)``, so a failing seed is its reproducer."""
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        with self._lock:
            self._fuzz = (float(prob), float(delay))
        return self

    # -- the interposition hot path -------------------------------------
    def cross(self, site: str) -> None:
        # `hit` and `stall` are distinct: a delay=0 preemption still
        # fires — time.sleep(0) yields the GIL, the minimal preemption
        hit, stall = False, 0.0
        with self._lock:
            c = self._counts[site] = self._counts.get(site, 0) + 1
            for p in self._preempts:
                if p.site == site and p.at <= c < p.at + p.times:
                    hit, stall = True, max(stall, p.delay)
            if not hit and self._fuzz is not None:
                prob, delay = self._fuzz
                h = zlib.crc32(f"{self.seed}:{site}:{c}".encode())
                if (h % 10_000) < prob * 10_000:
                    hit, stall = True, delay
            if hit:
                self._fired += 1
            if len(self._log) < self.max_log:
                self._log.append({
                    "site": site, "n": c,
                    "thread": threading.current_thread().name,
                    "hit": hit, "stall": stall})
        if hit:
            time.sleep(stall)

    # -- introspection / reproducers ------------------------------------
    def crossings(self, site: Optional[str] = None) -> Any:
        with self._lock:
            if site is not None:
                return self._counts.get(site, 0)
            return dict(self._counts)

    @property
    def fired(self) -> int:
        """Preemptions actually injected — a harness run that asserts
        on a schedule should also assert this is non-zero, or the
        harness has silently become a no-op."""
        with self._lock:
            return self._fired

    def spec(self) -> dict:
        with self._lock:
            return {
                "schema": "fdtpu-schedule-repro/v1",
                "seed": self.seed,
                "preempt": [p.to_dict() for p in self._preempts],
                "fuzz": ({"prob": self._fuzz[0], "delay": self._fuzz[1]}
                         if self._fuzz else None),
                "fired": self._fired,
                "crossings": dict(self._counts),
                "log": list(self._log),
            }

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.spec(), fh, indent=2)
            fh.write("\n")
        return path

    @classmethod
    def from_spec(cls, spec: dict) -> "SchedulePlan":
        plan = cls(seed=int(spec.get("seed", 0)))
        for p in spec.get("preempt") or []:
            plan.preempt_at(p["site"], at=int(p.get("at", 1)),
                            times=int(p.get("times", 1)),
                            delay=float(p.get("delay", 0.05)))
        fz = spec.get("fuzz")
        if fz:
            plan.fuzz(prob=float(fz["prob"]), delay=float(fz["delay"]))
        return plan


# -- the factory hook (faults.py contract: install/clear/active
# accessors only) --------------------------------------------------------

_SCHEDULE: Optional[SchedulePlan] = None


def install_schedule(plan: SchedulePlan) -> SchedulePlan:
    global _SCHEDULE
    _SCHEDULE = plan
    return plan


def clear_schedule() -> None:
    global _SCHEDULE
    _SCHEDULE = None


def active_schedule() -> Optional[SchedulePlan]:
    return _SCHEDULE


def cross(site: str) -> None:
    """Schedule-point hook: one global ``None`` check when no plan is
    installed — the instrumented primitives cost nothing outside the
    harness."""
    plan = _SCHEDULE
    if plan is not None:
        plan.cross(site)


# -- traced primitives ---------------------------------------------------


class TracedLock:
    """A ``Lock``/``RLock`` that announces its boundaries: ``.acquire``
    before blocking, ``.held`` just after acquisition, ``.release``
    just after release — the three points a forced preemption can pry
    an atomicity assumption apart."""

    def __init__(self, inner: Any, site: str):
        self._inner = inner
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        cross(f"{self.site}.acquire")
        got = self._inner.acquire(blocking, timeout)
        if got:
            cross(f"{self.site}.held")
        return got

    def release(self) -> None:
        self._inner.release()
        cross(f"{self.site}.release")

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class TracedEvent:
    """A ``threading.Event`` announcing ``.set`` and ``.wait``
    completion — wake-up ordering is schedulable too."""

    def __init__(self, inner: threading.Event, site: str):
        self._inner = inner
        self.site = site

    def set(self) -> None:
        self._inner.set()
        cross(f"{self.site}.set")

    def wait(self, timeout: Optional[float] = None) -> bool:
        got = self._inner.wait(timeout)
        cross(f"{self.site}.wait")
        return got

    def clear(self) -> None:
        self._inner.clear()

    def is_set(self) -> bool:
        return self._inner.is_set()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


def instrument(obj: Any, site_prefix: Optional[str] = None) -> Any:
    """Swap every ``Lock``/``RLock``/``Event`` in ``obj.__dict__`` for
    a traced wrapper whose site is ``"<Type>.<attr>"`` — real objects
    (a live Scheduler, Router, StepWatchdog, FlightRecorder) join the
    harness with no source changes.  Idempotent; returns ``obj``."""
    prefix = site_prefix or type(obj).__name__
    for name, val in list(vars(obj).items()):
        if isinstance(val, (TracedLock, TracedEvent)):
            continue
        if isinstance(val, _LOCK_TYPES):
            setattr(obj, name, TracedLock(val, f"{prefix}.{name}"))
        elif isinstance(val, threading.Event):
            setattr(obj, name, TracedEvent(val, f"{prefix}.{name}"))
    return obj


def run_under_schedule(plan: SchedulePlan, fn: Callable[[], Any],
                       repro_name: str = "schedule-failure") -> Any:
    """Install ``plan``, run ``fn``, always clear.  If ``fn`` raises
    (an assertion caught a race, or the race corrupted state into a
    crash) the plan's reproducer JSON is written to
    ``$FDTPU_SCHEDULE_REPRO_DIR`` (when set) before re-raising — CI
    uploads the directory with the obs artifacts, so the exact failing
    interleaving ships with the red build."""
    install_schedule(plan)
    try:
        return fn()
    except BaseException:
        repro_dir = os.environ.get(REPRO_DIR_ENV)
        if repro_dir:
            try:
                stamp = f"{repro_name}-seed{plan.seed}.json"
                plan.dump(os.path.join(repro_dir, stamp))
            except OSError:
                pass  # reproducers are best-effort forensics
        raise
    finally:
        clear_schedule()
