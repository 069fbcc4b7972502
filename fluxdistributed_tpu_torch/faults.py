"""Preemption tolerance: fault injection, retries and signal handling.

A copy of ``fluxdistributed_tpu/faults.py`` (stdlib apart from the
``fdtpu_fault_*`` counters, which land in the port's
:mod:`.obs.metrics` registry):

* :class:`FaultPlan` — a deterministic injection registry, so every
  tolerance path is provable on a CPU box: SIGTERM at step k, transient
  loader exceptions, a backend that is not granting.  Hot paths call
  :func:`fire` at named sites; with no plan installed that is one
  module-global ``None`` check.
* :func:`with_retries` — the one retry/backoff/jitter/budget policy,
  used by :func:`acquire_backend` and the checkpoint I/O
  (:mod:`.train.checkpoint`).
* :class:`SignalFlag` + :class:`Preempted` — checkpoint-on-signal: the
  handlers set a flag, the trainer's step boundary checks it, ``train``
  writes a checkpoint and the RESUME manifest and raises
  :class:`Preempted`; the training CLI exits with :data:`PREEMPTED_RC`
  so a supervisor can tell "requeue me" from "I crashed".

:func:`acquire_backend` enumerates the CUDA devices through torch with
the same retries; with no card it raises :class:`BackendUnavailable`
unless the caller asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FAULT_ACTIONS",
    "HALTED_RC",
    "HANG_DELAY_SECONDS",
    "PREEMPTED_RC",
    "UNAVAILABLE_SIGNATURES",
    "VALUE_ACTIONS",
    "BackendUnavailable",
    "FaultInjected",
    "FaultPlan",
    "Preempted",
    "RetryBudgetExceeded",
    "SignalFlag",
    "acquire_backend",
    "active_plan",
    "clear_plan",
    "fire",
    "fire_value",
    "install_plan",
    "install_plan_arg",
    "param",
    "record_preemption",
    "with_retries",
]

#: exit code of a CLI run that checkpointed and exited on SIGTERM —
#: EX_TEMPFAIL, the sysexits "try again later" code, distinct from both
#: success (0) and a crash (1/tracebacks): a supervisor that sees it
#: should requeue the run with ``--resume``.
PREEMPTED_RC = 75

#: exit code of a CLI run the training guard HALTED (rollback loop:
#: anomalies recur faster than checkpoints make progress) — EX_DATAERR,
#: "the input data was incorrect".  Deliberately NOT retryable: a
#: supervisor that sees it must page a human instead of requeueing a
#: run that provably cannot make progress (``train/guard.py``).
HALTED_RC = 65


class FaultInjected(RuntimeError):
    """Base class of every exception a :class:`FaultPlan` raises."""


class BackendUnavailable(FaultInjected):
    """The backend is not there: simulated by a plan, or raised by
    :func:`acquire_backend` when torch sees no CUDA device.  Retryable,
    as the real-world signatures in :data:`UNAVAILABLE_SIGNATURES`
    are."""


class RetryBudgetExceeded(RuntimeError):
    """:func:`with_retries` ran out of attempts/seconds; ``__cause__``
    is the last underlying error."""


class Preempted(RuntimeError):
    """Training was interrupted by SIGTERM/SIGINT and checkpointed at a
    step boundary.  Carries everything a supervisor needs to resume."""

    def __init__(self, message: str, *, step: int = 0, next_item: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 manifest: Optional[dict] = None):
        super().__init__(message)
        self.step = step
        self.next_item = next_item
        self.checkpoint_dir = checkpoint_dir
        self.manifest = manifest or {}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _metrics():
    """The fdtpu_fault_* instruments, created lazily in the process
    registry (import cycles: obs imports nothing from here)."""
    from .obs import get_registry

    reg = get_registry()
    return {
        "injected": reg.counter(
            "fdtpu_fault_injected_total",
            "faults injected by the active FaultPlan", labelnames=("site",)),
        "retries": reg.counter(
            "fdtpu_fault_retries_total",
            "retry attempts after a retryable error", labelnames=("site",)),
        "giveups": reg.counter(
            "fdtpu_fault_giveups_total",
            "with_retries exhaustions (budget/attempts out)",
            labelnames=("site",)),
        "backoff": reg.counter(
            "fdtpu_fault_backoff_seconds_total",
            "seconds slept between retry attempts", labelnames=("site",)),
        "preemptions": reg.counter(
            "fdtpu_fault_preemptions_total",
            "SIGTERM/SIGINT checkpoint-and-exit events"),
    }


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------


#: every action :meth:`FaultPlan.fail` / ``from_spec``'s ``fail`` key
#: accepts — the serve-side fault model needs more than exceptions:
#: ``exit`` is a replica crash (``os._exit`` — no drain, no atexit, the
#: SIGKILL shape), ``sleep`` is a slow replica (delay then continue),
#: ``hang`` is a wedged one (delay defaults to an hour — the caller's
#: timeout machinery is what's under test).  ``nan``/``inf`` are VALUE
#: corruptions: they only trigger at :func:`fire_value` sites (the
#: training guard's ``train.loss``/``train.grad`` sentinel taps) and
#: replace the observed value instead of raising — the RNG-free way to
#: prove every anomaly-detection path on a CPU dev box.
FAULT_ACTIONS = ("raise", "sigterm", "sigint", "exit", "sleep", "hang",
                 "nan", "inf")

#: the subset of :data:`FAULT_ACTIONS` that corrupts an observed value
#: rather than performing a side effect; matched only by
#: :func:`fire_value` (plain :func:`fire` skips them — a value
#: corruption without a value to corrupt is meaningless).
VALUE_ACTIONS = ("nan", "inf")

#: how long a "hang" action sleeps when no explicit delay is given —
#: far beyond any probe/dispatch/request timeout in the tree
HANG_DELAY_SECONDS = 3600.0


@dataclasses.dataclass
class _Fault:
    site: str
    at: Optional[int] = None        # trigger only when fire(index=at)
    times: int = 1                  # how many triggers remain
    action: str = "raise"           # one of FAULT_ACTIONS
    exc: Optional[Callable[[], BaseException]] = None
    message: str = "injected fault"
    delay: float = 0.0              # seconds for sleep/hang actions
    fired: int = 0                  # triggers delivered so far


class FaultPlan:
    """Deterministic injection registry.

    Sites wired into the framework:

    * ``"step"`` — the trainer's step boundary (``fire(index=j)`` with
      the loader-item index);
    * ``"loader"`` — host-side batch assembly inside a prefetch worker
      (``fire(index=i)`` with the batch index; the loader retries
      transient failures via :func:`with_retries`);
    * ``"backend_init"`` — inside :func:`acquire_backend`'s attempt,
      before the CUDA devices are counted;
    * ``"resume"`` — entry of ``train.resume_training``;
    * ``"checkpoint_save"`` / ``"checkpoint_load"`` — inside the
      checkpoint write/read (retried by ``train/checkpoint.py``);
    * ``"serve.tick"`` — top of every serve ``Scheduler.step`` (``index``
      = the scheduler's tick count; an ``exit`` action here is a
      deterministic replica kill mid-burst, ``sleep``/``hang`` a slow or
      wedged engine loop);
    * ``"serve.dispatch"`` — inside the router's per-request dispatch
      attempt (retried across replicas by ``with_retries``);
    * ``"serve.probe"`` — inside the router's health-probe attempt
      (``index`` = the running probe count; failures feed the circuit
      breaker without any real outage);
    * ``"train.loss"`` / ``"train.grad"`` — VALUE sites inside the
      training guard's sentinel read (``fire_value(site, value,
      index=j)`` with the loader-item index): a ``nan``/``inf`` action
      replaces the observed loss / global grad-norm component, so every
      anomaly-detection + quarantine + rollback path is provable
      deterministically, RNG-free, with zero recompiles
      (``train/guard.py``).

    ``params`` is a free-form dict for harness knobs that are not
    exceptions (the JAX driver reads ``{"local_devices": 4}`` as a
    device-count change on resume; :func:`param` reads any knob).
    """

    def __init__(self):
        self._faults: List[_Fault] = []
        self.params: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # -- construction --------------------------------------------------
    def fail(self, site: str, *, at: Optional[int] = None, times: int = 1,
             exc: Optional[Callable[[], BaseException]] = None,
             message: str = "injected fault", action: str = "raise",
             delay: float = 0.0) -> "FaultPlan":
        """Trigger ``action`` at ``site`` (optionally only at occurrence
        index ``at``), ``times`` times.  The default raises an
        exception; see :data:`FAULT_ACTIONS` for the kill/slow/hang
        shapes (``delay`` is the sleep seconds for ``sleep``/``hang``)."""
        if action not in FAULT_ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; one of {FAULT_ACTIONS}")
        if delay < 0:
            raise ValueError(f"delay must be >= 0, got {delay}")
        # under the lock: plans are usually built before installation,
        # but a test arming extra faults while a fire() iterates the
        # list from another thread must not race the traversal
        with self._lock:
            self._faults.append(
                _Fault(site=site, at=at, times=times, exc=exc,
                       message=message, action=action, delay=float(delay)))
        return self

    def sigterm_at_step(self, k: int) -> "FaultPlan":
        """Deliver SIGTERM to this process at the trainer's step
        boundary ``k`` — the deterministic preemption."""
        with self._lock:
            self._faults.append(_Fault(site="step", at=k, action="sigterm"))
        return self

    def sigint_at_step(self, k: int) -> "FaultPlan":
        with self._lock:
            self._faults.append(_Fault(site="step", at=k, action="sigint"))
        return self

    def loader_fail(self, *, at: int = 0, times: int = 1) -> "FaultPlan":
        """Transient data-loader exceptions at batch index ``at``."""
        return self.fail(
            "loader", at=at, times=times, exc=lambda: OSError(
                "injected transient loader failure"))

    def backend_unavailable(self, times: int = 1) -> "FaultPlan":
        """The first ``times`` backend acquisitions fail as if the chip
        were not granting."""
        return self.fail(
            "backend_init", times=times,
            exc=lambda: BackendUnavailable(
                "injected UNAVAILABLE: backend is not granting"))

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlan":
        """Build a plan from a JSON-able dict (the ``--fault-plan``
        CLI / env surface)::

            {"sigterm_at_step": 3,
             "loader_fail": {"at": 1, "times": 2},
             "backend_unavailable": 2,
             "params": {"local_devices": 4}}

        The generic ``fail`` key addresses any site/action directly —
        the serve-side surface (replica kill/slow/hang, dispatch and
        probe failures)::

            {"fail": [{"site": "serve.tick", "at": 40, "action": "exit"},
                      {"site": "serve.dispatch", "times": 2},
                      {"site": "serve.probe", "action": "sleep",
                       "delay": 0.5}]}

        — and the training-guard surface: ``nan``/``inf`` value
        corruptions at the sentinel sites, a deterministic step-k
        anomaly with no RNG and no recompile::

            {"fail": [{"site": "train.loss", "at": 2, "action": "nan"},
                      {"site": "train.grad", "at": 5, "action": "inf"}]}
        """
        plan = cls()
        known = {"sigterm_at_step", "sigint_at_step", "loader_fail",
                 "backend_unavailable", "params", "fail"}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"unknown fault-plan keys {sorted(unknown)}; "
                f"supported: {sorted(known)}")
        if "sigterm_at_step" in spec:
            plan.sigterm_at_step(int(spec["sigterm_at_step"]))
        if "sigint_at_step" in spec:
            plan.sigint_at_step(int(spec["sigint_at_step"]))
        if "loader_fail" in spec:
            lf = spec["loader_fail"] or {}
            plan.loader_fail(at=int(lf.get("at", 0)),
                             times=int(lf.get("times", 1)))
        if "backend_unavailable" in spec:
            plan.backend_unavailable(int(spec["backend_unavailable"]))
        for f in spec.get("fail") or []:
            fkeys = {"site", "at", "times", "action", "delay", "message"}
            unknown = set(f) - fkeys
            if unknown:
                raise ValueError(
                    f"unknown fail-entry keys {sorted(unknown)}; "
                    f"supported: {sorted(fkeys)}")
            if "site" not in f:
                raise ValueError(f"fail entry needs a site: {f!r}")
            plan.fail(
                str(f["site"]),
                at=None if f.get("at") is None else int(f["at"]),
                times=int(f.get("times", 1)),
                action=str(f.get("action", "raise")),
                delay=float(f.get("delay", 0.0)),
                message=str(f.get("message", "injected fault")))
        plan.params.update(spec.get("params") or {})
        return plan

    # -- delivery ------------------------------------------------------
    def fire(self, site: str, index: Optional[int] = None) -> None:
        """Trigger any matching fault.  ``raise`` actions raise; signal
        actions ``os.kill`` this process (a python handler — e.g. the
        trainer's :class:`SignalFlag` — runs before the caller's next
        bytecode, so the very next boundary check observes it);
        ``exit`` is an immediate hard kill (``os._exit`` — a crash, not
        a drain); ``sleep``/``hang`` stall the CALLING thread for the
        fault's delay and then return (the slow/wedged-replica shapes —
        everything else in the process keeps running).  Value actions
        (``nan``/``inf``) never match here — they need a value to
        corrupt and only trigger at :meth:`fire_value` sites."""
        to_signal = None
        exc: Optional[BaseException] = None
        hard_exit = False
        stall = 0.0
        with self._lock:
            for f in self._faults:
                if f.site != site or f.fired >= f.times:
                    continue
                if f.at is not None and index != f.at:
                    continue
                if f.action in VALUE_ACTIONS:
                    continue
                f.fired += 1
                _metrics()["injected"].labels(site=site).inc()
                if f.action == "sigterm":
                    to_signal = signal.SIGTERM
                elif f.action == "sigint":
                    to_signal = signal.SIGINT
                elif f.action == "exit":
                    hard_exit = True
                elif f.action in ("sleep", "hang"):
                    stall = f.delay if (
                        f.action == "sleep" or f.delay > 0
                    ) else HANG_DELAY_SECONDS
                else:
                    exc = f.exc() if f.exc is not None else FaultInjected(
                        f"{f.message} (site={site}, index={index})")
                break
        if hard_exit:
            # the un-drainable crash: no atexit, no finally blocks —
            # the same shape as SIGKILL/OOM, which is the point
            os._exit(1)
        if to_signal is not None:
            os.kill(os.getpid(), to_signal)
            return
        if stall > 0:
            time.sleep(stall)
            return
        if exc is not None:
            raise exc

    def fire_value(self, site: str, value: float,
                   index: Optional[int] = None) -> float:
        """Value-corruption delivery: side-effect actions at ``site``
        run first (via :meth:`fire` — a ``raise``/``hang`` planted on a
        sentinel site still behaves), then the first matching
        ``nan``/``inf`` action replaces ``value``.  With no match the
        value passes through untouched."""
        self.fire(site, index)
        with self._lock:
            for f in self._faults:
                if f.site != site or f.fired >= f.times:
                    continue
                if f.at is not None and index != f.at:
                    continue
                if f.action not in VALUE_ACTIONS:
                    continue
                f.fired += 1
                _metrics()["injected"].labels(site=site).inc()
                return float("nan") if f.action == "nan" else float("inf")
        return value


_PLAN: Optional[FaultPlan] = None


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (tests/chaos runs)."""
    global _PLAN
    _PLAN = plan
    return plan


def install_plan_arg(spec: str) -> FaultPlan:
    """Install a CLI's ``--fault-plan``: a JSON object, or ``@path`` to
    a file holding one.  A malformed plan exits with its error."""
    import json

    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    try:
        plan = FaultPlan.from_spec(json.loads(spec))
    except (ValueError, TypeError) as e:
        raise SystemExit(f"--fault-plan: {e}")
    return install_plan(plan)


def clear_plan() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str, index: Optional[int] = None) -> None:
    """Hot-path hook: no-op (one global load + None check) unless a
    plan is installed."""
    if _PLAN is not None:
        _PLAN.fire(site, index)


def fire_value(site: str, value: float, index: Optional[int] = None) -> float:
    """Hot-path VALUE hook (the guard's sentinel taps): returns
    ``value`` untouched unless the active plan plants a ``nan``/``inf``
    corruption at ``site`` — one global load + None check when idle."""
    if _PLAN is not None:
        return _PLAN.fire_value(site, value, index)
    return value


def param(name: str, default: Any = None) -> Any:
    """A harness knob from the active plan (None-safe)."""
    if _PLAN is None:
        return default
    return _PLAN.params.get(name, default)


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------

# deterministic-by-default jitter stream: reseeded per with_retries call
# so two identical runs back off identically (the harness is provable)
_JITTER_SEED = 0x5FDB


#: error-message fragments that mean "the backend was not there", not
#: "the code is wrong" (the JAX package's list, unchanged, so the two
#: classifiers agree)
UNAVAILABLE_SIGNATURES = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "failed to connect",
    "Connection reset", "Connection refused", "Socket closed",
    "response body closed", "remote_compile", "No visible device",
    "Unable to initialize backend", "timed out", "per-attempt bound",
)


def _default_retryable(err: BaseException) -> bool:
    """Transient by default: injected faults, OS/IO errors, and
    anything carrying a backend-unavailable signature.  Programming
    errors (TypeError, ValueError, ...) are not retried."""
    if isinstance(err, (FaultInjected, OSError, IOError, TimeoutError,
                        ConnectionError)):
        return True
    s = str(err)
    return any(sig in s for sig in UNAVAILABLE_SIGNATURES)


def with_retries(
    fn: Callable[[], Any],
    *,
    tries: int = 3,
    timeout: Optional[float] = None,
    backoff: float = 0.5,
    jitter: float = 0.1,
    budget: Optional[float] = None,
    retryable: Optional[Callable[[BaseException], bool]] = None,
    site: str = "generic",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn()`` with bounded exponential-backoff retries.

    * ``tries`` — max attempts;
    * ``timeout`` — per-attempt wall bound: the attempt runs on a
      daemon thread and a hang counts as a retryable failure (the
      thread itself cannot be interrupted — a truly wedged C call
      leaks it; this is the in-process best effort);
    * ``backoff`` — first sleep; doubles each retry;
    * ``jitter`` — fraction of the sleep randomized (deterministic
      stream, so two identical runs back off identically);
    * ``budget`` — total wall seconds across attempts AND sleeps; when
      exceeded, gives up with :class:`RetryBudgetExceeded`;
    * ``retryable`` — classifier; default retries injected faults,
      OS/IO errors and backend-unavailable signatures only.

    Retry/giveup/backoff tallies land in the ``fdtpu_fault_*`` counters
    under ``site``.
    """
    if tries < 1:
        raise ValueError(f"tries must be >= 1, got {tries}")
    m = _metrics()
    rng = random.Random(_JITTER_SEED)
    classify = retryable or _default_retryable
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(tries):
        if budget is not None and time.monotonic() - t0 > budget:
            break
        try:
            if timeout is None:
                return fn()
            box: dict = {}

            def run():
                try:
                    box["value"] = fn()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            th = threading.Thread(target=run, daemon=True)
            th.start()
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError(
                    f"attempt exceeded the {timeout}s per-attempt bound "
                    f"(site={site}); the worker thread is abandoned")
            if "error" in box:
                raise box["error"]
            return box.get("value")
        except BaseException as e:  # noqa: BLE001 — classified below
            last = e
            if not classify(e) or attempt == tries - 1:
                if attempt == tries - 1 and classify(e):
                    break  # exhausted: report as budget/attempts out
                raise
            pause = backoff * (2 ** attempt)
            pause += pause * jitter * rng.random()
            if budget is not None:
                pause = min(pause, max(0.0, budget - (time.monotonic() - t0)))
            m["retries"].labels(site=site).inc()
            m["backoff"].labels(site=site).inc(pause)
            if pause > 0:
                sleep(pause)
    m["giveups"].labels(site=site).inc()
    raise RetryBudgetExceeded(
        f"gave up after {tries} attempt(s) at site={site!r}: "
        f"{type(last).__name__ if last else 'no attempt ran'}: {last}"
    ) from last


def acquire_backend(
    *,
    device=None,
    tries: int = 3,
    timeout: Optional[float] = 120.0,
    backoff: float = 5.0,
    budget: Optional[float] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Enumerate devices with retries — the backend-acquisition boundary
    for training and serving bring-up.  ``device=None`` (or ``"cuda"``)
    asks for the CUDA devices: each attempt counts them through torch,
    and none visible is :class:`BackendUnavailable` (retried, then
    :class:`RetryBudgetExceeded`); the CPU is used only when the caller
    asks for it (``device="cpu"``), never as a quiet fall-back.  Returns
    the list of ``torch.device`` s."""

    def attempt():
        fire("backend_init")
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu":
            return [dev]
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev} (cuda|cpu)")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise BackendUnavailable(
                "No visible device: torch sees no CUDA device; pass "
                "device='cpu' to run on the CPU")
        if dev.index is not None:
            if dev.index >= n:
                raise ValueError(f"{dev} asked for, {n} CUDA device(s) seen")
            return [dev]
        return [torch.device("cuda", i) for i in range(n)]

    return with_retries(
        attempt, tries=tries, timeout=timeout, backoff=backoff,
        budget=budget, site="backend_init", sleep=sleep)


# ---------------------------------------------------------------------------
# signals
# ---------------------------------------------------------------------------


class SignalFlag:
    """Install handlers that record a delivered signal instead of
    killing the process.  The trainer polls :meth:`is_set` at its step
    boundary; a SECOND delivery of the same signal restores escalation
    semantics (raises ``KeyboardInterrupt`` from the handler) so a
    stuck run can still be killed interactively.

    Handlers only install from the main thread (CPython restriction);
    elsewhere :meth:`install` is a recorded no-op and :meth:`is_set`
    still works for programmatic ``set()`` use.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._received: Optional[int] = None
        self._previous: dict = {}
        self.installed = False

    def _handler(self, signum, frame):
        if self._event.is_set():
            raise KeyboardInterrupt(
                f"second signal {signum} during checkpoint-and-exit")
        self._received = signum
        self._event.set()

    def install(self) -> "SignalFlag":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handler)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, old in self._previous.items():
            try:
                signal.signal(s, old)
            except (ValueError, OSError):  # not main thread / teardown
                pass
        self._previous.clear()
        self.installed = False

    def set(self) -> None:
        """Programmatic trigger (tests; cooperative preemption)."""
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()

    @property
    def received(self) -> Optional[int]:
        return self._received

    @property
    def reason(self) -> str:
        if self._received == signal.SIGTERM:
            return "sigterm"
        if self._received == signal.SIGINT:
            return "sigint"
        return "requested"

    def __enter__(self) -> "SignalFlag":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def record_preemption() -> None:
    """Count a checkpoint-and-exit event (called by the trainer once
    the checkpoint + manifest are durably on disk)."""
    _metrics()["preemptions"].inc()
