"""Self-healing training: anomaly detection in the run and bounded
recovery.

Port of ``fluxdistributed_tpu/train/guard.py``; the policy is the JAX
one, unchanged.  Checkpoints, preemption and resume make a run survive
failures outside it; this module defends the loop against its own
steps.  A non-finite gradient or a loss spike used to crash the run or
train on through it.

Three pieces:

* **The sentinel on the device** (:func:`..parallel.dp.guard_sentinel`,
  built into the train step by ``prepare_training(guard=True)``): an
  f32 [2] ``[poisoned_loss, grad_norm]``, the finiteness of the loss
  and of every gradient folded into the first entry (``0 * inf`` and
  ``0 * nan`` are NaN) and the global gradient norm in the second.  A
  step without it falls back to the loss (``metrics["loss"]``), blind
  to a gradient blow-up that leaves the loss finite.  Reading it is one
  device-to-host copy a loader item, which waits for the step: the
  verdict comes before the step's state is committed.
* **The policy on the host** (:class:`TrainGuard`): a rolling robust
  z-score spike detector (median/MAD) feeding the ladder

  1. **skip and quarantine**: the item joins the quarantine, the step's
     result is discarded and the run goes on from the state before it
     (a guarded step keeps that state: on a card its CUDA graph copies
     the state it is given into a shadow before each replay);
  2. **rollback**: anomalies persisting inside a window
     (``rollback_after`` within ``anomaly_window`` items) restore the
     last checkpoint, rewind the loader's cursor and replay with the
     quarantined items skipped, recorded in the RESUME manifest;
  3. **halt**: rollbacks recurring without ``progress_steps`` of clean
     items in between raise :class:`GuardHalt` (``retryable=False``),
     which the training CLI maps to :data:`..faults.HALTED_RC`.

* **Deterministic replay** (:func:`replay_item`, the CLI's
  ``--replay-step K``): a loader item is a pure function of ``(seed,
  item)``, so a quarantined step re-runs from the checkpoint and the
  cursor, under ``torch.autograd.detect_anomaly``, which names the
  backward op that made a NaN.

Every decision lands in ``fdtpu_guard_*`` metrics.  Tests inject
anomalies through the :mod:`..faults` value sites (``train.loss`` and
``train.grad`` with ``nan``/``inf`` actions), which corrupt what the
guard observes and never the training state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..parallel.graphs import state_donated
from .logging import Logger, current_logger

__all__ = ["GuardConfig", "GuardHalt", "TrainGuard", "replay_item",
           "state_donated"]


class GuardHalt(RuntimeError):
    """The guard's terminal verdict: recovery is looping without
    progress (or rollback is needed with nothing to roll back to).
    ``retryable`` is False by construction — a supervisor must NOT
    requeue this run (the training CLI maps it to
    :data:`..faults.HALTED_RC`)."""

    retryable = False

    def __init__(self, message: str, *, rollbacks: int = 0,
                 quarantined: Sequence[int] = ()):
        super().__init__(message)
        self.rollbacks = rollbacks
        self.quarantined = list(quarantined)


@dataclasses.dataclass
class GuardConfig:
    """Policy knobs for :class:`TrainGuard`.

    Attributes
    ----------
    window: rolling robust-statistics window (accepted losses) feeding
        the spike detector's median/MAD
    warmup: accepted samples required before spike detection arms (the
        first losses of a fresh run are a falling edge, not a baseline);
        non-finite detection is always armed
    zmax: robust z-score threshold — ``0.6745 * |x - median| / MAD``
        above it is a spike (8 ≈ "this loss is not from this run's
        distribution"; cadence jitter and eval-cycle wobble sit far
        below)
    rollback_after: anomalies within ``anomaly_window`` recent items
        that escalate skip → rollback
    anomaly_window: the "persist" window, in loader items
    max_rollbacks: rollbacks tolerated without an intervening
        ``progress_steps`` clean span; one more halts the run
    progress_steps: clean (non-anomalous) items that clear the rollback
        debt
    quarantine: loader items to skip from the start — how a clean run
        deterministically skips the batches another run quarantined
        (the loss-parity oracle), and how a resume replays decisions
        recorded in the manifest
    """

    window: int = 64
    warmup: int = 8
    zmax: float = 8.0
    rollback_after: int = 3
    anomaly_window: int = 16
    max_rollbacks: int = 2
    progress_steps: int = 32
    quarantine: Sequence[int] = ()

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if self.warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {self.warmup}")
        if self.zmax <= 0:
            raise ValueError(f"zmax must be > 0, got {self.zmax}")
        if self.rollback_after < 1:
            raise ValueError(
                f"rollback_after must be >= 1, got {self.rollback_after}")
        if self.anomaly_window < 1:
            raise ValueError(
                f"anomaly_window must be >= 1, got {self.anomaly_window}")
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}")


class TrainGuard:
    """Host-side policy engine over the per-step sentinel.

    The trainer calls :meth:`is_quarantined` before dispatching an item
    and :meth:`observe` on the step's metrics before committing the new
    state; ``observe`` returns one of ``"ok"`` / ``"skip"`` /
    ``"rollback"`` / ``"halt"`` and the trainer executes the verdict
    (it owns the state, the loader cursor and the checkpoint dir).
    Decisions are a pure function of replicated scalars, so every host
    of a multi-host run reaches the same verdict from the same step.
    """

    def __init__(self, config: Optional[GuardConfig] = None, *,
                 registry=None, logger: Optional[Logger] = None):
        from ..obs import get_registry

        self.config = config or GuardConfig()
        self.logger = logger or current_logger()
        reg = registry if registry is not None else get_registry()
        self._quarantined: set = {int(i) for i in self.config.quarantine}
        self._losses: deque = deque(maxlen=self.config.window)
        self._recent_anomalies: deque = deque()
        self._rollbacks = 0
        self._rollback_debt = 0
        self._good_since_rollback = 0
        #: decision ledger (JSON-able), newest last — the CLI logs
        #: it and tests read it; bounded like the loss window
        self.events: deque = deque(maxlen=256)
        self._m_anomalies = reg.counter(
            "fdtpu_guard_anomalies_total",
            "anomalous train steps detected by the guard",
            labelnames=("kind",))
        self._m_quarantined = reg.counter(
            "fdtpu_guard_quarantined_total",
            "loader items quarantined (skipped and recorded) by the guard")
        self._m_replayed = reg.counter(
            "fdtpu_guard_replay_skips_total",
            "pre-step skips of already-quarantined items (rollback "
            "replays and resumed runs)")
        self._m_rollbacks = reg.counter(
            "fdtpu_guard_rollbacks_total",
            "rollbacks to the last-good checkpoint")
        self._m_halts = reg.counter(
            "fdtpu_guard_halts_total",
            "guard halts (rollback loop without progress; retryable=false)")
        self._g_quarantine = reg.gauge(
            "fdtpu_guard_quarantine_size", "items currently quarantined")
        self._g_z = reg.gauge(
            "fdtpu_guard_last_z",
            "robust z-score of the most recent observed loss (0 until "
            "the detector warms up)")
        self._g_gnorm = reg.gauge(
            "fdtpu_guard_grad_norm", "global grad L2 norm of the most "
            "recent step carrying the compiled sentinel")
        self._g_quarantine.set(len(self._quarantined))

    # -- quarantine bookkeeping ---------------------------------------
    def is_quarantined(self, item: int) -> bool:
        return int(item) in self._quarantined

    def quarantined_items(self) -> list:
        return sorted(self._quarantined)

    def quarantine(self, item: int) -> None:
        self._quarantined.add(int(item))
        self._m_quarantined.inc()
        self._g_quarantine.set(len(self._quarantined))

    def note_replayed_skip(self, item: int) -> None:
        """A pre-step skip of an already-quarantined item (the replay
        after a rollback, or a resumed run honoring the manifest)."""
        self._m_replayed.inc()
        self.events.append({"item": int(item), "decision": "replay_skip"})

    # -- the robust spike detector ------------------------------------
    def zscore(self, x: float) -> Optional[float]:
        """Robust z of ``x`` against the accepted-loss window, or None
        while the detector is warming up.  0.6745·(x−median)/MAD — the
        MAD-consistency constant makes it comparable to a normal z.
        A degenerate MAD (e.g. an alternating window, where more than
        half the deviations are exactly zero) falls back to the mean
        absolute deviation; a bit-constant window falls through to an
        epsilon scale, so the first genuinely different loss still
        registers."""
        if len(self._losses) < self.config.warmup:
            return None
        vals = np.asarray(self._losses, dtype=np.float64)
        med = float(np.median(vals))
        dev = np.abs(vals - med)
        scale = max(float(np.median(dev)), float(np.mean(dev)),
                    1e-9 * max(abs(med), 1.0))
        return 0.6745 * (x - med) / scale

    # -- the verdict ---------------------------------------------------
    def observe(self, item: int, metrics: dict,
                can_rollback: bool = True) -> str:
        """Classify one completed step and return the trainer's order:
        ``"ok"`` (commit the new state), ``"skip"`` (discard it, the
        item is quarantined), ``"rollback"`` (restore last-good
        checkpoint and rewind to it), ``"halt"`` (raise
        :class:`GuardHalt`).

        ``metrics["guard"]`` — the compiled sentinel ``[poisoned_loss,
        grad_norm]`` (stacked ``[K, 2]`` under the device loop) — is
        preferred; ``metrics["loss"]`` is the loss-only fallback.
        Reading it is THE per-step device sync the guard costs (one
        device-to-host copy of the sentinel, which waits for the step).
        ``can_rollback=False`` (no checkpoint dir / nothing saved yet)
        short-circuits the rollback tier to halt.
        """
        g = metrics.get("guard")
        sentinel_compiled = g is not None
        if g is None:
            g = metrics["loss"]
        if torch.is_tensor(g):
            g = g.detach().float().cpu().numpy()
        arr = np.asarray(g, dtype=np.float64)
        if sentinel_compiled:
            rows = arr.reshape(-1, 2)
            losses = [float(r[0]) for r in rows]
            gnorms = [float(r[1]) for r in rows]
        else:
            losses = [float(v) for v in arr.reshape(-1)]
            gnorms = []
        # deterministic injection taps: the fault plan corrupts what
        # the guard OBSERVES (never the training state), so detection +
        # recovery are provable RNG-free and the "clean run that
        # skipped the same batch" oracle stays exact
        losses[0] = faults.fire_value("train.loss", losses[0], index=item)
        if gnorms:
            gnorms[0] = faults.fire_value("train.grad", gnorms[0], index=item)
            finite_g = [v for v in gnorms if math.isfinite(v)]
            if finite_g:
                self._g_gnorm.set(finite_g[-1])

        kind = None
        detail: dict = {}
        if not all(map(math.isfinite, losses + gnorms)):
            kind = "nonfinite"
            detail = {"loss": losses[0],
                      "grad_norm": gnorms[0] if gnorms else None}
        else:
            for v in losses:
                z = self.zscore(v)
                if z is not None:
                    self._g_z.set(z)
                if z is not None and abs(z) > self.config.zmax:
                    kind = "loss_spike"
                    detail = {"loss": v, "z": round(z, 2)}
                    break

        if kind is None:
            self._losses.extend(losses)
            self._good_since_rollback += 1
            if (self._rollback_debt
                    and self._good_since_rollback
                    >= self.config.progress_steps):
                self._rollback_debt = 0
            return "ok"

        self._m_anomalies.labels(kind=kind).inc()
        self.quarantine(item)
        self._recent_anomalies.append(int(item))
        self._good_since_rollback = 0
        lo = int(item) - self.config.anomaly_window
        while self._recent_anomalies and self._recent_anomalies[0] <= lo:
            self._recent_anomalies.popleft()
        persistent = len(self._recent_anomalies) >= self.config.rollback_after

        decision = "skip"
        if persistent:
            if self._rollback_debt >= self.config.max_rollbacks or (
                    not can_rollback):
                decision = "halt"
                self._m_halts.inc()
            else:
                decision = "rollback"
                self._rollbacks += 1
                self._rollback_debt += 1
                self._recent_anomalies.clear()
                self._m_rollbacks.inc()
        event = {"item": int(item), "decision": decision, "kind": kind,
                 **detail}
        self.events.append(event)
        self.logger.info(
            f"guard: {kind} anomaly at item {item} -> {decision} "
            f"({detail}; {len(self._quarantined)} quarantined, "
            f"{self._rollbacks} rollbacks)")
        return decision

    def halt(self, reason: str) -> GuardHalt:
        """Build the terminal error (the trainer raises it)."""
        return GuardHalt(
            f"{reason} — quarantined items "
            f"{self.quarantined_items()}, {self._rollbacks} rollback(s); "
            "NOT retryable: requeueing cannot make progress, inspect with "
            "python -m fluxdistributed_tpu_torch.train --replay-step <k>",
            rollbacks=self._rollbacks, quarantined=self.quarantined_items())

    def snapshot(self) -> dict:
        """JSON-able state summary (manifest / ledger / CLI log)."""
        return {
            "quarantined_items": self.quarantined_items(),
            "rollbacks": self._rollbacks,
            "rollback_debt": self._rollback_debt,
            "events": list(self.events)[-8:],
        }


def replay_item(task, item: int, debug_nans: bool = True) -> dict:
    """Re-run ONE loader item against the task's current state,
    deterministically: the postmortem of a quarantined step behind the
    training CLI's ``--replay-step K``.

    A loader item is a pure function of ``(seed, item)``, so the exact
    batch is assembled again without replaying the run; restore the
    checkpoint first (``--resume``) to reproduce the state the anomaly
    met.  With ``debug_nans`` the step runs under
    ``torch.autograd.detect_anomaly``, the counterpart of JAX's
    ``jax_debug_nans``: a NaN in the backward raises naming the op that
    made it, and the report carries that message (``finite`` False).
    The step runs eagerly (a device loop's K steps as a plain loop, no
    CUDA graph) and its result is discarded: the task's state is not
    touched.  Returns a JSON-able report."""
    if state_donated(task.state):
        raise ValueError(
            "replay_item needs a live state: this task's state was given "
            "to a donating CUDA graph replay; re-prepare it with "
            "prepare_training(guard=True)")
    if item < 0 or item >= len(task.loader):
        raise ValueError(
            f"item {item} outside this run's range [0, {len(task.loader)})")
    batch = task.loader._put(task.loader._assemble(item))
    report: dict = {"item": int(item),
                    "steps_per_call": int(getattr(task.loader, "chunk", 1)),
                    "state_step": int(task.state.step)}
    step = getattr(task.step_fn, "eager", task.step_fn)
    anomaly = (torch.autograd.detect_anomaly(check_nan=True) if debug_nans
               else contextlib.nullcontext())
    try:
        with anomaly:
            _, metrics = step(task.state, batch)
    except RuntimeError as e:
        if not (debug_nans and "nan" in str(e).lower()):
            raise
        # detect_anomaly named the backward op that made the NaN: the
        # diagnosis, not a failure of the harness
        report.update(finite=False, error=str(e)[:500])
        return report
    g = metrics.get("guard")
    if g is not None:
        rows = g.detach().double().cpu().numpy().reshape(-1, 2)
        report.update(loss=[float(r[0]) for r in rows],
                      grad_norm=[float(r[1]) for r in rows],
                      finite=bool(np.isfinite(rows).all()),
                      sentinel="compiled")
    else:
        losses = metrics["loss"].detach().double().cpu().numpy().reshape(-1)
        report.update(loss=[float(v) for v in losses],
                      finite=bool(np.isfinite(losses).all()),
                      sentinel="loss-only")
    return report
