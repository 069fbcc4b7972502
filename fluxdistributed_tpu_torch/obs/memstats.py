"""Memory observability: the static price of a step, and live device
telemetry.

Port of ``fluxdistributed_tpu/obs/memstats.py``.

* the static half: :func:`step_memory` prices a step by running it once
  on fake tensors (:mod:`.pricing`; the JAX function asks XLA's
  ``memory_analysis`` of the compiled program): argument, output, temp
  and alias bytes and the peak, with ``"source": "fake"``.
  :func:`variant_report` prices every registered variant
  (:mod:`..analysis.variants`) through the real ``prepare_training`` /
  ``LMEngine`` paths, one fake run each feeding both the memory and the
  collective ledger (:mod:`.comms`).  :func:`rank_memory` is the one
  headroom ranking the fit checker (``python -m
  fluxdistributed_tpu_torch.fit``) and the layout picker
  (``parallel.layout.pick``) share; :func:`check_memory_baseline` and
  :func:`build_baseline` hold a sweep to the committed
  ``analysis/memory_baseline.json``; :func:`pp_plan_memory_check` holds
  a pipeline plan's per-stage estimate to the priced step it drives;
* :func:`tree_bytes` / :func:`state_bytes` price a tree of tensors (a
  training state) exactly from shapes and dtypes;
* :func:`hbm_device_stats` reads each local card's allocator truth off
  ``torch.cuda.memory_stats`` (bytes in use, the peak) and its capacity
  off ``torch.cuda.mem_get_info``: host-side reads of the caching
  allocator's counters and one driver query, neither of which waits for
  the stream;
* :class:`HbmGauges` exposes them as ``fdtpu_hbm_bytes_{in_use,peak,
  limit}`` per device and ``fdtpu_hbm_headroom_ratio`` (min over devices
  of ``(limit - in_use) / limit``), computed at scrape time so the hot
  path pays nothing.

Without a card (the CPU) the live reads return ``None``: the per-device
gauges register no cells, ``fdtpu_hbm_available`` reads 0 and the
headroom gauge NaN, as the JAX module does on its CPU backend.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import Registry, get_registry

__all__ = ["BASELINE_SCHEMA", "DEFAULT_TOLERANCE", "HbmGauges",
           "PP_MEMORY_FACTOR", "build_baseline", "check_memory_baseline",
           "hbm_device_stats", "hbm_summary", "min_headroom_ratio",
           "pp_plan_memory_check", "rank_memory", "state_bytes",
           "step_memory", "tree_bytes", "variant_report"]

#: memory-baseline artifact schema (analysis/memory_baseline.json)
BASELINE_SCHEMA = "fdtpu-membaseline/v1"

#: default regression tolerance of the baseline check: a variant's
#: priced peak may grow this fraction over its committed value before
#: the check fails (the JAX default, kept: it catches the 2x regressions
#: that break fits)
DEFAULT_TOLERANCE = 0.5


def tree_bytes(tree) -> int:
    """Exact bytes of every leaf with a shape and a dtype (tensors,
    numpy arrays; ``None`` and other leaves are skipped)."""
    from ..tree import leaves

    total = 0
    for x in leaves(tree):
        if hasattr(x, "element_size") and hasattr(x, "numel"):
            total += x.numel() * x.element_size()
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return int(total)


def state_bytes(state) -> Dict[str, int]:
    """Param / optimizer-state / model-state bytes of a training state
    (anything with those attributes).  A rank's own bytes: a ZeRO-1
    state's optimizer buffers are this rank's 1/N."""
    params = tree_bytes(getattr(state, "params", None))
    opt = tree_bytes(getattr(state, "opt_state", None))
    mstate = tree_bytes(getattr(state, "model_state", None))
    return {"param_bytes": params, "opt_state_bytes": opt,
            "model_state_bytes": mstate,
            "total_bytes": params + opt + mstate}


def _local_devices() -> List[int]:
    """The cards this process uses: its current device (a rank drives
    one card; asking another would create a context on it)."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.cuda.current_device()]


def hbm_device_stats(devices: Optional[Sequence[int]] = None
                     ) -> Optional[List[dict]]:
    """``[{"device", "kind", "bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}, ...]`` for ``devices`` (default: the local cards),
    or ``None`` without one.  ``bytes_in_use`` and its peak are the
    caching allocator's allocated bytes (JAX's allocator
    ``bytes_in_use``), ``bytes_limit`` the card's total memory."""
    import torch

    out = []
    for i in _local_devices() if devices is None else devices:
        st = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        in_use = int(st.get("allocated_bytes.all.current", 0))
        out.append({
            "device": i,
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                            in_use)),
            "bytes_limit": int(total),
        })
    return out or None


def _min_ratio(stats: Optional[List[dict]]) -> Optional[float]:
    if not stats:
        return None
    ratios = [(d["bytes_limit"] - d["bytes_in_use"]) / d["bytes_limit"]
              for d in stats if d["bytes_limit"] > 0]
    return min(ratios) if ratios else None


def hbm_summary() -> dict:
    """The ``/healthz`` memory block: per-device stats and their
    rollups, or ``{"available": False}`` without a card.  Never
    raises."""
    try:
        stats = hbm_device_stats()
    except Exception:  # noqa: BLE001 — telemetry must not kill a scrape
        return {"available": False}
    if not stats:
        return {"available": False}
    out = {"available": True, "devices": stats,
           "bytes_in_use_max": max(d["bytes_in_use"] for d in stats),
           "peak_bytes_in_use_max": max(d["peak_bytes_in_use"]
                                        for d in stats)}
    ratio = _min_ratio(stats)
    if ratio is not None:
        out["min_headroom_ratio"] = ratio
    return out


def min_headroom_ratio() -> Optional[float]:
    """Min over the local cards of ``(limit - in_use) / limit``: the
    watchdog's OOM-margin input; ``None`` without a card."""
    try:
        return _min_ratio(hbm_device_stats())
    except Exception:  # noqa: BLE001
        return None


class HbmGauges:
    """Scrape-time per-device memory gauges on a registry.

    Registration is get-or-create (one per ``train()`` on a shared
    registry is safe); availability is probed once, at construction.
    Without a card only ``fdtpu_hbm_available`` (0) and the NaN headroom
    gauge expose, so a CPU scrape says "unavailable" instead of
    inventing zero-byte devices.  ``devices=()`` reads no card at all
    (a serving engine on the CPU, or a fake one, asks no device).
    :meth:`close` detaches the callbacks from a shared registry."""

    #: one device sweep serves every gauge cell a scrape reads within
    #: this window
    SWEEP_TTL_SECONDS = 0.1

    def __init__(self, registry: Optional[Registry] = None,
                 name_prefix: str = "fdtpu",
                 devices: Optional[Sequence[int]] = None):
        self.registry = registry or get_registry()
        self._devices = devices
        p = name_prefix
        self._sweep_at = 0.0
        self._sweep: Optional[List[dict]] = None
        try:
            self.available = hbm_device_stats(devices) is not None
        except Exception:  # noqa: BLE001 — a broken backend reads as absent
            self.available = False
        g = self.registry.gauge
        self._avail = g(
            f"{p}_hbm_available",
            "1 when the card's allocator reports memory, 0 without a "
            "card (CPU)")
        self._avail.set(1.0 if self.available else 0.0)
        self._headroom = g(
            f"{p}_hbm_headroom_ratio",
            "min over devices of (bytes_limit - bytes_in_use) / "
            "bytes_limit — the OOM margin; NaN when unavailable")

        def _headroom_or_nan() -> float:
            r = _min_ratio(self._sweep_stats())
            return math.nan if r is None else r

        self._headroom.set_function(_headroom_or_nan)
        self.gauge_names = [f"{p}_hbm_available", f"{p}_hbm_headroom_ratio"]
        if self.available:
            for name, key, txt in (
                (f"{p}_hbm_bytes_in_use", "bytes_in_use",
                 "bytes the caching allocator has allocated, per device"),
                (f"{p}_hbm_bytes_peak", "peak_bytes_in_use",
                 "peak allocated bytes since process start, per device"),
                (f"{p}_hbm_bytes_limit", "bytes_limit",
                 "the card's total memory, per device"),
            ):
                gauge = g(name, txt, labelnames=("device",))
                self.gauge_names.append(name)
                for i in (_local_devices() if devices is None
                          else devices):
                    gauge.labels(device=str(i)).set_function(
                        lambda i=i, key=key: self._read(i, key))

    def _sweep_stats(self) -> Optional[List[dict]]:
        """One :func:`hbm_device_stats` sweep per ``SWEEP_TTL_SECONDS``,
        shared by every gauge cell a scrape renders."""
        now = time.monotonic()
        if now - self._sweep_at > self.SWEEP_TTL_SECONDS:
            try:
                self._sweep = hbm_device_stats(self._devices)
            except Exception:  # noqa: BLE001 — a broken read scrapes NaN
                self._sweep = None
            self._sweep_at = now
        return self._sweep

    def _read(self, device: int, key: str) -> float:
        for d in self._sweep_stats() or ():
            if d["device"] == device:
                return float(d[key])
        return math.nan

    def summary(self) -> dict:
        """The dict block ``/healthz`` embeds."""
        return hbm_summary()

    def close(self) -> None:
        """Detach the scrape-time callbacks from a shared registry."""
        for name in self.gauge_names:
            self.registry.unregister(name)


# -- the static half: a step priced on fake tensors ---------------------------

def step_memory(fn, args: Tuple[Any, ...]) -> Optional[dict]:
    """The priced memory of ``fn(*args)`` on fake tensors built under
    :func:`.pricing.pricing` (``{"argument_bytes", "output_bytes",
    "temp_bytes", "alias_bytes", "generated_code_bytes", "peak_bytes",
    "source"}``; :func:`.pricing.price_step`), or ``None`` when the step
    cannot run fake: its arguments are real tensors, or it needs their
    values (a data-dependent shape, a host read), as JAX returns None for
    a program it cannot compile.  Touches no device memory."""
    from .pricing import _fake_args, price_step

    if not _fake_args(args):
        return None
    try:
        return price_step(fn, args)["memory"]
    except Exception as e:  # noqa: BLE001 — only the unpriceable
        if not _unpriceable(e):
            raise
        return None


def _unpriceable(err: BaseException) -> bool:
    """A step that cannot run on fake tensors (it reads values)."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)

    return isinstance(err, (DataDependentOutputException,
                            DynamicOutputShapeException))


def variant_report(names: Optional[Sequence[str]] = None,
                   include_hlo: bool = True, device=None) -> Dict[str, dict]:
    """Memory and collectives of every registered variant (default: all;
    :mod:`..analysis.variants`), built through the real
    ``prepare_training`` / ``LMEngine`` paths on a fake world of 8 ranks
    and priced by ONE fake run each, which feeds both.  Per entry::

        {"source": ...,               # the file the program comes from
         "args_bytes": N,             # its arguments' bytes
         "memory": {...} | None,      # step_memory; None: cannot price
         "comms": {"recorded": [...]},  # the collectives it issued
         "unavailable": "reason"}     # only when it cannot run fake

    ``include_hlo=False`` (the fit checker's ``--no-hlo``) leaves the
    ledger out.  ``device`` is where the fake tensors live (default
    ``cuda``).  Touches no device memory."""
    from ..analysis.variants import WORLD, build_variants
    from .pricing import _tensors, price_step, pricing

    out: Dict[str, dict] = {}
    with pricing(WORLD, device=device) as pr:
        for v in build_variants(names, pr):
            entry: dict = {"source": v.source, "args_bytes": sum(
                t.numel() * t.element_size() for t in _tensors(v.args)),
                "memory": None}
            try:
                priced = price_step(v.fn, v.args, mesh=v.mesh)
            except Exception as e:  # noqa: BLE001 — only the unpriceable
                if not _unpriceable(e):
                    raise
                entry["unavailable"] = f"{type(e).__name__}: {e}"[:200]
                priced = None
            comms: dict = {}
            if priced is not None:
                entry["memory"] = priced["memory"]
                if include_hlo:
                    comms["recorded"] = priced["comms"]
            entry["comms"] = comms
            out[v.name] = entry
    return out


# -- headroom ranking (shared by the fit checker and the layout picker) -------

def rank_memory(variant_memory: Dict[str, dict],
                budget: Optional[float]) -> List[dict]:
    """Headroom ranking rows over ``{name: {"memory": step_memory-dict
    | None}}``, sorted most-headroom-first; entries whose memory is
    unknown rank LAST with ``fits=None`` — unknown is not "fits".  The
    ONE ranking the fit checker (over an artifact's variants) and
    ``parallel.layout.pick`` (over candidate layouts) consume."""
    rows = []
    for name, entry in sorted(variant_memory.items()):
        mem = entry.get("memory") if isinstance(entry, dict) else None
        row = {"variant": name, "peak_bytes": None,
               "headroom_bytes": None, "fits": None}
        if mem:
            row["peak_bytes"] = int(mem["peak_bytes"])
            if budget is not None:
                row["headroom_bytes"] = int(budget - mem["peak_bytes"])
                row["fits"] = row["headroom_bytes"] >= 0
        rows.append(row)

    def _key(r):
        if r["peak_bytes"] is None:
            return (1, 0.0)  # unknowns last
        if r["headroom_bytes"] is None:
            return (0, float(r["peak_bytes"]))  # no budget: smallest first
        return (0, -float(r["headroom_bytes"]))  # most headroom first

    rows.sort(key=_key)
    return rows


# -- the baseline workflow ----------------------------------------------------

def check_memory_baseline(current: Dict[str, dict], baseline: dict,
                          tolerance: Optional[float] = None) -> dict:
    """Compare a :func:`variant_report` sweep with the committed baseline
    (``analysis/memory_baseline.json``).  Fails only on NEW regressions:
    a variant whose priced ``peak_bytes`` grew beyond ``(1 + tolerance)
    x`` its committed value, or a variant the baseline does not cover.
    Shrinkage and stale entries are notes.  Returns ``{"failures",
    "notes", "checked", "tolerance"}``."""
    doc = baseline.get("variants", {})
    tol = (tolerance if tolerance is not None
           else float(baseline.get("tolerance", DEFAULT_TOLERANCE)))
    failures, notes = [], []
    checked = 0
    for name, entry in sorted(current.items()):
        mem = entry.get("memory")
        if not mem:
            notes.append(f"{name}: memory unavailable here (the step cannot "
                         "run on fake tensors) — not checked")
            continue
        base = doc.get(name)
        if base is None:
            failures.append(
                f"{name}: not covered by the baseline — run python -m "
                "fluxdistributed_tpu_torch.fit --collect OUT "
                "--update-baseline so every registered variant stays "
                "checked")
            continue
        checked += 1
        peak = int(mem["peak_bytes"])
        ref = int(base.get("peak_bytes", 0))
        if ref and peak > ref * (1.0 + tol):
            failures.append(
                f"{name}: peak_bytes {peak} regressed beyond "
                f"{ref} x (1 + {tol}) — a real memory regression, or "
                "an intentional change needing --update-baseline")
        elif ref and peak < ref / (1.0 + tol):
            notes.append(f"{name}: peak_bytes {peak} shrank well below "
                         f"baseline {ref} — consider re-recording")
    for name in sorted(set(doc) - set(current)):
        notes.append(f"stale baseline entry {name!r} — variant no "
                     "longer registered; shrink the baseline")
    return {"failures": failures, "notes": notes, "checked": checked,
            "tolerance": tol}


def build_baseline(current: Dict[str, dict],
                   tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """The committed-baseline document of a sweep (entries without a
    price are dropped: they cannot regress)."""
    variants = {}
    for name, entry in sorted(current.items()):
        mem = entry.get("memory")
        if mem:
            variants[name] = {
                k: int(mem[k]) for k in (
                    "peak_bytes", "argument_bytes", "output_bytes",
                    "temp_bytes", "alias_bytes")}
    return {"schema": BASELINE_SCHEMA, "tolerance": tolerance,
            "variants": variants}


# -- the pipeline planner's estimate against the priced step ------------------

#: the band of :func:`pp_plan_memory_check` (the JAX value): a plan's
#: ``stage_bytes`` model the working set a stage holds live (its params
#: and the min(S, M)-slot activation ring), a lower bound of the step's
#: peak, which also holds gradients, optimizer moments, temporaries and
#: the batch; the priced peak must lie between the modeled peak stage and
#: ``PP_MEMORY_FACTOR x`` the modeled total
PP_MEMORY_FACTOR = 8.0


def pp_plan_memory_check(plan, fn, args: Tuple[Any, ...],
                         factor: float = PP_MEMORY_FACTOR) -> dict:
    """Hold a :class:`..parallel.pp_plan.PipelinePlan`'s per-stage memory
    estimate to the priced peak of the step it drives (``fn(*args)`` on
    fake tensors: rank 0's, the first stage's).  ``within`` is False
    outside the band or without an estimate, None (``measured`` None)
    when the step cannot be priced."""
    measured = step_memory(fn, args)
    modeled = [float(b) for b in getattr(plan, "stage_bytes", ()) or ()]
    report: dict = {
        "modeled_stage_bytes": modeled,
        "modeled_peak_stage": max(modeled) if modeled else 0.0,
        "modeled_total": sum(modeled),
        "factor": factor,
        "measured": measured,
        "within": None,
    }
    if measured is None or not modeled:
        return report
    peak = float(measured["peak_bytes"])
    report["within"] = (
        report["modeled_peak_stage"] <= peak
        <= factor * report["modeled_total"])
    return report
