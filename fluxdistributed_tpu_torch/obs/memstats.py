"""Live device-memory telemetry: the live half of the JAX package's
``obs/memstats.py``.

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

Without a card (the CPU) the reads return ``None``: the per-device
gauges register no cells, ``fdtpu_hbm_available`` reads 0 and the
headroom gauge NaN, as the JAX module does on its CPU backend.  The
static half (``step_memory``, ``variant_report``, the baselines, the
pipeline planner's check) prices a compiled XLA program and has no
counterpart here yet.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

from .metrics import Registry, get_registry

__all__ = ["HbmGauges", "hbm_device_stats", "hbm_summary",
           "min_headroom_ratio", "state_bytes", "tree_bytes"]


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
