"""Metric logging for the trainer.

Port of ``fluxdistributed_tpu/train/logging.py``'s console and null
loggers: ``@info``-style ``key=value`` records (the reference logs
through Julia's ``Logging`` stdlib).  Any object with ``log(metrics,
step)`` and ``info(msg)`` can stand in for them.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Mapping, Protocol

__all__ = ["ConsoleLogger", "Logger", "NullLogger"]


class Logger(Protocol):
    def log(self, metrics: Mapping[str, Any], step: int) -> None: ...

    def info(self, msg: str) -> None: ...


def _fmt_value(v: Any) -> str:
    """One key=value cell on one line, whatever the value is; never
    raises (a logger that can crash the train loop is worse than none)."""
    if isinstance(v, float):
        return f"{v:.4f}"
    if isinstance(v, (bool, int, str)) or v is None:
        return str(v)
    if isinstance(v, Mapping):
        return "{" + ",".join(
            f"{k}:{_fmt_value(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt_value(x) for x in v) + "]"
    try:
        return f"{float(v):.4f}"  # numpy / torch scalars and 0-d tensors
    except (TypeError, ValueError, RuntimeError):
        pass
    try:
        return " ".join(str(v).split())  # collapse multi-line reprs
    except Exception:  # noqa: BLE001 — even a broken __str__ must not
        return f"<unprintable {type(v).__name__}>"  # kill the loop


class ConsoleLogger:
    """``@info``-style key=value console records with wall-clock stamps."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout
        self._t0 = time.time()

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        kv = " ".join(f"{k}={_fmt_value(v)}" for k, v in metrics.items())
        print(f"[info] t={time.time() - self._t0:8.1f}s step={step} {kv}",
              file=self.stream, flush=True)

    def info(self, msg: str) -> None:
        print(msg, file=self.stream, flush=True)


class NullLogger:
    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        pass

    def info(self, msg: str) -> None:
        pass
