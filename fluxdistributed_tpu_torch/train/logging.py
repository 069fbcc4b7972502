"""Metric logging for the trainer.

Port of ``fluxdistributed_tpu/train/logging.py``: ``@info``-style
``key=value`` console records (the reference logs through Julia's
``Logging`` stdlib), a null logger, the Weights & Biases sink (its
``wandb`` imported only when one is built), and the current logger of a
context (:func:`current_logger`, :func:`with_logger`), through which
the guard and model selection log.  Any object with ``log(metrics,
step)`` and ``info(msg)`` can stand in for them.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import time
from typing import Any, Mapping, Protocol

__all__ = ["ConsoleLogger", "Logger", "NullLogger", "WandbLogger",
           "current_logger", "with_logger"]


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


class WandbLogger:
    """Weights & Biases sink.  ``wandb`` is imported when the logger is
    built, so its absence raises ``ImportError`` there and nowhere else.
    ``config`` (the run configuration) goes to ``wandb.init`` as the
    reference's ``WandbLogger(...; config=...)`` passes it;
    :meth:`log_config` merges more later."""

    def __init__(self, config: Mapping[str, Any] | None = None,
                 **init_kwargs):
        import wandb

        self._wandb = wandb
        if config is not None:
            init_kwargs.setdefault("config", dict(config))
        self.run = wandb.init(**init_kwargs)

    def log_config(self, config: Mapping[str, Any]) -> None:
        """Merge more run config after init (``wandb.config.update``)."""
        self.run.config.update(dict(config), allow_val_change=True)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        self._wandb.log(dict(metrics), step=step)

    def info(self, msg: str) -> None:
        print(msg)


_current: contextvars.ContextVar[Logger] = contextvars.ContextVar(
    "fluxdistributed_tpu_torch_logger", default=ConsoleLogger())


def current_logger() -> Logger:
    """The logger of this context (a :class:`ConsoleLogger` unless
    :func:`with_logger` set another)."""
    return _current.get()


@contextlib.contextmanager
def with_logger(logger: Logger):
    """Route the framework's logging through ``logger`` for the dynamic
    extent (the ``Logging.with_logger`` analog)."""
    token = _current.set(logger)
    try:
        yield logger
    finally:
        _current.reset(token)
