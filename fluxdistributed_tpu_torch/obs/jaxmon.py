"""Live compile counters and steady-state recompile flagging.

The port's counterpart of ``fluxdistributed_tpu/obs/jaxmon.py`` (the
file keeps its name so the two can be found side by side).  The JAX
module listens to ``jax.monitoring``'s events for XLA compiles and the
persistent compilation cache.  The port has no compiler on its path
but two events that cost what a compile costs, and reports each
through :func:`record`:

* a **build**: ``ops/_build.py`` compiling a ``csrc/*.cu`` with
  ``nvcc`` (a cache **miss** and a **compile**, with the compiler's
  wall seconds), or finding its library already built in the build
  cache (a cache **hit**, adding the seconds the build once took to
  the seconds saved);
* a **capture**: ``parallel/graphs.py``'s :class:`Graph` capturing a
  CUDA graph (the device loop's K steps, the serving engine's decode
  step): a **compile**, with the capture's wall seconds.

The series keep the JAX package's names, so the flight records,
``/healthz``, ``obs.runs`` and ``obs.profile`` read them as the JAX
package's do:

* ``fdtpu_jax_compiles_total`` / ``fdtpu_jax_compile_seconds_total`` —
  every ``nvcc`` run and every capture, count and wall seconds;
* ``fdtpu_jax_steady_recompiles_total`` — compiles after the caller
  declared steady state (:func:`mark_steady`); each also warns, naming
  what was built or captured.  The serving engine's "one decode
  capture" invariant is then a live metric;
* ``fdtpu_jax_cache_hits_total`` / ``fdtpu_jax_cache_misses_total`` /
  ``fdtpu_jax_cache_saved_seconds_total`` — the kernel build cache's
  hits, misses, and the ``nvcc`` seconds the hits skipped.  "No new
  compiles" is asserted as ``cache_misses == 0``.

Install is idempotent and process-global; the first registry passed
wins.  A record costs one lock and a few counter updates, i.e. nothing
at steady state (nothing builds or captures there).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Optional

from .metrics import Registry, get_registry

__all__ = [
    "install",
    "installed",
    "record",
    "mark_steady",
    "clear_steady",
    "steady_state",
    "compile_count",
    "compile_seconds",
    "cache_hits",
    "cache_misses",
    "compile_seconds_saved",
    "steady_recompiles",
]

#: the two kinds of event :func:`record` takes
KINDS = ("build", "capture")

_HELP = {
    "fdtpu_jax_compiles_total":
        "kernel builds (nvcc) and CUDA graph captures",
    "fdtpu_jax_compile_seconds_total":
        "wall seconds of kernel builds and CUDA graph captures",
    "fdtpu_jax_steady_recompiles_total":
        "compiles observed AFTER steady state was declared "
        "(any nonzero value means something is recompiling)",
    "fdtpu_jax_cache_hits_total":
        "kernel libraries found in the build cache (no nvcc run)",
    "fdtpu_jax_cache_misses_total":
        "kernel libraries the build cache could not serve (nvcc ran)",
    "fdtpu_jax_cache_saved_seconds_total":
        "nvcc wall seconds skipped by build-cache hits",
}

_lock = threading.Lock()
_installed = False
_steady = False
_registry: Optional[Registry] = None
_warn: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr)


def _counter(reg: Registry, name: str):
    return reg.counter(name, _HELP[name])


def install(registry: Optional[Registry] = None,
            warn: Optional[Callable[[str], None]] = None) -> None:
    """Bind the counters to a registry (idempotent; the first registry
    passed wins) and pre-register them at zero, so ``/metrics`` shows
    explicit zeros before the first event (absence would read as "not
    instrumented")."""
    global _installed, _registry, _warn
    with _lock:
        if registry is not None and _registry is None:
            _registry = registry
        if _registry is None:
            _registry = get_registry()
        if warn is not None:
            _warn = warn
        if _installed:
            return
        for name in _HELP:
            _counter(_registry, name)
        _installed = True


def installed() -> bool:
    return _installed


def record(kind: str, seconds: float, *, cached: bool = False,
           what: str = "") -> None:
    """Count one event.  ``kind="build"`` with ``cached=True`` is a build
    cache hit (``seconds``: what the build it reuses once took); with
    ``cached=False`` an ``nvcc`` run: a miss and a compile.
    ``kind="capture"`` is a CUDA graph capture: a compile.  ``what``
    names the library or the captured function in the steady-state
    warning."""
    if kind not in KINDS:
        raise ValueError(f"unknown compile event {kind!r} "
                         f"({'|'.join(KINDS)})")
    install()
    reg = _registry
    if kind == "build" and cached:
        _counter(reg, "fdtpu_jax_cache_hits_total").inc()
        _counter(reg, "fdtpu_jax_cache_saved_seconds_total").inc(
            max(float(seconds), 0.0))
        return
    if kind == "build":
        _counter(reg, "fdtpu_jax_cache_misses_total").inc()
    _counter(reg, "fdtpu_jax_compiles_total").inc()
    _counter(reg, "fdtpu_jax_compile_seconds_total").inc(
        max(float(seconds), 0.0))
    if _steady:
        _counter(reg, "fdtpu_jax_steady_recompiles_total").inc()
        verb = "nvcc build of" if kind == "build" else "CUDA graph capture of"
        _warn(f"obs.jaxmon: steady-state RECOMPILE ({seconds:.2f}s): "
              f"{verb} {what or 'an unnamed program'} after warmup — an "
              "input shape or dtype changed; check bucket sizes and batch "
              "shapes")


def mark_steady() -> None:
    """Declare warmup over: every compile from here on is a flagged
    (counted + warned) steady-state recompile."""
    global _steady
    install()
    _steady = True


def clear_steady() -> None:
    global _steady
    _steady = False


@contextlib.contextmanager
def steady_state():
    """``with jaxmon.steady_state():`` — flag recompiles inside the
    block (restores the previous flag on exit, so nesting composes)."""
    global _steady
    install()
    prev = _steady
    _steady = True
    try:
        yield
    finally:
        _steady = prev


def _value(name: str) -> float:
    return (_registry or get_registry()).value(name)


def compile_count() -> float:
    return _value("fdtpu_jax_compiles_total")


def compile_seconds() -> float:
    return _value("fdtpu_jax_compile_seconds_total")


def cache_hits() -> float:
    return _value("fdtpu_jax_cache_hits_total")


def cache_misses() -> float:
    return _value("fdtpu_jax_cache_misses_total")


def compile_seconds_saved() -> float:
    return _value("fdtpu_jax_cache_saved_seconds_total")


def steady_recompiles() -> float:
    return _value("fdtpu_jax_steady_recompiles_total")
