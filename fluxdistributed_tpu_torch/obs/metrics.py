"""Process-wide metrics registry: Counter / Gauge / Histogram with labels.

(A copy of the JAX package's stdlib-only ``obs/metrics.py``.)

The single instrumentation substrate for the repo (ROADMAP: production
serving + training need ONE answer to "what is this process doing").
Before this layer existed the repo had four disconnected fragments — a
``Logger`` protocol, a hand-rolled Prometheus string in the LM server,
a fixed-window profiler capture, and an offline trace analyzer.  Every
subsystem now registers its counters here and two exporters read them:

* :meth:`Registry.prometheus_text` — Prometheus text exposition (the
  ``/metrics`` endpoint of both the LM server and the training driver);
* :meth:`Registry.snapshot` / :class:`JsonlSink` — flat JSON snapshots
  appended to a ``.jsonl`` file for offline diffing between runs.

Design points:

* **get-or-create registration** — ``registry.counter(name, ...)``
  returns the existing metric when called twice with a consistent
  signature (train() may run many times per process; re-registration
  must not raise) and raises on kind/label conflicts (two subsystems
  silently sharing one name would corrupt both).
* **thread-safe** — the loader's prefetch workers, the serve loop
  thread, HTTP handler threads and the watchdog all write concurrently;
  each metric guards its cells with one lock (bounded, uncontended).
* **callback gauges** — ``Gauge.set_function`` renders a value computed
  at scrape time (queue depth, compile-cache size) so hot paths never
  pay for bookkeeping the scraper can derive.
* **naming** — every metric is ``fdtpu_<subsystem>_<what>_<unit>``
  snake_case; the serve parity tests pin the exposition byte-for-byte
  and fdtpu-lint's FDT106 rule enforces the prefix statically at every
  registration site (docs/analysis.md).
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "Registry",
    "bucket_percentile",
    "get_registry",
]

# Prometheus-conventional timing buckets, stretched to cover both a
# sub-millisecond decode step and a minutes-long XLA compile.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def bucket_percentile(bounds: Sequence[float], counts: Sequence[int],
                      q: float) -> float:
    """Percentile ``q`` (0-100) estimated from histogram buckets — the
    ONE percentile implementation every consumer shares (decode_bench,
    the serve rollup gauges, the profile artifact) instead of each
    rolling its own off-by-one bucket walk.

    ``bounds`` are the finite upper bucket bounds (ascending);
    ``counts`` are PER-BUCKET (non-cumulative) counts with one extra
    trailing entry for the +Inf bucket, i.e. ``len(counts) ==
    len(bounds) + 1`` — exactly a :class:`_HistogramCell`'s layout.
    Linear interpolation inside the target bucket (lower edge 0 for the
    first); a percentile landing in the +Inf bucket returns the largest
    finite bound (the honest Prometheus ``histogram_quantile``
    convention — the data says "bigger than everything we bin").
    Returns NaN when the histogram is empty.
    """
    if not 0 <= q <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {q}")
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"counts must have one entry per bound plus +Inf "
            f"({len(bounds) + 1}), got {len(counts)}")
    total = sum(counts)
    if total == 0:
        return math.nan
    rank = q / 100.0 * total
    cum = 0.0
    for i, b in enumerate(bounds):
        prev_cum = cum
        cum += counts[i]
        if cum >= rank:
            lo = bounds[i - 1] if i else 0.0
            frac = (rank - prev_cum) / counts[i] if counts[i] else 0.0
            return lo + frac * (b - lo)
    return float(bounds[-1])  # landed in the +Inf bucket


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition format spec: backslash,
    double-quote, and newline must be escaped inside ``name{k="v"}``."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus value rendering — integers stay integral, floats keep
    enough digits to round-trip, +Inf spelled the Prometheus way."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    """Shared label plumbing: a metric owns one cell per label-value
    tuple; the unlabeled metric is the single ``()`` cell."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # eager default cell: an unlabeled metric exposes its zero
            # from registration on (absence reads as "not instrumented")
            self._cell(())

    def _new_cell(self):
        raise NotImplementedError

    def _cell(self, labelvalues: Tuple[str, ...]):
        with self._lock:
            cell = self._cells.get(labelvalues)
            if cell is None:
                cell = self._cells[labelvalues] = self._new_cell()
            return cell

    def labels(self, *values, **kv):
        """The child metric for one label-value combination (creates it
        on first use, like prometheus_client)."""
        if values and kv:
            raise ValueError("pass label values positionally OR by name")
        if kv:
            missing = set(self.labelnames) - set(kv)
            extra = set(kv) - set(self.labelnames)
            if missing or extra:
                raise ValueError(
                    f"{self.name} has labels {self.labelnames}; "
                    f"got {sorted(kv)}"
                )
            values = tuple(kv[k] for k in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} needs {len(self.labelnames)} label values "
                f"{self.labelnames}, got {len(values)}"
            )
        if not self.labelnames:
            raise ValueError(f"{self.name} has no labels")
        return self._cell(tuple(str(v) for v in values))

    def _default_cell(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames} — "
                "call .labels(...) first"
            )
        return self._cell(())

    # -- exposition ----------------------------------------------------
    def _series(self):
        """Yield ``(labelvalues, cell)`` snapshot-safely."""
        with self._lock:
            items = list(self._cells.items())
        return items

    def _label_str(self, labelvalues: Tuple[str, ...]) -> str:
        if not labelvalues:
            return ""
        pairs = ",".join(
            f'{k}="{_escape_label(v)}"'
            for k, v in zip(self.labelnames, labelvalues)
        )
        return "{" + pairs + "}"


class _CounterCell:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counters are monotonic; cannot inc by {amount} "
                "(use a Gauge for values that go down)"
            )
        with self._lock:
            self.value += amount


class Counter(_Metric):
    """Monotonically increasing count (requests, steps, compile-seconds)."""

    kind = "counter"

    def _new_cell(self):
        return _CounterCell()

    def inc(self, amount: float = 1.0) -> None:
        self._default_cell().inc(amount)

    def value(self, *labelvalues) -> float:
        cell = self.labels(*labelvalues) if labelvalues else self._default_cell()
        return cell.value

    def expose(self) -> list:
        return [
            (self.name + self._label_str(lv), cell.value)
            for lv, cell in self._series()
        ]

    def sample(self) -> dict:
        return {
            self.name + self._label_str(lv): cell.value
            for lv, cell in self._series()
        }


class _GaugeCell:
    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a dead callback must not
                return math.nan  # kill the scrape; NaN flags it honestly
        return self._value


class Gauge(_Metric):
    """Point-in-time value (queue depth, active slots, last TTFT)."""

    kind = "gauge"

    def _new_cell(self):
        return _GaugeCell()

    def set(self, v: float) -> None:
        self._default_cell().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._default_cell().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_cell().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Compute the value at scrape time (zero hot-path cost)."""
        self._default_cell().set_function(fn)

    def value(self, *labelvalues) -> float:
        cell = self.labels(*labelvalues) if labelvalues else self._default_cell()
        return cell.value

    def expose(self) -> list:
        return [
            (self.name + self._label_str(lv), cell.value)
            for lv, cell in self._series()
        ]

    def sample(self) -> dict:
        return {
            self.name + self._label_str(lv): cell.value
            for lv, cell in self._series()
        }


class _HistogramCell:
    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1


class Histogram(_Metric):
    """Cumulative-bucket distribution (step-phase seconds, TTFT)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b  # before super(): the eager default cell reads it
        super().__init__(name, help, labelnames)

    def _new_cell(self):
        return _HistogramCell(self.buckets)

    def observe(self, v: float) -> None:
        self._default_cell().observe(v)

    def time(self):
        """``with hist.time():`` — observe the block's wall seconds."""
        return _HistogramTimer(self._default_cell())

    def cell_sum(self, *labelvalues) -> float:
        cell = self.labels(*labelvalues) if labelvalues else self._default_cell()
        return cell.sum

    def cell_count(self, *labelvalues) -> int:
        cell = self.labels(*labelvalues) if labelvalues else self._default_cell()
        return cell.count

    def percentile(self, q: float, *labelvalues) -> float:
        """Estimated percentile ``q`` (0-100) of one cell via
        :func:`bucket_percentile`; NaN while the cell is empty."""
        cell = self.labels(*labelvalues) if labelvalues else self._default_cell()
        with cell._lock:
            counts = list(cell.counts)
        return bucket_percentile(self.buckets, counts, q)

    def series(self) -> dict:
        """Snapshot every cell as ``{label_tuple: {"sum", "count",
        "bounds", "counts"}}`` (counts per-bucket incl. the trailing
        +Inf entry) — the raw material the profile artifact persists so
        offline consumers can recompute any percentile."""
        out = {}
        for lv, cell in self._series():
            with cell._lock:
                out[lv] = {
                    "sum": cell.sum,
                    "count": cell.count,
                    "bounds": list(self.buckets),
                    "counts": list(cell.counts),
                }
        return out

    def expose(self) -> list:
        out = []
        for lv, cell in self._series():
            with cell._lock:
                counts = list(cell.counts)
                csum, ccount = cell.sum, cell.count
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                le = (f'le="{_fmt(bound)}"',)
                pairs = ",".join(
                    (*(f'{k}="{_escape_label(v)}"'
                       for k, v in zip(self.labelnames, lv)), *le)
                )
                out.append((f"{self.name}_bucket{{{pairs}}}", cum))
            pairs = ",".join(
                (*(f'{k}="{_escape_label(v)}"'
                   for k, v in zip(self.labelnames, lv)), 'le="+Inf"')
            )
            out.append((f"{self.name}_bucket{{{pairs}}}", cum + counts[-1]))
            out.append((self.name + "_sum" + self._label_str(lv), csum))
            out.append((self.name + "_count" + self._label_str(lv), ccount))
        return out

    def sample(self) -> dict:
        out = {}
        for lv, cell in self._series():
            base = self.name + self._label_str(lv)
            with cell._lock:
                out[base + "_sum"] = cell.sum
                out[base + "_count"] = cell.count
        return out


class _HistogramTimer:
    __slots__ = ("_cell", "_t0")

    def __init__(self, cell: _HistogramCell):
        self._cell = cell

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._cell.observe(time.perf_counter() - self._t0)
        return False


class Registry:
    """Named collection of metrics with get-or-create registration and
    the two exporters (Prometheus text, JSON snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- registration --------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or tuple(
                    existing.labelnames
                ) != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}; "
                        f"requested {cls.__name__}{tuple(labelnames)}"
                    )
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(),
        buckets=DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    # -- exporters -----------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (``text/plain; version=0.0.4``)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for m in metrics:
            series = m.expose()
            if not series:
                continue  # labeled metric with no cells yet
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, value in series:
                lines.append(f"{key} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat ``{series: value}`` dict (histograms as _sum/_count) —
        the JSONL sink's payload, also handy in tests."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in metrics:
            out.update(m.sample())
        return out

    def value(self, name: str, *labelvalues, default: float = 0.0) -> float:
        """Read one series (0/default when absent) — the test/consumer
        shortcut that avoids parsing exposition text."""
        m = self.get(name)
        if m is None:
            return default
        try:
            return m.value(*labelvalues)  # type: ignore[attr-defined]
        except (ValueError, AttributeError, KeyError):
            return default


class JsonlSink:
    """Append registry snapshots to a ``.jsonl`` file, one JSON object
    per line — the offline-diff exporter (compare two runs with plain
    ``jq``; no Prometheus server needed)."""

    def __init__(self, path: str, registry: Optional[Registry] = None):
        self.path = path
        self.registry = registry or get_registry()
        self._lock = threading.Lock()

    def write(self, step: Optional[int] = None, **extra) -> dict:
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        rec.update(extra)
        # non-finite values (a dead callback gauge reads NaN) would emit
        # bare NaN tokens — INVALID JSON that breaks every strict reader
        # of the file; null keeps the record parseable and honest
        rec["metrics"] = {
            k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in self.registry.snapshot().items()
        }
        line = json.dumps(rec, default=str, allow_nan=False)
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
        return rec


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry — what the trainer, loader and
    driver endpoint share (the serve scheduler takes a private one by
    default so engine instances stay isolated)."""
    return _REGISTRY
