"""Prefetching data loader, for one device or one rank of a mesh.

Port of ``fluxdistributed_tpu/data/loader.py``: worker threads assemble
host batches ahead of the training loop and copy them to the device,
so the host-to-device transfer overlaps compute.  On a GPU each batch
is staged in pinned host memory and copied with ``non_blocking=True`` (a
copy from pageable memory would synchronise the stream).  Batch ``i`` is
drawn from ``np.random.default_rng((seed, 0, i))``, exactly as the JAX
loader draws it on process 0, so both packages see the same tokens for
the same seed, and a run that starts at item ``start`` sees the same
batches from there on.  With a mesh every rank draws that same global
batch and keeps its own rows (:func:`..sharding.shard_batch`): what one
JAX process feeding an N-device mesh does, so N ranks see the JAX
N-device step's data.  With ``chunk=K`` each item stacks K consecutive
step batches on a new leading dim, the layout of the device loop
(``make_train_step(steps_per_call=K)``).  Queue depth and timings land
in the process registry under the JAX names (``fdtpu_data_*``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..mesh import Mesh

__all__ = ["PrefetchLoader", "apply_transform", "batch_to_dict"]


def _onehot(labels: np.ndarray, nclasses: int) -> np.ndarray:
    return (labels[..., None] == np.arange(nclasses)).astype(np.float32)


def batch_to_dict(out, nclasses=None, one_hot: bool = True) -> dict:
    """Normalise a ``dataset.batch()`` return to the batch dict: a
    ``(images, labels)`` tuple → ``{"image", "label"}`` (one-hot labels
    per ``one_hot``), a dict as it is, a bare array → ``{"tokens"}``."""
    if isinstance(out, tuple):
        imgs, labels = out
        y = np.asarray(labels)
        if one_hot:
            if nclasses is None:
                raise ValueError(
                    "one_hot labels need nclasses (dataset lacks .nclasses)")
            y = _onehot(y, nclasses)
        return {"image": np.asarray(imgs), "label": y}
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return {"tokens": np.asarray(out)}


def apply_transform(transform, out):
    """A host-side batch hook on a ``dataset.batch()`` return: a tuple
    draw unpacks into ``transform(images, labels)``, any other passes as
    one argument; ``None`` leaves the draw as it is.  The loader, the
    val slice and ``evaluate`` all go through here, so training and eval
    see one layout."""
    if transform is None:
        return out
    return transform(*out) if isinstance(out, tuple) else transform(out)


class PrefetchLoader:
    """Iterate device batches (dicts of tensors) with background
    prefetch.

    ``dataset.batch(rng, n)`` decides the layout (see
    :func:`batch_to_dict`).  ``cycles`` batches are produced; ``None``
    derives ``len(dataset) * epochs // batch_size``.  ``buffersize`` is
    the prefetch depth, ``num_threads`` the workers, ``start`` the first
    item (a resume cursor), ``transform`` a host-side hook on each draw
    (:func:`apply_transform`).  ``batch_size`` is the global batch; with a
    ``mesh`` each rank yields its ``batch_size / N`` rows of it, on the
    mesh's device.  ``device`` defaults to the mesh's, else ``cuda``
    (see :func:`..device.resolve_device`).  ``retries`` is how many
    times a failed assembly (an I/O hiccup, or a fault plan's
    ``"loader"`` site) is retried after a short backoff: a batch is a
    pure function of its index, so a retry is bit-identical.

    ``chunk=K`` is the device loop's layout: each item stacks K step
    batches on a new leading dim, ``[K, B, ...]`` (rows on dim 1), and
    sub-batch ``j`` of item ``c`` is batch ``c * K + j`` of an unchunked
    loader with the same seed, bit for bit.  ``cycles`` still counts
    step batches and must be a multiple of ``chunk`` (a derived count is
    rounded down to one); ``len()`` and ``start`` count items.  On a
    card each stacked array goes to the device in one pinned,
    asynchronous copy.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        cycles: Optional[int] = None,
        epochs: int = 1,
        buffersize: int = 5,
        seed: int = 0,
        num_threads: int = 2,
        start: int = 0,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
        transform: Optional[Callable] = None,
        chunk: int = 1,
        retries: int = 2,
    ):
        from ..obs import get_registry

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if start < 0:
            raise ValueError(f"start must be >= 0, got {start}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk
        self.dataset = dataset
        self.batch_size = batch_size
        self.buffersize = max(1, buffersize)
        self.seed = seed
        self.num_threads = max(1, num_threads)
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{mesh.size} ranks")
        self.start = start
        self.retries = max(0, retries)
        self.mesh = mesh
        self.transform = transform
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        reg = get_registry()
        # a span tracer (set by train() when spans are on) puts each h2d
        # copy on the worker threads' own rows of the trace
        self.tracer = None
        self._m_depth = reg.gauge(
            "fdtpu_data_prefetch_depth",
            "device-ready batches waiting in the prefetch queue "
            "(0 at read time = the train loop is data-bound)")
        self._m_h2d = reg.histogram(
            "fdtpu_data_h2d_seconds",
            "seconds per batch for host->device transfer (issued inside a "
            "prefetch worker, overlapped with compute)")
        self._m_assemble = reg.histogram(
            "fdtpu_data_assemble_seconds",
            "seconds per batch for host-side assembly (sampling, "
            "decode, one-hot, transform)")
        self._m_batches = reg.counter(
            "fdtpu_data_batches_total", "batches produced by the loader")
        if cycles is None:
            if not hasattr(dataset, "__len__"):
                raise ValueError(
                    f"{type(dataset).__name__} has no __len__ (an unbounded "
                    "stream, e.g. a generated token dataset) — pass cycles= "
                    "explicitly instead of deriving it from epochs")
            cycles = max(1, (len(dataset) * epochs) // batch_size)
            # a derived count: round down to whole items (a caller never
            # chose this exact number)
            cycles = max(chunk, cycles // chunk * chunk)
        if cycles % chunk:
            raise ValueError(
                f"cycles ({cycles}) must be a multiple of chunk ({chunk})")
        self.cycles = cycles

    def _batch(self, i: int) -> dict:
        """Host-side assembly of step batch ``i``: a pure function of
        (seed, process 0, index), whichever worker assembles it; with a
        mesh, this rank's rows of it."""
        from .. import faults

        faults.fire("loader", index=i)
        rng = np.random.default_rng((self.seed, 0, i))
        out = batch_to_dict(
            apply_transform(self.transform,
                            self.dataset.batch(rng, self.batch_size)),
            getattr(self.dataset, "nclasses", None))
        if self.mesh is not None:
            from ..sharding import shard_batch

            out = shard_batch(out, self.mesh, axis=self.mesh.axis_names)
        return out

    def _assemble(self, c: int) -> dict:
        """Item ``c``: one step batch, or ``chunk`` consecutive ones
        stacked on a new leading dim."""
        if self.chunk == 1:
            return self._batch(c)
        subs = [self._batch(c * self.chunk + j) for j in range(self.chunk)]
        return {k: np.stack([d[k] for d in subs]) for k in subs[0]}

    def _put(self, host: dict) -> dict:
        """Host arrays → device tensors: pinned staging and an
        asynchronous copy on a GPU."""
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def __len__(self) -> int:
        """Items yielded (step batches / ``chunk``)."""
        return self.cycles // self.chunk

    def __iter__(self) -> Iterator[dict]:
        from .. import faults

        if self.start > len(self):
            raise ValueError(
                f"start item {self.start} is past the end of the run "
                f"({len(self)} items) — a stale RESUME manifest?")
        q: queue.Queue = queue.Queue(maxsize=self.buffersize)
        counter = iter(range(self.start, len(self)))
        lock = threading.Lock()
        stop = threading.Event()
        # backpressure: workers run at most buffersize items ahead
        ahead = threading.Semaphore(self.buffersize)

        def worker():
            while not stop.is_set():
                if not ahead.acquire(timeout=0.5):
                    continue
                with lock:
                    i = next(counter, None)
                if i is None:
                    ahead.release()
                    break
                try:
                    t0 = time.perf_counter()
                    host = faults.with_retries(
                        lambda: self._assemble(i), tries=self.retries + 1,
                        backoff=0.05, site="loader")
                    t1 = time.perf_counter()
                    self._m_assemble.observe(t1 - t0)
                    tracer = self.tracer
                    if tracer is not None:
                        with tracer.span("h2d", batch=i):
                            dev = self._put(host)
                    else:
                        dev = self._put(host)
                    self._m_h2d.observe(time.perf_counter() - t1)
                    self._m_batches.inc()
                    item = (i, dev, None)
                except Exception as e:  # noqa: BLE001 — surfaced to the consumer
                    item = (i, None, e)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if item[2] is not None:
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        # deliver in index order (workers may finish out of order)
        pending: dict = {}
        next_idx = self.start
        try:
            while next_idx < len(self):
                while next_idx not in pending:
                    i, batch, err = q.get()
                    if err is not None:
                        raise RuntimeError(
                            "prefetch worker failed while assembling a "
                            "batch") from err
                    pending[i] = batch
                self._m_depth.set(q.qsize() + len(pending) - 1)
                yield pending.pop(next_idx)
                next_idx += 1
                ahead.release()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
