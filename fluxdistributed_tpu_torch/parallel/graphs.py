"""Captured steps: the port's counterpart of ``jit`` and ``lax.scan``.

The JAX package dispatches each step as one compiled program, and
``make_train_step(steps_per_call=K)`` scans K optimizer steps over K
stacked batches in one dispatch (``fluxdistributed_tpu/parallel/dp.py``).
Eager PyTorch launches every op from Python, and on a GPU the host's
launches set the pace of most of the port's steps.  Here a step is
captured into a CUDA graph once and replayed: one launch from the host
for every kernel of the K steps.

* :class:`StepTable` holds what a step takes from the host at each call
  — the dropout seeds and the optimizer's scalars — in device memory,
  where a replay reads this call's values (a capture would freeze the
  values it saw);
* :class:`Graph` captures a function and replays it: a capture that
  fails raises naming the op, and the kernel wrappers' launch counts
  stay exact under replay;
* :class:`DeviceLoop` is a train step at K optimizer steps a call: on
  the CPU a plain loop of K steps (the JAX scan's semantics; no graph
  exists there), on a card one replay of the K steps, the state donated
  to it as the JAX step donates its state.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fake import is_fake, real
from ..obs import jaxmon
from ..ops import counts
from ..tree import leaves, tree_map

__all__ = ["DeviceLoop", "Graph", "StepTable", "state_donated"]


def state_donated(state) -> bool:
    """True when ``state`` was given to a donating graph replay: its
    tensors may be the graph's own, which the next replay overwrites, so
    it cannot be recovered after a failed or discarded step."""
    return bool(getattr(state, "donated", False))


class StepTable:
    """The host values of ``k`` steps in memory on ``device``: ``seeds``
    [k, n_seeds] int64 (a step's dropout seeds, one a microbatch) and
    ``scalars`` [k, n_scalars] float32 (the optimizer's
    :attr:`~..optim.Optimizer.scalars`), two views of one buffer.

    :meth:`fill` writes the rows into one persistent staging buffer
    (pinned memory, for a card) and copies it to the device with one
    asynchronous copy on the current stream.  Before it writes the
    staging buffer again it waits for the previous copy to have run, so
    the host can never overwrite values a queued copy has still to
    read."""

    def __init__(self, k: int, n_seeds: int, n_scalars: int,
                 device: torch.device):
        self.n_seeds, self.n_scalars = n_seeds, n_scalars
        sb = 8 * n_seeds
        row = -(-(sb + 4 * max(n_scalars, 1)) // 8) * 8
        self.buffer = torch.zeros((k, row), dtype=torch.uint8, device=device)
        self.seeds = self.buffer[:, :sb].view(torch.int64)
        self.scalars = self.buffer[:, sb:sb + 4 * n_scalars].view(
            torch.float32)
        # a fake table (a priced step, ..fake) keeps its host values in
        # a real buffer of its own and copies nothing
        self._fake = is_fake(self.buffer)
        if self._fake:
            with real():
                self._staging = torch.zeros((k, row), dtype=torch.uint8)
                self._host = self._staging.numpy()
        else:
            self._staging = (
                torch.zeros((k, row), dtype=torch.uint8).pin_memory()
                if device.type == "cuda" else self.buffer)
            self._host = self._staging.numpy()
        self._copied = None

    def fill(self, rows: Sequence[Tuple[Sequence[int], Sequence]]) -> None:
        """Write ``rows``, one ``(seeds, scalars)`` pair a step from row
        0, and copy the table to the device.  A scalar is a Python float
        or a 0-d float32 tensor, rounded to float32 once."""
        if self._copied is not None:
            self._copied.synchronize()
        for j, (seeds, scalars) in enumerate(rows):
            if len(seeds) != self.n_seeds or len(scalars) != self.n_scalars:
                raise ValueError(
                    f"a table row takes {self.n_seeds} seeds and "
                    f"{self.n_scalars} scalars, got {len(seeds)} and "
                    f"{len(scalars)}")
            data = (np.asarray(seeds, np.int64).tobytes()
                    + np.asarray([float(x) for x in scalars],
                                 np.float32).tobytes())
            self._host[j, :len(data)] = np.frombuffer(data, np.uint8)
        if self._staging is not self.buffer and not self._fake:
            self.buffer.copy_(self._staging, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()


def _op_of(err: BaseException) -> str:
    """The innermost frame of ``err`` outside PyTorch and this module:
    the line of the op a capture refused."""
    skip = (os.path.dirname(torch.__file__), os.path.abspath(__file__))
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not os.path.abspath(f.filename).startswith(skip)]
    if not frames:
        return "an op of the captured function"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class Graph:
    """``fn()`` captured into a CUDA graph on a side stream.

    The capture runs ``fn`` once without executing it: its outputs
    (``out``) are static, and :meth:`replay` runs its kernels again on
    the current stream and returns them, overwritten by the next
    replay.  The caller runs ``fn`` eagerly once before (the warm-up
    the capture needs: libraries set up their handles and workspaces,
    kernel modules load).  The capture is thread-local, so the loader's
    threads keep staging batches meanwhile.  A capture that fails
    raises ``RuntimeError`` naming the op; nothing falls back to eager.
    The allocator's cached blocks are released before the capture,
    whose private pool could not reuse them.  What the capture launched
    onto its stream through a kernel wrapper is not counted
    (:func:`..ops.counts.capturing`) and is added to its count at each
    replay, so the counts stay those of the kernels that ran, whatever
    other threads launch meanwhile.  Each capture is a compile of
    :mod:`..obs.jaxmon` (its wall seconds, named by ``what``)."""

    def __init__(self, fn: Callable[[], Any], what: str):
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        torch.cuda.synchronize()
        # the capture allocates from the graph's own pool, which cannot
        # take the blocks the eager warm-up left cached: hand them back
        # (a ConvNeXt-XL step at batch 128 otherwise runs out with 40 GB
        # cached and free)
        torch.cuda.empty_cache()
        err = out = None
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), counts.capturing(stream) as captured:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — re-raised below
                err = e
            try:
                self.graph.capture_end()
            except RuntimeError as e:
                err = err or e
        torch.cuda.current_stream().wait_stream(stream)
        if err is not None:
            raise RuntimeError(f"CUDA graph capture of {what} failed at "
                               f"{_op_of(err)}: {err}") from err
        self.out = out
        self._counts = [(c, d) for c, d in captured.items() if d]
        jaxmon.record("capture", time.perf_counter() - t0, what=what)

    @property
    def launches_per_replay(self) -> Dict[str, int]:
        """Launches of each kernel wrapper one replay makes."""
        return {c.__name__: d for c, d in self._counts}

    def replay(self):
        self.graph.replay()
        for c, d in self._counts:
            counts.count(c, d)
        return self.out


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i] <- src[i]`` where they are not the same memory."""
    if len(dst) != len(src):
        raise ValueError(f"the state has {len(src)} tensors, the captured "
                         f"step {len(dst)}")
    pairs = [(d, s) for d, s in zip(dst, src) if d.data_ptr() != s.data_ptr()]
    for d, s in pairs:
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a state tensor {tuple(s.shape)} {s.dtype} "
                             f"does not match the captured step's "
                             f"{tuple(d.shape)} {d.dtype}")
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class DeviceLoop:
    """A train step at ``steps_per_call`` optimizer steps a call:
    ``loop(state, batch) -> (state, metrics)``.

    ``body(state, batch, seeds, scalars) -> (state, metrics)`` is one
    optimizer step of a :class:`~.dp.TrainState` on one batch, reading
    its step's dropout seeds and optimizer scalars from a row of the
    :class:`StepTable`, whose values ``host_row(step) -> (seeds,
    scalars)`` computes on the host.  Every call fills the table first
    (one copy), so an eager step and a replayed one run the same body on
    the same values.

    At K = 1 the call is one eager step.  At K > 1 each leaf of
    ``batch`` stacks K per-step batches on a new leading dim ``[K, ...]``
    (the loader's ``chunk=K`` layout), the K steps run one after the
    other on them, and each metric comes back stacked ``[K, ...]``:

    * on the CPU, as a plain loop of the K steps;
    * on a card, as a CUDA graph of the K steps, captured once per batch
      layout (shapes and dtypes): the first call with a layout runs the
      K steps eagerly (the capture's warm-up) and then captures them on
      copies of its result; later calls replay.  The graph **donates**
      the state: it writes the new params, optimizer and model state
      into the tensors it read, and the state it returns holds those
      tensors, overwritten by the next call.  A state whose tensors are
      not the graph's (the first call's result, or a state loaded from
      elsewhere) is copied in once.  Metrics come back as fresh tensors.
      A capture that fails raises; nothing falls back to eager steps.

    ``keep_state=True`` keeps the state a replay is given, as a step
    that does not donate: when that state holds the graph's own tensors,
    they are copied into a shadow set (one more copy of the state in
    memory) before the replay, and the given state is re-pointed at the
    shadow, so it still holds the pre-step values after the call (until
    the next call).  The anomaly guard discards a step's result and
    carries on from that state.  Without it, a replayed state is marked
    donated (:func:`state_donated`).
    """

    def __init__(self, body: Callable, host_row: Callable, *,
                 steps_per_call: int, n_seeds: int, n_scalars: int,
                 keep_state: bool = False):
        self.body, self.host_row = body, host_row
        self.k = steps_per_call
        self.n_seeds, self.n_scalars = n_seeds, n_scalars
        self.keep_state = keep_state
        self.table = None
        self._graphs: Dict[tuple, tuple] = {}

    @property
    def graphs(self) -> List[Graph]:
        """The captured graphs, one a batch layout."""
        return [g for g, _, _, _ in self._graphs.values()]

    def _table(self, device: torch.device) -> StepTable:
        if self.table is None:
            self.table = StepTable(self.k, self.n_seeds, self.n_scalars,
                                   device)
        elif self.table.buffer.device != device:
            raise ValueError(f"this step runs on {self.table.buffer.device}, "
                             f"got a batch on {device}")
        return self.table

    def _rows(self, step: int) -> list:
        return [self.host_row(step + j) for j in range(self.k)]

    def __call__(self, state, batch: dict):
        return self.run(state, batch)

    def run(self, state, batch: dict, *, fill: bool = True):
        """One call.  ``fill=False`` replays a captured graph on the table
        as it stands, without this call's values: a control that shows
        the graph reads the table (a card, K > 1, after the capture)."""
        dev = next(iter(batch.values())).device
        table = self._table(dev)
        if self.k == 1:
            table.fill(self._rows(state.step))
            return self.body(state, batch, table.seeds[0], table.scalars[0])
        for k, v in batch.items():
            if v.ndim < 1 or v.shape[0] != self.k:
                raise ValueError(
                    f"steps_per_call={self.k} takes batches stacked on a "
                    f"leading dim of {self.k} (the loader's chunk="
                    f"{self.k}); batch[{k!r}] has shape {tuple(v.shape)}")
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        cap = self._graphs.get(key)
        if cap is None or dev.type != "cuda":
            table.fill(self._rows(state.step))
            state, metrics = self._steps(state, batch, table)
            if dev.type == "cuda":
                self._graphs[key] = self._capture(state, batch, table)
            return state, metrics
        graph, static, static_batch, shadow = cap
        own, given = leaves(static), leaves(
            (state.params, state.opt_state, state.model_state))
        aliased = any(a.data_ptr() == b.data_ptr()
                      for a, b in zip(own, given))
        _copy_into(own, given)
        for k, v in batch.items():
            if v.data_ptr() != static_batch[k].data_ptr():
                static_batch[k].copy_(v)
        if fill:
            table.fill(self._rows(state.step))
        if not self.keep_state:
            state.donated = True
        elif aliased:
            self._keep(state, shadow, own)
        metrics = graph.replay()
        params, opt_state, mstate = tree_map(lambda x: x, static)
        return (type(state)(params=params, opt_state=opt_state,
                            model_state=mstate, step=state.step + self.k),
                {k: v.clone() for k, v in metrics.items()})

    def eager(self, state, batch: dict):
        """One call run eagerly, never captured or replayed: the K steps
        as a plain loop on new tensors (the given state is not written).
        What a debugging harness runs under
        ``torch.autograd.detect_anomaly``, which a capture refuses."""
        dev = next(iter(batch.values())).device
        table = self._table(dev)
        table.fill(self._rows(state.step))
        if self.k == 1:
            return self.body(state, batch, table.seeds[0], table.scalars[0])
        return self._steps(state, batch, table)

    @staticmethod
    def _keep(state, shadow, own: List[torch.Tensor]) -> None:
        """Copy the graph's own tensors ``own`` into ``shadow`` (one
        multi-tensor copy) and point ``state`` at the shadow."""
        torch._foreach_copy_(leaves(shadow), own)
        state.params, state.opt_state, state.model_state = tree_map(
            lambda x: x, shadow)

    def _steps(self, state, batch: dict, table: StepTable, static=None):
        """The K steps from ``state``, step ``j`` on sub-batch ``j`` and
        row ``j`` of the table; metrics stacked.  With ``static`` (the
        captured state's tensors) each step's new state is copied into
        them, and the next step reads them."""
        metrics = []
        for j in range(self.k):
            sub = {k: v[j] for k, v in batch.items()}
            new, m = self.body(state, sub, table.seeds[j], table.scalars[j])
            if static is not None:
                _copy_into(static, leaves(
                    (new.params, new.opt_state, new.model_state)))
                new = type(state)(params=state.params,
                                  opt_state=state.opt_state,
                                  model_state=state.model_state,
                                  step=new.step)
            state = new
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics])
                       for k in metrics[0]}

    def _capture(self, state, batch: dict, table: StepTable) -> tuple:
        """The graph of K steps over copies of ``state`` and ``batch``,
        which become the graph's own (static) tensors."""
        static = tree_map(lambda x: x.detach().clone(),
                          (state.params, state.opt_state, state.model_state))
        static_batch = {k: v.clone() for k, v in batch.items()}
        st = type(state)(params=static[0], opt_state=static[1],
                         model_state=static[2], step=state.step)
        targets = leaves(static)
        graph = Graph(lambda: self._steps(st, static_batch, table,
                                          static=targets)[1],
                      f"the train step ({self.k} steps)")
        shadow = (tree_map(torch.empty_like, static) if self.keep_state
                  else None)
        return graph, static, static_batch, shadow
