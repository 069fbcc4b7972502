"""Training orchestration: ``prepare_training`` + ``train``.

Port of the core of ``fluxdistributed_tpu/train/trainer.py`` for the
data-parallel modes ``spmd="jit"`` (alias ``"dp"``) and ``"shard_map"``,
with or without ZeRO-1, on one GPU, on the ranks of a process group
(:mod:`..mesh`), or on the CPU when asked:

* ``prepare_training`` takes the model's parameters and buffers (the
  BatchNorm running stats) as the initial
  :class:`..parallel.TrainState` (copied from rank 0 to every rank when
  there is a mesh), builds the train and eval steps the mode picks, the
  prefetching loader and the val slice;
* ``train`` is the loop: the print cadence logs steps/s and tokens/s
  (images/s), the eval cadence logs the eval loss and top-k accuracies
  of the val slice and of the current batch, and a device OOM skips the
  batch and counts it in ``num_missed`` (the step's update is pure, so
  the pre-step state carries on);
* ``steps_per_call=K`` is the JAX device loop: each loader item stacks
  K step batches and one call runs K optimizer steps (one CUDA graph
  replay on a card), the cadences ticking per item;
* ``evaluate`` aggregates the loss and top-k accuracies over a dataset.

Phase times, step counts and OOM skips land in the process registry
(:mod:`..obs.metrics`) under the JAX trainer's ``fdtpu_train_*`` names.
Checkpoints, the anomaly guard, preemption, profiling and the other
parallel modes come with later slices.  A
device OOM on one rank of a mesh, and not on the others, leaves the
others waiting in the step's next collective, as in the JAX package on
several hosts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.loader import PrefetchLoader, apply_transform, batch_to_dict
from ..device import DeviceLike, resolve_device
from ..mesh import Mesh
from ..obs import get_registry
from ..ops.losses import logitcrossentropy
from ..optim import Optimizer
from ..parallel.dp import (TrainState, make_eval_step, make_train_step,
                           make_train_step_shardmap, module_loss_fn)
from ..tree import to_host
from .logging import ConsoleLogger, Logger

__all__ = ["TrainTask", "evaluate", "prepare_training", "train"]


@dataclasses.dataclass
class TrainTask:
    """Everything ``train`` needs: the state, the compiled-step
    counterparts, the loader, and the run's bookkeeping."""

    state: TrainState
    step_fn: Callable
    eval_fn: Callable
    loader: Iterable
    optimizer: Optimizer
    model: Any
    device: torch.device
    # the ranks the step spans (None: one device, no process group)
    mesh: Optional[Mesh] = None
    num_missed: int = 0
    # loader items skipped by OOM fault tolerance, in order
    skipped_items: list = dataclasses.field(default_factory=list)
    # the loss of every step that ran, in order (floats)
    losses: list = dataclasses.field(default_factory=list)
    # the top-k accuracies the eval step computes
    topk: tuple = ()
    # the val slice on the step's device (this rank's rows), or None
    val_batch: Optional[dict] = None
    # the loader's host-side batch hook, also applied by ``evaluate``
    transform: Optional[Callable] = None
    # optimizer steps a call of ``step_fn`` (one loader item) runs
    steps_per_call: int = 1


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _same_device(p: torch.device, dev: torch.device) -> bool:
    """``cuda:0`` is on ``cuda``; an index counts only when given."""
    return p.type == dev.type and (dev.index is None or p.index == dev.index)


def prepare_training(
    model,
    dataset,
    optimizer: Optimizer,
    *,
    loss_fn: Optional[Callable] = None,
    loss: Callable = logitcrossentropy,
    batch_size: int = 32,
    epochs: int = 1,
    cycles: Optional[int] = None,
    buffersize: int = 5,
    seed: int = 0,
    spmd: str = "jit",
    zero1: bool = False,
    accum_steps: int = 1,
    mesh: Optional[Mesh] = None,
    device: DeviceLike = None,
    topk: Optional[Sequence[int]] = None,
    val_dataset=None,
    val_samples: int = 300,
    transform: Optional[Callable] = None,
    steps_per_call: int = 1,
) -> TrainTask:
    """The train state from the model's current parameters and buffers,
    the train and eval steps, the prefetching loader and the val slice.

    ``loss_fn`` has the framework signature (e.g.
    ``models.lm_loss_fn(model)``); without one, the image adapter
    ``module_loss_fn(model, loss, mesh)`` trains the model on
    ``{"image", "label"}`` batches with ``loss`` (default
    ``logitcrossentropy``), its BatchNorm statistics taken over the
    global batch when there is a mesh.  ``topk`` is the top-k
    accuracies of the eval step; ``None`` is ``(1, 5, 10)`` with the
    image adapter and ``()`` with a ``loss_fn`` of the caller's (an LM's
    batches carry no labels).  ``val_dataset`` gives a slice of
    ``val_samples`` rows (rounded down to a multiple of the ranks, at
    least one row a rank; the reference's 300-sample slice), drawn once
    with seed ``seed + 1`` and evaluated at the eval cadence.
    ``transform`` is the host-side batch hook (``transform(images,
    labels)`` for image datasets) applied to the train batches, the val
    slice and ``evaluate``.  ``spmd`` takes the data-parallel
    modes ``"jit"`` (alias ``"dp"``) and ``"shard_map"``; the other
    modes raise.  ``zero1=True`` shards the optimizer state and update
    over the ranks (:mod:`..parallel.zero1`); it applies to those modes
    only, and ``"shard_map"`` takes no ``accum_steps``, as in the JAX
    trainer.

    ``mesh`` is the process group the step spans (:mod:`..mesh`);
    ``batch_size`` is the global batch, of which each rank trains its
    rows.  Without a mesh, ``"jit"`` trains on one device, while
    ``zero1`` and ``"shard_map"`` take :func:`..mesh.data_mesh` of
    ``device`` (forming a one-rank group when there is none; the caller
    ends it with :func:`..mesh.shutdown_distributed`).  ``seed`` roots
    the loader's batches and the dropout seeds.  The model must already
    live on the step's device (default ``cuda``).

    ``steps_per_call=K`` runs K optimizer steps a call (the JAX device
    loop, ``spmd="jit"`` only, with or without ``zero1``): the loader
    stacks K step batches an item (``chunk=K``; ``cycles`` counts steps
    and must be a multiple of K) and the step runs them one after the
    other, on a card as one CUDA graph replay that donates the state.
    The JAX version's other options (donation as an option, AOT, the
    guard) are not accepted.
    """
    if spmd == "dp":
        spmd = "jit"
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if steps_per_call != 1 and spmd != "jit":
        raise ValueError("steps_per_call > 1 requires spmd='jit'")
    if zero1 and spmd not in ("jit", "shard_map"):
        raise ValueError(
            "zero1=True applies to the DP paths only (spmd='jit'/'dp'/"
            f"'shard_map'); got spmd={spmd!r} — fsdp already shards the "
            "optimizer state (ZeRO-3 subsumes ZeRO-1)")
    if spmd not in ("jit", "shard_map"):
        raise ValueError(
            f"spmd={spmd!r} is not ported: the port trains data-parallel "
            "(spmd='jit', 'dp' or 'shard_map', with or without zero1); the "
            "other modes come with later slices (ROADMAP)")
    if spmd == "shard_map" and accum_steps != 1:
        raise ValueError("accum_steps > 1 requires spmd='jit'")
    if mesh is None and (zero1 or spmd == "shard_map"):
        from ..mesh import data_mesh

        mesh = data_mesh(device=device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    params = dict(model.named_parameters())
    off = [n for n, p in params.items() if not _same_device(p.device, dev)]
    if off:
        raise ValueError(f"the model's parameters {off[:3]} are not on "
                         f"{dev}; build the model with device={str(dev)!r}")
    if topk is None:
        topk = (1, 5, 10) if loss_fn is None else ()
    topk = tuple(topk)
    if loss_fn is None:
        loss_fn = module_loss_fn(model, loss, mesh)
    # the mutable model state: the buffers (BatchNorm running stats)
    mstate = {k: b.detach().clone() for k, b in model.named_buffers()}
    if mesh is None:
        state = TrainState.create(params, optimizer, model_state=mstate)
        step_fn = make_train_step(loss_fn, optimizer,
                                  accum_steps=accum_steps, seed=seed,
                                  steps_per_call=steps_per_call)
    elif zero1:
        from ..parallel import zero1 as zero1_lib

        state = zero1_lib.zero1_state(params, optimizer, mesh,
                                      model_state=mstate)
        if spmd == "shard_map":
            step_fn = zero1_lib.make_train_step_zero1_shardmap(
                loss_fn, optimizer, mesh, seed=seed)
        else:
            step_fn = zero1_lib.make_train_step_zero1(
                loss_fn, optimizer, mesh, accum_steps=accum_steps, seed=seed,
                steps_per_call=steps_per_call)
    else:
        from ..sharding import replicate

        state = TrainState.create(
            replicate({k: p.detach() for k, p in params.items()}, mesh),
            optimizer, model_state=replicate(mstate, mesh))
        if spmd == "shard_map":
            step_fn = make_train_step_shardmap(loss_fn, optimizer, mesh,
                                               seed=seed)
        else:
            step_fn = make_train_step(loss_fn, optimizer, mesh=mesh,
                                      accum_steps=accum_steps, seed=seed,
                                      steps_per_call=steps_per_call)
    val_batch = None
    if val_dataset is not None:
        q = 1 if mesh is None else mesh.size
        nval = max(q, val_samples // q * q)
        draw = apply_transform(transform, val_dataset.batch(
            np.random.default_rng(seed + 1), nval))
        val_batch = batch_to_dict(draw, getattr(val_dataset, "nclasses", None))
        if mesh is not None:
            from ..sharding import shard_batch

            val_batch = shard_batch(val_batch, mesh)
        val_batch = _to_device(val_batch, dev)
    return TrainTask(
        state=state, step_fn=step_fn,
        eval_fn=make_eval_step(loss_fn, mesh, topk=topk),
        loader=PrefetchLoader(dataset, batch_size, cycles=cycles,
                              epochs=epochs, buffersize=buffersize, seed=seed,
                              device=dev, mesh=mesh, transform=transform,
                              chunk=steps_per_call),
        optimizer=optimizer, model=model, device=dev, mesh=mesh, topk=topk,
        val_batch=val_batch, transform=transform,
        steps_per_call=steps_per_call)


def _is_oom(err: Exception) -> bool:
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "out of memory" in str(err).lower())


def _require_topk(accs: dict, topk) -> None:
    """Fail when a requested top-k accuracy is not one the eval step
    computes."""
    for k in topk:
        if f"top{k}" not in accs:
            raise KeyError(
                f"top-{k} accuracy is not computed by the eval step; pass "
                f"topk={tuple(topk)} to prepare_training")


def _eval_and_log(task: TrainTask, batch, name: str, step: int,
                  logger: Logger) -> dict:
    loss, accs = task.eval_fn(task.state, batch)
    metrics = {f"{name}_loss": float(loss)}
    for k in task.topk:
        metrics[f"{name}_top{k}"] = float(accs[f"top{k}"])
    logger.log(metrics, step)
    return metrics


def evaluate(task: TrainTask, dataset, *, batch_size: int = 256,
             max_batches: Optional[int] = None,
             topk: Optional[Sequence[int]] = None, seed: int = 0) -> dict:
    """Sample-weighted mean loss and top-k accuracies over a dataset
    with the eval step.

    A dataset with a length whose ``batch`` takes ``indices`` is covered
    exactly once, in sequential index blocks plus one smaller remainder
    batch (``"exact": True``).  Otherwise batches are sampled and
    ``max_batches`` is required (``"exact": False``).  ``topk`` defaults
    to the task's; each must be one the eval step computes.  The task's
    ``transform`` applies to every draw.  Returns ``{"loss", "top{k}"
    for each k, "samples", "exact"}``.
    """
    topk = task.topk if topk is None else tuple(topk)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    capable = (hasattr(dataset, "__len__")
               and "indices" in inspect.signature(dataset.batch).parameters)
    full_batches = rem_size = 0
    if capable:
        if len(dataset) == 0:
            raise ValueError("dataset is empty")
        batch_size = min(batch_size, len(dataset))
        full_batches = len(dataset) // batch_size
        rem_size = len(dataset) - full_batches * batch_size
    if max_batches is None:
        if not hasattr(dataset, "__len__"):
            raise ValueError(
                f"{type(dataset).__name__} has no __len__; pass max_batches")
        max_batches = (full_batches if capable
                       else max(1, len(dataset) // batch_size))
    if capable:
        max_batches = min(max_batches, full_batches)
        if max_batches < full_batches:
            rem_size = 0  # caller truncated: no remainder pass
    exact = capable and max_batches == full_batches
    rng = np.random.default_rng(seed)
    total = {"loss": 0.0}
    n = 0

    def accumulate(draw, bs):
        nonlocal n
        draw = apply_transform(task.transform, draw)
        batch = _to_device(
            batch_to_dict(draw, getattr(dataset, "nclasses", None)),
            task.device)
        loss, accs = task.eval_fn(task.state, batch)
        _require_topk(accs, topk)
        total["loss"] += float(loss) * bs
        for k in topk:
            total[f"top{k}"] = (total.get(f"top{k}", 0.0)
                                + float(accs[f"top{k}"]) * bs)
        n += bs

    for i in range(max_batches):
        if exact:
            idx = np.arange(i * batch_size, (i + 1) * batch_size)
            accumulate(dataset.batch(rng, batch_size, indices=idx), batch_size)
        else:
            accumulate(dataset.batch(rng, batch_size), batch_size)
    if exact and rem_size:
        start = max_batches * batch_size
        idx = np.arange(start, start + rem_size)
        accumulate(dataset.batch(rng, rem_size, indices=idx), rem_size)
    out = {k: v / max(n, 1) for k, v in total.items()}
    out.update(samples=n, exact=exact)
    return out


class _PhaseClock:
    """``with phases("dispatch"):`` observes the block's wall seconds
    into ``fdtpu_train_phase_seconds{phase=...}`` (data_wait / dispatch
    / eval)."""

    def __init__(self, registry):
        self.hist = registry.histogram(
            "fdtpu_train_phase_seconds",
            "wall seconds per train-step phase (data_wait/dispatch/eval)",
            labelnames=("phase",))

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # observed on the exception path too: an OOM-heavy run must
            # not show artificially fast dispatch percentiles
            self.hist.labels(phase=name).observe(time.perf_counter() - t0)


def train(task: TrainTask, *, print_every: int = 10, eval_every: int = 50,
          logger: Optional[Logger] = None):
    """The training loop.

    Every ``print_every`` items it logs steps/s and tokens/s (images/s
    for image batches) over the interval; every ``eval_every`` items the
    eval loss and top-k accuracies of the val slice (when there is one)
    and of the current batch (its last step batch under the device
    loop), and the step's own loss.  Host-clock rates: the loop runs
    ahead of the device by the launch queue, so interval averages hold.
    A device OOM skips the item (``task.skipped_items``) and counts its
    steps in ``task.num_missed``.  Each step's loss lands in
    ``task.losses`` (read back once, at the end).  The
    trained parameters and running stats are copied into ``task.model``
    in place.

    Returns ``(host_params, model_state, task)``: CPU copies of the
    final parameters.
    """
    logger = logger or ConsoleLogger()
    reg = get_registry()
    phases = _PhaseClock(reg)
    steps_total = reg.counter(
        "fdtpu_train_steps_total", "optimizer steps completed")
    step_hist = reg.histogram(
        "fdtpu_train_step_seconds", "wall seconds per loader item")
    step_gauge = reg.gauge(
        "fdtpu_train_step", "optimizer steps completed this train() call")
    oom_total = reg.counter(
        "fdtpu_train_oom_skipped_total",
        "batches skipped by OOM fault tolerance")
    # the device loop: an item is spc optimizer steps
    spc = task.steps_per_call
    t_start = time.perf_counter()
    it = iter(task.loader)
    _end = object()
    j = int(getattr(task.loader, "start", 0))
    t_mark, j_mark = t_start, j
    done_steps = 0
    losses = []  # fresh device tensors, read back once at the end
    try:
        while True:
            t_item = time.perf_counter()
            with phases("data_wait"):
                batch = next(it, _end)
            if batch is _end:
                break
            if print_every and j % print_every == 0:
                now = time.perf_counter()
                if j > j_mark:
                    dsteps = (j - j_mark) * spc
                    dt = max(now - t_mark, 1e-9)
                    lead = next(iter(batch.values()))
                    lead = lead[0] if spc > 1 else lead  # one step's batch
                    rate = {"steps_per_sec": round(dsteps / dt, 3)}
                    if "tokens" in batch:
                        rate["tokens_per_sec"] = round(
                            dsteps * lead.numel() / dt, 1)
                    else:
                        rate["images_per_sec"] = round(
                            dsteps * lead.shape[0] / dt, 1)
                    logger.log(rate, j)
                    t_mark, j_mark = now, j
                logger.info(f"cycle {j} (t={now - t_start:.1f}s)")
            skipped = False
            try:
                with phases("dispatch"):
                    task.state, metrics = task.step_fn(task.state, batch)
            except Exception as e:  # OOM-skip fault tolerance
                if not _is_oom(e):
                    raise
                task.num_missed += spc
                task.skipped_items.append(j)
                oom_total.inc(spc)
                logger.log({"oom_skipped_item": j,
                            "oom_skipped_step_first": j * spc}, j)
                logger.info(f"cycle {j}: device OOM — skipping batch "
                            f"({task.num_missed} missed)")
                skipped = True
            if not skipped:
                losses.append(metrics["loss"])
                if eval_every and j % eval_every == 0:
                    with phases("eval"):
                        if task.val_batch is not None:
                            _eval_and_log(task, task.val_batch, "val", j,
                                          logger)
                        # the eval step takes one step's batch: the last
                        eb = ({k: v[-1] for k, v in batch.items()}
                              if spc > 1 else batch)
                        _eval_and_log(task, eb, "train", j, logger)
                        loss = metrics["loss"]
                        logger.log({"train_step_loss": float(
                            loss[-1] if spc > 1 else loss)}, j)
                steps_total.inc(spc)
                done_steps += spc
                step_gauge.set(done_steps)
                step_hist.observe(time.perf_counter() - t_item)
            j += 1
    finally:
        if losses:
            task.losses.extend(torch.cat([x.reshape(-1) for x in losses])
                               .float().cpu().tolist())
    if task.num_missed:
        logger.info(f"missed {task.num_missed} batches due to OOM")
    with torch.no_grad():
        for name, p in task.model.named_parameters():
            p.copy_(task.state.params[name])
        for name, b in task.model.named_buffers():
            if name in task.state.model_state:
                b.copy_(task.state.model_state[name])
    return to_host(task.state.params), task.state.model_state, task
