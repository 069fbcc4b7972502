"""Training orchestration: ``prepare_training`` + ``train``.

Port of the core of ``fluxdistributed_tpu/train/trainer.py`` for the
data-parallel modes ``spmd="jit"`` (alias ``"dp"``) and ``"shard_map"``
(with or without ZeRO-1), FSDP (``"fsdp"``), Megatron tensor
parallelism (``"tp"``) and their hybrid (``"fsdp_tp"``), the
rule-derived dp x fsdp x tp layouts (``layout=``), context parallelism
(``"sp"``), MoE expert parallelism (``"ep"``) and pipeline parallelism
(``"pp"``, the GPipe schedule, and ``"pp_1f1b"``, the hand-written 1F1B
and zero-bubble schedules), on one GPU, on the ranks of a process group
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
* ``evaluate`` aggregates the loss and top-k accuracies over a dataset,
  drawing (as the val slice does) through an eval view of the dataset
  with augmentation off;
* checkpoints and preemption: ``train(checkpoint_dir=...)`` saves at the
  JAX cadence, and with ``handle_signals`` a SIGTERM or SIGINT becomes a
  blocking checkpoint, a RESUME manifest and :class:`..faults.Preempted`
  at the next step boundary; ``resume_training`` restores the state and
  the loader cursor, so a resumed run is step for step the
  uninterrupted one (:mod:`.checkpoint`);
* the anomaly guard (:mod:`.guard`): ``prepare_training(guard=True)``
  builds the sentinel into the step and keeps the pre-step state, and
  ``train(guard=...)`` judges each item before it commits it, with
  quarantine, rollback onto the last checkpoint and halt;
* the observation layer (:mod:`..obs`): ``train(observation=...)``
  threads the phase histograms and spans, the stall watchdog, the
  flight recorder, the JSONL sink and the ``fdtpu_hbm_*`` gauges
  through the loop, and ``profile_dir`` takes a ``torch.profiler``
  trace of a window of items.

Phase times, step counts and OOM skips land in the process registry
(:mod:`..obs.metrics`) under the JAX trainer's ``fdtpu_train_*`` names.  A
device OOM on one rank of a mesh, and not on the others, leaves the
others waiting in the step's next collective, as in the JAX package on
several hosts.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..data.loader import PrefetchLoader, apply_transform, batch_to_dict
from ..device import DeviceLike, resolve_device
from ..mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                    Mesh)
from ..obs import FlightRecorder, JsonlSink, Observation, memstats, runs
from ..ops.losses import logitcrossentropy
from ..optim import Optimizer
from ..parallel.dp import (TrainState, make_eval_step, make_train_step,
                           make_train_step_shardmap, module_loss_fn)
from ..parallel.fsdp import make_eval_step_sharded, make_train_step_sharded
from ..parallel import multihost
from ..tree import synchronize, to_host
from .checkpoint import (clear_resume_manifest, latest_step, load_checkpoint,
                         load_checkpoint_elastic, read_resume_manifest,
                         save_checkpoint, wait_for_pending,
                         write_resume_manifest)
from .guard import GuardConfig, GuardHalt, TrainGuard, state_donated
from .logging import Logger, current_logger

__all__ = ["TrainTask", "evaluate", "prepare_training", "restore_training",
           "resume_training", "train"]


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
    # loader items the anomaly guard quarantined (a resumed run reads
    # them from the RESUME manifest and skips them again)
    quarantined_items: list = dataclasses.field(default_factory=list)
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
    # the optimizer state is ZeRO-1-sharded over ``mesh`` (a checkpoint
    # gathers it)
    zero1: bool = False
    # the state's specs (a TrainState of sharding.P) when it is a state
    # of blocks (fsdp, tp, fsdp_tp, layouts, sp, ep, pp, pp_1f1b), else
    # None
    specs: Optional[TrainState] = None
    # the size every eval batch must divide (0: any): the pipeline modes
    # set data ranks x microbatches (each data row's rows split into M
    # microbatches)
    batch_quantum: int = 0
    # the pipeline modes: maps the gathered split tree onto the model's
    # parameter names (``train`` copies the result into the model)
    merge_params: Optional[Callable] = None


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _same_device(p: torch.device, dev: torch.device) -> bool:
    """``cuda:0`` is on ``cuda``; an index counts only when given."""
    return p.type == dev.type and (dev.index is None or p.index == dev.index)


def _eval_view(dataset):
    """A non-mutating eval view of ``dataset``: the same tables and
    decoders with augmentation off.

    Eval draws go through the eval pipeline even when the dataset
    augments (an ImageNet train split, a registry entry with ``augment =
    true``).  Turning ``dataset.augment`` off in place would race a
    prefetch loader that shares the object, so the view is a shallow
    copy with its own ``augment`` flag over the shared, read-only sample
    tables.
    """
    if getattr(dataset, "augment", False):
        view = copy.copy(dataset)
        view.augment = False
        return view
    return dataset


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
    guard: bool = False,
    layout=None,
    num_microbatches: Optional[int] = None,
    pipeline_interleave: bool = False,
    pipeline_schedule: str = "1f1b",
    pp_plan=None,
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
    ``val_samples`` rows (rounded down to a multiple of the batch ranks, at
    least one row a rank; the reference's 300-sample slice), drawn once
    with seed ``seed + 1`` and evaluated at the eval cadence.
    ``transform`` is the host-side batch hook (``transform(images,
    labels)`` for image datasets) applied to the train batches, the val
    slice and ``evaluate``.  ``spmd`` takes the data-parallel
    modes ``"jit"`` (alias ``"dp"``) and ``"shard_map"``, ``"fsdp"``,
    ``"tp"`` and ``"fsdp_tp"``, ``"sp"`` and ``"ep"``, ``"pp"`` and
    ``"pp_1f1b"``.  ``zero1=True`` shards the optimizer state and
    update over the ranks (:mod:`..parallel.zero1`); it applies to the
    data-parallel modes only, and ``"shard_map"`` takes no
    ``accum_steps``, as in the JAX trainer.

    ``"fsdp"`` shards every large param and optimizer-state leaf over
    the mesh's ``data`` axis (:mod:`..parallel.fsdp`).  ``"tp"`` makes
    the model (an LM or a ViT) Megatron tensor-parallel over a mesh with
    a ``model`` axis (:func:`..mesh.make_mesh`, ``{"data": D, "model":
    K}``; :mod:`..parallel.tp`: the model's weights are rebound to this
    rank's blocks), with the batch over ``data``; ``"fsdp_tp"`` also
    FSDP-shards each leaf's leftover dim over ``data``.  The tensor-
    parallel modes refuse ``accum_steps > 1``, a mesh without a
    ``model`` axis, ``dropout > 0`` and a model without rules, as the
    JAX trainer does.  ``layout`` (a :class:`..parallel.layout.Layout`
    or a preset name) shards by the rules engine over the ``(data,
    fsdp, model)`` mesh (:mod:`..parallel.layout`; the caller's mesh, or
    ``layout.build_mesh``), the batch split over ``data`` and ``fsdp``;
    it keeps ``spmd="jit"`` and refuses ``zero1`` and ``steps_per_call >
    1``, and a layout with ``tp > 1`` refuses ``dropout > 0``.
    ``layout="auto"`` is refused: the picker
    (``parallel.layout.pick``) chooses a Layout from a model and a batch
    (the CLI's ``--layout auto``).

    ``"sp"`` (context parallelism) needs a mesh with ``data`` and ``seq``
    axes and a model whose ``attn_fn`` is that mesh's
    ``parallel.make_ring_attention`` or ``make_ulysses_attention``: the
    params are replicated, each rank takes its data row's rows of the
    batch (the full sequences; tokens are cheap) and runs the whole model
    on its ``T/S`` positions, and the seq ranks' parts of the loss and
    their gradients are summed before the data-parallel mean.  ``"ep"``
    (expert parallelism) needs a mesh with ``data`` and ``expert`` axes
    and an MoE ``TransformerLM`` whose ``moe_fn`` is that mesh's
    ``parallel.moe_apply(models.moe_expert_fn, mesh, ...)``: the expert
    leaves are split over ``expert`` (``models.lm_moe_specs``), the batch
    over ``data`` and ``expert`` jointly, the loss is ``lm_loss_fn``'s
    (with the router's load-balance term) and ``topk`` is ``()``.  Both
    refuse ``accum_steps > 1`` (``ep``), ``zero1`` and ``steps_per_call
    > 1``, and take ``guard=True``.  These modes keep a
    state of blocks (``TrainTask.specs``): checkpoints hold global
    shapes, and the eval step and ``evaluate`` take the state as it is.

    ``"pp"`` and ``"pp_1f1b"`` pipeline a ``TransformerLM``'s blocks
    over the ``pipe`` axis of a ``{"data": D, "pipe": S}`` mesh (the
    pipe rank at index *s* hosts stage *s*), with data parallelism over
    ``data``: the state is the flat split tree of
    ``models.lm_pp`` (``outer/`` leaves replicated, ``stages/`` leaves
    this rank's stage), each data row's rows split into
    ``num_microbatches`` (default ``2 S``) microbatches.  ``"pp"`` is the
    GPipe schedule, its backward derived by autograd (and takes
    ``guard=True``); ``"pp_1f1b"`` the hand-written 1F1B schedule, or its
    zero-bubble variant with ``pipeline_schedule="zb"``, and with
    ``pipeline_interleave=True`` the Megatron interleaved placement
    (whose eval runs the 1F1B program; the others evaluate through the
    GPipe forward on the same tree).  ``pp_plan`` (a
    ``parallel.pp_plan.PipelinePlan`` or the path of a saved one) places
    non-uniform stage boundaries.  Both train on the pipeline's own
    next-token loss (a ``loss_fn`` is refused), ``topk`` is ``()``, and
    eval batches must divide ``D x M`` (``TrainTask.batch_quantum``: the
    val slice and ``evaluate`` round to it).

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

    ``guard=True`` builds the anomaly sentinel into the train step
    (:func:`..parallel.dp.guard_sentinel`: ``metrics["guard"] =
    [poisoned_loss, grad_norm]``) and keeps the state a step is given
    (on a card, a graph replay first copies the state into a shadow), so
    that ``train(guard=...)`` can discard an anomalous step.  It applies
    to ``spmd="jit"`` (with or without ``zero1``, and with a
    ``layout``), ``"sp"`` and ``"ep"``, the paths of the JAX
    ``dp.make_train_step``; ``"shard_map"``, ``"fsdp"``, ``"tp"`` and
    ``"fsdp_tp"`` have no sentinel and are refused, as the JAX trainer
    refuses them
    (``train(guard=...)`` still runs there on the loss alone).  The JAX version's other options
    (donation as an option, AOT) are not accepted.
    """
    if spmd == "dp":
        spmd = "jit"
    if layout is not None:
        from ..parallel import layout as layout_lib

        if spmd != "jit":
            raise ValueError(
                f"layout= builds the rule-derived 3-D step and cannot "
                f"combine with spmd={spmd!r} (keep the default "
                "spmd='jit'/'dp')")
        if zero1:
            raise ValueError(
                "layout= cannot combine with zero1=True: a layout's fsdp "
                "axis already shards the optimizer state (ZeRO-3 placement "
                "subsumes ZeRO-1) — use e.g. layout='fsdp' or 'dp_fsdp'")
        if steps_per_call != 1:
            raise ValueError("steps_per_call > 1 is not supported with "
                             "layout= (yet) — drop one of them")
        layout = layout_lib.resolve_layout(
            layout, ndev=mesh.size if mesh is not None else None)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if steps_per_call != 1 and spmd != "jit":
        raise ValueError("steps_per_call > 1 requires spmd='jit'")
    if zero1 and spmd not in ("jit", "shard_map"):
        raise ValueError(
            "zero1=True applies to the DP paths only (spmd='jit'/'dp'/"
            f"'shard_map'); got spmd={spmd!r} — fsdp already shards the "
            "optimizer state (ZeRO-3 subsumes ZeRO-1)")
    if spmd not in ("jit", "shard_map", "fsdp", "tp", "fsdp_tp", "sp",
                    "ep", "pp", "pp_1f1b"):
        raise ValueError(
            f"unknown spmd mode {spmd!r}; pick one of jit (alias dp) / "
            "shard_map / fsdp / tp / fsdp_tp / pp / pp_1f1b / ep / sp")
    if spmd == "shard_map" and accum_steps != 1:
        raise ValueError("accum_steps > 1 requires spmd='jit'")
    if guard and spmd not in ("jit", "sp", "ep", "pp"):
        raise ValueError(
            f"guard=True builds the grad sentinel into the step of "
            f"dp.make_train_step, which spmd={spmd!r} does not use "
            "(supported: jit/dp [+zero1, layouts], sp, ep, pp); the guard "
            "still runs loss-only there: drop guard=True and pass "
            "train(guard=GuardConfig(...))")
    _check_pp_options(spmd, num_microbatches, pipeline_interleave,
                      pipeline_schedule, pp_plan)
    if layout is not None:
        mesh = mesh or layout.build_mesh(device=device)
        layout.validate_mesh(mesh)
    elif mesh is None and (zero1 or spmd in ("shard_map", "fsdp")):
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
    # the mutable model state: the buffers (BatchNorm running stats)
    mstate = {k: b.detach().clone() for k, b in model.named_buffers()}
    specs = None
    # the ranks the batch splits over: the mesh, or its batch axes
    bmesh = mesh
    # the sharded step's expert-block and partial-loss axes (ep, sp)
    block_axes, partial_axes = (), ()
    batch_quantum, merge, eval_fn = 0, None, None
    if spmd in ("pp", "pp_1f1b"):
        topk = ()  # image metrics never apply to the LM pipeline
        state, specs, step_fn, eval_fn, batch_quantum, merge = _pp_task(
            model, dataset, optimizer, params, mstate, mesh, spmd=spmd,
            loss_fn=loss_fn, accum_steps=accum_steps,
            batch_size=batch_size, seed=seed,
            num_microbatches=num_microbatches,
            interleave=pipeline_interleave, schedule=pipeline_schedule,
            pp_plan=pp_plan, guard=guard, transform=transform)
        bmesh = mesh.sub(DATA_AXIS)
    elif layout is not None:
        if batch_size % layout.batch_shards:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the "
                f"layout's dp x fsdp = {layout.batch_shards} "
                f"({layout.describe()})")
        bmesh = mesh.sub(layout.batch_axes)
        if loss_fn is None:
            loss_fn = module_loss_fn(model, loss, bmesh)
        state, specs = _sharded_state(
            model, params, mstate, optimizer, mesh,
            lambda st: layout_lib.state_specs_for(model, st, layout, mesh),
            tp=layout.tp > 1, what=f"layout {layout.name!r}")
        step_fn = make_train_step_sharded(
            loss_fn, optimizer, mesh, specs, batch_axes=layout.batch_axes,
            accum_steps=accum_steps, seed=seed, guard=guard, model=model)
    elif spmd in ("tp", "fsdp_tp"):
        from ..models import TransformerLM, ViT
        from ..parallel import fsdp as fsdp_lib
        from ..parallel import tp as tp_lib

        if accum_steps != 1:
            raise ValueError("accum_steps > 1 requires spmd='jit' or 'fsdp'")
        if mesh is None or MODEL_AXIS not in mesh.shape:
            raise ValueError(
                f"spmd={spmd!r} needs a mesh with a 'model' axis, e.g. "
                "make_mesh({'data': D, 'model': K})")
        if getattr(model, "dropout", 0.0):
            raise ValueError(
                f"spmd={spmd!r} supports dropout=0 only (no rng stream "
                "threads through the TP step)")
        if isinstance(model, ViT):
            rules = tp_lib.vit_tp_rules()
        elif isinstance(model, TransformerLM):
            rules = tp_lib.lm_tp_rules()
        else:
            raise ValueError(
                f"no TP sharding rules for {type(model).__name__}; "
                f"spmd={spmd!r} supports ViT and TransformerLM (CNN params "
                "are small — use DP/FSDP there)")

        def tp_specs(st):
            if spmd == "fsdp_tp":
                p = fsdp_lib.hybrid_fsdp_tp_specs(st.params, mesh, rules)
            else:
                p = tp_lib.param_specs(st.params, rules)
            return tp_lib.state_specs(st, p)

        bmesh = mesh.sub(DATA_AXIS)
        if loss_fn is None:
            loss_fn = module_loss_fn(model, loss, bmesh)
        state, specs = _sharded_state(model, params, mstate, optimizer,
                                      mesh, tp_specs, tp=True, what=spmd)
        step_fn = make_train_step_sharded(
            loss_fn, optimizer, mesh, specs, batch_axes=(DATA_AXIS,),
            seed=seed, model=model)
    elif spmd == "sp":
        from ..parallel import tp as tp_lib
        from ..sharding import P

        _check_sp(model, mesh)
        bmesh = mesh.sub(DATA_AXIS)
        partial_axes = (SEQ_AXIS,)
        if loss_fn is None:
            # an image model (the sequence-sharded ViT): every seq rank
            # holds the whole loss of its rows, so each takes 1/S of it
            loss_fn = _seq_part(module_loss_fn(model, loss, bmesh),
                                mesh.axis_size(SEQ_AXIS))
        state, specs = _sharded_state(  # every leaf replicated
            model, params, mstate, optimizer, mesh,
            lambda st: tp_lib.state_specs(st, {k: P() for k in st.params}),
            tp=False, what=spmd)
        step_fn = make_train_step_sharded(
            loss_fn, optimizer, mesh, specs, batch_axes=(DATA_AXIS,),
            tp_axis=None, partial_axes=partial_axes,
            accum_steps=accum_steps, seed=seed, guard=guard)
    elif spmd == "ep":
        from ..models import lm_loss_fn, lm_moe_specs
        from ..parallel import tp as tp_lib

        _check_ep(model, mesh, accum_steps)
        if loss_fn is None:
            loss_fn = lm_loss_fn(model)  # the token protocol
        topk = ()  # image metrics never apply to the LM
        bmesh = mesh.sub((DATA_AXIS, EXPERT_AXIS))
        block_axes = (EXPERT_AXIS,)
        state, specs = _sharded_state(
            model, params, mstate, optimizer, mesh,
            lambda st: tp_lib.state_specs(st, lm_moe_specs(st.params)),
            tp=False, what=spmd)
        step_fn = make_train_step_sharded(
            loss_fn, optimizer, mesh, specs,
            batch_axes=(DATA_AXIS, EXPERT_AXIS), tp_axis=None,
            block_axes=block_axes, seed=seed, guard=guard)
    elif spmd == "fsdp":
        from ..parallel import fsdp as fsdp_lib

        bmesh = mesh.sub(DATA_AXIS)
        if loss_fn is None:
            loss_fn = module_loss_fn(model, loss, bmesh)
        state, specs = _sharded_state(
            model, params, mstate, optimizer, mesh,
            lambda st: fsdp_lib.fsdp_specs(st, mesh), tp=False, what=spmd)
        step_fn = make_train_step_sharded(
            loss_fn, optimizer, mesh, specs, batch_axes=(DATA_AXIS,),
            accum_steps=accum_steps, seed=seed, model=model)
    else:
        if loss_fn is None:
            loss_fn = module_loss_fn(model, loss, mesh)
        state, step_fn = _dp_state_and_step(
            loss_fn, optimizer, params, mstate, mesh, spmd=spmd,
            zero1=zero1, accum_steps=accum_steps, seed=seed,
            steps_per_call=steps_per_call, guard=guard)
    if eval_fn is not None:
        pass  # the pipeline modes' own
    elif specs is not None:
        eval_fn = make_eval_step_sharded(loss_fn, mesh, specs,
                                         batch_axes=bmesh.axis_names,
                                         block_axes=block_axes,
                                         partial_axes=partial_axes,
                                         topk=topk, model=model)
    else:
        eval_fn = make_eval_step(loss_fn, mesh, topk=topk)
    val_batch = None
    if val_dataset is not None:
        q = batch_quantum or (1 if bmesh is None else bmesh.size)
        nval = max(q, val_samples // q * q)
        # the eval pipeline, even where the val dataset augments
        draw = apply_transform(transform, _eval_view(val_dataset).batch(
            np.random.default_rng(seed + 1), nval))
        val_batch = batch_to_dict(draw, getattr(val_dataset, "nclasses", None))
        if bmesh is not None:
            from ..sharding import shard_batch

            val_batch = shard_batch(val_batch, bmesh, axis=bmesh.axis_names)
        val_batch = _to_device(val_batch, dev)
    return TrainTask(
        state=state, step_fn=step_fn, eval_fn=eval_fn,
        loader=PrefetchLoader(dataset, batch_size, cycles=cycles,
                              epochs=epochs, buffersize=buffersize, seed=seed,
                              device=dev, mesh=bmesh, transform=transform,
                              chunk=steps_per_call),
        optimizer=optimizer, model=model, device=dev, mesh=mesh, topk=topk,
        val_batch=val_batch, transform=transform,
        steps_per_call=steps_per_call, zero1=zero1, specs=specs,
        batch_quantum=batch_quantum, merge_params=merge)


def _dp_state_and_step(loss_fn, optimizer, params, mstate, mesh, *, spmd,
                       zero1, accum_steps, seed, steps_per_call, guard):
    """The state and the train step of the data-parallel modes."""
    if mesh is None:
        state = TrainState.create(params, optimizer, model_state=mstate)
        return state, make_train_step(
            loss_fn, optimizer, accum_steps=accum_steps, seed=seed,
            steps_per_call=steps_per_call, guard=guard)
    if zero1:
        from ..parallel import zero1 as zero1_lib

        state = zero1_lib.zero1_state(params, optimizer, mesh,
                                      model_state=mstate)
        if spmd == "shard_map":
            return state, zero1_lib.make_train_step_zero1_shardmap(
                loss_fn, optimizer, mesh, seed=seed)
        return state, zero1_lib.make_train_step_zero1(
            loss_fn, optimizer, mesh, accum_steps=accum_steps, seed=seed,
            steps_per_call=steps_per_call, guard=guard)
    from ..sharding import replicate

    state = TrainState.create(
        replicate({k: p.detach() for k, p in params.items()}, mesh),
        optimizer, model_state=replicate(mstate, mesh))
    if spmd == "shard_map":
        return state, make_train_step_shardmap(loss_fn, optimizer, mesh,
                                               seed=seed)
    return state, make_train_step(
        loss_fn, optimizer, mesh=mesh, accum_steps=accum_steps, seed=seed,
        steps_per_call=steps_per_call, guard=guard)


def _check_sp(model, mesh) -> None:
    """``spmd="sp"``'s mesh and model, with the JAX trainer's message
    for a mesh without its axes."""
    for ax in (SEQ_AXIS, DATA_AXIS):
        if mesh is None or ax not in mesh.shape:
            raise ValueError(
                "spmd='sp' needs a mesh with 'data' and 'seq' axes, e.g. "
                "make_mesh({'data': 1, 'seq': 8}), and a model built with "
                "attn_fn=make_ring_attention(mesh, batch_axis='data', ...)")
    attn = getattr(model, "attn_fn", None)
    if getattr(attn, "seq_axis", None) != SEQ_AXIS:
        raise ValueError(
            "spmd='sp' needs a model whose attn_fn is sequence-parallel "
            "over the 'seq' axis (parallel.make_ring_attention or "
            f"make_ulysses_attention on the mesh); got {attn!r}")
    if attn.mesh.shape != mesh.shape:
        raise ValueError(f"the model's attn_fn runs on the mesh "
                         f"{attn.mesh.shape}, the step on {mesh.shape}")
    from ..models import TransformerLM

    if not isinstance(model, TransformerLM) and attn.batch_axis is not None:
        raise ValueError(
            "the trainer feeds each rank its rows of the batch: build the "
            "sequence-sharded model's attn_fn without batch_axis (with one "
            "its forward takes the global batch)")


def _seq_part(loss_fn: Callable, n: int) -> Callable:
    """``loss_fn``'s loss divided by the ``n`` seq ranks: a loss every
    rank computes whole becomes the parts ``spmd="sp"`` sums."""
    from ..optim import div_const

    def fn(params, model_state, batch, train: bool, rng=None):
        loss, aux = loss_fn(params, model_state, batch, train, rng=rng)
        return div_const(loss, n), aux

    fn.global_model_state = getattr(loss_fn, "global_model_state", False)
    return fn


def _check_ep(model, mesh, accum_steps: int) -> None:
    """``spmd="ep"``'s model and mesh, with the JAX trainer's checks and
    messages."""
    from ..models import TransformerLM

    if not isinstance(model, TransformerLM) or not model.moe_every:
        raise ValueError(
            "spmd='ep' needs a TransformerLM with moe_every > 0 and a "
            "mesh-bound moe_fn (models.moe_expert_fn via ep.moe_apply)")
    if accum_steps != 1:
        raise ValueError("accum_steps > 1 requires spmd='jit' or 'fsdp'")
    for ax in (EXPERT_AXIS, DATA_AXIS):
        if mesh is None or ax not in mesh.shape:
            raise ValueError(
                "spmd='ep' needs a mesh with 'data' and 'expert' axes, "
                "e.g. make_mesh({'data': 1, 'expert': 8})")
    bound = getattr(model.moe_fn, "mesh", None)
    if bound is not None and bound.shape != mesh.shape:
        raise ValueError(f"the model's moe_fn runs on the mesh "
                         f"{bound.shape}, the step on {mesh.shape}")


def _check_pp_options(spmd, num_microbatches, interleave, schedule,
                      pp_plan) -> None:
    """The pipeline options, checked before any model wiring with the
    JAX trainer's messages."""
    if num_microbatches is not None and spmd not in ("pp", "pp_1f1b"):
        raise ValueError("num_microbatches requires spmd='pp' or 'pp_1f1b'")
    if num_microbatches is not None and num_microbatches < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    if interleave and spmd != "pp_1f1b":
        raise ValueError(
            "pipeline_interleave requires spmd='pp_1f1b' (the hand-written "
            "schedule; GPipe-via-AD cannot interleave)")
    if schedule not in ("1f1b", "zb"):
        raise ValueError(f"unknown pipeline_schedule {schedule!r} "
                         "(pick '1f1b' or 'zb')")
    if schedule != "1f1b" and spmd != "pp_1f1b":
        raise ValueError(
            "pipeline_schedule='zb' requires spmd='pp_1f1b' (the zero-"
            "bubble B/W split only exists in the hand-written schedule)")
    if pp_plan is not None and spmd not in ("pp", "pp_1f1b"):
        raise ValueError("pp_plan requires spmd='pp' or 'pp_1f1b'")
    if pp_plan is not None and interleave:
        raise ValueError(
            "pp_plan cannot combine with pipeline_interleave: planner "
            "boundaries are contiguous block ranges, the interleaved "
            "placement is round-robin")


def _pp_task(model, dataset, optimizer, params, mstate, mesh, *, spmd,
             loss_fn, accum_steps, batch_size, seed, num_microbatches,
             interleave, schedule, pp_plan, guard, transform):
    """``spmd="pp"|"pp_1f1b"``'s checks (the JAX trainer's, in its order
    and with its messages), state, specs, train and eval steps, the
    batch quantum and the split tree's merge onto the model's names."""
    from ..models import TransformerLM
    from ..models.transformer_lm import lm_pp, lm_pp_1f1b, pp_merge_params
    from ..parallel.pp import split_tree
    from ..parallel.pp_1f1b import make_train_step_1f1b, pipeline_grads_1f1b
    from ..sharding import replicate

    if not isinstance(model, TransformerLM):
        raise ValueError(
            f"spmd={spmd!r} supports TransformerLM only (CNN stages "
            "change activation shapes mid-network)")
    if accum_steps != 1:
        raise ValueError("accum_steps > 1 requires spmd='jit' or 'fsdp'")
    if loss_fn is not None:
        raise ValueError(
            f"spmd={spmd!r} trains on the pipeline's own per-microbatch "
            "next-token loss; a loss_fn override cannot apply (drop it)")
    for ax in (PIPE_AXIS, DATA_AXIS):
        if mesh is None or ax not in mesh.shape:
            raise ValueError(
                f"spmd={spmd!r} needs a mesh with 'data' and 'pipe' "
                "axes, e.g. make_mesh({'data': 1, 'pipe': 8})")
    if mstate:
        raise ValueError(f"spmd={spmd!r} supports stateless models only "
                         f"(got model state {list(mstate)[:3]})")
    if spmd == "pp_1f1b":
        probe = batch_to_dict(
            apply_transform(transform,
                            dataset.batch(np.random.default_rng(0), 1)),
            getattr(dataset, "nclasses", None))
        if "mask" in probe:
            raise ValueError(
                "spmd='pp_1f1b' does not support batch['mask'] (the "
                "1F1B per-microbatch loss reads tokens only) — use "
                "spmd='pp', whose loss applies the mask")
    S, n_data = mesh.shape[PIPE_AXIS], mesh.shape[DATA_AXIS]
    M = num_microbatches or 2 * S
    boundaries = None
    if pp_plan is not None:
        from ..parallel.pp_plan import PipelinePlan

        if isinstance(pp_plan, str):
            pp_plan = PipelinePlan.load(pp_plan)
        pp_plan.verify_source_topology()
        if pp_plan.S != S:
            raise ValueError(
                f"pp_plan places {pp_plan.S} stages but the "
                f"'{PIPE_AXIS}' axis has {S} — re-plan for this mesh")
        if pp_plan.depth != model.depth:
            raise ValueError(
                f"pp_plan partitions {pp_plan.depth} blocks but the model "
                f"has depth {model.depth} — re-plan for this model")
        boundaries = pp_plan.boundaries
    per_row = batch_size // n_data
    if batch_size % n_data or per_row % M:
        raise ValueError(
            f"batch_size {batch_size} must split into data axis {n_data} x "
            f"microbatches {M} (per-row batch {per_row})")
    gparams = replicate({k: p.detach() for k, p in params.items()}, mesh)
    kw = dict(num_microbatches=M, batch_axis=DATA_AXIS, seed=seed)
    if interleave:
        # the round-robin layout cannot feed the blocked GPipe forward:
        # eval runs the 1F1B program and keeps its loss
        w = lm_pp_1f1b(model, mesh, interleave=True)
        state = TrainState.create(w.split_params(gparams), optimizer)
        step_fn = make_train_step_1f1b(*w.fns, optimizer, mesh,
                                       interleave=w.interleave,
                                       schedule=schedule, **kw)
        eval_run = pipeline_grads_1f1b(
            *w.fns, mesh, num_microbatches=M, batch_axis=DATA_AXIS,
            interleave=w.interleave)

        def eval_fn(state, batch):
            outer, stages = split_tree(state.params)
            loss, _, _ = eval_run(stages, outer, batch["tokens"],
                                  batch["tokens"])
            return loss, {}

        return (state, w.state_specs(state), step_fn, eval_fn, n_data * M,
                pp_merge_params(model, S, interleave=True))
    split_params, pp_loss_fn, specs_of = lm_pp(
        model, mesh, batch_axis=DATA_AXIS, num_microbatches=M,
        boundaries=boundaries)
    state = TrainState.create(split_params(gparams), optimizer)
    specs = specs_of(state)
    if spmd == "pp":
        step_fn = make_train_step_sharded(
            pp_loss_fn, optimizer, mesh, specs, batch_axes=(DATA_AXIS,),
            tp_axis=None, block_axes=(PIPE_AXIS,), seed=seed, guard=guard)
    else:
        w = lm_pp_1f1b(model, mesh, boundaries=boundaries)
        step_fn = make_train_step_1f1b(*w.fns, optimizer, mesh,
                                       interleave=w.interleave,
                                       schedule=schedule, **kw)
    # eval through the GPipe forward: the same tree and specs
    eval_fn = make_eval_step_sharded(
        pp_loss_fn, mesh, specs, batch_axes=(DATA_AXIS,), tp_axis=None,
        block_axes=(PIPE_AXIS,), topk=())
    return (state, specs, step_fn, eval_fn, n_data * M,
            pp_merge_params(model, S, boundaries=boundaries))


def _sharded_state(model, params, mstate, optimizer, mesh,
                   specs_of: Callable, *, tp: bool, what: str):
    """This rank's blocks of the state made from the model's params
    (rank 0's values) and their specs (``specs_of(global_state)``).
    With ``tp``, a model whose specs split it over the ``model`` axis
    becomes tensor-parallel (its weights rebound to this rank's blocks);
    a model with dropout is refused there (the masks of its split
    activations would be drawn over each rank's slice)."""
    from ..parallel import fsdp as fsdp_lib
    from ..parallel import tp as tp_lib
    from ..sharding import spec_axes

    gstate = TrainState.create(params, optimizer, model_state=mstate)
    specs = specs_of(gstate)
    state = fsdp_lib.shard_state(gstate, specs, mesh)
    del gstate
    if tp and any(MODEL_AXIS in spec_axes(s) for s in specs.params.values()):
        if getattr(model, "dropout", 0.0):
            raise ValueError(f"{what} splits the model over its 'model' "
                             "axis, which supports dropout=0 only")
        tp_lib.tensor_parallel(model, mesh, specs.params)
    return state, specs


def restore_training(task: TrainTask, checkpoint_dir: str,
                     step: Optional[int] = None) -> TrainTask:
    """Restore the latest (or the given) step of ``checkpoint_dir`` into
    the prepared task's state (params, optimizer state, model state and
    step counter; a ZeRO-1 state on this rank's slices).  For the
    preemption-aware resume, with the loader cursor, use
    :func:`resume_training`."""
    task.state = load_checkpoint(checkpoint_dir, task.state, step=step,
                                 mesh=task.mesh, specs=task.specs)
    return task


def _topology(task: TrainTask) -> tuple:
    """(mesh shape, device count) as the RESUME manifest records them."""
    if task.mesh is None:
        return {"data": 1}, 1
    return dict(task.mesh.shape), task.mesh.size


def resume_training(task: TrainTask, checkpoint_dir: str,
                    step: Optional[int] = None) -> Optional[dict]:
    """Preemption-aware resume: restore the state and the run's cursor,
    so that the resumed run is step for step the uninterrupted one.

    Reads the RESUME manifest a preempted ``train`` left beside its
    checkpoint.  At the manifest's rank count the checkpoint restores
    as it is; at another one (the elastic case) ZeRO-1's flat padded
    optimizer buffers are re-split for the new count
    (:func:`.checkpoint.load_checkpoint_elastic`).  A state of blocks
    (fsdp, tp, layouts) is saved at global shapes and cut anew for the
    task's specs, whatever layout or rank count saved it.  The loader starts at
    the manifest's ``next_item``, and ``num_missed``, ``skipped_items``
    and the guard's ``quarantined_items`` carry over.  Without a
    manifest the cursor is the step counter over ``steps_per_call``
    (right when nothing was OOM-skipped before the checkpoint).

    Returns the manifest, or ``None``: no manifest (a plain latest
    checkpoint resume), or nothing on disk at all, in which case the
    task is left untouched (a fresh run)."""
    faults.fire("resume")
    manifest = read_resume_manifest(checkpoint_dir)
    ckpt_step = (manifest or {}).get("checkpoint_step", step)
    if ckpt_step is None:
        ckpt_step = latest_step(checkpoint_dir)
        if ckpt_step is None:
            return None  # nothing saved yet: a fresh run
    mesh_now, ndev = _topology(task)
    same = manifest is None or (manifest.get("device_count") == ndev
                                and manifest.get("mesh") == mesh_now)
    load = load_checkpoint if same else load_checkpoint_elastic
    task.state = load(checkpoint_dir, task.state, step=ckpt_step,
                      mesh=task.mesh, specs=task.specs)
    if manifest is not None:
        task.loader.start = int(manifest.get("next_item", 0))
        task.num_missed = int(manifest.get("num_missed", 0))
        task.skipped_items = [int(x) for x in
                              manifest.get("skipped_items", [])]
        task.quarantined_items = [int(x) for x in
                                  manifest.get("quarantined_items", [])]
    else:
        task.loader.start = int(task.state.step) // task.steps_per_call
    return manifest


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


def _eval_and_log(task: TrainTask, batch, name: str, step: int, topk,
                  logger: Logger) -> dict:
    loss, accs = task.eval_fn(task.state, batch)
    _require_topk(accs, topk)
    metrics = {f"{name}_loss": float(loss)}
    for k in topk:
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
    ``transform`` applies to every draw.  A task with a
    ``batch_quantum`` (the pipeline modes) rounds every batch, the
    remainder too, down to a multiple of it, as the JAX ``evaluate``
    does: fewer than a quantum of samples is left out.  Returns
    ``{"loss", "top{k}" for each k, "samples", "exact"}``.
    """
    topk = task.topk if topk is None else tuple(topk)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    capable = (hasattr(dataset, "__len__")
               and "indices" in inspect.signature(dataset.batch).parameters)
    q = task.batch_quantum or 1
    full_batches = rem_size = 0
    if capable:
        if len(dataset) < q:
            raise ValueError(
                "dataset is empty" if not len(dataset) else
                f"dataset has {len(dataset)} samples — fewer than the "
                f"batch granularity {q}")
        batch_size = min(batch_size, len(dataset) // q * q)
    requested, batch_size = batch_size, batch_size // q * q
    if batch_size == 0:
        raise ValueError(f"batch_size {requested} rounds down to 0 at batch "
                         f"granularity {q}; pass batch_size >= {q}")
    if capable:
        full_batches = len(dataset) // batch_size
        rem_size = (len(dataset) - full_batches * batch_size) // q * q
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
    # the eval pipeline; the caller's dataset (which a loader may share)
    # keeps augmenting
    dataset = _eval_view(dataset)
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
    """Step-phase brackets: every ``with phases("dispatch"):`` block
    observes its wall seconds into ``fdtpu_train_phase_seconds{phase}``
    and, when a tracer rides along, opens a span of the same name, so
    one set of brackets feeds the live ``/metrics`` percentiles and the
    offline Chrome trace.  Without a tracer the block registers as the
    active phase (``obs.spans.phase_scope``), so the stall watchdog can
    still name where the loop wedged.  When the card reports memory and
    a watchdog rides along, every phase exit samples the headroom into
    the watchdog's OOM-margin alert (allocator counters and one driver
    query: no stream sync)."""

    def __init__(self, observation: Observation, hbm=None):
        from ..obs.spans import phase_scope

        self.tracer = observation.tracer
        self._phase_scope = phase_scope
        self.watchdog = (observation.watchdog
                         if hbm is not None and hbm.available else None)
        self.hist = observation.registry.histogram(
            "fdtpu_train_phase_seconds",
            "wall seconds per train-step phase "
            "(data_wait/h2d/dispatch/device/eval/checkpoint)",
            labelnames=("phase",))
        # per-phase seconds since the last take(): a flight record's split
        self.last: dict = {}

    def take(self) -> dict:
        """Return and clear the per-phase seconds since the last call."""
        out, self.last = self.last, {}
        return out

    @contextlib.contextmanager
    def __call__(self, name: str, **args):
        span = (self.tracer.span(name, **args) if self.tracer is not None
                else self._phase_scope(name))
        t0 = time.perf_counter()
        try:
            with span:
                yield
        finally:
            # observed on the exception path too: an OOM-heavy run must
            # not show artificially fast dispatch percentiles
            dt = time.perf_counter() - t0
            self.hist.labels(phase=name).observe(dt)
            self.last[name] = self.last.get(name, 0.0) + dt
            if self.watchdog is not None:
                from ..obs import memstats

                self.watchdog.note_headroom(memstats.min_headroom_ratio())


def _last_loss(metrics) -> float:
    loss = metrics["loss"]
    return float(loss[-1] if loss.ndim else loss)


def train(task: TrainTask, *, print_every: int = 10, eval_every: int = 50,
          topk: Optional[Sequence[int]] = None,
          sched: Optional[Callable] = None,
          logger: Optional[Logger] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 20,
          verbose: bool = False, profile_dir: Optional[str] = None,
          profile_start: int = 10, profile_steps: int = 5,
          observation: Optional[Observation] = None,
          handle_signals: bool = False, guard=None):
    """The training loop.

    Every ``print_every`` items it logs steps/s and tokens/s (images/s
    for image batches) over the interval; every ``eval_every`` items the
    eval loss and ``topk`` accuracies (default: the task's) of the val
    slice (when there is one) and of the current batch (its last step
    batch under the device loop), and the step's own loss.  Host-clock
    rates: the loop runs ahead of the device by the launch queue, so
    interval averages hold.  ``sched(step)`` is called once an item, in
    optimizer steps, and its value logged with ``verbose`` (the
    reference's schedule callback; it feeds nothing into the step, whose
    schedules live in the optimizer).  ``verbose`` also logs each
    dispatch.  A device OOM skips the item (``task.skipped_items``) and
    counts its steps in ``task.num_missed``.  Each committed step's loss
    lands in ``task.losses`` (read back once, at the end; a rollback
    drops those it rewinds).  The trained parameters and running stats
    are copied into ``task.model`` in place.

    ``profile_dir`` takes a ``torch.profiler`` trace (CPU activity, and
    the card's kernels on a card) of items ``[profile_start,
    profile_start + profile_steps)`` and exports it there as Chrome JSON
    (``trace.json``).

    ``observation`` threads the observation layer (:mod:`..obs`)
    through the loop.  The default (``None``: :meth:`Observation.default`)
    is metrics only: step counters, the per-phase wall-time histograms
    and the OOM-skip counter land in the process registry (the CLI's
    ``--metrics-port``), with no device sync and no thread.
    :meth:`Observation.full` adds nested phase spans (a Chrome trace at
    ``trace_path``), a stall watchdog against the rolling-median item
    time (paused around eval and checkpoints), and a
    ``torch.cuda.synchronize`` each item in a ``device`` phase.  A
    ``jsonl_path`` appends registry snapshots at the print cadence, a
    flight recorder (``flight`` / ``flight_path``) one record an item
    with its phase split and the guard's verdict and z.  The
    ``fdtpu_hbm_*`` gauges read the card at scrape time.

    With a ``checkpoint_dir``, the state is saved every
    ``checkpoint_every`` items (the reference's 20 cycles) after item
    ``j > 0``, without blocking (the host snapshot is taken at once, the
    write overlaps the next steps), and at the end the last write is
    waited for and any RESUME manifest removed.  ``handle_signals=True``
    arms checkpoint-on-preemption: SIGTERM/SIGINT set a flag
    (:class:`..faults.SignalFlag`) that the loop reads at the next step
    boundary, where the state is consistent (no step and no graph replay
    in flight), and there it saves a blocking checkpoint and the RESUME
    manifest (step, loader cursor, skipped and quarantined items, ranks)
    and raises :class:`..faults.Preempted`; on a mesh the ranks agree on
    the boundary.  A second signal during that exit raises
    ``KeyboardInterrupt``.  The loop starts at ``task.loader.start``
    (:func:`resume_training` sets it), and each item's batch is a
    function of its index, so a resumed run draws what the uninterrupted
    one drew.

    ``guard`` (a :class:`.guard.GuardConfig`, or ``True`` for the
    defaults) arms the anomaly guard (:class:`.guard.TrainGuard`): each
    item's sentinel (``metrics["guard"]`` of a step prepared with
    ``guard=True``, else the loss) is read, and judged, BEFORE the new
    state is committed.  An anomalous item is quarantined and its result
    discarded (the state before it carries on); anomalies that persist
    roll back to the last checkpoint, rewind the loader's cursor and
    replay with the quarantined items skipped; rollbacks that loop raise
    :class:`.guard.GuardHalt`.  With a ``checkpoint_dir`` the starting
    state is banked as the first rollback target, cadence checkpoints
    block, and each refreshes the RESUME manifest, so a SIGKILL at any
    point resumes onto a consistent (checkpoint, cursor, quarantine)
    triple.  Items in ``task.quarantined_items`` (a resumed run's
    manifest) or ``GuardConfig.quarantine`` are skipped before dispatch:
    also how a clean run skips the items a guarded run quarantined.

    Returns ``(host_params, model_state, task)``: CPU copies of the
    final parameters, at global shapes (a state of blocks is gathered;
    every rank of its mesh takes part).
    """
    logger = logger or current_logger()
    obs = observation or Observation.default()
    reg = obs.registry
    hbm = memstats.HbmGauges(reg)
    phases = _PhaseClock(obs, hbm=hbm)
    steps_total = reg.counter(
        "fdtpu_train_steps_total", "optimizer steps completed")
    step_hist = reg.histogram(
        "fdtpu_train_step_seconds",
        "wall seconds per loader item (= steps_per_call optimizer steps)")
    step_gauge = reg.gauge(
        "fdtpu_train_step", "optimizer steps completed this train() call")
    oom_total = reg.counter(
        "fdtpu_train_oom_skipped_total",
        "batches skipped by OOM fault tolerance")
    sink = JsonlSink(obs.jsonl_path, reg) if obs.jsonl_path else None
    # the black box: a footer-less dump is the hard-death signature
    flight = obs.flight
    if flight is None and obs.flight_path:
        flight = FlightRecorder(obs.flight_path, meta={"component": "train"})
    runs.set_run_info(reg, "train")
    if topk is None:
        topk = task.topk
    # the device loop: an item is spc optimizer steps
    spc = task.steps_per_call
    cuda = task.device.type == "cuda"
    t_start = time.perf_counter()
    # the profiler window runs once (a rollback may pass its start again)
    profiler, profiled = None, False
    if obs.watchdog is not None:
        obs.watchdog.start()
    traced_loader = (obs.tracer is not None
                     and isinstance(task.loader, PrefetchLoader))
    if traced_loader:
        # the prefetch workers' h2d spans land on their own thread rows
        task.loader.tracer = obs.tracer
    it = iter(task.loader)
    _end = object()
    start_item = int(getattr(task.loader, "start", 0))
    j = start_item
    t_mark, j_mark = t_start, j
    done_steps = 0
    last_batch = None  # the last item's batch: the profile's shapes
    losses = []  # fresh device tensors, read back once at the end
    preempt = faults.SignalFlag().install() if handle_signals else None
    # eval and checkpoints are known-long work: the watchdog pauses
    wd_pause = (obs.watchdog.pause if obs.watchdog is not None
                else contextlib.nullcontext)

    guard_obj = None
    if guard is not None and guard is not False:
        cfg = guard if isinstance(guard, GuardConfig) else GuardConfig()
        guard_obj = TrainGuard(cfg, registry=reg, logger=logger)
        # decisions a previous process recorded (the RESUME manifest)
        for q in task.quarantined_items:
            if not guard_obj.is_quarantined(q):
                guard_obj.quarantine(q)
    # the rollback target: the newest blocking checkpoint, the item a
    # resume from it starts at, and the committed losses it holds
    last_good: Optional[dict] = None

    def run_manifest(reason: str, checkpoint_step: int,
                     next_item: int) -> dict:
        mesh_now, ndev = _topology(task)
        m = {
            "version": 1,
            "reason": reason,
            "checkpoint_step": int(checkpoint_step),
            "next_item": int(next_item),
            "steps_per_call": spc,
            "num_missed": int(task.num_missed),
            "skipped_items": [int(x) for x in task.skipped_items],
            "mesh": mesh_now,
            "device_count": ndev,
            "process_count": ndev,
            # both streams re-derive from restored values: nothing of an
            # rng needs saving
            "rng": {
                "step": "dropout seed of (seed, state.step), on the host",
                "loader": "np.random.default_rng((seed, 0, item))",
            },
        }
        if guard_obj is not None:
            m["quarantined_items"] = guard_obj.quarantined_items()
        return m

    def save(block: bool) -> None:
        save_checkpoint(task.state, checkpoint_dir, int(task.state.step),
                        block=block, mesh=task.mesh, zero1=task.zero1,
                        specs=task.specs)

    def write_guard_manifest() -> None:
        """The guard's (checkpoint, cursor, quarantine) triple, written
        at once: a SIGKILL after a decision resumes onto that decision."""
        if guard_obj is None or not checkpoint_dir or last_good is None:
            return
        write_resume_manifest(checkpoint_dir, run_manifest(
            "guard", last_good["step"], last_good["item"]))

    if guard_obj is not None and checkpoint_dir:
        # bank the starting state: rollback has a target from the first
        # item on, and on a resumed run it is on the current topology
        with wd_pause(), phases("checkpoint"):
            save(block=True)
        last_good = {"step": int(task.state.step), "item": start_item,
                     "losses": 0}
        write_guard_manifest()
    elif guard_obj is not None:
        logger.info("guard: no checkpoint_dir — the rollback tier is "
                    "disabled, the policy ladder is skip-and-quarantine "
                    "-> halt")

    def preempted() -> bool:
        if preempt is None:
            return False
        hit = preempt.is_set()
        if task.mesh is not None and task.mesh.size > 1:
            # every rank stops at the same boundary, or one rank enters a
            # collective (the checkpoint's gather, the next step) alone
            hit = multihost.agree_to_stop(hit, group=task.mesh.group,
                                          device=task.mesh.device)
        return hit

    def checkpoint_and_exit():
        step_now = int(task.state.step)
        manifest = run_manifest(preempt.reason, step_now, j)
        if checkpoint_dir:
            with wd_pause(), phases("checkpoint"):
                # blocking: the process is about to exit
                save(block=True)
                write_resume_manifest(checkpoint_dir, manifest)
            faults.record_preemption()
            logger.info(f"preempted ({manifest['reason']}): checkpointed "
                        f"step {step_now} + RESUME manifest (next item "
                        f"{j}) in {checkpoint_dir}")
        else:
            logger.info(f"preempted ({manifest['reason']}) with no "
                        "checkpoint_dir: nothing persisted, the run "
                        "cannot be resumed")
        raise faults.Preempted(
            f"training preempted at step {step_now} (item {j})",
            step=step_now, next_item=j, checkpoint_dir=checkpoint_dir,
            manifest=manifest)

    try:
        while True:
            # the fault plan's SIGTERM-at-item-j lands here, and the
            # step-boundary check sees it at once
            faults.fire("step", index=j)
            if preempted():
                checkpoint_and_exit()
            t_item = time.perf_counter()
            # host time blocked on the prefetch queue
            with phases("data_wait"):
                batch = next(it, _end)
            if batch is _end:
                break
            last_batch = batch
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
                if sink is not None:
                    sink.write(step=j * spc)
            if profile_dir is not None:
                if j == profile_start and profiler is None and not profiled:
                    profiler = _start_profiler(cuda)
                elif (profiler is not None
                      and j == profile_start + profile_steps):
                    _stop_profiler(profiler, task, profile_dir, logger)
                    profiler, profiled = None, True
            if sched is not None:
                lr = sched(j * spc)  # optimizer steps, not loader items
                if verbose and lr is not None:
                    logger.log({"lr": float(lr)}, j)
            skipped = False
            verdict = None
            if guard_obj is not None and guard_obj.is_quarantined(j):
                # drawn (the cursor advances as when the quarantine was
                # decided) but never stepped
                guard_obj.note_replayed_skip(j)
                logger.info(f"cycle {j}: guard — quarantined batch skipped")
                skipped = True
            else:
                # the try covers only the dispatch and the sentinel read:
                # a failure in a recovery below is never taken for a
                # skippable OOM
                try:
                    if verbose:
                        logger.info(f"  step {j}: dispatching the train step")
                    with phases("dispatch"):
                        new_state, metrics = task.step_fn(task.state, batch)
                        if guard_obj is None:
                            task.state = new_state
                    if obs.device_sync and cuda:
                        with phases("device"):
                            torch.cuda.synchronize(task.device)
                    if guard_obj is not None:
                        # the verdict before the commit: an anomalous
                        # step's result is dropped
                        verdict = guard_obj.observe(
                            j, metrics, can_rollback=last_good is not None)
                        if verdict == "ok":
                            task.state = new_state
                        else:
                            task.quarantined_items = (
                                guard_obj.quarantined_items())
                            if state_donated(task.state):
                                raise RuntimeError(
                                    "guard anomaly on a state given to a "
                                    "donating CUDA graph: the pre-step "
                                    "state cannot be recovered; prepare "
                                    "the task with prepare_training("
                                    "guard=True)")
                except Exception as e:  # OOM-skip fault tolerance
                    if not _is_oom(e):
                        raise
                    if state_donated(task.state):
                        raise RuntimeError(
                            "device OOM on a state given to a donating "
                            "CUDA graph: it cannot be recovered; prepare "
                            "the task with prepare_training(guard=True) "
                            "to keep the pre-step state") from e
                    task.num_missed += spc
                    task.skipped_items.append(j)
                    oom_total.inc(spc)
                    logger.log({"oom_skipped_item": j,
                                "oom_skipped_step_first": j * spc}, j)
                    logger.info(f"cycle {j}: device OOM — skipping batch "
                                f"({task.num_missed} missed)")
                    skipped = True
            # the verdict's recovery, outside the OOM try: a failure while
            # restoring must surface
            if verdict == "skip":
                skipped = True
                write_guard_manifest()
            elif verdict == "rollback":
                logger.info(
                    f"guard: rolling back to checkpoint step "
                    f"{last_good['step']} (item {last_good['item']}); "
                    f"quarantined {guard_obj.quarantined_items()}")
                with wd_pause(), phases("checkpoint"):
                    wait_for_pending()
                    task.state = load_checkpoint(
                        checkpoint_dir, task.state, step=last_good["step"],
                        mesh=task.mesh, specs=task.specs)
                write_guard_manifest()
                del losses[last_good["losses"]:]
                # rewind the cursor and replay; the quarantined items
                # skip on the way through
                it.close()
                task.loader.start = last_good["item"]
                it = iter(task.loader)
                j = last_good["item"]
                continue
            elif verdict == "halt":
                write_guard_manifest()
                raise guard_obj.halt(
                    f"anomalies persist across {guard_obj._rollbacks} "
                    "rollback(s)" if last_good is not None else
                    "rollback needed but no checkpoint_dir to roll back to")
            if not skipped:
                losses.append(metrics["loss"])
                if eval_every and j % eval_every == 0:
                    with wd_pause(), phases("eval"):
                        if task.val_batch is not None:
                            _eval_and_log(task, task.val_batch, "val", j,
                                          topk, logger)
                        # the eval step takes one step's batch: the last
                        eb = ({k: v[-1] for k, v in batch.items()}
                              if spc > 1 else batch)
                        _eval_and_log(task, eb, "train", j, topk, logger)
                        logger.log({"train_step_loss": _last_loss(metrics)},
                                   j)
                if (checkpoint_dir and checkpoint_every and j > 0
                        and j % checkpoint_every == 0):
                    # unguarded: the snapshot is queued now and the write
                    # overlaps the next steps; guarded: blocking, so the
                    # rollback target is always durably on disk
                    with wd_pause(), phases("checkpoint"):
                        save(block=guard_obj is not None)
                    if guard_obj is not None:
                        last_good = {"step": int(task.state.step),
                                     "item": j + 1, "losses": len(losses)}
                        write_guard_manifest()
                steps_total.inc(spc)
                done_steps += spc
                step_gauge.set(done_steps)
                step_hist.observe(time.perf_counter() - t_item)
            if obs.watchdog is not None:
                # a skipped batch is still loop progress
                obs.watchdog.beat()
            if flight is not None:
                _flight_record(flight, reg, hbm, phases, task, j,
                               done_steps, skipped, verdict,
                               None if skipped else metrics)
            j += 1
    finally:
        if profiler is not None:
            # a run that ended (or failed) inside the window exports it
            _stop_profiler(profiler, task, profile_dir, logger)
        if flight is not None:
            _flight_dump(flight, done_steps)
        if preempt is not None:
            preempt.uninstall()
        if obs.watchdog is not None:
            obs.watchdog.stop()
        if traced_loader:
            task.loader.tracer = None
        if obs.tracer is not None and obs.trace_path:
            # exported on an exception too: the timeline up to a crash
            # is what a postmortem needs
            n = obs.tracer.export_chrome_trace(obs.trace_path)
            logger.info(f"span trace ({n} events) written to "
                        f"{obs.trace_path}")
        if sink is not None:
            sink.write(step=j * spc, final=True)
        if losses:
            task.losses.extend(torch.cat([x.reshape(-1) for x in losses])
                               .float().cpu().tolist())
    if task.num_missed:
        logger.info(f"missed {task.num_missed} batches due to OOM")
    if obs.profile_path and last_batch is not None and (
            task.mesh is None or task.mesh.rank == 0):
        # the cost profile of the finished run: its model's and step's
        # static costs at this run's shapes, priced on fake tensors, and
        # the measured phase histograms
        from ..obs import profile as profile_lib

        prof = profile_lib.collect_profile(
            task, registry=reg, batch=last_batch,
            meta={"steps": done_steps, "steps_per_call": spc})
        prof.save(obs.profile_path)
        logger.info(f"cost profile written to {obs.profile_path}")
    if checkpoint_dir:
        wait_for_pending()
        # a completed run must not leave a mid-run cursor behind
        clear_resume_manifest(checkpoint_dir)
        if task.mesh is not None and task.mesh.size > 1:
            torch.distributed.barrier(group=task.mesh.group)
    model_params, host_params = _final_params(task)
    with torch.no_grad():
        for name, p in task.model.named_parameters():
            p.copy_(model_params[name])
        for name, b in task.model.named_buffers():
            if name in task.state.model_state:
                b.copy_(task.state.model_state[name])
    return to_host(host_params), task.state.model_state, task


def _final_params(task: TrainTask) -> tuple:
    """(the params the model holds, the global params): the state's,
    or for a state of blocks its gathers (a collective), the model's
    keeping a tensor-parallel model's own blocks; a pipeline's split
    tree goes back onto the model's names."""
    params = task.state.params
    if task.specs is None:
        return params, params
    from ..parallel.fsdp import gather_state

    whole = gather_state(params, task.specs.params, task.mesh)
    if task.merge_params is not None:
        return task.merge_params(whole), whole
    if not getattr(task.model, "tp_applied", False):
        return whole, whole
    return gather_state(params, task.specs.params, task.mesh,
                        keep_axis=MODEL_AXIS), whole


def _start_profiler(cuda: bool):
    """A ``torch.profiler`` session over the CPU and, on a card, its
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, task: TrainTask, profile_dir: str,
                   logger: Logger) -> None:
    """Wait for the window's device work, stop and export Chrome JSON to
    ``profile_dir/trace.json``."""
    import os

    synchronize(task.state.params)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def _flight_record(flight, reg, hbm, phases, task, j, done_steps, skipped,
                   verdict, metrics) -> None:
    """One flight record for item ``j``.  ``record`` never raises, and
    neither does this: forensics must not kill the loop."""
    try:
        frec: dict = {"step": j, "opt_step": done_steps,
                      "phases": {k: round(v, 4)
                                 for k, v in phases.take().items()}}
        if skipped:
            frec["skipped"] = True
        else:
            try:
                frec["loss"] = _last_loss(metrics)
            except Exception:  # noqa: BLE001
                pass
        if verdict is not None:
            frec["guard_verdict"] = verdict
            z = reg.value("fdtpu_guard_last_z")
            if z is not None:
                frec["guard_z"] = round(float(z), 3)
        if hbm.available:
            hr = memstats.min_headroom_ratio()
            if hr is not None and hr == hr:  # NaN: unavailable, not 0
                frec["headroom"] = round(hr, 4)
        if task.num_missed:
            frec["oom_skipped"] = int(task.num_missed)
        stalled = reg.value("fdtpu_watchdog_stalled")
        if stalled:
            frec["stalled"] = int(stalled)
        flight.record(**frec)
    except Exception:  # noqa: BLE001 — never kill the loop
        pass


def _flight_dump(flight, done_steps: int) -> None:
    """Stamp a soft exit's verdict into the dump's footer (a SIGKILL
    never gets here: a footer-less dump is its signature)."""
    import sys

    try:
        etype, evalue = sys.exc_info()[:2]
        if etype is None:
            flight.dump("done", steps=done_steps)
        elif issubclass(etype, faults.Preempted):
            flight.dump("preempted", error=str(evalue), steps=done_steps)
        else:
            flight.dump("halt" if issubclass(etype, GuardHalt) else "crash",
                        error=f"{etype.__name__}: {evalue}",
                        steps=done_steps)
    except Exception:  # noqa: BLE001
        pass
