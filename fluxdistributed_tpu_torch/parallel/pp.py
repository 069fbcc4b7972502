"""Pipeline parallelism: GPipe-style microbatch pipelining over a
``pipe`` mesh axis.

Port of ``fluxdistributed_tpu/parallel/pp.py``.  The JAX schedule is a
``lax.scan`` over ticks inside ``shard_map``: device *s* applies stage
*s* and hands its activation to device *s + 1* with a ``ppermute`` each
tick, and AD through the scan derives the reverse pipeline.  Here the
pipe rank at index *s* of a :class:`..mesh.Mesh` hosts stage *s*, the
ticks are a Python loop, and the hand-off is one hop of
:func:`.collectives.ring_shift_start`, whose backward is the reverse hop:
autograd through the loop derives the reverse pipeline, as AD does in
JAX.  Two things JAX's SPMD typing does for free are written out:

* the last stage's outputs are handed to every pipe rank (JAX: a
  ``psum`` of outputs that are zero off the last stage), and each rank
  computes the same replicated loss from them.  The backward passes the
  last stage its own cotangent once; summing the ranks' cotangents
  would make every stage gradient S times too large;
* the pipeline's input is replicated over the pipe ranks and only stage
  0 reads it, so only rank 0 gets its cotangent.  The backward sums it
  over the pipe ranks (JAX's transpose of a replicated input), so every
  rank ends with the same gradient for a replicated leaf that produced
  the input (the LM's embedding).

Every rank runs the stage and the hand-off every tick, as JAX does: on
zeros in the fill and the drain, whose outputs never reach the loss.
So every tick's output is in the graph whenever the params or the input
need a gradient, and each hop's backward runs on every rank, in one
order (a rank that skipped a tick would leave its partner waiting in
that hop's backward).

Model contract (JAX's): ``stage_fn(params, x) -> y`` keeps the
activation's shape; a ``stage_fn(params, x, stage)`` receives the stage
index (:func:`switch_stage` builds one from per-stage callables, and
:func:`chunk_stages` with ``counts`` is one).  Params are trees (dicts)
of tensors whose stacked leaves carry the stage on their leading dim.

M microbatches through S stages take M + S - 1 ticks; pick
``num_microbatches >= 2 S``.

The pipelined LM keeps its params as the split tree ``{"outer": ...,
"stages": ...}`` of the JAX package, held flat as the port's train
states are: keys ``outer/<name>`` and ``stages/<name>``
(:func:`split_tree`, :func:`join_tree`).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..mesh import PIPE_AXIS, Mesh
from ..obs import comms
from ..optim import Optimizer
from ..tree import tree_map
from .collectives import ring_shift_start
from .dp import TrainState

__all__ = [
    "OUTER",
    "PIPE_AXIS",
    "STAGES",
    "chunk_stages",
    "join_tree",
    "make_train_step_pp",
    "pipeline_apply",
    "split_tree",
    "stack_stage_params",
    "switch_stage",
]

OUTER, STAGES = "outer/", "stages/"


def split_tree(params: dict) -> Tuple[dict, dict]:
    """``(outer, stages)`` of a flat split tree (the prefixes dropped)."""
    outer, stages = {}, {}
    for k, v in params.items():
        if k.startswith(OUTER):
            outer[k[len(OUTER):]] = v
        elif k.startswith(STAGES):
            stages[k[len(STAGES):]] = v
        else:
            raise KeyError(f"{k!r} is neither an outer/ nor a stages/ leaf")
    return outer, stages


def join_tree(outer: dict, stages: dict) -> dict:
    """The flat split tree of ``outer`` and ``stages``."""
    return {**{OUTER + k: v for k, v in outer.items()},
            **{STAGES + k: v for k, v in stages.items()}}


def _accepts_stage(fn: Callable) -> bool:
    """Does ``fn`` require a third positional arg (the stage index)?

    Only callables with >= 3 non-defaulted positional parameters opt in:
    a defaulted third parameter or ``*args`` must not silently receive
    the stage index."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    required = [
        p for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        and p.default is p.empty
    ]
    return len(required) >= 3


def _chunks(params: Any) -> list:
    """The per-chunk trees of a stacked tree (dicts of tensors), by one
    ``unbind`` a leaf: its backward stacks the chunks' gradients once,
    where indexing each chunk would write a zero-filled gradient of the
    whole stack a chunk and add them up."""
    if isinstance(params, dict):
        subs = {k: _chunks(v) for k, v in params.items()}
        n = len(next(iter(subs.values())))
        return [{k: sub[c] for k, sub in subs.items()} for c in range(n)]
    return list(params.unbind(0))


def chunk_stages(stage_fn: Callable, counts=None) -> Callable:
    """Host V consecutive logical stages per pipe device (the blocked
    virtual pipeline): the returned stage applies ``stage_fn`` over the
    leading chunk dim of its params in order, so device *s* applies
    logical stages ``s V ... s V + V - 1`` each tick.

    ``counts`` (one int per pipe device) is the non-uniform split of a
    pipeline plan (:mod:`.pp_plan`): every device's params are padded to
    ``max(counts)`` chunks and device *s* applies only its first
    ``counts[s]``.  The padded chunks are never applied, so their
    gradients stay zero.  That stage takes the stage index as its third
    argument (the JAX function reads ``axis_index`` instead), which the
    schedules pass."""
    if counts is None:
        def fn(params, x):
            for p in _chunks(params):
                x = stage_fn(p, x)
            return x

        return fn

    counts = tuple(int(c) for c in counts)

    def fn(params, x, stage):
        for p in _chunks(params)[:counts[stage]]:
            x = stage_fn(p, x)
        return x

    return fn


def switch_stage(stage_fns: list) -> Callable:
    """Compose per-stage callables into one ``stage_fn(params, x,
    stage)`` that picks ``stage_fns[stage]``: the heterogeneous pipeline
    form.  Every callable takes the same params structure (a superset
    tree) and keeps the activation's shape.  The callable records
    ``len(stage_fns)``, which :func:`pipeline_apply` holds against the
    pipe axis (JAX's ``lax.switch`` would clamp a short list's index)."""
    fns = list(stage_fns)

    def fn(params, x, stage):
        return fns[stage](params, x)

    fn._num_stage_fns = len(fns)
    return fn


def stack_stage_params(per_stage: list, mesh: Mesh,
                       axis: str = PIPE_AXIS) -> Any:
    """Stack S per-stage param trees on a new leading dim split over the
    ``pipe`` axis and keep this rank's block: stage *s* on the pipe rank
    at index *s*."""
    from ..sharding import stack_on_axis

    return stack_on_axis(per_stage, mesh, axis)


class _Replicated(torch.autograd.Function):
    """The pipeline's input, replicated over the pipe ranks: the
    identity; the backward sums the cotangent over them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        comms.all_reduce(out, group=ctx.group)
        return out, None


class _HandOut(torch.autograd.Function):
    """The last stage's outputs on every pipe rank: a broadcast from it.
    The backward gives the last stage its own cotangent, once, and the
    others zeros (their outputs were never read)."""

    @staticmethod
    def forward(ctx, y, group, src, last):
        ctx.last = last
        out = y.detach().contiguous().clone()
        comms.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def pipeline_apply(
    stage_fn: Callable,
    mesh: Mesh,
    axis: str = PIPE_AXIS,
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
    remat: bool = False,
):
    """Build ``fwd(stacked_params, x) -> y`` running the GPipe schedule.

    ``stacked_params``: this rank's block of the stage-stacked params
    (leading dim 1, :func:`stack_stage_params`); ``x``: this rank's rows
    of the batch (the same on every pipe rank; only stage 0 reads it).
    ``y`` is the last stage's output for those rows, on every pipe rank.
    ``batch_axis`` names the data axis of a ``(data, pipe)`` mesh whose
    rows each pipeline their own rows (their batches arrive split, so
    nothing here changes).  ``remat=True`` recomputes each tick's stage
    in the backward (``torch.utils.checkpoint``): one more stage forward
    a tick, activations of one stage input a tick kept."""
    S = mesh.axis_size(axis)
    M = num_microbatches or S
    if batch_axis is not None:
        mesh.axis_size(batch_axis)  # raises when it is not on the mesh
    n_fns = getattr(stage_fn, "_num_stage_fns", None)
    if n_fns is not None and n_fns != S:
        raise ValueError(
            f"switch_stage got {n_fns} stage fns but the '{axis}' axis has "
            f"{S} stages (lax.switch would silently clamp the stage index)")
    idx = mesh.axis_index(axis)
    group = mesh.group_of(axis)
    last = S - 1 if group is None else dist.get_global_rank(group, S - 1)
    with_stage = _accepts_stage(stage_fn)

    def apply(params, x):
        return stage_fn(params, x, idx) if with_stage else stage_fn(params, x)

    if remat:
        from torch.utils.checkpoint import checkpoint

        plain = apply

        def apply(params, x):
            return checkpoint(plain, params, x, use_reentrant=False)

    def fwd(stacked_params, x):
        params = tree_map(lambda p: p[0], stacked_params)
        b = x.shape[0]
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        if S > 1:
            x = _Replicated.apply(x, group)
        mb = x.reshape(M, b // M, *x.shape[1:])
        zero = torch.zeros_like(mb[0])
        first = torch.tensor(idx == 0, device=x.device)
        state, outs = zero, []
        for t in range(M + S - 1):
            feed = mb[t] if t < M else zero
            x_in = feed if S == 1 else torch.where(first, feed, state)
            y = apply(params, x_in)
            if t >= S - 1:
                outs.append(y)
            if t < M + S - 2:
                (state,) = ring_shift_start([y], mesh, axis).wait()
        out = torch.cat(outs)
        if S > 1:
            out = _HandOut.apply(out, group, last, idx == S - 1)
        return out

    return fwd


def make_train_step_pp(
    stage_fn: Callable,
    loss: Callable,
    optimizer: Optimizer,
    mesh: Mesh,
    axis: str = PIPE_AXIS,
    num_microbatches: Optional[int] = None,
    remat: bool = False,
):
    """``step_fn(state, batch) -> (state, metrics)``: a pipelined
    training step on ``state.params``, this rank's block of the
    stage-stacked params (a flat dict).  ``loss(y, labels)`` consumes the
    pipeline's output of ``batch["image"]`` against ``batch["label"]``
    (the whole batch on every rank).  The gradients stay on their stage,
    so the update is local to each pipe rank.  (The JAX function returns
    ``compile_for(state)``; an eager step has nothing to compile.)"""
    fwd = pipeline_apply(stage_fn, mesh, axis=axis,
                         num_microbatches=num_microbatches, remat=remat)

    def step(state: TrainState, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        lval = loss(fwd(leaves, batch["image"]), batch["label"])
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            lval, [leaves[n] for n in names])))
        with torch.no_grad():
            new_params, new_opt = optimizer.apply(
                state.params, grads, state.opt_state, state.step)
        return TrainState(params=new_params, opt_state=new_opt,
                          model_state=state.model_state,
                          step=state.step + 1), {"loss": lval.detach()}

    return step
