"""Fully-sharded data parallelism (ZeRO-3), and the sharded train step
that FSDP, tensor parallelism, their hybrid and the dp x fsdp x tp
layouts share.

Port of ``fluxdistributed_tpu/parallel/fsdp.py``.  The JAX package
shards every large parameter and optimizer-state leaf over the ``data``
axis by annotation and compiles the unchanged DP step with those
shardings; XLA inserts an all-gather where a full parameter is needed
and a reduce-scatter for its gradient.  Eager PyTorch has no
partitioner, so the port writes that schedule out, with its own
collectives:

* each rank holds its block of every sharded leaf
  (:func:`fsdp_leaf_spec` picks the dim, :func:`shard_state` cuts the
  blocks), and the optimizer runs on the blocks;
* the step reaches each sharded leaf through :class:`AllGatherShard`,
  whose forward all-gathers the blocks along the spec's dim over the
  axis's group and whose backward reduce-scatters (sums) the gradient
  along it, so each rank's gradient is its block of the sum over the
  axis's ranks;
* a gradient is then summed over the batch axes it was not yet summed
  over (an all-reduce; all of them for a replicated leaf) and divided
  by the batch group's size as ``collectives.pmean`` divides
  (``div_const``): the DP step's sum-then-divide, so a step whose specs
  shard nothing is the DP step;
* the loss is averaged, and BatchNorm statistics taken, over the batch
  group; the norms of LARS and global-norm clipping sum their squares
  over the ranks that hold a leaf's blocks (:func:`..optim.sharded_norms`),
  which ZeRO-1's sliced update refuses.

The whole state is gathered once a step: persistent params and
optimizer state are 1/N a rank, but the gathered params live through
the step.  Freeing them between forward and backward, with a per-block
prefetch, is later work (ROADMAP).  ``torch.distributed.fsdp`` is not
used: its reduction divides before or while it sums (pre/post division,
``ReduceOp.AVG``), which rounds otherwise than the sum-then-divide the
port's DP and ZeRO-1 steps are held to, and its sharded parameters hide
their blocks from the port's plain-tensor optimizer.

A spec entry naming ``tp_axis`` (the model axis) is not gathered: the
tensor-parallel modules (:mod:`.tp`) compute on those blocks as they
are, and no gradient is reduced over that axis.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .. import optim as optim_lib
from ..mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..ops.metrics import topkaccuracy
from ..optim import Optimizer, div_const
from ..sharding import (P, Stacked, entry_axes, gather_dim, local_block,
                        map_with_specs, reduce_scatter_dim, spec_axes)
from ..tree import tree_map
from . import collectives, dp
from .zero1 import restore_layout

__all__ = [
    "AllGatherShard",
    "MIN_SHARD_ELEMS",
    "fsdp_leaf_spec",
    "fsdp_specs",
    "gather_state",
    "hybrid_fsdp_tp_specs",
    "make_eval_step_fsdp",
    "make_eval_step_sharded",
    "make_train_step_fsdp",
    "make_train_step_sharded",
    "shard_state",
]

# Leaves smaller than this stay replicated: sharding a 64-float BatchNorm
# bias saves nothing and costs a latency-bound collective per use.
MIN_SHARD_ELEMS = 2**11


def fsdp_leaf_spec(shape, axis: str = DATA_AXIS, nshards: int = 1,
                   min_size: int = MIN_SHARD_ELEMS,
                   base: Optional[P] = None) -> P:
    """The spec of one leaf, from its shape alone (the JAX rule, copied).

    Shards the largest dim divisible by ``nshards`` (ties go to the
    trailing dim).  Leaves under ``min_size`` elements, or with no
    divisible dim, stay replicated.  ``base`` composes with an existing
    spec (the hybrid FSDP x TP path): only dims it leaves unsplit are
    candidates, and its entries are kept.  The rule reads the port's
    shapes: a torch weight is ``(out, in)`` and a conv OIHW where the
    JAX kernel is ``(in, out)`` / HWIO, so at a tie the chosen dim can be
    the other one; the shard sizes are the same (ROADMAP C9)."""
    shape = tuple(shape)
    entries = (list(base) + [None] * (len(shape) - len(base))
               if base is not None else [None] * len(shape))
    keep = P(*entries) if base is not None else P()
    if not shape or math.prod(shape) < min_size:
        return keep
    best = None  # (extent, dim)
    for d, extent in enumerate(shape):
        if entries[d] is None and extent % nshards == 0 and extent >= nshards:
            if best is None or extent >= best[0]:
                best = (extent, d)
    if best is None:
        return keep
    entries[best[1]] = axis
    return P(*entries)


def fsdp_specs(state: dp.TrainState, mesh: Mesh, axis: str = DATA_AXIS,
               min_size: int = MIN_SHARD_ELEMS) -> dp.TrainState:
    """A ``TrainState`` of specs: params and optimizer state sharded by
    :func:`fsdp_leaf_spec`; the mutable model state (BatchNorm running
    stats) and the step replicated."""
    n = mesh.axis_size(axis)

    def leaf(x):
        return fsdp_leaf_spec(tuple(x.shape), axis, n, min_size)

    return dp.TrainState(
        params=tree_map(leaf, state.params),
        opt_state=tree_map(leaf, state.opt_state),
        model_state=tree_map(lambda _: P(), state.model_state), step=P())


def hybrid_fsdp_tp_specs(params: dict, mesh: Mesh, tp_rules: Callable,
                         data_axis: str = DATA_AXIS,
                         min_size: int = MIN_SHARD_ELEMS) -> dict:
    """Sharding on a ``(data, model)`` mesh: tensor parallelism by
    ``tp_rules`` (e.g. :func:`.tp.lm_tp_rules`) and FSDP over
    ``data_axis`` on each leaf's largest dim the rule left unsplit.  A
    rank holds about 1/(|data| |model|) of each large leaf.  Returns the
    params' spec dict (:func:`.tp.state_specs` extends it to a state)."""
    from .tp import param_specs

    n = mesh.axis_size(data_axis)
    tp_specs = param_specs(params, tp_rules)
    return {k: fsdp_leaf_spec(tuple(p.shape), data_axis, n, min_size,
                              base=tp_specs[k])
            for k, p in params.items()}


def shard_state(state: dp.TrainState, specs: dp.TrainState,
                mesh: Mesh) -> dp.TrainState:
    """This rank's blocks of a global ``state`` (each leaf copied from
    rank 0 first, so every rank cuts from the same values), in new
    tensors; replicated leaves are whole copies."""
    from ..sharding import replicate

    def put(x, spec):
        return local_block(replicate(x, mesh), spec, mesh)

    return dp.TrainState(
        params=map_with_specs(put, state.params, specs.params),
        opt_state=map_with_specs(put, state.opt_state, specs.opt_state),
        model_state=map_with_specs(put, state.model_state,
                                   specs.model_state),
        step=state.step)


def gather_state(tree, specs, mesh: Mesh, keep_axis: Optional[str] = None):
    """The global tensors of a tree of blocks (a collective: every rank
    of ``mesh`` calls it): the inverse of :func:`shard_state`'s cut.
    Entries over ``keep_axis`` stay split (a tensor-parallel model's
    blocks)."""
    from ..sharding import gather_global

    def one(x, spec):
        if keep_axis is not None:
            spec = P(*(None if keep_axis in entry_axes(e) else e
                       for e in spec))
        return gather_global(x, spec, mesh)

    return map_with_specs(one, tree, specs)


class AllGatherShard(torch.autograd.Function):
    """``x``'s blocks all-gathered along ``dim`` over ``group`` (``n``
    ranks); the backward reduce-scatters (sums) the gradient along that
    dim, so each rank gets its block of the sum."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None,
                None, None)


def _sub(mesh: Mesh, axes) -> Mesh:
    """The sub-mesh over ``axes`` in the mesh's order."""
    order = mesh.axis_names
    return mesh.sub(tuple(sorted(set(axes), key=order.index)))


class _Plan:
    """How a sharded step reaches each param: the (dim, axes) gathers of
    its spec's non-model entries, the batch axes its gradient is still
    summed over, and the axes its blocks span (its norms' reduction)."""

    def __init__(self, mesh: Mesh, p_specs: dict, batch_axes: tuple,
                 tp_axis: Optional[str]):
        self.mesh = mesh
        self.gathers, self.rest, self.held, self._subs = {}, {}, {}, {}
        for k, spec in p_specs.items():
            gathers = []
            for d, e in enumerate(spec):
                axes = entry_axes(e)
                if not axes or (tp_axis is not None and tp_axis in axes):
                    if len(axes) > 1:
                        raise ValueError(f"{k}: spec entry {e!r} mixes the "
                                         f"model axis with others")
                    continue
                if isinstance(e, Stacked):
                    raise ValueError(f"{k}: a stacked entry {e!r} over a "
                                     "data axis is not supported")
                gathers.append((d, axes))
            done = {a for _, axes in gathers for a in axes}
            extra = done - set(batch_axes)
            if extra:
                raise ValueError(
                    f"{k}: spec {spec!r} shards over {sorted(extra)}, which "
                    f"the batch does not split over (batch axes "
                    f"{tuple(batch_axes)})")
            self.gathers[k] = gathers
            self.rest[k] = tuple(a for a in batch_axes if a not in done)
            self.held[k] = spec_axes(spec)

    def sub(self, axes) -> Mesh:
        """The sub-mesh over ``axes`` (made once)."""
        if axes not in self._subs:
            self._subs[axes] = _sub(self.mesh, axes)
        return self._subs[axes]

    def view(self, params: dict) -> dict:
        """The params the model computes with: each sharded leaf
        gathered (through :class:`AllGatherShard`), in its block's
        memory layout."""
        out = {}
        for k, p in params.items():
            x = p
            for d, axes in self.gathers.get(k, ()):
                sub = self.sub(axes)
                x = AllGatherShard.apply(x, d, sub.group, sub.size)
            out[k] = restore_layout(x, p) if x is not p else p
        return out

    def reduce(self, k: str, g: Optional[torch.Tensor], n: int):
        """Gradient ``g`` of leaf ``k`` summed over its remaining batch
        axes, divided by the batch group's size ``n``."""
        if g is None:
            return None
        rest = self.rest.get(k, ())
        if rest:
            g = collectives.psum(g, self.sub(rest))
        return div_const(g, n)

    def norm_sq(self, k: str, sq: torch.Tensor) -> torch.Tensor:
        """A leaf's sum of squares over the ranks holding its blocks."""
        held = self.held.get(k, ())
        return collectives.psum(sq, self.sub(held)) if held else sq

    def global_sq(self, grads: dict) -> torch.Tensor:
        """The squares of every gradient summed (f32), each leaf's over
        the ranks holding its blocks: one all-reduce a set of axes."""
        by_axes: dict = {}
        for k, g in grads.items():
            if g is not None:
                sq = torch.sum(torch.square(g.float()))
                held = self.held.get(k, ())
                by_axes[held] = by_axes.get(held, 0.0) + sq
        total = torch.zeros((), dtype=torch.float32,
                            device=self.mesh.device)
        for held, sq in by_axes.items():
            total = total + (collectives.psum(sq, self.sub(held))
                             if held else sq)
        return total


def _gathered_loss(loss_fn: Callable, plan: _Plan) -> Callable:
    """``loss_fn`` on the blocks: the params are gathered first."""
    with_rng = dp._accepts_rng(loss_fn)

    def fn(params, model_state, batch, train: bool, rng=None):
        kw = {"rng": rng} if with_rng else {}
        return loss_fn(plan.view(params), model_state, batch, train, **kw)

    fn.global_model_state = getattr(loss_fn, "global_model_state", False)
    return fn


def _batch_axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_train_step_sharded(loss_fn: Callable, optimizer: Optimizer,
                            mesh: Mesh, specs: dp.TrainState, *,
                            batch_axes: Sequence[str] = (DATA_AXIS,),
                            tp_axis: Optional[str] = MODEL_AXIS,
                            accum_steps: int = 1, seed: int = 0,
                            guard: bool = False):
    """``step_fn(state, batch) -> (state, metrics)`` on a state of blocks
    placed by ``specs`` (a ``TrainState`` of :class:`~..sharding.P`):
    the DP step with each sharded leaf gathered for the forward and its
    gradient reduce-scattered (see the module docstring).  ``batch``
    holds this rank's rows of the batch split over ``batch_axes``;
    ``metrics["loss"]`` is the mean over the batch group.  The dropout
    seeds fold in the rank's index in the batch group (ranks that differ
    on the model axis draw the same masks).  ``accum_steps`` and
    ``seed`` are the DP step's.  The model's entries over ``tp_axis``
    must already be the tensor-parallel modules' blocks
    (:func:`.tp.tensor_parallel`).  ``guard=True`` adds
    ``metrics["guard"]``, :func:`.dp.guard_sentinel`'s ``[poisoned_loss,
    grad_norm]`` with each leaf's squares summed over its blocks."""
    dp._check_step_options(accum_steps, 1)
    axes = _batch_axes(batch_axes)
    bmesh = _sub(mesh, axes)
    plan = _Plan(mesh, specs.params, axes, tp_axis)
    grads_of = dp._grads_of(_gathered_loss(loss_fn, plan), accum_steps)

    def body(state: dp.TrainState, batch, seeds, scalars):
        loss, mstate, grads = grads_of(state.params, state.model_state,
                                       batch, seeds)
        with torch.no_grad():
            grads = {k: plan.reduce(k, g, bmesh.size)
                     for k, g in grads.items()}
            loss = collectives.pmean(loss, bmesh)
            mstate = dp.sync_model_state(loss_fn, mstate, bmesh)
            with optim_lib.sharded_norms(plan.norm_sq):
                new_params, new_opt = optimizer.rule(
                    state.params, grads, state.opt_state, scalars)
            metrics = {"loss": loss}
            if guard:
                gnorm = torch.sqrt(plan.global_sq(grads))
                metrics["guard"] = torch.stack([loss.float() + 0.0 * gnorm,
                                                gnorm])
        return dp.TrainState(params=new_params, opt_state=new_opt,
                             model_state=mstate,
                             step=state.step + 1), metrics

    return dp.device_loop(body, optimizer, seed=seed,
                          accum_steps=accum_steps, mesh=bmesh,
                          steps_per_call=1)


def make_eval_step_sharded(loss_fn: Callable, mesh: Mesh,
                           specs: dp.TrainState, *,
                           batch_axes: Sequence[str] = (DATA_AXIS,),
                           tp_axis: Optional[str] = MODEL_AXIS,
                           topk: tuple = (1, 5, 10)):
    """The eval step on a state of blocks: the params gathered, one
    forward in eval mode, the loss and top-k accuracies averaged over
    the batch group (see :func:`.dp.make_eval_step`)."""
    axes = _batch_axes(batch_axes)
    bmesh = _sub(mesh, axes)
    plan = _Plan(mesh, specs.params, axes, tp_axis)

    @torch.no_grad()
    def step(state: dp.TrainState, batch):
        loss, (_, logits) = loss_fn(plan.view(state.params),
                                    state.model_state, batch, False)
        metrics = {f"top{k}": topkaccuracy(logits, batch["label"], k=k)
                   for k in topk}
        return (collectives.pmean(loss, bmesh),
                collectives.pmean(metrics, bmesh))

    return step


def make_train_step_fsdp(loss_fn: Callable, optimizer: Optimizer,
                         mesh: Mesh, specs: dp.TrainState,
                         axis: str = DATA_AXIS, accum_steps: int = 1,
                         seed: int = 0):
    """The DP train step on the FSDP-sharded state of
    :func:`fsdp_specs` / :func:`shard_state`, the batch split over
    ``axis`` as in DP; ``accum_steps`` and ``seed`` are the DP step's."""
    return make_train_step_sharded(loss_fn, optimizer, mesh, specs,
                                   batch_axes=(axis,), tp_axis=None,
                                   accum_steps=accum_steps, seed=seed)


def make_eval_step_fsdp(loss_fn: Callable, mesh: Mesh, specs: dp.TrainState,
                        axis: str = DATA_AXIS, topk: tuple = (1, 5, 10)):
    """The eval step on the FSDP-sharded state directly."""
    return make_eval_step_sharded(loss_fn, mesh, specs, batch_axes=(axis,),
                                  tp_axis=None, topk=topk)
