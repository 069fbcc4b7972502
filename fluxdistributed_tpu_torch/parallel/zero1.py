"""ZeRO-1: the optimizer state and update sharded over the data axis.

Port of ``fluxdistributed_tpu/parallel/zero1.py`` (Xu et al., arXiv:
2004.13336).  Plain DP (:func:`.dp.make_train_step` with a mesh) keeps
the whole optimizer state on every rank and runs the same full update N
times.  ZeRO-1 instead, per step and per parameter leaf:

1. ravels the leaf's gradient to 1-D, zero-pads it to a multiple of the
   number of ranks N (:func:`_flatten_leaf`), and **reduce-scatters**
   it: each rank receives the sum of its 1/N slice, then divides by N;
2. runs the inner optimizer rule on that slice only, against this
   rank's slice of the flat padded params and its 1/N of the state;
3. **all-gathers** the updated slices back into whole params.

The update is elementwise, so each element gets the same arithmetic as
in DP: only where it runs changes.  Zero padding is inert (a zero
gradient keeps the Adam and momentum slots at zero).

The JAX package has two variants: ``make_train_step_zero1`` lets the
GSPMD partitioner derive this schedule from sharding annotations, and
``make_train_step_zero1_shardmap`` writes it out with explicit
collectives.  Eager PyTorch has no partitioner, so both names here run
the same explicit schedule above.  Because each rank's rule sees only
its slice, rules that need norms over whole leaves or the whole
gradient (LARS, global-norm clipping) are refused by both; the JAX
GSPMD variant takes them because XLA inserts the norm collectives.
``zero1_ema_params`` (the EMA of :func:`..optim.with_ema` gathered from
the shards) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..mesh import Mesh
from ..optim import Optimizer, div_const
from . import collectives, dp

__all__ = [
    "make_train_step_zero1",
    "make_train_step_zero1_shardmap",
    "per_device_state_bytes",
    "zero1_optimizer",
    "zero1_state",
]


def _flatten_leaf(x: torch.Tensor, nshards: int) -> torch.Tensor:
    """Ravel to 1-D and zero-pad to a multiple of ``nshards``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % nshards
    return F.pad(flat, (0, pad)) if pad else flat


def _flatten_tree(tree: dict, nshards: int) -> dict:
    return {k: None if x is None else _flatten_leaf(x, nshards)
            for k, x in tree.items()}


def restore_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` (``like``'s shape, contiguous) in ``like``'s memory layout:
    a channels-last conv weight stays channels-last, so the convolutions
    after an update run as before (and sum in the same order)."""
    if (like.dim() == 4 and not like.is_contiguous()
            and like.is_contiguous(memory_format=torch.channels_last)):
        return x.contiguous(memory_format=torch.channels_last)
    return x


def _unflatten_like(flat_tree: dict, template: dict) -> dict:
    """Invert :func:`_flatten_tree`: drop the pad, restore each shape
    and layout."""
    return {k: None if p is None else restore_layout(
        flat_tree[k][:p.numel()].reshape(p.shape), p)
        for k, p in template.items()}


def _local_chunk(flat_tree: dict, mesh: Mesh) -> dict:
    """Slice ``rank`` of N from each flat padded leaf (a view)."""

    def one(x):
        k = x.shape[0] // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    return {k: None if x is None else one(x) for k, x in flat_tree.items()}


def _refuse_cross_slice(optimizer: Optimizer) -> None:
    for frag in ("lars", "clip"):
        if frag in optimizer.name:
            raise ValueError(
                f"optimizer {optimizer.name!r} needs cross-slice reductions "
                "(layer/global norms); ZeRO-1 updates each 1/N slice "
                "locally on its rank, so it takes elementwise rules only")


def zero1_optimizer(inner: Optimizer, mesh: Mesh) -> Optimizer:
    """Wrap ``inner`` so that its state and its update cover this rank's
    1/N of every flat padded leaf.

    ``init(params)`` initialises the inner rule on this rank's slices.
    ``apply(params, grads, state, step)`` takes whole params and this
    rank's OWN (not yet exchanged) gradients: it reduce-scatters the
    flat gradients and divides them by N, updates the slices, and
    all-gathers whole params.  Refuses LARS and clipping (see the module
    docstring)."""
    _refuse_cross_slice(inner)
    n = mesh.size

    def init(params):
        return inner.init(_local_chunk(_flatten_tree(params, n), mesh))

    def rule(params, grads, state, s):
        flat_g = collectives.reduce_scatter(_flatten_tree(grads, n), mesh)
        flat_g = {k: None if g is None else div_const(g, n)
                  for k, g in flat_g.items()}
        flat_p = _local_chunk(_flatten_tree(params, n), mesh)
        new_flat_p, new_state = inner.rule(flat_p, flat_g, state, s)
        gathered = collectives.all_gather(new_flat_p, mesh)
        return _unflatten_like(gathered, params), new_state

    return Optimizer(init, rule, f"zero1({inner.name})", inner.scalars)


def zero1_state(params: dict, optimizer: Optimizer, mesh: Mesh,
                model_state: Optional[dict] = None) -> dp.TrainState:
    """The ZeRO-1 ``TrainState`` of this rank: params and model state
    copied from rank 0 (:func:`..sharding.replicate`), the optimizer
    state initialised by :func:`zero1_optimizer` on this rank's 1/N of
    every flat padded leaf."""
    from ..sharding import replicate

    params = replicate({k: p.detach() for k, p in dict(params).items()},
                       mesh)
    return dp.TrainState(
        params=params,
        opt_state=zero1_optimizer(optimizer, mesh).init(params),
        model_state=replicate(model_state or {}, mesh), step=0)


def make_train_step_zero1(loss_fn: Callable, optimizer: Optimizer,
                          mesh: Mesh, *, accum_steps: int = 1,
                          seed: int = 0, steps_per_call: int = 1):
    """The DP step with a ZeRO-1 sharded update: this rank's gradients
    (with ``accum_steps`` microbatches), the loss and model state
    averaged over the ranks, then :func:`zero1_optimizer`'s exchange and
    update.  ``state`` comes from :func:`zero1_state`.
    ``steps_per_call > 1`` runs that many steps a call on stacked
    batches, as :func:`.dp.make_train_step` does (the JAX step passes it
    through to the DP step): on a card one CUDA graph replay, with the
    reduce-scatters and all-gathers captured.
    """
    dp._check_step_options(accum_steps, steps_per_call)
    z = zero1_optimizer(optimizer, mesh)
    grads_of = dp._grads_of(loss_fn, accum_steps)

    def body(state: dp.TrainState, batch, seeds, scalars):
        loss, mstate, grads = grads_of(state.params, state.model_state,
                                       batch, seeds)
        with torch.no_grad():
            loss = collectives.pmean(loss, mesh)
            mstate = dp.sync_model_state(loss_fn, mstate, mesh)
            new_params, new_opt = z.rule(state.params, grads,
                                         state.opt_state, scalars)
        return dp.TrainState(params=new_params, opt_state=new_opt,
                             model_state=mstate,
                             step=state.step + 1), {"loss": loss}

    return dp.device_loop(body, z, seed=seed, accum_steps=accum_steps,
                          mesh=mesh, steps_per_call=steps_per_call)


def make_train_step_zero1_shardmap(loss_fn: Callable, optimizer: Optimizer,
                                   mesh: Mesh, *, seed: int = 0):
    """The explicit-collectives ZeRO-1 step under its JAX name: the same
    schedule as :func:`make_train_step_zero1`, and like the JAX shard_map
    variant it takes no ``accum_steps`` and no ``steps_per_call`` and
    refuses LARS and clipping."""
    _refuse_cross_slice(optimizer)
    return make_train_step_zero1(loss_fn, optimizer, mesh, seed=seed)


def per_device_state_bytes(tree) -> dict:
    """Bytes of the tensors in ``tree`` held by this rank, by device:
    ``{device: bytes}`` (the JAX function counts every addressable
    device; a rank addresses one)."""
    out: dict = {}

    def add(x):
        out[x.device] = out.get(x.device, 0) + x.numel() * x.element_size()
        return x

    collectives.tree_map(add, tree)
    return out
