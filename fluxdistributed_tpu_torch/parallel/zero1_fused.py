"""Fused ZeRO-1: pack, one reduce-scatter, one fused Adam kernel, one
all-gather.

Port of ``fluxdistributed_tpu/parallel/zero1_fused.py``.  The composable
ZeRO-1 step (:mod:`.zero1`) exchanges and updates each parameter leaf on
its own: on lm_small that is 147 reduce-scatters, 147 chains of Adam's
elementwise ops and 147 all-gathers per step.  This step does the whole
update in four moves:

1. **pack** every gradient leaf, raveled and cast to f32, into one flat
   buffer in the JAX leaf order (sorted dict keys), zero-padded to a
   multiple of N × 1024 (:func:`pack_tree`: the same length and layout
   as the JAX package's, whose 1024 is one [8, 128] TPU tile);
2. **one reduce-scatter** of that buffer; each rank divides its summed
   1/N chunk by N;
3. **one fused Adam kernel** over this rank's chunk of the packed
   params and its flat ``m``/``v`` (:func:`fused_adam_update`, through
   :func:`..ops.fused_adam.fused_adam`: the Hopper kernel on the GPU,
   its plain version on the CPU);
4. **one all-gather** of the updated chunks, unpacked into leaves.

The optimizer state is two flat f32 buffers ``{"m", "v"}`` of
``packed / N`` elements per rank.  The rule is Adam only: the fusion is
the rule.  Use :mod:`.zero1` for other rules.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.nn.functional as F

from ..mesh import Mesh
from ..ops.fused_adam import fused_adam
from ..optim import _f32, _lr_at, _on, div_const
from . import collectives, dp
from .zero1 import restore_layout

__all__ = [
    "fused_adam_update",
    "make_train_step_zero1_fused",
    "pack_tree",
    "packed_size",
    "unpack_tree",
    "zero1_fused_state",
]

_LANES = 128
_SUBLANES = 8
#: the packed buffer pads to a multiple of (ranks x 1024), the JAX
#: package's tile, so the two packages' packed buffers have one length
_TILE = _LANES * _SUBLANES


def _leaves(tree: Any) -> List[Optional[torch.Tensor]]:
    """The leaves of ``tree`` in JAX order: dicts by sorted key, lists
    and tuples in order, ``None`` kept as a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(template: Any, it) -> Any:
    """``template``'s structure with its leaves taken from ``it`` in the
    order of :func:`_leaves`."""
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, it) for v in template)
    return next(it)


def packed_size(params: Any, nshards: int) -> int:
    """Element count of the packed buffer: every non-``None`` leaf,
    padded to a multiple of ``nshards * 1024``."""
    total = sum(x.numel() for x in _leaves(params) if x is not None)
    return total + (-total) % (nshards * _TILE)


def pack_tree(tree: Any, nshards: int) -> torch.Tensor:
    """Ravel every non-``None`` leaf, cast it to f32 and concatenate, in
    JAX leaf order, then zero-pad to a multiple of ``nshards * 1024``:
    the one buffer the collectives and the kernel see."""
    leaves = [x for x in _leaves(tree) if x is not None]
    flat = torch.cat([x.reshape(-1).float() for x in leaves])
    pad = (-flat.numel()) % (nshards * _TILE)
    return F.pad(flat, (0, pad)) if pad else flat


def unpack_tree(flat: torch.Tensor, template: Any) -> Any:
    """Invert :func:`pack_tree` against ``template``'s shapes and dtypes
    (the pad tail is dropped; ``None`` leaves stay ``None``) and memory
    layouts (channels-last conv weights).  Leaves of f32 contiguous
    templates are views of ``flat``."""
    out, off = [], 0
    for leaf in _leaves(template):
        if leaf is None:
            out.append(None)
            continue
        n = leaf.numel()
        out.append(restore_layout(
            flat[off:off + n].reshape(leaf.shape).to(leaf.dtype), leaf))
        off += n
    return _rebuild(template, iter(out))


def _step_scalars(step: int, lr, b1: float, b2: float) -> torch.Tensor:
    """``[eta, 1 - b1^t, 1 - b2^t]`` (t = step + 1) as f32 on the host,
    computed as :func:`..optim.adam` computes them."""
    t = _f32(step) + 1.0
    return torch.stack([_f32(_lr_at(lr, step)),
                        1.0 - torch.pow(_f32(b1), t),
                        1.0 - torch.pow(_f32(b2), t)])


def fused_adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, step: int, *, lr=1e-3,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over flat f32 buffers (a rank's ZeRO-1 chunk):
    ``(p', m', v')``, new buffers.  ``lr`` may be a schedule (a callable
    of the step).  The step's scalars reach the kernel as an f32 [3]
    tensor on the buffers' device, copied from pinned host memory
    without a sync.  The length must be a multiple of 1024
    (:func:`pack_tree` guarantees it)."""
    if p.shape[0] % _TILE:
        raise ValueError(
            f"fused_adam_update needs whole [{_SUBLANES}, {_LANES}] tiles: "
            f"length {p.shape[0]} is not a multiple of {_TILE} "
            "(pack with pack_tree)")
    scalars = _on(_step_scalars(step, lr, b1, b2), p.device)
    return fused_adam(p.float(), g.float(), m.float(), v.float(), scalars,
                      b1=b1, b2=b2, eps=eps)


def zero1_fused_state(params: dict, mesh: Mesh,
                      model_state: Optional[dict] = None) -> dp.TrainState:
    """The fused-update ``TrainState`` of this rank: params and model
    state copied from rank 0, the optimizer state two flat f32 zero
    buffers ``{"m", "v"}`` of ``packed_size(params, N) / N`` elements."""
    from ..sharding import replicate

    params = replicate({k: p.detach() for k, p in dict(params).items()},
                       mesh)
    chunk = packed_size(params, mesh.size) // mesh.size
    zeros = lambda: torch.zeros(chunk, dtype=torch.float32,  # noqa: E731
                                device=mesh.device)
    return dp.TrainState(params=params, opt_state={"m": zeros(), "v": zeros()},
                         model_state=replicate(model_state or {}, mesh),
                         step=0)


def make_train_step_zero1_fused(loss_fn: Callable, mesh: Mesh, *, lr=1e-3,
                                b1: float = 0.9, b2: float = 0.999,
                                eps: float = 1e-8, seed: int = 0,
                                guard: bool = False):
    """ZeRO-1 with the fused packed update, per rank: this rank's
    gradients → pack → ONE reduce-scatter → ÷ N → this rank's chunk of
    the packed params → the fused Adam kernel → ONE all-gather → unpack.
    The same summed-gradient Adam step as
    :func:`.zero1.make_train_step_zero1` with ``optim.adam`` (bit for bit
    at two ranks, where a sum of two is exact in either order), with
    collective and kernel counts independent of the number of leaves.
    ``state`` comes from :func:`zero1_fused_state`; ``lr`` may be a
    schedule.  ``guard=True`` adds ``metrics["guard"]``
    (:func:`.dp.guard_sentinel` of the reduce-scattered flat gradient,
    its squares summed over the ranks).  The step never writes the
    state it is given, so the guard can discard its result."""
    n = mesh.size
    grads_of = dp.local_grads(loss_fn, seed=seed, mesh=mesh)

    def step(state: dp.TrainState, batch):
        loss, mstate, grads = grads_of(state.params, state.model_state,
                                       batch, state.step)
        with torch.no_grad():
            loss = collectives.pmean(loss, mesh)
            mstate = dp.sync_model_state(loss_fn, mstate, mesh)
            # a param the loss does not use gets a zero gradient, as in
            # JAX: the packed layout must not shift
            grads = {k: torch.zeros_like(p) if grads[k] is None
                     and p is not None else grads[k]
                     for k, p in state.params.items()}
            flat_g = collectives.reduce_scatter(pack_tree(grads, n), mesh)
            flat_g = div_const(flat_g, n)
            chunk = flat_g.shape[0]
            flat_p = pack_tree(state.params, n)[
                mesh.rank * chunk:(mesh.rank + 1) * chunk]
            p2, m2, v2 = fused_adam_update(
                flat_p, flat_g, state.opt_state["m"], state.opt_state["v"],
                state.step, lr=lr, b1=b1, b2=b2, eps=eps)
            gathered = collectives.all_gather(p2, mesh)
            new_params = unpack_tree(gathered, state.params)
            metrics = {"loss": loss}
            if guard:
                metrics["guard"] = dp.guard_sentinel(loss, {"flat": flat_g},
                                                     mesh)
        return dp.TrainState(params=new_params, opt_state={"m": m2, "v": v2},
                             model_state=mstate,
                             step=state.step + 1), metrics

    return step
