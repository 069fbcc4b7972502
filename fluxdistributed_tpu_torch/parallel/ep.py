"""Expert parallelism (MoE): top-1 (Switch) or top-k (GShard-style)
routing with capacity, experts split over an ``expert`` mesh axis.

Port of ``fluxdistributed_tpu/parallel/ep.py``.  Routing builds the
``(tokens, experts, capacity)`` one-hot dispatch and combine tensors of
this rank's tokens, and two ``all_to_all`` exchanges over the expert
axis move each expert's queue to the rank that holds the expert and the
results back: dense products and static shapes, as the JAX design has
them.  The JAX ``moe_apply`` shards a global token array inside
``shard_map``; here every rank brings its own tokens and its own block
of ``E / S`` experts (expert ``g`` lives on the rank at expert index
``g // (E / S)``, :func:`stack_expert_params`), and the exchanges run
over the expert axis's group, within the rank's data row.

Semantics (the JAX module's):

* ``top_k=1`` (Switch): one expert a token, its output scaled by the
  router probability; ``top_k > 1``: k experts a token, later choices
  queue after earlier ones in each expert's capacity, gates normalised
  to sum to 1;
* a rank's expert capacity is ``C = ceil(tokens / E * capacity_factor
  * top_k)``; tokens over capacity are dropped (zero output for that
  choice);
* the load-balance term ``E * sum_e f_e p_e`` (first-choice fraction
  routed times mean router probability), averaged over the expert
  group (and the data group with ``batch_axis``), is returned for the
  caller to add to its loss.

Routing runs in f32 whatever the compute dtype (a bf16 cumsum saturates
at 256).  The dispatched tokens take the f32 of the routing tensors, as
JAX's type promotion gives them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..mesh import EXPERT_AXIS, Mesh
from ..obs import comms
from .collectives import all_to_all, pmean_grad

__all__ = [
    "moe_apply",
    "router_dispatch",
    "router_dispatch_expert_choice",
    "stack_expert_params",
]


def stack_expert_params(per_expert: list, mesh: Mesh,
                        axis: str = EXPERT_AXIS) -> Any:
    """Stack E per-expert param trees on a leading dim split over
    ``axis`` and keep this rank's block: experts ``[r E/S, (r + 1) E/S)``
    on the rank at expert index ``r``."""
    from ..sharding import stack_on_axis

    return stack_on_axis(per_expert, mesh, axis)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_dispatch(logits: torch.Tensor, capacity: int, k: int = 1,
                    normalize: Optional[bool] = None):
    """Top-``k`` dispatch and combine tensors from router ``logits``
    (T, E): ``dispatch`` (T, E, C) of 0/1, ``combine`` (T, E, C) =
    dispatch x gate, in the logits' dtype, and the load-balance term.

    ``k=1`` is Switch routing (gate = router probability); ``k > 1`` is
    GShard-style top-k, later choices queued after earlier ones in each
    expert's capacity and gates normalised to sum to 1 over the chosen
    experts (``normalize`` overrides; default ``k > 1``).  The aux term
    uses the first choices (the Switch definition).  Ties go to the
    lower expert index."""
    t, e = logits.shape
    dtype = logits.dtype
    if not 1 <= k <= e:
        # past round E the masked probabilities are all zero and argmax
        # would send every token to expert 0
        raise ValueError(f"top-k ({k}) must be in [1, experts ({e})]")
    if normalize is None:
        normalize = k > 1
    probs = torch.softmax(logits.float(), dim=-1)
    masked = probs
    counts = torch.zeros(e, dtype=torch.float32, device=logits.device)
    ds, gates = [], []
    first_oh = None
    for _ in range(k):
        onehot = _one_hot(torch.argmax(masked, dim=-1), e)  # (T, E)
        if first_oh is None:
            first_oh = onehot
        # each token's place in its expert's queue (0-based), after the
        # tokens queued there in earlier rounds
        pos = (torch.cumsum(onehot, dim=0) + counts[None, :]) * onehot - 1.0
        kept = (pos >= 0) & (pos < capacity)
        pos_oh = _one_hot(pos.to(torch.int32), capacity)
        ds.append(pos_oh * kept.float()[..., None])
        gates.append(torch.amax(probs * onehot, dim=-1))  # routed prob
        counts = counts + onehot.sum(dim=0)
        masked = masked * (1.0 - onehot)
    if normalize:
        gsum = sum(gates) + 1e-9
        gates = [g / gsum for g in gates]
    dispatch = sum(ds).to(dtype)
    combine = sum(d * g[:, None, None] for d, g in zip(ds, gates)).to(dtype)
    # E * sum_e (fraction of tokens sent to e) * (mean prob of e)
    aux = e * torch.sum(first_oh.mean(dim=0) * probs.mean(dim=0))
    return dispatch, combine, aux


def router_dispatch_expert_choice(logits: torch.Tensor, capacity: int):
    """Expert-choice dispatch and combine (Zhou et al. 2022): each
    expert takes its ``capacity`` most probable tokens (ties to the
    lower token index), so every expert is full and the aux term is 0;
    a token may go to several experts or none.  The
    :func:`router_dispatch` contract."""
    t, e = logits.shape
    dtype = logits.dtype
    if capacity > t:
        raise ValueError(f"expert-choice capacity ({capacity}) cannot "
                         f"exceed tokens per shard ({t})")
    probs = torch.softmax(logits.float(), dim=-1)  # (T, E)
    idx = torch.sort(probs.t(), dim=-1, descending=True,
                     stable=True).indices[:, :capacity]  # (E, C)
    dispatch = _one_hot(idx, t).permute(2, 0, 1)  # (T, E, C)
    combine = (dispatch * probs[:, :, None]).to(dtype)
    return (dispatch.to(dtype), combine,
            torch.zeros((), dtype=torch.float32, device=logits.device))


def _promoted(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def moe_apply(expert_fn: Callable, mesh: Mesh, axis: str = EXPERT_AXIS,
              capacity_factor: float = 1.25, capacity: Optional[int] = None,
              top_k: int = 1, routing: str = "token",
              batch_axis: Optional[str] = None, pad_tokens: bool = False):
    """Build ``fn(stacked_params, router_w, x) -> (y, aux)`` over this
    rank's tokens.

    ``x``: (T, D) this rank's tokens; ``router_w``: (D, E), the same on
    every rank; ``stacked_params``: this rank's block of the experts,
    leaves (E/S, ...) (:func:`stack_expert_params`), on which
    ``expert_fn(params, tokens)`` computes every local expert at once
    (tokens (E/S, n, D); e.g. ``models.moe_expert_fn``).  E must be a
    multiple of the ``axis`` size S.  ``y`` is (T, D), ``aux`` the
    load-balance term averaged over the expert group (then over the
    ``batch_axis`` group), differentiable.  ``routing`` is token choice
    (``"token"``, ``top_k`` 1 or more) or expert choice
    (``"expert_choice"``).  With ``batch_axis`` (a ``(data, expert)``
    mesh) each data row routes its own tokens among the row's expert
    blocks.  Every rank of the expert group brings the same token count;
    ``pad_tokens=True`` (decode steps, which need an explicit
    ``capacity``) pads each rank's tokens with zero tokens to the
    group's largest count, as the JAX function pads its token array to
    a multiple of the shards: they route like any other token and take
    capacity slots."""
    if routing not in ("token", "expert_choice"):
        raise ValueError(f"unknown routing {routing!r}")
    if routing == "expert_choice" and top_k != 1:
        raise ValueError("top_k applies to token-choice routing only")
    if pad_tokens and routing == "expert_choice":
        # pad tokens get uniform router prob 1/E and would displace real
        # tokens from each expert's top-capacity pick
        raise ValueError("pad_tokens is incompatible with expert_choice "
                         "routing")
    if pad_tokens and capacity is None:
        raise ValueError(
            "pad_tokens=True needs an explicit capacity: the auto capacity "
            "ceil(T/E * factor) is ~1 for tiny decode steps and pad tokens "
            "consume slots — size it for the real token count plus headroom")
    if capacity is not None and capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    s = mesh.axis_size(axis)
    batch = (batch_axis, axis) if batch_axis else (axis,)
    if batch_axis:
        mesh.axis_size(batch_axis)  # raises when it is not on the mesh

    def padded_count(t: int, x: torch.Tensor) -> int:
        if mesh.axis_size(batch) == 1:
            return t
        n = torch.tensor([t], dtype=torch.int64, device=x.device)
        comms.all_reduce(n, op=dist.ReduceOp.MAX, group=mesh.group_of(batch))
        return int(n.item())

    def fn(stacked_params, router_w, x):
        t, d = x.shape
        e = router_w.shape[-1]
        if e % s:
            raise ValueError(f"experts ({e}) must be a multiple of "
                             f"'{axis}' size ({s})")
        loc = e // s  # experts on each rank
        n = padded_count(t, x) if pad_tokens else t
        if n > t:
            x = torch.cat([x, x.new_zeros((n - t, d))])
        cap = (capacity if capacity is not None
               else max(1, math.ceil(n / e * capacity_factor * top_k)))
        logits = x.float() @ router_w.float()
        if routing == "expert_choice":
            dispatch, combine, aux = router_dispatch_expert_choice(logits,
                                                                   cap)
        else:
            dispatch, combine, aux = router_dispatch(logits, cap, k=top_k)
        # (T, D), (T, E, C) -> (E, C, D): each expert's queue of this rank
        expert_in = torch.einsum("td,tec->ecd", *_promoted(x, dispatch))
        # rank q receives every rank's queues for its LOC experts
        expert_in = all_to_all(expert_in.reshape(s, loc, cap, d), mesh,
                               axis, 0, 0)  # (S_src, LOC, C, D)
        xin = expert_in.transpose(0, 1).reshape(loc, s * cap, d)
        y = expert_fn(stacked_params, xin)  # (LOC, S C, D)
        y = y.reshape(loc, s, cap, d).transpose(0, 1)  # (S, LOC, C, D)
        y = all_to_all(y, mesh, axis, 0, 0)  # back to the token owners
        out = torch.einsum("ecd,tec->td",
                           *_promoted(y.reshape(e, cap, d), combine))
        aux = pmean_grad(aux, mesh, axis)
        if batch_axis:
            aux = pmean_grad(aux, mesh, batch_axis)
        return (out[:t] if n > t else out), aux

    fn.mesh = mesh  # the trainer checks it against the step's mesh
    return fn
