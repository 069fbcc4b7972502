"""Collectives over the data axis, on trees of tensors.

Port of ``fluxdistributed_tpu/parallel/collectives.py:psum``, ``pmean``,
``all_gather`` and ``reduce_scatter``.  The JAX functions run inside
``shard_map`` and name a mesh axis; these run in every rank of a
:class:`..mesh.Mesh` and run ``torch.distributed`` collectives over
its group (NCCL on the GPU, gloo on CPU ranks).  A tree is a tensor or
a (nested) dict, list or tuple of tensors; ``None`` leaves pass through.
Every function returns new tensors and leaves its inputs as they were.
The collective runs at one rank too, so a one-GPU run goes through
NCCL like a larger one.  Each tensor is one collective: callers that
want one call for many tensors pack them first
(:mod:`.zero1_fused`).

The exchanges of context and expert parallelism run over one axis's
group of an N-D mesh and carry gradients (each an
``autograd.Function``):

* :func:`ring_shift_start` posts the JAX ``ppermute`` of a ring (send to
  the axis's next rank, receive from its previous one, or the other way
  round, with ``batch_isend_irecv``) and :meth:`RingShift.wait`
  finishes it; the backward shifts the gradient the other way (the
  pipeline's activation hand-off, :mod:`.pp` and :mod:`.pp_1f1b`, rides
  it too);
* :func:`all_to_all` is the JAX tiled ``all_to_all``: split one dim
  into the axis's ranks, send block ``i`` to rank ``i``, concatenate
  what arrives along another dim in rank order
  (``all_to_all_single``); the backward is the reverse exchange;
* :func:`pmean_grad` is the JAX ``pmean`` of a value that carries a
  gradient: its backward averages the cotangents the same way, so a
  replicated term of the loss (the MoE auxiliary loss) reaches each
  rank's inputs once; :func:`psum_grad` is the ``psum`` whose backward
  sums them (the sequence-sharded ViT's pooling).

In a group of one each is the identity and sends nothing: NCCL is never
asked to send to its own rank.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..mesh import Mesh
from ..obs import comms
from ..optim import div_const
from ..tree import tree_map

__all__ = ["RingShift", "all_gather", "all_to_all", "pmean", "pmean_grad",
           "psum", "psum_grad", "reduce_scatter", "ring_shift_start", "tree_map"]

def psum(tree: Any, mesh: Mesh) -> Any:
    """Element-wise sum over the ranks (an all-reduce per leaf)."""

    def one(x):
        out = x.detach().clone()
        comms.all_reduce(out, group=mesh.group)
        return out

    return tree_map(one, tree)


def pmean(tree: Any, mesh: Mesh) -> Any:
    """Element-wise mean over the ranks: the sum divided by their
    number, as the JAX ``pmean`` divides by the axis size (a constant
    there, so a product with its f32 reciprocal: :func:`..optim.div_const`)."""
    return tree_map(lambda x: div_const(x, mesh.size), psum(tree, mesh))


def reduce_scatter(tree: Any, mesh: Mesh) -> Any:
    """Sum over the ranks, then keep this rank's slice: each leaf is 1-D
    of a length divisible by the number of ranks, and rank ``r`` gets
    elements ``[r * n / N, (r + 1) * n / N)`` of the sum."""

    def one(x):
        if x.ndim != 1 or x.shape[0] % mesh.size:
            raise ValueError(
                f"reduce_scatter takes 1-D tensors whose length divides "
                f"over {mesh.size} ranks, got {tuple(x.shape)}")
        out = torch.empty(x.shape[0] // mesh.size, dtype=x.dtype,
                          device=x.device)
        comms.reduce_scatter_into(out, x.contiguous(), group=mesh.group)
        return out

    return tree_map(one, tree)


def all_gather(tree: Any, mesh: Mesh) -> Any:
    """Concatenate every rank's 1-D leaf in rank order (the JAX
    ``all_gather(..., tiled=True)`` on axis 0)."""

    def one(x):
        if x.ndim != 1:
            raise ValueError(f"all_gather takes 1-D tensors, got "
                             f"{tuple(x.shape)}")
        out = torch.empty(x.shape[0] * mesh.size, dtype=x.dtype,
                          device=x.device)
        comms.all_gather_into(out, x.contiguous(), group=mesh.group)
        return out

    return tree_map(one, tree)


def _axis_group(mesh: Mesh, axis: str):
    """(group, size, this rank's index, global rank of each index) of
    ``axis``'s group: its ranks, in ascending global rank, are the
    axis's coordinates in order."""
    group = mesh.group_of(axis)
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    glob = [r if group is None else dist.get_global_rank(group, r)
            for r in range(n)]
    return group, n, i, glob


def _shift(tensors, group, dst: int, src: int):
    """Send every tensor to global rank ``dst`` and receive as many of
    the same shapes from ``src``: the posted requests and the buffers."""
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.detach().contiguous(), dst, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, b, src, group) for b in bufs])
    return comms.batch_isend_irecv(ops, group), bufs


class RingShift:
    """One hop of a ring over an axis, posted by :func:`ring_shift_start`:
    :meth:`wait` returns what the previous rank of the axis sent, as
    tensors whose gradient goes back to the sent ones (the backward
    sends each gradient to the previous rank and receives from the
    next, mirroring the forward's pairs)."""

    def __init__(self, tensors, group, nxt: int, prv: int):
        self.tensors, self.group, self.nxt, self.prv = tensors, group, nxt, prv
        self.reqs, self.bufs = _shift(tensors, group, nxt, prv)

    def wait(self):
        return _RingRecv.apply(self, *self.tensors)


class _RingRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, work, *tensors):
        for r in work.reqs:
            r.wait()
        ctx.work = work
        return tuple(work.bufs)

    @staticmethod
    def backward(ctx, *grads):
        w = ctx.work
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, w.tensors)]
        reqs, bufs = _shift(grads, w.group, w.prv, w.nxt)
        for r in reqs:
            r.wait()
        return (None, *bufs)


class _Held:
    """A finished shift of a group of one: the tensors themselves."""

    def __init__(self, tensors):
        self.tensors = tensors

    def wait(self):
        return tuple(self.tensors)


def ring_shift_start(tensors, mesh: Mesh, axis: str, reverse: bool = False):
    """Post one hop of the ring over ``axis`` (the JAX ``ppermute`` with
    pairs ``(j, j + 1 mod n)``, or ``(j, j - 1 mod n)`` with
    ``reverse``) for a list of tensors and return its handle;
    ``handle.wait()`` gives the tensors the previous rank of the hop
    sent.  Post before the work the transfer should overlap, wait after
    it."""
    group, n, i, glob = _axis_group(mesh, axis)
    if n == 1:
        return _Held(list(tensors))
    step = -1 if reverse else 1
    return RingShift(list(tensors), group, glob[(i + step) % n],
                     glob[(i - step) % n])


def _exchange(x: torch.Tensor, split: int, concat: int, group,
              n: int) -> torch.Tensor:
    blocks = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(blocks)
    comms.all_to_all_into(out, blocks, group=group)
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group, n):
        ctx.args = (split, concat, group, n)
        return _exchange(x, split, concat, group, n)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, n = ctx.args
        return _exchange(g, concat, split, group, n), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The JAX ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over ``axis``'s group: ``x`` is cut into the axis's ``n`` ranks along
    ``split_dim``, block ``i`` goes to rank ``i``, and the blocks that
    arrive are concatenated along ``concat_dim`` in rank order.  With
    ``split_dim == concat_dim == 0`` it is also the untiled exchange of
    a leading dim of size ``n``.  Differentiable (the reverse exchange);
    the identity in a group of one."""
    group, n, _, _ = _axis_group(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over the {n} ranks of {axis!r}")
    return _AllToAll.apply(x, split_dim, concat_dim, group, n)


class _PmeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.args = (group, n)
        out = x.detach().clone()
        comms.all_reduce(out, group=group)
        return div_const(out, n)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        out = g.contiguous().clone()
        comms.all_reduce(out, group=group)
        return div_const(out, n), None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        comms.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        comms.all_reduce(out, group=ctx.group)
        return out, None


def psum_grad(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks that carries its gradient:
    the backward sums the cotangents over the same ranks (the JAX
    ``psum``'s transpose), so when each rank's loss is its part of one
    total, each rank's input gets the whole total's cotangent.  The
    identity in a group of one."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumGrad.apply(x, mesh.group_of(axis))


def pmean_grad(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis``'s ranks (one name or a tuple)
    that carries its gradient: the backward takes the mean of the
    cotangents over the same ranks.  The identity in a group of one."""
    group, n = mesh.group_of(axis), mesh.axis_size(axis)
    if n == 1:
        return x
    return _PmeanGrad.apply(x, group, n)
