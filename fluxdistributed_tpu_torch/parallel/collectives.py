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
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..mesh import Mesh
from ..optim import div_const
from ..tree import tree_map

__all__ = ["all_gather", "pmean", "psum", "reduce_scatter", "tree_map"]

# torch >= 2.13 names these ``*_single`` and warns on the older names,
# which are the only ones older releases have
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def psum(tree: Any, mesh: Mesh) -> Any:
    """Element-wise sum over the ranks (an all-reduce per leaf)."""

    def one(x):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
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
        _reduce_scatter(out, x.contiguous(), op=dist.ReduceOp.SUM,
                        group=mesh.group)
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
        _all_gather(out, x.contiguous(), group=mesh.group)
        return out

    return tree_map(one, tree)
