"""Replication and batch sharding across the ranks of the data axis.

Port of the data-parallel subset of ``fluxdistributed_tpu/sharding.py``.
In the JAX package a ``NamedSharding`` places a full copy of the state
on every device and splits the batch's leading dim over the ``data``
axis.  Here each rank holds its own copy, so:

* :func:`replicate` copies rank 0's tensors to every rank (a broadcast)
  when the state is made, and returns new tensors;
* :func:`shard_batch` keeps this rank's contiguous rows of the global
  batch, as the JAX package gives device ``r`` rows
  ``[r * B / N, (r + 1) * B / N)``;
* :func:`ensure_synced` checks that every rank holds the same values
  (the reference's ``ensure_synced`` debug check).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .mesh import Mesh
from .tree import leaves_with_path, tree_map

__all__ = ["ensure_synced", "replicate", "shard_batch"]


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's value of every leaf on every rank, in new tensors that
    share no storage with the caller's."""

    def one(x):
        out = x.detach().clone()
        dist.broadcast(out, src=0, group=mesh.group)
        return out

    return tree_map(one, tree)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of the global ``batch`` (a dict of arrays or
    tensors sharing the leading dim).  Raises when the batch does not
    split evenly over the ranks."""

    def rows(x):
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch dim {b} not divisible by mesh axis "
                             f"'{mesh.axis}' size {mesh.size}")
        n = b // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    return {k: rows(v) for k, v in batch.items()}


def ensure_synced(tree: Any, mesh: Mesh, rtol: float = 0.0,
                  atol: float = 0.0) -> bool:
    """Check that every rank's copy of each leaf equals rank 0's (within
    ``rtol``/``atol``; identical NaNs count as equal).  Every rank must
    call it.  Raises ``AssertionError`` naming the first leaf that
    differs on some rank; returns True otherwise."""
    for path, leaf in leaves_with_path(tree):
        if leaf is None:
            continue
        ref = leaf.detach().clone()
        dist.broadcast(ref, src=0, group=mesh.group)
        same = torch.allclose(leaf, ref, rtol=rtol, atol=atol, equal_nan=True)
        bad = torch.tensor([0.0 if same else 1.0], device=leaf.device)
        dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=mesh.group)
        if bad.item():
            err = (leaf.float() - ref.float()).abs().max().item()
            raise AssertionError(
                f"replica divergence at {path}: {int(bad.item())} rank(s) "
                f"differ from rank 0 (this rank's max abs err {err})")
    return True
