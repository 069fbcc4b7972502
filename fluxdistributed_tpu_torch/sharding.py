"""Replication, batch sharding, partition specs and the blocks they
place, across the ranks of a mesh.

Port of ``fluxdistributed_tpu/sharding.py``.  In the JAX package a
``NamedSharding`` places each array over a mesh and GSPMD moves the
data; here each rank holds its own tensors, so:

* :func:`replicate` copies rank 0's tensors to every rank (a broadcast)
  when the state is made, and returns new tensors;
* :func:`shard_batch` keeps this rank's contiguous rows of the global
  batch, split over one axis or over a tuple of axes jointly, as the
  JAX package gives device ``r`` rows ``[r * B / N, (r + 1) * B / N)``
  of the ``N`` batch shards; ranks that differ only on other axes (the
  model axis) get the same rows;
* :class:`P` is the port's partition spec (``jax.sharding.PartitionSpec``
  cannot be imported here): one entry per leading dim, each ``None``, an
  axis name, a tuple of axis names split jointly, or a :class:`Stacked`
  dim; trailing dims left out are ``None``.  :func:`partition_by_rules`
  derives a spec for every leaf of a tree from a regex rule table;
* :func:`local_block` cuts this rank's block out of a global tensor and
  :func:`global_shape` gives a block's global shape (together the
  counterpart of ``make_shardings`` and ``device_put``), and
  :func:`gather_global` all-gathers the blocks back into the global
  tensor;
* :func:`stack_on_axis` stacks N per-item trees on a new leading dim
  split over an axis (MoE experts, later pipeline stages);
* :func:`ensure_synced` checks that every rank holds the same values
  (the reference's ``ensure_synced`` debug check).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh
from .tree import leaves_with_path, tree_map

__all__ = ["P", "Stacked", "ensure_synced", "entry_axes", "gather_dim", "gather_global", "global_shape",
           "local_block", "map_with_specs", "partition_by_rules",
           "reduce_scatter_dim", "replicate", "shard_batch", "spec_axes",
           "stack_on_axis", "start_gather_dim"]


@dataclasses.dataclass(frozen=True)
class Stacked:
    """A spec entry for a dim made of ``parts`` equal stacked parts, each
    split over ``axis``: the port's fused projections hold q, k and v
    (or k and v) one after the other on their output dim, where the JAX
    kernel has a separate ``3`` dim that stays whole while the heads
    split.  Rank ``i`` of the axis holds slice ``i`` of every part."""

    axis: str
    parts: int


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, in order."""
    if entry is None:
        return ()
    if isinstance(entry, Stacked):
        return (entry.axis,)
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class P(tuple):
    """A partition spec: ``P("model", None)`` splits dim 0 over the model
    axis; ``P()`` replicates.  Trailing ``None`` entries do not count, so
    ``P(None) == P()``, as the specs of JAX shardings compare."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def _norm(self) -> tuple:
        out = tuple(self)
        while out and out[-1] is None:
            out = out[:-1]
        return out

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._norm() == (other._norm() if isinstance(other, P)
                                else P(*other)._norm())

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._norm())

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis name a spec splits over, in dim order."""
    return tuple(a for e in spec for a in entry_axes(e))


def _dims(x: torch.Tensor, spec):
    """``(dim, entry, parts)`` for each split dim of ``spec``."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more entries than the "
                         f"{x.ndim}-d leaf {tuple(x.shape)}")
    return [(d, e, e.parts if isinstance(e, Stacked) else 1)
            for d, e in enumerate(spec) if e is not None]


def global_shape(shape: Sequence[int], spec, mesh: Mesh) -> tuple:
    """The global shape of a block of ``shape`` placed by ``spec``."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] *= mesh.axis_size(entry_axes(e))
    return tuple(out)


def local_block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``, in
    a new tensor (``x``'s memory layout kept).  Raises when a split dim
    does not divide."""
    out = x
    for d, e, parts in _dims(x, spec):
        axes = entry_axes(e)
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        ext = x.shape[d]
        if ext % (n * parts):
            raise ValueError(f"dim {d} of {tuple(x.shape)} is not divisible "
                             f"by {n * parts} (spec {spec!r} over "
                             f"{mesh.shape})")
        m = ext // (n * parts)
        if parts == 1:
            out = out.narrow(d, i * m, m)
        else:
            shp = list(out.shape)
            v = out.reshape(shp[:d] + [parts, n * m] + shp[d + 1:])
            out = v.narrow(d + 1, i * m, m).reshape(
                shp[:d] + [parts * m] + shp[d + 1:])
    return out.clone()


def gather_dim(x: torch.Tensor, dim: int, group, n: int,
               parts: int = 1) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` along ``dim`` concatenated in
    rank order (an all-gather over ``group``); ``parts > 1`` puts each
    rank's slice of every stacked part back in its part."""
    return start_gather_dim(x, dim, group, n, parts, async_op=False)()


def start_gather_dim(x: torch.Tensor, dim: int, group, n: int,
                     parts: int = 1, async_op: bool = True):
    """:func:`gather_dim` started: the all-gather is posted (without
    waiting, with ``async_op``) and the returned ``finish()`` waits for
    it and returns what :func:`gather_dim` returns, bit for bit
    (``finish.out`` is the buffer it fills).  The buffer is allocated on
    the current stream."""
    from .parallel.collectives import _all_gather

    x = x.contiguous()
    shp = list(x.shape)
    out = torch.empty([n] + shp, dtype=x.dtype, device=x.device)
    work = _all_gather(out.view([n * shp[0]] + shp[1:]), x, group=group,
                       async_op=async_op)

    def finish() -> torch.Tensor:
        if work is not None:
            work.wait()
        full = shp[:dim] + [n * shp[dim]] + shp[dim + 1:]
        if parts == 1:
            return out.movedim(0, dim).reshape(full)
        m = shp[dim] // parts
        v = out.view([n] + shp[:dim] + [parts, m] + shp[dim + 1:])
        return v.movedim(0, dim + 1).reshape(full)

    finish.out = out  # the buffer the gather fills
    return finish


def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       n: int) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``x``, of which this rank keeps
    its block along ``dim`` (a reduce-scatter over ``group``): the
    transpose of :func:`gather_dim`."""
    from .parallel.collectives import _reduce_scatter

    shp = list(x.shape)
    m = shp[dim] // n
    blocks = x.reshape(shp[:dim] + [n, m] + shp[dim + 1:]).movedim(
        dim, 0).contiguous()
    local = shp[:dim] + [m] + shp[dim + 1:]
    out = torch.empty(local, dtype=x.dtype, device=x.device)
    _reduce_scatter(out, blocks.view([n * local[0]] + local[1:]),
                    op=dist.ReduceOp.SUM, group=group)
    return out


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (the same
    structure, with :class:`P` leaves); ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, v, s)
                          for v, s in zip(tree, specs))
    raise TypeError(f"no spec for leaf of type {type(tree).__name__}")


def gather_global(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The global tensor of this rank's block ``x`` under ``spec``: an
    all-gather over each split dim's axes (every rank of the mesh calls
    it, with its own block)."""
    for d, e, parts in _dims(x, spec):
        axes = entry_axes(e)
        x = gather_dim(x, d, mesh.group_of(axes), mesh.axis_size(axes),
                       parts)
    return x


def partition_by_rules(rules, params: dict) -> dict:
    """A spec for every leaf of ``params`` by regex match on its name
    (first match wins; scalars and unmatched leaves replicate): a thin
    alias of :func:`.parallel.rules.match_partition_rules`, the one
    matcher, which takes ``mesh=``, ``strict=`` and ``report=``."""
    from .parallel.rules import match_partition_rules

    return match_partition_rules(list(rules), params)


def _first(mesh: Mesh) -> int:
    """The global rank of the mesh's rank 0 (a broadcast names its
    source by global rank)."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's value of every leaf on every rank, in new tensors that
    share no storage with the caller's."""
    src = _first(mesh)

    def one(x):
        out = x.detach().clone()
        dist.broadcast(out, src=src, group=mesh.group)
        return out

    return tree_map(one, tree)


def shard_batch(batch: dict, mesh: Mesh, axis=DATA_AXIS) -> dict:
    """This rank's rows of the global ``batch`` (a dict of arrays or
    tensors sharing the leading dim), split over ``axis``: one axis
    name, or a tuple split jointly (the layouts' ``("data", "fsdp")``).
    Ranks that differ only on other axes get the same rows.  Raises when
    the batch does not split evenly."""
    if not isinstance(axis, str) and len(axis) == 1:
        axis = axis[0]
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def rows(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch dim {b} not divisible by mesh axis "
                             f"'{axis}' size {n}")
        k = b // n
        return x[i * k:(i + 1) * k]

    return {k: rows(v) for k, v in batch.items()}


def stack_on_axis(per_item: Sequence[Any], mesh: Mesh, axis: str) -> Any:
    """Stack N per-item trees (dicts, lists or tuples of tensors of one
    structure) on a new leading dim split over ``axis``, and keep this
    rank's block: item ``i`` lives on the rank at index ``i // (N / n)``
    of the axis's ``n`` (contiguous blocks, the JAX ``P(axis)``
    placement).  Every rank passes all N items."""
    first = per_item[0]
    if isinstance(first, dict):
        return {k: stack_on_axis([it[k] for it in per_item], mesh, axis)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            stack_on_axis([it[i] for it in per_item], mesh, axis)
            for i in range(len(first)))
    return local_block(torch.stack(list(per_item)), P(axis), mesh)


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
        dist.broadcast(ref, src=_first(mesh), group=mesh.group)
        same = torch.allclose(leaf, ref, rtol=rtol, atol=atol, equal_nan=True)
        bad = torch.tensor([0.0 if same else 1.0], device=leaf.device)
        dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=mesh.group)
        if bad.item():
            err = (leaf.float() - ref.float()).abs().max().item()
            raise AssertionError(
                f"replica divergence at {path}: {int(bad.item())} rank(s) "
                f"differ from rank 0 (this rank's max abs err {err})")
    return True
