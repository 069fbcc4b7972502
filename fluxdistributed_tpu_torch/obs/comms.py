"""The collective ledger: what a step moves between ranks, counted per
mesh axis.

Port of ``fluxdistributed_tpu/obs/comms.py``.  The JAX module reads the
collectives off a traced jaxpr (the explicit ``shard_map`` schedules)
and off the compiled HLO (what GSPMD inserted).  Eager PyTorch has no
program to read: every collective is a ``torch.distributed`` call the
port makes itself.  So the port records the collectives a call actually
issues.  Every collective of the port goes through the functions of
this module (:func:`all_reduce`, :func:`broadcast`,
:func:`all_gather_into`, :func:`reduce_scatter_into`,
:func:`all_to_all_into`, :func:`batch_isend_irecv`,
:func:`broadcast_object_list`), which note the call in the open
:func:`recording`, if there is one, and then make it.  Outside a
recording a call pays one ``None`` check.

Counting follows what ran, not what a program holds: a pipeline's tick
loop counts each hop it issued (JAX multiplies a ``scan`` body by its
trip count, takes the max over ``cond`` branches and counts a ``while``
body once; none of that applies to a run).  Entries keep the JAX
layout::

    {"kind": "all_reduce" | "all_gather" | "reduce_scatter" |
             "all_to_all" | "ppermute" | "broadcast",
     "axes": ["data"] | None,   # the mesh axes of the call's group
     "count": N,                # calls
     "bytes": B,                # sum of buffer bytes over those calls
     "bytes_per_call": B1}      # largest single buffer

``bytes`` is the buffer, the larger of the input and output bytes (an
all-gather's output, a reduce-scatter's input), not the wire bytes.  A
``batch_isend_irecv`` hop is one ``ppermute`` whose bytes are the
tensors it sends.  ``broadcast`` (the port's own kind) covers the
placement broadcasts of setup and the pipeline's hand-out; a setup call
is recorded only when it runs inside the window.  ``axes`` come from
the recording's mesh (:meth:`..mesh.Mesh.axes_of`): the axes of the
group the call ran on, ``None`` when the recording has no mesh or the
group is none of the mesh's.

A recording is process-wide, not per thread: autograd runs a CUDA
backward's collectives on its own thread.  The rollups
(:func:`collective_signature`, :func:`merge_entries`,
:func:`total_bytes`) are the JAX functions as they are.
"""

from __future__ import annotations

import contextlib
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "KINDS",
    "Recording",
    "all_gather_into",
    "all_reduce",
    "all_to_all_into",
    "batch_isend_irecv",
    "broadcast",
    "broadcast_object_list",
    "collective_signature",
    "merge_entries",
    "record_collectives",
    "recording",
    "reduce_scatter_into",
    "total_bytes",
]

#: the kinds an entry can have: JAX's five and the port's ``broadcast``
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "ppermute", "broadcast")

_Key = Tuple[str, Optional[Tuple[str, ...]]]

# torch >= 2.13 names these ``*_single`` and warns on the older names,
# which are the only ones older releases have
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

#: the open recording, or None
_active: Optional["Recording"] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Recording:
    """The collectives noted since it opened, keyed on (kind, axes).
    ``mesh`` names the axes of each call's group."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._acc: Dict[_Key, dict] = {}

    def add(self, kind: str, group, nbytes: int) -> None:
        axes = self.mesh.axes_of(group) if self.mesh is not None else None
        cell = self._acc.setdefault(
            (kind, axes), {"count": 0, "bytes": 0, "bytes_per_call": 0})
        cell["count"] += 1
        cell["bytes"] += int(nbytes)
        cell["bytes_per_call"] = max(cell["bytes_per_call"], int(nbytes))

    def entries(self) -> List[dict]:
        """The ledger so far, in the JAX entry layout, sorted."""
        return _entries(self._acc)


@contextlib.contextmanager
def recording(mesh=None) -> Iterator[Recording]:
    """Note every collective the process issues until the block ends.
    Recordings do not nest (a second one raises)."""
    global _active
    if _active is not None:
        raise RuntimeError("a collective recording is already open")
    rec = Recording(mesh)
    _active = rec
    try:
        yield rec
    finally:
        _active = None


def record_collectives(fn, args: Tuple[Any, ...], mesh=None) -> List[dict]:
    """``fn(*args)`` run once, and the collectives it issued (see the
    module doc for the entry layout).  On fake tensors
    (:mod:`.pricing`) nothing runs on a device and nothing is sent."""
    with recording(mesh) as rec:
        fn(*args)
    return rec.entries()


# -- the port's collectives, each noted ---------------------------------------

def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
               async_op: bool = False):
    """``dist.all_reduce`` in place, noted as ``all_reduce``."""
    if _active is not None:
        _active.add("all_reduce", group, _nbytes(t))
    return dist.all_reduce(t, op=op, group=group, async_op=async_op)


def broadcast(t: torch.Tensor, src: int, group=None):
    """``dist.broadcast`` in place from global rank ``src``, noted as
    ``broadcast``."""
    if _active is not None:
        _active.add("broadcast", group, _nbytes(t))
    return dist.broadcast(t, src=src, group=group)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group=None,
                    async_op: bool = False):
    """Every rank's ``x`` concatenated on dim 0 into ``out``, noted as
    ``all_gather`` of ``out``'s bytes."""
    if _active is not None:
        _active.add("all_gather", group, _nbytes(out))
    return _all_gather(out, x, group=group, async_op=async_op)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor,
                        op=dist.ReduceOp.SUM, group=None):
    """This rank's dim-0 block of the sum of every rank's ``x``, into
    ``out``, noted as ``reduce_scatter`` of ``x``'s bytes."""
    if _active is not None:
        _active.add("reduce_scatter", group, _nbytes(x))
    return _reduce_scatter(out, x, op=op, group=group)


def all_to_all_into(out: torch.Tensor, x: torch.Tensor, group=None):
    """``dist.all_to_all_single``, noted as ``all_to_all``."""
    if _active is not None:
        _active.add("all_to_all", group, max(_nbytes(x), _nbytes(out)))
    return dist.all_to_all_single(out, x, group=group)


def batch_isend_irecv(ops: Sequence, group=None):
    """``dist.batch_isend_irecv`` of one hop, noted as one ``ppermute``
    whose bytes are the tensors it sends; ``group`` is the hop's."""
    if _active is not None:
        _active.add("ppermute", group, sum(
            _nbytes(p.tensor) for p in ops if p.op is dist.isend))
    return dist.batch_isend_irecv(list(ops))


def broadcast_object_list(box: list, src: int = 0, device=None, group=None):
    """``dist.broadcast_object_list``, noted as ``broadcast`` of the
    pickled bytes (the source's; another rank notes 0)."""
    if _active is not None:
        n = len(pickle.dumps(box)) if dist.get_rank() == src else 0
        _active.add("broadcast", group, n)
    return dist.broadcast_object_list(box, src=src, device=device,
                                      group=group)


# -- rollups (the JAX functions) ----------------------------------------------

def _entries(acc: Dict[_Key, dict]) -> List[dict]:
    out = []
    for (kind, axes), cell in sorted(
            acc.items(), key=lambda kv: (kv[0][0], kv[0][1] or ())):
        out.append({
            "kind": kind,
            "axes": list(axes) if axes else None,
            "count": int(cell["count"]),
            "bytes": int(cell["bytes"]),
            "bytes_per_call": int(cell["bytes_per_call"]),
        })
    return out


def collective_signature(entries: Sequence[dict]) -> Dict[str, int]:
    """``{kind: total count}`` — the shape tests pin ("zero1 =
    reduce_scatter + all_gather where dp = all_reduce only")."""
    out: Dict[str, int] = {}
    for e in entries:
        out[e["kind"]] = out.get(e["kind"], 0) + int(e["count"])
    return out


def merge_entries(*entry_lists: Sequence[dict]) -> List[dict]:
    """Sum several ledgers (e.g. a serve engine's program pool) into
    one, keyed on (kind, axes)."""
    acc: Dict[_Key, dict] = {}
    for entries in entry_lists:
        for e in entries:
            key = (e["kind"], tuple(e["axes"]) if e.get("axes") else None)
            cell = acc.setdefault(
                key, {"count": 0, "bytes": 0, "bytes_per_call": 0})
            cell["count"] += int(e["count"])
            cell["bytes"] += int(e["bytes"])
            cell["bytes_per_call"] = max(cell["bytes_per_call"],
                                         int(e.get("bytes_per_call", 0)))
    return _entries(acc)


def total_bytes(entries: Sequence[dict]) -> int:
    """Σ buffer bytes a step moves through collectives."""
    return sum(int(e["bytes"]) for e in entries)
