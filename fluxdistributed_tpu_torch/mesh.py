"""Process groups: the port's counterpart of the JAX package's ``mesh.py``.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` whose
``data`` axis holds N devices.  Eager PyTorch runs one process per
device instead: each process (a *rank*) holds one replica, and the ranks
meet in ``torch.distributed`` collectives.  So the data axis becomes a
process group, and a :class:`Mesh` is that group seen from one rank: its
rank, the number of ranks and the rank's device.

* :func:`init_distributed` forms the group.  Under ``torchrun`` it reads
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``;
  with none of them set it forms a one-rank group over an in-memory
  store (no file, no port).  The backend is ``nccl`` for a CUDA device
  and ``gloo`` for the CPU, and nothing else: a CUDA rank never falls
  back to gloo.
* :func:`data_mesh` is the :class:`Mesh` of the current group (formed
  first when there is none).
* :func:`make_mesh` and :func:`make_mesh_3d` lay named axes over the
  ranks (``{"data": 2, "model": 2}``; ``(data, fsdp, model)``): rank
  ``r`` takes the coordinates of JAX device ``r`` of the same mesh (row
  major, the last axis fastest), so rank ``r``'s block of a sharded
  tensor is JAX device ``r``'s.  The process group of every axis, and of
  every tuple of axes (the joint ``(data, fsdp)`` batch), is formed up
  front, on every rank in the same order; :meth:`Mesh.sub` is the mesh
  over some of the axes, whose ``group`` is theirs;
* :func:`run_ranks` is the counterpart of ``force_host_devices(n)``: it
  spawns ``n`` gloo ranks on the CPU, runs a function in each and returns
  what each returned.  The N-replica tests are built on it.

NCCL refuses two ranks on one GPU, so on a one-GPU machine the world is
one rank; the N-rank schedule runs on gloo CPU ranks there.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device

__all__ = ["DATA_AXIS", "FSDP_AXIS", "MODEL_AXIS", "Mesh", "data_mesh",
           "init_distributed", "make_mesh", "make_mesh_3d", "run_ranks",
           "shutdown_distributed"]

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh from one rank: the process ``group`` of all its ranks
    (``None`` is the default group), this process's ``rank`` in it, the
    number of ranks ``size`` and the rank's ``device``.

    A mesh of :func:`data_mesh` has one axis, ``axis``.  A mesh of
    :func:`make_mesh` has the ordered ``axes`` (``(name, size)`` pairs),
    this rank's ``coords`` on them and ``groups``, the process group of
    each tuple of axis names (the ranks that differ only on those
    axes)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = DATA_AXIS
    axes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[int, ...] = ()
    groups: Mapping[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes) if self.axes else (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` for every axis in order, as a JAX mesh's
        ``shape`` reads."""
        return dict(self.axes) if self.axes else {self.axis: self.size}

    @property
    def coord(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        return (dict(zip(self.axis_names, self.coords)) if self.axes
                else {self.axis: self.rank})

    def _names(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [a for a in names if a not in self.shape]
        if bad:
            raise ValueError(f"axis {bad} is not on the mesh (axes: "
                             f"{list(self.shape)})")
        return names

    def axis_size(self, axes) -> int:
        """The size of one axis, or the product over a tuple of them."""
        return math.prod(self.shape[a] for a in self._names(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along one axis, or along a tuple of them
        jointly (row major over the tuple, as a JAX spec entry
        ``("data", "fsdp")`` tiles a dim)."""
        idx = 0
        for a in self._names(axes):
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def group_of(self, axes) -> Any:
        """The process group of the ranks that differ from this one only
        on ``axes`` (one name or a tuple)."""
        names = self._names(axes)
        if not self.axes or set(names) == set(self.axis_names):
            return self.group
        return self.groups[tuple(sorted(names, key=self.axis_names.index))]

    def sub(self, axes) -> "Mesh":
        """The mesh over ``axes`` (one name or a tuple, in this mesh's
        order) that holds this rank: its group is theirs, its rank this
        rank's joint index on them.  A one-axis sub-mesh is what the
        data-parallel code takes (``pmean`` over it, a batch split over
        it)."""
        names = self._names(axes)
        order = tuple(sorted(names, key=self.axis_names.index))
        if order != names:
            raise ValueError(f"axes {names} are out of the mesh's order "
                             f"{self.axis_names}")
        groups = {k: v for k, v in self.groups.items()
                  if set(k) <= set(names) and k != names}
        return Mesh(group=self.group_of(names), rank=self.axis_index(names),
                    size=self.axis_size(names), device=self.device,
                    axis=names[0],
                    axes=tuple((a, self.shape[a]) for a in names),
                    coords=tuple(self.coord[a] for a in names),
                    groups=groups)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device: DeviceLike = None) -> Mesh:
    """Form the process group and return this rank's :class:`Mesh`.

    ``device`` is ``cuda`` (the default) or ``cpu``.  Under ``torchrun``
    a CUDA rank takes ``cuda:LOCAL_RANK``.  A group that is already
    formed is returned as it is, after its backend is checked against
    the device."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return data_mesh(device=dev)
    present = [k for k in _ENV if k in os.environ]
    if present and len(present) != len(_ENV):
        missing = sorted(set(_ENV) - set(present))
        raise ValueError(f"torchrun environment is incomplete: {present} set, "
                         f"{missing} missing")
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        dev = torch.device("cuda", index)
        # the group's communicator binds the current device
        torch.cuda.set_device(dev)
    if present:
        dist.init_process_group(_backend(dev), init_method="env://")
    else:
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    return data_mesh(device=dev)


def data_mesh(n: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """The :class:`Mesh` of the default group over all its ranks (formed
    by :func:`init_distributed` first when there is none).  ``n``, when
    given, must equal the number of ranks.  With ``device=None`` an
    existing group's backend picks the device (gloo: the CPU)."""
    if not dist.is_initialized():
        return init_distributed(device)
    backend = dist.get_backend()
    dev = resolve_device(
        "cpu" if device is None and backend == "gloo" else device)
    if backend != _backend(dev):
        raise ValueError(f"the process group runs {backend}, which does not "
                         f"serve {dev.type} tensors (nccl: cuda, gloo: cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    size = dist.get_world_size()
    if n is not None and n != size:
        raise ValueError(f"requested {n} ranks but the group has {size}")
    return Mesh(group=None, rank=dist.get_rank(), size=size, device=dev)


def make_mesh(axes: Mapping[str, int], device: DeviceLike = None) -> Mesh:
    """An N-D mesh with named axes over the ranks of the default group,
    e.g. ``make_mesh({"data": 2, "model": 2})`` on 4 ranks.

    Axis order follows the mapping's; the sizes must multiply to the
    number of ranks.  Rank ``r`` sits at the row-major coordinates of
    ``r`` (the last axis fastest), where the JAX package's ``make_mesh``
    puts device ``r`` (``np.array(devs).reshape(shape)``).  Every tuple
    of axes gets its process group, formed on every rank in one order
    (``dist.new_group``); a group that holds every rank is the default
    group itself.  The backend is the default group's (NCCL for the
    card, gloo for CPU ranks).  The group is formed first when there is
    none (:func:`init_distributed`)."""
    base = data_mesh(device=device)
    names = tuple(axes)
    shape = tuple(int(v) for v in axes.values())
    for n, v in zip(names, shape):
        if v < 1:
            raise ValueError(f"mesh axis {n!r} size {v} must be >= 1")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axes repeat a name: {names}")
    if math.prod(shape) != base.size:
        raise ValueError(f"mesh {dict(axes)} needs {math.prod(shape)} ranks, "
                         f"the group has {base.size}")
    coords = _unravel(base.rank, shape)
    groups = {}
    for k in range(1, len(names)):
        for sub in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in sub]
            mine = None
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                ranks = [r for r in range(base.size)
                         if all(_unravel(r, shape)[i] == c
                                for i, c in zip(rest, fixed))]
                g = (None if len(ranks) == base.size
                     else dist.new_group(ranks))
                if base.rank in ranks:
                    mine = g
            groups[tuple(names[i] for i in sub)] = mine
    return Mesh(group=base.group, rank=base.rank, size=base.size,
                device=base.device, axis=names[0],
                axes=tuple(zip(names, shape)), coords=coords, groups=groups)


def _unravel(r: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def make_mesh_3d(dp: int = 1, fsdp: int = 1, tp: int = 1,
                 device: DeviceLike = None) -> Mesh:
    """The dp x fsdp x tp mesh ``(data, fsdp, model)`` (the JAX
    ``make_mesh_3d``): size-1 axes are kept, so every spec a rule table
    derives names the same three axes whatever the layout.  ``dp``
    replicates parameters, ``fsdp`` shards parameters and optimizer
    state (the batch splits over ``data`` and ``fsdp`` jointly), ``tp``
    is the Megatron model axis."""
    for name, v in (("dp", dp), ("fsdp", fsdp), ("tp", tp)):
        if v < 1:
            raise ValueError(f"make_mesh_3d {name}={v} must be >= 1")
    return make_mesh({DATA_AXIS: dp, FSDP_AXIS: fsdp, MODEL_AXIS: tp},
                     device=device)


def shutdown_distributed() -> None:
    """Destroy the default group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, n: int, store: str, out_dir: str, fn: Callable,
               args: tuple) -> None:
    # one intra-op thread per rank: N ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        mesh = data_mesh(device="cpu")
        result = fn(mesh, *args)
        # every rank reaches the end before any leaves the group
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn: Callable, n: int, *args) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``n`` spawned gloo ranks on the CPU and
    return each rank's result, in rank order.

    ``fn`` must be importable by name (a module-level function) and
    should import no more than it needs: each rank is a fresh
    interpreter.  Results travel through ``torch.save``.  A rank that
    raises makes this raise with its traceback.  Each rank runs one
    intra-op thread."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    tmp = tempfile.mkdtemp(prefix="fdtpu_ranks_")
    try:
        mp.start_processes(
            _rank_main,
            args=(n, os.path.join(tmp, "store"), tmp, fn, args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
