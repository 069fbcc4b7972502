"""Multi-process runs: the port's counterpart of
``fluxdistributed_tpu/parallel/multihost.py``.

The JAX package joins one global runtime per host
(``jax.distributed.initialize``) and then runs the same SPMD program
over every chip.  The port already runs one process per device (a
*rank*, :mod:`..mesh`), so a multi-host run is the same process group
formed over TCP instead of by ``torchrun`` or :func:`..mesh.run_ranks`:

* :func:`initialize` forms the group from a coordinator address, the
  number of processes and this process's id (``bin/driver.py``'s
  ``--coordinator``, ``--num-processes``, ``--process-id``), NCCL for a
  CUDA device and gloo for the CPU; with none of them it defers to a
  ``torchrun`` environment, and with neither it runs one process.  A
  partial set of arguments, a partial environment or a coordinator that
  does not answer raises: one host training a private model while the
  others form a smaller world is worse than a failed start;
* :func:`process_index`, :func:`process_count`, :func:`is_coordinator`
  and :func:`local_batch_size` read the group (a process is a rank);
* :func:`global_batch` tags this process's rows with the mesh axis they
  split over, and :func:`commit_to_mesh` cuts this rank's block of a
  host value under a spec (the elastic-restore boundary): each rank
  holds its own block, so neither moves data;
* :func:`host_local_values` all-gathers a value to every process,
  :func:`broadcast_from_coordinator` sends picklable host values from
  rank 0, :func:`sync_global_devices` is a barrier and
  :func:`agree_to_stop` stops every rank when any rank asks to (the
  trainer's preemption boundary).

Each function works with no group too, as one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..mesh import DATA_AXIS, Mesh, init_distributed
from ..sharding import P, local_block
from ..tree import tree_map

__all__ = [
    "GlobalBatch",
    "agree_to_stop",
    "broadcast_from_coordinator",
    "commit_to_mesh",
    "global_batch",
    "host_local_values",
    "initialize",
    "is_coordinator",
    "is_distributed",
    "local_batch_size",
    "process_count",
    "process_index",
    "sync_global_devices",
]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: DeviceLike = None,
               timeout: float = 300.0) -> Optional[Mesh]:
    """Form (or join) the process group and return this rank's
    :class:`..mesh.Mesh`, or ``None`` when the run is one process with
    no group.

    ``coordinator_address`` is ``host:port`` of process 0's store; with
    it, ``num_processes`` and ``process_id`` are required.  A CUDA
    process drives ``cuda:LOCAL_RANK`` when that is set, else device
    ``process_id`` modulo the host's card count.  ``timeout`` bounds the
    wait for every process to join (it raises when passed).  With no
    arguments a ``torchrun`` environment forms the group
    (:func:`..mesh.init_distributed`, which raises on a partial one);
    without one this is one process and nothing is formed."""
    given = [a is not None for a in (coordinator_address, num_processes,
                                     process_id)]
    if any(given) and not all(given):
        raise ValueError(
            "a multi-process run needs all of the coordinator address, the "
            "number of processes and this process's id (got "
            f"coordinator={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})")
    if dist.is_initialized():
        if all(given) and (dist.get_world_size() != num_processes
                           or dist.get_rank() != process_id):
            raise ValueError(
                f"a process group of {dist.get_world_size()} ranks (this "
                f"rank {dist.get_rank()}) is already formed; asked for "
                f"process {process_id} of {num_processes}")
        return init_distributed(device)
    if not any(given):
        if any(k in os.environ for k in _TORCHRUN_ENV):
            return init_distributed(device)
        return None
    dev = resolve_device(device)
    n, pid = int(num_processes), int(process_id)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process id {pid} is not in [0, {n})")
    if dev.type == "cuda":
        if "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        elif dev.index is not None:
            index = dev.index
        else:
            index = pid % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        # the communicator binds the current device
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=addr, world_size=n, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout))
    return init_distributed(dev)


def is_distributed() -> bool:
    """More than one process."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Process 0: it logs, serves metrics and writes checkpoints."""
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """Rows of the global batch this process supplies."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} processes")
    return global_batch_size // n


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This process's rows of a global batch (``local``: a tree of
    tensors on the mesh's device), split over ``axis`` of ``mesh``: the
    port's counterpart of a ``jax.Array`` sharded ``P(axis)``.
    :meth:`gather` is the global value (a collective)."""

    local: Any
    axis: Any
    mesh: Mesh

    @property
    def spec(self) -> P:
        return P(self.axis)

    def gather(self) -> Any:
        from ..sharding import gather_global

        return tree_map(lambda x: gather_global(x, self.spec, self.mesh),
                        self.local)


def global_batch(local: Any, mesh: Mesh, axis=DATA_AXIS) -> GlobalBatch:
    """This process's rows ``local`` (numpy arrays or tensors, leading
    dim the global batch over the axis's ranks), placed on the mesh's
    device and tagged with ``axis``.  No data moves: each rank feeds
    only its own rows."""
    def put(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=mesh.device)

    return GlobalBatch(tree_map(put, local), axis, mesh)


def commit_to_mesh(x, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block under ``spec`` of the host value ``x`` (the
    same global value on every rank), on the mesh's device: how a
    checkpoint saved on one topology is placed on another.  Each rank
    cuts its own block; nothing is sent."""
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return local_block(t.to(mesh.device), spec, mesh)


def _device() -> torch.device:
    """The device the default group's backend serves."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_local_values(x) -> np.ndarray:
    """Every process's ``x`` (equal shapes), concatenated on dim 0 in
    process order, on every process: a value read at a log or eval
    boundary."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if process_count() == 1:
        return a
    t = torch.as_tensor(np.ascontiguousarray(a)).to(_device())
    t = t.reshape((1,) + tuple(t.shape)) if t.dim() == 0 else t
    out = torch.empty((process_count() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous())
    return out.cpu().numpy()


def broadcast_from_coordinator(tree: Any) -> Any:
    """Process 0's picklable host value on every process."""
    if process_count() == 1:
        return tree
    box = [tree if is_coordinator() else None]
    dist.broadcast_object_list(box, src=0, device=_device())
    return box[0]


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier over every process (``tag`` names it in errors)."""
    if process_count() == 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed: {e}") from e


def agree_to_stop(local_stop: bool, group=None,
                  device: Optional[torch.device] = None) -> bool:
    """True on every rank when any rank of ``group`` (the default group:
    every process) passes True, so all of them stop at the same step and
    none waits in a collective the others never enter.  ``device`` is
    the tensor's (default: the one the backend serves)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return bool(local_stop)
    flag = torch.tensor([float(bool(local_stop))],
                        device=device if device is not None else _device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())
