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
* :func:`run_ranks` is the counterpart of ``force_host_devices(n)``: it
  spawns ``n`` gloo ranks on the CPU, runs a function in each and returns
  what each returned.  The N-replica tests are built on it.

NCCL refuses two ranks on one GPU, so on a one-GPU machine the world is
one rank; the N-rank schedule runs on gloo CPU ranks there.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device

__all__ = ["DATA_AXIS", "Mesh", "data_mesh", "init_distributed",
           "run_ranks", "shutdown_distributed"]

DATA_AXIS = "data"

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis from one rank: the process ``group`` (``None`` is
    the default group), this process's ``rank``, the number of ranks
    ``size`` and the rank's ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = DATA_AXIS

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape`` reads."""
        return {self.axis: self.size}


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
