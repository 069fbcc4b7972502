"""Model selection: the reference's legacy per-worker trainer.

Port of ``fluxdistributed_tpu/train/model_selection.py`` (the
reference's ``run_distributed`` in ``src/test.jl``): R replicas train
independently, each from its own initial weights and with its own
dropout stream, with no gradient exchange; after each cycle every
replica takes the weights (and optimizer and model state) of the one
with the lowest validation loss.  The reference divides the lr by 5
every 10 cycles: pass ``optim.step_decay(lr0, 0.2, every=10)``.

The JAX version stacks the replicas on a leading axis and ``vmap``s one
step.  Here the replicas are a list and each step is a loop over them:
a BatchNorm layer's running stats come back as new tensors from
``module_loss_fn`` per replica, each replica has its own dropout seeds,
and the same step code serves every model, where ``torch.func.vmap``
cannot take a model whose forward branches on data or writes a buffer.
The R updates are the same arithmetic either way.

Replicas shard over the ranks of a mesh, as the JAX replica axis shards
over ``data_mesh(n)``: rank ``k`` of N holds replicas ``[k R/N, (k + 1)
R/N)``.  Selection gathers the R val losses from every rank, picks the
argmin and broadcasts that replica from the rank that holds it.  With no
mesh all R replicas live on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..mesh import Mesh
from ..ops.losses import logitcrossentropy
from ..ops.metrics import onehot
from ..optim import Optimizer
from ..parallel.dp import _grads_of, _step_seed, module_loss_fn
from ..tree import leaves, to_host, tree_map
from .logging import Logger, current_logger

__all__ = ["SelectionTask", "prepare_model_selection",
           "train_model_selection"]


@dataclasses.dataclass
class SelectionTask:
    """This rank's replicas and the two steps.  ``params``,
    ``opt_state`` and ``model_state`` are lists, one entry a local
    replica (replica ``first + i`` of ``replicas``)."""

    params: List[dict]
    opt_state: List[Any]
    model_state: List[dict]
    dropout_seeds: List[int]
    step_fn: Callable
    select_fn: Callable
    mesh: Optional[Mesh]
    model: Any
    replicas: int
    device: torch.device
    first: int = 0


def prepare_model_selection(
    model: Callable,
    optimizer: Optimizer,
    *,
    mesh: Optional[Mesh] = None,
    replicas: Optional[int] = None,
    loss: Callable = logitcrossentropy,
    input_shape=(32, 32, 3),
    seed: int = 0,
    device: DeviceLike = None,
) -> SelectionTask:
    """R replicas, each with its own initial weights, and the two steps.

    ``model`` builds one replica: ``model(seed=s, device=d)`` returns
    the module (a port model factory, e.g. ``functools.partial(
    models.resnet18, num_classes=10)``); replica ``r`` is built with
    seed ``seed * 65536 + r``, where the JAX version initialises a flax
    module from the r-th split of ``PRNGKey(seed)``.  Each replica's
    dropout stream is its own (root ``(seed + 1) * 65536 + r``).
    ``replicas`` defaults to the mesh's rank count (1 without a mesh)
    and must divide over it.  ``input_shape`` is one sample's
    shape: one forward of a zero batch of it checks the model takes it.
    ``device`` (default ``cuda``, or the mesh's) holds this rank's
    replicas.
    """
    n = 1 if mesh is None else mesh.size
    r = replicas or n
    if r % n:
        raise ValueError(f"replicas ({r}) must divide over the mesh's "
                         f"{n} ranks")
    dev = mesh.device if mesh is not None else resolve_device(device)
    local = r // n
    first = 0 if mesh is None else mesh.rank * local
    modules = [model(seed=seed * 65536 + first + i, device=dev)
               for i in range(local)]
    with torch.no_grad():
        modules[0](torch.zeros((1, *input_shape), device=dev))
    params = [{k: p.detach() for k, p in m.named_parameters()}
              for m in modules]
    mstates = [{k: b.detach().clone() for k, b in m.named_buffers()}
               for m in modules]
    opt_states = [optimizer.init(p) for p in params]
    # each replica's dropout stream: a root of its own, away from the
    # init seeds; step t draws with _step_seed(root, t)
    dropout_seeds = [(seed + 1) * 65536 + first + i for i in range(local)]
    loss_fn = module_loss_fn(modules[0], loss)
    grads_of = _grads_of(loss_fn, 1)

    def step_fn(params, opt_state, mstate, batch, step):
        """One step of every local replica on its own rows
        (``batch[k][i]``): new lists and the train losses [local]."""
        out_p, out_o, out_m, losses = [], [], [], []
        for i in range(len(params)):
            sub = {k: v[i] for k, v in batch.items()}
            l, ms, grads = grads_of(params[i], mstate[i], sub,
                                    [_step_seed(dropout_seeds[i], step)])
            with torch.no_grad():
                p, o = optimizer.apply(params[i], grads, opt_state[i], step)
            out_p.append(p)
            out_o.append(o)
            out_m.append(ms)
            losses.append(l)
        return out_p, out_o, out_m, torch.stack(losses)

    @torch.no_grad()
    def select_fn(params, opt_state, mstate, val_batch):
        """Every replica's val loss, the argmin's weights to all:
        new lists and the R losses (a CPU tensor)."""
        local_losses = torch.stack([
            loss_fn(p, ms, val_batch, False)[0].float()
            for p, ms in zip(params, mstate)])
        if mesh is None:
            losses = local_losses
        else:
            parts = [torch.empty_like(local_losses) for _ in range(n)]
            torch.distributed.all_gather(parts, local_losses,
                                         group=mesh.group)
            losses = torch.cat(parts)
        losses = losses.cpu()
        best = int(torch.argmin(losses))
        owner, i = divmod(best, len(params))
        src = (params[i], opt_state[i], mstate[i])
        if mesh is not None:
            src = tree_map(lambda x: x.clone(), src)
            for x in leaves(src):
                torch.distributed.broadcast(
                    x, src=owner, group=mesh.group)
        clones = [tree_map(lambda x: x.clone(), src)
                  for _ in range(len(params))]
        return ([c[0] for c in clones], [c[1] for c in clones],
                [c[2] for c in clones], losses)

    return SelectionTask(params=params, opt_state=opt_states,
                         model_state=mstates, dropout_seeds=dropout_seeds,
                         step_fn=step_fn, select_fn=select_fn, mesh=mesh,
                         model=modules[0], replicas=r, device=dev,
                         first=first)


def train_model_selection(
    task: SelectionTask,
    dataset,
    val_batch: dict,
    *,
    cycles: int = 10,
    steps_per_cycle: int = 1,
    batch_size_per_replica: int = 8,
    seed: int = 0,
    logger: Optional[Logger] = None,
):
    """The select-the-best loop (``run_distributed``, ``src/test.jl``).

    Each cycle every replica trains ``steps_per_cycle`` steps on its own
    rows of a batch of ``replicas * batch_size_per_replica`` samples
    drawn from ``np.random.default_rng(seed)`` (replica ``r`` takes rows
    ``[r B, (r + 1) B)``, as the JAX version reshapes them), then the
    min-val-loss replica is given to all.  ``val_batch`` is ``{"image",
    "label"}`` (one-hot) on the replicas' device.  Returns CPU copies of
    the selected replica's params and the per-cycle history of the R
    val losses (numpy arrays)."""
    logger = logger or current_logger()
    rng = np.random.default_rng(seed)
    r, bpr = task.replicas, batch_size_per_replica
    local = len(task.params)
    rows = slice(task.first, task.first + local)
    history = []
    step = 0
    for cycle in range(cycles):
        for _ in range(steps_per_cycle):
            imgs, labels = dataset.batch(rng, r * bpr)
            imgs = torch.from_numpy(np.ascontiguousarray(imgs)).reshape(
                r, bpr, *imgs.shape[1:])[rows]
            labels = torch.from_numpy(np.asarray(labels)).reshape(r, bpr)[rows]
            batch = {"image": imgs.to(task.device),
                     "label": onehot(labels.to(task.device),
                                     dataset.nclasses)}
            task.params, task.opt_state, task.model_state, _ = task.step_fn(
                task.params, task.opt_state, task.model_state, batch, step)
            step += 1
        (task.params, task.opt_state, task.model_state,
         val_losses) = task.select_fn(task.params, task.opt_state,
                                      task.model_state, val_batch)
        val_losses = val_losses.numpy()
        history.append(val_losses)
        logger.log({"selection_best_loss": float(val_losses.min()),
                    "selection_best_replica": int(val_losses.argmin()),
                    "selection_mean_loss": float(val_losses.mean())}, cycle)
    return to_host(task.params[0]), history
