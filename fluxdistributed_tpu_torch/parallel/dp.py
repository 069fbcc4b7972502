"""The data-parallel training step, on one device or across ranks.

Port of ``fluxdistributed_tpu/parallel/dp.py`` (``TrainState``,
``make_train_step``, ``make_train_step_shardmap``, ``make_eval_step``,
``guard_sentinel``).  Without a mesh the step runs on one device.  With
a :class:`..mesh.Mesh` of N ranks every rank holds a replica of the
state and its own rows of the batch (:func:`..sharding.shard_batch`):
it computes the gradient of its rows' mean loss, sums the gradients
over the ranks with an all-reduce and divides by N, and applies the
same update, so the replicas stay equal.  That is the schedule of the
JAX ``make_train_step_shardmap`` (dp.py:376-384); its GSPMD
``make_train_step`` differentiates the global mean instead, which is
the same update up to the order of the sums.  The loss and the mutable
model state are averaged over the ranks the same way, except model
state that the loss function already took over the global batch
(:func:`module_loss_fn` with a mesh: the BatchNorm running stats of
synchronised BatchNorm are equal on every rank, and a mean of N equal
values can differ from them by an ulp where N is not a power of two).
A loss function has the JAX signature::

    loss_fn(params, model_state, batch, train, rng=None)
        -> (loss, (new_model_state, aux))

where ``params`` is a dict of tensors by parameter name (see
:func:`..models.lm_loss_fn` and :func:`module_loss_fn`) and ``rng`` a
dropout seed (an int, or a 0-d int64 tensor on the step's device).  A
step is forward, ``torch.autograd.grad`` of the loss with respect to
the params, then the pure optimizer update, which returns new param
tensors and leaves the old ones as they were until the step has
finished.  A step that fails (a device OOM) therefore leaves the
caller's ``TrainState`` whole, which is what OOM-skip needs.  The
step's host values (dropout seeds, optimizer scalars) reach it through
a device table, and ``steps_per_call=K`` runs K steps a call: a plain
loop on the CPU, one CUDA graph replay on a card (:mod:`.graphs`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import torch

from ..mesh import Mesh
from ..ops.metrics import topkaccuracy
from ..optim import Optimizer, div_const
from . import collectives, graphs

__all__ = ["TrainState", "guard_sentinel", "local_grads", "make_eval_step",
           "make_train_step", "make_train_step_shardmap", "module_loss_fn",
           "step_seeds", "sync_model_state"]


@dataclasses.dataclass
class TrainState:
    """Params (a dict of tensors by name), optimizer state, mutable model
    state and the step counter (a host int: schedules and dropout seeds
    are evaluated on the host each step, and reach the step through its
    table)."""

    params: Dict[str, torch.Tensor]
    opt_state: Any
    model_state: dict
    step: int = 0

    @classmethod
    def create(cls, params, optimizer: Optimizer, model_state=None):
        params = {k: p.detach() for k, p in dict(params).items()}
        return cls(params=params, opt_state=optimizer.init(params),
                   model_state=model_state if model_state is not None else {},
                   step=0)


def module_loss_fn(model, loss: Callable, mesh: Optional[Mesh] = None
                   ) -> Callable:
    """An image model and a loss (e.g. ``ops.logitcrossentropy``) in the
    framework signature ``fn(params, model_state, batch, train,
    rng=None) -> (loss, (model_state, logits))``: the JAX
    ``flax_loss_fn``.

    The batch is ``{"image": [B, H, W, C], "label": ...}``.  ``params``
    and ``model_state`` (the model's buffers by name: BatchNorm running
    stats) go into the model through ``torch.func.functional_call``.  In
    train mode a model with model state returns its new running stats
    as the new ``model_state``, in new tensors: the ``model_state``
    passed in is never written (see :mod:`..models.norm`).  With a
    ``mesh`` the BatchNorm statistics are those of the global batch,
    all-reduced over the mesh's ranks inside every BatchNorm layer (the
    JAX ``jit`` step's global-batch BatchNorm), even at one rank;
    without one they are this rank's rows'.  ``rng`` is the step's
    dropout seed (an int, or a 0-d int64 tensor: the step table's), the
    JAX ``dropout`` stream: in train mode it reaches a model whose
    forward takes a ``dropout_seed`` (ViT dropout, ConvNeXt drop path)."""
    from torch.func import functional_call

    from ..models.norm import BatchStats

    names = {m: n for n, m in model.named_modules()}
    takes_seed = "dropout_seed" in inspect.signature(model.forward).parameters

    def fn(params, model_state, batch, train: bool, rng=None):
        x, y = batch["image"], batch["label"]
        tensors = {**params, **model_state}
        kw = {"train": train}
        if train and takes_seed and rng is not None:
            kw["dropout_seed"] = rng
        if train and model_state:
            stats = BatchStats(mesh)
            out = functional_call(model, tensors, (x,),
                                  {**kw, "stats": stats})
            new = dict(model_state)
            for m, (mean, var) in stats.new.items():
                new[f"{names[m]}.running_mean"] = mean
                new[f"{names[m]}.running_var"] = var
            return loss(out, y), (new, out)
        out = functional_call(model, tensors, (x,), kw)
        return loss(out, y), (model_state, out)

    fn.global_model_state = mesh is not None
    return fn


def sync_model_state(loss_fn: Callable, mstate, mesh: Optional[Mesh]):
    """The model state a step keeps: the mean over the ranks, or
    ``mstate`` itself where ``loss_fn`` computed it over the global
    batch already (:func:`module_loss_fn` with a mesh)."""
    if mesh is None or getattr(loss_fn, "global_model_state", False):
        return mstate
    return collectives.pmean(mstate, mesh)


def _accepts_rng(loss_fn: Callable) -> bool:
    try:
        sig = inspect.signature(loss_fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get("rng")
    return p is not None or any(
        q.kind is inspect.Parameter.VAR_KEYWORD for q in sig.parameters.values())


def _step_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The per-step dropout seed, rooted at the user seed (the JAX
    ``fold_in(PRNGKey(seed), step)``): two seeds draw different masks,
    the same seed reproduces a run.  A rank of a mesh folds in its index
    (the JAX ``fold_in(..., axis_index)``), so the ranks' rows draw
    independent masks; ``rank=None`` is the one-device seed."""
    s = ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    if rank is None:
        return s
    return ((s * 0x100000001B3) ^ (int(rank) + 1)) & 0x7FFFFFFFFFFFFFFF


def guard_sentinel(loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
    """``[poisoned_loss, grad_norm]`` (f32 [2]): the global L2 norm of the
    gradients (f32 accumulation; NaN or Inf anywhere poisons it) and the
    loss plus ``0 * grad_norm``, which equals the loss when the
    gradients are finite and is NaN when anything is not."""
    gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for g in grads.values():
        if g is not None:
            gsq = gsq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gsq)
    return torch.stack([loss.float() + 0.0 * gnorm, gnorm])


def step_seeds(seed: int, step: int, accum_steps: int = 1,
               rank: Optional[int] = None) -> list:
    """The dropout seeds of step ``step``'s microbatches: microbatch
    ``i`` takes the seed of index ``step * accum_steps + i`` rooted at
    ``seed`` (:func:`_step_seed`)."""
    return [_step_seed(seed, step * accum_steps + i, rank)
            for i in range(accum_steps)]


def _check_step_options(accum_steps: int, steps_per_call: int) -> None:
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")


def _grads_of(loss_fn: Callable, accum_steps: int) -> Callable:
    """``fn(params, model_state, batch, seeds) -> (loss, model_state,
    grads)``: :func:`local_grads` with the microbatches' dropout seeds
    given (ints, or a row of int64 tensors)."""
    with_rng = _accepts_rng(loss_fn)

    def grad_of(params, mstate, batch, rng):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        kw = {"rng": rng} if with_rng else {}
        loss, (mstate, _) = loss_fn(leaves, mstate, batch, True, **kw)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        return loss.detach(), mstate, dict(zip(names, grads))

    def fn(params, mstate, batch, seeds):
        if accum_steps == 1:
            return grad_of(params, mstate, batch, seeds[0])
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch of {n} does not split into "
                             f"accum_steps={accum_steps} microbatches")
        micro = {k: v.reshape(accum_steps, n // accum_steps, *v.shape[1:])
                 for k, v in batch.items()}
        gsum, lsum = None, 0.0
        for i in range(accum_steps):
            mb = {k: v[i] for k, v in micro.items()}
            l, mstate, g = grad_of(params, mstate, mb, seeds[i])
            lsum = lsum + l
            # an unused param has a None gradient in every microbatch
            gsum = g if gsum is None else {
                k: None if a is None else a + g[k] for k, a in gsum.items()}
        # the reference divides by the constant accum_steps
        grads = {k: None if g is None else div_const(g, accum_steps)
                 for k, g in gsum.items()}
        return div_const(lsum, accum_steps), mstate, grads

    return fn


def local_grads(loss_fn: Callable, *, accum_steps: int = 1, seed: int = 0,
                mesh: Optional[Mesh] = None) -> Callable:
    """``fn(params, model_state, batch, step) -> (loss, model_state,
    grads)``: the loss and the gradients of this rank's rows, before any
    exchange between ranks (``grads`` maps every param name to a tensor,
    or ``None`` for a param the loss does not use).

    ``accum_steps > 1`` splits the rows into that many microbatches run
    one after the other and averages their gradients and losses.  The
    dropout seeds of step ``step`` are :func:`step_seeds`, with this
    rank folded in when there is a mesh.  The steps of :mod:`.dp`,
    :mod:`.zero1` and :mod:`.zero1_fused` all compute their gradients
    this way."""
    grads_of = _grads_of(loss_fn, accum_steps)
    rank = None if mesh is None else mesh.rank
    return lambda params, mstate, batch, step: grads_of(
        params, mstate, batch, step_seeds(seed, step, accum_steps, rank))


def device_loop(body: Callable, optimizer: Optimizer, *, seed: int,
                accum_steps: int, mesh: Optional[Mesh],
                steps_per_call: int) -> graphs.DeviceLoop:
    """``body(state, batch, seeds, scalars)`` as a train step of
    ``steps_per_call`` steps a call (:class:`.graphs.DeviceLoop`), its
    table rows the step's :func:`step_seeds` and ``optimizer.scalars``."""
    rank = None if mesh is None else mesh.rank

    def host_row(step):
        return (step_seeds(seed, step, accum_steps, rank),
                optimizer.scalars(step))

    return graphs.DeviceLoop(body, host_row, steps_per_call=steps_per_call,
                             n_seeds=accum_steps,
                             n_scalars=len(optimizer.scalars(0)))


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    mesh: Optional[Mesh] = None, accum_steps: int = 1,
                    seed: int = 0, steps_per_call: int = 1,
                    guard: bool = False):
    """``step_fn(state, batch) -> (state, metrics)``.

    ``mesh=None`` runs on one device.  With a mesh, ``batch`` holds this
    rank's rows and ``state`` this rank's replica: the gradients are
    summed over the ranks with an all-reduce and divided by their
    number, and ``metrics["loss"]`` is the mean over the ranks.
    ``accum_steps > 1`` splits the rows into that many microbatches, run
    one after the other (activations of one live at a time), and
    averages their gradients and losses: the same update as one full
    batch for a mean loss.  ``seed`` roots the per-step dropout seed
    (see :func:`local_grads`).  ``guard=True`` adds
    ``metrics["guard"]`` (:func:`guard_sentinel`, of the summed
    gradients).

    ``steps_per_call > 1`` is the JAX device loop: ``batch`` stacks that
    many per-step batches on a new leading dim (the loader's ``chunk``
    layout), the steps run one after the other, and the metrics come
    back stacked (``loss`` [K], ``guard`` [K, 2]).  On a card the K
    steps are one CUDA graph replay, which donates ``state`` (its
    tensors are overwritten by the next call) and captures the
    all-reduces too; see :class:`.graphs.DeviceLoop`.
    """
    _check_step_options(accum_steps, steps_per_call)
    grads_of = _grads_of(loss_fn, accum_steps)

    def body(state: TrainState, batch, seeds, scalars):
        loss, mstate, grads = grads_of(state.params, state.model_state,
                                       batch, seeds)
        with torch.no_grad():
            if mesh is not None:
                grads = collectives.pmean(grads, mesh)
                loss = collectives.pmean(loss, mesh)
            mstate = sync_model_state(loss_fn, mstate, mesh)
            new_params, new_opt = optimizer.rule(
                state.params, grads, state.opt_state, scalars)
            metrics = {"loss": loss}
            if guard:
                metrics["guard"] = guard_sentinel(loss, grads)
        return TrainState(params=new_params, opt_state=new_opt,
                          model_state=mstate, step=state.step + 1), metrics

    return device_loop(body, optimizer, seed=seed, accum_steps=accum_steps,
                       mesh=mesh, steps_per_call=steps_per_call)


def make_train_step_shardmap(loss_fn: Callable, optimizer: Optimizer,
                             mesh: Mesh, *, seed: int = 0):
    """The explicit per-rank DP step under its JAX name: each rank's
    gradients, one all-reduce per gradient, the mean, the same update
    everywhere.  In eager PyTorch this is :func:`make_train_step` with a
    mesh; like the JAX shard_map step it takes no ``accum_steps`` and no
    ``steps_per_call`` (the JAX shard_map step has no device loop)."""
    return make_train_step(loss_fn, optimizer, mesh=mesh, seed=seed)


def make_eval_step(loss_fn: Callable, mesh: Optional[Mesh] = None,
                   topk: tuple = (1, 5, 10)):
    """``eval_fn(state, batch) -> (loss, metrics)`` under ``no_grad``:
    one forward in eval mode gives the loss and, for each ``k`` in
    ``topk``, ``metrics[f"top{k}"]``, the top-k accuracy of the logits
    against ``batch["label"]`` (pass ``topk=()`` for batches without
    labels, e.g. an LM's).  With a mesh, ``batch`` holds this rank's
    rows and the loss and metrics are means over the ranks."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        loss, (_, logits) = loss_fn(state.params, state.model_state, batch,
                                    False)
        metrics = {f"top{k}": topkaccuracy(logits, batch["label"], k=k)
                   for k in topk}
        if mesh is not None:
            loss = collectives.pmean(loss, mesh)
            metrics = collectives.pmean(metrics, mesh)
        return loss, metrics

    return step
