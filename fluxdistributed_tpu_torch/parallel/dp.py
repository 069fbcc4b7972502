"""The training step on one device.

Port of ``fluxdistributed_tpu/parallel/dp.py`` (``TrainState``,
``make_train_step``, ``make_eval_step``, ``guard_sentinel``) for one
device; the mesh, shardings and collectives come with the multi-GPU
slice.  A loss function has the JAX signature::

    loss_fn(params, model_state, batch, train, rng=None)
        -> (loss, (new_model_state, aux))

where ``params`` is a dict of tensors by parameter name (see
:func:`..models.lm_loss_fn`) and ``rng`` an integer dropout seed.  The
step is eager PyTorch: forward, ``torch.autograd.grad`` of the loss with
respect to the params, then the pure optimizer update, which returns new
param tensors and leaves the old ones as they were until the step has
finished.  A step that fails (a device OOM) therefore leaves the
caller's ``TrainState`` whole, which is what OOM-skip needs.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict

import torch

from ..optim import Optimizer

__all__ = ["TrainState", "guard_sentinel", "make_eval_step",
           "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """Params (a dict of tensors by name), optimizer state, mutable model
    state and the step counter (a host int: schedules are evaluated on
    the host each step)."""

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


def _accepts_rng(loss_fn: Callable) -> bool:
    try:
        sig = inspect.signature(loss_fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get("rng")
    return p is not None or any(
        q.kind is inspect.Parameter.VAR_KEYWORD for q in sig.parameters.values())


def _step_seed(seed: int, step: int) -> int:
    """The per-step dropout seed, rooted at the user seed (the JAX
    ``fold_in(PRNGKey(seed), step)``): two seeds draw different masks,
    the same seed reproduces a run."""
    return ((int(seed) & 0x7FFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)


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


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    accum_steps: int = 1, seed: int = 0,
                    steps_per_call: int = 1, guard: bool = False):
    """``step_fn(state, batch) -> (state, metrics)``.

    ``accum_steps > 1`` splits the batch's leading dim into that many
    microbatches, run one after the other (activations of one live at a
    time), and averages their gradients and losses: the same update as
    one full batch for a mean loss.  ``seed`` roots the per-step dropout
    seed (microbatch ``i`` of step ``s`` draws ``s * accum_steps + i``,
    as the JAX step does).  ``guard=True`` adds ``metrics["guard"]``
    (:func:`guard_sentinel`).  ``steps_per_call > 1`` (the JAX device
    loop, a dispatch trick whose counterpart here is a CUDA graph) is
    not ported yet.
    """
    if steps_per_call != 1:
        if steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        raise NotImplementedError(
            "steps_per_call > 1 (the device loop) is not ported: its "
            "counterpart on the GPU is a CUDA graph of the step, planned "
            "for a later slice (ROADMAP)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    with_rng = _accepts_rng(loss_fn)

    def grad_of(params, mstate, batch, step_idx):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        kw = {"rng": _step_seed(seed, step_idx)} if with_rng else {}
        loss, (mstate, _) = loss_fn(leaves, mstate, batch, True, **kw)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        return loss.detach(), mstate, dict(zip(names, grads))

    def step(state: TrainState, batch):
        if accum_steps == 1:
            loss, mstate, grads = grad_of(state.params, state.model_state,
                                          batch, state.step)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} does not split into "
                                 f"accum_steps={accum_steps} microbatches")
            micro = {k: v.reshape(accum_steps, n // accum_steps, *v.shape[1:])
                     for k, v in batch.items()}
            mstate, gsum, lsum = state.model_state, None, 0.0
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in micro.items()}
                l, mstate, g = grad_of(state.params, mstate, mb,
                                       state.step * accum_steps + i)
                lsum = lsum + l
                # an unused param has a None gradient in every microbatch
                gsum = g if gsum is None else {
                    k: None if a is None else a + g[k] for k, a in gsum.items()}
            grads = {k: None if g is None else g / accum_steps
                     for k, g in gsum.items()}
            loss = lsum / accum_steps
        with torch.no_grad():
            new_params, new_opt = optimizer.apply(
                state.params, grads, state.opt_state, state.step)
            metrics = {"loss": loss}
            if guard:
                metrics["guard"] = guard_sentinel(loss, grads)
        return TrainState(params=new_params, opt_state=new_opt,
                          model_state=mstate, step=state.step + 1), metrics

    return step


def make_eval_step(loss_fn: Callable):
    """``eval_fn(state, batch) -> (loss, metrics)`` under ``no_grad``:
    the JAX eval step with ``topk=()`` (the top-k image metrics come with
    the vision slice), so ``metrics`` is empty."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        loss, _ = loss_fn(state.params, state.model_state, batch, False)
        return loss, {}

    return step
