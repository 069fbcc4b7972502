"""Functional optimizers: the JAX package's ``optim.py`` on tensors.

Port of ``fluxdistributed_tpu/optim.py``.  The contract is the same pure
one (the reference's Optimisers.jl shape)::

    opt = momentum(0.01, 0.9)
    state = opt.init(params)
    params, state = opt.apply(params, grads, state, step)

with ``params`` and ``grads`` dicts of tensors keyed by parameter name
(a ``None`` gradient marks a frozen parameter: it and its state pass
through untouched).  ``apply`` returns NEW tensors and never writes into
the ones it was given, so a step that fails half way (a device OOM)
leaves the caller's state whole.  These are plain functions with the
JAX op order, not ``torch.optim``: Flux ``Momentum`` is ``v = ρv + ηg;
x -= v``, where ``torch.optim.SGD`` is ``v = ρv + g; x -= ηv``, and the
two drift apart as soon as the learning rate changes.  Scalars (the
bias corrections, the schedules) are computed in float32, as jnp does.

Each rule is split in two so that a captured step (a CUDA graph,
:mod:`.parallel.graphs`) reads them where they live: ``scalars(step)``
computes a step's values on the host, and ``rule(params, grads, state,
s)`` applies the update, reading them from ``s``, a float32 row on the
params' device.  ``apply`` is the two in turn; the train steps fill
``s`` from a device table instead, before each call or replay.

Rules: ``descent``, ``momentum``, ``nesterov``, ``adam``, ``adamw``; the
``clip_by_global_norm`` wrapper; the schedules ``constant``,
``step_decay``, ``cosine_decay``, ``warmup_cosine`` (callables
``step -> lr``, usable anywhere ``lr`` is); ``lars`` (layer-wise
trust ratios for large batches); ``with_ema`` (a shadow average of the
params in the optimizer state, read with ``ema_params``).

The norms of ``lars`` and ``clip_by_global_norm`` are over whole
leaves.  A step whose leaves are blocks of sharded tensors (FSDP, tensor
parallelism) runs the rule under :func:`sharded_norms`, which sums each
leaf's squares over the ranks that hold its blocks.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from .fake import is_fake

Params = Dict[str, Optional[torch.Tensor]]
Schedule = Callable[[Any], Any]
LR = Union[float, Schedule]

__all__ = [
    "Optimizer",
    "adam",
    "adamw",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "descent",
    "div_const",
    "ema_params",
    "global_norm",
    "lars",
    "momentum",
    "nesterov",
    "sharded_norms",
    "step_decay",
    "warmup_cosine",
    "with_ema",
]


def _lr_at(lr: LR, step):
    return lr(step) if callable(lr) else lr


def _f32(x) -> torch.Tensor:
    """A 0-d float32 CPU tensor (jnp's f32 scalar arithmetic)."""
    return torch.as_tensor(x, dtype=torch.float32)


def div_const(x, n):
    """``x / n`` for a constant ``n`` as the reference computes it: XLA
    turns a division by a compile-time constant into a product with its
    f32 reciprocal, which rounds differently from a true division in
    about a third of the entries (where ``n`` is not a power of two).
    A division by a traced value stays a true division; the port divides
    by a tensor on the operand's device there (see :func:`adam`)."""
    return x * _f32(1.0 / n).item()


def _on(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; to a card through pinned memory, without a
    sync (a pageable host-to-device copy synchronises the stream).  A
    fake tensor (a priced step) has no memory to pin."""
    if device.type == "cuda" and not is_fake(x):
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _zeros_like(params: Params):
    return {k: None if p is None else torch.zeros_like(p)
            for k, p in params.items()}


def _no_scalars(step) -> list:
    return []


def _lr_scalars(lr: LR) -> Callable[[Any], list]:
    return lambda step: [_lr_at(lr, step)]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A pure optimizer: ``init(params) -> state``;
    ``apply(params, grads, state, step) -> (params, state)``.

    ``scalars(step)`` lists the step's host values (Python floats or 0-d
    float32 tensors: the learning rate, Adam's bias corrections...);
    ``rule(params, grads, state, s)`` is the update, reading them from
    ``s``, a 1-D float32 tensor on the params' device.  A value is
    rounded to float32 once, where the tensor op that used it as a
    Python number would have rounded it, so the update is the same bit
    for bit whichever way ``s`` arrives."""

    init: Callable[[Params], Any]
    rule: Callable[[Params, Params, Any, torch.Tensor], tuple]
    name: str = "optimizer"
    scalars: Callable[[Any], list] = _no_scalars

    def apply(self, params: Params, grads: Params, state, step=0):
        dev = next((p.device for p in params.values() if p is not None),
                   torch.device("cpu"))
        row = torch.tensor([float(x) for x in self.scalars(step)],
                           dtype=torch.float32)
        return self.rule(params, grads, state, _on(row, dev))

    update = apply
    # the reference's call syntax: ``m, st = opt(m, grads, st)``
    __call__ = apply


def descent(lr: LR = 0.1) -> Optimizer:
    """Plain gradient descent: ``x -= η g``."""

    def init(params):
        return {k: None for k in params}

    def rule(params, grads, state, s):
        eta = s[0]
        new = {k: p if grads.get(k) is None else p - eta * grads[k]
               for k, p in params.items()}
        return new, state

    return Optimizer(init, rule, "descent", _lr_scalars(lr))


def momentum(lr: LR = 0.01, rho: float = 0.9) -> Optimizer:
    """Flux ``Momentum(η, ρ)``: ``v = ρ v + η g; x -= v``."""

    def rule(params, grads, state, s):
        eta = s[0]
        new_p, new_v = {}, {}
        for k, p in params.items():
            g, v = grads.get(k), state[k]
            if g is None:
                new_p[k], new_v[k] = p, v
                continue
            v = rho * v + eta * g
            new_p[k], new_v[k] = p - v, v
        return new_p, new_v

    return Optimizer(_zeros_like, rule, "momentum", _lr_scalars(lr))


def nesterov(lr: LR = 0.01, rho: float = 0.9) -> Optimizer:
    """Flux ``Nesterov(η, ρ)`` lookahead momentum."""

    def scalars(step):
        eta = _lr_at(lr, step)
        return [eta, (1 + rho) * eta]

    def rule(params, grads, state, s):
        eta, eta_ahead = s[0], s[1]
        new_p, new_v = {}, {}
        for k, p in params.items():
            g, v = grads.get(k), state[k]
            if g is None:
                new_p[k], new_v[k] = p, v
                continue
            v2 = rho * v - eta * g
            d = rho * rho * v - eta_ahead * g
            new_p[k], new_v[k] = p + d, v2
        return new_p, new_v

    return Optimizer(_zeros_like, rule, "nesterov", scalars)


def adam(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Bias-corrected Adam (the reference's ``ADAM()``)."""

    def init(params):
        return {k: None if p is None else (torch.zeros_like(p),
                                           torch.zeros_like(p))
                for k, p in params.items()}

    def scalars(step):
        t = _f32(step) + 1.0
        return [_lr_at(lr, step), 1.0 - torch.pow(_f32(b1), t),
                1.0 - torch.pow(_f32(b2), t)]

    def rule(params, grads, state, s):
        # the reference divides by traced bias corrections, a true
        # division: they are tensors on the parameters' device (on CUDA
        # a CPU-scalar divisor would be multiplied by its reciprocal)
        eta, c1, c2 = s[0], s[1], s[2]
        new_p, new_s = {}, {}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_p[k], new_s[k] = p, state[k]
                continue
            m, v = state[k]
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * (g * g)
            mhat = m / c1
            vhat = v / c2
            new_p[k] = p - eta * mhat / (torch.sqrt(vhat) + eps)
            new_s[k] = (m, v)
        return new_p, new_s

    return Optimizer(init, rule, "adam", scalars)


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-2) -> Optimizer:
    """Adam with decoupled weight decay."""
    base = adam(lr, b1, b2, eps)

    def scalars(step):
        return [*base.scalars(step), _lr_at(lr, step) * weight_decay]

    def rule(params, grads, state, s):
        new_p, new_s = base.rule(params, grads, state, s[:3])
        decay = s[3]
        out = {k: np_ if grads.get(k) is None
               else np_ - decay * params[k]
               for k, np_ in new_p.items()}
        return out, new_s

    return Optimizer(base.init, rule, "adamw", scalars)


def lars(lr: LR = 1.0, momentum_coef: float = 0.9, weight_decay: float = 0.0,
         trust_coefficient: float = 1e-3, eps: float = 1e-9) -> Optimizer:
    """LARS: momentum whose step for each leaf is scaled by the trust
    ratio ``trust_coefficient * |p| / (|g| + eps)`` (1 where either norm
    is 0), with ``g`` the gradient plus ``weight_decay * p``:
    ``v = ρ v + η trust g; x -= v``."""

    def rule(params, grads, state, s):
        eta = s[0]
        new_p, new_v = {}, {}
        for k, p in params.items():
            g, v = grads.get(k), state[k]
            if g is None:
                new_p[k], new_v[k] = p, v
                continue
            g = g + weight_decay * p
            p_norm, g_norm = _leaf_norm(k, p), _leaf_norm(k, g)
            # the norms stay on the device: no host sync per leaf
            trust = torch.where((p_norm > 0) & (g_norm > 0),
                                trust_coefficient * p_norm / (g_norm + eps),
                                torch.ones_like(p_norm))
            v = momentum_coef * v + eta * trust * g
            new_p[k], new_v[k] = p - v, v
        return new_p, new_v

    return Optimizer(_zeros_like, rule, "lars", _lr_scalars(lr))


def with_ema(optimizer: Optimizer, decay: float = 0.9999) -> Optimizer:
    """``optimizer`` plus an exponential moving average of the params,
    kept in the optimizer state: each param's slot is ``{"inner": <the
    wrapped rule's slot>, "ema": <shadow>}``.  The decay is
    warmup-corrected, ``min(decay, (1 + t) / (10 + t))`` at step ``t``,
    so early steps do not average against the random init.  The shadow
    starts as a copy of the params and keeps their dtype; read it with
    :func:`ema_params`."""

    def init(params):
        inner = optimizer.init(params)
        return {k: None if p is None else {"inner": inner[k],
                                           "ema": p.detach().clone()}
                for k, p in params.items()}

    def scalars(step):
        t = _f32(step)
        d = torch.clamp((1.0 + t) / (10.0 + t), max=decay)
        return [*optimizer.scalars(step), d, 1.0 - d]

    def rule(params, grads, state, s):
        n = s.shape[0] - 2
        inner = {k: None if st is None else st["inner"]
                 for k, st in state.items()}
        new_p, new_inner = optimizer.rule(params, grads, inner, s[:n])
        d, keep = s[n], s[n + 1]
        out = {}
        for k, st in state.items():
            if st is None:
                out[k] = None
                continue
            p = new_p[k]
            out[k] = {"inner": new_inner[k],
                      "ema": (d * st["ema"] + keep * p).to(p.dtype)}
        return new_p, out

    return Optimizer(init, rule, f"ema{decay}({optimizer.name})", scalars)


def ema_params(opt_state: dict) -> dict:
    """The shadow params of a :func:`with_ema` optimizer state."""
    if not any(isinstance(s, dict) and "ema" in s
               for s in opt_state.values()):
        raise ValueError("opt_state does not carry an EMA (use "
                         "optim.with_ema)")
    return {k: None if s is None else s["ema"] for k, s in opt_state.items()}


# ``fn(name, local_sum_of_squares) -> global_sum_of_squares`` of the
# sharded step whose rule is running, or None: every leaf is whole
_NORM_REDUCE: contextvars.ContextVar = contextvars.ContextVar(
    "norm_reduce", default=None)


@contextlib.contextmanager
def sharded_norms(reduce: Callable):
    """Within the block, the norms of :func:`lars` and
    :func:`global_norm` treat each leaf as this rank's block of a
    sharded tensor: ``reduce(name, sq)`` returns the sum of ``sq`` (the
    block's f32 sum of squares) over the ranks that hold the leaf's
    blocks (a collective, which every one of them reaches in the same
    leaf order)."""
    token = _NORM_REDUCE.set(reduce)
    try:
        yield
    finally:
        _NORM_REDUCE.reset(token)


def _leaf_norm(name: str, x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of leaf ``name``, whole or (under
    :func:`sharded_norms`) summed over its blocks."""
    reduce = _NORM_REDUCE.get()
    if reduce is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(reduce(name, torch.sum(torch.square(x.float()))))


def global_norm(grads: Params) -> torch.Tensor:
    """L2 norm over every non-``None`` gradient (f32 accumulation)."""
    leaves = [(k, g) for k, g in grads.items() if g is not None]
    if not leaves:
        return torch.zeros(())
    sq = [torch.sum(torch.square(g.float())) for _, g in leaves]
    reduce = _NORM_REDUCE.get()
    if reduce is not None:
        sq = [reduce(k, s) for (k, _), s in zip(leaves, sq)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Rescale gradients whose global norm exceeds ``max_norm`` to exactly
    ``max_norm`` before the wrapped rule runs; smaller ones pass
    through.  ``None`` (frozen) gradients are kept.  The scale is
    computed on the device from the gradients: no step scalar."""

    def rule(params, grads, state, s):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        clipped = {k: None if g is None else (g * scale).to(g.dtype)
                   for k, g in grads.items()}
        return optimizer.rule(params, clipped, state, s)

    return Optimizer(optimizer.init, rule,
                     f"clip{max_norm}({optimizer.name})", optimizer.scalars)


def constant(lr: float) -> Schedule:
    return lambda step: lr


def step_decay(lr0: float, factor: float = 0.2, every: int = 10) -> Schedule:
    """Multiply the LR by ``factor`` every ``every`` steps
    (``step_decay(lr, 0.2, 10)`` is the reference's LR/5 every 10)."""

    def sched(step):
        k = torch.floor(div_const(_f32(step), every))
        return lr0 * torch.pow(_f32(factor), k)

    return sched


def cosine_decay(lr0: float, total_steps: int,
                 final_fraction: float = 0.0) -> Schedule:
    def sched(step):
        t = torch.clamp(div_const(_f32(step), max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr0 * (final_fraction + (1.0 - final_fraction) * cos)

    return sched


def warmup_cosine(lr0: float, warmup_steps: int, total_steps: int) -> Schedule:
    cos = cosine_decay(lr0, max(total_steps - warmup_steps, 1))

    def sched(step):
        s = _f32(step)
        warm = div_const(lr0 * s, max(warmup_steps, 1))
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return sched
