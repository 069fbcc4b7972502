"""Shared model-building helpers: rematerialisation and the flax
initialisers the image models draw their weights from."""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["fan_in_normal", "maybe_remat"]

# the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def maybe_remat(block: nn.Module, enabled: bool) -> Callable:
    """``block``, or when ``enabled`` a call of it that
    ``torch.utils.checkpoint`` recomputes in the backward instead of
    keeping its activations.  The block stays a submodule where it is,
    so its parameters keep their names (checkpoints and
    :mod:`.from_jax` rely on them)."""
    if not enabled:
        return block
    return functools.partial(checkpoint, block, use_reentrant=False)


def fan_in_normal(shape: Sequence[int], scale: float,
                  gen: torch.Generator) -> torch.Tensor:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    a normal truncated to two standard deviations, scaled to variance
    ``scale / fan_in``.  ``shape`` is a torch weight's, ``[out, in,
    *kernel]``, so the fan-in is the product of all but the first dim
    (``he_normal`` is ``scale=2``, ``lecun_normal`` ``scale=1``)."""
    fan_in = math.prod(shape[1:])
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    bound = math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(tuple(shape)).uniform_(-bound, bound, generator=gen)
    return torch.erfinv(u).clamp_(-math.sqrt(2.0), math.sqrt(2.0)) * (
        math.sqrt(2.0) * std)
