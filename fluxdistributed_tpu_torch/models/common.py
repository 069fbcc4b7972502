"""Shared model-building helpers: rematerialisation, the flax
initialisers the image models draw their weights from, flax's ``Dense``
and ``LayerNorm`` in a compute dtype, the two GELUs, and the
counter-based dropout masks."""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["LayerNorm", "conv_nhwc", "dense", "fan_in_normal", "gelu",
           "maybe_remat", "site_keys"]

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


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """``x @ W^T + b`` in the compute dtype (flax ``Dense(dtype=...)``)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
              padding=0) -> torch.Tensor:
    """``conv`` (with its bias) over an NHWC batch in the compute dtype,
    NHWC out.  On the GPU the NCHW view of an NHWC tensor is
    channels-last, so no copy is made; on the CPU the convolution runs
    NCHW (ROADMAP C8)."""
    xc = x.to(dtype).permute(0, 3, 1, 2)
    if xc.device.type == "cpu":
        xc = xc.contiguous()
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(xc, conv.weight.to(dtype), b, conv.stride, padding,
                 groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """flax's ``nn.gelu``: the erf form when ``exact`` (PyTorch's and
    torchvision's default), else the tanh approximation (the JAX
    models' default, ``gelu_exact=False``)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last dim, with its epsilon
    (1e-6) and its arithmetic: the statistics in at least float32 (the
    promotion of the input's dtype with float32), the variance formed as
    ``E[x²] - E[x]²`` clipped at 0 (flax's ``use_fast_variance``), the
    input normalised as ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in that precision, and the result cast to ``dtype`` (the
    input's when ``None``).  This is the formula written out, not a
    library kernel: in float64 it is flax's float64, and in float32 it
    cancels where flax's does (ROADMAP C7)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        st = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(st)
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp((xs * xs).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(st)
        y = (xs - mean) * mul + self.bias.to(st)
        return y.to(x.dtype if dtype is None else dtype)


# ------------------------------------------------------------- dropout

_HASH_MUL = 0x045D9F3B  # T. Mueller's 32-bit integer hash constant
_M32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer hash (two multiply-xorshift rounds), the same
    bits on a Python int in [0, 2^32) and on an int32 tensor, where it
    computes in two's complement: shifts are masked to act as logical
    shifts and products wrap."""
    if isinstance(x, int):
        for _ in range(2):
            x = ((x ^ (x >> 16)) * _HASH_MUL) & _M32
        return x ^ (x >> 16)
    for _ in range(2):
        x = torch.bitwise_xor(x, torch.bitwise_and(x >> 16, 0xFFFF))
        x = x * _HASH_MUL
    return torch.bitwise_xor(x, torch.bitwise_and(x >> 16, 0xFFFF))


def _int32(x: int) -> int:
    """The signed value of 32 bits (an int32 tensor's view of them)."""
    return x - (1 << 32) if x >= 1 << 31 else x


def site_keys(seed, n: int):
    """The keys of ``n`` dropout sites of one forward, in the model's
    site order, hashed from the step seed (a non-negative integer below
    2^63).  An int seed gives Python ints (no device work); a 0-d int64
    tensor (the step table's seed column, read inside a captured step)
    gives an int32 tensor on its device.  Either way the same 32 bits."""
    if isinstance(seed, int):
        base = _hash32(_hash32(seed & _M32) ^ (seed >> 32))
        return [_int32(_hash32(base ^ _hash32(i + 1))) for i in range(n)]
    s = seed.to(torch.int64)
    lo = torch.bitwise_and(s, _M32).to(torch.int32)
    hi = (s >> 32).to(torch.int32)
    base = _hash32(torch.bitwise_xor(_hash32(lo), hi))
    ids = torch.arange(1, n + 1, dtype=torch.int32, device=s.device)
    return _hash32(torch.bitwise_xor(base, _hash32(ids)))


def _shard_index(shape, offset: int, total: int,
                 device) -> torch.Tensor:
    """The element indices of positions ``[offset, offset + shape[1])``
    of a ``[shape[0], total, *shape[2:]]`` tensor, row major, int32."""
    rest = math.prod(shape[2:])
    if shape[0] * total * rest >= 1 << 31:
        raise ValueError(f"dropout indexes elements with int32: "
                         f"{shape[0] * total * rest} elements are too many")

    def ar(n, at):
        view = [1] * 3
        view[at] = n
        return torch.arange(n, dtype=torch.int32, device=device).view(view)

    idx = (ar(shape[0], 0) * (total * rest)
           + (ar(shape[1], 1) + offset) * rest + ar(rest, 2))
    return idx.view(shape)


def _dropout(x: torch.Tensor, rate: float, key,
             mask_shape: Optional[Sequence[int]] = None,
             seq: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``.  The mask is a counter-based hash
    of (``key``, element index): it depends on the step seed and the
    site (through ``key``, see :func:`site_keys`) and nothing else — no
    generator state — so a recompute under ``torch.utils.checkpoint``
    and a replay of a captured step draw the same mask, and the CPU
    draws the card's.  An element is kept where its hash, read as a
    signed 32-bit integer, is at least ``-2^31 + round(rate * 2^32)``.
    ``mask_shape`` (flax's ``broadcast_dims``: 1 on each broadcast dim)
    draws one bit per entry of that shape, broadcast over ``x``: the
    drop path's ``[B, 1, 1, 1]`` keeps or drops whole samples.
    ``seq=(offset, total)`` says that ``x``'s dim 1 holds positions
    ``[offset, offset + x.shape[1])`` of a sequence of ``total`` (a
    sequence shard, :mod:`..parallel.context`): each element is indexed
    as in the whole sequence, so the shards together draw the mask of
    one rank running all of it."""
    if not rate:
        return x
    if key is None:
        raise ValueError("dropout > 0 in training needs a dropout seed (the "
                         "rng of the loss function / make_train_step)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape if mask_shape is None else mask_shape)
    n = math.prod(shape)
    if n >= 1 << 31:
        raise ValueError(f"dropout indexes elements with int32: {n} "
                         "elements are too many")
    if seq is not None and (seq[0] or seq[1] != shape[1]):
        idx = _shard_index(shape, seq[0], seq[1], x.device)
    else:
        idx = torch.arange(n, dtype=torch.int32, device=x.device).view(shape)
    h = _hash32(torch.bitwise_xor(idx, key))
    keep = h >= -(1 << 31) + min(round(rate * (1 << 32)), _M32)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
