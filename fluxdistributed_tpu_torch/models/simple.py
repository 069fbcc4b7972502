"""Small image models for tests and smoke runs: the JAX package's
``models/simple.py`` (``SimpleCNN``, ``MLP``), which the invariant
tests train in place of a full ResNet.

Both take an NHWC image batch, as the JAX models do.  Weights are drawn
on the CPU from ``seed`` with flax's default initialisers (LeCun normal
kernels, zero biases) and moved to ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .common import fan_in_normal

__all__ = ["MLP", "SimpleCNN", "same_padding"]


def same_padding(size: int, k: int, stride: int) -> tuple:
    """flax's ``padding="SAME"`` along one dim: ``(before, after)``,
    asymmetric (the extra row after) where the total is odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _lecun(module: nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        module.weight.copy_(fan_in_normal(module.weight.shape, 1.0, gen))
        module.bias.zero_()


class SimpleCNN(nn.Module):
    """Conv(3x3) → relu → Conv(3x3, stride 2) → relu → global mean pool
    → Dense, with flax's SAME padding.  Input NHWC; logits f32."""

    def __init__(self, num_classes: int = 10, features: int = 16, *,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, features, 3)
        self.conv2 = nn.Conv2d(features, features * 2, 3, stride=2)
        self.fc = nn.Linear(features * 2, num_classes)
        gen = torch.Generator().manual_seed(seed)
        for m in (self.conv1, self.conv2, self.fc):
            _lecun(m, gen)
        self.to(resolve_device(device))

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        s = conv.stride[0]
        ph = same_padding(x.shape[2], 3, s)
        pw = same_padding(x.shape[3], 3, s)
        x = F.pad(x, (*pw, *ph))
        return F.conv2d(x, conv.weight.to(self.dtype),
                        conv.bias.to(self.dtype), s)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # NCHW: oneDNN's channels-last convolution backward is unsafe on
        # the CPU (see models.resnet), and a model this small gains
        # nothing from the layout on the GPU
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        x = F.relu(self._conv(self.conv1, x))
        x = F.relu(self._conv(self.conv2, x))
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


class MLP(nn.Module):
    """Flatten (NHWC order, as the JAX model reshapes) → Dense → relu →
    ... → Dense.  ``in_features`` is the flattened input size (flax
    infers it at init)."""

    def __init__(self, in_features: int, features: Sequence[int] = (32, 10),
                 *, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dims = (in_features, *features)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        gen = torch.Generator().manual_seed(seed)
        for m in self.layers:
            _lecun(m, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
