"""The ConvNeXt family: the JAX package's ``models/convnext.py`` in
PyTorch.

The model takes an NHWC image batch and keeps it NHWC, as the JAX model
does: the convolutions run on its NCHW view, which is channels-last on
the GPU (no copy) and made contiguous on the CPU (ROADMAP C8); the
norms and the pointwise layers work on the channel axis, last.  The
layers follow the JAX model:

* the stem is a 4x4/4 convolution and a LayerNorm; stages 2-4 start
  with a LayerNorm and a 2x2/2 convolution (``Downsample``), both
  padded as flax's ``SAME`` pads them;
* a block is the 7x7 depthwise convolution (``groups = dim``, padded 3),
  LayerNorm, Dense(4 dim), GELU (tanh unless ``gelu_exact``), Dense(dim),
  the per-channel layer scale ``gamma`` (initialised to
  ``layer_scale_init``) and, in training, the drop path: one keep bit a
  sample, the kept samples scaled by 1 / (1 - rate), at a rate rising
  linearly from 0 at the first block to ``drop_path_rate`` at the last;
  the masks are counter-based hashes of (step seed, block, sample)
  (:func:`.common.site_keys`), so remat and graph replays draw the same;
* the global mean pool reduces in float32 and rounds to ``dtype``; the
  head norm and the head run in at least float32, and so do the
  logits.

:class:`.common.LayerNorm` is flax's (eps 1e-6, f32 statistics).
Parameter names follow the official layout (``downsample_layers.{s}``,
``stages.{s}.{b}.{dwconv, norm, pwconv1, pwconv2, gamma}``, ``norm``,
``head``), so the JAX package's ``import_torch_convnext`` reads the
port's ``state_dict`` and :func:`.from_jax.load_flax_convnext` fills it
from a flax tree.  Weights are flax's initialisers (``lecun_normal``
kernels, zero biases), drawn from ``seed`` on the CPU; the model then
moves to ``device`` (default ``cuda``).  ``remat`` recomputes each block
in the backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .common import (LayerNorm, _dropout, conv_nhwc, dense, fan_in_normal,
                     gelu, maybe_remat, site_keys)

__all__ = ["ConvNeXt", "ConvNeXtBlock", "convnext_base", "convnext_large",
           "convnext_small", "convnext_test", "convnext_tiny",
           "convnext_xlarge"]


def _same_pad(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Pad an NHWC ``x`` as flax's ``padding="SAME"`` pads ``conv``'s
    input: to ``ceil(n / stride)`` outputs, the smaller half first."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    pads = []
    for n, k, s in ((x.shape[2], kw, sw), (x.shape[1], kh, sh)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads)) if any(pads) else x


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 → LN → pwconv1 → GELU → pwconv2 → layer scale → drop
    path, added to the input."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6, gelu_exact: bool = False):
        super().__init__()
        self.drop_path, self.gelu_exact = drop_path, gelu_exact
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x, dtype, train: bool = False, key=None):
        y = conv_nhwc(self.dwconv, x, dtype, padding=3)
        y = gelu(dense(self.pwconv1, self.norm(y, dtype), dtype),
                 self.gelu_exact)
        y = dense(self.pwconv2, y, dtype) * self.gamma.to(dtype)
        rate = self.drop_path if train else 0.0
        return x + _dropout(y, rate, key, (y.shape[0], 1, 1, 1))

    def macs(self, h: int) -> int:
        c = self.gamma.numel()
        return h * h * c * (49 + 8 * c)


class ConvNeXt(nn.Module):
    """A ConvNeXt classifier over NHWC images; see the module docstring.
    ``forward(x, train=False, dropout_seed=None)``: the drop path needs
    ``train=True`` and the step's seed (an int, or a 0-d int64 tensor
    on any device)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, *, drop_path_rate: float = 0.0,
                 layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16,
                 gelu_exact: bool = False, remat: bool = False,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if len(depths) != len(dims):
            raise ValueError(f"depths {depths} and dims {dims} differ in "
                             "length")
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.num_classes, self.drop_path_rate = num_classes, drop_path_rate
        self.dtype, self.remat, self.gelu_exact = dtype, remat, gelu_exact
        down = [nn.ModuleList([nn.Conv2d(3, dims[0], 4, 4),
                               LayerNorm(dims[0])])]
        for s in range(1, len(dims)):
            down.append(nn.ModuleList([LayerNorm(dims[s - 1]),
                                       nn.Conv2d(dims[s - 1], dims[s], 2, 2)]))
        self.downsample_layers = nn.ModuleList(down)
        total, block = sum(depths), 0
        stages = []
        for depth, dim in zip(depths, dims):
            blocks = []
            for _ in range(depth):
                # linearly increasing drop-path rate, as in the paper
                dp = drop_path_rate * block / max(total - 1, 1)
                blocks.append(ConvNeXtBlock(dim, dp, layer_scale_init,
                                            gelu_exact))
                block += 1
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.norm = LayerNorm(dims[-1])
        self.head = nn.Linear(dims[-1], num_classes)
        self._init_weights(seed)
        self.to(dev, memory_format=torch.channels_last
                if dev.type == "cuda" else torch.contiguous_format)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(fan_in_normal(m.weight.shape, 1.0, gen))
                m.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def blocks(self):
        """The blocks in order, over every stage."""
        for stage in self.stages:
            yield from stage

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_seed=None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        keys = None
        if train and self.drop_path_rate and dropout_seed is not None:
            keys = site_keys(dropout_seed, sum(self.depths))
        remat = self.remat and torch.is_grad_enabled()
        block = 0
        for s, stage in enumerate(self.stages):
            if s == 0:
                conv, norm = self.downsample_layers[0]
                x = norm(conv_nhwc(conv, _same_pad(x, conv), dt), dt)
            else:
                norm, conv = self.downsample_layers[s]
                x = norm(x, dt)
                x = conv_nhwc(conv, _same_pad(x, conv), dt)
            for blk in stage:
                x = maybe_remat(blk, remat)(
                    x, dt, train, None if keys is None else keys[block])
                block += 1
        x = x.mean(dim=(1, 2))
        hd = torch.promote_types(dt, torch.float32)
        x = self.norm(x, hd)
        return F.linear(x, self.head.weight.to(hd), self.head.bias.to(hd))

    def forward_macs(self, image_size: int) -> int:
        """Multiply-adds of one ``image_size`` x ``image_size`` image's
        forward through the convolutions, the pointwise layers and the
        head, from the layer shapes (norms, GELU, the layer scale and
        sums are not counted)."""
        h = -(-image_size // 4)
        total = h * h * self.dims[0] * 3 * 16
        for s, stage in enumerate(self.stages):
            if s > 0:
                h = -(-h // 2)
                total += h * h * self.dims[s] * self.dims[s - 1] * 4
            total += sum(blk.macs(h) for blk in stage)
        return total + self.dims[-1] * self.num_classes


def _convnext(kw: dict, **defaults) -> ConvNeXt:
    for key, val in defaults.items():
        kw.setdefault(key, val)
    return ConvNeXt(**kw)


def convnext_test(num_classes: int = 10, **kw) -> ConvNeXt:
    """Tiny config for tests and dry runs (not a published variant)."""
    return _convnext(kw, depths=(1, 1, 2, 1), dims=(16, 32, 64, 128),
                     num_classes=num_classes)


def convnext_tiny(num_classes: int = 1000, **kw) -> ConvNeXt:
    return _convnext(kw, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                     num_classes=num_classes)


def convnext_small(num_classes: int = 1000, **kw) -> ConvNeXt:
    return _convnext(kw, depths=(3, 3, 27, 3), dims=(96, 192, 384, 768),
                     num_classes=num_classes)


def convnext_base(num_classes: int = 1000, **kw) -> ConvNeXt:
    return _convnext(kw, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                     num_classes=num_classes)


def convnext_large(num_classes: int = 1000, **kw) -> ConvNeXt:
    return _convnext(kw, depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                     num_classes=num_classes)


def convnext_xlarge(num_classes: int = 1000, **kw) -> ConvNeXt:
    """The BASELINE 'ConvNeXt-XL large-batch (LARS)' config's model."""
    return _convnext(kw, depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048),
                     num_classes=num_classes)
