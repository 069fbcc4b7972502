"""The ResNet family: the JAX package's ``models/resnet.py`` in PyTorch.

The model takes an NHWC image batch, as the JAX model does, casts it to
the compute ``dtype`` (bfloat16 by default; the parameters stay
float32) and permutes it to NCHW, which for a contiguous NHWC tensor is
a ``channels_last`` view: no copy, and on the GPU every convolution
after it runs channels-last.  The layers follow the JAX model:

* the stem is a 7x7/2 convolution with padding 3 (or, with
  ``space_to_depth``, the equivalent 4x4/1 convolution over the
  space-to-depth input, padded (2, 1)), BatchNorm, relu, and a 3x3/2
  max pool with padding 1 (padding counts as ``-inf``);
* 3x3 convolutions are padded 1, and a block's last BatchNorm starts at
  scale 0;
* the global mean pool reduces in float32 and rounds to ``dtype``, the
  dense head runs in float32, and the logits are float32;
* BatchNorm (:mod:`.norm`) computes in ``norm_dtype`` (default
  ``dtype``) with float32 statistics, and returns its new running stats
  instead of writing them (see :class:`.norm.BatchStats`).

Parameter and buffer names are torchvision's (``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{j}`` / ``bn{j}`` / ``downsample.{0,1}``, ``fc``),
so the JAX package's ``import_torch_resnet`` reads the port's
``state_dict`` and :func:`.from_jax.load_flax_resnet` fills the port
from a flax tree.  Convolutions draw ``he_normal`` weights and the head
``variance_scaling(1, fan_in, truncated_normal)`` ones, from ``seed`` on
the CPU; the model then moves to ``device`` (default ``cuda``) with its
conv weights channels-last (on the CPU the convolutions run NCHW: see
``ResNet.__init__``).  ``remat`` recomputes each residual block in
the backward (:func:`.common.maybe_remat`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .common import fan_in_normal, maybe_remat
from .norm import BatchNorm, BatchStats

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "s2d_stem_kernel", "space_to_depth"]


def space_to_depth(x, block: int = 2):
    """NHWC ``[B, H, W, C]`` → ``[B, H/b, W/b, b²·C]``: each ``b x b``
    pixel block becomes channels, ordered (row offset, column offset,
    channel).  Takes a tensor or a numpy array."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"image {h}x{w} does not split into {block}x{block} "
                         "blocks")
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = (x.permute(0, 1, 3, 2, 4, 5) if torch.is_tensor(x)
         else x.transpose(0, 1, 3, 2, 4, 5))
    return x.reshape(b, h // block, w // block, block * block * c)


def s2d_stem_kernel(w) -> torch.Tensor:
    """A 7x7 stride-2 stem weight ``[O, C, 7, 7]`` re-laid as the equal
    4x4 stride-1 weight ``[O, 4C, 4, 4]`` over :func:`space_to_depth`
    input (padded (2, 1)): the 7 taps padded to 8 with a leading zero,
    each 2x2 sub-block contracting against its space-to-depth channel
    group."""
    w = torch.as_tensor(w).permute(2, 3, 1, 0)  # HWIO
    kh, kw, c, o = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the s2d re-layout is for the 7x7 stem, got "
                         f"{kh}x{kw}")
    w8 = w.new_zeros(8, 8, c, o)
    w8[1:, 1:] = w
    w8 = w8.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
    return w8.reshape(4, 4, 4 * c, o).permute(3, 2, 0, 1).contiguous()


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    if x.device.type == "cpu":
        x = x.contiguous()  # NCHW on the CPU: see ResNet.__init__
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


def _conv_macs(conv: nn.Conv2d, h: int) -> tuple:
    """Multiply-adds of ``conv`` on an ``h x h`` input, and its output
    side."""
    o, i, kh, kw = conv.weight.shape
    ho = (h + 2 * conv.padding[0] - kh) // conv.stride[0] + 1
    return ho * ho * o * i * kh * kw, ho


class BasicBlock(nn.Module):
    """3x3 → 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, norm):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, filters, 3, stride, 1, bias=False)
        self.bn1 = norm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = norm(filters, zero_scale=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.ModuleList([
                nn.Conv2d(cin, filters, 1, stride, bias=False),
                norm(filters)])

    def forward(self, x, train: bool = False,
                stats: Optional[BatchStats] = None):
        dt = self.dtype
        y = F.relu(self.bn1(_conv(self.conv1, x, dt), train, stats))
        y = self.bn2(_conv(self.conv2, y, dt), train, stats)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(_conv(conv, x, dt), train, stats)
        return F.relu(y + x)

    def macs(self, h: int) -> tuple:
        m1, ho = _conv_macs(self.conv1, h)
        m2, _ = _conv_macs(self.conv2, ho)
        md = 0 if self.downsample is None else _conv_macs(
            self.downsample[0], h)[0]
        return m1 + m2 + md, ho


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck block (ResNet-50/101/152); the
    stride sits on the 3x3 convolution."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, norm):
        super().__init__()
        self.dtype = dtype
        out = filters * 4
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = norm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = norm(filters)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = norm(out, zero_scale=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.ModuleList([
                nn.Conv2d(cin, out, 1, stride, bias=False), norm(out)])

    def forward(self, x, train: bool = False,
                stats: Optional[BatchStats] = None):
        dt = self.dtype
        y = F.relu(self.bn1(_conv(self.conv1, x, dt), train, stats))
        y = F.relu(self.bn2(_conv(self.conv2, y, dt), train, stats))
        y = self.bn3(_conv(self.conv3, y, dt), train, stats)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(_conv(conv, x, dt), train, stats)
        return F.relu(y + x)

    def macs(self, h: int) -> tuple:
        m1, _ = _conv_macs(self.conv1, h)
        m2, ho = _conv_macs(self.conv2, h)
        m3, _ = _conv_macs(self.conv3, ho)
        md = 0 if self.downsample is None else _conv_macs(
            self.downsample[0], h)[0]
        return m1 + m2 + m3 + md, ho


class ResNet(nn.Module):
    """A ResNet over NHWC images; see the module docstring.

    ``forward(x, train=False, stats=None)``: eval mode normalises with
    the running stats; ``train=True`` with the batch's, and records the
    new running stats in ``stats`` (a :class:`.norm.BatchStats`, which
    also names the mesh the statistics are taken over) when one is
    given.  The running-stat buffers themselves never change."""

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_classes: int = 1000, *, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: Optional[torch.dtype] = None,
                 bn_momentum: float = 0.9, remat: bool = False,
                 space_to_depth: bool = False, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes, self.block = tuple(stage_sizes), block
        self.num_classes, self.width = num_classes, width
        self.dtype, self.remat = dtype, remat
        self.space_to_depth = space_to_depth
        norm = functools.partial(
            BatchNorm, momentum=bn_momentum, eps=1e-5,
            dtype=norm_dtype if norm_dtype is not None else dtype)
        if space_to_depth:
            self.conv1 = nn.Conv2d(12, width, 4, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = norm(width)
        cin = width
        for i, n in enumerate(self.stage_sizes):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, width * 2 ** i,
                                    2 if i > 0 and j == 0 else 1,
                                    dtype=dtype, norm=norm))
                cin = width * 2 ** i * block.expansion
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(cin, num_classes)
        self._init_weights(seed)
        # channels-last on the GPU; NCHW on the CPU, where oneDNN's
        # channels-last convolution backward corrupts the heap at some
        # shapes (torch 2.13: a strided 1x1 weight gradient over 6 x 8 x
        # 16 x 16, ResNet-18's at 64² and batch 6)
        self.to(dev, memory_format=torch.channels_last
                if dev.type == "cuda" else torch.contiguous_format)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(fan_in_normal(m.weight.shape, 2.0, gen))
        self.fc.weight.copy_(fan_in_normal(self.fc.weight.shape, 1.0, gen))
        self.fc.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def blocks(self):
        """The residual blocks in order, over every stage."""
        for i in range(len(self.stage_sizes)):
            yield from getattr(self, f"layer{i + 1}")

    def stem(self, x: torch.Tensor, train: bool = False,
             stats: Optional[BatchStats] = None) -> torch.Tensor:
        """NHWC input → the max pool's NCHW output (channels-last on the
        GPU)."""
        x = x.to(self.dtype)
        if self.space_to_depth:
            if x.shape[-1] == 3:
                x = space_to_depth(x)  # prefer feeding it pre-transformed
            # pad H and W by (2, 1) while NHWC, so the view stays
            # channels-last
            x = F.pad(x, (0, 0, 2, 1, 2, 1))
        x = _conv(self.conv1, x.permute(0, 3, 1, 2), self.dtype)
        x = F.relu(self.bn1(x, train, stats))
        return F.max_pool2d(x, 3, 2, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[BatchStats] = None) -> torch.Tensor:
        x = self.stem(x, train, stats)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks():
            x = maybe_remat(blk, remat)(x, train, stats)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)

    def forward_macs(self, image_size: int) -> int:
        """Multiply-adds of one ``image_size`` x ``image_size`` image's
        forward through the convolutions and the dense head, from the
        layers' own shapes (BatchNorm, pooling and the residual sums
        are not counted)."""
        if self.space_to_depth:
            h = image_size // 2  # padded (2, 1) around a 4x4/1 kernel
            total = h * h * self.conv1.weight.numel()
        else:
            total, h = _conv_macs(self.conv1, image_size)
        h = (h + 2 - 3) // 2 + 1  # the 3x3/2 max pool, padded 1
        for blk in self.blocks():
            m, h = blk.macs(h)
            total += m
        return total + self.fc.weight.numel()


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes=num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes=num_classes,
                  **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes=num_classes,
                  **kw)


def resnet152(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 8, 36, 3], BottleneckBlock, num_classes=num_classes,
                  **kw)
