"""The Vision Transformer family: the JAX package's ``models/vit.py`` in
PyTorch.

The model takes an NHWC image batch, as the JAX model does, casts it to
the compute ``dtype`` (bfloat16 by default; the parameters stay
float32) and patchifies it with a strided convolution (no padding),
channels-last on the GPU and NCHW on the CPU (ROADMAP C8).  The layers
follow the JAX model:

* tokens are read out by a mean over them (the default) or, with
  ``use_class_token``, from a learned class token prepended to them
  (the torchvision form: 197 tokens at 224² and patch 16);
* pre-norm encoder blocks: ``x + attn(ln_1(x))``, then ``x +
  mlp(ln_2(x))``; :class:`.common.LayerNorm` is flax's (eps 1e-6, f32
  statistics); the MLP's GELU is the tanh approximation unless
  ``gelu_exact``;
* the attention core is pluggable: ``attn_fn(q, k, v)`` on ``[B, T, H,
  D]``, default :func:`..ops.attention.dot_product_attention`
  (non-causal).  ``attn_fn=functools.partial(ops.flash_attention,
  causal=False)`` runs the hand-written training kernels B1-B3; q, k
  and v are strided views of the one ``[B, T, 3, H, D]`` projection,
  which the kernels read in place;
* the head runs in at least float32 (the promotion of ``dtype`` with
  float32), and so do the logits.

``dropout`` applies in training at the JAX model's sites (after the
position embedding; in each block after the attention, after the GELU
and after the MLP), each mask a counter-based hash of (step seed, site,
element) (:func:`.common.site_keys`), so remat and graph replays draw
the same masks; ``remat`` recomputes each block in the backward.
:func:`..parallel.tp.tensor_parallel` makes the attention and the MLP
Megatron modules (their ``tp`` context).

With a sequence-parallel ``attn_fn`` (:mod:`..parallel.context`: the
ring, flash or not, or Ulysses) the model is sequence-sharded, the
counterpart of the JAX model with ``make_ring_attention``, which shards
inside ``shard_map``: each rank patch-embeds the images (its rows of
the attention's ``batch_axis``, when it names one: the forward then
takes the global batch), adds the position table, keeps its ``T/S``
tokens of the ``seq_axis``, runs the blocks and the final norm on them,
and reads out over the sequence group: the mean is each shard's sum
scaled by ``1/T`` and summed over the group, the class token global
position 0's row, shared from the shard that holds it.  Both sums carry
the gradient (:func:`..parallel.collectives.psum_grad`), so a loss
divided by ``S`` on every rank gives each rank its part of the gradient
(``prepare_training(spmd="sp")`` does that).  Every rank returns the
logits of its rows.  A token count that does not divide over the axis
raises, as ``shard_map`` refuses it; training dropout is refused (its
masks hash the local element index).

Parameter names are torchvision's ``VisionTransformer``'s
(``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.{ln_1, self_attention.in_proj_*,
self_attention.out_proj, ln_2, mlp.0, mlp.3}``, ``encoder.ln``,
``heads.head``), so the JAX package's ``import_torch_vit`` reads the
port's ``state_dict`` and :func:`.from_jax.load_flax_vit` fills the port
from a flax tree.  Weights are flax's initialisers (``lecun_normal``
kernels, zero biases, positions ``normal(0.02)``, a zero class token)
drawn from ``seed`` on the CPU; the model then moves to ``device``
(default ``cuda``).  ``image_size`` fixes the token count, as
torchvision's does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from .common import (LayerNorm, _dropout, conv_nhwc, dense, fan_in_normal,
                     gelu, maybe_remat, site_keys)

__all__ = ["EncoderBlock", "MlpBlock", "MultiHeadAttention", "ViT",
           "vit_b16", "vit_h14", "vit_l16", "vit_tiny"]

#: dropout sites of a block: after the attention, after the GELU, after
#: the MLP; one more site (the first) follows the position embedding
BLOCK_SITES = 3


class MlpBlock(nn.Module):
    """Dense → GELU → dropout → Dense → dropout; the two layers are
    torchvision's ``mlp.0`` and ``mlp.3``."""

    def __init__(self, dim: int, mlp_dim: int, gelu_exact: bool = False):
        super().__init__()
        self.gelu_exact = gelu_exact
        # the tensor-parallel context (parallel.tp), or None
        self.tp = None
        self.add_module("0", nn.Linear(dim, mlp_dim))
        self.add_module("3", nn.Linear(mlp_dim, dim))

    def forward(self, x, dtype, rate: float = 0.0, keys=(None, None)):
        if self.tp is not None:
            x = self.tp.enter(x)
        y = gelu(dense(self._modules["0"], x, dtype), self.gelu_exact)
        y = _dropout(y, rate, keys[0])
        if self.tp is not None:
            y = self.tp.row(self._modules["3"], y, dtype)
        else:
            y = dense(self._modules["3"], y, dtype)
        return _dropout(y, rate, keys[1])


class MultiHeadAttention(nn.Module):
    """The QKV projection (torchvision's ``in_proj_weight`` [3D, D],
    rows q, k, v, each head-major), the pluggable core and the output
    projection ``out_proj``."""

    def __init__(self, dim: int, num_heads: int,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim ({dim}) must divide num_heads "
                             f"({num_heads})")
        self.num_heads, self.attn_fn = num_heads, attn_fn
        # the tensor-parallel context (parallel.tp), or None
        self.tp = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, _ = x.shape
        if self.tp is not None:
            x = self.tp.enter(x)
        qkv = F.linear(x.to(dtype), self.in_proj_weight.to(dtype),
                       self.in_proj_bias.to(dtype))
        q, k, v = qkv.view(b, t, 3, self.num_heads, -1).unbind(2)
        attn = self.attn_fn if self.attn_fn is not None else \
            dot_product_attention
        out = attn(q, k, v).reshape(b, t, -1)  # [B, T, H * Dh]
        if self.tp is not None:
            return self.tp.row(self.out_proj, out, dtype)
        return dense(self.out_proj, out, dtype)


class EncoderBlock(nn.Module):
    """Pre-norm block: ``x + dropout(attn(ln_1(x)))``, then ``x +
    mlp(ln_2(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 attn_fn: Optional[Callable] = None,
                 gelu_exact: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.self_attention = MultiHeadAttention(dim, num_heads, attn_fn)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_dim, gelu_exact)

    def forward(self, x, dtype, rate: float = 0.0, keys=None):
        """``keys``: this block's dropout keys, one a site, or ``None``."""
        k = (None,) * BLOCK_SITES if keys is None else keys
        y = self.self_attention(self.ln_1(x, dtype), dtype)
        x = x + _dropout(y, rate, k[0])
        return x + self.mlp(self.ln_2(x, dtype), dtype, rate, k[1:])


class _Encoder(nn.Module):
    """torchvision's ``encoder``: the position table, the blocks as
    ``layers.encoder_layer_{i}`` and the final norm ``ln``."""

    def __init__(self, ntok: int, depth: int, dim: int, num_heads: int,
                 mlp_dim: int, **block_kw):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, ntok, dim))
        self.layers = nn.ModuleDict({
            f"encoder_layer_{i}": EncoderBlock(dim, num_heads, mlp_dim,
                                               **block_kw)
            for i in range(depth)})
        self.ln = LayerNorm(dim)


class ViT(nn.Module):
    """A Vision Transformer over NHWC images; see the module docstring.
    ``forward(x, train=False, dropout_seed=None)``: dropout needs
    ``train=True`` and the step's seed (an int, or a 0-d int64 tensor
    on any device)."""

    def __init__(self, patch: int = 16, depth: int = 12, dim: int = 768,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 1000, *, image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0,
                 attn_fn: Optional[Callable] = None,
                 use_class_token: bool = False, gelu_exact: bool = False,
                 remat: bool = False, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if image_size % patch:
            raise ValueError(f"image size {image_size} is not a multiple of "
                             f"the patch {patch}")
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {dropout}")
        self.patch, self.depth, self.dim = patch, depth, dim
        self.num_heads, self.mlp_dim = num_heads, mlp_dim
        self.num_classes, self.image_size = num_classes, image_size
        self.dtype, self.dropout, self.remat = dtype, dropout, remat
        self.use_class_token, self.gelu_exact = use_class_token, gelu_exact
        self.attn_fn = attn_fn
        self.conv_proj = nn.Conv2d(3, dim, patch, patch)
        if use_class_token:
            self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.encoder = _Encoder(self.tokens(image_size), depth, dim,
                                num_heads, mlp_dim, attn_fn=attn_fn,
                                gelu_exact=gelu_exact)
        self.heads = nn.ModuleDict({"head": nn.Linear(dim, num_classes)})
        self._init_weights(seed)
        self.to(dev, memory_format=torch.channels_last
                if dev.type == "cuda" else torch.contiguous_format)

    def tokens(self, image_size: int) -> int:
        """Sequence length at ``image_size``: the patches, and the class
        token."""
        return (image_size // self.patch) ** 2 + int(self.use_class_token)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("weight") and p.ndim >= 2:
                p.copy_(fan_in_normal(p.shape, 1.0, gen))
            elif name.endswith("bias"):
                p.zero_()
        self.encoder.pos_embedding.normal_(0.0, 0.02, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.conv_proj.weight.device

    def blocks(self):
        """The encoder blocks in order."""
        return self.encoder.layers.values()

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_seed=None) -> torch.Tensor:
        dt = self.dtype
        if x.shape[1:3] != (self.image_size, self.image_size):
            raise ValueError(f"this ViT takes {self.image_size}² images "
                             f"(its position table), got {tuple(x.shape)}")
        sp = self.attn_fn if getattr(self.attn_fn, "seq_axis", None) else None
        if sp is not None and sp.batch_axis is not None:
            x = _rows(x, sp.mesh, sp.batch_axis)
        x = conv_nhwc(self.conv_proj, x, dt)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        if self.use_class_token:
            cls = self.class_token.to(dt).expand(b, 1, c)
            x = torch.cat([cls, x], dim=1)
        x = x + self.encoder.pos_embedding.to(dt)
        rate = self.dropout if train else 0.0
        keys = None
        if rate and dropout_seed is not None:
            keys = site_keys(dropout_seed, 1 + BLOCK_SITES * self.depth)
        if sp is not None:
            if keys is not None:
                raise ValueError("a sequence-sharded ViT trains with "
                                 "dropout 0: the masks hash the element "
                                 "index, which sharding changes")
            total = x.shape[1]
            x = _tokens(x, sp.mesh, sp.seq_axis)
        x = _dropout(x, rate, None if keys is None else keys[0])
        remat = self.remat and torch.is_grad_enabled()
        s = BLOCK_SITES
        for i, blk in enumerate(self.blocks()):
            x = maybe_remat(blk, remat)(
                x, dt, rate,
                None if keys is None else keys[1 + i * s:1 + (i + 1) * s])
        x = self.encoder.ln(x, dt)
        if sp is not None:
            x = _readout(x, sp.mesh, sp.seq_axis, total,
                         self.use_class_token)
        else:
            x = x[:, 0] if self.use_class_token else x.mean(dim=1)
        hd = torch.promote_types(dt, torch.float32)
        head = self.heads["head"]
        return F.linear(x.to(hd), head.weight.to(hd), head.bias.to(hd))

    def forward_macs(self, image_size: int) -> int:
        """Multiply-adds of one ``image_size`` x ``image_size`` image's
        forward through the patch convolution, the projections, the
        attention products (QKᵀ and PV) and the head, from the layer
        shapes (norms, GELU, softmax and sums are not counted)."""
        t = self.tokens(image_size)
        d, m = self.dim, self.mlp_dim
        patches = (image_size // self.patch) ** 2
        per_block = t * d * 3 * d + 2 * t * t * d + t * d * d + 2 * t * d * m
        return (patches * d * 3 * self.patch ** 2 + self.depth * per_block
                + d * self.num_classes)


def _rows(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` over ``axis``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over the {n} "
                         f"ranks of the {axis!r} axis")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _tokens(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """This rank's ``T/S`` tokens of ``x`` [B, T, D] over ``axis``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} tokens do not split over the {n} "
                         f"ranks of the {axis!r} axis")
    t = x.shape[1] // n
    return x[:, i * t:(i + 1) * t]


def _readout(x: torch.Tensor, mesh, axis, total: int,
             class_token: bool) -> torch.Tensor:
    """The sequence-sharded readout of this shard ``x`` [B, T/S, D] of
    ``total`` tokens: global position 0's row with a class token, else
    the mean over every token (this shard's mean scaled by its share,
    summed over the group: exactly the mean on one rank)."""
    from ..parallel.collectives import psum_grad

    if class_token:
        first = mesh.axis_index(axis) == 0
        row = x[:, 0] if first else torch.zeros_like(x[:, 0])
        return psum_grad(row, mesh, axis)
    share = x.mean(dim=1)
    if x.shape[1] != total:
        share = share * (x.shape[1] / total)
    return psum_grad(share, mesh, axis)


def _vit(kw: dict, **defaults) -> ViT:
    for key, val in defaults.items():
        kw.setdefault(key, val)
    return ViT(**kw)


def vit_tiny(num_classes: int = 10, **kw) -> ViT:
    """Tiny config for tests and dry runs (not a published variant)."""
    return _vit(kw, patch=4, depth=2, dim=64, num_heads=4, mlp_dim=128,
                num_classes=num_classes)


def vit_b16(num_classes: int = 1000, **kw) -> ViT:
    return _vit(kw, patch=16, depth=12, dim=768, num_heads=12, mlp_dim=3072,
                num_classes=num_classes)


def vit_l16(num_classes: int = 1000, **kw) -> ViT:
    return _vit(kw, patch=16, depth=24, dim=1024, num_heads=16, mlp_dim=4096,
                num_classes=num_classes)


def vit_h14(num_classes: int = 1000, **kw) -> ViT:
    return _vit(kw, patch=14, depth=32, dim=1280, num_heads=16, mlp_dim=5120,
                num_classes=num_classes)
