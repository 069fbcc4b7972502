"""Decoder-only transformer LM and its KV-cache decode path.

Port of ``fluxdistributed_tpu/models/transformer_lm.py``: pre-norm
blocks (layernorm or rmsnorm), GELU or SwiGLU MLPs, RoPE or learned
positions, grouped-query attention, sliding window with attention
sinks, tied embeddings, and f32 logits.  Parameters are stored in f32
and cast to the compute ``dtype`` at use, as flax does; the serving
engine casts them once up front.

Decoding keeps a cache and updates it IN PLACE: the JAX package returns
a new cache per call, the port writes rows where they live.  Two
layouts share one code path:

* :class:`DecodeCache` — one K/V buffer per layer with one row span
  per batch row (``generate``, the dense serving engine);
* :class:`PagedCache` — a shared pool of fixed-size K/V blocks per
  layer and one int32 page table per batch row, kept as device data
  (the paged serving engine).

The full-sequence forward (``cache=None``) is the training path: its
attention core is pluggable (``attn_fn``, e.g. ``ops.attention_core
("flash")``, the hand-written training kernels), ``dropout`` applies at
the JAX model's sites when ``train=True``, each mask a counter-based
hash of (step seed, layer, site, element), and ``remat`` recomputes
each block in the backward (``torch.utils.checkpoint``).
:func:`next_token_loss` and :func:`lm_loss_fn` give the training loss.
Made tensor-parallel by :func:`..parallel.tp.tensor_parallel`, the
attention, the MLP, the embedding and the logits run the Megatron
collectives of the ``tp`` context they are given (training only).
With a sequence-parallel ``attn_fn`` (:mod:`..parallel.context`) each
rank runs the whole model on its shard of positions (``seq_shard``:
RoPE, the learned table and the dropout masks read global positions)
and :func:`lm_loss_fn` takes that shard's part of the loss.  With
``moe_every`` every that-many-th block is a :class:`MoEDecoderBlock`
whose MLP is a routed expert layer (``moe_fn``, built by
:func:`..parallel.ep.moe_apply`), and the loss adds the router's
load-balance term.

Every batch row has its own cursor, so one code path serves
``generate`` (all rows at the same depth), batch-1 prefill and the
engine's all-slot decode step (every slot at its own depth):

* a single-token step (``t == 1``) writes its K/V first and then
  attends through the decode kernel
  (:func:`..ops.flash_decode.flash_decode`, or ``flash_decode_paged``
  walking the page table; the Hopper kernel on the GPU, its plain
  version on the CPU): for a windowed ring the key the write evicts is
  a full ring behind the cursor, out of band by construction;
* a multi-token prefill (``t > 1``) attends with
  :func:`..ops.attention.dot_product_attention`: the plain cache writes
  and then attends the masked cache, the windowed ring attends
  [old ring ∥ this chunk] BEFORE its rolling write, so a chunk's early
  queries still see the band keys its newest tokens overwrite.

A write whose position falls past the cache end (a parked slot's cursor
drifting on) is dropped, never wrapped or indexed out of range.  In the
paged layout a dropped write (past the row span, on an unbound page, or
from a row whose ``slot_live`` gate is shut) lands in one scratch block
at the end of each pool that no page table names, so no step needs a
host sync to drop it and no dropped row can collide with a live one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..mesh import EXPERT_AXIS, PIPE_AXIS
from ..ops.attention import dot_product_attention, validate_window
from ..ops.flash_decode import flash_decode, flash_decode_paged
from .common import _dropout, dense, maybe_remat, site_keys

__all__ = [
    "KV_QUANTS",
    "VALID_UNGATED",
    "CausalSelfAttention",
    "DecodeCache",
    "DecoderBlock",
    "MoEDecoderBlock",
    "PagedCache",
    "TransformerLM",
    "dequantize_kv",
    "generate",
    "lm_loss_fn",
    "lm_medium",
    "lm_moe_specs",
    "lm_small",
    "lm_tiny",
    "make_decode_cache",
    "make_paged_cache",
    "moe_expert_fn",
    "next_token_loss",
    "quantize_kv",
    "rope",
]

#: KV-cache storage scenarios: the model dtype, int8, or fp8 e4m3
KV_QUANTS = ("none", "int8", "fp8")

#: ``valid_len`` meaning "every position of this call is real" — decode
#: steps and unpadded prefills.  The engine passes the REAL token count
#: of a padded prefill instead, so pad positions never write into (or
#: evict from) a windowed ring.
VALID_UNGATED = 2 ** 30


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on ``x`` [B, T, H, D] (D even).

    ``positions``: [T] or [B, T] global token indices.  Pairs feature
    ``2i`` with ``2i+1`` (interleaved, not the half-split layout) and
    rotates by ``pos / base^(2i/D)``, in f32, cast back to x's dtype.
    """
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim, got {d}")
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    ang = positions.to(torch.float32)[..., None] * inv_freq  # [..., T, D/2]
    if ang.ndim == 2:
        ang = ang[None]
    ang = ang[:, :, None, :]  # [B|1, T, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _kv_store_dtype(kv_quant: str) -> Optional[torch.dtype]:
    if kv_quant not in KV_QUANTS:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r} ({'|'.join(KV_QUANTS)})")
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_quant)


def quantize_kv(x: torch.Tensor, kv_quant: str):
    """Per-row-per-head absmax quantisation over the head dim.
    ``x`` [..., H, D] → ``(stored [..., H, D], scale [..., H] f32)``.
    int8 rounds half to even and clips to ±127; fp8 stores ``x/scale``
    in e4m3 with ``scale = amax / 448``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if kv_quant == "int8":
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    elif kv_quant == "fp8":
        scale = torch.clamp(amax, min=1e-12) / 448.0
        q = xf / scale[..., None]
    else:
        raise ValueError(f"quantize_kv needs int8 or fp8, got {kv_quant!r}")
    return q.to(_kv_store_dtype(kv_quant)), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`quantize_kv` into the model's compute dtype."""
    return (q.float() * scale.float()[..., None]).to(dtype)


#: dropout sites of a block: the attention output, the MLP's hidden
#: activation, the MLP output
DROPOUT_SITES = 3


def dropout_keys(seed, depth: int):
    """The dropout keys of one forward: one per (layer, site), in
    ``layer * DROPOUT_SITES + site`` order (:func:`.common.site_keys`
    of the step seed: an int gives Python ints, a 0-d int64 tensor an
    int32 tensor on its device; the same 32 bits)."""
    return site_keys(seed, depth * DROPOUT_SITES)


class _Norm(nn.Module):
    """``layernorm`` (GPT-2 style) or ``rmsnorm`` (Llama style), in f32
    and cast to the compute dtype.  ``eps`` defaults to flax's 1e-6."""

    def __init__(self, dim: int, kind: str, eps: float):
        super().__init__()
        if kind not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {kind!r} (layernorm|rmsnorm)")
        self.kind, self.eps = kind, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = (nn.Parameter(torch.zeros(dim)) if kind == "layernorm"
                     else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            y = F.layer_norm(xf, xf.shape[-1:], self.weight.float(),
                             self.bias.float(), self.eps)
        else:
            y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
            y = y * self.weight.float()
        return y.to(dtype)


@dataclass
class DecodeCache:
    """KV cache for decoding, updated in place.

    ``k``/``v``: per layer [B, R, Hkv, D] in the model dtype, int8 or
    fp8; ``k_scale``/``v_scale``: per layer [B, R, Hkv] f32 (quantised
    caches only); ``index``: [B] int32 cursors (the next write
    position); ``slot_pos``: [B, R] int32 global position held by each
    windowed-ring slot (-1 = unwritten, never attendable), None for a
    plain cache.  R is the target length, or ``sinks + window`` for a
    windowed ring.
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]]
    v_scale: Optional[List[torch.Tensor]]
    index: torch.Tensor
    slot_pos: Optional[torch.Tensor]
    kv_quant: str = "none"

    def buffers(self):
        """Every K/V and scale buffer (what ``kv_cache_bytes`` counts)."""
        out = list(self.k) + list(self.v)
        if self.k_scale is not None:
            out += list(self.k_scale) + list(self.v_scale)
        return out


@dataclass
class PagedCache:
    """Paged KV cache for the serving engine, updated in place.

    ``k``/``v``: per layer [kv_blocks + 1, bs, Hkv, D] pools in the model
    dtype, int8 or fp8; ``k_scale``/``v_scale``: per layer
    [kv_blocks + 1, bs, Hkv] f32 (quantised only).  Block ``kv_blocks``
    is scratch: dropped writes land there and no page table names it.
    ``page_table``: [B, P] int32 block ids, ONE table for every layer
    (block ids are layer-agnostic; -1 = unbound: reads masked, writes
    dropped), updated by whole-row copies and never reallocated.
    ``index``: [B] int32 cursors; ``slot_live``: [B] int32 write gate (0
    = parked or mid-prefill: the all-slot decode step drifts every
    row's cursor, and a mid-prefill row's drift writes would otherwise
    land through its bound pages); ``slot_pos``: [B, P*bs] int32 global
    position held by each logical ring row (-1 = unwritten), None for a
    plain cache.
    """

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]]
    v_scale: Optional[List[torch.Tensor]]
    index: torch.Tensor
    page_table: torch.Tensor
    slot_live: torch.Tensor
    slot_pos: Optional[torch.Tensor]
    block_size: int
    kv_quant: str = "none"

    @property
    def kv_blocks(self) -> int:
        """Blocks a page table may name (the scratch block excluded)."""
        return self.k[0].shape[0] - 1

    def buffers(self):
        """Every K/V and scale pool without its scratch block (what
        ``kv_cache_bytes`` counts)."""
        out = list(self.k) + list(self.v)
        if self.k_scale is not None:
            out += list(self.k_scale) + list(self.v_scale)
        return [t[:-1] for t in out]


class _Step:
    """Per-forward decode bookkeeping, computed once for all layers:
    positions, write targets and (for prefill) the attention mask."""

    def __init__(self, cache: DecodeCache, t: int, window, sinks,
                 valid_len):
        idx = cache.index.to(torch.int64)  # [B]
        b, r = cache.k[0].shape[:2]
        dev = idx.device
        self.t = t
        self.idx32 = cache.index  # every layer runs before the cursor moves
        self.rows = torch.arange(b, device=dev)
        self.wpos = idx[:, None] + torch.arange(t, device=dev)[None, :]
        if window is None:
            slots = self.wpos
            keep = self.wpos < r
        else:
            ring = max(r - sinks, 1)
            veff = min(int(valid_len), t)
            limit = idx[:, None] + veff  # one past the last REAL position
            keep = (self.wpos > limit - 1 - ring) & (self.wpos < limit)
            if sinks:
                keep |= (self.wpos < sinks) & (self.wpos < limit)
                slots = torch.where(self.wpos < sinks, self.wpos,
                                    sinks + (self.wpos - sinks) % ring)
            else:
                slots = self.wpos % ring
        self.allow = None
        if t == 1:
            # one position per row: a masked blend-write needs no host
            # sync (the dropped rows rewrite their old value in range)
            self.pos1 = torch.clamp(slots[:, 0], 0, r - 1)
            self.keep1 = keep[:, 0]
        else:
            self.wb = self.rows[:, None].expand(b, t)[keep]
            self.ws = slots[keep]
            self.wsel = keep
            qg = self.wpos[:, :, None]  # [B, T, 1]
            if window is None:
                keys = torch.arange(r, device=dev)[None, None, :]
                self.allow = keys <= qg  # [B, T, R]
            else:
                # read [old ring ∥ this chunk] before the rolling write
                sp = torch.cat([cache.slot_pos.to(torch.int64), self.wpos],
                               dim=1)[:, None, :]
                allow = (sp >= 0) & (sp <= qg)
                band = sp > qg - window
                if sinks:
                    band |= sp < sinks
                self.allow = allow & band  # [B, T, R + T]

    def put(self, buf: torch.Tensor, val: torch.Tensor) -> None:
        """Write this call's rows of ``val`` [B, T, ...] into ``buf``
        [B, R, ...], dropping out-of-range / gated positions."""
        if buf.dtype == torch.float8_e4m3fn:
            # plain indexing ops are not defined for every fp8 op; move
            # the bytes
            buf, val = buf.view(torch.uint8), val.view(torch.uint8)
        if self.t == 1:
            cur = buf[self.rows, self.pos1]
            keep = self.keep1.view(-1, *([1] * (cur.ndim - 1)))
            buf[self.rows, self.pos1] = torch.where(keep, val[:, 0], cur)
        else:
            buf[self.wb, self.ws] = val[self.wsel]

    def put_positions(self, cache: DecodeCache) -> None:
        """Record the written ring slots' global positions."""
        self.put(cache.slot_pos, self.wpos.to(torch.int32))

    def view(self, buf: torch.Tensor) -> torch.Tensor:
        """The cache rows as prefill attends them: [B, R, ...]."""
        return buf


class _PagedStep:
    """:class:`_Step` for a :class:`PagedCache`: every write goes through
    the page table to ``(block, offset)``, a dropped one to the scratch
    block; prefill attends the gathered view of each row's pages."""

    def __init__(self, cache: PagedCache, t: int, window, sinks,
                 valid_len):
        idx = cache.index.to(torch.int64)  # [B]
        pt = cache.page_table.to(torch.int64)  # [B, P]
        b, pages = pt.shape
        bs = cache.block_size
        r_pad = pages * bs
        dev = idx.device
        self.t, self.bs, self.r_pad = t, bs, r_pad
        self.idx32 = cache.index
        self.pt = cache.page_table
        self.rows = torch.arange(b, device=dev)
        self.wpos = idx[:, None] + torch.arange(t, device=dev)[None, :]
        live = cache.slot_live[:, None] > 0  # [B, 1] write gate
        if window is None:
            # logical row == global position
            keep = (self.wpos < r_pad) & live
            lrow = self.wpos
            page = torch.clamp(self.wpos // bs, max=pages - 1)
        else:
            # the logical ring spans ALL paged rows (r_pad - sinks);
            # rounding up to whole blocks only retains more, and
            # retained out-of-band keys are masked anyway
            ring = max(r_pad - sinks, 1)
            veff = min(int(valid_len), t)
            limit = idx[:, None] + veff  # one past the last REAL position
            keep = (self.wpos > limit - 1 - ring) & (self.wpos < limit)
            if sinks:
                keep |= (self.wpos < sinks) & (self.wpos < limit)
                lrow = torch.where(self.wpos < sinks, self.wpos,
                                   sinks + (self.wpos - sinks) % ring)
            else:
                lrow = self.wpos % ring
            keep &= live  # mid-prefill / parked rows never write
            page = lrow // bs
        phys = torch.gather(pt, 1, page)
        phys = torch.where(keep & (phys >= 0), phys,
                           torch.full_like(phys, cache.kv_blocks))
        self.phys, self.off = phys.reshape(-1), (lrow % bs).reshape(-1)
        self.lrow, self.keep = lrow, keep
        self.allow = None
        if t > 1:
            qg = self.wpos[:, :, None]  # [B, T, 1]
            if window is None:
                keys = torch.arange(r_pad, device=dev)[None, None, :]
                self.allow = keys <= qg  # [B, T, r_pad]
            else:
                # read [gathered pages ∥ this chunk] before the write
                sp = torch.cat([cache.slot_pos.to(torch.int64), self.wpos],
                               dim=1)[:, None, :]
                allow = (sp >= 0) & (sp <= qg)
                band = sp > qg - window
                if sinks:
                    band |= sp < sinks
                self.allow = allow & band  # [B, T, r_pad + T]

    def put(self, pool: torch.Tensor, val: torch.Tensor) -> None:
        """Write this call's rows of ``val`` [B, T, ...] into ``pool``
        [NB + 1, bs, ...]; dropped rows go to the scratch block.  Live
        rows never collide: shared prefix blocks are never written, and
        a row's kept positions map to distinct (block, offset) pairs."""
        if pool.dtype == torch.float8_e4m3fn:
            pool, val = pool.view(torch.uint8), val.view(torch.uint8)
        pool[self.phys, self.off] = val.reshape(-1, *val.shape[2:])

    def put_positions(self, cache: PagedCache) -> None:
        """Record the kept ring rows' global positions in ``slot_pos``."""
        sp = cache.slot_pos
        wpos = self.wpos.to(torch.int32)
        if self.t == 1:
            # one position per row: a blend-write needs no host sync
            cur = sp[self.rows, self.lrow[:, 0]]
            sp[self.rows, self.lrow[:, 0]] = torch.where(
                self.keep[:, 0], wpos[:, 0], cur)
        else:
            rows = self.rows[:, None].expand_as(self.keep)
            sp[rows[self.keep], self.lrow[self.keep]] = wpos[self.keep]

    def view(self, pool: torch.Tensor) -> torch.Tensor:
        """Each row's pages gathered into [B, r_pad, ...] (an unbound
        page reads block 0; its rows are masked)."""
        blk = torch.clamp(self.pt.to(torch.int64), min=0)
        if pool.dtype == torch.float8_e4m3fn:
            g = pool.view(torch.uint8)[blk].view(pool.dtype)
        else:
            g = pool[blk]
        return g.reshape(blk.shape[0], self.r_pad, *pool.shape[2:])


class CausalSelfAttention(nn.Module):
    """QKV projection + RoPE + causal core + output projection.

    The full-sequence core is ``attn_fn(q, k, v)`` when given (it owns
    its windowing, as ``ops.attention_core(..., window=...)`` builds
    it), else the windowed dense core.  Weights mirror the flax module: ``qkv`` (features ordered
    [3, H, Dh]) or, under GQA, ``q`` ([H, Dh]) and ``kv`` ([2, Hkv,
    Dh]); ``out`` ([H·Dh] → dim).  All projections carry biases, as
    flax's ``DenseGeneral`` does.
    """

    def __init__(self, dim: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, sinks: int = 0,
                 use_rope: bool = True, attn_fn: Optional[Callable] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim ({dim}) must divide num_heads "
                             f"({num_heads})")
        validate_window(True, window, sinks)
        hkv = num_kv_heads or num_heads
        if num_heads % hkv:
            raise ValueError(f"num_heads ({num_heads}) must be a multiple "
                             f"of num_kv_heads ({hkv})")
        self.num_heads, self.num_kv_heads = num_heads, hkv
        self.head_dim = dim // num_heads
        self.window, self.sinks, self.use_rope = window, sinks, use_rope
        self.attn_fn = attn_fn
        # the tensor-parallel context (parallel.tp), or None
        self.tp = None
        hd = self.head_dim
        if hkv != num_heads:
            self.q = nn.Linear(dim, num_heads * hd)
            self.kv = nn.Linear(dim, 2 * hkv * hd)
        else:
            self.qkv = nn.Linear(dim, 3 * num_heads * hd)
        self.out = nn.Linear(num_heads * hd, dim)

    def _project(self, x, dtype):
        b, t, _ = x.shape
        h, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if hkv != h:
            q = dense(self.q, x, dtype).view(b, t, h, hd)
            kv = dense(self.kv, x, dtype).view(b, t, 2, hkv, hd)
            return q, kv[:, :, 0], kv[:, :, 1]
        qkv = dense(self.qkv, x, dtype).view(b, t, 3, h, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                cache: Optional[DecodeCache] = None, layer: int = 0,
                step: Optional[_Step] = None, pos0: int = 0) -> torch.Tensor:
        """``pos0``: the global position of ``x``'s first row (a
        sequence shard's offset) in the full-sequence forward."""
        b, t, _ = x.shape
        if self.tp is not None:
            x = self.tp.enter(x)
        q, k, v = self._project(x, dtype)
        if cache is None:
            if self.use_rope:
                pos = torch.arange(t, device=x.device) + pos0
                q, k = rope(q, pos), rope(k, pos)
            attn = (self.attn_fn if self.attn_fn is not None else
                    partial(dot_product_attention, causal=True,
                            window=self.window, sinks=self.sinks))
            out = attn(q, k, v)  # [B, T, H, Dh]
        else:
            out = self._decode(q, k, v, dtype, cache, layer, step)
        if self.tp is not None:
            return self.tp.row(self.out, out.reshape(b, t, -1), dtype)
        return dense(self.out, out.reshape(b, t, -1), dtype)

    def _decode(self, q, k, v, dtype, cache, layer: int, st):
        if self.use_rope:
            q, k = rope(q, st.wpos), rope(k, st.wpos)
        quant = cache.kv_quant != "none"
        if quant:
            k_store, k_sc = quantize_kv(k, cache.kv_quant)
            v_store, v_sc = quantize_kv(v, cache.kv_quant)
        else:
            k_store, v_store = k, v
        ck, cv = cache.k[layer], cache.v[layer]
        ks = cache.k_scale[layer] if quant else None
        vs = cache.v_scale[layer] if quant else None

        def write():
            st.put(ck, k_store)
            st.put(cv, v_store)
            if quant:
                st.put(ks, k_sc)
                st.put(vs, v_sc)

        def rows(buf, scale):
            """The cache as prefill attends it, dequantised."""
            if quant:
                return dequantize_kv(st.view(buf), st.view(scale), dtype)
            return st.view(buf)

        if st.t == 1:
            # write-then-attend through the decode kernel (slot_pos was
            # updated for this step before the first layer)
            write()
            kw = dict(slot_pos=cache.slot_pos, window=self.window,
                      sinks=self.sinks, k_scale=ks, v_scale=vs)
            if isinstance(cache, PagedCache):
                return flash_decode_paged(q.contiguous(), ck, cv,
                                          cache.page_table, st.idx32, **kw)
            return flash_decode(q.contiguous(), ck, cv, st.idx32, **kw)
        if self.window is None:
            write()
            attn_k, attn_v = rows(ck, ks), rows(cv, vs)
        else:
            # read [old ring ∥ this chunk] BEFORE the rolling write;
            # quantised chunks attend their STORED (dequantised) values
            k_at = dequantize_kv(k_store, k_sc, dtype) if quant else k
            v_at = dequantize_kv(v_store, v_sc, dtype) if quant else v
            attn_k = torch.cat([rows(ck, ks), k_at], dim=1)
            attn_v = torch.cat([rows(cv, vs), v_at], dim=1)
            write()
        return dot_product_attention(q, attn_k, attn_v,
                                     mask=st.allow[:, None])


class DecoderBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))`` then ``x + mlp(norm(x))``.
    The MLP is GELU (tanh approximation, ``fc1``/``fc2`` with biases) or
    SwiGLU (biasless ``gate``/``up``/``down``).  In training, dropout
    applies to the attention output, the MLP's hidden activation and the
    MLP output (the JAX block's sites)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads=None, window=None, sinks=0, use_rope=True,
                 norm="layernorm", norm_eps=1e-6, mlp="gelu", dropout=0.0,
                 attn_fn=None):
        super().__init__()
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp {mlp!r} (gelu|swiglu)")
        self.mlp, self.dropout = mlp, dropout
        # the MLP's tensor-parallel context (parallel.tp), or None
        self.tp = None
        self.ln1 = _Norm(dim, norm, norm_eps)
        self.attn = CausalSelfAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, window=window,
            sinks=sinks, use_rope=use_rope, attn_fn=attn_fn)
        self.ln2 = _Norm(dim, norm, norm_eps)
        if mlp == "swiglu":
            self.gate = nn.Linear(dim, mlp_dim, bias=False)
            self.up = nn.Linear(dim, mlp_dim, bias=False)
            self.down = nn.Linear(mlp_dim, dim, bias=False)
        else:
            self.fc1 = nn.Linear(dim, mlp_dim)
            self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x, dtype, cache=None, layer=0, step=None, train=False,
                keys=None, seq=None):
        """``keys``: this block's dropout keys, one a site (a slice of
        :func:`dropout_keys`), or ``None``; ``seq``: ``(offset, total)``
        of a sequence shard, or ``None``."""
        rate = self.dropout if train else 0.0
        key = (lambda site: None) if keys is None else keys.__getitem__
        drop = partial(_dropout, seq=seq)
        y = self.attn(self.ln1(x, dtype), dtype, cache, layer, step,
                      0 if seq is None else seq[0])
        x = x + drop(y, rate, key(0))
        y = self.ln2(x, dtype)
        if self.tp is not None:
            y = self.tp.enter(y)
            down = lambda layer, h: self.tp.row(layer, h, dtype)  # noqa: E731
        else:
            down = lambda layer, h: dense(layer, h, dtype)  # noqa: E731
        if self.mlp == "swiglu":
            y = F.silu(dense(self.gate, y, dtype)) * dense(self.up, y, dtype)
            y = down(self.down, drop(y, rate, key(1)))
        else:
            y = F.gelu(dense(self.fc1, y, dtype), approximate="tanh")
            y = down(self.fc2, drop(y, rate, key(1)))
        return x + drop(y, rate, key(2))


class MoEDecoderBlock(nn.Module):
    """:class:`DecoderBlock` with the MLP replaced by a routed expert
    layer (Switch top-1 or GShard top-k, :mod:`..parallel.ep`).

    The parameters keep the flax layouts: ``router`` [dim, E] (f32 in
    use), the stacked experts ``w1`` [E, dim, mlp], ``b1`` [E, mlp],
    ``w2`` [E, mlp, dim], ``b2`` [E, dim], so ``x @ w1`` over the experts
    is one batched product (:func:`moe_expert_fn`).  ``moe_fn(experts,
    router, tokens) -> (out, aux)`` routes this rank's tokens; under
    expert parallelism the expert leaves are this rank's block of
    experts.  The forward returns ``(x, aux)``, the router's
    load-balance term beside the block's output.  Dropout applies to
    the attention output and the expert layer's output."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 num_experts: int, moe_fn: Callable, *, num_kv_heads=None,
                 window=None, sinks=0, use_rope=True, norm="layernorm",
                 norm_eps=1e-6, dropout=0.0, attn_fn=None):
        super().__init__()
        self.moe_fn, self.dropout = moe_fn, dropout
        self.ln1 = _Norm(dim, norm, norm_eps)
        self.attn = CausalSelfAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, window=window,
            sinks=sinks, use_rope=use_rope, attn_fn=attn_fn)
        self.ln2 = _Norm(dim, norm, norm_eps)
        e, m = num_experts, mlp_dim
        self.router = nn.Parameter(torch.zeros(dim, e))
        self.w1 = nn.Parameter(torch.zeros(e, dim, m))
        self.b1 = nn.Parameter(torch.zeros(e, m))
        self.w2 = nn.Parameter(torch.zeros(e, m, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))

    def forward(self, x, dtype, cache=None, layer=0, step=None, train=False,
                keys=None, seq=None):
        rate = self.dropout if train else 0.0
        key = (lambda site: None) if keys is None else keys.__getitem__
        y = self.attn(self.ln1(x, dtype), dtype, cache, layer, step,
                      0 if seq is None else seq[0])
        x = x + _dropout(y, rate, key(0), seq=seq)
        y = self.ln2(x, dtype)
        b, t, d = y.shape
        experts = {n: getattr(self, n).to(dtype)
                   for n in ("w1", "b1", "w2", "b2")}
        out, aux = self.moe_fn(experts, self.router.float(),
                               y.reshape(b * t, d))
        return x + _dropout(out.reshape(b, t, d), rate, key(2), seq=seq), aux


def moe_expert_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The expert MLP of :class:`MoEDecoderBlock`'s params, over leading
    expert dims: ``gelu(x @ w1 + b1) @ w2 + b2`` with ``p`` leaves [E,
    ...] and ``x`` [E, n, dim] (or one expert's, unbatched).  Pass it to
    :func:`..parallel.ep.moe_apply` when building the block's
    ``moe_fn``.  Mixed dtypes compute in their promotion (the f32
    dispatched tokens promote bf16 weights, as in JAX)."""
    dt = torch.promote_types(x.dtype, p["w1"].dtype)
    h = x.to(dt) @ p["w1"].to(dt) + p["b1"].to(dt).unsqueeze(-2)
    h = F.gelu(h, approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt).unsqueeze(-2)


def lm_moe_specs(params: dict, axis: str = EXPERT_AXIS) -> dict:
    """Specs of an MoE LM's params (the JAX ``lm_moe_specs``): the
    stacked expert leaves (``w1``/``b1``/``w2``/``b2`` of the MoE
    blocks, leading dim E) split over ``axis``, everything else (the
    routers, the dense leaves) replicated."""
    from ..sharding import P

    def spec(name, p):
        if name.split(".")[-1] in ("w1", "b1", "w2", "b2"):
            return P(axis, *([None] * (p.ndim - 1)))
        return P()

    return {k: spec(k, p) for k, p in params.items()}


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens [B, T] int → logits [B, T, vocab] f32.

    Position t's logits predict token t+1.  With ``tie_embeddings`` the
    output head reuses the input table (logits = h @ E^T).  Weights are
    initialised from ``seed`` on the CPU (so every device gets the same
    numbers) and moved to ``device`` (default ``cuda``; see
    :func:`..device.resolve_device`).  ``use_rope=False`` needs
    ``max_len``, the learned positional table's length.  ``attn_fn``,
    ``dropout`` and ``remat`` shape the full-sequence (training)
    forward only; the decode paths ignore them.  ``moe_every > 0`` makes
    blocks ``moe_every - 1``, ``2 moe_every - 1``, ... MoE blocks of
    ``num_experts`` experts routed by ``moe_fn``
    (``parallel.ep.moe_apply(models.moe_expert_fn, mesh, ...)``), whose
    load-balance terms :func:`lm_loss_fn` adds with ``moe_aux_weight``.
    """

    def __init__(self, vocab: int, depth: int = 4, dim: int = 256,
                 num_heads: int = 4, mlp_dim: int = 1024, *,
                 dtype: torch.dtype = torch.bfloat16, use_rope: bool = True,
                 tie_embeddings: bool = True,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, sinks: int = 0,
                 norm: str = "layernorm", norm_eps: float = 1e-6,
                 mlp: str = "gelu", max_len: Optional[int] = None,
                 attn_fn: Optional[Callable] = None, dropout: float = 0.0,
                 remat: bool = False, moe_every: int = 0,
                 num_experts: int = 0, moe_fn: Optional[Callable] = None,
                 moe_aux_weight: float = 0.01, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        #: the architecture (every argument but ``device`` and ``seed``):
        #: ``TransformerLM(**config)`` rebuilds it (obs.profile prices
        #: its blocks by depth)
        self.config = dict(
            vocab=vocab, depth=depth, dim=dim, num_heads=num_heads,
            mlp_dim=mlp_dim, dtype=dtype, use_rope=use_rope,
            tie_embeddings=tie_embeddings, num_kv_heads=num_kv_heads,
            window=window, sinks=sinks, norm=norm, norm_eps=norm_eps,
            mlp=mlp, max_len=max_len, attn_fn=attn_fn, dropout=dropout,
            remat=remat, moe_every=moe_every, num_experts=num_experts,
            moe_fn=moe_fn, moe_aux_weight=moe_aux_weight)
        dev = resolve_device(device)
        if not use_rope and max_len is None:
            raise ValueError("use_rope=False needs max_len (the learned "
                             "positional table's length)")
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {dropout}")
        if moe_every:
            # a silently dense "MoE" model or a late per-block error would
            # hide the misconfiguration
            if moe_fn is None or num_experts < 1:
                raise ValueError(
                    "moe_every > 0 needs moe_fn (parallel.ep.moe_apply("
                    "models.moe_expert_fn, mesh, ...)) and num_experts")
            if moe_every > depth:
                raise ValueError(f"moe_every ({moe_every}) > depth ({depth}):"
                                 " no block would be MoE")
        self.vocab, self.depth, self.dim = vocab, depth, dim
        self.num_heads, self.mlp_dim = num_heads, mlp_dim
        self.num_kv_heads = num_kv_heads
        self.window, self.sinks = window, sinks
        self.use_rope, self.tie_embeddings = use_rope, tie_embeddings
        self.max_len, self.dtype = max_len, dtype
        self.attn_fn, self.dropout, self.remat = attn_fn, dropout, remat
        self.moe_every, self.num_experts = moe_every, num_experts
        self.moe_fn, self.moe_aux_weight = moe_fn, moe_aux_weight
        self.embed = nn.Embedding(vocab, dim)
        self.pos_embedding = (None if use_rope else
                              nn.Parameter(torch.zeros(max_len, dim)))
        attn_kw = dict(num_kv_heads=num_kv_heads, window=window, sinks=sinks,
                       use_rope=use_rope, norm=norm, norm_eps=norm_eps,
                       dropout=dropout, attn_fn=attn_fn)
        self.blocks = nn.ModuleList(
            MoEDecoderBlock(dim, num_heads, mlp_dim, num_experts, moe_fn,
                            **attn_kw)
            if moe_every and (i + 1) % moe_every == 0 else
            DecoderBlock(dim, num_heads, mlp_dim, mlp=mlp, **attn_kw)
            for i in range(depth))
        self.final_ln = _Norm(dim, norm, norm_eps)
        self.head = None if tie_embeddings else nn.Linear(dim, vocab)
        # the vocab-parallel embedding's and the column-parallel head's
        # tensor-parallel contexts (parallel.tp), or None
        self.tp_embed = self.tp_head = None
        self._init_weights(seed)
        self.to(dev)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        if self.pos_embedding is not None:
            self.pos_embedding.normal_(0.0, 0.02, generator=gen)
        for blk in self.blocks:
            if isinstance(blk, MoEDecoderBlock):
                # flax's lecun_normal fan-in: a leading expert dim counts
                # as receptive field (w1: dim x E, w2: mlp x E)
                e = blk.router.shape[1]
                blk.router.normal_(0.0, blk.router.shape[0] ** -0.5,
                                   generator=gen)
                for w in (blk.w1, blk.w2):
                    w.normal_(0.0, (w.shape[1] * e) ** -0.5, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, tokens: torch.Tensor, cache=None, *,
                valid_len: int = VALID_UNGATED, train: bool = False,
                dropout_seed: Optional[int] = None,
                seq_shard: Optional[tuple] = None,
                moe_aux: Optional[list] = None) -> torch.Tensor:
        """Full causal forward (``cache=None``), or one decode call that
        advances every row of ``cache`` (a :class:`DecodeCache` or a
        :class:`PagedCache`) by ``T`` positions.
        ``valid_len`` is the number of REAL positions in this call (a
        padded prefill's pads never write into a windowed ring).
        ``train=True`` turns dropout on (it needs ``dropout_seed``, this
        step's seed: an int, or a 0-d int64 tensor on any device); with
        ``remat`` each block of a full forward that records gradients is
        recomputed in the backward.  ``seq_shard=(offset, total)``: the
        tokens are positions ``[offset, offset + T)`` of sequences of
        ``total`` (this rank's shard under a sequence-parallel
        ``attn_fn``).  ``moe_aux``: a list that receives each MoE
        block's load-balance term, in block order."""
        dt = self.dtype
        tokens = tokens.to(self.device)
        b, t = tokens.shape
        if cache is not None and getattr(self, "tp_applied", False):
            raise NotImplementedError("a tensor-parallel model has no "
                                      "decode path")
        if cache is not None and seq_shard is not None:
            raise ValueError("seq_shard applies to the full-sequence "
                             "forward only")
        off = 0 if seq_shard is None else int(seq_shard[0])
        if self.tp_embed is not None:
            x = self.tp_embed.embed(tokens, self.embed.weight.to(dt))
        else:
            x = F.embedding(tokens, self.embed.weight.to(dt))
        step = None
        if cache is not None:
            kind = _PagedStep if isinstance(cache, PagedCache) else _Step
            step = kind(cache, t, self.window, self.sinks, valid_len)
            if t == 1 and cache.slot_pos is not None:
                step.put_positions(cache)  # write-then-attend
        if self.pos_embedding is not None:
            if cache is None:
                x = x + self.pos_embedding[off:off + t].to(dt)[None]
            else:
                # parked slots may run past the table: clamp (their
                # output is discarded)
                pos = torch.clamp(step.wpos, max=self.pos_embedding.shape[0] - 1)
                x = x + self.pos_embedding[pos].to(dt)
        # the dropout masks are hashes of (key, element): a recompute
        # draws the same ones
        keys = None
        if train and self.dropout and dropout_seed is not None:
            keys = dropout_keys(dropout_seed, self.depth)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        s = DROPOUT_SITES
        for i, blk in enumerate(self.blocks):
            x = maybe_remat(blk, remat)(
                x, dt, cache, i, step, train,
                None if keys is None else keys[i * s:(i + 1) * s],
                None if seq_shard is None else (off, int(seq_shard[1])))
            if isinstance(blk, MoEDecoderBlock):
                x, aux = x
                if moe_aux is not None:
                    moe_aux.append(aux)
        if cache is not None:
            if t > 1 and cache.slot_pos is not None:
                step.put_positions(cache)
            cache.index += t
        x = self.final_ln(x, dt)
        tp = self.tp_embed if self.head is None else self.tp_head
        if tp is not None:
            x = tp.enter(x)
        if self.head is None:
            logits = x @ self.embed.weight.to(dt).t()
        else:
            logits = dense(self.head, x, dt)
        if tp is not None:
            logits = tp.gather(logits)
        return logits.float()


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy.  ``logits`` [B, T, V] (position t
    predicts token t+1), ``tokens`` [B, T] int; ``mask`` optional [B, T]
    (True = count this *target* position).  f32 log-softmax whatever the
    compute dtype."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long().to(logp.device)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]  # [B, T-1]
    if mask is not None:
        m = mask[:, 1:].to(device=nll.device, dtype=nll.dtype)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1)
    return nll.mean()


def _seq_axis(model):
    """The sequence-parallel ``attn_fn`` of ``model`` (one that names a
    ``seq_axis``, :mod:`..parallel.context`), or ``None``."""
    fn = getattr(model, "attn_fn", None)
    return fn if getattr(fn, "seq_axis", None) is not None else None


def _shard_loss(model, params, tokens, mask, kw, sp):
    """This sequence shard's part of the mean next-token loss: the
    model runs on this rank's positions of the full rows ``tokens``,
    each position's target is read from the full row (so the shift
    crosses the shard boundary; the last global position has none), and
    the sum is divided by the global count.  The shards' parts add up
    to the whole sequence's mean (the mask's count is summed over the
    axis when there is a mask).  Returns ``(part, local logits)``."""
    from torch.func import functional_call

    from ..parallel.collectives import psum

    mesh, axis = sp.mesh, sp.seq_axis
    n, s = mesh.axis_size(axis), mesh.axis_index(axis)
    b, total = tokens.shape
    if total % n:
        raise ValueError(f"sequence length {total} does not split over the "
                         f"{n} ranks of the {axis!r} axis")
    t = total // n
    off = s * t
    logits = functional_call(model, params, (tokens[:, off:off + t],),
                             {**kw, "seq_shard": (off, total)})
    live = min(t, total - 1 - off)  # positions with a target
    logp = torch.log_softmax(logits[:, :live].float(), dim=-1)
    tgt = tokens[:, off + 1:off + 1 + live].long().to(logp.device)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]  # [B, live]
    if mask is not None:
        m = mask[:, off + 1:off + 1 + live].to(device=nll.device,
                                               dtype=nll.dtype)
        count = m.sum()
        if n > 1:
            count = psum(count, mesh.sub(axis))
        return (nll * m).sum() / torch.clamp(count, min=1), logits
    if live == 0:
        return logits.sum() * 0.0, logits
    # the local mean scaled by this shard's share of the positions: the
    # share is exactly 1 on one rank, where this is next_token_loss
    return nll.mean() * (live / (total - 1)), logits


def lm_loss_fn(model: TransformerLM) -> Callable:
    """The LM in the framework loss signature ``fn(params, model_state,
    batch, train, rng=None) -> (loss, (model_state, logits))``.

    ``params`` maps the model's parameter names to tensors (the model is
    applied with them through ``torch.func.functional_call``, as flax
    applies a param tree); ``rng`` is an integer dropout seed.  The
    batch is ``{"tokens": [B, T]}`` with optional ``{"mask": [B, T]}``.
    An MoE model adds, in training only, ``moe_aux_weight`` times the
    mean of its blocks' load-balance terms.  A model whose ``attn_fn``
    is sequence-parallel (:mod:`..parallel.context`) runs on this rank's
    positions of the full rows and returns this shard's part of the
    loss (see :func:`_shard_loss`) and its logits; the parts of the
    ``seq`` ranks sum to the mean (``prepare_training(spmd="sp")`` sums
    them)."""
    from torch.func import functional_call

    from ..optim import div_const

    moe = getattr(model, "moe_every", 0) > 0
    sp = _seq_axis(model)

    def fn(params, model_state, batch, train: bool, rng=None):
        tokens = batch["tokens"]
        aux = []
        kw = {"train": train, "dropout_seed": rng if train else None}
        if moe:
            kw["moe_aux"] = aux
        if sp is not None:
            loss, logits = _shard_loss(model, params, tokens,
                                       batch.get("mask"), kw, sp)
        else:
            logits = functional_call(model, params, (tokens,), kw)
            loss = next_token_loss(logits, tokens, batch.get("mask"))
        if aux and train:
            loss = loss + div_const(model.moe_aux_weight * sum(aux),
                                    len(aux))
        return loss, (model_state, logits)

    return fn


def _validate_pp_boundaries(boundaries, S: int, depth: int, what: str):
    """Planner boundaries sanity: S+1 monotone cut points covering the
    whole stack with >= 1 block per stage.  Returns them as a tuple."""
    b = tuple(int(x) for x in boundaries)
    if len(b) != S + 1:
        raise ValueError(
            f"{what}: boundaries needs S+1 = {S + 1} cut points for the "
            f"{S}-stage pipe axis, got {len(b)} ({list(b)})")
    if b[0] != 0 or b[-1] != depth:
        raise ValueError(
            f"{what}: boundaries must span the whole stack "
            f"(0 .. depth={depth}), got {list(b)}")
    if any(b[s + 1] <= b[s] for s in range(S)):
        raise ValueError(
            f"{what}: every stage needs >= 1 block (strictly increasing "
            f"boundaries), got {list(b)}")
    return b


def _is_local_pipe(mesh) -> bool:
    from ..parallel.pp_1f1b import LocalPipe

    return isinstance(mesh, LocalPipe)


def _pipe_size(mesh, pipe_axis: str) -> int:
    """The number of pipe devices of a mesh or a ``LocalPipe``."""
    return mesh.S if _is_local_pipe(mesh) else mesh.axis_size(pipe_axis)


def _pp_validate_and_stage(model: "TransformerLM", mesh, pipe_axis: str,
                           what: str, blocked: bool = True,
                           boundaries=None):
    """Shared ``lm_pp``/``lm_pp_1f1b`` front half: check the model can
    be pipelined and build the stage callable.  Returns ``(S, V,
    stage_fn)``: V blocks a pipe device (``max(counts)`` under planner
    ``boundaries``, run by a counts-aware ``chunk_stages``).
    ``blocked=True`` wraps V > 1 blocks into one ``chunk_stages`` stage
    (GPipe, plain 1F1B); ``blocked=False`` returns the one-block stage
    for the interleaved schedule.  A stage is the model's
    :class:`DecoderBlock` (with its ``attn_fn``) applied to one block's
    params through ``torch.func.functional_call``."""
    from torch.func import functional_call

    from ..parallel.pp import chunk_stages

    if not model.use_rope:
        raise ValueError(f"{what} needs use_rope=True (a positional table "
                         "would have to enter mid-pipeline)")
    if model.dropout:
        raise ValueError(f"{what} supports dropout=0 only (no rng stream "
                         "threads through the pipeline schedule)")
    if model.moe_every:
        raise ValueError(
            f"{what} does not support moe_every > 0: MoE and dense blocks "
            "have different param trees, so blocks cannot stack as "
            "homogeneous pipe stages")
    S = _pipe_size(mesh, pipe_axis)
    counts = None
    if boundaries is not None:
        if not blocked:
            raise ValueError(
                f"{what}: planner boundaries use the blocked chunk "
                "layout and cannot combine with interleave=True (the "
                "round-robin placement has no contiguous stage ranges)")
        boundaries = _validate_pp_boundaries(boundaries, S, model.depth,
                                             what)
        counts = [boundaries[s + 1] - boundaries[s] for s in range(S)]
        V = max(counts)
    else:
        if model.depth % S:
            raise ValueError(
                f"model.depth ({model.depth}) must be a multiple of the "
                f"'{pipe_axis}' axis size ({S}) — or pass a pp plan, "
                "whose non-uniform boundaries lift the divisibility "
                "requirement")
        V = model.depth // S
    blk, dt = model.blocks[0], model.dtype

    def base_fn(p, x):
        return functional_call(blk, p, (x, dt))

    if counts is not None and V > 1 and any(c != V for c in counts):
        return S, V, chunk_stages(base_fn, counts=counts)
    return S, V, (base_fn if V == 1 or not blocked else chunk_stages(base_fn))


def _pp_split_params(model: "TransformerLM", mesh, pipe_axis: str, S: int,
                     V: int, placement: str = "blocked", boundaries=None):
    """Shared splitter: the model's params (by name, global) -> the flat
    split tree: ``outer/<name>`` for the embedding, the final norm and
    the head, ``stages/<name>`` for one block's params (the
    ``blocks.{i}.`` prefix dropped) stacked ``(S, ...)``, or ``(S, V,
    ...)`` when V > 1.  On a process-group mesh the stage leaves are
    this rank's block (leading dim 1); a ``LocalPipe`` keeps all S.

    ``placement`` puts block ``s V + c`` (``"blocked"``, the
    ``chunk_stages`` layout GPipe and plain 1F1B share) or block ``c S +
    s`` (``"interleaved"``) at ``[s, c]``.  Planner ``boundaries`` take
    the plan's contiguous ranges instead, devices with fewer than ``V =
    max(counts)`` blocks padded with zero blocks that are never run."""
    from ..parallel.pp import join_tree, stack_stage_params

    def stack(trees):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}

    def split_params(params):
        blocks = [{} for _ in range(model.depth)]
        outer = {}
        for k, v in params.items():
            v = v.detach()
            if k.startswith("blocks."):
                i, name = k[len("blocks."):].split(".", 1)
                blocks[int(i)][name] = v
            else:
                outer[k] = v
        if boundaries is not None:
            groups = [blocks[boundaries[s]:boundaries[s + 1]]
                      for s in range(S)]
            if V > 1:
                pad = {k: torch.zeros_like(v) for k, v in blocks[0].items()}
                stages = [stack(g + [pad] * (V - len(g))) for g in groups]
            else:
                stages = [g[0] for g in groups]
        elif V > 1:
            if placement == "interleaved":
                groups = [[blocks[c * S + s] for c in range(V)]
                          for s in range(S)]
            else:
                groups = [blocks[s * V:(s + 1) * V] for s in range(S)]
            stages = [stack(g) for g in groups]
        else:
            stages = blocks
        if _is_local_pipe(mesh):  # it holds every stage
            stacked = stack(stages)
        else:
            stacked = stack_stage_params(stages, mesh, pipe_axis)
        return join_tree(outer, stacked)

    return split_params


def pp_merge_params(model: "TransformerLM", S: int, interleave: bool = False,
                    boundaries=None) -> Callable:
    """The inverse of the wirings' ``split_params`` on global shapes:
    ``merge(flat)`` maps a gathered split tree (``outer/``, ``stages/``
    leaves ``(S, ...)`` or ``(S, V, ...)``) back onto the model's
    parameter names, the padded chunks of a planned split dropped."""
    from ..parallel.pp import split_tree

    bounds = (tuple(boundaries) if boundaries is not None else
              tuple(range(0, model.depth + 1, model.depth // S)))
    counts = [bounds[s + 1] - bounds[s] for s in range(S)]
    V = max(counts)

    def merge(flat):
        outer, stages = split_tree(flat)
        out = dict(outer)
        for name, v in stages.items():
            for s in range(S):
                for c in range(counts[s]):
                    i = c * S + s if interleave else bounds[s] + c
                    out[f"blocks.{i}.{name}"] = v[s][c] if V > 1 else v[s]
        return out

    return merge


def _pp_embed(model: "TransformerLM", outer: dict,
              tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, outer["embed.weight"].to(model.dtype))


def _pp_logits(model: "TransformerLM", outer: dict,
               x: torch.Tensor) -> torch.Tensor:
    """The final norm and the logits (f32) from the outer leaves."""
    from torch.func import functional_call

    dt = model.dtype
    ln = {k[len("final_ln."):]: v for k, v in outer.items()
          if k.startswith("final_ln.")}
    x = functional_call(model.final_ln, ln, (x, dt))
    if model.tie_embeddings:
        logits = x @ outer["embed.weight"].to(dt).t()
    else:
        logits = F.linear(x, outer["head.weight"].to(dt),
                          outer["head.bias"].to(dt))
    return logits.float()


def lm_pp(model: TransformerLM, mesh, pipe_axis: str = PIPE_AXIS,
          batch_axis: Optional[str] = None,
          num_microbatches: Optional[int] = None, remat: bool = False,
          boundaries=None):
    """Pipeline-parallelize the LM on the GPipe schedule: block *i* of
    each pipe device's range is a stage of ``parallel.pp.pipeline_apply``,
    and the embedding, the final norm and the (tied) logits run outside
    the pipelined middle, on every pipe rank.

    Returns ``(split_params, loss_fn, state_specs)``:

    * ``split_params(params)`` maps the model's params (by name) to the
      flat split tree (``outer/``, ``stages/``), this rank's block of the
      stages;
    * ``loss_fn`` has the framework loss signature on that tree;
    * ``state_specs(state)`` is the ``TrainState`` of specs (stages on
      ``pipe_axis``, outer replicated), the state's ``TrainTask.specs``.

    ``batch_axis`` composes data parallelism on a ``(data, pipe)`` mesh.
    Needs ``use_rope`` and ``dropout == 0``, and no MoE.  ``boundaries``
    (a planner's S+1 cut points, ``parallel.pp_plan``) replaces the
    uniform split by the plan's non-uniform ranges and lifts ``depth %
    S == 0``."""
    from ..parallel.pp import pipeline_apply, split_tree
    from ..parallel.pp_1f1b import split_state_specs

    S, V, stage_fn = _pp_validate_and_stage(model, mesh, pipe_axis, "lm_pp",
                                            boundaries=boundaries)
    fwd = pipeline_apply(stage_fn, mesh, axis=pipe_axis,
                         num_microbatches=num_microbatches,
                         batch_axis=batch_axis, remat=remat)
    split_params = _pp_split_params(model, mesh, pipe_axis, S, V,
                                    boundaries=boundaries)

    def loss_fn(params, model_state, batch, train: bool, rng=None):
        outer, stages = split_tree(params)
        tokens = batch["tokens"]
        x = fwd(stages, _pp_embed(model, outer, tokens))
        logits = _pp_logits(model, outer, x)
        return next_token_loss(logits, tokens, batch.get("mask")), (
            model_state, logits)

    return split_params, loss_fn, split_state_specs(pipe_axis)


class LMPipelineWiring(NamedTuple):
    """Everything ``parallel.pp_1f1b.make_train_step_1f1b`` needs, with
    the interleave factor (1 for the blocked placement, whose V blocks a
    device ride inside ``chunk_stages``)::

        w = lm_pp_1f1b(model, mesh, interleave=True)
        step = make_train_step_1f1b(*w.fns, opt, mesh,
                                    interleave=w.interleave, ...)
        state = TrainState.create(w.split_params(params), opt)
    """

    split_params: Callable
    fns: tuple  # (stage_fn, embed_fn, head_fn)
    state_specs: Callable
    interleave: int = 1


def lm_pp_1f1b(model: TransformerLM, mesh, pipe_axis: str = PIPE_AXIS,
               interleave: bool = False, boundaries=None) -> LMPipelineWiring:
    """Pipeline-parallelize the LM on the hand-scheduled 1F1B schedule
    (``parallel.pp_1f1b``): the same stages and, for the blocked
    placement, the same split tree as :func:`lm_pp`, so checkpoints move
    between the two schedules.  The embedding runs at logical stage 0
    and the final norm, logits and each microbatch's loss at the last
    one, inside the schedule; their gradients are summed over the pipe,
    which sums a tied embedding's two parts.

    ``interleave=True`` takes the Megatron interleaved placement (device
    *i* hosts blocks ``c S + i``; its split tree differs from the
    blocked one).  ``mesh`` is a process-group mesh or a
    ``parallel.LocalPipe``.  ``lm_pp``'s constraints hold, the batch
    carries no ``mask`` (the per-microbatch loss reads tokens only), and
    ``boundaries`` cannot combine with ``interleave``."""
    from ..parallel.pp_1f1b import split_state_specs

    S, V, stage_fn = _pp_validate_and_stage(
        model, mesh, pipe_axis, "lm_pp_1f1b", blocked=not interleave,
        boundaries=boundaries)

    def embed_fn(outer, tokens_mb):
        return _pp_embed(model, outer, tokens_mb)

    def head_fn(outer, y, tokens_mb):
        return next_token_loss(_pp_logits(model, outer, y), tokens_mb)

    return LMPipelineWiring(
        _pp_split_params(model, mesh, pipe_axis, S, V,
                         placement="interleaved" if interleave else "blocked",
                         boundaries=boundaries),
        (stage_fn, embed_fn, head_fn),
        split_state_specs(pipe_axis),
        V if interleave else 1)


def make_decode_cache(model: TransformerLM, batch: int, total_len: int,
                      kv_quant: str = "none") -> DecodeCache:
    """A fresh cache for ``batch`` rows out to ``total_len`` tokens, on
    the model's device: zero K/V, zero cursors, and ``slot_pos = -1``
    ("unwritten") for a windowed ring of ``min(window + sinks,
    total_len)`` slots — a zero there would fake a written position 0."""
    store = _kv_store_dtype(kv_quant) or model.dtype
    rows = (total_len if model.window is None
            else min(model.window + model.sinks, total_len))
    hkv = model.num_kv_heads or model.num_heads
    hd = model.dim // model.num_heads
    dev = model.device

    def bufs(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(model.depth)]

    quant = kv_quant != "none"
    return DecodeCache(
        k=bufs((batch, rows, hkv, hd), store),
        v=bufs((batch, rows, hkv, hd), store),
        k_scale=bufs((batch, rows, hkv), torch.float32) if quant else None,
        v_scale=bufs((batch, rows, hkv), torch.float32) if quant else None,
        index=torch.zeros(batch, dtype=torch.int32, device=dev),
        slot_pos=(None if model.window is None else
                  torch.full((batch, rows), -1, dtype=torch.int32, device=dev)),
        kv_quant=kv_quant)


def make_paged_cache(model: TransformerLM, batch: int, total_len: int,
                     block_size: int, kv_blocks: int,
                     kv_quant: str = "none") -> PagedCache:
    """A fresh paged cache on the model's device: ``kv_blocks`` zero
    blocks of ``block_size`` rows per layer (plus the scratch block),
    every page unbound (-1), cursors and write gates at 0, and
    ``slot_pos = -1`` for a windowed ring.  Each row spans
    ``ceil(rows / block_size)`` pages, where ``rows`` is ``total_len``
    or, for a windowed ring, ``min(window + sinks, total_len)``."""
    if block_size < 1 or kv_blocks < 1:
        raise ValueError(f"need block_size >= 1 and kv_blocks >= 1, got "
                         f"{block_size} and {kv_blocks}")
    store = _kv_store_dtype(kv_quant) or model.dtype
    rows = (total_len if model.window is None
            else min(model.window + model.sinks, total_len))
    pages = -(-rows // block_size)
    hkv = model.num_kv_heads or model.num_heads
    hd = model.dim // model.num_heads
    dev = model.device

    def pools(shape, dtype):
        return [torch.zeros((kv_blocks + 1, block_size) + shape, dtype=dtype,
                            device=dev) for _ in range(model.depth)]

    quant = kv_quant != "none"
    return PagedCache(
        k=pools((hkv, hd), store),
        v=pools((hkv, hd), store),
        k_scale=pools((hkv,), torch.float32) if quant else None,
        v_scale=pools((hkv,), torch.float32) if quant else None,
        index=torch.zeros(batch, dtype=torch.int32, device=dev),
        page_table=torch.full((batch, pages), -1, dtype=torch.int32,
                              device=dev),
        slot_live=torch.zeros(batch, dtype=torch.int32, device=dev),
        slot_pos=(None if model.window is None else
                  torch.full((batch, pages * block_size), -1,
                             dtype=torch.int32, device=dev)),
        block_size=block_size, kv_quant=kv_quant)


def _sample(logits, temperature, k_eff, top_p, rng):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    # filter math in f32: a bf16 cumsum saturates below 1.0
    logits = logits.float() / temperature
    if k_eff or top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cutoff = torch.full((logits.shape[0], 1), -math.inf,
                            device=logits.device)
        if k_eff:
            cutoff = sorted_logits[:, k_eff - 1:k_eff]
        if top_p < 1.0:
            # nucleus: the smallest prefix with cumulative probability
            # >= top_p (the first token past the threshold stays in)
            probs = torch.softmax(sorted_logits, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = cum - probs < top_p
            p_cut = torch.where(keep, sorted_logits,
                                torch.full_like(sorted_logits, math.inf))
            cutoff = torch.maximum(cutoff, p_cut.amin(dim=-1, keepdim=True))
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, -math.inf), logits)
    probs = torch.softmax(logits, dim=-1).to(rng.device)
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(logits.device)


@torch.no_grad()
def generate(model: TransformerLM, prompt, total_len: int,
             temperature: float = 0.0,
             rng: Optional[torch.Generator] = None, top_k: int = 0,
             top_p: float = 1.0, *, kv_quant: str = "none") -> torch.Tensor:
    """Autoregressive sampling with the KV cache.

    The prompt [B, P] is prefilled in one parallel forward, then
    single-token cache steps sample out to ``total_len``: greedy at
    ``temperature=0``, else softmax sampling with ``rng`` (a
    ``torch.Generator``, on any device).  ``top_k`` keeps the k highest
    logits and ``top_p`` the smallest nucleus with cumulative
    probability >= p (0 / 1.0 disable).  ``kv_quant`` selects the cache
    storage.  Returns tokens [B, total_len] int32 (prompt included).
    """
    if not model.use_rope and total_len > model.max_len:
        raise ValueError(
            f"total_len ({total_len}) exceeds the learned positional "
            f"table (max_len={model.max_len})")
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=model.device)
    bsz, plen = prompt.shape
    if not 0 < plen <= total_len:
        raise ValueError(f"need 0 < prompt len ({plen}) <= total_len "
                         f"({total_len})")
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 samples stochastically — pass rng "
                         "(a torch.Generator) or use temperature=0 for greedy")
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"need top_k >= 0 and 0 < top_p <= 1, got {top_k}, "
                         f"{top_p}")
    if (top_k or top_p < 1.0) and temperature == 0.0:
        raise ValueError("top_k/top_p filter a sampling distribution — "
                         "set temperature > 0 (greedy ignores them)")
    if total_len == plen:
        return prompt.to(torch.int32)
    k_eff = top_k if 0 < top_k < model.vocab else 0
    cache = make_decode_cache(model, bsz, total_len, kv_quant)
    logits = model(prompt, cache)
    tok = _sample(logits[:, -1], temperature, k_eff, top_p, rng)
    out = [prompt, tok[:, None]]
    for _ in range(total_len - plen - 1):
        logits = model(tok[:, None], cache)
        tok = _sample(logits[:, 0], temperature, k_eff, top_p, rng)
        out.append(tok[:, None])
    return torch.cat(out, dim=1).to(torch.int32)


def lm_tiny(vocab: int = 256, **kw) -> TransformerLM:
    """Test/CI scale: 4 layers, d=128."""
    kw = {"depth": 4, "dim": 128, "num_heads": 4, "mlp_dim": 512, **kw}
    return TransformerLM(vocab=vocab, **kw)


def lm_small(vocab: int = 32000, **kw) -> TransformerLM:
    """GPT-2-small scale: 12 layers, d=768 (~124M with a 32k vocab)."""
    kw = {"depth": 12, "dim": 768, "num_heads": 12, "mlp_dim": 3072, **kw}
    return TransformerLM(vocab=vocab, **kw)


def lm_medium(vocab: int = 32000, **kw) -> TransformerLM:
    """GPT-2-medium scale: 24 layers, d=1024."""
    kw = {"depth": 24, "dim": 1024, "num_heads": 16, "mlp_dim": 4096, **kw}
    return TransformerLM(vocab=vocab, **kw)
