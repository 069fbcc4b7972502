"""Decoder-only transformer LM and its KV-cache decode path.

Port of ``fluxdistributed_tpu/models/transformer_lm.py``: pre-norm
blocks (layernorm or rmsnorm), GELU or SwiGLU MLPs, RoPE or learned
positions, grouped-query attention, sliding window with attention
sinks, tied embeddings, and f32 logits.  Parameters are stored in f32
and cast to the compute ``dtype`` at use, as flax does; the serving
engine casts them once up front.

Decoding keeps a :class:`DecodeCache` (one K/V buffer per layer, one
cursor per batch row) and updates it IN PLACE: the JAX package returns
a new cache per call, the port writes rows where they live.  Every
batch row has its own cursor, so one code path serves ``generate``
(all rows at the same depth), batch-1 prefill and the engine's
all-slot decode step (every slot at its own depth):

* a single-token step (``t == 1``) writes its K/V first and then
  attends through :func:`..ops.flash_decode.flash_decode` (the Hopper
  kernel on the GPU, its plain version on the CPU): for a windowed ring
  the key the write evicts is a full ring behind the cursor, out of
  band by construction;
* a multi-token prefill (``t > 1``) attends with
  :func:`..ops.attention.dot_product_attention`: the plain cache writes
  and then attends the masked cache, the windowed ring attends
  [old ring ∥ this chunk] BEFORE its rolling write, so a chunk's early
  queries still see the band keys its newest tokens overwrite.

A write whose position falls past the cache end (a parked slot's cursor
drifting on) is dropped, never wrapped or indexed out of range.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from ..ops.flash_decode import flash_decode

__all__ = [
    "KV_QUANTS",
    "VALID_UNGATED",
    "CausalSelfAttention",
    "DecodeCache",
    "DecoderBlock",
    "TransformerLM",
    "dequantize_kv",
    "generate",
    "lm_medium",
    "lm_small",
    "lm_tiny",
    "make_decode_cache",
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


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """``x @ W^T + b`` in the compute dtype (flax ``Dense(dtype=...)``)."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


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


class CausalSelfAttention(nn.Module):
    """QKV projection + RoPE + causal core + output projection.

    Weights mirror the flax module: ``qkv`` (features ordered
    [3, H, Dh]) or, under GQA, ``q`` ([H, Dh]) and ``kv`` ([2, Hkv,
    Dh]); ``out`` ([H·Dh] → dim).  All projections carry biases, as
    flax's ``DenseGeneral`` does.
    """

    def __init__(self, dim: int, num_heads: int, *,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, sinks: int = 0,
                 use_rope: bool = True):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim ({dim}) must divide num_heads "
                             f"({num_heads})")
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0, got {sinks}")
        if sinks and window is None:
            raise ValueError(
                f"sinks={sinks} requires a sliding window: attention sinks "
                "pin the first keys OUTSIDE the window. Pass window=<int> "
                "or sinks=0.")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        hkv = num_kv_heads or num_heads
        if num_heads % hkv:
            raise ValueError(f"num_heads ({num_heads}) must be a multiple "
                             f"of num_kv_heads ({hkv})")
        self.num_heads, self.num_kv_heads = num_heads, hkv
        self.head_dim = dim // num_heads
        self.window, self.sinks, self.use_rope = window, sinks, use_rope
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
            q = _linear(self.q, x, dtype).view(b, t, h, hd)
            kv = _linear(self.kv, x, dtype).view(b, t, 2, hkv, hd)
            return q, kv[:, :, 0], kv[:, :, 1]
        qkv = _linear(self.qkv, x, dtype).view(b, t, 3, h, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                cache: Optional[DecodeCache] = None, layer: int = 0,
                step: Optional[_Step] = None) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = self._project(x, dtype)
        if cache is None:
            if self.use_rope:
                pos = torch.arange(t, device=x.device)
                q, k = rope(q, pos), rope(k, pos)
            out = dot_product_attention(q, k, v, causal=True,
                                        window=self.window, sinks=self.sinks)
        else:
            out = self._decode(q, k, v, dtype, cache, layer, step)
        return _linear(self.out, out.reshape(b, t, -1), dtype)

    def _decode(self, q, k, v, dtype, cache: DecodeCache, layer: int,
                st: _Step):
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

        if st.t == 1:
            # write-then-attend through the decode kernel (slot_pos was
            # updated for this step before the first layer)
            write()
            return flash_decode(
                q.contiguous(), ck, cv, st.idx32, slot_pos=cache.slot_pos,
                window=self.window, sinks=self.sinks, k_scale=ks, v_scale=vs)
        if self.window is None:
            write()
            attn_k = dequantize_kv(ck, ks, dtype) if quant else ck
            attn_v = dequantize_kv(cv, vs, dtype) if quant else cv
        else:
            # read [old ring ∥ this chunk] BEFORE the rolling write;
            # quantised chunks attend their STORED (dequantised) values
            k_at = dequantize_kv(k_store, k_sc, dtype) if quant else k
            v_at = dequantize_kv(v_store, v_sc, dtype) if quant else v
            ring_k = dequantize_kv(ck, ks, dtype) if quant else ck
            ring_v = dequantize_kv(cv, vs, dtype) if quant else cv
            attn_k = torch.cat([ring_k, k_at], dim=1)
            attn_v = torch.cat([ring_v, v_at], dim=1)
            write()
        return dot_product_attention(q, attn_k, attn_v,
                                     mask=st.allow[:, None])


class DecoderBlock(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))`` then ``x + mlp(norm(x))``.
    The MLP is GELU (tanh approximation, ``fc1``/``fc2`` with biases) or
    SwiGLU (biasless ``gate``/``up``/``down``)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, *,
                 num_kv_heads=None, window=None, sinks=0, use_rope=True,
                 norm="layernorm", norm_eps=1e-6, mlp="gelu"):
        super().__init__()
        if mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp {mlp!r} (gelu|swiglu)")
        self.mlp = mlp
        self.ln1 = _Norm(dim, norm, norm_eps)
        self.attn = CausalSelfAttention(
            dim, num_heads, num_kv_heads=num_kv_heads, window=window,
            sinks=sinks, use_rope=use_rope)
        self.ln2 = _Norm(dim, norm, norm_eps)
        if mlp == "swiglu":
            self.gate = nn.Linear(dim, mlp_dim, bias=False)
            self.up = nn.Linear(dim, mlp_dim, bias=False)
            self.down = nn.Linear(mlp_dim, dim, bias=False)
        else:
            self.fc1 = nn.Linear(dim, mlp_dim)
            self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x, dtype, cache=None, layer=0, step=None):
        x = x + self.attn(self.ln1(x, dtype), dtype, cache, layer, step)
        y = self.ln2(x, dtype)
        if self.mlp == "swiglu":
            y = F.silu(_linear(self.gate, y, dtype)) * _linear(self.up, y, dtype)
            y = _linear(self.down, y, dtype)
        else:
            y = F.gelu(_linear(self.fc1, y, dtype), approximate="tanh")
            y = _linear(self.fc2, y, dtype)
        return x + y


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens [B, T] int → logits [B, T, vocab] f32.

    Position t's logits predict token t+1.  With ``tie_embeddings`` the
    output head reuses the input table (logits = h @ E^T).  Weights are
    initialised from ``seed`` on the CPU (so every device gets the same
    numbers) and moved to ``device`` (default ``cuda``; see
    :func:`..device.resolve_device`).  ``use_rope=False`` needs
    ``max_len``, the learned positional table's length.
    """

    def __init__(self, vocab: int, depth: int = 4, dim: int = 256,
                 num_heads: int = 4, mlp_dim: int = 1024, *,
                 dtype: torch.dtype = torch.bfloat16, use_rope: bool = True,
                 tie_embeddings: bool = True,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None, sinks: int = 0,
                 norm: str = "layernorm", norm_eps: float = 1e-6,
                 mlp: str = "gelu", max_len: Optional[int] = None,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if not use_rope and max_len is None:
            raise ValueError("use_rope=False needs max_len (the learned "
                             "positional table's length)")
        self.vocab, self.depth, self.dim = vocab, depth, dim
        self.num_heads, self.mlp_dim = num_heads, mlp_dim
        self.num_kv_heads = num_kv_heads
        self.window, self.sinks = window, sinks
        self.use_rope, self.tie_embeddings = use_rope, tie_embeddings
        self.max_len, self.dtype = max_len, dtype
        self.embed = nn.Embedding(vocab, dim)
        self.pos_embedding = (None if use_rope else
                              nn.Parameter(torch.zeros(max_len, dim)))
        self.blocks = nn.ModuleList(
            DecoderBlock(dim, num_heads, mlp_dim, num_kv_heads=num_kv_heads,
                         window=window, sinks=sinks, use_rope=use_rope,
                         norm=norm, norm_eps=norm_eps, mlp=mlp)
            for _ in range(depth))
        self.final_ln = _Norm(dim, norm, norm_eps)
        self.head = None if tie_embeddings else nn.Linear(dim, vocab)
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

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, tokens: torch.Tensor,
                cache: Optional[DecodeCache] = None, *,
                valid_len: int = VALID_UNGATED) -> torch.Tensor:
        """Full causal forward (``cache=None``), or one decode call that
        advances every row of ``cache`` by ``T`` positions.
        ``valid_len`` is the number of REAL positions in this call (a
        padded prefill's pads never write into a windowed ring)."""
        dt = self.dtype
        tokens = tokens.to(self.device)
        b, t = tokens.shape
        x = F.embedding(tokens, self.embed.weight.to(dt))
        step = None
        if cache is not None:
            step = _Step(cache, t, self.window, self.sinks, valid_len)
            if t == 1 and cache.slot_pos is not None:
                step.put_positions(cache)  # write-then-attend
        if self.pos_embedding is not None:
            if cache is None:
                x = x + self.pos_embedding[:t].to(dt)[None]
            else:
                # parked slots may run past the table: clamp (their
                # output is discarded)
                pos = torch.clamp(step.wpos, max=self.pos_embedding.shape[0] - 1)
                x = x + self.pos_embedding[pos].to(dt)
        for i, blk in enumerate(self.blocks):
            x = blk(x, dt, cache, i, step)
        if cache is not None:
            if t > 1 and cache.slot_pos is not None:
                step.put_positions(cache)
            cache.index += t
        x = self.final_ln(x, dt)
        if self.head is None:
            logits = x @ self.embed.weight.to(dt).t()
        else:
            logits = _linear(self.head, x, dt)
        return logits.float()


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
