"""Flash decode: one query row per slot against a dense slot KV cache.

Port of ``fluxdistributed_tpu/ops/pallas_decode.py:flash_decode`` (the
dense form of the Pallas ``_decode_kernel``).  Two versions of one
function:

* on a CUDA tensor, the hand-written Hopper kernel
  ``csrc/flash_decode.cu`` (built by :mod:`._build`, bound with
  ``ctypes``); it launches or raises, never falls back;
* on a CPU tensor, :func:`flash_decode_reference`, the plain PyTorch
  version: the JAX package's ``_xla_block_walk`` schedule (f32 online
  softmax over ``block_k``-row blocks, dead blocks skipped).

Both keep the probabilities in f32 through P·V, as the XLA walk does.
(The Pallas body instead rounds p to v's dtype, so on a bf16 cache the
two JAX impls differ by bf16 rounding of p; the port follows the XLA
walk on both devices.)  ``flash_decode.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .attention import NEG_INF, online_softmax_update

__all__ = ["flash_decode", "flash_decode_reference"]

# dtype codes shared with csrc/flash_decode.cu
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
_QUANT = (torch.int8, torch.float8_e4m3fn)


def _validate(window, sinks, slot_pos, k_scale, v_scale):
    if (window is None) != (slot_pos is None):
        raise ValueError(
            "windowed decode needs BOTH window= and slot_pos= (the ring's "
            "position side buffer); plain decode needs neither")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sinks and window is None:
        raise ValueError("sinks only make sense with a window")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized decode needs BOTH k_scale and v_scale")


def _check_shapes(q, k, v, idx, slot_pos, k_scale):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(
            f"flash decode takes one query row per slot: q must be "
            f"[B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v must both be [B, R, Hkv, D] = [{b}, R, Hkv, {d}], got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(
            f"num query heads ({h}) must be a multiple of num KV heads "
            f"({hkv}) for grouped-query attention")
    if idx.shape != (b,):
        raise ValueError(f"idx must be [B] = [{b}], got {tuple(idx.shape)}")
    if slot_pos is not None and slot_pos.shape != k.shape[:2]:
        raise ValueError(f"slot_pos must be [B, R] = {tuple(k.shape[:2])}, "
                         f"got {tuple(slot_pos.shape)}")
    if k_scale is not None and k_scale.shape != k.shape[:3]:
        raise ValueError(f"k_scale/v_scale must be [B, R, Hkv] = "
                         f"{tuple(k.shape[:3])}, got {tuple(k_scale.shape)}")


def _dequant(x, scale):
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def flash_decode_reference(q, k, v, idx, *, slot_pos=None, window=None,
                           sinks=0, k_scale=None, v_scale=None,
                           block_k: int = 128):
    """The plain PyTorch version: ``_xla_block_walk`` with the dense
    cursor or windowed-ring mask.  Same contract as :func:`flash_decode`."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    r = k.shape[1]
    block_k = min(block_k, r)
    q4 = q[:, 0].reshape(b, hkv, g, d).float() * (1.0 / math.sqrt(d))
    idx = idx.to(torch.int64)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    for j0 in range(0, r, block_k):
        j1 = min(j0 + block_k, r)
        if window is None:
            pos = torch.arange(j0, j1, device=q.device)
            allow = pos[None, :] <= idx[:, None]
        else:
            sp = slot_pos[:, j0:j1].to(torch.int64)
            qg = idx[:, None]
            allow = (sp >= 0) & (sp <= qg)
            band = sp > qg - window
            if sinks:
                band = band | (sp < sinks)
            allow = allow & band
        if not bool(allow.any()):
            continue  # dead block: no K/V touched
        kb = _dequant(k[:, j0:j1], None if k_scale is None else k_scale[:, j0:j1])
        vb = _dequant(v[:, j0:j1], None if v_scale is None else v_scale[:, j0:j1])
        s = torch.einsum("bhgd,bkhd->bhgk", q4, kb)
        p, corr, m, l = online_softmax_update(s, m, l,
                                              mask=allow[:, None, None, :])
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from . import _build

        lib = _build.load("flash_decode")
        fn = lib.flash_decode_launch
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_decode_error_string)
    return _fn


def _launch(q, k, v, idx, slot_pos, window, sinks, k_scale, v_scale):
    b, _, h, d = q.shape
    r, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _Q_CODES:
        raise TypeError(f"flash_decode kernel takes q in float32 or bfloat16, "
                        f"got {q.dtype}")
    if k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel takes a K/V cache in "
                        f"{list(_KV_CODES)}, got {k.dtype}/{v.dtype}")
    quant = k.dtype in _QUANT
    if not quant and k.dtype != q.dtype:
        raise TypeError(f"an unquantized cache must match q's dtype "
                        f"({q.dtype}), got {k.dtype}")
    if quant != (k_scale is not None):
        raise TypeError(f"int8/fp8 caches need k_scale/v_scale and other "
                        f"caches take none (cache {k.dtype})")
    if d % 16 or d > 256:
        raise ValueError(f"flash_decode kernel needs head_dim % 16 == 0 and "
                         f"<= 256, got {d}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if slot_pos is not None and slot_pos.dtype != torch.int32:
        raise TypeError(f"slot_pos must be int32, got {slot_pos.dtype}")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    tensors = [q, k, v, idx, slot_pos, k_scale, v_scale]
    for t in tensors:
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash_decode kernel needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError("flash_decode kernel needs 16-byte aligned inputs")
    out = torch.empty_like(q)
    fn, errstr = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(_Q_CODES[q.dtype], _KV_CODES[k.dtype], int(window is not None),
                 _ptr(q), _ptr(k), _ptr(v), _ptr(idx), _ptr(slot_pos),
                 _ptr(k_scale), _ptr(v_scale), _ptr(out), b, r, h, hkv, d,
                 int(window or 0), int(sinks), 1.0 / math.sqrt(d),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"{errstr(err).decode()} (cudaError {err})")
    flash_decode.launches += 1
    return out


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    idx: torch.Tensor,
    *,
    slot_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash decode over a dense slot cache.

    ``q`` [B, 1, H, D] (ONE query row per slot), ``k``/``v``
    [B, R, Hkv, D] (the slot cache AFTER this step's write), ``idx``
    [B] int32 per-slot cursors (the position of this step's token).
    Plain caches attend positions ``<= idx``; windowed rings pass
    ``slot_pos`` [B, R] (+ ``window``/``sinks``) and the band mask runs
    over ring slots.  Quantized (int8 / fp8 e4m3) caches pass
    ``k_scale``/``v_scale`` [B, R, Hkv] f32.  → [B, 1, H, D] in q's
    dtype; slots with nothing attendable return exactly 0.

    On a CUDA tensor this launches the Hopper kernel (its tile size is
    its own; ``block_k`` sets the plain version's block rows); on a CPU
    tensor it runs :func:`flash_decode_reference`.
    """
    _validate(window, sinks, slot_pos, k_scale, v_scale)
    _check_shapes(q, k, v, idx, slot_pos, k_scale)
    if block_k < 1:
        raise ValueError(f"block_k must be >= 1, got {block_k}")
    if q.device.type == "cuda":
        return _launch(q, k, v, idx, slot_pos, window, sinks, k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode runs on cuda or cpu, got {q.device}")
    return flash_decode_reference(
        q, k, v, idx, slot_pos=slot_pos, window=window, sinks=sinks,
        k_scale=k_scale, v_scale=v_scale, block_k=block_k)


#: kernel launches since the last reset (plain int; the CPU path and the
#: plain version never count)
flash_decode.launches = 0
