"""Flash attention for training: fused forward and backward.

Port of ``fluxdistributed_tpu/ops/pallas_attention.py``.  Its three
Pallas kernels become three hand-written Hopper kernels in
``csrc/flash_attention.cu`` (built by :mod:`._build`, bound with
``ctypes``), each behind a wrapper with a plain PyTorch version:

* B1 :func:`flash_attention_fwd` (``_flash_kernel``): O and the per-row
  logsumexp;
* B2 :func:`flash_attention_dq` (``_flash_dq_kernel``): dQ;
* B3 :func:`flash_attention_dkv` (``_flash_dkv_kernel``): dK and dV,
  summed over each KV head's query group.

On a CUDA tensor a wrapper launches its kernel or raises, never falls
back; on a CPU tensor it runs the plain version
(:func:`flash_attention_fwd_reference` and the others), which walks the
same blocks in Python, vectorised over batch and heads, with the Pallas
bodies' math and rounding points: scores in f32 times ``scale``, p
rounded to v's dtype before P·V, ds to k's dtype before ds·K, p to dO's
and ds to q's dtype before the dK/dV products.  The kernels choose their
own tiles (:data:`TILE_Q` query rows by :data:`TILE_K` key rows);
``block_q``/``block_k`` set the plain versions' blocks, so the two differ
only by summation order.  In bf16 the three kernels run on the tensor
cores, and B2 and B3 round ds (and B3 p) to bf16 as the plain version
does: pairs whose rounding the tensor cores' sums could decide otherwise
are flagged and summed again in the plain order.  f32 runs SIMT FMAs
(``csrc/flash_attention.cu`` says why).  :func:`kernel_design` is the
launcher's dispatch: bf16 B1, B2 and B3 at head dims 64, 80 and 128 run
the Hopper kernels (wgmma, TMA, warp-specialised), which read q, k, v and
dO in place through TMA descriptors (:func:`tma_geometry`; D = 80 rows as
two boxes, :func:`row_boxes`); bf16 at D = 32 runs mma.sync, f32 SIMT.  The B2/B3 wrappers refuse a view
TMA cannot take rather than copy it; B1's wrapper and the autograd
functions hand the kernels :func:`_readable` tensors (a contiguous copy
only of what a design cannot read).  :func:`rounding_audit` counts,
on the card, how often that flag fires and whether it missed a pair.
On fake tensors (a priced step, :mod:`..fake`), on any device, each
wrapper takes its shape-only branch: it checks what the kernel checks
and returns the kernel's outputs, fake, without a launch or a count.

:func:`flash_attention` and :func:`flash_attention_lse` are
``torch.autograd.Function`` s over these three (the JAX ``custom_vjp``
pairs ``_fwd``/``_bwd`` and ``_fwd_lse``/``_bwd_lse``), so the CPU
backward runs the B2/B3 schedule too, not autograd of the forward.
``delta = rowsum(dO ∘ O)`` (minus the LSE cotangent) is computed in f32
outside the kernels, as ``_flash_bwd_impl`` does.  Each wrapper counts
its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..fake import is_fake
from .attention import (NEG_INF, online_softmax_update,
                        validate_window)
from .counts import count

__all__ = [
    "DESIGNS",
    "HOPPER_BWD_DIMS",
    "HOPPER_FWD_DIMS",
    "TILE_K",
    "TILE_Q",
    "TMA_BOX",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "flash_attention_lse",
    "kernel_design",
    "rounding_audit",
    "row_boxes",
    "tma_geometry",
]

# dtype codes and kernel ids shared with csrc/flash_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DQ, _DKV = 0, 1, 2
_HEAD_DIMS = (32, 64, 80, 128)
#: the kernels' tiles: query rows and key rows (``kTile`` in the source);
#: a tile outside the causal / window band is skipped whole
TILE_Q = TILE_K = 64
#: the kernels' designs, by the launcher's code (``design_of`` in the
#: source): f32, bf16 on mma.sync, bf16 on the Hopper kernels
DESIGNS = ("SIMT f32", "tensor cores, mma.sync",
           "wgmma, TMA, warp-specialised")
#: head dims at which bf16 B1 runs the Hopper kernel (``kHopperFwd``);
#: 32 stays on mma.sync
HOPPER_FWD_DIMS = (64, 80, 128)
#: head dims at which bf16 B2 and B3 run the Hopper kernels
#: (``kHopperBwd``); 32 stays on mma.sync
HOPPER_BWD_DIMS = (64, 80, 128)
#: a Hopper kernel's TMA box: 64 features (one 128-byte swizzle atom) x
#: ``TILE_Q`` rows of one head of one batch row; D = 128 takes two, and
#: D = 80 one and a 16-feature box (:func:`row_boxes`)
TMA_BOX = (64, TILE_Q, 1, 1)
_KERNELS = {"fwd": _FWD, "dq": _DQ, "dkv": _DKV}


def kernel_design(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The design the launcher runs ``kernel`` (``"fwd"``, ``"dq"`` or
    ``"dkv"``) on for ``dtype`` and ``head_dim``, one of
    :data:`DESIGNS`: an explicit table, never a fall-back."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {tuple(_KERNELS)}, got "
                         f"{kernel!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or "
                        f"bfloat16, got {dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{_HEAD_DIMS}, got {head_dim}")
    if dtype == torch.float32:
        return DESIGNS[0]
    hopper = HOPPER_FWD_DIMS if kernel == "fwd" else HOPPER_BWD_DIMS
    return DESIGNS[2] if head_dim in hopper else DESIGNS[1]


def row_boxes(head_dim: int):
    """The TMA boxes across a row of ``head_dim`` features (``RowBoxes``
    in the source), each ``(features, swizzle bytes)``: whole boxes of 64
    features with the 128-byte swizzle, then at most one of 16 features
    with the 32-byte swizzle (D = 80's 160-byte row); None where no split
    takes ``head_dim``."""
    wide, tail = divmod(int(head_dim), TMA_BOX[0])
    if wide == 0 or tail not in (0, 16):
        return None
    return ((TMA_BOX[0], 128),) * wide + (((tail, 32),) if tail else ())


def _tma_refusals(shape, strides, element_size, data_ptr) -> list:
    """Why TMA cannot read a [B, T, H, D] view in place (empty: it can):
    the feature dim not contiguous, or the base address or a byte stride
    of T, H or B not a positive multiple of 16 (a dim of extent 1 is
    exempt: its coordinate is always 0)."""
    bad = [] if int(strides[3]) == 1 else [
        f"feature stride {int(strides[3])} (must be 1)"]
    bad += [f"{name} stride {v} bytes" for name, v in zip(
        ("seq", "head", "batch"), _tma_strides(shape, strides, element_size))
        if v <= 0 or v % 16]
    if data_ptr % 16:
        bad.append(f"base address {data_ptr:#x}")
    return bad


def _tma_strides(shape, strides, element_size):
    """The byte strides of T, H and B that a descriptor takes: 128 for a
    dim of extent 1."""
    b, t, h, _ = (int(n) for n in shape)
    sb, st, sh, _ = (int(s) for s in strides)
    return tuple(128 if n == 1 else s * element_size
                 for n, s in ((t, st), (h, sh), (b, sb)))


def tma_geometry(shape, strides, element_size: int = 2,
                 data_ptr: int = 0) -> dict:
    """The TMA descriptors a Hopper kernel builds for a [B, T, H, D] view
    with element ``strides`` (``encode_view`` in the source): dims
    ``(D, T, H, B)``, the byte strides of T, H and B (128 for a dim of
    extent 1, whose coordinate is always 0), the box :data:`TMA_BOX`, and
    the boxes across a row (:func:`row_boxes`).  Raises ValueError where
    no split takes the head dim, or where TMA cannot read the view in
    place (the wrappers take it as it is, never a copy): the feature dim
    not contiguous, or the base address or a byte stride not a positive
    multiple of 16."""
    b, t, h, d = (int(n) for n in shape)
    boxes = row_boxes(d)
    if boxes is None:
        raise ValueError(f"TMA rows are whole {TMA_BOX[0]}-feature boxes "
                         f"and at most one 16-feature box, got head_dim {d}")
    bad = _tma_refusals(shape, strides, element_size, data_ptr)
    if bad:
        raise ValueError("the Hopper attention kernels read q, k, v and dO "
                         "in place through TMA, which needs 16-byte aligned "
                         f"rows: {', '.join(bad)}; pass a contiguous tensor")
    return {"dims": (d, t, h, b), "byte_strides": _tma_strides(
        shape, strides, element_size), "box": TMA_BOX,
        "boxes_per_row": len(boxes), "boxes": boxes}


def _gqa_dims(q, k, v):
    """(h, hkv, group) after the shape and grouped-query checks."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Tq, H, D] and k/v both [B, Tk, Hkv, "
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(
            f"num query heads ({h}) must be a multiple of num KV heads "
            f"({hkv}) for grouped-query attention")
    return h, hkv, h // hkv


def _block_relevant(q_start, k_start, block_q, block_k, causal, offset,
                    window, sinks):
    """Does the key block at ``k_start`` meet the query block's causal /
    window band at all?  (The Pallas ``_block_relevant``.)"""
    if not causal:
        return True
    live = k_start <= q_start + block_q - 1 + offset
    if window is not None:
        band = k_start + block_k - 1 >= q_start + offset - (window - 1)
        if sinks:
            band = band or k_start < sinks
        live = live and band
    return live


def _band_mask(qs, qe, ks, ke, tk, causal, offset, window, sinks, device):
    """The attend mask of the tile of queries ``qs:qe`` and keys ``ks:ke``
    (the Pallas ``_band_mask``)."""
    qp = torch.arange(qs, qe, device=device)[:, None]
    kp = torch.arange(ks, ke, device=device)[None, :]
    mask = kp < tk
    if causal:
        mask = mask & (kp <= qp + offset)
        if window is not None:
            band = kp >= qp + offset - (window - 1)
            if sinks:
                band = band | (kp < sinks)
            mask = mask & band
    return mask


def _blocks(q, k, block_q, block_k):
    """The plain versions' layout: q as [B, Hkv, G, Tq, D], k as
    [B, Hkv, 1, Tk, D] (a group shares its KV head), and block sizes."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.permute(0, 2, 1, 3).reshape(b, hkv, h // hkv, tq, d)
    return qg, min(block_q, tq), min(block_k, tk)


def _kv(x):
    return x.permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, Tk, D]


def flash_attention_fwd_reference(q, k, v, *, causal=False, block_q=128,
                                  block_k=128, window=None, sinks=0):
    """The plain version of B1: ``(out [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] f32)``."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg, bq, bk = _blocks(q, k, block_q, block_k)
    kf, vf = _kv(k), _kv(v)
    offset = tk - tq
    outs, lses = [], []
    for qs in range(0, tq, bq):
        qe = min(qs + bq, tq)
        qb = qg[:, :, :, qs:qe].float()
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for ks in range(0, tk, bk):
            ke = min(ks + bk, tk)
            if not _block_relevant(qs, ks, bq, bk, causal, offset, window,
                                   sinks):
                continue
            s = scale * torch.matmul(qb, kf[:, :, :, ks:ke].float().transpose(-1, -2))
            mask = _band_mask(qs, qe, ks, ke, tk, causal, offset, window,
                              sinks, q.device)
            p, corr, m, l = online_softmax_update(s, m, l, mask=mask)
            vb = vf[:, :, :, ks:ke]
            acc = acc * corr[..., None] + torch.matmul(
                p.to(v.dtype).float(), vb.float())
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=3).reshape(b, h, tq, d).permute(0, 2, 1, 3)
    lse = torch.cat(lses, dim=3).reshape(b, h, tq)
    return out.contiguous(), lse


def _bwd_tile(qb, kb, vb, gb, lse_b, delta_b, mask, scale):
    """The shared dQ/dKV tile recompute: ``(p, ds)`` f32, p zeroed by the
    mask (not only by NEG_INF before the exp, which overflows when a
    row's LSE is ~ -1e30)."""
    s = scale * torch.matmul(qb.float(), kb.float().transpose(-1, -2))
    p = torch.exp(s - lse_b[..., None])
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    dp = torch.matmul(gb.float(), vb.float().transpose(-1, -2))
    return p, p * (dp - delta_b[..., None])


def flash_attention_dq_reference(q, k, v, do, lse, delta, *, causal=False,
                                 block_q=128, block_k=128, window=None,
                                 sinks=0):
    """The plain version of B2: dQ [B, Tq, H, D] in q's dtype.  ``lse``
    and ``delta`` are [B, H, Tq] f32."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg, bq, bk = _blocks(q, k, block_q, block_k)
    gg, _, _ = _blocks(do, k, block_q, block_k)
    kf, vf = _kv(k), _kv(v)
    lse_g, delta_g = lse.reshape(b, hkv, g, tq), delta.reshape(b, hkv, g, tq)
    offset = tk - tq
    dqs = []
    for qs in range(0, tq, bq):
        qe = min(qs + bq, tq)
        acc = torch.zeros(qg[:, :, :, qs:qe].shape, dtype=torch.float32,
                          device=q.device)
        for ks in range(0, tk, bk):
            ke = min(ks + bk, tk)
            if not _block_relevant(qs, ks, bq, bk, causal, offset, window,
                                   sinks):
                continue
            mask = _band_mask(qs, qe, ks, ke, tk, causal, offset, window,
                              sinks, q.device)
            kb = kf[:, :, :, ks:ke]
            _, ds = _bwd_tile(qg[:, :, :, qs:qe], kb, vf[:, :, :, ks:ke],
                              gg[:, :, :, qs:qe], lse_g[..., qs:qe],
                              delta_g[..., qs:qe], mask, scale)
            acc = acc + scale * torch.matmul(ds.to(k.dtype).float(), kb.float())
        dqs.append(acc.to(q.dtype))
    dq = torch.cat(dqs, dim=3).reshape(b, h, tq, d).permute(0, 2, 1, 3)
    return dq.contiguous()


def flash_attention_dkv_reference(q, k, v, do, lse, delta, *, causal=False,
                                  block_q=128, block_k=128, window=None,
                                  sinks=0):
    """The plain version of B3: ``(dk, dv)`` [B, Tk, Hkv, D] in k's and
    v's dtypes, each key block summed over its group's query heads and
    query blocks in the Pallas order (member-major)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg, bq, bk = _blocks(q, k, block_q, block_k)
    gg, _, _ = _blocks(do, k, block_q, block_k)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # [B, Hkv, Tk, D]
    lse_g, delta_g = lse.reshape(b, hkv, g, tq), delta.reshape(b, hkv, g, tq)
    offset = tk - tq
    dks, dvs = [], []
    for ks in range(0, tk, bk):
        ke = min(ks + bk, tk)
        kb, vb = kf[:, :, ks:ke], vf[:, :, ks:ke]
        dk = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for member in range(g):
            for qs in range(0, tq, bq):
                qe = min(qs + bq, tq)
                if not _block_relevant(qs, ks, bq, bk, causal, offset, window,
                                       sinks):
                    continue
                mask = _band_mask(qs, qe, ks, ke, tk, causal, offset, window,
                                  sinks, q.device)
                qb = qg[:, :, member, qs:qe]
                gb = gg[:, :, member, qs:qe]
                p, ds = _bwd_tile(qb, kb, vb, gb, lse_g[:, :, member, qs:qe],
                                  delta_g[:, :, member, qs:qe], mask, scale)
                dv = dv + torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                       gb.float())
                dk = dk + scale * torch.matmul(
                    ds.to(q.dtype).float().transpose(-1, -2), qb.float())
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3).contiguous()
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3).contiguous()
    return dk, dv


# ------------------------------------------------------------- the kernel

_lib = None


def _kernel():
    """The loaded kernel library, its entry point typed."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
            + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_design.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_design.restype = ctypes.c_int
        _lib = lib
    return _lib


def _address(x: torch.Tensor) -> int:
    return 0 if is_fake(x) else x.data_ptr()


def _reads_in_place(x: torch.Tensor, hopper: bool) -> bool:
    """Can a kernel of the Hopper design (``hopper``) or of the others
    read ``x`` through its strides?  Hopper: :func:`tma_geometry`'s test;
    the others: feature dim contiguous, 16-byte aligned rows."""
    if hopper:
        return not _tma_refusals(x.shape, x.stride(), x.element_size(),
                                 _address(x))
    step = 16 // x.element_size()
    return (x.stride(3) == 1 and all(s % step == 0 for s in x.stride()[:3])
            and _address(x) % 16 == 0)


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` if a kernel outside the Hopper design can read it through its
    strides, else a contiguous copy."""
    if _reads_in_place(x, False):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _hopper(kernel, x) -> bool:
    return kernel_design(kernel, x.dtype, x.shape[-1]) == DESIGNS[2]


def _readable(kernel, *xs):
    """The tensors ``kernel``'s design reads: each ``x`` itself where that
    design reads it in place (:func:`tma_geometry`'s test for the Hopper
    kernels, :func:`_kernel_view`'s for the others), else a contiguous
    copy, so a contiguous tensor is never copied.  B1's wrapper and the
    autograd backward pass their tensors through it (an expanded
    cotangent, a q view with a 136-byte head stride); the B2/B3 wrappers
    themselves refuse what TMA cannot read (:func:`_kernel_views`)."""
    hopper = _hopper(kernel, xs[0])
    return tuple(x if _reads_in_place(x, hopper)
                 else x.clone(memory_format=torch.contiguous_format)
                 for x in xs)


def _kernel_views(kernel, *xs):
    """The views ``kernel`` reads: on the Hopper kernels each as it is,
    checked by :func:`tma_geometry` (which raises), else
    :func:`_kernel_view`'s."""
    if not _hopper(kernel, xs[0]):
        return tuple(_kernel_view(x) for x in xs)
    for x in xs:
        tma_geometry(x.shape, x.stride(), x.element_size(), _address(x))
    return xs


def _check_kernel_inputs(*xs):
    q = xs[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{_HEAD_DIMS}, got {q.shape[-1]}")
    for x in xs:
        if x.dtype != q.dtype:
            raise TypeError(f"q, k, v (and dO) must share one dtype, got "
                            f"{q.dtype} and {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {x.device}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("batch x heads must be <= 65535 (the grid's y axis)")
    if q.shape[1] == 0 or xs[1].shape[1] == 0:
        raise ValueError("flash attention needs Tq >= 1 and Tk >= 1")


def _check_stats(q, lse, delta):
    """B2/B3 read the forward's row LSE and ``delta``, f32 [B, H, Tq]
    each: refused otherwise, before anything is launched (a kernel would
    read past them)."""
    b, tq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, h, tq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _launch(which, q, k, v, *, o=None, do=None, dq=None, dk=None, dv=None,
            lse, delta=None, causal, window, sinks, audit=None):
    """One kernel launch on the current stream; raises on a refused
    launch.  Every tensor is already on the device and kernel-readable.
    ``audit`` (four zeroed int64 counts) runs the bf16 B2/B3 kernel's
    rounding audit instead of the training kernel."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    views = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[
        s for x in views for s in (x.stride()[:3] if x is not None else (0, 0, 0))])

    def ptr(x):
        return None if x is None else ctypes.c_void_p(x.data_ptr())

    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            which, _DTYPES[q.dtype], d, ptr(q), ptr(k), ptr(v), ptr(o),
            ptr(do), ptr(dq), ptr(dk), ptr(dv), ptr(lse), ptr(delta), strides,
            b, tq, tk, h, hkv, int(causal), int(window or 0), int(sinks),
            1.0 / math.sqrt(d), ptr(audit), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        name = ("flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv")[which]
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def _dispatch(q, name):
    """True for the kernel's path (a CUDA tensor, or a fake one on any
    device), False for the plain version's (a CPU tensor)."""
    if q.device.type == "cuda" or is_fake(q):
        return True
    if q.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    return False


def flash_attention_fwd(q, k, v, *, causal=False, block_q=128, block_k=128,
                        window=None, sinks=0):
    """B1: ``(out [B, Tq, H, D], lse [B, H, Tq] f32)``.  The kernel on a
    CUDA tensor (reading :func:`_b1_views`), the plain version on a CPU
    one."""
    validate_window(causal, window, sinks)
    return _fwd(*_b1_views(q, k, v), causal=causal, block_q=block_q,
                block_k=block_k, window=window, sinks=sinks)


def _b1_views(q, k, v):
    """The q, k and v B1's kernel reads (:func:`_readable`), after the
    kernel's input checks; the caller's tensors on the CPU, where the
    plain version reads any layout."""
    _gqa_dims(q, k, v)
    if not _dispatch(q, "flash_attention_fwd"):
        return q, k, v
    _check_kernel_inputs(q, k, v)
    return _readable("fwd", q, k, v)


def _fwd(q, k, v, *, causal, block_q, block_k, window, sinks):
    """B1 on what :func:`_b1_views` returned: the launch, or the plain
    version on a CPU tensor."""
    if not _dispatch(q, "flash_attention_fwd"):
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k,
            window=window, sinks=sinks)
    b, tq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if not is_fake(q):  # else the shape-only branch
        _launch(_FWD, q, k, v, o=out, lse=lse, causal=causal,
                window=window, sinks=sinks)
        count(flash_attention_fwd)
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, *, causal=False, block_q=128,
                       block_k=128, window=None, sinks=0):
    """B2: dQ [B, Tq, H, D] from the saved LSE and ``delta`` [B, H, Tq]
    f32.  The kernel on a CUDA tensor, the plain version on a CPU one."""
    validate_window(causal, window, sinks)
    _gqa_dims(q, k, v)
    if not _dispatch(q, "flash_attention_dq"):
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, causal=causal, block_q=block_q,
            block_k=block_k, window=window, sinks=sinks)
    _check_kernel_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    q, k, v, do = _kernel_views("dq", q, k, v, do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if not is_fake(q):  # else the shape-only branch
        _launch(_DQ, q, k, v, do=do, dq=dq, lse=lse.contiguous(),
                delta=delta.contiguous(), causal=causal, window=window,
                sinks=sinks)
        count(flash_attention_dq)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal=False,
                        block_q=128, block_k=128, window=None, sinks=0):
    """B3: ``(dk, dv)`` [B, Tk, Hkv, D].  The kernel on a CUDA tensor,
    the plain version on a CPU one."""
    validate_window(causal, window, sinks)
    _gqa_dims(q, k, v)
    if not _dispatch(q, "flash_attention_dkv"):
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, causal=causal, block_q=block_q,
            block_k=block_k, window=window, sinks=sinks)
    _check_kernel_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    q, k, v, do = _kernel_views("dkv", q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if not is_fake(q):  # else the shape-only branch
        _launch(_DKV, q, k, v, do=do, dk=dk, dv=dv, lse=lse.contiguous(),
                delta=delta.contiguous(), causal=causal, window=window,
                sinks=sinks)
        count(flash_attention_dkv)
    return dk, dv


#: what :func:`rounding_audit` counts, in the kernels' order (AuditCount)
AUDIT_COUNTS = ("flagged", "flagged_changed", "unflagged_differ", "live_pairs")


def rounding_audit(q, k, v, do, lse, delta, *, causal=False, window=None,
                   sinks=0):
    """The bf16 B2 and B3 kernels' rounding audit on the card: each runs
    its audit instantiation, which sums every live pair again in the
    plain version's order.  Returns ``{"dq": counts, "dkv": counts}``,
    each a dict over :data:`AUDIT_COUNTS`: pairs flagged for re-summing,
    flagged pairs whose bf16 rounding of ds (and, in B3, of p) the
    re-sum changed, unflagged pairs whose rounding differs from the plain
    order's (the flag's misses), and live pairs.  The launches are not
    counted: this is a measurement, not the training path."""
    validate_window(causal, window, sinks)
    _gqa_dims(q, k, v)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("rounding_audit runs the bf16 kernels on a CUDA "
                         f"device, got {q.dtype} on {q.device}")
    _check_kernel_inputs(q, k, v, do)
    q, k, v, do = _kernel_views("dq", q, k, v, do)
    lse, delta = lse.contiguous(), delta.contiguous()
    cfg = dict(causal=causal, window=window, sinks=sinks)
    out = {}
    for name, which, outs in (
            ("dq", _DQ, dict(dq=torch.empty_like(q))),
            ("dkv", _DKV, dict(dk=torch.empty_like(k), dv=torch.empty_like(v)))):
        counts = torch.zeros(len(AUDIT_COUNTS), dtype=torch.int64,
                             device=q.device)
        _launch(which, q, k, v, do=do, lse=lse, delta=delta, audit=counts,
                **outs, **cfg)
        out[name] = dict(zip(AUDIT_COUNTS, counts.tolist()))
    return out


#: kernel launches since the last reset (plain ints; the CPU path and the
#: plain versions never count)
flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


def _backward(q, k, v, o, lse, g, g_lse, cfg):
    """``_flash_bwd_impl``: delta in f32 outside the kernels (the LSE
    cotangent folded in as ``delta - g_lse``), then B2 and B3 on the
    tensors their design reads (:func:`_readable`: autograd's cotangent
    may be expanded, with strides of 0)."""
    delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, Tq]
    if g_lse is not None:
        # d lse_r / d s_rc = p_rc, so ds = p (dP - delta + g_lse)
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    if _dispatch(q, "flash_attention"):
        q, k, v, g = _readable("dq", q, k, v, g)
    dq = flash_attention_dq(q, k, v, g, lse, delta, **cfg)
    dk, dv = flash_attention_dkv(q, k, v, g, lse, delta, **cfg)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``'s custom VJP (``_fwd``/``_bwd``).  The
    backward takes the q, k and v that B1 read (:func:`_b1_views`)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        q, k, v = _b1_views(q, k, v)
        out, lse = _fwd(q, k, v, **cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, g, None, ctx.cfg)
        return dq, dk, dv, None


class _FlashAttentionLse(torch.autograd.Function):
    """``flash_attention_lse``'s custom VJP (``_fwd_lse``/``_bwd_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        q, k, v = _b1_views(q, k, v)
        out, lse = _fwd(q, k, v, **cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = cfg
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(o)
        dq, dk, dv = _backward(q, k, v, o, lse, g_out, g_lse, ctx.cfg)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 128,
                    block_k: int = 128, window: Optional[int] = None,
                    sinks: int = 0) -> torch.Tensor:
    """Fused flash attention, [B, T, H, D] → [B, T, H, D], differentiable.

    Grouped-query K/V ([B, Tk, Hkv, D], Hkv dividing H) are read through
    the group map, never repeated.  Causal masking is end-aligned (query
    i sits at position ``i + Tk - Tq``).  ``window`` (causal only) keeps
    each query's ``window`` newest keys, and ``sinks`` (with a window)
    the first ``sinks`` positions; key blocks outside the band are
    skipped.  Rows with nothing attendable give 0, with finite
    gradients.  The Hopper kernels on CUDA tensors, their plain versions
    on CPU tensors.
    """
    validate_window(causal, window, sinks)
    cfg = dict(causal=causal, block_q=block_q, block_k=block_k,
               window=window, sinks=sinks)
    return _FlashAttention.apply(q, k, v, cfg)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, block_q: int = 128,
                        block_k: int = 128, window: Optional[int] = None):
    """Flash attention that also returns the per-row logsumexp:
    ``(out [B, Tq, H, D], lse [B, H, Tq] f32)`` with
    ``lse = log sum_k exp(q . k^T / sqrt(D))``.  Both outputs are
    differentiable; the LSE cotangent folds into the same backward
    kernels.  Rows with nothing attendable have ``lse ~ -1e30``."""
    validate_window(causal, window, 0)
    cfg = dict(causal=causal, block_q=block_q, block_k=block_k,
               window=window, sinks=0)
    return _FlashAttentionLse.apply(q, k, v, cfg)
