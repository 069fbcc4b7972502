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
(``csrc/flash_attention.cu`` says why).  :func:`rounding_audit` counts,
on the card, how often that flag fires and whether it missed a pair.

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

from .attention import (NEG_INF, online_softmax_update,
                        validate_window)
from .counts import count

__all__ = [
    "TILE_K",
    "TILE_Q",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dkv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "flash_attention_lse",
    "rounding_audit",
]

# dtype codes and kernel ids shared with csrc/flash_attention.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DQ, _DKV = 0, 1, 2
_HEAD_DIMS = (32, 64, 80, 128)
#: the kernels' tiles: query rows and key rows (``kTile`` in the source);
#: a tile outside the causal / window band is skipped whole
TILE_Q = TILE_K = 64


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
        _lib = lib
    return _lib


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernel can read it through its strides (feature dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    step = 16 // x.element_size()
    if (x.stride(3) == 1 and all(s % step == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0):
        return x
    return x.clone(memory_format=torch.contiguous_format)


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
    if q.device.type == "cuda":
        return True
    if q.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    return False


def flash_attention_fwd(q, k, v, *, causal=False, block_q=128, block_k=128,
                        window=None, sinks=0):
    """B1: ``(out [B, Tq, H, D], lse [B, H, Tq] f32)``.  The kernel on a
    CUDA tensor, :func:`flash_attention_fwd_reference` on a CPU one."""
    validate_window(causal, window, sinks)
    _gqa_dims(q, k, v)
    if not _dispatch(q, "flash_attention_fwd"):
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k,
            window=window, sinks=sinks)
    _check_kernel_inputs(q, k, v)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    b, tq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch(_FWD, q, k, v, o=out, lse=lse, causal=causal, window=window,
            sinks=sinks)
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
    q, k, v, do = (_kernel_view(x) for x in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
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
    q, k, v, do = (_kernel_view(x) for x in (q, k, v, do))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
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
    q, k, v, do = (_kernel_view(x) for x in (q, k, v, do))
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
    cotangent folded in as ``delta - g_lse``), then B2 and B3."""
    delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, Tq]
    if g_lse is not None:
        # d lse_r / d s_rc = p_rc, so ds = p (dP - delta + g_lse)
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    dq = flash_attention_dq(q, k, v, g, lse, delta, **cfg)
    dk, dv = flash_attention_dkv(q, k, v, g, lse, delta, **cfg)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``'s custom VJP (``_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        out, lse = flash_attention_fwd(q, k, v, **cfg)
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
        out, lse = flash_attention_fwd(q, k, v, **cfg)
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
