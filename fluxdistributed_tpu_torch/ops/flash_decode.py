"""Flash decode: one query row per slot against the KV cache.

Port of ``fluxdistributed_tpu/ops/pallas_decode.py:flash_decode`` and
``flash_decode_paged`` (the dense and paged forms of the Pallas
``_decode_kernel``).  Each is two versions of one function:

* on a CUDA tensor, the hand-written Hopper kernel
  ``csrc/flash_decode.cu`` (built by :mod:`._build`, bound with
  ``ctypes``); it launches or raises, never falls back;
* on a CPU tensor, the plain PyTorch version
  (:func:`flash_decode_reference`, :func:`flash_decode_paged_reference`):
  the JAX package's ``_xla_block_walk`` schedule (f32 online softmax
  over row blocks, dead blocks skipped).

Both kernels are split-KV: each slot's rows are cut into contiguous
runs, each run's partial softmax state is computed on its own, and the
partials are merged in run order.  The dense kernel cuts each slot's
live rows (up to its cursor, read on the device) into
:func:`decode_splits` runs of whole tiles of :func:`decode_tile_rows`
rows; the paged kernel cuts the page table into :func:`paged_splits`
runs of whole pages.  :func:`flash_decode_split` and
:func:`flash_decode_paged_split` are the plain versions of those
schedules (the tests hold them to the oracles,
:func:`flash_decode_reference` and :func:`flash_decode_paged_reference`).

All keep the probabilities in f32 through P·V, as the XLA walk does.
(The Pallas body instead rounds p to v's dtype, so on a bf16 cache the
two JAX impls differ by bf16 rounding of p; the port follows the XLA
walk on both devices.)  ``flash_decode.launches`` and
``flash_decode_paged.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .attention import NEG_INF, online_softmax_update, validate_window
from .counts import count

__all__ = ["decode_splits", "decode_tile_rows", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_reference",
           "flash_decode_paged_split", "flash_decode_reference",
           "flash_decode_split", "paged_splits", "split_pages",
           "split_tiles"]

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
    validate_window(True, window, sinks)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized decode needs BOTH k_scale and v_scale")


def _check_q(q, hkv, idx):
    """q is [B, 1, H, D] with H a multiple of ``hkv``; idx is [B]."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(
            f"flash decode takes one query row per slot: q must be "
            f"[B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, _ = q.shape
    if h % hkv:
        raise ValueError(
            f"num query heads ({h}) must be a multiple of num KV heads "
            f"({hkv}) for grouped-query attention")
    if idx.shape != (b,):
        raise ValueError(f"idx must be [B] = [{b}], got {tuple(idx.shape)}")


def _check_shapes(q, k, v, idx, slot_pos, k_scale):
    b, d = q.shape[0], q.shape[-1]
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v must both be [B, R, Hkv, D] = [{b}, R, Hkv, {d}], got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    _check_q(q, k.shape[2], idx)
    if slot_pos is not None and slot_pos.shape != k.shape[:2]:
        raise ValueError(f"slot_pos must be [B, R] = {tuple(k.shape[:2])}, "
                         f"got {tuple(slot_pos.shape)}")
    if k_scale is not None and k_scale.shape != k.shape[:3]:
        raise ValueError(f"k_scale/v_scale must be [B, R, Hkv] = "
                         f"{tuple(k.shape[:3])}, got {tuple(k_scale.shape)}")


def _check_paged_shapes(q, k_pool, v_pool, page_table, idx, slot_pos,
                        k_scale):
    b, d = q.shape[0], q.shape[-1]
    if (k_pool.ndim != 4 or k_pool.shape != v_pool.shape
            or k_pool.shape[3] != d):
        raise ValueError(
            f"k_pool/v_pool must both be [NB, bs, Hkv, D] with D = {d}, got "
            f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _check_q(q, k_pool.shape[2], idx)
    if (page_table.ndim != 2 or page_table.shape[0] != b
            or page_table.dtype != torch.int32):
        raise ValueError(f"page_table must be [B, P] = [{b}, P] int32, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    rows = page_table.shape[1] * k_pool.shape[1]
    if slot_pos is not None and slot_pos.shape != (b, rows):
        raise ValueError(f"slot_pos must be [B, P*bs] = [{b}, {rows}], got "
                         f"{tuple(slot_pos.shape)}")
    if k_scale is not None and k_scale.shape != k_pool.shape[:3]:
        raise ValueError(f"k_scale/v_scale must be [NB, bs, Hkv] = "
                         f"{tuple(k_pool.shape[:3])}, got "
                         f"{tuple(k_scale.shape)}")


def _dequant(x, scale):
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def _walk_state(q, hkv, blocks, get_mask, get_block):
    """The loop of the JAX package's ``_xla_block_walk``: f32 online
    softmax over the row blocks ``blocks``.  ``get_mask(j)`` [B, rows]
    says which rows of block ``j`` each slot attends; a block no slot
    attends is skipped before ``get_block(j)`` (its K/V, [B, rows, Hkv,
    D] f32) is touched.  Returns the state ``(m, l, acc)``, each
    [B, Hkv, G(, D)] f32."""
    b, _, h, d = q.shape
    g = h // hkv
    q4 = q[:, 0].reshape(b, hkv, g, d).float() * (1.0 / math.sqrt(d))
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    for j in blocks:
        allow = get_mask(j)
        if not bool(allow.any()):
            continue  # dead block: no K/V touched
        kb, vb = get_block(j)
        s = torch.einsum("bhgd,bkhd->bhgk", q4, kb)
        p, corr, m, l = online_softmax_update(s, m, l,
                                              mask=allow[:, None, None, :])
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
    return m, l, acc


def _finish(q, acc, l):
    b, _, h, d = q.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _block_walk(q, hkv, nblocks, get_mask, get_block):
    """The JAX package's ``_xla_block_walk`` over blocks ``0 ..
    nblocks - 1`` (:func:`_walk_state`), normalised."""
    _, l, acc = _walk_state(q, hkv, range(nblocks), get_mask, get_block)
    return _finish(q, acc, l)


def _ring_mask(sp, idx, window, sinks):
    """Ring rows attendable from cursor ``idx``: written, causal, in band
    or a sink.  ``sp`` [B, rows] global positions (-1 = unwritten)."""
    sp, qg = sp.to(torch.int64), idx[:, None]
    band = sp > qg - window
    if sinks:
        band = band | (sp < sinks)
    return (sp >= 0) & (sp <= qg) & band


def _dense_walkers(q, k, v, idx, slot_pos, window, sinks, k_scale, v_scale,
                   block_k):
    """``(get_mask, get_block)`` of the dense walk, ``block_k`` rows a
    block (the last may be shorter)."""
    r = k.shape[1]
    idx = idx.to(torch.int64)

    def get_mask(j):
        j0, j1 = j * block_k, min((j + 1) * block_k, r)
        if window is None:
            pos = torch.arange(j0, j1, device=q.device)
            return pos[None, :] <= idx[:, None]
        return _ring_mask(slot_pos[:, j0:j1], idx, window, sinks)

    def get_block(j):
        rows = slice(j * block_k, min((j + 1) * block_k, r))
        return (_dequant(k[:, rows], None if k_scale is None else k_scale[:, rows]),
                _dequant(v[:, rows], None if v_scale is None else v_scale[:, rows]))

    return get_mask, get_block


def flash_decode_reference(q, k, v, idx, *, slot_pos=None, window=None,
                           sinks=0, k_scale=None, v_scale=None,
                           block_k: int = 128):
    """The plain PyTorch version: ``_xla_block_walk`` with the dense
    cursor or windowed-ring mask.  Same contract as :func:`flash_decode`."""
    r = k.shape[1]
    block_k = min(block_k, r)
    get_mask, get_block = _dense_walkers(q, k, v, idx, slot_pos, window,
                                         sinks, k_scale, v_scale, block_k)
    return _block_walk(q, k.shape[2], -(-r // block_k), get_mask, get_block)


def _take(pool, blk):
    """``pool[blk]``; fp8 moves its bytes (not every indexing op is
    defined for it)."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[blk].view(pool.dtype)
    return pool[blk]


def flash_decode_paged_reference(q, k_pool, v_pool, page_table, idx, *,
                                 slot_pos=None, window=None, sinks=0,
                                 k_scale=None, v_scale=None):
    """The plain PyTorch version of :func:`flash_decode_paged`: the
    ``_xla_block_walk`` over the page table, one page per block.  Rows on
    an unbound page (-1) are masked and never gathered."""
    hkv = k_pool.shape[2]
    get_mask, get_block = _page_walkers(q, k_pool, v_pool, page_table, idx,
                                        slot_pos, window, sinks, k_scale,
                                        v_scale)
    return _block_walk(q, hkv, page_table.shape[1], get_mask, get_block)


def _page_walkers(q, k_pool, v_pool, page_table, idx, slot_pos, window,
                  sinks, k_scale, v_scale):
    """``(get_mask, get_block)`` of the paged walk, one page per block."""
    b = q.shape[0]
    bs, hkv, d = k_pool.shape[1:]
    pt = page_table.to(torch.int64)
    idx = idx.to(torch.int64)

    def get_mask(j):
        if window is None:
            pos = torch.arange(j * bs, (j + 1) * bs, device=q.device)
            allow = pos[None, :] <= idx[:, None]
        else:
            allow = _ring_mask(slot_pos[:, j * bs:(j + 1) * bs], idx, window,
                               sinks)
        return allow & (pt[:, j] >= 0)[:, None]

    def get_block(j):
        rows = torch.nonzero(pt[:, j] >= 0).flatten()
        blk = pt[rows, j]
        kb = torch.zeros((b, bs, hkv, d), dtype=torch.float32, device=q.device)
        vb = torch.zeros_like(kb)
        kb[rows] = _dequant(_take(k_pool, blk),
                            None if k_scale is None else k_scale[blk])
        vb[rows] = _dequant(_take(v_pool, blk),
                            None if v_scale is None else v_scale[blk])
        return kb, vb

    return get_mask, get_block


#: CTAs per SM that the kernels' split counts aim at
_CTAS_PER_SM = 4


def decode_tile_rows(d: int) -> int:
    """Rows a tile of the dense kernel (``csrc/flash_decode.cu:
    tile_rows``): a tile of K in f32 is about 16 KB whatever the head dim
    ``d`` is."""
    return 64 if d <= 64 else (32 if d <= 128 else 16)


def decode_splits(batch: int, hkv: int, rows: int, sms: int,
                  head_dim: int) -> int:
    """The dense kernel's split count: enough runs that ``batch * hkv *
    splits`` CTAs give each of ``sms`` SMs about four, but no more runs
    than the ``rows`` of the cache hold tiles of
    ``decode_tile_rows(head_dim)`` rows.  Depends on the cache and the
    card, never on the cursors, so the grid is fixed on the host."""
    want = -(-_CTAS_PER_SM * sms // max(batch * hkv, 1))
    tiles = -(-rows // decode_tile_rows(head_dim))
    return max(1, min(tiles, want))


def split_tiles(tiles: int, splits: int):
    """The dense kernel's runs of one slot: its ``tiles`` live tiles cut
    into ``splits`` runs of ``ceil(tiles / splits)`` whole tiles,
    ``[(t0, t1), ...]`` in split order; the last runs may be short or
    empty (``t0 == t1``)."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    per = -(-tiles // splits)
    return [(min(s * per, tiles), min((s + 1) * per, tiles))
            for s in range(splits)]


def paged_splits(batch: int, hkv: int, pages: int, sms: int) -> int:
    """The paged kernel's split count: enough runs of whole pages that
    ``batch * hkv * splits`` CTAs give each of ``sms`` SMs about four
    (at least two waves), but no more runs than pages.  Depends on the
    page count and the card, never on the cursors, because the grid is
    fixed on the host."""
    want = -(-_CTAS_PER_SM * sms // max(batch * hkv, 1))
    return max(1, min(pages, want))


def split_pages(pages: int, splits: int):
    """``(runs, pages_per_run)``: ``pages`` cut into runs of
    ``ceil(pages / splits)`` whole pages, the last possibly shorter and
    none empty (so ``runs <= splits``)."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    per = -(-pages // min(splits, pages))
    return -(-pages // per), per


def _merge_splits(parts):
    """Merge the split partials ``[(m, l, acc), ...]`` in split order, as
    the paged kernel's combine does: ``M = max m_s``, ``w_s = exp(m_s -
    M)``, ``l = sum l_s w_s``, ``acc = sum acc_s w_s``; returns ``(l,
    acc)``.  A slot with nothing attendable keeps ``l = 0``, ``acc =
    0``."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    l = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        w = torch.exp(m - big_m)
        l = l + ls * w
        acc = acc + a * w[..., None]
    return l, acc


def flash_decode_split(q, k, v, idx, *, splits, slot_pos=None, window=None,
                       sinks=0, k_scale=None, v_scale=None):
    """The plain version of the dense kernel's split-KV schedule: each
    slot's live rows (up to its cursor; all R rows of a windowed ring)
    in tiles of :func:`decode_tile_rows` rows, cut into ``splits`` runs
    of whole tiles (:func:`split_tiles`), the ``_xla_block_walk`` state
    of each run taken on its own, and the runs merged in split order, as
    the kernel's combine merges them.  Same contract as
    :func:`flash_decode`."""
    r, hkv, d = k.shape[1:]
    tile = decode_tile_rows(d)
    outs = []
    for b in range(q.shape[0]):
        one = slice(b, b + 1)

        def mine(x):
            return None if x is None else x[one]

        get_mask, get_block = _dense_walkers(
            q[one], k[one], v[one], idx[one], mine(slot_pos), window, sinks,
            mine(k_scale), mine(v_scale), tile)
        rows = r if window is not None else min(max(int(idx[b]) + 1, 0), r)
        parts = [_walk_state(q[one], hkv, range(t0, t1), get_mask, get_block)
                 for t0, t1 in split_tiles(-(-rows // tile), splits)]
        l, acc = _merge_splits(parts)
        outs.append(_finish(q[one], acc, l))
    return torch.cat(outs)


def flash_decode_paged_split(q, k_pool, v_pool, page_table, idx, *, splits,
                             slot_pos=None, window=None, sinks=0,
                             k_scale=None, v_scale=None):
    """The plain version of the paged kernel's split-KV schedule: the
    page table cut into runs of whole pages (:func:`split_pages`), the
    ``_xla_block_walk`` state of each run taken on its own, and the
    partials merged in run order, as the kernel's combine merges them.
    Same contract as :func:`flash_decode_paged`."""
    pages = page_table.shape[1]
    _, per = split_pages(pages, splits)
    get_mask, get_block = _page_walkers(q, k_pool, v_pool, page_table, idx,
                                        slot_pos, window, sinks, k_scale,
                                        v_scale)
    parts = [_walk_state(q, k_pool.shape[2], range(p0, min(p0 + per, pages)),
                         get_mask, get_block)
             for p0 in range(0, pages, per)]
    l, acc = _merge_splits(parts)
    return _finish(q, acc, l)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


_lib = None


def _kernel():
    """The loaded kernel library, its two entry points typed."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("flash_decode")
        lib.flash_decode_launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p])
        lib.flash_decode_paged_launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p])
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_paged_launch.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k, v, idx, slot_pos, k_scale, v_scale,
                         extra=()):
    """What the kernel takes: dtypes, head dim, device, contiguity and
    alignment.  Raises before anything is built or launched."""
    d = q.shape[-1]
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
    for t in (q, k, v, idx, slot_pos, k_scale, v_scale, *extra):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash_decode kernel needs contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError("flash_decode kernel needs 16-byte aligned inputs")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _kernel().flash_decode_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


_SMS = {}


def _sm_count(device) -> int:
    """The SM count of ``device``, asked of the CUDA runtime once: the
    decode step calls the wrappers once a layer, and host time sets its
    pace."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _workspace(q, splits):
    """The split partials (m, l, acc[D]) of every (slot, query head),
    from the caching allocator on the current stream."""
    b, _, h, d = q.shape
    return torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)


def _launch(q, k, v, idx, slot_pos, window, sinks, k_scale, v_scale,
            splits=None):
    """The dense kernel on ``splits`` runs of tiles a slot (default:
    :func:`decode_splits` of the card's SM count; the card-only tests
    force other counts)."""
    _check_kernel_inputs(q, k, v, idx, slot_pos, k_scale, v_scale)
    b, _, h, d = q.shape
    r, hkv = k.shape[1], k.shape[2]
    if splits is None:
        splits = decode_splits(b, hkv, r, _sm_count(q.device), d)
    elif splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    out = torch.empty_like(q)
    work = _workspace(q, splits)
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(
            _Q_CODES[q.dtype], _KV_CODES[k.dtype], int(window is not None),
            _ptr(q), _ptr(k), _ptr(v), _ptr(idx), _ptr(slot_pos),
            _ptr(k_scale), _ptr(v_scale), _ptr(out), b, r, h, hkv, d,
            int(window or 0), int(sinks), 1.0 / math.sqrt(d), splits,
            _ptr(work), ctypes.c_void_p(stream))
    _raise_on(err, "flash_decode")
    count(flash_decode)  # one call, two CUDA launches
    return out


def _launch_paged(q, k_pool, v_pool, page_table, idx, slot_pos, window,
                  sinks, k_scale, v_scale, splits=None):
    """The paged kernel on ``splits`` runs of pages (default: from the
    card's SM count; the card-only tests force other counts)."""
    _check_kernel_inputs(q, k_pool, v_pool, idx, slot_pos, k_scale, v_scale,
                         extra=(page_table,))
    b, _, h, d = q.shape
    nb, bs, hkv = k_pool.shape[:3]
    pages = page_table.shape[1]
    if splits is None:
        splits = paged_splits(b, hkv, pages, _sm_count(q.device))
    runs, per = split_pages(pages, splits)
    out = torch.empty_like(q)
    work = _workspace(q, runs)
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_decode_paged_launch(
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], int(window is not None),
            _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(page_table), _ptr(idx),
            _ptr(slot_pos), _ptr(k_scale), _ptr(v_scale), _ptr(out),
            b, pages, bs, nb, h, hkv, d, int(window or 0), int(sinks),
            1.0 / math.sqrt(d), runs, per, _ptr(work),
            ctypes.c_void_p(stream))
    _raise_on(err, "flash_decode_paged")
    count(flash_decode_paged)  # one call, two CUDA launches
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

    On a CUDA tensor this launches the Hopper kernel, split-KV over runs
    of whole tiles (:func:`decode_splits` of the card's SM count; its
    tile size is its own, :func:`decode_tile_rows`, and ``block_k`` sets
    the plain version's block rows); on a CPU tensor it runs
    :func:`flash_decode_reference`.
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


def flash_decode_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    idx: torch.Tensor,
    *,
    slot_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash decode over the paged block pool.

    ``q`` [B, 1, H, D]; ``k_pool``/``v_pool`` [NB, bs, Hkv, D] (the
    shared per-layer pools AFTER this step's write); ``page_table``
    [B, P] int32 (logical row ``r`` of slot ``b`` lives at block
    ``page_table[b, r // bs]``, offset ``r % bs``; -1 = unbound: masked,
    never read); ``idx`` [B] int32 cursors.  Windowed rings pass
    ``slot_pos`` [B, P*bs] (+ ``window``/``sinks``); quantized pools
    pass ``k_scale``/``v_scale`` [NB, bs, Hkv] f32.  → [B, 1, H, D] in
    q's dtype; slots with nothing attendable return exactly 0.

    On a CUDA tensor this launches the Hopper kernel, split-KV over runs
    of whole pages (:func:`paged_splits` of the card's SM count); on a
    CPU tensor it runs :func:`flash_decode_paged_reference`.
    """
    _validate(window, sinks, slot_pos, k_scale, v_scale)
    _check_paged_shapes(q, k_pool, v_pool, page_table, idx, slot_pos, k_scale)
    if q.device.type == "cuda":
        return _launch_paged(q, k_pool, v_pool, page_table, idx, slot_pos,
                             window, sinks, k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode_paged runs on cuda or cpu, got "
                         f"{q.device}")
    return flash_decode_paged_reference(
        q, k_pool, v_pool, page_table, idx, slot_pos=slot_pos, window=window,
        sinks=sinks, k_scale=k_scale, v_scale=v_scale)


#: kernel launches since the last reset (plain int; the CPU path and the
#: plain version never count)
flash_decode_paged.launches = 0
