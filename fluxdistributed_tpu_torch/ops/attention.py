"""Attention primitives: the semantic oracle, the blockwise walk and the
``--attn`` core names.

Port of ``fluxdistributed_tpu/ops/attention.py``.  Every function takes
``q, k, v`` shaped ``[batch, seq, heads, head_dim]`` (the JAX layout)
and accumulates softmax statistics in float32 whatever the input dtype.
``dot_product_attention`` and ``blockwise_attention`` are written in
plain torch ops, like the JAX XLA versions; :func:`attention_core`
resolves ``dense|blockwise|flash`` to a causal core, where ``flash`` is
the hand-written training kernel pair (:mod:`.flash_attention`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

__all__ = [
    "NEG_INF",
    "AttnCarry",
    "attention_core",
    "attn_block_update",
    "attn_finalize",
    "attn_init",
    "blockwise_attention",
    "dot_product_attention",
    "online_softmax_update",
    "validate_window",
]

NEG_INF = -1e30


def validate_window(causal: bool, window: Optional[int], sinks: int) -> None:
    """The sliding-window rules every attention core and kernel shares:
    a window needs causal masking and at least one key; sinks are >= 0
    and need a window."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is a causal-LM construct)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sinks:
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0, got {sinks}")
        if window is None:
            raise ValueError("sinks only make sense with a window "
                             "(unwindowed causal attention already "
                             "attends every past position)")


def _scale(q: torch.Tensor) -> torch.Tensor:
    """``q`` divided by sqrt(head_dim), the divisor rounded to q's dtype
    first (the JAX ``_scale``)."""
    return q / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32)).to(
        q.dtype)


def _expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Broadcast grouped KV heads up to the query head count (GQA)."""
    h, hkv = q.shape[2], k.shape[2]
    if h == hkv:
        return k, v
    if h % hkv:
        raise ValueError(
            f"num query heads ({h}) must be a multiple of num KV heads ({hkv})")
    rep = h // hkv
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    sinks: int = 0,
) -> torch.Tensor:
    """Reference softmax attention.

    ``q``: [B, Tq, H, D]; ``k``/``v``: [B, Tk, Hkv, D] with Hkv dividing
    H → [B, Tq, H, D].  ``mask``: optional boolean broadcastable to
    [B, H, Tq, Tk] (True = attend).  Causal masking aligns the ends
    (query i sits at position ``i + Tk - Tq``); ``window`` keeps each
    query's ``window`` newest keys plus the first ``sinks`` positions.
    Scores and softmax in f32; probabilities are rounded to v's dtype
    before P·V (as the JAX version does); output in q's dtype.  Rows
    with nothing attendable return exactly 0.
    """
    validate_window(causal, window, sinks)
    k, v = _expand_kv(q, k, v)
    # scale in q's dtype, then contract in f32 (preferred_element_type)
    qs = _scale(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    tq, tk = s.shape[-2], s.shape[-1]
    allow = None
    if causal:
        ar = torch.arange(tk, device=q.device)
        idx_q = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        allow = ar[None, :] <= idx_q
        if window is not None:
            in_band = ar[None, :] >= idx_q - (window - 1)
            if sinks:
                in_band = in_band | (ar[None, :] < sinks)
            allow = allow & in_band
        allow = allow[None, None]
    if mask is not None:
        allow = mask if allow is None else allow & mask
    if allow is not None:
        s = torch.where(allow, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    p = torch.softmax(s, dim=-1)
    if allow is not None:
        # softmax over an all-NEG_INF row is uniform; zero it so fully
        # masked rows output 0, matching the online-softmax paths
        p = torch.where(allow, p, torch.zeros((), dtype=p.dtype,
                                              device=p.device))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def online_softmax_update(s, m_prev, l_prev, mask=None):
    """The online-softmax statistics update: the shared numerics of the
    block walks.

    ``s``: [..., q, k] f32 scores (pre-scaled).  ``m_prev``/``l_prev``:
    [..., q].  ``mask``: optional [..., q, k] boolean, True = attend.
    Returns ``(p, corr, m_new, l_new)``: ``p`` is the un-normalised block
    softmax (zero at masked positions, so rows masked everywhere keep
    ``l == 0`` and finalise to 0) and ``corr`` rescales the caller's
    output accumulator.
    """
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    corr = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        # for a row masked in EVERY position so far m_new is still
        # NEG_INF and exp(s - m_new) = exp(0) = 1: zero explicitly
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                             device=p.device))
    l_new = l_prev * corr + p.sum(dim=-1)
    return p, corr, m_new, l_new


class AttnCarry(NamedTuple):
    """Online-softmax accumulator state for the blockwise walk.

    ``o`` [B, Tq, H, D] f32: un-normalised output accumulator; ``m``
    [B, H, Tq] f32: running row max of the scores; ``l`` [B, H, Tq] f32:
    running sum of exp(scores - m).
    """

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def attn_init(q: torch.Tensor) -> AttnCarry:
    b, tq, h, d = q.shape
    return AttnCarry(
        o=torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device),
        m=torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                     device=q.device),
        l=torch.zeros((b, h, tq), dtype=torch.float32, device=q.device))


def attn_block_update(carry: AttnCarry, q_scaled: torch.Tensor,
                      k_blk: torch.Tensor, v_blk: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None) -> AttnCarry:
    """Fold one KV block into the accumulator.  ``q_scaled`` is already
    divided by sqrt(head_dim); ``mask`` [Tq, Tk_blk] boolean, True =
    attend.  P·V runs in f32 (p is not rounded), as the JAX walk does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_scaled.float(), k_blk.float())
    p, corr, m_new, l_new = online_softmax_update(
        s, carry.m, carry.l, mask=None if mask is None else mask[None, None])
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    o_new = carry.o * corr.permute(0, 2, 1)[..., None] + pv
    return AttnCarry(o=o_new, m=m_new, l=l_new)


def attn_finalize(carry: AttnCarry, dtype: torch.dtype) -> torch.Tensor:
    """Normalise the accumulator into the output (rows with nothing
    attendable give 0, not NaN)."""
    l = torch.clamp(carry.l, min=1e-30)
    return (carry.o / l.permute(0, 2, 1)[..., None]).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_size: int = 512, causal: bool = False,
                        window: Optional[int] = None,
                        sinks: int = 0) -> torch.Tensor:
    """Flash-style attention as a loop over KV blocks: never holds the
    [Tq, Tk] scores of the whole sequence, with
    ``dot_product_attention``'s numerics.  Grouped-query KV is
    broadcast to the query head count; a ragged last block is padded
    and masked.  ``window`` (causal only) masks keys older than each
    query's ``window`` newest, plus the first ``sinks``; every block is
    still visited.  Differentiable through autograd of the loop."""
    validate_window(causal, window, sinks)
    k, v = _expand_kv(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    block_size = min(block_size, tk)
    pad = -tk % block_size  # pad (masked) rather than fall back to one block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_scaled = _scale(q)
    q_pos = torch.arange(tq, device=q.device) + (tk - tq)
    carry = attn_init(q)
    for j in range(0, tk + pad, block_size):
        k_pos = j + torch.arange(block_size, device=q.device)
        mask = (k_pos[None, :] < tk).expand(tq, block_size)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                in_band = k_pos[None, :] >= q_pos[:, None] - (window - 1)
                if sinks:
                    in_band = in_band | (k_pos[None, :] < sinks)
                mask = mask & in_band
        elif not pad:
            mask = None
        carry = attn_block_update(carry, q_scaled, k[:, j:j + block_size],
                                  v[:, j:j + block_size], mask=mask)
    return attn_finalize(carry, q.dtype)


def attention_core(kind: str, block: int = 128, window: Optional[int] = None,
                   sinks: int = 0):
    """Resolve an ``--attn`` core name to a causal ``attn_fn(q, k, v)``.

    ``"dense"`` → None without a window (the model's built-in core),
    else a windowed dense core; ``"blockwise"`` → the KV-block walk;
    ``"flash"`` → the fused training kernels (:func:`.flash_attention
    .flash_attention`), which refuse single-query decode-shaped input:
    that is the decode kernels' work.
    """
    validate_window(True, window, sinks)
    if kind == "dense":
        if window is None:
            return None
        return partial(dot_product_attention, causal=True, window=window,
                       sinks=sinks)
    if block <= 0:
        raise ValueError(f"attention block size must be > 0, got {block}")
    if kind == "blockwise":
        return partial(blockwise_attention, block_size=block, causal=True,
                       window=window, sinks=sinks)
    if kind == "flash":
        from .flash_attention import flash_attention

        def _flash(q, k, v):
            # the training kernel amortises its tiles over many query
            # rows; a single-query call would run it at its worst shape
            if q.shape[1] == 1 and k.shape[1] > 1:
                raise ValueError(
                    "attention_core(kind='flash') is the training/prefill "
                    "kernel; single-query decode-shaped inputs (Tq=1 vs a "
                    f"Tk={k.shape[1]} cache) belong to the flash-decode "
                    "kernels (ops.flash_decode.flash_decode[_paged])")
            return flash_attention(q, k, v, True, block, block, window,
                                   sinks)

        return _flash
    raise ValueError(f"unknown attention core {kind!r}")
