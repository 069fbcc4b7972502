"""Attention primitives: the semantic oracle and the prefill core.

Port of ``fluxdistributed_tpu/ops/attention.py``.  Every function takes
``q, k, v`` shaped ``[batch, seq, heads, head_dim]`` (the JAX layout)
and accumulates softmax statistics in float32 whatever the input dtype.
``dot_product_attention`` is written in plain torch ops, like the JAX
XLA version: it serves prefill, where the whole prompt attends at once.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "dot_product_attention", "online_softmax_update"]

NEG_INF = -1e30


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
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if sinks and window is None:
        raise ValueError("sinks only make sense with a window")
    k, v = _expand_kv(q, k, v)
    # scale in q's dtype, then contract in f32 (preferred_element_type)
    qs = q / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32)).to(q.dtype)
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
