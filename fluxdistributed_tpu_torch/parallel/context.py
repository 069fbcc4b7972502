"""Context (sequence) parallelism: ring attention and Ulysses.

Port of ``fluxdistributed_tpu/parallel/context.py``.  A sequence is cut
over a ``seq`` mesh axis: the rank at seq index ``s`` of ``S`` holds
positions ``[s T/S, (s + 1) T/S)`` of its data rows, and attention runs
without ever gathering the whole sequence on one rank.  The JAX
functions run inside ``shard_map`` on the local shards; these run in
every rank of a :class:`..mesh.Mesh` on its blocks ``[B/D, T/S, H, D]``
and write the exchanges out (:mod:`.collectives`):

* **Ring attention** (:func:`ring_attention`): each rank keeps its Q
  block and passes K/V blocks around the ring (a ``batch_isend_irecv``
  to the next rank of the axis a hop), folding each arriving block into
  the online-softmax accumulator (``ops.attention.attn_block_update``)
  with causal masks by global position.  :func:`ring_flash_attention`
  computes each hop with the flash kernels' LSE entry
  (``ops.flash_attention_lse``, B1 forward, B2/B3 backward with the LSE
  cotangent) and merges hops by their log-sum-exps.  Grouped K/V ride
  the ring at their ``hkv`` heads.  Each hop's exchange is posted before
  the hop's compute and waited for after it.
* **Ulysses** (:func:`ulysses_attention`): two ``all_to_all`` exchanges
  re-shard [sequence-sharded, all heads] to [whole sequence, H/S heads]
  and back; attention between them is the dense core on whole
  sequences.  Needs ``num_heads % S == 0``.

``make_ring_attention`` / ``make_ulysses_attention`` return an
``attn_fn`` for ``models.TransformerLM(attn_fn=...)``: a callable on this
rank's blocks that carries its ``mesh``, ``seq_axis``, ``batch_axis``
and ``strategy``, which the LM's loss and ``prepare_training(spmd="sp")``
read to run the whole model on this rank's positions.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..mesh import SEQ_AXIS, Mesh
from ..ops.attention import (NEG_INF, _expand_kv, _scale, attn_block_update,
                             attn_finalize, attn_init, dot_product_attention)
from .collectives import all_to_all, ring_shift_start

__all__ = [
    "SequenceParallelAttention",
    "make_ring_attention",
    "make_ulysses_attention",
    "ring_attention",
    "ring_flash_attention",
    "ring_flash_hops",
    "ulysses_attention",
]


def _ring_blocks(k: torch.Tensor, v: torch.Tensor, mesh: Mesh, axis: str,
                 last_shift: bool):
    """The K/V blocks in their arrival order on this rank: its own, then
    those of ranks ``my - 1``, ``my - 2``, ... (mod S).  Each hop's
    exchange is posted before the block is handed out and waited for
    when the next is asked for, so the transfer overlaps the hop's
    compute.  ``last_shift`` makes the last hop exchange too (the XLA
    ring's wasted rotation, kept as JAX runs it)."""
    n = mesh.axis_size(axis)
    cur = (k, v)
    for i in range(n):
        handle = (ring_shift_start(list(cur), mesh, axis)
                  if i + 1 < n or last_shift else None)
        yield cur
        if handle is not None:
            cur = handle.wait()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str = SEQ_AXIS, *,
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over the sequence shards of ``axis_name``, as the
    JAX XLA walk computes it: ``q``/``k``/``v`` are this rank's blocks
    [B, T/S, H(kv), D]; returns this rank's output block.  Causal masks
    use global positions (shard ``i`` owns ``[i T/S, (i + 1) T/S)``)."""
    n, my = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    t = q.shape[1]
    q_scaled = _scale(q)
    q_pos = my * t + torch.arange(t, device=q.device)
    carry = attn_init(q)
    blocks = _ring_blocks(k, v, mesh, axis_name, last_shift=True)
    for i, (k_cur, v_cur) in enumerate(blocks):
        mask = None
        if causal:
            k_pos = ((my - i) % n) * t + torch.arange(t, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
        k_blk, v_blk = _expand_kv(q_scaled, k_cur, v_cur)
        carry = attn_block_update(carry, q_scaled, k_blk, v_blk, mask=mask)
    return attn_finalize(carry, q.dtype)


def ring_flash_hops(q: torch.Tensor, blocks: Iterable, my_idx: int, *,
                    causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """The hops of :func:`ring_flash_attention` over K/V ``blocks`` given
    in arrival order (block ``i`` is the one of seq rank ``my_idx - i``
    mod S): each hop is ``flash_attention_lse`` (causal inside the kernel
    on hop 0, this rank's diagonal block), and hops merge by their f32
    log-sum-exps::

        lse' = logaddexp(lse, lse_i)
        o'   = o exp(lse - lse') + o_i exp(lse_i - lse')

    with a weight of 0 where an LSE is ``NEG_INF`` (a row with nothing
    attendable so far).  Under ``causal`` a hop ``i > 0`` whose block
    lies after this rank's queries (``my_idx < i``) is computed, then
    weighted 0, as the JAX ring does (the FLOPs of every rank match).
    The distributed ring feeds it received blocks; a single process can
    feed it a list (``chip_smoke.py`` does)."""
    from ..ops.flash_attention import flash_attention_lse

    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), NEG_INF,
                     dtype=torch.float32, device=q.device)
    for i, (k_cur, v_cur) in enumerate(blocks):
        o_i, lse_i = flash_attention_lse(q, k_cur, v_cur, causal and i == 0,
                                         block_q, block_k)
        if causal and i > 0 and my_idx < i:
            # the block of a later rank: every key is after every query
            lse_i = torch.full_like(lse_i, NEG_INF)
        lse_new = torch.logaddexp(lse, lse_i)
        w_prev = torch.where(lse == NEG_INF, 0.0, torch.exp(lse - lse_new))
        w_i = torch.where(lse_i == NEG_INF, 0.0, torch.exp(lse_i - lse_new))
        o = (o * w_prev.transpose(1, 2)[..., None]
             + o_i.float() * w_i.transpose(1, 2)[..., None])
        lse = lse_new
    return o.to(q.dtype)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh, axis_name: str = SEQ_AXIS, *,
                         causal: bool = False, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """Ring attention with the flash kernels as each hop's compute (see
    :func:`ring_flash_hops`), on this rank's blocks.  The last hop sends
    nothing on."""
    blocks = _ring_blocks(k, v, mesh, axis_name, last_shift=False)
    return ring_flash_hops(q, blocks, mesh.axis_index(axis_name),
                           causal=causal, block_q=block_q, block_k=block_k)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis_name: str = SEQ_AXIS, *,
                      causal: bool = False) -> torch.Tensor:
    """Ulysses sequence parallelism on this rank's blocks [B, T/S, H, D]:
    an ``all_to_all`` re-shards heads for sequence, the dense core
    attends whole sequences for H/S heads, and a second ``all_to_all``
    re-shards back.  Needs H divisible by the axis size.  Grouped K/V
    ride the exchange at ``hkv`` heads when ``hkv`` divides over the
    axis, and are expanded to H heads before it otherwise."""
    n = mesh.axis_size(axis_name)
    if q.shape[2] % n != 0:
        # a real error: without it the head re-shard fails later with an
        # obscure shape mismatch
        raise ValueError(
            f"ulysses_attention needs num_heads ({q.shape[2]}) divisible by "
            f"the '{axis_name}' axis size ({n}): the all_to_all "
            "re-shards heads across the axis in equal chunks. Use a seq "
            "axis that divides the head count, or ring attention "
            "(make_ring_attention), which has no head-count constraint.")
    if k.shape[2] != q.shape[2] and k.shape[2] % n != 0:
        k, v = _expand_kv(q, k, v)
    # [B, T/S, H, D] -> [B, T, H/S, D]
    qg, kg, vg = (all_to_all(x, mesh, axis_name, 2, 1) for x in (q, k, v))
    out = dot_product_attention(qg, kg, vg, causal=causal)
    # [B, T, H/S, D] -> [B, T/S, H, D]
    return all_to_all(out, mesh, axis_name, 1, 2)


class SequenceParallelAttention:
    """An ``attn_fn(q, k, v)`` on this rank's sequence blocks, with what
    the model and the trainer need to know about it: ``mesh``,
    ``seq_axis``, ``batch_axis``, ``strategy`` (``"ring"`` or
    ``"ulysses"``), ``impl`` (the ring's ``"xla"`` or ``"flash"``) and
    ``causal``."""

    def __init__(self, mesh: Mesh, seq_axis: str, batch_axis: Optional[str],
                 causal: bool, strategy: str, impl: Optional[str] = None,
                 block_q: int = 128, block_k: int = 128):
        for ax in (seq_axis,) + ((batch_axis,) if batch_axis else ()):
            if ax not in mesh.shape:
                raise ValueError(f"axis {ax!r} is not on the mesh "
                                 f"{mesh.shape}")
        self.mesh, self.seq_axis, self.batch_axis = mesh, seq_axis, batch_axis
        self.causal, self.strategy, self.impl = causal, strategy, impl
        self.block_q, self.block_k = block_q, block_k

    def __call__(self, q, k, v):
        if self.strategy == "ulysses":
            return ulysses_attention(q, k, v, self.mesh, self.seq_axis,
                                     causal=self.causal)
        if self.impl == "flash":
            return ring_flash_attention(
                q, k, v, self.mesh, self.seq_axis, causal=self.causal,
                block_q=self.block_q, block_k=self.block_k)
        return ring_attention(q, k, v, self.mesh, self.seq_axis,
                              causal=self.causal)


def make_ring_attention(mesh: Mesh, seq_axis: str = SEQ_AXIS,
                        batch_axis: Optional[str] = None,
                        causal: bool = False, impl: str = "xla",
                        block_q: int = 128,
                        block_k: int = 128) -> SequenceParallelAttention:
    """Ring attention as an ``attn_fn`` on this rank's blocks (the JAX
    ``shard_map`` wrapper's counterpart): ``impl="flash"`` runs each hop
    through the flash kernels (:func:`ring_flash_attention`), ``"xla"``
    the blockwise online-softmax walk (:func:`ring_attention`).  The
    batch rows are this rank's rows of ``batch_axis`` (the model under
    ``prepare_training(spmd="sp")`` gets them so)."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
    return SequenceParallelAttention(mesh, seq_axis, batch_axis, causal,
                                     "ring", impl, block_q, block_k)


def make_ulysses_attention(mesh: Mesh, seq_axis: str = SEQ_AXIS,
                           batch_axis: Optional[str] = None,
                           causal: bool = False
                           ) -> SequenceParallelAttention:
    """Ulysses as an ``attn_fn`` on this rank's blocks (see
    :func:`make_ring_attention`)."""
    return SequenceParallelAttention(mesh, seq_axis, batch_axis, causal,
                                     "ulysses")
