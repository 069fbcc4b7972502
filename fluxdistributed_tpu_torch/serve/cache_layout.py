"""Cache-layout sizing for the serving engine: the dense fixed-slot
layout and the KV byte model.

Copied from the JAX package's ``serve/cache_layout.py`` (pure host
code).  The paged layout (``PagedLayout``/``BlockPool``) belongs to the
paged-serving slice and is not here yet.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["DenseLayout", "KV_STORE_BYTES", "kv_row_bytes",
           "reserved_kv_bytes"]


#: bytes per stored K or V element under each quant scenario (None =
#: the model's compute itemsize); quantized scenarios additionally
#: carry a per-row-per-head f32 scale (``models.transformer_lm
#: .quantize_kv``)
KV_STORE_BYTES = {"none": None, "int8": 1, "fp8": 1}


def kv_row_bytes(hkv: int, head_dim: int, kv_quant: str,
                 compute_itemsize: int) -> int:
    """HBM bytes one cache row (K + V, all KV heads) costs per layer:
    stored values plus the sibling scale rows for quantized scenarios —
    the sizing model behind the engine's measured ``kv_cache_bytes``
    (the bytes-halved test pins the two against each other)."""
    if kv_quant not in KV_STORE_BYTES:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r} ({'|'.join(KV_STORE_BYTES)})")
    item = KV_STORE_BYTES[kv_quant] or compute_itemsize
    per = hkv * head_dim * item
    if KV_STORE_BYTES[kv_quant]:
        per += hkv * 4  # f32 scale per row per head
    return 2 * per  # K and V


def reserved_kv_bytes(layout, depth: int, hkv: int, head_dim: int,
                      compute_itemsize: int) -> int:
    """Total HBM bytes a layout's KV storage reserves across ``depth``
    layers — THE sizing model.  ``layout.reserved_rows()`` supplies the
    per-layer row count each layout actually allocates (dense: every
    slot's rows; paged: the whole block pool, shared), and
    :func:`kv_row_bytes` prices one row including the quantization
    scale leaves.  The engine's MEASURED ``kv_cache_bytes()`` is
    cross-checked against this figure (its ``predicted`` key; parity
    pinned by test in both layouts for every kv_quant scenario) so the
    accounting the fit checker and the benches report can never drift
    from the math admission control sizes pools with."""
    return depth * layout.reserved_rows() * kv_row_bytes(
        hkv, head_dim, layout.kv_quant, compute_itemsize)


class DenseLayout:
    """The original fixed-slot layout: each slot statically owns
    ``rows_per_slot`` contiguous KV rows per layer.  Admission never
    waits on memory — capacity IS ``max_slots`` — so the allocator
    surface is trivially permissive.  ``kv_quant`` records the storage
    scenario riding in the device cache (scale leaves live NEXT TO their
    K/V rows, same indexing) so stats and sizing math stay layout-aware.
    """

    name = "dense"

    def __init__(self, max_slots: int, rows_per_slot: int,
                 kv_quant: str = "none"):
        self.max_slots = max_slots
        self.rows_per_slot = rows_per_slot
        self.kv_quant = kv_quant

    def can_admit(self, prompt: Sequence[int], max_new_tokens: int) -> bool:
        return True

    def reserved_rows(self) -> int:
        """KV rows allocated per layer: every slot statically owns its
        full span for the engine's lifetime."""
        return self.max_slots * self.rows_per_slot

    def stats(self) -> dict:
        return {"kv_quant": self.kv_quant}
