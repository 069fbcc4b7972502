"""Attention ops and the hand-written decode kernel (dense and paged)."""

from .attention import NEG_INF, dot_product_attention, online_softmax_update
from .flash_decode import (flash_decode, flash_decode_paged,
                           flash_decode_paged_reference,
                           flash_decode_reference)

__all__ = ["NEG_INF", "dot_product_attention", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_reference",
           "flash_decode_reference", "online_softmax_update"]
