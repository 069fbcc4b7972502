"""Attention ops and the hand-written decode kernel."""

from .attention import NEG_INF, dot_product_attention, online_softmax_update
from .flash_decode import flash_decode, flash_decode_reference

__all__ = ["NEG_INF", "dot_product_attention", "flash_decode",
           "flash_decode_reference", "online_softmax_update"]
