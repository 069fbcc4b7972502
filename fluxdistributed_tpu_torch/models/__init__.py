"""The port's models: the decoder-only LM, its training loss and its
decode caches."""

from .from_jax import flax_to_state_dict, load_flax_params
from .transformer_lm import (KV_QUANTS, VALID_UNGATED, DecodeCache,
                             PagedCache, TransformerLM, dequantize_kv,
                             generate, lm_loss_fn, lm_medium, lm_small,
                             lm_tiny, make_decode_cache, make_paged_cache,
                             next_token_loss, quantize_kv, rope)

__all__ = [
    "KV_QUANTS", "VALID_UNGATED", "DecodeCache", "PagedCache",
    "TransformerLM", "dequantize_kv", "flax_to_state_dict", "generate",
    "lm_loss_fn", "lm_medium", "lm_small", "lm_tiny", "load_flax_params",
    "make_decode_cache", "make_paged_cache", "next_token_loss",
    "quantize_kv", "rope",
]
