"""The port's models: the decoder-only LM and its decode cache."""

from .from_jax import load_flax_params
from .transformer_lm import (KV_QUANTS, VALID_UNGATED, DecodeCache,
                             TransformerLM, dequantize_kv, generate,
                             lm_medium, lm_small, lm_tiny, make_decode_cache,
                             quantize_kv, rope)

__all__ = [
    "KV_QUANTS", "VALID_UNGATED", "DecodeCache", "TransformerLM",
    "dequantize_kv", "generate", "lm_medium", "lm_small", "lm_tiny",
    "load_flax_params", "make_decode_cache", "quantize_kv", "rope",
]
