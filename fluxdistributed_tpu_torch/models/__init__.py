"""The port's models: the decoder-only LM, its training loss and its
decode caches; the ResNet family and the small image models, with the
BatchNorm that returns its running stats."""

from .common import maybe_remat
from .from_jax import (flax_to_state_dict, load_flax_params,
                       load_flax_resnet, load_flax_simple)
from .norm import BatchNorm, BatchStats
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, s2d_stem_kernel,
                     space_to_depth)
from .simple import MLP, SimpleCNN
from .transformer_lm import (KV_QUANTS, VALID_UNGATED, DecodeCache,
                             PagedCache, TransformerLM, dequantize_kv,
                             generate, lm_loss_fn, lm_medium, lm_small,
                             lm_tiny, make_decode_cache, make_paged_cache,
                             next_token_loss, quantize_kv, rope)

__all__ = [
    "KV_QUANTS", "MLP", "VALID_UNGATED", "BasicBlock", "BatchNorm",
    "BatchStats", "BottleneckBlock", "DecodeCache", "PagedCache", "ResNet",
    "SimpleCNN", "TransformerLM", "dequantize_kv", "flax_to_state_dict",
    "generate", "lm_loss_fn", "lm_medium", "lm_small", "lm_tiny",
    "load_flax_params", "load_flax_resnet", "load_flax_simple",
    "make_decode_cache", "make_paged_cache", "maybe_remat",
    "next_token_loss", "quantize_kv", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "rope", "s2d_stem_kernel", "space_to_depth",
]
