"""The port's models: the decoder-only LM (with its MoE blocks), its
training loss and its decode caches; the ResNet family and the small image models, with the
BatchNorm that returns its running stats; the ViT and ConvNeXt
families."""

from .common import LayerNorm, maybe_remat
from .convnext import (ConvNeXt, ConvNeXtBlock, convnext_base,
                       convnext_large, convnext_small, convnext_test,
                       convnext_tiny, convnext_xlarge)
from .from_jax import (flax_split_to_state_dict, flax_to_state_dict,
                       flax_vit_to_state_dict,
                       load_flax_convnext, load_flax_params, load_flax_resnet,
                       load_flax_simple, load_flax_vit)
from .norm import BatchNorm, BatchStats
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, s2d_stem_kernel,
                     space_to_depth)
from .simple import MLP, SimpleCNN
from .transformer_lm import (KV_QUANTS, VALID_UNGATED, DecodeCache,
                             LMPipelineWiring, MoEDecoderBlock, PagedCache,
                             TransformerLM, dequantize_kv, generate,
                             lm_loss_fn, lm_medium, lm_moe_specs, lm_pp,
                             lm_pp_1f1b, lm_small, lm_tiny,
                             make_decode_cache, make_paged_cache,
                             moe_expert_fn, next_token_loss, quantize_kv,
                             rope)
from .vit import (EncoderBlock, MlpBlock, MultiHeadAttention, ViT, vit_b16,
                  vit_h14, vit_l16, vit_tiny)

__all__ = [
    "KV_QUANTS", "MLP", "VALID_UNGATED", "BasicBlock", "BatchNorm",
    "BatchStats", "BottleneckBlock", "ConvNeXt", "ConvNeXtBlock",
    "DecodeCache", "EncoderBlock", "LMPipelineWiring", "LayerNorm",
    "MlpBlock",
    "MoEDecoderBlock", "MultiHeadAttention", "PagedCache", "ResNet", "SimpleCNN",
    "TransformerLM", "ViT", "convnext_base", "convnext_large",
    "convnext_small", "convnext_test", "convnext_tiny", "convnext_xlarge",
    "dequantize_kv", "flax_split_to_state_dict", "flax_to_state_dict",
    "flax_vit_to_state_dict",
    "generate", "lm_loss_fn",
    "lm_medium", "lm_moe_specs", "lm_pp", "lm_pp_1f1b", "lm_small",
    "lm_tiny",
    "load_flax_convnext", "load_flax_params", "load_flax_resnet",
    "load_flax_simple", "load_flax_vit", "make_decode_cache",
    "make_paged_cache", "maybe_remat", "moe_expert_fn",
    "next_token_loss", "quantize_kv", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "rope", "s2d_stem_kernel", "space_to_depth",
    "vit_b16", "vit_h14", "vit_l16", "vit_tiny",
]
