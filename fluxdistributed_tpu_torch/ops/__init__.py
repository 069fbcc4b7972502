"""Attention ops and the hand-written kernels: flash decode (dense and
paged) for serving, flash attention (forward and backward) for
training, and the fused Adam update for ZeRO-1; the losses and the
top-k metrics of image training."""

from .attention import (NEG_INF, AttnCarry, attention_core,
                        attn_block_update, attn_finalize, attn_init,
                        blockwise_attention, dot_product_attention,
                        online_softmax_update, validate_window)
from .flash_attention import (flash_attention, flash_attention_dkv,
                              flash_attention_dkv_reference,
                              flash_attention_dq,
                              flash_attention_dq_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference,
                              flash_attention_lse)
from .flash_decode import (flash_decode, flash_decode_paged,
                           flash_decode_paged_reference,
                           flash_decode_reference)
from .fused_adam import fused_adam, fused_adam_plain
from .losses import crossentropy, logitcrossentropy, mse
from .metrics import onehot, showpreds, topkaccuracy

__all__ = ["NEG_INF", "AttnCarry", "attention_core", "attn_block_update",
           "attn_finalize", "attn_init", "blockwise_attention", "crossentropy",
           "dot_product_attention", "flash_attention", "flash_attention_dkv",
           "flash_attention_dkv_reference", "flash_attention_dq",
           "flash_attention_dq_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_lse",
           "flash_decode", "flash_decode_paged",
           "flash_decode_paged_reference", "flash_decode_reference",
           "fused_adam", "fused_adam_plain", "logitcrossentropy", "mse",
           "onehot", "online_softmax_update", "showpreds", "topkaccuracy",
           "validate_window"]
