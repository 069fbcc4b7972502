"""HuggingFace GPT-2 weights in the port's LM: the GPT-2 half of the
JAX package's ``models/torch_import.py``.

GPT-2 is the port's :class:`.transformer_lm.TransformerLM` with learned
positions (``use_rope=False``), tied embeddings, pre-norm LayerNorms of
epsilon 1e-5 and the tanh GELU.  A ``GPT2LMHeadModel`` ``state_dict``
(``transformer.h.{i}...``, or a bare ``GPT2Model``'s ``h.{i}...``) maps
onto the port's parameter names:

* HF's ``Conv1D`` stores its weight as ``[in, out]``; ``nn.Linear``
  holds ``[out, in]``, so every projection is transposed;
* ``c_attn`` packs ``[q | k | v]`` on its output dim, each head-major,
  which is the row order of the port's fused ``qkv`` (``[3, H, D]``);
* the learned position table ``wpe`` is sliced to ``seqlen``;
* the head is the embedding (tied); ``lm_head.weight`` is not read.

The head count is not in the weights: the GPT-2 family's convention is
``dim // 64``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .transformer_lm import TransformerLM

__all__ = ["gpt2_config", "gpt2_model", "import_gpt2"]


def _prefix(state_dict: Mapping[str, Any]) -> str:
    pre = "transformer." if "transformer.wte.weight" in state_dict else ""
    if f"{pre}wte.weight" not in state_dict:
        raise ValueError("not a GPT-2 state_dict (no wte.weight)")
    return pre


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to(torch.float32)


def gpt2_config(state_dict: Mapping[str, Any]) -> dict:
    """A GPT-2 checkpoint's architecture from its weights alone:
    ``{vocab, dim, depth, mlp_dim, n_positions}``."""
    pre = _prefix(state_dict)
    vocab, d = _t(state_dict[f"{pre}wte.weight"]).shape
    depth = 0
    while f"{pre}h.{depth}.ln_1.weight" in state_dict:
        depth += 1
    if depth == 0:
        raise ValueError("no transformer blocks found — not a GPT-2 "
                         "state_dict")
    return {"vocab": int(vocab), "dim": int(d), "depth": depth,
            "mlp_dim": int(_t(state_dict[f"{pre}h.0.mlp.c_fc.weight"])
                           .shape[1]),
            "n_positions": int(_t(state_dict[f"{pre}wpe.weight"]).shape[0])}


def import_gpt2(state_dict: Mapping[str, Any], num_heads: int,
                seqlen: Optional[int] = None) -> Tuple[dict, dict]:
    """``(params, model_state)`` for a :class:`TransformerLM` built as
    :func:`gpt2_model` builds it: ``params`` maps the port's parameter
    names to float32 tensors; ``model_state`` is ``{}``.  ``seqlen``
    slices the position table (default: the whole table)."""
    pre = _prefix(state_dict)
    sd = {k: _t(v) for k, v in state_dict.items()}
    wte, wpe = sd[f"{pre}wte.weight"], sd[f"{pre}wpe.weight"]
    d = wte.shape[1]
    if d % num_heads:
        raise ValueError(f"embed dim {d} not divisible by num_heads "
                         f"{num_heads}")
    if seqlen is not None:
        if seqlen > wpe.shape[0]:
            raise ValueError(
                f"seqlen {seqlen} exceeds the checkpoint's positional "
                f"table ({wpe.shape[0]})")
        wpe = wpe[:seqlen]
    params = {"embed.weight": wte, "pos_embedding": wpe.contiguous(),
              "final_ln.weight": sd[f"{pre}ln_f.weight"],
              "final_ln.bias": sd[f"{pre}ln_f.bias"]}
    i = 0
    while f"{pre}h.{i}.ln_1.weight" in sd:
        t, b = f"{pre}h.{i}", f"blocks.{i}"
        for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2")):
            params[f"{b}.{ours}.weight"] = sd[f"{t}.{theirs}.weight"]
            params[f"{b}.{ours}.bias"] = sd[f"{t}.{theirs}.bias"]
        for ours, theirs in (("attn.qkv", "attn.c_attn"),
                             ("attn.out", "attn.c_proj"),
                             ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj")):
            # Conv1D [in, out] -> nn.Linear [out, in]
            params[f"{b}.{ours}.weight"] = (
                sd[f"{t}.{theirs}.weight"].t().contiguous())
            params[f"{b}.{ours}.bias"] = sd[f"{t}.{theirs}.bias"]
        i += 1
    if i == 0:
        raise ValueError("no transformer blocks found — not a GPT-2 "
                         "state_dict")
    return params, {}


def gpt2_model(state_dict: Mapping[str, Any], *,
               num_heads: Optional[int] = None,
               seqlen: Optional[int] = None,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> TransformerLM:
    """The GPT-2 of ``state_dict`` as a port :class:`TransformerLM` on
    ``device`` (``num_heads`` defaults to ``dim // 64``; ``seqlen``, the
    position table's length, to the checkpoint's)."""
    cfg = gpt2_config(state_dict)
    heads = num_heads or max(cfg["dim"] // 64, 1)
    seqlen = seqlen or cfg["n_positions"]
    params, _ = import_gpt2(state_dict, heads, seqlen)
    with torch.device("meta"):
        model = TransformerLM(
            vocab=cfg["vocab"], depth=cfg["depth"], dim=cfg["dim"],
            num_heads=heads, mlp_dim=cfg["mlp_dim"], dtype=dtype,
            use_rope=False, tie_embeddings=True, norm_eps=1e-5,
            max_len=seqlen, device="meta")
    model.load_state_dict(params, assign=True)
    return model.to(resolve_device(device))
