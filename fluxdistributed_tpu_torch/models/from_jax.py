"""Carry weights from the JAX package's flax ``TransformerLM`` across.

``load_flax_params(model, params)`` takes the flax param tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; nothing of
JAX is needed here) and fills the port's :class:`TransformerLM` in
place.  The mapping, flax → port:

* ``embed/embedding`` [V, d] → ``embed.weight``;
* ``pos_embedding`` [L, d] → ``pos_embedding`` (learned positions);
* ``block{i}/LayerNorm_{0,1}`` (or ``RMSNorm_{0,1}``) ``scale``/``bias``
  → ``blocks.{i}.ln{1,2}``;
* ``block{i}/CausalSelfAttention_0/qkv`` kernel [d, 3, H, Dh] →
  ``attn.qkv`` (or ``q`` [d, H, Dh] and ``kv`` [d, 2, Hkv, Dh] under
  GQA); ``out`` kernel [H, Dh, d] → ``attn.out``;
* ``Dense_{0,1}`` → ``fc1``/``fc2``, or ``gate``/``up``/``down``;
* ``final_ln`` → ``final_ln``; ``head`` → ``head`` (untied embeddings).

A flax kernel [in..., out...] becomes a torch ``Linear`` weight
[out, in] after flattening.  Every port parameter must be filled and
every flax leaf used; anything else raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer_lm import TransformerLM

__all__ = ["load_flax_params", "flax_to_state_dict"]


def _dense(kernel, in_dims: int):
    """flax kernel with ``in_dims`` leading input axes → [out, in]."""
    k = np.asarray(kernel)
    n_in = int(np.prod(k.shape[:in_dims]))
    return k.reshape(n_in, -1).T


def _linear(out: Dict[str, np.ndarray], prefix: str, p: dict, in_dims=1):
    out[prefix + ".weight"] = _dense(p["kernel"], in_dims)
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"]).reshape(-1)


def _norm(out, prefix: str, p: dict):
    out[prefix + ".weight"] = np.asarray(p["scale"])
    if "bias" in p:
        out[prefix + ".bias"] = np.asarray(p["bias"])


def flax_to_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` names for a flax ``TransformerLM`` tree."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name == "embed":
            out["embed.weight"] = np.asarray(sub["embedding"])
        elif name == "pos_embedding":
            out["pos_embedding"] = np.asarray(sub)
        elif name == "final_ln":
            _norm(out, "final_ln", sub)
        elif name == "head":
            _linear(out, "head", sub)
        elif name.startswith("block"):
            pre = f"blocks.{int(name[len('block'):])}"
            for child, p in sub.items():
                if child in ("LayerNorm_0", "RMSNorm_0"):
                    _norm(out, pre + ".ln1", p)
                elif child in ("LayerNorm_1", "RMSNorm_1"):
                    _norm(out, pre + ".ln2", p)
                elif child == "CausalSelfAttention_0":
                    for proj, pp in p.items():
                        if proj not in ("qkv", "q", "kv", "out"):
                            raise KeyError(f"unknown attention param "
                                           f"{name}/{child}/{proj}")
                        # out contracts over (H, Dh); the rest over d
                        _linear(out, f"{pre}.attn.{proj}", pp,
                                in_dims=2 if proj == "out" else 1)
                elif child in ("Dense_0", "Dense_1"):
                    _linear(out, pre + (".fc1" if child == "Dense_0"
                                        else ".fc2"), p)
                elif child in ("gate", "up", "down"):
                    _linear(out, f"{pre}.{child}", p)
                else:
                    raise KeyError(f"unknown flax param {name}/{child}")
        else:
            raise KeyError(f"unknown flax param {name}")
    return out


@torch.no_grad()
def load_flax_params(model: TransformerLM, params: dict) -> TransformerLM:
    """Fill ``model`` with the flax ``params`` tree (numpy leaves).
    Shapes must match exactly; returns ``model``."""
    sd = flax_to_state_dict(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for name, arr in sd.items():
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: flax shape {tuple(arr.shape)} != "
                             f"port shape {tuple(p.shape)}")
        p.copy_(torch.tensor(np.asarray(arr, np.float32)))
    return model
