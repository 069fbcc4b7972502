"""Carry weights from the JAX package's flax models across: the
``TransformerLM``, the ResNets and the small image models.

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
* ``final_ln`` → ``final_ln``; ``head`` → ``head`` (untied embeddings);
* an MoE block's ``router`` [d, E] and stacked experts ``w1`` [E, d, m],
  ``b1`` [E, m], ``w2`` [E, m, d], ``b2`` [E, d] → the same names under
  ``blocks.{i}``, as they are (the port keeps the flax layouts);
  ``flax_to_state_dict(params, experts=(r, S))`` keeps the block of
  experts ``[r E/S, (r + 1) E/S)`` that the rank at expert index ``r``
  of ``S`` holds.

``flax_split_to_state_dict(split)`` maps a pipelined LM's JAX split
tree ``{"outer": ..., "stages": ...}`` (``lm_pp``'s ``split_params``;
each stage leaf stacked ``(S, ...)`` or ``(S, V, ...)``) onto the port's
flat split tree: ``outer/<name>`` for the outer leaves and
``stages/<name>`` for one block's leaves under the port's names, stacked
the same way.

A flax kernel [in..., out...] becomes a torch ``Linear`` weight
[out, in] after flattening.  Every port parameter must be filled and
every flax leaf used; anything else raises.

``load_flax_vit(model, params)`` fills a port :class:`.vit.ViT` (either
token readout) and ``load_flax_convnext(model, params)`` a
:class:`.convnext.ConvNeXt`, under torchvision's and the official
ConvNeXt names: the ViT's ``qkv`` kernel [D, 3, H, Dh] becomes
``in_proj_weight`` [3D, D] (rows q, k, v), its ``out`` kernel
[H, Dh, D] ``out_proj.weight`` [D, D], ``cls_token`` / ``pos_embed``
``class_token`` / ``encoder.pos_embedding``; the ConvNeXt's
``layer_scale`` becomes ``gamma`` and the depthwise kernel [7, 7, 1, C]
``[C, 1, 7, 7]``.  (The JAX package's ``import_torch_vit`` and
``import_torch_convnext`` are the inverses.)

``load_flax_resnet(model, params, batch_stats)`` fills a port ResNet
(and its BatchNorm running stats) from a flax ResNet's ``params`` and
``batch_stats`` trees; ``load_flax_simple`` a ``SimpleCNN`` or ``MLP``.
A flax conv kernel ``[kh, kw, in, out]`` becomes ``[out, in, kh, kw]``,
a dense kernel ``[in, out]`` becomes ``[out, in]``, a BatchNorm's
``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
``running_mean``/``running_var``, and the flax scopes take
torchvision's names: ``stem_conv``/``stem_bn`` → ``conv1``/``bn1``,
``BottleneckBlock_k`` (or ``BasicBlock_k``, numbered over all stages)
→ ``layer{i}.{j}``, its ``Conv_i``/``BatchNorm_i`` → ``conv{i+1}``/
``bn{i+1}``, ``downsample_conv``/``downsample_bn`` →
``downsample.0``/``downsample.1``, ``Dense_0`` → ``fc``.  (The JAX
package's ``import_torch_resnet`` is the inverse; this is the port's own
copy of the naming.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer_lm import TransformerLM

__all__ = ["flax_split_to_state_dict", "flax_to_state_dict",
           "flax_vit_to_state_dict",
           "load_flax_convnext", "load_flax_params", "load_flax_resnet",
           "load_flax_simple", "load_flax_vit"]


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


_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def flax_to_state_dict(params: dict, experts=None) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` names for a flax ``TransformerLM`` tree.
    ``experts=(r, S)``: an MoE model's expert leaves cut to the block of
    the rank at expert index ``r`` of ``S`` (the rest whole)."""
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
                elif child == "router":
                    out[f"{pre}.router"] = np.asarray(p)
                elif child in _EXPERT_LEAVES:
                    a = np.asarray(p)
                    if experts is not None:
                        r, n = experts
                        if a.shape[0] % n:
                            raise ValueError(f"{name}/{child}: {a.shape[0]} "
                                             f"experts do not split over "
                                             f"{n} ranks")
                        m = a.shape[0] // n
                        a = a[r * m:(r + 1) * m]
                    out[f"{pre}.{child}"] = a
                else:
                    raise KeyError(f"unknown flax param {name}/{child}")
        else:
            raise KeyError(f"unknown flax param {name}")
    return out


def flax_split_to_state_dict(split: dict) -> Dict[str, np.ndarray]:
    """The port's flat split tree (``outer/``, ``stages/`` names, see
    the module docstring) of a JAX ``{"outer", "stages"}`` tree of numpy
    leaves."""
    out = {f"outer/{k}": v
           for k, v in flax_to_state_dict(split["outer"]).items()}
    stages = split["stages"]
    # the stacked dims: those in front of a block norm's [d] scale
    norm = next(v for k, v in stages.items() if k.endswith("Norm_0"))
    dims = np.asarray(norm["scale"]).shape[:-1]
    per = []
    for idx in np.ndindex(*dims):
        block = _index(stages, idx)
        per.append({k[len("blocks.0."):]: a for k, a in
                    flax_to_state_dict({"block0": block}).items()})
    for k in per[0]:
        out[f"stages/{k}"] = np.stack([p[k] for p in per]).reshape(
            dims + per[0][k].shape)
    return out


def _index(tree, idx):
    """Every leaf of a tree of nested dicts at ``idx``."""
    if isinstance(tree, dict):
        return {k: _index(v, idx) for k, v in tree.items()}
    return np.asarray(tree)[idx]


@torch.no_grad()
def _fill(model: torch.nn.Module, sd: Dict[str, np.ndarray]):
    """Copy ``sd`` into ``model``'s parameters and buffers, which it must
    name exactly, shape for shape; returns ``model``."""
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
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


def load_flax_params(model: TransformerLM, params: dict) -> TransformerLM:
    """Fill ``model`` with the flax ``params`` tree (numpy leaves).
    Shapes must match exactly; returns ``model``."""
    return _fill(model, flax_to_state_dict(params))


def _conv(kernel) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _bn(out: dict, prefix: str, p: dict, stats: dict) -> None:
    out[prefix + ".weight"] = np.asarray(p["scale"])
    out[prefix + ".bias"] = np.asarray(p["bias"])
    out[prefix + ".running_mean"] = np.asarray(stats["mean"])
    out[prefix + ".running_var"] = np.asarray(stats["var"])


def load_flax_resnet(model, params: dict, batch_stats: dict):
    """Fill a port :class:`.resnet.ResNet` from a flax ResNet's ``params``
    and ``batch_stats`` (numpy leaves; ``batch_stats`` is the
    collection itself, ``variables["batch_stats"]``).  Returns
    ``model``."""
    sd: Dict[str, np.ndarray] = {}
    sd["conv1.weight"] = _conv(params["stem_conv"]["kernel"])
    _bn(sd, "bn1", params["stem_bn"], batch_stats["stem_bn"])
    name = model.block.__name__
    k = 0
    for i, n in enumerate(model.stage_sizes):
        for j in range(n):
            scope, pre = f"{name}_{k}", f"layer{i + 1}.{j}"
            bp, bs = params[scope], batch_stats[scope]
            for child, p in bp.items():
                if child.startswith("Conv_"):
                    idx = int(child[len("Conv_"):]) + 1
                    sd[f"{pre}.conv{idx}.weight"] = _conv(p["kernel"])
                elif child.startswith("BatchNorm_"):
                    idx = int(child[len("BatchNorm_"):]) + 1
                    _bn(sd, f"{pre}.bn{idx}", p, bs[child])
                elif child == "downsample_conv":
                    sd[f"{pre}.downsample.0.weight"] = _conv(p["kernel"])
                elif child == "downsample_bn":
                    _bn(sd, f"{pre}.downsample.1", p, bs[child])
                else:
                    raise KeyError(f"unknown flax param {scope}/{child}")
            k += 1
    extra = set(params) - {"stem_conv", "stem_bn", "Dense_0"} - {
        f"{name}_{i}" for i in range(k)}
    if extra:
        raise KeyError(f"unknown flax params {sorted(extra)}")
    _linear(sd, "fc", params["Dense_0"])
    return _fill(model, sd)


def load_flax_simple(model, params: dict):
    """Fill a port ``SimpleCNN`` (flax ``Conv_0``, ``Conv_1``,
    ``Dense_0`` → ``conv1``, ``conv2``, ``fc``) or ``MLP`` (``Dense_i``
    → ``layers.i``) from its flax ``params``.  Returns ``model``."""
    sd: Dict[str, np.ndarray] = {}
    is_cnn = "Conv_0" in params
    for name, p in params.items():
        idx = int(name.rsplit("_", 1)[1])
        if name.startswith("Conv_"):
            sd[f"conv{idx + 1}.weight"] = _conv(p["kernel"])
            sd[f"conv{idx + 1}.bias"] = np.asarray(p["bias"])
        elif name.startswith("Dense_"):
            _linear(sd, "fc" if is_cnn else f"layers.{idx}", p)
        else:
            raise KeyError(f"unknown flax param {name}")
    return _fill(model, sd)


def _conv_bias(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _conv(p["kernel"])
    out[prefix + ".bias"] = np.asarray(p["bias"])


def load_flax_vit(model, params: dict):
    """Fill a port :class:`.vit.ViT` from a flax ViT's ``params`` (numpy
    leaves), mean-pooled or with a class token.  Returns ``model``."""
    return _fill(model, flax_vit_to_state_dict(params))


def flax_vit_to_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` names for a flax ViT tree (any block of
    its leaves too: a device's shard of each converts the same way)."""
    sd: Dict[str, np.ndarray] = {}
    rest = dict(params)
    _conv_bias(sd, "conv_proj", rest.pop("patch_embed"))
    if "cls_token" in rest:
        sd["class_token"] = np.asarray(rest.pop("cls_token"))
    sd["encoder.pos_embedding"] = np.asarray(rest.pop("pos_embed"))
    _norm(sd, "encoder.ln", rest.pop("final_norm"))
    _linear(sd, "heads.head", rest.pop("head"))
    depth = sum(1 for k in rest if k.startswith("block"))
    for i in range(depth):
        bp, pre = rest.pop(f"block{i}"), f"encoder.layers.encoder_layer_{i}"
        _norm(sd, pre + ".ln_1", bp["LayerNorm_0"])
        _norm(sd, pre + ".ln_2", bp["LayerNorm_1"])
        att, mlp = bp["MultiHeadAttention_0"], bp["MlpBlock_0"]
        sd[pre + ".self_attention.in_proj_weight"] = _dense(
            att["qkv"]["kernel"], 1)
        sd[pre + ".self_attention.in_proj_bias"] = np.asarray(
            att["qkv"]["bias"]).reshape(-1)
        _linear(sd, pre + ".self_attention.out_proj", att["out"], in_dims=2)
        _linear(sd, pre + ".mlp.0", mlp["Dense_0"])
        _linear(sd, pre + ".mlp.3", mlp["Dense_1"])
    if rest:
        raise KeyError(f"unknown flax params {sorted(rest)}")
    return sd


def load_flax_convnext(model, params: dict):
    """Fill a port :class:`.convnext.ConvNeXt` from a flax ConvNeXt's
    ``params`` (numpy leaves).  Returns ``model``."""
    sd: Dict[str, np.ndarray] = {}
    rest = dict(params)
    _conv_bias(sd, "downsample_layers.0.0", rest.pop("stem"))
    _norm(sd, "downsample_layers.0.1", rest.pop("stem_norm"))
    for s in range(1, len(model.dims)):
        dp = rest.pop(f"down{s}")
        _norm(sd, f"downsample_layers.{s}.0", dp["norm"])
        _conv_bias(sd, f"downsample_layers.{s}.1", dp["conv"])
    k = 0
    for s, depth in enumerate(model.depths):
        for b in range(depth):
            bp, pre = rest.pop(f"block{k}"), f"stages.{s}.{b}"
            _conv_bias(sd, pre + ".dwconv", bp["dwconv"])
            _norm(sd, pre + ".norm", bp["norm"])
            _linear(sd, pre + ".pwconv1", bp["pwconv1"])
            _linear(sd, pre + ".pwconv2", bp["pwconv2"])
            sd[pre + ".gamma"] = np.asarray(bp["layer_scale"])
            k += 1
    _norm(sd, "norm", rest.pop("head_norm"))
    _linear(sd, "head", rest.pop("head"))
    if rest:
        raise KeyError(f"unknown flax params {sorted(rest)}")
    return _fill(model, sd)
