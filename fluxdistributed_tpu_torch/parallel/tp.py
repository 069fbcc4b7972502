"""Tensor parallelism: Megatron over a ``model`` axis.

Port of ``fluxdistributed_tpu/parallel/tp.py``.  The JAX package places
the params over a ``(data, model)`` mesh by rule and lets GSPMD insert
the collectives.  Here each rank holds its blocks and the modules run
the Megatron schedule with explicit collectives over the model group
(Shoeybi et al., arXiv:1909.08053):

* the qkv (or GQA ``q``/``kv``) projection and the MLP's up projection
  (``fc1``; SwiGLU's ``gate``/``up``) are column-parallel: a rank holds
  the rows of its heads / its slice of ``mlp_dim``, and its input passes
  :class:`ToModelParallel` (identity forward, all-reduce backward);
* the attention output and the MLP's down projection are row-parallel:
  a rank holds the matching columns, and its partial product passes
  :class:`FromModelParallel` (all-reduce forward, identity backward);
  the layer's bias is added once, after the sum;
* the LM's embedding is vocab-parallel (:meth:`TPContext.embed`: mask
  the ids outside this rank's rows, look up locally, all-reduce), and
  the tied logits (or an untied column-parallel ``head``'s) are
  gathered over the vocab before the f32 log-softmax by
  :class:`GatherFromModelParallel`, whose backward keeps this rank's
  slice of the gradient.

Every model rank computes the same loss from the same gathered logits,
so the gathered logits' gradient is the same on every rank: it is
sliced, never reduce-scattered (that would count it K times), and the
gradient of a replicated leaf (a norm, a row-parallel bias) is the same
on every model rank and is not scaled.  The gradient mean spans the
data group only.  The attention core still runs the flash kernels
(B1-B3) on the card, over H/K heads.

:func:`tensor_parallel` rebinds a model's sharded weights to this
rank's blocks and sets its attention modules' local head counts; the
train step is :func:`.fsdp.make_train_step_sharded` with the batch over
``data``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..optim import Optimizer
from ..sharding import P, entry_axes, gather_dim, local_block
from ..tree import tree_map
from .dp import TrainState

__all__ = [
    "FromModelParallel",
    "GatherFromModelParallel",
    "TPContext",
    "ToModelParallel",
    "broadcast_prefix",
    "lm_tp_rules",
    "make_train_step_tp",
    "param_specs",
    "shard_state",
    "state_specs",
    "tensor_parallel",
    "vit_tp_rules",
]


def param_specs(params: dict, rule: Callable[[str, Any], P]) -> dict:
    """A spec for every param by ``rule(name, leaf)``; names are the
    ``state_dict``'s ('.'-joined, e.g. ``blocks.0.attn.qkv.weight``)."""
    return {k: rule(k, p) for k, p in params.items()}


def broadcast_prefix(specs: dict, tree: dict) -> dict:
    """Each param's spec over every tensor of its optimizer-state
    subtree (Adam's ``(m, v)`` pair, an EMA's dict)."""
    return {k: tree_map(lambda _, s=specs[k]: s, sub)
            for k, sub in tree.items()}


def state_specs(state: TrainState, p_specs: dict) -> TrainState:
    """The ``TrainState`` of specs: params by ``p_specs``, optimizer
    state following its param, model state and step replicated."""
    return TrainState(params=p_specs,
                      opt_state=broadcast_prefix(p_specs, state.opt_state),
                      model_state=tree_map(lambda _: P(), state.model_state),
                      step=P())


def shard_state(state: TrainState, mesh: Mesh, p_specs: dict) -> TrainState:
    """This rank's blocks of a global ``state`` by ``p_specs`` (see
    :func:`.fsdp.shard_state`): new tensors, the caller's untouched."""
    from .fsdp import shard_state as put

    return put(state, state_specs(state, p_specs), mesh)


def _table_rule(table) -> Callable[[str, Any], P]:
    """A rule callable from a regex table: the first pattern that
    matches the name decides, else replicated."""
    compiled = [(re.compile(pat), val) for pat, val in table]

    def rule(path: str, leaf) -> P:
        for rx, val in compiled:
            if rx.search(path) is not None:
                return val
        return P()

    return rule


def vit_tp_rules(model_axis: str = MODEL_AXIS) -> Callable[[str, Any], P]:
    """Megatron rules for the port's :class:`..models.vit.ViT`:
    ``in_proj_weight`` [3D, D] and its bias column-parallel over heads
    (each of q, k, v split), ``out_proj`` row-parallel, ``mlp.0``
    column- and ``mlp.3`` row-parallel over ``mlp_dim``; the patch
    embedding, norms, position table and head replicate."""
    from .rules import vit_tp_rules_table

    return _table_rule(vit_tp_rules_table(model_axis))


def lm_tp_rules(model_axis: str = MODEL_AXIS,
                shard_vocab: bool = True) -> Callable[[str, Any], P]:
    """Megatron rules for the port's :class:`..models.TransformerLM`:
    the ``vit_tp_rules`` block pattern over ``attn.qkv`` (or GQA
    ``attn.q``/``attn.kv``), ``attn.out``, ``fc1``/``fc2`` and SwiGLU's
    ``gate``/``up``/``down``, plus the embedding vocab-sharded (when
    ``shard_vocab``) and an untied ``head`` column-parallel.  Heads, KV
    heads, ``mlp_dim`` and (when sharded) the vocab must divide over the
    model axis."""
    from .rules import lm_tp_rules_table

    return _table_rule(lm_tp_rules_table(model_axis, shard_vocab))


def make_train_step_tp(loss_fn: Callable, optimizer: Optimizer, mesh: Mesh,
                       p_specs: dict, state: TrainState,
                       data_axis: str = DATA_AXIS, seed: int = 0,
                       model_axis: str = MODEL_AXIS):
    """The train step with tensor-parallel params: the DP step's math on
    a state of blocks by ``p_specs`` (``state`` gives the optimizer
    state's structure), the batch over ``data_axis``, the gradient mean
    over the data group.  The model ``loss_fn`` runs must have been
    through :func:`tensor_parallel`.  Entries of ``p_specs`` over
    ``data_axis`` (:func:`.fsdp.hybrid_fsdp_tp_specs`) are gathered for
    the forward and reduce-scattered in the backward."""
    from .fsdp import make_train_step_sharded

    return make_train_step_sharded(
        loss_fn, optimizer, mesh, state_specs(state, p_specs),
        batch_axes=(data_axis,), tp_axis=model_axis, seed=seed)


# -- the Megatron collectives ------------------------------------------------


class ToModelParallel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    model group (the column-parallel layers' input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class FromModelParallel(torch.autograd.Function):
    """All-reduce forward over the model group (the row-parallel sum);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromModelParallel(torch.autograd.Function):
    """The ranks' last-dim blocks concatenated (an all-gather over the
    model group); the backward keeps this rank's slice of the gradient,
    which every model rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.rank, ctx.m = rank, x.shape[-1]
        return gather_dim(x, x.ndim - 1, group, n)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(-1, ctx.rank * ctx.m, ctx.m).contiguous(), None,
                None, None)


class TPContext:
    """The model group of one rank, and the Megatron pieces the
    tensor-parallel modules call."""

    def __init__(self, mesh: Mesh, axis: str = MODEL_AXIS):
        sub = mesh.sub(axis)
        self.group, self.size, self.rank = sub.group, sub.size, sub.rank

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer's input."""
        return ToModelParallel.apply(x, self.group)

    def row(self, layer, x: torch.Tensor, dtype) -> torch.Tensor:
        """A row-parallel ``layer`` on ``x`` (its block of the input
        features): the partial product summed over the model group, then
        the bias, once."""
        y = F.linear(x.to(dtype), layer.weight.to(dtype))
        y = FromModelParallel.apply(y, self.group)
        return y if layer.bias is None else y + layer.bias.to(dtype)

    def embed(self, tokens: torch.Tensor, weight: torch.Tensor):
        """The vocab-parallel lookup: ids outside this rank's rows of
        the table (``weight``, its block) read zeros, and the ranks'
        lookups are summed."""
        vl = weight.shape[0]
        local = tokens.long() - self.rank * vl
        inside = (local >= 0) & (local < vl)
        x = F.embedding(torch.where(inside, local, 0), weight)
        x = x.masked_fill(~inside[..., None], 0)
        return FromModelParallel.apply(x, self.group)

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-sharded logits gathered whole."""
        return GatherFromModelParallel.apply(logits, self.group, self.size,
                                             self.rank)


def _only(spec, axis: str) -> P:
    """``spec`` with only its entries over ``axis``."""
    return P(*(e if axis in entry_axes(e) else None for e in spec))


def _split_dim(spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if axis in entry_axes(e):
            return d
    return None


def tensor_parallel(model, mesh: Mesh, rules, model_axis: str = MODEL_AXIS):
    """Make ``model`` (a :class:`..models.TransformerLM` or
    :class:`..models.vit.ViT`) tensor-parallel over ``model_axis`` of
    ``mesh``, in place, and return it.

    ``rules`` is a rule callable (:func:`lm_tp_rules`), a rule table, or
    a spec dict by param name (only entries over ``model_axis`` count;
    the hybrid's FSDP entries are the step's business).  Each weight
    split over the axis is rebound to this rank's block, each
    tensor-parallel attention module takes the local head counts
    (``head_dim`` is unchanged) and each wired module runs the Megatron
    collectives (:class:`TPContext`).  Column-parallel weights must be
    split on their output dim and row-parallel ones on their input dim;
    a split weight no wired module owns, a module split in part, or a
    head count that does not divide raises.  Decoding a
    tensor-parallel model is not supported."""
    from ..models.transformer_lm import (CausalSelfAttention, DecoderBlock,
                                         TransformerLM)
    from ..models.vit import MlpBlock, MultiHeadAttention, ViT

    if not isinstance(model, (TransformerLM, ViT)):
        raise ValueError(f"no tensor-parallel modules for "
                         f"{type(model).__name__} (TransformerLM and ViT)")
    if getattr(model, "tp_applied", False):
        raise ValueError("the model is tensor-parallel already")
    params = dict(model.named_parameters())
    if isinstance(rules, dict):
        specs = rules
    else:
        specs = param_specs(params, rules if callable(rules)
                            else _table_rule(rules))
    tp = {k: _only(s, model_axis) for k, s in specs.items()
          if model_axis in {a for e in s for a in entry_axes(e)}}
    k = mesh.axis_size(model_axis)
    ctx = TPContext(mesh, model_axis)
    owned = set()

    def wire(pre: str, cols, rows, extra=()):
        """Whether the module at ``pre`` is split: all of its column
        (dim 0) and row (dim 1) weights, or none."""
        names = [pre + n for n in (*cols, *rows, *extra) if pre + n in params]
        split = [n for n in names if n in tp]
        if not split:
            return False
        if len(split) != len(names):
            raise ValueError(f"{pre[:-1]}: {sorted(set(names) - set(split))}"
                             f" are not split over {model_axis!r} while "
                             f"{split} are")
        for n in split:
            want = 1 if n[len(pre):] in rows else 0
            if _split_dim(tp[n], model_axis) != want:
                raise ValueError(f"{n}: split on dim "
                                 f"{_split_dim(tp[n], model_axis)}, the "
                                 f"tensor-parallel layer needs dim {want}")
        owned.update(split)
        return True

    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, CausalSelfAttention):
            if wire(pre, ("qkv.weight", "q.weight", "kv.weight"),
                    ("out.weight",), ("qkv.bias", "q.bias", "kv.bias")):
                _local_heads(mod, k, name)
                mod.tp = ctx
        elif isinstance(mod, DecoderBlock):
            if wire(pre, ("fc1.weight", "gate.weight", "up.weight"),
                    ("fc2.weight", "down.weight"), ("fc1.bias",)):
                mod.tp = ctx
        elif isinstance(mod, MultiHeadAttention):
            if wire(pre, ("in_proj_weight",), ("out_proj.weight",),
                    ("in_proj_bias",)):
                _local_heads(mod, k, name)
                mod.tp = ctx
        elif isinstance(mod, MlpBlock):
            if wire(pre, ("0.weight",), ("3.weight",), ("0.bias",)):
                mod.tp = ctx
    if isinstance(model, TransformerLM):
        if "embed.weight" in tp:
            if _split_dim(tp["embed.weight"], model_axis) != 0:
                raise ValueError("embed.weight must split on its vocab dim")
            model.tp_embed = ctx
            owned.add("embed.weight")
        if model.head is not None and wire("", ("head.weight",), (),
                                           ("head.bias",)):
            model.tp_head = ctx
    stray = sorted(set(tp) - owned)
    if stray:
        raise ValueError(f"{stray} are split over {model_axis!r} but no "
                         "tensor-parallel module computes with them")
    with torch.no_grad():
        for n in owned:
            params[n].data = local_block(params[n].data, tp[n], mesh)
    model.tp_applied = True
    return model


def _local_heads(mod, k: int, name: str) -> None:
    heads = mod.num_heads
    kv = getattr(mod, "num_kv_heads", heads)
    if heads % k or kv % k:
        raise ValueError(f"{name}: {heads} heads ({kv} KV heads) do not "
                         f"split over a model axis of {k}")
    mod.num_heads = heads // k
    if hasattr(mod, "num_kv_heads"):
        mod.num_kv_heads = kv // k
