"""Declarative sharding rules: a regex table over parameter names becomes
a spec for every leaf of any model.

Port of ``fluxdistributed_tpu/parallel/rules.py``, over the port's
names: a leaf's path is its ``state_dict`` name (keys joined by ``.``,
e.g. ``blocks.0.attn.qkv.weight``), where the JAX package joins flax
scopes by ``/``.

* :func:`match_partition_rules`: the FIRST rule whose regex
  ``re.search``-matches a leaf's path gives its spec; scalars and
  single-element leaves replicate; an unmatched leaf replicates too,
  and is recorded in a :class:`RuleReport` (``strict=True`` raises on
  an unmatched leaf of at least ``min_size`` elements: the silent
  replication trap).
* :class:`ShardLargest`: a shape-driven rule value, the FSDP rule
  (:func:`.fsdp.fsdp_leaf_spec`) over one axis; :func:`with_fsdp`
  overlays it on an existing spec tree's leftover dims.
* :func:`validate_rules` rejects axes the mesh does not have, and
  :func:`validate_specs` checks a spec tree against the leaves' shapes
  (the axis exists, the dim divides), before anything is placed: the
  port's own copy of the checks of the JAX package's
  ``analysis.jaxpr_checks.check_spec_tree``.
* :data:`RULE_TABLES`: the committed tables (``dp``, ``fsdp``,
  ``lm_tp``, ``vit_tp``) with probe models of the port (built on the
  meta device: shapes, no memory), and :func:`rules_for_model`.

The tensor-parallel tables carry the port's layouts: a torch weight is
``(out, in)``, so a column-parallel layer splits dim 0 and a row-parallel
one dim 1, and the fused qkv / kv projections split each stacked part
(:class:`~..sharding.Stacked`) where the JAX kernel splits its heads dim.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Optional, Sequence, Tuple

from ..mesh import FSDP_AXIS, MODEL_AXIS, Mesh
from ..sharding import P, Stacked, entry_axes, spec_axes

__all__ = [
    "FALLBACK_MIN_SIZE",
    "RULE_TABLES",
    "Rule",
    "RuleReport",
    "RuleTable",
    "ShardLargest",
    "dp_rules",
    "fsdp_rules",
    "lm_tp_rules_table",
    "match_partition_rules",
    "rule_report",
    "rules_for_model",
    "train_state_specs",
    "validate_rules",
    "validate_specs",
    "vit_tp_rules_table",
    "with_fsdp",
]

#: an UNMATCHED leaf of at least this many elements falling to
#: replication is reported (and refused under ``strict=True``): the
#: scale of ``fsdp.MIN_SHARD_ELEMS``
FALLBACK_MIN_SIZE = 2 ** 11


@dataclasses.dataclass(frozen=True)
class ShardLargest:
    """Rule value: split the leaf's largest still-unsplit dim divisible
    by the axis size over ``axis`` (:func:`.fsdp.fsdp_leaf_spec`: ties
    go to the trailing dim; leaves under ``min_size`` elements, or with
    no divisible dim, keep their base spec).  Resolving it needs a mesh
    (the axis size)."""

    axis: str = FSDP_AXIS
    min_size: int = FALLBACK_MIN_SIZE


#: one rule: (regex searched in the leaf's path, value); the value is a
#: spec, ``None`` (replicated) or a ShardLargest
Rule = Tuple[str, Any]


@dataclasses.dataclass
class RuleReport:
    """What a resolution did: the record behind the replication
    fallback."""

    #: rule pattern -> the leaf paths it decided
    matched: dict
    #: rule patterns that decided no leaf
    dead: list
    #: (path, elements) of every unmatched non-scalar leaf (replicated)
    unmatched: list
    #: the subset of ``unmatched`` at or above the size threshold
    large_unmatched: list


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` over a tree of dicts, lists and tuples, the path
    '.'-joined (a ``state_dict`` name for a flat param dict)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))
    else:
        yield path, tree


def _rebuild(tree, values: dict, path: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_rebuild(v, values, f"{path}.{i}" if path
                                   else str(i)) for i, v in enumerate(tree))
    return values[path]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _resolve_value(value, shape, mesh: Optional[Mesh], base=None) -> P:
    if isinstance(value, ShardLargest):
        from .fsdp import fsdp_leaf_spec

        if mesh is None:
            raise ValueError(
                "a ShardLargest rule value needs a mesh to resolve (its "
                "axis size drives divisibility) — pass mesh= to "
                "match_partition_rules")
        if value.axis not in mesh.shape:
            raise ValueError(
                f"ShardLargest axis {value.axis!r} is not on the mesh "
                f"(axes: {sorted(mesh.shape)})")
        return fsdp_leaf_spec(shape, value.axis, mesh.axis_size(value.axis),
                              min_size=value.min_size, base=base)
    if value is None:
        return P()
    if isinstance(value, P):
        return value
    raise TypeError(f"rule value {value!r} is neither a spec (P) nor a "
                    "ShardLargest")


def match_partition_rules(rules: Sequence[Rule], params, *,
                          mesh: Optional[Mesh] = None,
                          min_size: int = FALLBACK_MIN_SIZE,
                          strict: bool = False,
                          report: Optional[RuleReport] = None):
    """The spec tree of ``params`` (a dict of tensors by name, or a tree
    of them) from a regex rule table.

    The first match wins (order specific patterns before broad ones);
    scalars and single-element leaves replicate before any rule is
    consulted; unmatched leaves replicate and are recorded in
    ``report`` (``strict=True`` raises when one has at least
    ``min_size`` elements).  ``mesh`` is needed by ShardLargest values
    and validates the rules' axis names (:func:`validate_rules`)."""
    if mesh is not None:
        validate_rules(rules, mesh)
    compiled = [(re.compile(pat), pat, val) for pat, val in rules]
    rep = report if report is not None else RuleReport({}, [], [], [])
    for _, pat, _ in compiled:
        rep.matched.setdefault(pat, [])
    out = {}
    for path, leaf in _leaves(params):
        if leaf is None:
            out[path] = None
            continue
        shape = _shape(leaf)
        n = math.prod(shape)
        if not shape or n <= 1:
            out[path] = P()
            continue
        for rx, pat, val in compiled:
            if rx.search(path) is not None:
                rep.matched[pat].append(path)
                out[path] = _resolve_value(val, shape, mesh)
                break
        else:
            rep.unmatched.append((path, n))
            if n >= min_size:
                rep.large_unmatched.append((path, n))
            out[path] = P()
    rep.dead = [pat for _, pat, _ in compiled if not rep.matched[pat]]
    if strict and rep.large_unmatched:
        worst = ", ".join(f"{p} ({n} elems)"
                          for p, n in rep.large_unmatched[:5])
        raise ValueError(
            f"{len(rep.large_unmatched)} unmatched leaf(ves) of >= "
            f"{min_size} elements fell to replication: {worst} — add a "
            "rule (or a ShardLargest catch-all), or drop strict=True if "
            "replication is intended")
    return _rebuild(params, out)


def with_fsdp(specs, params, mesh: Mesh, axis: str = FSDP_AXIS,
              min_size: int = FALLBACK_MIN_SIZE):
    """ZeRO placement over ``axis`` laid on an existing spec tree: each
    large leaf's largest still-unsplit dim splits over ``axis`` (the
    entries already there, tensor-parallel dims, are kept)."""
    from .fsdp import fsdp_leaf_spec

    n = mesh.axis_size(axis)
    base = dict(_leaves(specs))
    out = {path: None if leaf is None else fsdp_leaf_spec(
        _shape(leaf), axis, n, min_size=min_size, base=base[path])
        for path, leaf in _leaves(params)}
    return _rebuild(params, out)


def rule_report(rules: Sequence[Rule], params,
                min_size: int = FALLBACK_MIN_SIZE) -> RuleReport:
    """Dead rules and unmatched leaves of ``rules`` on ``params``; no
    mesh needed (ShardLargest values resolve as replicated: only the
    matching is reported)."""
    rep = RuleReport({}, [], [], [])
    safe = [(pat, P() if isinstance(val, ShardLargest) else val)
            for pat, val in rules]
    match_partition_rules(safe, params, min_size=min_size, report=rep)
    return rep


def validate_rules(rules: Sequence[Rule], mesh: Mesh) -> None:
    """Refuse rule values that name axes the mesh does not have, naming
    the rule."""
    axes = set(mesh.shape)
    for pat, val in rules:
        if isinstance(val, ShardLargest):
            bad = () if val.axis in axes else (val.axis,)
        elif val is None:
            bad = ()
        elif isinstance(val, P):
            bad = tuple(a for a in spec_axes(val) if a not in axes)
        else:
            raise TypeError(f"rule {pat!r} value {val!r} is neither a spec "
                            "(P) nor a ShardLargest")
        if bad:
            raise ValueError(
                f"rule {pat!r} names mesh axis(es) {sorted(set(bad))} not on "
                f"the mesh (axes: {sorted(axes)}) — source axis names from "
                "fluxdistributed_tpu_torch.mesh constants and build the mesh "
                "with those axes")


def _spec_leaves(tree, path: str = ""):
    """``(path, spec)`` over a spec tree (specs are leaves)."""
    if isinstance(tree, P) or tree is None:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}.{i}" if path else str(i))
    else:
        raise TypeError(f"{path}: {tree!r} is not a spec")


def _check(shape: tuple, spec, leaf: str, mesh: Mesh, where: str) -> list:
    """The findings of one leaf: a split axis the mesh lacks, more
    split dims than the leaf has, or a dim that does not divide."""
    out = []
    for d, entry in enumerate(spec):
        names = entry_axes(entry)
        if not names:
            continue
        if d >= len(shape):
            out.append(f"{where}: spec {spec!r} at {leaf} has more sharded "
                       f"dims than the rank-{len(shape)} array")
            continue
        size = 1
        for a in names:
            if a not in mesh.shape:
                out.append(f"{where}: axis {a!r} in spec {spec!r} at {leaf} "
                           f"is not on the mesh (axes: {sorted(mesh.shape)})")
            else:
                size *= mesh.shape[a]
        size *= entry.parts if isinstance(entry, Stacked) else 1
        if size > 1 and shape[d] % size:
            out.append(f"{where}: dim {d} of {leaf} (shape {shape}) is not "
                       f"divisible by {'x'.join(names)}={size}")
    return out


def validate_specs(specs, shapes, mesh: Mesh, where: str = "rules") -> None:
    """Check a spec tree against the leaves of ``shapes`` (the same tree
    of tensors, e.g. a ``TrainState``'s fields; Adam's ``(m, v)`` pairs
    are leaves' containers, not shape literals): every split axis is on
    the mesh and every split dim divides.  Raises ONE ``ValueError``
    carrying every finding."""
    sflat = list(_spec_leaves(_fields(specs)))
    aflat = [(p, x) for p, x in _leaves(_fields(shapes))]
    if len(sflat) != len(aflat):
        raise ValueError(
            f"{where}: spec tree has {len(sflat)} leaves but the state tree "
            f"has {len(aflat)} — regenerate the specs from the live state "
            "tree")
    findings = []
    for (path, spec), (_, leaf) in zip(sflat, aflat):
        if leaf is None or spec is None or not hasattr(leaf, "shape"):
            continue
        findings += _check(tuple(leaf.shape), spec, path, mesh, where)
    if findings:
        raise ValueError(f"rule-derived specs failed validation "
                         f"({len(findings)} finding(s)): "
                         + "; ".join(findings[:8]))


def _fields(state):
    """A ``TrainState``'s trees as a dict (other trees as they are)."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {"params": state.params, "opt_state": state.opt_state,
                "model_state": state.model_state}
    return state


def train_state_specs(state, p_specs: dict):
    """A ``TrainState`` of specs from a param spec dict: the optimizer
    state broadcast from its param's spec, model state and step
    replicated (:func:`.tp.state_specs`)."""
    from .tp import state_specs

    return state_specs(state, p_specs)


# -- committed rule tables ---------------------------------------------------
#
# Patterns are ordered specific-first: the matcher takes the FIRST hit
# ("qkv" before "kv").


def dp_rules() -> list:
    """Plain data parallelism: the empty table (every leaf replicates,
    which is the dp and ZeRO-1 placement)."""
    return []


def fsdp_rules(axis: str = FSDP_AXIS,
               min_size: int = FALLBACK_MIN_SIZE) -> list:
    """ZeRO-3 placement as one rule: every large leaf's largest
    divisible dim splits over ``axis`` (with ``axis="data"`` on a 1-D
    mesh, :func:`.fsdp.fsdp_specs` exactly)."""
    return [(r".*", ShardLargest(axis, min_size=min_size))]


def lm_tp_rules_table(model_axis: str = MODEL_AXIS,
                      shard_vocab: bool = True) -> list:
    """The Megatron LM recipe over the port's names: ``qkv`` / ``q`` /
    ``kv`` column-parallel over heads, ``attn.out`` row-parallel, the
    MLP's ``fc1`` (SwiGLU ``gate``, ``up``) column- and ``fc2``
    (``down``) row-parallel, the embedding vocab-sharded, an untied
    ``head`` column-parallel."""
    m = model_axis
    rules = []
    if shard_vocab:
        rules.append((r"(^|\.)embed\.weight$", P(m, None)))
    rules += [
        (r"\.qkv\.weight$", P(Stacked(m, 3), None)),
        (r"\.qkv\.bias$", P(Stacked(m, 3))),
        (r"\.kv\.weight$", P(Stacked(m, 2), None)),
        (r"\.kv\.bias$", P(Stacked(m, 2))),
        (r"\.q\.weight$", P(m, None)),
        (r"\.q\.bias$", P(m)),
        (r"\.out\.weight$", P(None, m)),
        (r"(^|\.)head\.weight$", P(m, None)),
        (r"(^|\.)head\.bias$", P(m)),
        (r"\.fc1\.weight$", P(m, None)),
        (r"\.fc1\.bias$", P(m)),
        (r"\.fc2\.weight$", P(None, m)),
        (r"\.(gate|up)\.weight$", P(m, None)),
        (r"\.down\.weight$", P(None, m)),
    ]
    return rules


def vit_tp_rules_table(model_axis: str = MODEL_AXIS) -> list:
    """The encoder-block Megatron pattern over the port's (torchvision)
    ViT names; patch embedding, norms, positions and head replicate."""
    m = model_axis
    return [
        (r"self_attention\.in_proj_weight$", P(Stacked(m, 3), None)),
        (r"self_attention\.in_proj_bias$", P(Stacked(m, 3))),
        (r"self_attention\.out_proj\.weight$", P(None, m)),
        (r"\.mlp\.0\.weight$", P(m, None)),
        (r"\.mlp\.0\.bias$", P(m)),
        (r"\.mlp\.3\.weight$", P(None, m)),
    ]


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """A committed table and the probe models it is checked against
    (each probe: ``() -> (params, note)``, the params of a port model
    built on the meta device)."""

    name: str
    build: Callable[[], list]
    probes: Tuple[Callable[[], Tuple[Any, str]], ...]
    #: tables that match nothing (dp) or everything (fsdp) skip the
    #: large-unmatched check: that is their documented placement
    check_unmatched: bool = True


def _meta_params(build) -> dict:
    import torch

    with torch.device("meta"):
        model = build()
    return {k: p for k, p in model.named_parameters()}


def _lm_probe(gqa: bool = False, swiglu: bool = False, tied: bool = True):
    def build():
        from ..models.transformer_lm import TransformerLM

        params = _meta_params(lambda: TransformerLM(
            vocab=32, dim=16, depth=2, num_heads=4, mlp_dim=32,
            num_kv_heads=2 if gqa else None,
            mlp="swiglu" if swiglu else "gelu", tie_embeddings=tied,
            device="meta"))
        return params, (f"TransformerLM(gqa={gqa}, swiglu={swiglu}, "
                        f"tied={tied})")

    return build


def _vit_probe():
    from ..models.vit import ViT

    return _meta_params(lambda: ViT(
        patch=4, depth=2, dim=16, num_heads=4, mlp_dim=32, num_classes=4,
        image_size=8, device="meta")), "ViT(tiny)"


def _cnn_probe():
    from ..models.simple import SimpleCNN

    return _meta_params(lambda: SimpleCNN(
        num_classes=4, features=8, device="meta")), "SimpleCNN(tiny)"


#: name -> committed table: a pattern that matches no leaf of any probe
#: is a dead rule; a probe leaf of >= FALLBACK_MIN_SIZE elements matched
#: by nothing is a silent replication
RULE_TABLES = {
    "dp": RuleTable("dp", dp_rules,
                    probes=(_lm_probe(), _vit_probe, _cnn_probe),
                    check_unmatched=False),
    "fsdp": RuleTable("fsdp", fsdp_rules,
                      probes=(_lm_probe(), _vit_probe, _cnn_probe),
                      check_unmatched=False),
    "lm_tp": RuleTable("lm_tp", lm_tp_rules_table,
                       probes=(_lm_probe(), _lm_probe(gqa=True),
                               _lm_probe(swiglu=True),
                               _lm_probe(tied=False))),
    "vit_tp": RuleTable("vit_tp", vit_tp_rules_table, probes=(_vit_probe,)),
}


def rules_for_model(model, tp: bool = True) -> list:
    """The committed table of a model family: the LM and the ViT get
    their Megatron tables (``tp=False``, a layout without a model axis,
    gives the empty table, so the FSDP overlay alone decides);
    everything else (the CNNs) the empty table."""
    from ..models.transformer_lm import TransformerLM
    from ..models.vit import ViT

    if not tp:
        return dp_rules()
    if isinstance(model, TransformerLM):
        return lm_tp_rules_table()
    if isinstance(model, ViT):
        return vit_tp_rules_table()
    return dp_rules()
