"""The registered step variants: every parallelism mode's train step and
the serving engine's programs, built tiny for pricing.

Port of the registry of ``fluxdistributed_tpu/analysis/variants.py``
(``StepVariant``, ``VARIANT_BUILDERS``, ``variant_names``,
``build_variants``), without the lint checks it also serves there.  Each
variant goes through the port's real path, ``prepare_training`` for the
parallelism modes and ``LMEngine`` for serving, with the JAX registry's
toy sizes (``SimpleCNN`` with 8 features, a ``TransformerLM`` of vocab
32, width 16, MLP 32) on a world of 8 ranks.  Variants are built inside
:func:`..obs.pricing.pricing` (8 fake ranks): their models, states and
batches are fake tensors, and ``fn(*args)`` is one step of rank 0, run
by :func:`..obs.pricing.price_step`.

``dp_shardmap`` and ``zero1_shardmap`` name the port's ``spmd=
"shard_map"`` steps, which issue the same collectives as ``dp`` and
``zero1``: every step of the port writes its collectives out.  The
``serve*`` variants price the engine's decode step, insert and prefill
per bucket (dense), and its decode step, prefill chunk, page bind and
release (paged); ``serve_paged_pallas`` is the paged engine with an
int8 cache.  Priced, every one runs the kernels' shape-only branches
(B4/B5), the card's decode path.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["StepVariant", "VARIANT_BUILDERS", "build_variants",
           "variant_names"]

#: the world the variants span
WORLD = 8


@dataclasses.dataclass
class StepVariant:
    """One priced program: ``fn(*args)`` is one call of it (rank 0's),
    ``mesh`` the mesh whose axes name its collectives (``None`` for the
    serving programs), ``source`` the repo-relative file of the factory
    it comes from."""

    name: str
    fn: Callable
    args: Tuple[Any, ...]
    mesh: Any
    source: str


def _src(module) -> str:
    """Repo-relative path of a module's source file."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.relpath(os.path.abspath(module.__file__),
                           root).replace(os.sep, "/")


def _image_setup(pr):
    import torch

    from ..data.synthetic import SyntheticDataset
    from ..models.simple import SimpleCNN
    from ..fake import real

    with real(), torch.device("meta"):
        model = SimpleCNN(num_classes=4, features=8, device="meta")
    return (pr.module(model),
            SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3)))


def _lm_setup(pr, depth: int, heads: int, attn_fn=None):
    import torch

    from ..data.synthetic import SyntheticTextDataset
    from ..fake import real
    from ..models.transformer_lm import TransformerLM

    with real(), torch.device("meta"):
        model = TransformerLM(vocab=32, dim=16, depth=depth, num_heads=heads,
                              mlp_dim=32, dtype=torch.float32, dropout=0.0,
                              attn_fn=attn_fn, device="meta")
    return pr.module(model), SyntheticTextDataset(vocab=32, seqlen=16)


def _fake_batch(pr, dataset, task, rows: int = 16) -> dict:
    """Rank 0's rows of a ``rows``-row batch of ``dataset``, fake."""
    import numpy as np

    from ..data.loader import batch_to_dict
    from ..fake import real

    with real():
        draw = batch_to_dict(dataset.batch(np.random.default_rng(0), rows),
                             getattr(dataset, "nclasses", None))
    bmesh = task.loader.mesh
    return pr.batch(draw, shards=1 if bmesh is None else bmesh.size)


def _prepared(pr, name: str, model, dataset, mesh, source_mod,
              **kw) -> List[StepVariant]:
    """The real ``prepare_training`` path, its step a variant."""
    from .. import optim
    from ..train.trainer import prepare_training

    task = prepare_training(model, dataset, optim.adam(1e-3), mesh=mesh,
                            batch_size=16, cycles=1, device=pr.device, **kw)
    return [StepVariant(name=name, fn=task.step_fn,
                        args=(task.state, _fake_batch(pr, dataset, task)),
                        mesh=mesh, source=_src(source_mod))]


def _data_mesh(pr):
    from .. import mesh as mesh_lib

    return mesh_lib.data_mesh(WORLD, device=pr.device)


def _mesh(pr, axes: dict):
    from .. import mesh as mesh_lib

    return mesh_lib.make_mesh(axes, device=pr.device)


def _build_dp(pr) -> List[StepVariant]:
    from ..parallel import dp

    model, ds = _image_setup(pr)
    return _prepared(pr, "dp", model, ds, _data_mesh(pr), dp, spmd="jit")


def _build_dp_shardmap(pr) -> List[StepVariant]:
    from ..parallel import dp

    model, ds = _image_setup(pr)
    return _prepared(pr, "dp_shardmap", model, ds, _data_mesh(pr), dp,
                     spmd="shard_map")


def _build_zero1(pr) -> List[StepVariant]:
    from ..parallel import zero1

    model, ds = _image_setup(pr)
    return _prepared(pr, "zero1", model, ds, _data_mesh(pr), zero1,
                     spmd="jit", zero1=True)


def _build_zero1_shardmap(pr) -> List[StepVariant]:
    from ..parallel import zero1

    model, ds = _image_setup(pr)
    return _prepared(pr, "zero1_shardmap", model, ds, _data_mesh(pr), zero1,
                     spmd="shard_map", zero1=True)


def _build_zero1_fused(pr) -> List[StepVariant]:
    """The fused packed ZeRO-1 update: one reduce-scatter, the fused
    Adam kernel (B6, its shape-only branch), one all-gather."""
    from ..ops import logitcrossentropy
    from ..parallel import dp
    from ..parallel import zero1_fused as zf

    mesh = _data_mesh(pr)
    model, ds = _image_setup(pr)
    loss_fn = dp.module_loss_fn(model, logitcrossentropy, mesh)
    state = zf.zero1_fused_state(dict(model.named_parameters()), mesh)
    step = zf.make_train_step_zero1_fused(loss_fn, mesh, lr=1e-3)
    batch = pr.batch({"image": ((16, 8, 8, 3), "float32"),
                      "label": ((16, 4), "float32")}, shards=WORLD)
    return [StepVariant(name="zero1_fused", fn=step, args=(state, batch),
                        mesh=mesh, source=_src(zf))]


def _build_fsdp(pr) -> List[StepVariant]:
    from ..parallel import fsdp

    model, ds = _image_setup(pr)
    return _prepared(pr, "fsdp", model, ds, _data_mesh(pr), fsdp,
                     spmd="fsdp")


def _build_tp(pr) -> List[StepVariant]:
    from ..mesh import DATA_AXIS, MODEL_AXIS
    from ..models.transformer_lm import lm_loss_fn
    from ..parallel import tp

    mesh = _mesh(pr, {DATA_AXIS: 2, MODEL_AXIS: 4})
    model, ds = _lm_setup(pr, depth=1, heads=4)
    return _prepared(pr, "tp", model, ds, mesh, tp, spmd="tp",
                     loss_fn=lm_loss_fn(model), topk=())


def _pp(pr, name: str, depth: int, source_mod, **kw) -> List[StepVariant]:
    from ..mesh import DATA_AXIS, PIPE_AXIS

    mesh = _mesh(pr, {DATA_AXIS: 2, PIPE_AXIS: 4})
    model, ds = _lm_setup(pr, depth=depth, heads=2)
    return _prepared(pr, name, model, ds, mesh, source_mod, spmd="pp_1f1b",
                     num_microbatches=2, topk=(), **kw)


def _build_pp_1f1b(pr) -> List[StepVariant]:
    from ..parallel import pp_1f1b

    return _pp(pr, "pp_1f1b", 4, pp_1f1b)


def _build_pp_planned(pr) -> List[StepVariant]:
    """Depth 6 over 4 pipe ranks through a non-uniform plan (flat block
    costs, the outer weight on the end stages: boundaries (0, 1, 3, 5,
    6))."""
    from ..parallel import pp_plan as pp_plan_mod

    plan = pp_plan_mod.plan_stages([1.0] * 6, 4, 2, outer=(1.0, 1.0))
    return _pp(pr, "pp_planned", 6, pp_plan_mod, pp_plan=plan)


def _build_pp_zb(pr) -> List[StepVariant]:
    from ..parallel import pp_1f1b

    return _pp(pr, "pp_zb", 4, pp_1f1b, pipeline_schedule="zb")


def _layout(pr, name: str, preset: str, lm: bool) -> List[StepVariant]:
    from ..models.transformer_lm import lm_loss_fn
    from ..parallel import layout as layout_mod

    lay = layout_mod.resolve_layout(preset, WORLD)
    mesh = lay.build_mesh(device=pr.device)
    if lm:
        model, ds = _lm_setup(pr, depth=1, heads=4)
        kw = dict(loss_fn=lm_loss_fn(model), topk=())
    else:
        model, ds = _image_setup(pr)
        kw = {}
    return _prepared(pr, name, model, ds, mesh, layout_mod, layout=lay, **kw)


def _build_layout_dp_fsdp(pr) -> List[StepVariant]:
    return _layout(pr, "layout_dp_fsdp", "dp_fsdp", lm=False)


def _build_layout_fsdp_tp(pr) -> List[StepVariant]:
    return _layout(pr, "layout_fsdp_tp", "fsdp_tp", lm=True)


def _build_layout_dp_fsdp_tp(pr) -> List[StepVariant]:
    return _layout(pr, "layout_dp_fsdp_tp", "dp_fsdp_tp", lm=True)


def _build_context(pr) -> List[StepVariant]:
    from ..mesh import DATA_AXIS, SEQ_AXIS
    from ..models.transformer_lm import lm_loss_fn
    from ..parallel import context

    mesh = _mesh(pr, {DATA_AXIS: 2, SEQ_AXIS: 4})
    model, ds = _lm_setup(pr, depth=1, heads=4,
                          attn_fn=context.make_ring_attention(
                              mesh, batch_axis=DATA_AXIS, causal=True))
    return _prepared(pr, "context", model, ds, mesh, context, spmd="sp",
                     loss_fn=lm_loss_fn(model), topk=())


def _engine(pr, **kw):
    from ..serve import engine as engine_mod

    # one head of 16: the decode kernels (B4/B5) take head dims that are
    # multiples of 16 (the JAX registry's two heads of 8 run its XLA walk)
    model, _ = _lm_setup(pr, depth=1, heads=1)
    return engine_mod.LMEngine(model, max_slots=2, max_len=64,
                               cuda_graph=False, **kw), _src(engine_mod)


def _state(eng) -> dict:
    """What a decode program reads and writes: the params, the cache,
    the token buffer."""
    return {"params": dict(eng.model.named_parameters()),
            "cache": list(eng.cache.buffers()), "tok": eng._tok}


def _build_serve(pr) -> List[StepVariant]:
    """The dense engine's programs: the all-slot decode step, the slot
    splice, one prefill per bucket."""
    import numpy as np

    from ..models.transformer_lm import make_decode_cache

    eng, src = _engine(pr, buckets=(16, 32))
    small = make_decode_cache(eng.model, 1, eng.max_len, eng.kv_quant)
    out = [
        StepVariant("serve:step", lambda st: eng._decode(), (_state(eng),),
                    None, src),
        StepVariant("serve:insert",
                    lambda st, sm: eng._insert(small, 0, 8),
                    (_state(eng), list(small.buffers())), None, src),
    ]
    for b in eng.buckets:
        cache0 = make_decode_cache(eng.model, 1, eng.max_len, eng.kv_quant)
        padded = np.zeros((1, b), np.int64)
        out.append(StepVariant(
            f"serve:prefill_b{b}",
            lambda st, c, p=padded, c0=cache0: eng._prefill(p, 8, c0),
            (_state(eng), list(cache0.buffers())), None, src))
    return out


def _paged(pr, name: str, programs: Sequence[str], **kw) -> List[StepVariant]:
    import numpy as np

    eng, src = _engine(pr, layout="paged", kv_block_size=8,
                       prefill_chunk=16, **kw)
    chunk = np.zeros((1, 16), np.int64)
    fns = {"step": lambda st: eng._decode(),
           "chunk": lambda st: eng._chunk(chunk, 0, 0, 16, True),
           "bind": lambda st: eng._bind(0),
           "release": lambda st: eng._release(0)}
    return [StepVariant(f"{name}:{p}", fns[p], (_state(eng),), None, src)
            for p in programs]


def _build_serve_paged(pr) -> List[StepVariant]:
    return _paged(pr, "serve_paged", ("step", "chunk", "bind", "release"),
                  prefix_cache=True)


def _build_serve_paged_pallas(pr) -> List[StepVariant]:
    return _paged(pr, "serve_paged_pallas", ("step", "chunk"),
                  kv_dtype="int8")


#: name -> builder, the JAX registry's names and order
VARIANT_BUILDERS: Dict[str, Callable[[Any], List[StepVariant]]] = {
    "dp": _build_dp,
    "dp_shardmap": _build_dp_shardmap,
    "zero1": _build_zero1,
    "zero1_shardmap": _build_zero1_shardmap,
    "zero1_fused": _build_zero1_fused,
    "fsdp": _build_fsdp,
    "tp": _build_tp,
    "layout_dp_fsdp": _build_layout_dp_fsdp,
    "layout_fsdp_tp": _build_layout_fsdp_tp,
    "layout_dp_fsdp_tp": _build_layout_dp_fsdp_tp,
    "pp_1f1b": _build_pp_1f1b,
    "pp_planned": _build_pp_planned,
    "pp_zb": _build_pp_zb,
    "context": _build_context,
    "serve": _build_serve,
    "serve_paged": _build_serve_paged,
    "serve_paged_pallas": _build_serve_paged_pallas,
}


def variant_names() -> List[str]:
    return list(VARIANT_BUILDERS)


def build_variants(names: Optional[Sequence[str]] = None,
                   pr=None) -> List[StepVariant]:
    """Build the named variants (default: all) inside ``pr``, an open
    :func:`..obs.pricing.pricing` of :data:`WORLD` ranks.  Unknown names
    raise: a typo must not skip a variant silently."""
    if pr is None:
        raise ValueError("build variants inside obs.pricing.pricing("
                         f"{WORLD}, device) and pass it as pr=")
    out: List[StepVariant] = []
    for n in (names or variant_names()):
        if n not in VARIANT_BUILDERS:
            raise ValueError(
                f"unknown variant {n!r}; registered: {variant_names()}")
        out.extend(VARIANT_BUILDERS[n](pr))
    return out
