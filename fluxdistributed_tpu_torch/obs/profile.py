"""Per-layer and per-step cost profiles: static costs priced on fake
tensors and measured phase times, in a versioned, topology-fingerprinted
JSON artifact.

Port of ``fluxdistributed_tpu/obs/profile.py``.  The JAX module reads
FLOPs and bytes off XLA's ``cost_analysis`` of a lowered program; the
port runs the program once on fake tensors (:mod:`.pricing`) and counts:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, which counts
  matmuls, convolutions and attention (XLA's count includes elementwise
  work too, so the two differ by that);
* ``bytes``: each aten op's input and output bytes, summed
  (:class:`.pricing.LiveBytes`).

:func:`lm_layer_costs` isolates one decoder block by the JAX module's
depth difference: the stack is homogeneous, so ``cost(depth=2) -
cost(depth=1)`` is one block and the rest is the embedding and head.
It prices the plain forward (the dense attention core, whose matmuls
are the work XLA counts for the JAX model's default attention).
:func:`step_cost` prices any step on fake arguments, and
:func:`variant_costs` the registered variants
(:mod:`..analysis.variants`).  Measured times are lifted out of the
metrics registry (:func:`measured_from_registry`).

The artifact (:class:`Profile`) keeps the JAX schema
(``fdtpu-profile/v2``; v1 still loads)::

    {"schema": "fdtpu-profile/v2", "created_unix": ...,
     "fingerprint": "<16-hex topology digest>",
     "topology": {"torch", "platform", "device_kind",
                  "device_count", "process_count", "mesh"},
     "static": {"model": {"batch", "seqlen", "depth",
                          "block": {"flops", "bytes"},
                          "outer": {"flops", "bytes"},
                          "total": {"flops", "bytes"}} | null,
                "step":  {"flops", "bytes"} | null,
                "variants": {name: {"flops", "bytes"}}},
     "memory": {"state": {...}, "step": {...} | null,
                "variants": {name: {...}}},
     "comms": {"step": {"recorded": [...]},
               "variants": {name: {"recorded": [...]}}},
     "measured": {"phases": {...}, "step_seconds": {...},
                  "counters": {...}, "hbm": {...}, "pp_rows": [...]},
     "meta": {...}}

The topology block has ``"torch"`` where JAX has ``"jax"``, and the
fingerprint is :func:`.runs.topology_fingerprint`.  :meth:`Profile.verify`
refuses an artifact recorded on another topology (:class:`ProfileMismatch`).
Consumers: the training CLI's ``--profile-out`` (and
``Observation(profile_path=)``), the fit checker (``python -m
fluxdistributed_tpu_torch.fit``), and the pipeline planner
(``parallel.pp_plan.plan_from_profile``, ``--pp-plan PROFILE``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import Histogram, Registry, get_registry

__all__ = [
    "Profile",
    "ProfileMismatch",
    "bubble_report",
    "collect_profile",
    "describe_topology",
    "lm_layer_costs",
    "measured_from_registry",
    "modeled_bubble",
    "stage_costs_from_static",
    "step_cost",
    "variant_costs",
]

SCHEMA = "fdtpu-profile/v2"
#: schemas ``Profile.load`` accepts (v1 lacks the memory and comms
#: sections; every v1 key means the same in v2)
ACCEPTED_SCHEMAS = ("fdtpu-profile/v1", SCHEMA)


class ProfileMismatch(ValueError):
    """A profile's (or a plan's) topology fingerprint does not match the
    consuming process: its costs describe different hardware."""


def describe_topology(mesh=None) -> dict:
    """What :func:`.runs.topology_fingerprint` digests, readable, stored
    beside the digest so a refused artifact can say what differed."""
    import torch

    cuda = torch.cuda.is_available()
    dist = torch.distributed
    ranks = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    out = {"torch": torch.__version__,
           "platform": "cuda" if cuda else "cpu",
           "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
           "device_count": torch.cuda.device_count() if cuda else 1,
           "process_count": ranks}
    if mesh is not None:
        out["mesh"] = {k: int(v) for k, v in dict(mesh.shape).items()}
    return out


def _count(fn, args: Tuple[Any, ...]) -> dict:
    """``fn(*args)`` run once on fake tensors under the FLOP counter and
    the byte counter: ``{"flops", "bytes"}``."""
    from torch.utils.flop_counter import FlopCounterMode

    from .pricing import LiveBytes

    live = LiveBytes()
    with FlopCounterMode(display=False) as flops, live:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(live.bytes_accessed)}


def step_cost(fn, args: Tuple[Any, ...]) -> Optional[dict]:
    """FLOPs and bytes of one call of ``fn`` at ``args`` (fake tensors,
    built under :func:`.pricing.pricing`): ``{"flops", "bytes"}``, or
    ``None`` when the arguments are not fake (the JAX function returns
    None for a callable it cannot lower).  Nothing runs on a device."""
    from .pricing import _fake_args

    if not _fake_args(args):
        return None
    return _count(fn, args)


def _lm_clone(model, depth: int):
    """``model``'s architecture at ``depth``, on the meta device, with
    the dense attention core and no dropout; ``None`` for a model that
    cannot be rebuilt alone (an MoE model's ``moe_fn`` is bound to its
    mesh)."""
    import torch

    from ..fake import real
    from ..models.transformer_lm import TransformerLM

    cfg = getattr(model, "config", None)
    if not isinstance(model, TransformerLM) or cfg is None \
            or cfg.get("moe_every"):
        return None
    with real(), torch.device("meta"):
        return TransformerLM(**{**cfg, "depth": depth, "attn_fn": None,
                                "dropout": 0.0, "remat": False},
                             device="meta")


def _forward_cost(model, batch_size: int, seqlen: int, device) -> dict:
    import torch

    from .pricing import pricing

    with pricing(world=None, device=device) as pr:
        fake = pr.module(model)
        tokens = torch.zeros((batch_size, seqlen), dtype=torch.int64,
                             device=pr.device)
        with torch.no_grad():
            return _count(fake, (tokens,))


def lm_layer_costs(model, batch_size: int, seqlen: int,
                   device=None) -> Optional[dict]:
    """One decoder block's and the outer (embedding and head) forward
    cost of a ``TransformerLM`` at ``(batch_size, seqlen)``, by the depth
    difference ``cost(depth=2) - cost(depth=1)`` on the plain forward
    (the dense core), priced on fake tensors on ``device`` (default
    ``cuda``).  ``None`` when the model cannot be rebuilt alone (MoE)."""
    depth = int(getattr(model, "depth", 0))
    if depth < 1:
        return None
    m1, m2 = _lm_clone(model, 1), _lm_clone(model, 2)
    if m1 is None or m2 is None:
        return None
    c1 = _forward_cost(m1, batch_size, seqlen, device)
    c2 = _forward_cost(m2, batch_size, seqlen, device)
    block = {k: max(c2[k] - c1[k], 0.0) for k in c1}
    outer = {k: max(c1[k] - block[k], 0.0) for k in c1}
    return {
        "batch": int(batch_size),
        "seqlen": int(seqlen),
        "depth": depth,
        "block": block,
        "outer": outer,
        "total": {k: outer[k] + depth * block[k] for k in block},
    }


def variant_costs(names: Optional[Sequence[str]] = None,
                  device=None) -> Dict[str, Optional[dict]]:
    """:func:`step_cost` of every registered variant (default: all),
    built through the real paths on a fake world of 8 ranks; a program
    that cannot run fake prices to ``None``."""
    from ..analysis.variants import WORLD, build_variants
    from .memstats import _unpriceable
    from .pricing import pricing

    out: Dict[str, Optional[dict]] = {}
    with pricing(WORLD, device=device) as pr:
        for v in build_variants(names, pr):
            try:
                out[v.name] = step_cost(v.fn, v.args)
            except Exception as e:  # noqa: BLE001 — only the unpriceable
                if not _unpriceable(e):
                    raise
                out[v.name] = None
    return out


def measured_from_registry(registry: Optional[Registry] = None) -> dict:
    """The measured side out of a metrics registry: the per-phase
    histogram with its buckets, the per-item step histogram and the
    headline counters.  Reads snapshots only."""
    reg = registry or get_registry()
    out: dict = {}
    ph = reg.get("fdtpu_train_phase_seconds")
    if isinstance(ph, Histogram):
        out["phases"] = {lv[0]: cell for lv, cell in ph.series().items()
                         if lv and cell["count"]}
    st = reg.get("fdtpu_train_step_seconds")
    if isinstance(st, Histogram):
        cell = st.series().get(())
        if cell is not None and cell["count"]:
            out["step_seconds"] = cell
    counters = {}
    for name in ("fdtpu_train_steps_total", "fdtpu_train_oom_skipped_total"):
        v = reg.value(name)
        if v:
            counters[name] = v
    if counters:
        out["counters"] = counters
    return out


@dataclasses.dataclass
class Profile:
    """The versioned cost-profile artifact (schema in the module doc)."""

    fingerprint: str
    topology: dict = dataclasses.field(default_factory=dict)
    static: dict = dataclasses.field(default_factory=dict)
    #: the priced memory (state/step/variants); empty on v1 artifacts
    memory: dict = dataclasses.field(default_factory=dict)
    #: the collective ledger (step/variants); empty on v1 artifacts
    comms: dict = dataclasses.field(default_factory=dict)
    measured: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    schema: str = SCHEMA
    created_unix: float = 0.0

    def save(self, path: str) -> str:
        """Write the artifact (write, then rename: a cut-short run never
        leaves half a JSON behind)."""
        doc = dataclasses.asdict(self)
        doc["created_unix"] = self.created_unix or time.time()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "Profile":
        with open(path) as f:
            doc = json.load(f)
        schema = doc.get("schema")
        if schema not in ACCEPTED_SCHEMAS:
            raise ValueError(
                f"{path}: not a {'/'.join(ACCEPTED_SCHEMAS)} artifact "
                f"(schema={schema!r}) — regenerate it with this repo's "
                "profiler")
        fields = {f.name for f in dataclasses.fields(cls)}
        prof = cls(**{k: v for k, v in doc.items() if k in fields})
        # a loaded artifact keeps its recorded schema tag
        prof.schema = schema
        return prof

    def verify(self, mesh=None, tag: str = "") -> "Profile":
        """Raise :class:`ProfileMismatch` unless this artifact was
        recorded on the topology this process runs on (the digest of
        :func:`.runs.topology_fingerprint`: torch and CUDA versions, the
        card, the card and rank counts, the mesh shape, the tag).
        Returns self, so loads chain: ``Profile.load(p).verify(mesh)``."""
        from .runs import topology_fingerprint

        current = topology_fingerprint(mesh=mesh, tag=tag)
        if current != self.fingerprint:
            raise ProfileMismatch(
                f"profile fingerprint {self.fingerprint} does not match "
                f"this process ({current}): artifact topology "
                f"{self.topology} vs current {describe_topology(mesh)} — "
                "cost profiles do not transfer across topologies; "
                "re-collect on this one")
        return self


def _price_task_step(task, batch) -> dict:
    """The task's real step run once on fake copies of its state and
    ``batch`` (no device memory): its costs, memory and ledger."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..tree import tree_map
    from .pricing import price_step

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = lambda t: mode.from_tensor(t)  # noqa: E731
        st = task.state
        state = type(st)(params=tree_map(fake, st.params),
                         opt_state=tree_map(fake, st.opt_state),
                         model_state=tree_map(fake, st.model_state),
                         step=st.step)
        fbatch = {k: fake(v) for k, v in batch.items()}
        with FlopCounterMode(display=False) as flops:
            priced = price_step(task.step_fn, (state, fbatch))
    priced["flops"] = float(flops.get_total_flops())
    return priced


def collect_profile(task=None, registry: Optional[Registry] = None,
                    batch=None, meta: Optional[dict] = None) -> Profile:
    """A :class:`Profile` of a prepared or finished training task: the
    topology of its mesh, the static costs of its model
    (:func:`lm_layer_costs`, token batches) and of its real step, the
    step's priced memory and collective ledger, and the measured side of
    the registry.  ``batch`` gives the step's argument shapes (the
    trainer passes its last batch).  The step is priced on fake copies
    of the state and the batch when it runs on one device, one step a
    call; a step over a process group (its collectives need the group
    the run holds) or a device loop is not, and ``memory.step_note``
    says so."""
    from . import memstats
    from .runs import topology_fingerprint

    mesh = getattr(task, "mesh", None)
    prof = Profile(
        fingerprint=topology_fingerprint(mesh=mesh),
        topology=describe_topology(mesh),
        measured=measured_from_registry(registry),
        meta=dict(meta or {}),
    )
    static: dict = {"model": None, "step": None, "variants": {}}
    memory: dict = {"state": None, "step": None, "variants": {}}
    comms: dict = {"step": {}, "variants": {}}
    model = getattr(task, "model", None)
    if model is not None:
        prof.meta.setdefault("model", type(model).__name__)
    tokens = batch.get("tokens") if isinstance(batch, dict) else None
    device = getattr(task, "device", None)
    if model is not None and tokens is not None:
        shape = tuple(tokens.shape)
        if len(shape) >= 2:
            # a device-loop item stacks K batches: a step's shape is the
            # trailing two dims
            static["model"] = lm_layer_costs(model, shape[-2], shape[-1],
                                             device=device)
    if task is not None:
        memory["state"] = memstats.state_bytes(task.state)
    if task is not None and batch is not None:
        if mesh is None and getattr(task, "steps_per_call", 1) == 1:
            priced = _price_task_step(task, batch)
            static["step"] = {"flops": priced["flops"],
                              "bytes": float(priced["bytes_accessed"])}
            memory["step"] = priced["memory"]
            comms["step"]["recorded"] = priced["comms"]
        else:
            memory["step_note"] = (
                "step not priced: it runs over a process group or as a "
                "device loop; price such steps with python -m "
                "fluxdistributed_tpu_torch.fit --collect or "
                "parallel.layout.price_layouts")
    prof.static, prof.memory, prof.comms = static, memory, comms
    hbm = memstats.hbm_summary()
    if hbm.get("available"):
        prof.measured["hbm"] = hbm
    return prof


# -- modeled vs measured bubble accounting ------------------------------------

def modeled_bubble(stage_costs: Sequence[float], num_microbatches: int,
                   schedule: str = "1f1b") -> float:
    """The pipeline bubble the schedule model predicts for these
    per-stage costs: ``1 - M * mean(stage) / ((M + drain) * max(stage))``
    with ``drain = S - 1``, or ``(S - 1) / 3`` under the zero-bubble
    ``"zb"`` accounting (ZB-H1: the weight-grad ticks fill the drain).
    Uniform stages give ``(S - 1) / (M + S - 1)``."""
    S = len(stage_costs)
    if S < 1:
        return 0.0
    mx = max(stage_costs)
    if mx <= 0:
        return 0.0
    mean = sum(stage_costs) / S
    M = num_microbatches
    drain = (S - 1) / 3.0 if schedule == "zb" else float(S - 1)
    return 1.0 - (M * mean) / ((M + drain) * mx)


def stage_costs_from_static(model_costs: dict, S: int,
                            boundaries: Optional[Sequence[int]] = None,
                            ) -> List[float]:
    """A profile's per-block static costs summed into S contiguous
    stages: the uniform placement ``lm_pp`` uses by default, or a
    planner's ``boundaries`` (S + 1 cut points); the outer cost split
    between the first and last stages, and an explicit
    ``static.model.blocks`` list taking precedence over the depth-
    difference ``block`` cost."""
    from ..parallel.pp_plan import stage_costs_for, uniform_boundaries

    depth = int(model_costs["depth"])
    blocks = model_costs.get("blocks")
    if blocks:
        block_costs = [float(b["flops"]) for b in blocks]
    else:
        block_costs = [float(model_costs["block"]["flops"])] * depth
    outer = float(model_costs["outer"]["flops"])
    if boundaries is None:
        boundaries = uniform_boundaries(depth, S)
    return list(stage_costs_for(block_costs, boundaries,
                                (outer / 2, outer / 2)))


def bubble_report(profile: Profile) -> List[dict]:
    """Modeled against measured bubble fractions of an artifact's
    ``measured.pp_rows`` (rows of ``{"M", "S", "step_ms"}``, optionally
    tagged with ``schedule`` and ``boundaries``).  Within each
    configuration a least-squares fit ``t(M) = a M + b`` splits the
    per-microbatch cost ``a`` from the fixed fill, drain and dispatch
    cost ``b``; a row's measured bubble is ``1 - a M / t``.  The modeled
    side is :func:`modeled_bubble` of the static stage costs (uniform
    stages without them)."""
    rows = profile.measured.get("pp_rows") or []
    if len(rows) < 2:
        raise ValueError(
            "bubble accounting needs >= 2 measured M rows in the "
            "artifact (measured.pp_rows)")
    default_sched = (profile.meta or {}).get("schedule")
    groups: Dict[tuple, list] = {}
    for r in rows:
        key = (r.get("schedule", default_sched),
               tuple(r["boundaries"]) if r.get("boundaries") else None)
        groups.setdefault(key, []).append(r)
    model_costs = (profile.static or {}).get("model")
    out = []
    for (sched, bounds), grp in groups.items():
        if len(grp) < 2:
            raise ValueError(
                f"bubble accounting needs >= 2 measured M rows per "
                f"configuration; (schedule={sched}, boundaries={bounds}) "
                "has one — extend the M sweep")
        ms = [float(r["M"]) for r in grp]
        ts = [float(r["step_ms"]) for r in grp]
        n = len(grp)
        mean_m, mean_t = sum(ms) / n, sum(ts) / n
        denom = sum((m - mean_m) ** 2 for m in ms)
        a = (sum((m - mean_m) * (t - mean_t)
                 for m, t in zip(ms, ts)) / denom if denom else 0.0)
        b = mean_t - a * mean_m
        for r, t in zip(grp, ts):
            S, M = int(r["S"]), int(r["M"])
            stages = (stage_costs_from_static(model_costs, S,
                                              boundaries=bounds)
                      if model_costs else [1.0] * S)
            measured = (min(max(1.0 - (a * M) / t, 0.0), 1.0)
                        if t > 0 else 0.0)
            row = {
                "M": M, "S": S,
                "step_ms": round(t, 2),
                "modeled_bubble": round(
                    modeled_bubble(
                        stages, M,
                        schedule="zb" if sched == "zb" else "1f1b"), 4),
                "measured_bubble": round(measured, 4),
                "fit_ms_per_microbatch": round(a, 4),
                "fit_fixed_ms": round(b, 4),
            }
            if sched is not None:
                row["schedule"] = sched
            if bounds is not None:
                row["boundaries"] = list(bounds)
            out.append(row)
    return out
