"""Profile-guided pipeline planner: stage boundaries from per-block costs.

Port of ``fluxdistributed_tpu/parallel/pp_plan.py``, pure Python as
there.  The lockstep pipeline schedule is bottlenecked by its most
expensive stage (every tick costs ``max(stage)``), and the embedding and
the head run on the first and the last pipe device, so a uniform block
split is not balanced even on a homogeneous stack.  :func:`plan_stages`
places non-uniform stage boundaries that minimise the modeled max-stage
cost under an optional per-device memory budget, and returns a
:class:`PipelinePlan` with the modeled bubble of the planned and of the
uniform split.  ``prepare_training(spmd="pp"|"pp_1f1b", pp_plan=...)``
and the training CLI's ``--pp-plan`` run the boundaries as padded
``chunk_stages`` splits.

Partitioning is an exact DP over contiguous partitions minimising
``(max stage cost, sum of squared stage costs)``: flat costs give the
uniform split exactly.  A plan saved by the JAX package (the
``fdtpu-pp-plan/v1`` schema) loads here, and a plan derived from a
profile carries the profile's topology fingerprint, which
:meth:`PipelinePlan.verify` holds against this process's
(:func:`..obs.runs.topology_fingerprint`).

The costs come from a cost-profile artifact (:func:`plan_from_profile`,
``--pp-plan PROFILE``) or are priced fresh from the model
(:func:`plan_from_model`, ``--pp-plan auto``: the depth difference of
:func:`..obs.profile.lm_layer_costs` on fake tensors, and the exact
parameter bytes of each block).  The port's costs are PyTorch's FLOP
count (matmuls and attention), XLA's count also holds elementwise work:
the same model can place other boundaries here than in the JAX
package, while the same costs place the same ones.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence, Tuple

from ..obs.profile import ProfileMismatch, describe_topology, modeled_bubble

__all__ = [
    "PipelinePlan",
    "PlanError",
    "ProfileMismatch",
    "modeled_bubble",
    "plan_from_model",
    "plan_from_profile",
    "plan_stages",
    "resolve_plan",
    "stage_costs_for",
    "uniform_boundaries",
]

SCHEMA = "fdtpu-pp-plan/v1"

class PlanError(ValueError):
    """No feasible stage placement for the given costs/budget."""


def uniform_boundaries(depth: int, S: int) -> Tuple[int, ...]:
    """The uniform split's cut points: ``depth`` blocks dealt round-floor
    with the remainder on the leading stages."""
    counts = [depth // S + (1 if i < depth % S else 0) for i in range(S)]
    out = [0]
    for c in counts:
        out.append(out[-1] + c)
    return tuple(out)


def stage_costs_for(block_costs: Sequence[float],
                    boundaries: Sequence[int],
                    outer: Tuple[float, float] = (0.0, 0.0)
                    ) -> Tuple[float, ...]:
    """Per-stage cost sums for these cut points, with the outer costs
    folded into the first and last stages (the embedding runs at logical
    stage 0, the head at the last)."""
    S = len(boundaries) - 1
    out = []
    for s in range(S):
        c = float(sum(block_costs[boundaries[s]:boundaries[s + 1]]))
        if s == 0:
            c += float(outer[0])
        if s == S - 1:
            c += float(outer[1])
        out.append(c)
    return tuple(out)


@dataclasses.dataclass
class PipelinePlan:
    """Planner output: where to cut the stack, and what the model says
    that placement buys.

    ``boundaries`` — S+1 cut points (``boundaries[s]:boundaries[s+1]``
    is stage s's block range); ``stage_costs`` — modeled per-stage cost
    at those cuts (outer folded in); ``modeled_bubble`` vs
    ``uniform_bubble`` — the schedule model's bubble fraction for the
    planned and the uniform split at ``num_microbatches``;
    ``stage_bytes`` — per-stage memory estimate; ``fingerprint`` —
    topology digest of the profile the costs came from ("" for
    synthetic or explicit costs)."""

    boundaries: Tuple[int, ...]
    stage_costs: Tuple[float, ...]
    modeled_bubble: float
    uniform_bubble: float
    num_microbatches: int
    schedule: str = "1f1b"
    stage_bytes: Tuple[float, ...] = ()
    memory_budget: Optional[float] = None
    fingerprint: str = ""
    meta: dict = dataclasses.field(default_factory=dict)
    schema: str = SCHEMA

    def __post_init__(self):
        self.boundaries = tuple(int(b) for b in self.boundaries)
        self.stage_costs = tuple(float(c) for c in self.stage_costs)
        self.stage_bytes = tuple(float(b) for b in self.stage_bytes)

    @property
    def S(self) -> int:
        return len(self.boundaries) - 1

    @property
    def depth(self) -> int:
        return self.boundaries[-1]

    @property
    def counts(self) -> Tuple[int, ...]:
        """Blocks hosted per pipe device."""
        return tuple(self.boundaries[s + 1] - self.boundaries[s]
                     for s in range(self.S))

    @property
    def is_uniform(self) -> bool:
        return self.boundaries == uniform_boundaries(self.depth, self.S)

    def save(self, path: str) -> str:
        doc = dataclasses.asdict(self)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "PipelinePlan":
        with open(path) as f:
            doc = json.load(f)
        schema = doc.get("schema")
        if schema != SCHEMA:
            raise ValueError(
                f"{path}: not a {SCHEMA} artifact (schema={schema!r}) — "
                "regenerate it with parallel.pp_plan")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in fields})

    def verify(self, mesh=None, tag: str = "") -> "PipelinePlan":
        """Reject cross-topology reuse: a plan derived from a profile
        measured elsewhere must not drive placement here.  Plans with no
        recorded fingerprint (synthetic or explicit costs) pass."""
        if not self.fingerprint:
            return self
        from ..obs.runs import topology_fingerprint

        current = topology_fingerprint(mesh=mesh, tag=tag)
        if current != self.fingerprint:
            raise ProfileMismatch(
                f"pipeline plan fingerprint {self.fingerprint} does not "
                f"match this process ({current}): the profile it was "
                f"derived from describes different hardware (current "
                f"topology {describe_topology(mesh)}) — re-plan from a "
                "profile collected here")
        return self

    def verify_source_topology(self) -> "PipelinePlan":
        """Re-check the fingerprint against the mesh the source profile
        recorded (``meta.topology_mesh``) on this process.  A recorded
        mesh this process cannot hold (its sizes do not multiply to the
        ranks here) is the cross-topology case, refused with
        :class:`ProfileMismatch`."""
        if not self.fingerprint:
            return self
        shape = (self.meta or {}).get("topology_mesh") or None
        mesh = None
        if shape:
            import torch.distributed as dist

            shape = {k: int(v) for k, v in shape.items()}
            ranks = dist.get_world_size() if dist.is_initialized() else 1
            if math.prod(shape.values()) != ranks:
                raise ProfileMismatch(
                    f"pipeline plan was derived from a profile recorded "
                    f"on mesh {shape}, which this process cannot rebuild "
                    f"({ranks} rank(s)) — re-plan from a profile "
                    "collected here")
            mesh = _Shape(shape)
        return self.verify(mesh)

    def describe(self) -> str:
        """One-paragraph human summary for logs."""
        mx = max(self.stage_costs) if self.stage_costs else 0.0
        mem = (f", peak stage bytes {max(self.stage_bytes):.3e}"
               if self.stage_bytes else "")
        return (f"pp plan: S={self.S} depth={self.depth} "
                f"M={self.num_microbatches} schedule={self.schedule} "
                f"counts={list(self.counts)} max-stage={mx:.3e} "
                f"bubble {self.modeled_bubble:.4f} "
                f"(uniform {self.uniform_bubble:.4f}){mem}")


@dataclasses.dataclass(frozen=True)
class _Shape:
    """A mesh shape on its own: all the fingerprint reads of a mesh."""

    shape: dict


def _partition(block_costs: Sequence[float], S: int,
               outer: Tuple[float, float], feasible) -> Tuple[int, ...]:
    """Exact DP over contiguous partitions of ``depth`` blocks into S
    stages minimising ``(max stage cost, sum of squared stage costs)``
    lexicographically, restricted to ``feasible(s, i, j)`` segments.
    Every stage gets >= 1 block.  Returns boundaries or raises
    :class:`PlanError`."""
    depth = len(block_costs)
    prefix = [0.0]
    for c in block_costs:
        prefix.append(prefix[-1] + float(c))

    def seg(s: int, i: int, j: int) -> float:
        c = prefix[j] - prefix[i]
        if s == 0:
            c += outer[0]
        if s == S - 1:
            c += outer[1]
        return c

    INF = (math.inf, math.inf)
    best = [[INF] * (depth + 1) for _ in range(S)]
    parent = [[-1] * (depth + 1) for _ in range(S)]
    for j in range(1, depth - S + 2):
        if feasible(0, 0, j):
            c = seg(0, 0, j)
            best[0][j] = (c, c * c)
            parent[0][j] = 0
    for s in range(1, S):
        for j in range(s + 1, depth - (S - 1 - s) + 1):
            cand = INF
            arg = -1
            # descending i: on full ties the latest cut wins, which is
            # uniform_boundaries' remainder-on-leading-stages layout
            for i in range(j - 1, s - 1, -1):
                prev = best[s - 1][i]
                if math.isinf(prev[0]) or not feasible(s, i, j):
                    continue
                c = seg(s, i, j)
                key = (max(prev[0], c), prev[1] + c * c)
                if key < cand:
                    cand, arg = key, i
            best[s][j] = cand
            parent[s][j] = arg
    if math.isinf(best[S - 1][depth][0]):
        raise PlanError(
            f"no feasible placement of {depth} blocks over {S} stages "
            "under the memory budget — raise the budget, shrink the "
            "model, or add pipe devices")
    bounds = [depth]
    j = depth
    for s in range(S - 1, -1, -1):
        j = parent[s][j]
        bounds.append(j)
    return tuple(reversed(bounds))


def plan_stages(
    block_costs: Sequence[float],
    S: int,
    num_microbatches: int,
    outer: Tuple[float, float] = (0.0, 0.0),
    schedule: str = "1f1b",
    block_bytes: Optional[Sequence[float]] = None,
    outer_bytes: Tuple[float, float] = (0.0, 0.0),
    activation_bytes: float = 0.0,
    memory_budget: Optional[float] = None,
    fingerprint: str = "",
    meta: Optional[dict] = None,
) -> PipelinePlan:
    """Place stage boundaries for ``len(block_costs)`` blocks over S pipe
    devices minimising the modeled max-stage cost (ties broken toward
    balance, so flat costs give the uniform split exactly).

    ``outer = (embed_cost, head_cost)`` is folded into the first and
    last stages.  ``block_bytes``/``outer_bytes``/``activation_bytes``
    feed the per-stage memory estimate: stage params plus the 1F1B input
    ring (``min(S, M)`` activation slots per hosted block).
    ``memory_budget`` (bytes per device) makes over-budget segments
    infeasible."""
    depth = len(block_costs)
    if S < 1:
        raise PlanError(f"need >= 1 stage, got {S}")
    if depth < S:
        raise PlanError(
            f"{depth} blocks cannot fill {S} pipeline stages (every "
            "stage needs >= 1 block)")
    if num_microbatches < 1:
        raise PlanError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    if any(c < 0 for c in block_costs):
        raise PlanError("block costs must be non-negative")

    bbytes = [float(b) for b in (block_bytes or [0.0] * depth)]
    if len(bbytes) != depth:
        raise PlanError(
            f"block_bytes has {len(bbytes)} entries for {depth} blocks")
    bprefix = [0.0]
    for b in bbytes:
        bprefix.append(bprefix[-1] + b)
    ring = min(S, num_microbatches)

    def stage_mem(s: int, i: int, j: int) -> float:
        m = bprefix[j] - bprefix[i]
        if s == 0:
            m += outer_bytes[0]
        if s == S - 1:
            m += outer_bytes[1]
        return m + ring * (j - i) * activation_bytes

    def feasible(s: int, i: int, j: int) -> bool:
        return memory_budget is None or stage_mem(s, i, j) <= memory_budget

    boundaries = _partition(block_costs, S, outer, feasible)
    costs = stage_costs_for(block_costs, boundaries, outer)
    uni = uniform_boundaries(depth, S)
    uni_costs = stage_costs_for(block_costs, uni, outer)
    return PipelinePlan(
        boundaries=boundaries,
        stage_costs=costs,
        modeled_bubble=modeled_bubble(costs, num_microbatches,
                                      schedule=schedule),
        uniform_bubble=modeled_bubble(uni_costs, num_microbatches,
                                      schedule=schedule),
        num_microbatches=num_microbatches,
        schedule=schedule,
        stage_bytes=tuple(
            stage_mem(s, boundaries[s], boundaries[s + 1])
            for s in range(S)),
        memory_budget=memory_budget,
        fingerprint=fingerprint,
        meta=dict(meta or {}),
    )


def plan_from_profile(profile, S: int, num_microbatches: int,
                      schedule: str = "1f1b",
                      memory_budget: Optional[float] = None,
                      activation_bytes: float = 0.0) -> PipelinePlan:
    """Plan from a cost-profile artifact (:class:`..obs.profile.Profile`):
    its per-block static costs (the explicit ``static.model.blocks``
    list when a producer recorded per-block skew, else the depth-
    difference ``block`` cost ``depth`` times), the outer cost split
    between the end stages.  Verify an artifact from disk first
    (:meth:`~..obs.profile.Profile.verify`); the plan carries its
    fingerprint.  The artifact has no model width, so the activation
    ring's term comes from the caller (``activation_bytes``: one
    microbatch's activation, ``mb x seqlen x dim x 4``;
    :func:`resolve_plan` derives it from the model); left at 0 a
    ``memory_budget`` bounds stage param bytes only."""
    model_costs = (profile.static or {}).get("model")
    if not model_costs:
        raise PlanError(
            "profile artifact has no static model costs "
            "(static.model is null) — re-collect with a token batch "
            "so lm_layer_costs can price the model")
    depth = int(model_costs["depth"])
    blocks = model_costs.get("blocks")
    if blocks:
        block_costs = [float(b["flops"]) for b in blocks]
        block_bytes = [float(b["bytes"]) for b in blocks]
    else:
        block_costs = [float(model_costs["block"]["flops"])] * depth
        block_bytes = [float(model_costs["block"]["bytes"])] * depth
    outer_f = float(model_costs["outer"]["flops"])
    outer_b = float(model_costs["outer"]["bytes"])
    return plan_stages(
        block_costs, S, num_microbatches,
        outer=(outer_f / 2, outer_f / 2),
        schedule=schedule,
        block_bytes=block_bytes,
        outer_bytes=(outer_b / 2, outer_b / 2),
        activation_bytes=activation_bytes,
        memory_budget=memory_budget,
        fingerprint=profile.fingerprint,
        meta={"source": "profile", "batch": model_costs.get("batch"),
              "seqlen": model_costs.get("seqlen"),
              "topology_mesh": (profile.topology or {}).get("mesh")},
    )


def plan_from_model(model, S: int, num_microbatches: int,
                    batch_size: int, seqlen: int,
                    schedule: str = "1f1b",
                    memory_budget: Optional[float] = None,
                    device=None) -> PipelinePlan:
    """Plan from fresh static costs (``--pp-plan auto``): the model's
    per-block and outer costs priced on fake tensors on ``device``
    (default ``cuda``; :func:`..obs.profile.lm_layer_costs`, no device
    memory), the memory estimate sized exactly: each block's parameter
    bytes off the model, one microbatch's activation from its width."""
    from ..obs.profile import lm_layer_costs

    costs = lm_layer_costs(model, batch_size, seqlen, device=device)
    if costs is None:
        raise PlanError(
            f"{type(model).__name__} could not be priced for layer costs "
            "(lm_layer_costs returned None) — pass an explicit profile "
            "artifact instead")
    depth = int(costs["depth"])
    block_bytes = [0.0] * depth
    outer_bytes = 0.0
    for name, p in model.named_parameters():
        nbytes = float(p.numel() * p.element_size())
        parts = name.split(".")
        if parts[0] == "blocks":
            block_bytes[int(parts[1])] += nbytes
        else:
            outer_bytes += nbytes
    mb = max(batch_size // num_microbatches, 1)
    act_bytes = float(mb * seqlen * int(model.dim) * 4)  # f32 ring slots
    return plan_stages(
        [float(costs["block"]["flops"])] * depth, S, num_microbatches,
        outer=(float(costs["outer"]["flops"]) / 2,
               float(costs["outer"]["flops"]) / 2),
        schedule=schedule,
        block_bytes=block_bytes,
        outer_bytes=(outer_bytes / 2, outer_bytes / 2),
        activation_bytes=act_bytes,
        memory_budget=memory_budget,
        meta={"source": "model", "model": type(model).__name__,
              "batch": int(batch_size), "seqlen": int(seqlen)},
    )


def resolve_plan(source: str, S: int, num_microbatches: int,
                 schedule: str = "1f1b", model=None,
                 batch_size: Optional[int] = None,
                 seqlen: Optional[int] = None,
                 memory_budget: Optional[float] = None,
                 verify: bool = True, device=None) -> PipelinePlan:
    """Resolve a ``--pp-plan`` source, the one implementation behind the
    training CLI's flag: ``"auto"`` (fresh costs of ``model`` at
    ``batch_size``/``seqlen``, the whole batch of a data row, which the
    planner divides by M for the activation ring; priced on ``device``),
    a saved plan JSON, or a cost-profile artifact (told apart by its
    ``schema``).  ``verify=True`` re-checks a profile-derived
    fingerprint against this process
    (:meth:`PipelinePlan.verify_source_topology`, raising
    :class:`ProfileMismatch`); ``verify=False`` is for offline analysis
    of a foreign artifact.  A plan for another pipe axis size or another
    depth is refused here, before anything is built."""
    if source == "auto":
        if model is None or batch_size is None or seqlen is None:
            raise PlanError(
                "resolve_plan('auto') needs model, batch_size and seqlen "
                "to price fresh static costs")
        plan = plan_from_model(
            model, S, num_microbatches, batch_size=batch_size,
            seqlen=seqlen, schedule=schedule, memory_budget=memory_budget,
            device=device)
    else:
        with open(source) as f:
            doc = json.load(f)
        if doc.get("schema") == SCHEMA:
            plan = PipelinePlan.load(source)
        else:
            from ..obs.profile import Profile

            # the artifact lacks the model width: derive the ring's
            # activation term here when the caller gave the model
            dim = int(getattr(model, "dim", 0) or 0) if model else 0
            act_bytes = (
                float(max(batch_size // num_microbatches, 1)
                      * seqlen * dim * 4)
                if dim and batch_size and seqlen else 0.0)
            plan = plan_from_profile(
                Profile.load(source), S, num_microbatches,
                schedule=schedule, memory_budget=memory_budget,
                activation_bytes=act_bytes)
        if verify:
            plan.verify_source_topology()
    if plan.S != S:
        raise PlanError(
            f"plan places {plan.S} stages but this run's pipe axis has "
            f"{S} — re-plan for this mesh")
    if model is not None and plan.depth != int(getattr(model, "depth", 0)):
        raise PlanError(
            f"plan partitions {plan.depth} blocks but the model has "
            f"depth {getattr(model, 'depth', 0)} — re-plan for this model")
    return plan
