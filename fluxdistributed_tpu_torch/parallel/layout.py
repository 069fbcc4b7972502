"""dp x fsdp x tp layouts and the layout picker: "fit this model on
these ranks" as one name, or as ``auto``.

Port of ``fluxdistributed_tpu/parallel/layout.py``.
A :class:`Layout` is three axis sizes on the
:func:`..mesh.make_mesh_3d` mesh ``(data, fsdp, model)``:

* ``dp``: replicas (batch shards, parameters replicated);
* ``fsdp``: ZeRO-style parameter and optimizer sharding (the batch
  splits over ``data`` and ``fsdp`` jointly);
* ``tp``: the Megatron model axis (the model family's rule table picks
  the dims).

:func:`state_specs_for` derives the state's specs from the rules engine
(:mod:`.rules`): the family's table for the model axis, the FSDP overlay
(:func:`.rules.with_fsdp`) on every large leaf's leftover dim, the
optimizer state following its param, and the tree validated before
anything is placed.  The step is the sharded DP step
(:func:`.fsdp.make_train_step_sharded`) with the batch over ``(data,
fsdp)`` and the model axis through the tensor-parallel modules
(:mod:`.tp`).

The picker (:func:`price_layouts`, :func:`pick`, the CLI's ``--layout
auto``) prices each candidate's real train step once on fake tensors
over a fake world of the candidate's ranks (:mod:`..obs.pricing`; no
device memory): its priced peak (rank 0's), its collective ledger
(:mod:`..obs.comms`) per mesh axis, or ``invalid`` with the reason.  It
ranks the candidates by headroom under a budget through
:func:`..obs.memstats.rank_memory`, the fit checker's ranking, and among
those that fit takes the fewest bytes moved a step, then the most
headroom; with no budget the ledger alone ranks.  A process that holds a
real process group prices in a child process of its own
(:func:`price_layouts_in_child`): a process has one default group.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional, Sequence, Tuple

from ..mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, Mesh

__all__ = [
    "LAYOUT_PRESETS",
    "Layout",
    "LayoutError",
    "PickReport",
    "layout_candidates",
    "pick",
    "price_layouts",
    "price_layouts_in_child",
    "resolve_layout",
    "state_specs_for",
]


class LayoutError(ValueError):
    """A layout cannot be built on this topology."""


@dataclasses.dataclass(frozen=True)
class Layout:
    """One point of the dp x fsdp x tp grid; ``dp * fsdp * tp`` must
    equal the rank count of the mesh it is built over."""

    name: str
    dp: int = 1
    fsdp: int = 1
    tp: int = 1

    @property
    def sizes(self) -> dict:
        return {DATA_AXIS: self.dp, FSDP_AXIS: self.fsdp,
                MODEL_AXIS: self.tp}

    @property
    def batch_axes(self) -> Tuple[str, str]:
        """The batch splits over data AND fsdp jointly."""
        return (DATA_AXIS, FSDP_AXIS)

    @property
    def batch_shards(self) -> int:
        return self.dp * self.fsdp

    def devices(self) -> int:
        return self.dp * self.fsdp * self.tp

    def build_mesh(self, device=None) -> Mesh:
        from ..mesh import make_mesh_3d

        return make_mesh_3d(self.dp, self.fsdp, self.tp, device=device)

    def validate_mesh(self, mesh: Mesh) -> None:
        """A caller's mesh must carry exactly this layout's axis
        sizes."""
        got = {k: int(v) for k, v in mesh.shape.items()}
        if got != self.sizes:
            raise LayoutError(
                f"mesh axes {got} do not match layout {self.name!r} "
                f"{self.sizes} — build the mesh with layout.build_mesh() "
                "or mesh.make_mesh_3d")

    def describe(self) -> str:
        return (f"{self.name}: dp={self.dp} x fsdp={self.fsdp} x "
                f"tp={self.tp}")


def _even_split(n: int) -> int:
    """The smallest non-trivial factor of ``n`` (2 for even counts)."""
    for k in (2, 3, 5, 7):
        if n % k == 0:
            return k
    return 1


#: preset name -> (ranks -> Layout | None); None: no such preset at
#: that rank count
LAYOUT_PRESETS: dict = {
    "dp": lambda n: Layout("dp", dp=n),
    "fsdp": lambda n: Layout("fsdp", fsdp=n) if n > 1 else None,
    "tp": lambda n: Layout("tp", tp=n) if n > 1 else None,
    "dp_fsdp": lambda n: (
        Layout("dp_fsdp", dp=_even_split(n), fsdp=n // _even_split(n))
        if n >= 4 and _even_split(n) > 1 else None),
    "fsdp_tp": lambda n: (
        Layout("fsdp_tp", fsdp=n // _even_split(n), tp=_even_split(n))
        if n >= 4 and _even_split(n) > 1 else None),
    "dp_fsdp_tp": lambda n: (
        Layout("dp_fsdp_tp", dp=2, fsdp=n // 4, tp=2)
        if n >= 8 and n % 4 == 0 else None),
}


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_layout(spec, ndev: Optional[int] = None) -> Layout:
    """A Layout from a Layout (checked against the rank count) or a
    preset name.  ``ndev`` defaults to the ranks of the default group
    (1 without one).  ``"auto"`` is no preset: :func:`pick` chooses
    from a model and a batch (the CLI's ``--layout auto``)."""
    n = ndev if ndev is not None else _world()
    if isinstance(spec, Layout):
        if spec.devices() != n:
            raise LayoutError(
                f"layout {spec.describe()} covers {spec.devices()} devices "
                f"but the topology has {n}")
        return spec
    if isinstance(spec, str):
        if spec == "auto":
            raise LayoutError(
                "layout 'auto' is the picker, not a preset: "
                "parallel.layout.pick(model, batch, optimizer) chooses a "
                "Layout (the training CLI's --layout auto)")
        fn = LAYOUT_PRESETS.get(spec)
        if fn is None:
            raise LayoutError(
                f"unknown layout preset {spec!r} (known: "
                f"{sorted(LAYOUT_PRESETS)}, or pass a Layout)")
        lay = fn(n)
        if lay is None:
            raise LayoutError(f"layout preset {spec!r} does not exist on "
                              f"{n} device(s)")
        return lay
    raise TypeError(f"layout must be a Layout or preset name, got "
                    f"{type(spec).__name__}")


def layout_candidates(ndev: Optional[int] = None) -> list:
    """Every preset that exists at this rank count."""
    n = ndev if ndev is not None else _world()
    return [lay for lay in (fn(n) for fn in LAYOUT_PRESETS.values())
            if lay is not None]


def state_specs_for(model, state, layout: Layout, mesh: Mesh,
                    min_size: Optional[int] = None):
    """The rule-derived ``TrainState`` of specs of ``model`` under
    ``layout``: the family's table for the model axis (the empty table
    when ``tp == 1``), the FSDP overlay over ``fsdp`` (when ``fsdp >
    1``), the optimizer state following its param; validated (axes,
    divisibility) before anything is placed.  A ``tp > 1`` layout for a
    family without a tensor-parallel table is refused: the model axis
    would replicate everything."""
    from . import rules

    kw = {} if min_size is None else {"min_size": min_size}
    table = rules.rules_for_model(model, tp=layout.tp > 1)
    if layout.tp > 1 and not table:
        raise LayoutError(
            f"layout {layout.name!r} has a model axis (tp={layout.tp}) but "
            f"{type(model).__name__} has no tensor-parallel rule table — "
            "every leaf would replicate over it.  Use a dp/fsdp layout, or "
            "register a table in parallel/rules.py")
    p_specs = rules.match_partition_rules(table, state.params, mesh=mesh,
                                          **kw)
    if layout.fsdp > 1:
        p_specs = rules.with_fsdp(p_specs, state.params, mesh,
                                  axis=FSDP_AXIS, **kw)
    spec_state = rules.train_state_specs(state, p_specs)
    rules.validate_specs(spec_state, state, mesh,
                         where=f"layout:{layout.name}")
    return spec_state


# -- the picker -----------------------------------------------------------------


@dataclasses.dataclass
class PickReport:
    """What the picker decided and why: the artifact the CLI prints and
    writes (``--layout-report``)."""

    chosen: Optional[Layout]
    rows: list
    budget_bytes: Optional[float]
    reason: str

    def to_json(self) -> dict:
        return {
            "schema": "fdtpu-layout-pick/v1",
            "chosen": self.chosen.name if self.chosen else None,
            "chosen_sizes": self.chosen.sizes if self.chosen else None,
            "budget_bytes": self.budget_bytes,
            "reason": self.reason,
            "rows": self.rows,
        }

    def save(self, path: str) -> None:
        import os

        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def describe(self) -> str:
        lines = []
        if self.budget_bytes is not None:
            lines.append(
                f"layout pick: per-device HBM budget "
                f"{self.budget_bytes:.3e} bytes")
        else:
            lines.append(
                "layout pick: NO HBM budget (no card reports its memory and "
                "none was passed) — ranked by collective bytes only")
        for r in self.rows:
            peak = (f"peak {r['peak_bytes']:>13,}"
                    if r.get("peak_bytes") is not None
                    else "peak   unavailable")
            fits = {True: "FITS", False: "DOES NOT FIT",
                    None: "fit unknown"}[r.get("fits")]
            if r.get("comms_bytes") is not None:
                comms = f"collective bytes/step {r['comms_bytes']:,}"
            elif "invalid" in r:
                comms = f"invalid: {r['invalid']}"
            else:
                # priced, but the ledger is missing: a fitting candidate
                # must never read as "invalid"
                comms = ("collective ledger unavailable"
                         + (f" ({r['comms_unavailable']})"
                            if r.get("comms_unavailable") else ""))
            mark = " <== chosen" if (
                self.chosen and r["layout"] == self.chosen.name) else ""
            lines.append(
                f"  {r['layout']:<12} {peak}  {fits:<13} {comms}{mark}")
        lines.append(f"layout pick: {self.reason}")
        return "\n".join(lines)


def _loss_fn_for(model, loss_fn=None):
    """The step's loss of (a priced copy of) ``model``: ``loss_fn(model)``
    when the caller gave a factory, else the LM's token loss or the
    image adapter over the batch's ranks."""
    from ..models import TransformerLM, lm_loss_fn

    if loss_fn is not None:
        return loss_fn(model)
    if isinstance(model, TransformerLM):
        return lm_loss_fn(model)
    return None  # prepare-style default: the image adapter


def _shape_dtype(v) -> tuple:
    import numpy as np

    if isinstance(v, tuple):
        return tuple(int(d) for d in v[0]), v[1]
    return tuple(int(d) for d in np.shape(v)), getattr(v, "dtype", None)


def _price_one(pr, model, batch_struct: dict, optimizer, lay: Layout,
               loss_fn, min_size) -> dict:
    """One candidate's row: its real step built on a fake copy of the
    model and priced once (see :func:`price_layouts`)."""
    from ..obs.comms import total_bytes
    from ..obs.pricing import price_step
    from ..ops import logitcrossentropy
    from ..train.trainer import _sharded_state
    from .dp import module_loss_fn
    from .fsdp import make_train_step_sharded

    mesh = lay.build_mesh(device=pr.device)
    fmodel = pr.module(model)
    lf = _loss_fn_for(fmodel, loss_fn)
    if lf is None:
        lf = module_loss_fn(fmodel, logitcrossentropy,
                            mesh.sub(lay.batch_axes))
    params = dict(fmodel.named_parameters())
    mstate = {k: b.detach().clone() for k, b in fmodel.named_buffers()}
    state, specs = _sharded_state(
        fmodel, params, mstate, optimizer, mesh,
        lambda st: state_specs_for(fmodel, st, lay, mesh,
                                   min_size=min_size),
        tp=lay.tp > 1, what=f"layout {lay.name!r}")
    step = make_train_step_sharded(lf, optimizer, mesh, specs,
                                   batch_axes=lay.batch_axes, model=fmodel)
    batch = pr.batch({k: _shape_dtype(v) for k, v in batch_struct.items()},
                     shards=lay.batch_shards)
    priced = price_step(step, (state, batch), mesh=mesh)
    entries = priced["comms"]
    per_axis: dict = {}
    for e in entries:
        key = "+".join(e["axes"]) if e["axes"] else "?"
        per_axis[key] = per_axis.get(key, 0) + int(e["bytes"])
    return {"peak_bytes": int(priced["memory"]["peak_bytes"]),
            "memory": priced["memory"], "comms": entries,
            "comms_bytes": int(total_bytes(entries)),
            "comms_bytes_per_axis": per_axis}


def price_layouts(
    model,
    batch_struct: dict,
    optimizer=None,
    *,
    layouts: Optional[Sequence[Layout]] = None,
    loss_fn: Optional[Callable] = None,
    ndev: Optional[int] = None,
    min_size: Optional[int] = None,
    device=None,
) -> list:
    """Price each candidate layout's real train step and return one row
    per candidate: ``peak_bytes`` (the priced peak of rank 0, with the
    whole ``memory`` dict), the collective ledger (``comms``, its total
    ``comms_bytes`` and ``comms_bytes_per_axis``), or ``invalid`` with
    the reason (a batch that does not split, no TP rule table, heads
    that do not split, ...).

    Each step is built as ``prepare_training(layout=...)`` builds it, on
    a fake copy of ``model`` (:meth:`..obs.pricing.Pricing.module`; the
    model is neither read nor changed) over a fake world of ``ndev``
    ranks (default: the ranks of the default group), and run once on
    fake tensors on ``device`` (default ``cuda``): no device memory.
    ``batch_struct`` is the GLOBAL batch, a dict of arrays, tensors or
    ``(shape, dtype)`` pairs.  ``loss_fn`` is a factory ``loss_fn(model)
    -> loss function`` for the priced copy (default: the LM's token loss,
    or the image adapter).  ``optimizer`` defaults to ``optim.adam(1e-3)``.
    Under a real process group use :func:`price_layouts_in_child`."""
    from ..obs.pricing import pricing

    if optimizer is None:
        from .. import optim

        optimizer = optim.adam(1e-3)
    n = ndev if ndev is not None else _world()
    cands = list(layouts) if layouts is not None else layout_candidates(n)
    bsz = _shape_dtype(next(iter(batch_struct.values())))[0][0]
    rows = []
    with pricing(n, device=device) as pr:
        for lay in cands:
            row: dict = {"layout": lay.name, "sizes": lay.sizes,
                         "peak_bytes": None, "comms_bytes": None}
            if bsz % lay.batch_shards:
                row["invalid"] = (f"batch {bsz} not divisible by dp x fsdp "
                                  f"= {lay.batch_shards}")
                rows.append(row)
                continue
            try:
                row.update(_price_one(pr, model, batch_struct, optimizer,
                                      lay, loss_fn, min_size))
            except ValueError as e:  # LayoutError and the specs' refusals
                row["invalid"] = str(e)[:300]
            rows.append(row)
    return rows


def _child_rows(_index: int, build: Callable, out: str, kw: dict) -> None:
    import torch

    model, batch_struct, optimizer, loss_fn = build()
    torch.save(price_layouts(model, batch_struct, optimizer,
                             loss_fn=loss_fn, **kw), out)


def price_layouts_in_child(build: Callable, *, ndev: int,
                           layouts: Optional[Sequence[Layout]] = None,
                           min_size: Optional[int] = None,
                           device=None) -> list:
    """:func:`price_layouts` in a spawned child process, for a process
    that holds a real process group (the child forms its own fake world
    of ``ndev`` ranks).  ``build`` is a picklable callable that returns
    ``(model, batch_struct, optimizer, loss_fn)`` in the child (a model
    on the ``meta`` device is enough; a model's closures and an
    optimizer do not pickle, a builder does).  The rows are rank 0's of
    the candidates; the caller broadcasts them to its other ranks."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="fdtpu_pick_")
    out = os.path.join(tmp, "rows.pt")
    try:
        mp.start_processes(
            _child_rows, args=(build, out, dict(
                ndev=ndev, layouts=layouts, min_size=min_size,
                device=device)),
            nprocs=1, join=True, start_method="spawn")
        return torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _budget(hbm_bytes: Optional[float]) -> Optional[float]:
    """The per-device budget: the caller's, else the smallest local
    card's total memory, else None (the CPU)."""
    from ..obs import memstats

    if hbm_bytes is not None:
        return hbm_bytes
    limits = [d["bytes_limit"] for d in (memstats.hbm_device_stats() or [])
              if d["bytes_limit"] > 0]
    return float(min(limits)) if limits else None


def pick(
    model,
    batch_struct: dict,
    optimizer=None,
    *,
    hbm_bytes: Optional[float] = None,
    layouts: Optional[Sequence[Layout]] = None,
    loss_fn: Optional[Callable] = None,
    ndev: Optional[int] = None,
    min_size: Optional[int] = None,
    rows: Optional[list] = None,
    device=None,
) -> PickReport:
    """Choose the fastest layout that fits this topology.

    Fit rides :func:`..obs.memstats.rank_memory`, the fit checker's
    ranking: ``hbm_bytes`` defaults to the card's total memory and must
    be passed without a card (the CPU) for fit verdicts.  Among fitting
    layouts the fewest collective bytes a step wins, then the most
    headroom.  With no budget the verdicts stay unknown and the ledger
    alone ranks.  Raises :class:`LayoutError` when a budget is known and
    no candidate fits (the report rides the exception's ``report``).
    ``rows`` (a prior :func:`price_layouts` result, copied) re-picks
    under another budget without pricing again."""
    import copy

    from ..obs import memstats

    if rows is None:
        rows = price_layouts(
            model, batch_struct, optimizer, layouts=layouts,
            loss_fn=loss_fn, ndev=ndev, min_size=min_size, device=device)
    else:
        rows = copy.deepcopy(list(rows))
    budget = _budget(hbm_bytes)
    ranked = memstats.rank_memory(
        {r["layout"]: {"memory": r.get("memory")} for r in rows
         if "invalid" not in r},
        budget)
    verdicts = {r["variant"]: r for r in ranked}
    for r in rows:
        v = verdicts.get(r["layout"])
        r["fits"] = v["fits"] if v else None
        r["headroom_bytes"] = v["headroom_bytes"] if v else None

    def _tiebreak(r):
        comms = r.get("comms_bytes")
        head = r.get("headroom_bytes")
        return (comms if comms is not None else float("inf"),
                -(head if head is not None else float("-inf")))

    valid = [r for r in rows if "invalid" not in r]
    fitting = [r for r in valid if r["fits"]]
    # "does not fit" is a verdict only where a peak was priced
    any_peak = any(r.get("peak_bytes") is not None for r in valid)
    if fitting:
        best = min(fitting, key=_tiebreak)
        comms_txt = (f"{best['comms_bytes']:,} bytes/step"
                     if best.get("comms_bytes") is not None
                     else "ledger unavailable")
        reason = (f"chose {best['layout']} — fits with headroom "
                  f"{best['headroom_bytes']:,} bytes and the smallest "
                  f"collective traffic ({comms_txt}) among "
                  f"{len(fitting)} fitting layout(s)")
    elif budget is not None and valid and any_peak:
        report = PickReport(None, rows, budget,
                            "no candidate layout fits the budget")
        err = LayoutError(
            f"no layout fits: every candidate's peak exceeds the "
            f"per-device budget {budget:.3e} bytes "
            f"({[(r['layout'], r.get('peak_bytes')) for r in valid]})")
        err.report = report
        raise err
    elif valid:
        best = min(valid, key=_tiebreak)
        why = ("memory model unavailable"
               if budget is not None and not any_peak
               else "no HBM budget — pass hbm_bytes for fit verdicts")
        reason = (f"chose {best['layout']} by collective traffic alone "
                  f"({why})")
    else:
        report = PickReport(None, rows, budget,
                            "no valid candidate layout")
        err = LayoutError(
            "no valid candidate layout on this topology: "
            + "; ".join(f"{r['layout']}: {r.get('invalid')}"
                        for r in rows))
        err.report = report
        raise err
    # the winner from the row's own axis sizes, never by name alone: a
    # custom candidate may share a preset's name with other sizes
    sizes = best.get("sizes") or {}
    if sizes:
        chosen = Layout(best["layout"], dp=int(sizes.get(DATA_AXIS, 1)),
                        fsdp=int(sizes.get(FSDP_AXIS, 1)),
                        tp=int(sizes.get(MODEL_AXIS, 1)))
    else:
        chosen = next(lay for lay in (layouts or layout_candidates(ndev))
                      if lay.name == best["layout"])
    return PickReport(chosen, rows, budget, reason)
