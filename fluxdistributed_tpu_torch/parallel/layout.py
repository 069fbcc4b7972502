"""dp x fsdp x tp layouts: "shard this model over these ranks" as one
name.

Port of ``fluxdistributed_tpu/parallel/layout.py`` without its picker.
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

The picker (``price_layouts``, ``pick``, ``layout="auto"``) prices a
compiled program through the memory statistics' static half and the
collective ledger, which come with slice 7 of the port; it raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..mesh import DATA_AXIS, FSDP_AXIS, MODEL_AXIS, Mesh

__all__ = [
    "LAYOUT_PRESETS",
    "Layout",
    "LayoutError",
    "layout_candidates",
    "pick",
    "price_layouts",
    "resolve_layout",
    "state_specs_for",
]

_PICKER = ("the layout picker (price_layouts, pick, layout='auto') prices "
           "a compiled step through memstats' static half and the "
           "collective ledger (obs/comms.py), which the port has not yet "
           "(slice 7 of the port, ROADMAP); name a preset or pass a Layout")


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
    (1 without one).  ``"auto"`` raises ``NotImplementedError``."""
    n = ndev if ndev is not None else _world()
    if isinstance(spec, Layout):
        if spec.devices() != n:
            raise LayoutError(
                f"layout {spec.describe()} covers {spec.devices()} devices "
                f"but the topology has {n}")
        return spec
    if isinstance(spec, str):
        if spec == "auto":
            raise NotImplementedError(_PICKER)
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


def price_layouts(*args, **kwargs):
    """Not ported yet (slice 7): raises ``NotImplementedError``."""
    raise NotImplementedError(_PICKER)


def pick(*args, **kwargs):
    """Not ported yet (slice 7): raises ``NotImplementedError``."""
    raise NotImplementedError(_PICKER)
