"""Port parity: the 1F1B / zero-bubble timetables
(``parallel/pp_1f1b.py``'s ``build_schedule``, a numpy copy) and the
pipeline planner (``parallel/pp_plan.py``, pure Python), against the
JAX package.

Every column of every timetable, its counters and its rendering equal
JAX's over S in {2, 4}, M in {1, 2, 4, 8}, V in {1, 2} and both
schedules; the builder's and the oracle's refusals carry JAX's
messages.  The planner's boundaries, stage costs, modeled bubbles and
memory estimates equal JAX's exactly over a seeded grid of costs,
budgets and schedules; a plan JSON the JAX package saved loads in the
port, and a plan whose fingerprint is not this process's is refused.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from fluxdistributed_tpu.parallel import pp_1f1b as jpp1
from fluxdistributed_tpu.parallel import pp_plan as jplan
from fluxdistributed_tpu_torch.parallel import pp_1f1b, pp_plan

GRID = list(itertools.product((2, 4), (1, 2, 4, 8), (1, 2), ("1f1b", "zb")))


@pytest.mark.parametrize("S,M,V,schedule", GRID)
def test_timetable_columns_equal_jax(S, M, V, schedule):
    got = pp_1f1b.build_schedule(S, M, V, schedule=schedule)
    ref = jpp1.build_schedule(S, M, V, schedule=schedule)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert got.ticks == ref.ticks
    np.testing.assert_array_equal(got.busy_per_device(),
                                  ref.busy_per_device())
    np.testing.assert_array_equal(got.idle_ticks, ref.idle_ticks)
    assert got.utilization == ref.utilization
    assert got.render() == ref.render()
    assert got.render(max_ticks=5) == ref.render(max_ticks=5)


@pytest.mark.parametrize("args,kw,msg", [
    ((1, 4), {}, "1F1B needs >= 2 pipeline stages"),
    ((2, 0), {}, "need >= 1 microbatch"),
    ((2, 4, 0), {}, "need >= 1 chunk per device"),
    ((2, 4), {"schedule": "eager"}, "unknown pipeline schedule"),
])
def test_build_schedule_refusals_match_jax(args, kw, msg):
    for build in (pp_1f1b.build_schedule, jpp1.build_schedule):
        with pytest.raises(ValueError, match=msg):
            build(*args, **kw)


def test_placement_oracle_refuses_corrupted_placements_as_jax():
    """The dependency oracle on a real placement passes, and on the same
    placement with one backward moved before its own forward (and, for
    zb, one W before its B) raises JAX's error in both packages."""
    S, M, V = 4, 4, 1
    for zb in (False, True):
        ring = min(S, M)
        placed = pp_1f1b._place(S, M, V, ring, 1, "bfw" if zb else "bfirst",
                                zb=zb)
        assert placed == jpp1._place(S, M, V, ring, 1,
                                     "bfw" if zb else "bfirst", zb=zb)
        f, b, w, _, _ = placed
        pp_1f1b._verify_placement(S, M, V, ring, 1, f, b, w)
        bad_b = [[list(x) for x in d] for d in b]
        bad_b[2][0][1] = f[2][0][1] - 1
        for verify in (pp_1f1b._verify_placement, jpp1._verify_placement):
            with pytest.raises(RuntimeError, match="pipeline schedule unsafe"):
                verify(S, M, V, ring, 1, f, bad_b, w)
        if zb:
            bad_w = [[list(x) for x in d] for d in w]
            bad_w[1][0][0] = b[1][0][0]
            for verify in (pp_1f1b._verify_placement,
                           jpp1._verify_placement):
                with pytest.raises(RuntimeError,
                                   match="weight-grad before its input"):
                    verify(S, M, V, ring, 1, f, b, bad_w)


# ------------------------------------------------------------ the planner

def _cost_grid():
    rng = np.random.default_rng(7)
    out = []
    for depth, S in ((4, 2), (6, 4), (8, 4), (12, 3), (7, 2)):
        costs = [float(c) for c in rng.uniform(0.5, 3.0, depth)]
        outer = tuple(float(c) for c in rng.uniform(0.0, 2.0, 2))
        out.append((costs, S, outer))
    out.append(([1.0] * 8, 4, (0.0, 0.0)))  # flat: the uniform split
    return out


def _same_plan(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert set(da) == set(db)
    for k in db:
        assert da[k] == db[k], k


@pytest.mark.parametrize("case", range(len(_cost_grid())))
@pytest.mark.parametrize("schedule", ["1f1b", "zb"])
def test_plan_stages_equals_jax(case, schedule):
    costs, S, outer = _cost_grid()[case]
    rng = np.random.default_rng(case)
    bb = [float(b) for b in rng.uniform(1e6, 4e6, len(costs))]
    for kw in ({}, {"block_bytes": bb, "outer_bytes": (2e6, 3e6),
                    "activation_bytes": 1e5},
               {"block_bytes": bb, "activation_bytes": 1e5,
                "memory_budget": 2.2 * max(bb) + 4e5}):
        for M in (2, 8):
            try:
                ref = jplan.plan_stages(costs, S, M, outer=outer,
                                        schedule=schedule, **kw)
            except jplan.PlanError as e:
                with pytest.raises(pp_plan.PlanError,
                                   match="no feasible placement"):
                    pp_plan.plan_stages(costs, S, M, outer=outer,
                                        schedule=schedule, **kw)
                assert "no feasible placement" in str(e)
                continue
            got = pp_plan.plan_stages(costs, S, M, outer=outer,
                                      schedule=schedule, **kw)
            _same_plan(got, ref)
            assert got.counts == ref.counts and got.S == ref.S
            assert got.is_uniform == ref.is_uniform
            assert got.describe() == ref.describe()
    assert pp_plan.uniform_boundaries(len(costs), S) == \
        jplan.uniform_boundaries(len(costs), S)
    b = pp_plan.uniform_boundaries(len(costs), S)
    assert pp_plan.stage_costs_for(costs, b, outer) == \
        jplan.stage_costs_for(costs, b, outer)


def test_plan_refusals_match_jax():
    for args, kw, msg in (
            (([1.0] * 2, 3, 2), {}, "cannot fill 3 pipeline stages"),
            (([1.0] * 4, 0, 2), {}, "need >= 1 stage"),
            (([1.0] * 4, 2, 0), {}, "num_microbatches must be >= 1"),
            (([1.0, -1.0], 2, 2), {}, "non-negative"),
            (([1.0] * 4, 2, 2), {"block_bytes": [1.0]}, "block_bytes has"),
            (([1.0] * 4, 2, 2), {"block_bytes": [10.0] * 4,
                                 "memory_budget": 5.0},
             "no feasible placement")):
        for plan in (pp_plan.plan_stages, jplan.plan_stages):
            with pytest.raises(ValueError, match=msg):
                plan(*args, **kw)


def test_jax_saved_plan_loads_and_resolves(tmp_path):
    ref = jplan.plan_stages([1.0, 3.0, 1.0, 1.0, 2.0, 1.0], 3, 4,
                            outer=(0.5, 1.5), schedule="zb",
                            block_bytes=[1e6] * 6, activation_bytes=1e4)
    path = ref.save(str(tmp_path / "plan.json"))
    got = pp_plan.PipelinePlan.load(path)
    _same_plan(got, ref)
    assert got.verify() is got  # no fingerprint: topology-free
    resolved = pp_plan.resolve_plan(path, 3, 4)
    _same_plan(resolved, ref)
    got.save(str(tmp_path / "port.json"))
    _same_plan(jplan.PipelinePlan.load(str(tmp_path / "port.json")), ref)
    with pytest.raises(pp_plan.PlanError, match="re-plan for this mesh"):
        pp_plan.resolve_plan(path, 2, 4)

    class Model:
        depth = 8

    with pytest.raises(pp_plan.PlanError, match="re-plan for this model"):
        pp_plan.resolve_plan(path, 3, 4, model=Model())
    bad = tmp_path / "profile.json"
    bad.write_text(json.dumps({"schema": "fdtpu-profile/v1",
                               "fingerprint": ""}))
    with pytest.raises(ValueError, match="not a fdtpu-pp-plan/v1"):
        pp_plan.PipelinePlan.load(str(bad))
    # a cost profile is planned from: this one has no model costs
    with pytest.raises(pp_plan.PlanError, match="static.model"):
        pp_plan.resolve_plan(str(bad), 3, 4)
    with pytest.raises(pp_plan.PlanError, match="needs model"):
        pp_plan.resolve_plan("auto", 3, 4)


def test_plan_fingerprint_is_held_to_this_process():
    from fluxdistributed_tpu_torch.obs.runs import topology_fingerprint

    plan = pp_plan.plan_stages([1.0] * 4, 2, 2)
    foreign = dataclasses.replace(plan, fingerprint="0123456789abcdef")
    with pytest.raises(pp_plan.ProfileMismatch, match="different hardware"):
        foreign.verify()
    assert issubclass(pp_plan.ProfileMismatch, ValueError)
    here = dataclasses.replace(plan, fingerprint=topology_fingerprint())
    assert here.verify() is here
    assert here.verify_source_topology() is here
    elsewhere = dataclasses.replace(
        here, meta={"topology_mesh": {"data": 2, "pipe": 4}})
    with pytest.raises(pp_plan.ProfileMismatch, match="cannot rebuild"):
        elsewhere.verify_source_topology()
    one = dataclasses.replace(
        plan, fingerprint=topology_fingerprint(
            mesh=pp_plan._Shape({"pipe": 1})),
        meta={"topology_mesh": {"pipe": 1}})
    assert one.verify_source_topology() is one
