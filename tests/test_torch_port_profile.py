"""The cost profile (``fluxdistributed_tpu_torch/obs/profile.py``) and the
planner's profile sources (``parallel/pp_plan.py``) against the JAX
package.

The artifact tests are JAX ``tests/test_profile.py``'s and
``test_memstats.py``'s v2 round trip on the port.  ``lm_layer_costs``
prices the plain forward on fake tensors: one block's FLOPs equal the
closed-form matmul count exactly.  A profile the JAX package writes
(its own ``lm_layer_costs`` of lm_tiny, saved by its ``Profile``) loads
in the port with ``verify=False`` and plans the same boundaries and
costs as JAX's ``plan_from_profile`` on the same file.  The training
CLI's ``--profile-out`` artifact has JAX's key tree.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import pytest
import torch

from fluxdistributed_tpu_torch.obs import Registry
from fluxdistributed_tpu_torch.obs.profile import (
    ACCEPTED_SCHEMAS, Profile, ProfileMismatch, bubble_report,
    collect_profile, describe_topology, lm_layer_costs,
    measured_from_registry, modeled_bubble, stage_costs_from_static,
    step_cost)
from fluxdistributed_tpu_torch.obs.runs import topology_fingerprint
from fluxdistributed_tpu_torch.parallel import pp_plan

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")


def _tiny_profile(mesh=None, **measured):
    return Profile(fingerprint=topology_fingerprint(mesh=mesh),
                   topology=describe_topology(mesh),
                   static={"model": None, "step": None, "variants": {}},
                   measured=dict(measured), meta={"producer": "test"})


@dataclasses.dataclass(frozen=True)
class _Mesh:
    shape: dict


# ---- the artifact -------------------------------------------------------------

def test_profile_save_load_round_trip(tmp_path):
    mesh = _Mesh({"data": 8})
    prof = _tiny_profile(mesh, phases={"dispatch": {"sum": 1.0,
                                                    "count": 4}})
    path = str(tmp_path / "p.json")
    prof.save(path)
    doc = json.loads(open(path).read())
    assert doc["schema"] == "fdtpu-profile/v2"
    assert doc["created_unix"] > 0
    back = Profile.load(path)
    assert back.fingerprint == prof.fingerprint
    assert back.measured == prof.measured
    assert back.topology["mesh"] == {"data": 8}
    assert back.topology["torch"] == torch.__version__
    assert back.verify(mesh) is back


def test_profile_load_rejects_wrong_schema(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"schema": "something/v9"}))
    with pytest.raises(ValueError, match="fdtpu-profile/v1"):
        Profile.load(str(path))


def test_profile_verify_rejects_topology_mismatch(tmp_path):
    mesh = _Mesh({"data": 8})
    path = str(tmp_path / "p.json")
    _tiny_profile(mesh).save(path)
    doc = json.loads(open(path).read())
    doc["fingerprint"] = "0" * 16
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(ProfileMismatch, match="do not transfer"):
        Profile.load(path).verify(mesh)
    # a mesh shape alone flips the fingerprint too
    with pytest.raises(ProfileMismatch):
        _tiny_profile(mesh).verify(_Mesh({"data": 4}))
    assert pp_plan.ProfileMismatch is ProfileMismatch


def test_profile_v2_roundtrip_and_v1_accepted(tmp_path):
    p2 = tmp_path / "v2.json"
    prof = Profile(
        fingerprint=topology_fingerprint(),
        memory={"state": {"param_bytes": 7}, "step": None,
                "variants": {"dp": {"memory": {"peak_bytes": 5}}}},
        comms={"step": {"recorded": [{"kind": "all_reduce",
                                      "axes": ["data"], "count": 1,
                                      "bytes": 4, "bytes_per_call": 4}]},
               "variants": {}})
    prof.save(str(p2))
    back = Profile.load(str(p2)).verify()
    assert back.schema == "fdtpu-profile/v2"
    assert back.memory == prof.memory and back.comms == prof.comms
    doc = json.loads(p2.read_text())
    doc["schema"] = "fdtpu-profile/v1"
    del doc["memory"], doc["comms"]
    p1 = tmp_path / "v1.json"
    p1.write_text(json.dumps(doc))
    old = Profile.load(str(p1)).verify()
    assert old.schema == "fdtpu-profile/v1"
    assert old.memory == {} and old.comms == {}
    assert "fdtpu-profile/v1" in ACCEPTED_SCHEMAS
    doc["schema"] = "fdtpu-profile/v0"
    p0 = tmp_path / "v0.json"
    p0.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="not a .*artifact"):
        Profile.load(str(p0))


def test_measured_from_registry_skips_empty():
    reg = Registry()
    reg.histogram("fdtpu_train_phase_seconds", "", labelnames=("phase",))
    out = measured_from_registry(reg)
    assert "phases" not in out or out["phases"] == {}


# ---- static costs on fake tensors ---------------------------------------------

def test_lm_layer_costs_block_is_the_closed_form():
    """One decoder block's FLOPs by the depth difference equal its
    matmuls in closed form, exactly: q/k/v and out (4 d^2), the MLP
    (2 d mlp), per token 2 FLOPs a multiply-add, and the two T x T
    attention products (4 B T^2 d)."""
    from fluxdistributed_tpu_torch.models import lm_tiny

    B, T, d, mlp, depth = 2, 16, 32, 64, 4
    model = lm_tiny(vocab=64, depth=depth, dim=d, num_heads=2, mlp_dim=mlp,
                    device="cpu")
    costs = lm_layer_costs(model, batch_size=B, seqlen=T, device="cpu")
    assert costs["depth"] == depth
    assert costs["block"]["flops"] == (2 * B * T * (4 * d * d + 2 * d * mlp)
                                       + 4 * B * T * T * d)
    # the embedding lookup multiplies nothing: the outer cost is the tied
    # head's [B T, d] x [d, vocab]
    assert costs["outer"]["flops"] == 2 * B * T * d * 64
    for part in ("block", "outer", "total"):
        assert costs[part]["bytes"] > 0
    assert costs["total"]["flops"] == pytest.approx(
        costs["outer"]["flops"] + depth * costs["block"]["flops"])
    assert lm_layer_costs(model, B, T, device="cpu")["block"] \
        == costs["block"]


def test_step_cost_and_collect_profile_of_a_prepared_step():
    """``step_cost`` prices a prepared step on fake arguments; a real
    callable prices to None; ``collect_profile`` of a one-device task
    prices its real step on fake copies and carries the registry's
    measured side."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.obs.pricing import pricing
    from fluxdistributed_tpu_torch.train import prepare_training

    assert step_cost(lambda a: a, (1,)) is None
    ds = SyntheticDataset(nsamples=32, nclasses=4, shape=(8, 8, 3))
    model = SimpleCNN(num_classes=4, features=8, device="cpu")
    with pricing(None, device="cpu") as pr:
        task = prepare_training(pr.module(model), ds, optim.adam(1e-3),
                                batch_size=16, cycles=1, device="cpu")
        batch = pr.batch({"image": ((16, 8, 8, 3), "float32"),
                          "label": ((16, 4), "float32")})
        cost = step_cost(task.step_fn, (task.state, batch))
    assert cost["flops"] > 0 and cost["bytes"] > 0

    task = prepare_training(model, ds, optim.adam(1e-3), batch_size=16,
                            cycles=1, device="cpu")
    batch = {"image": torch.zeros(16, 8, 8, 3),
             "label": torch.zeros(16, 4)}
    reg = Registry()
    reg.histogram("fdtpu_train_phase_seconds", "", labelnames=("phase",)
                  ).labels(phase="dispatch").observe(0.25)
    reg.counter("fdtpu_train_steps_total", "").inc(3)
    prof = collect_profile(task, registry=reg, batch=batch)
    assert prof.static["step"]["flops"] == cost["flops"]
    assert prof.memory["step"]["source"] == "fake"
    assert prof.comms["step"]["recorded"] == []
    assert prof.measured["phases"]["dispatch"]["count"] == 1
    assert prof.measured["counters"]["fdtpu_train_steps_total"] == 3
    assert prof.meta["model"] == "SimpleCNN"
    prof.verify()


def test_variant_costs_price_the_registry():
    """Every named variant's step priced on 8 fake ranks; a program that
    cannot run fake (the dense engine's prefill) prices to None."""
    from fluxdistributed_tpu_torch.obs.profile import variant_costs

    got = variant_costs(["dp", "zero1", "serve"], device="cpu")
    assert got["dp"]["flops"] > 0 and got["dp"]["bytes"] > 0
    assert got["zero1"]["flops"] == got["dp"]["flops"]  # the same math
    assert got["serve:prefill_b16"] is None
    assert got["serve:step"]["bytes"] > 0


# ---- modeled against measured bubble ------------------------------------------

def test_modeled_bubble_reduces_to_classic_formula():
    for S, M in ((4, 4), (4, 8), (8, 16)):
        assert modeled_bubble([1.0] * S, M) == pytest.approx(
            (S - 1) / (M + S - 1))
    assert modeled_bubble([1.0, 1.0, 1.0, 2.0], 8) > (4 - 1) / (8 + 4 - 1)
    assert modeled_bubble([], 8) == 0.0
    assert modeled_bubble([0.0, 0.0], 8) == 0.0
    assert pp_plan.modeled_bubble is modeled_bubble


def test_stage_costs_split_blocks_and_outer():
    model_costs = {"depth": 8, "block": {"flops": 10.0},
                   "outer": {"flops": 4.0}}
    stages = stage_costs_from_static(model_costs, 4)
    assert len(stages) == 4
    assert sum(stages) == pytest.approx(8 * 10.0 + 4.0)
    assert stages[0] == pytest.approx(2 * 10.0 + 2.0)
    assert stages[-1] == pytest.approx(2 * 10.0 + 2.0)
    stages = stage_costs_from_static(model_costs, 3)
    assert [round(s - (2.0 if i in (0, 2) else 0), 1)
            for i, s in enumerate(stages)] == [30.0, 30.0, 20.0]


def test_bubble_report_recovers_planted_bubble():
    S, tau = 4, 2.0
    rows = [{"M": M, "S": S, "step_ms": (M + S - 1) * tau}
            for M in (4, 8, 16, 32)]
    prof = Profile(fingerprint="x", measured={"pp_rows": rows},
                   static={"model": None})
    for r in bubble_report(prof):
        classic = (S - 1) / (r["M"] + S - 1)
        assert r["measured_bubble"] == pytest.approx(classic, abs=1e-3)
        assert r["modeled_bubble"] == pytest.approx(classic, abs=1e-3)
        assert r["fit_ms_per_microbatch"] == pytest.approx(tau)
        assert r["fit_fixed_ms"] == pytest.approx((S - 1) * tau)


def test_bubble_report_needs_two_rows():
    prof = Profile(fingerprint="x",
                   measured={"pp_rows": [{"M": 4, "S": 4, "step_ms": 1}]})
    with pytest.raises(ValueError, match=">= 2"):
        bubble_report(prof)


# ---- the planner's profile sources against JAX ---------------------------------

def test_jax_profile_plans_the_same_in_the_port(tmp_path):
    """A profile the JAX package writes (its lm_layer_costs of lm_tiny,
    saved by its Profile) loads in the port unverified; the port's
    plan_from_profile places JAX's boundaries with JAX's costs, bubbles
    and stage bytes, on the file and through resolve_plan."""
    from fluxdistributed_tpu.models import lm_tiny as jax_lm_tiny
    from fluxdistributed_tpu.obs import profile as jprofile
    from fluxdistributed_tpu.parallel import pp_plan as jplan

    jmodel = jax_lm_tiny(vocab=64, depth=6, dim=32, num_heads=2,
                         mlp_dim=64)
    costs = jprofile.lm_layer_costs(jmodel, batch_size=4, seqlen=16)
    path = str(tmp_path / "jax.profile.json")
    jprofile.Profile(fingerprint="f" * 16, topology={"mesh": {"pipe": 3}},
                     static={"model": costs, "step": None,
                             "variants": {}}).save(path)
    for S, M, sched in ((3, 4, "1f1b"), (2, 8, "zb")):
        want = jplan.plan_from_profile(jprofile.Profile.load(path), S, M,
                                       schedule=sched)
        got = pp_plan.plan_from_profile(Profile.load(path), S, M,
                                        schedule=sched)
        assert got.boundaries == want.boundaries
        assert got.stage_costs == pytest.approx(want.stage_costs, rel=1e-12)
        assert got.stage_bytes == pytest.approx(want.stage_bytes, rel=1e-12)
        assert got.modeled_bubble == pytest.approx(want.modeled_bubble)
        assert got.uniform_bubble == pytest.approx(want.uniform_bubble)
        assert got.fingerprint == want.fingerprint == "f" * 16
        assert got.meta["topology_mesh"] == {"pipe": 3}
    resolved = pp_plan.resolve_plan(path, 3, 4, verify=False)
    assert resolved.boundaries == jplan.resolve_plan(
        path, 3, 4, verify=False).boundaries
    with pytest.raises(ProfileMismatch):
        pp_plan.resolve_plan(path, 3, 4)  # another topology's costs


def test_plan_from_profile_uses_blocks_and_outer():
    prof = Profile(
        fingerprint="",
        topology={"mesh": {"pipe": 4}},
        static={"model": {
            "batch": 2, "seqlen": 8, "depth": 8,
            "block": {"flops": 1.0, "bytes": 10.0},
            "outer": {"flops": 4.0, "bytes": 40.0},
            "total": {"flops": 12.0, "bytes": 120.0},
        }},
    )
    plan = pp_plan.plan_from_profile(prof, 4, 8)
    assert plan.depth == 8 and plan.S == 4
    assert plan.counts[0] < plan.counts[1]
    assert plan.meta["topology_mesh"] == {"pipe": 4}
    prof.static["model"]["blocks"] = [
        {"flops": f, "bytes": 1.0}
        for f in (6.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 6.0)]
    prof.static["model"]["outer"] = {"flops": 0.0, "bytes": 0.0}
    plan2 = pp_plan.plan_from_profile(prof, 4, 8)
    assert plan2.modeled_bubble < plan2.uniform_bubble
    assert plan2.counts[0] == 1 and plan2.counts[-1] == 1
    with pytest.raises(pp_plan.PlanError, match="static.model"):
        pp_plan.plan_from_profile(Profile(fingerprint=""), 4, 8)


def test_resolve_plan_fails_fast_on_mismatch(tmp_path):
    import types

    path = str(tmp_path / "plan8.json")
    pp_plan.plan_stages([1.0] * 16, 8, 8).save(path)
    with pytest.raises(pp_plan.PlanError, match="re-plan for this mesh"):
        pp_plan.resolve_plan(path, 4, 8)
    path2 = str(tmp_path / "plan4.json")
    pp_plan.plan_stages([1.0] * 16, 4, 8).save(path2)
    with pytest.raises(pp_plan.PlanError, match="re-plan for this model"):
        pp_plan.resolve_plan(path2, 4, 8,
                             model=types.SimpleNamespace(depth=12))
    got = pp_plan.resolve_plan(path2, 4, 8,
                               model=types.SimpleNamespace(depth=16))
    assert got.boundaries == pp_plan.plan_stages([1.0] * 16, 4, 8).boundaries


def test_plan_from_model_prices_blocks_and_bytes():
    """``--pp-plan auto``'s planner: the model's block costs priced on
    fake tensors and each block's exact parameter bytes; the outer
    weight thins the end stages of a homogeneous stack."""
    from fluxdistributed_tpu_torch.models import lm_tiny

    model = lm_tiny(vocab=256, depth=6, dim=32, num_heads=2, mlp_dim=64,
                    device="cpu")
    plan = pp_plan.plan_from_model(model, 3, 6, batch_size=4, seqlen=16,
                                   device="cpu")
    block = sum(p.numel() * 4 for n, p in model.named_parameters()
                if n.startswith("blocks.0."))
    outer = sum(p.numel() * 4 for n, p in model.named_parameters()
                if not n.startswith("blocks."))
    ring = min(3, 6) * (4 // 6 or 1) * 16 * 32 * 4
    assert plan.depth == 6 and plan.meta["source"] == "model"
    assert plan.stage_bytes[1] == plan.counts[1] * (block + ring)
    assert plan.stage_bytes[0] == plan.counts[0] * (block + ring) + outer / 2
    assert pp_plan.resolve_plan("auto", 3, 6, model=model, batch_size=4,
                                seqlen=16, device="cpu") == plan
    with pytest.raises(pp_plan.PlanError, match="needs model"):
        pp_plan.resolve_plan("auto", 3, 6)


# ---- the CLI's artifact ---------------------------------------------------------

def test_cli_profile_out_has_the_jax_key_tree(tmp_path):
    """``--profile-out`` writes, when training ends, an artifact with
    JAX's key tree (the topology block names ``torch`` for ``jax``), its
    model costs at the run's shapes and its step priced on fake
    tensors."""
    from fluxdistributed_tpu.obs import profile as jprofile

    path = str(tmp_path / "run.profile.json")
    cli.run(["--model", "lm_tiny", "--vocab", "64", "--seqlen", "16",
             "--batch-size", "4", "--cycles", "2", "--opt", "adam",
             "--lr", "3e-3", "--attn", "flash", "--device", "cpu",
             "--profile-out", path])
    doc = json.load(open(path))
    jdoc = dataclasses.asdict(jprofile.Profile(fingerprint=""))
    assert set(doc) == set(jdoc) | {"created_unix"}
    assert set(doc["static"]) == {"model", "step", "variants"}
    assert set(doc["memory"]) == {"state", "step", "variants"}
    assert set(doc["comms"]) == {"step", "variants"}
    assert set(doc["static"]["model"]) == {"batch", "seqlen", "depth",
                                           "block", "outer", "total"}
    assert doc["static"]["model"]["batch"] == 4
    assert doc["static"]["step"]["flops"] > 0
    assert doc["memory"]["step"]["peak_bytes"] > 0
    assert set(doc["topology"]) == {"torch", "platform", "device_kind",
                                    "device_count", "process_count"}
    assert doc["measured"]["counters"]["fdtpu_train_steps_total"] >= 2
    Profile.load(path).verify()
