"""Port parity: the sharding rules engine (``parallel/rules.py``) and the
dp x fsdp x tp layouts (``parallel/layout.py``) against the JAX package.

The port's tables name the port's parameters (``state_dict`` names,
torch ``(out, in)`` weights, the fused qkv as stacked parts); each is
held to the JAX table's logical placement: for every registered JAX
probe, each rank's block of each leaf under the port table equals the
conversion (``models/from_jax.py``) of the JAX device's block under the
JAX table, bit for bit.  The FSDP table shards each leaf's own largest
dim, which can differ between the two layouts (ROADMAP C9): there the
per-rank element counts must agree.

The layouts train at 4 gloo ranks (one spawn, bodies in
``test_torch_port_rules_ranks.py``) against JAX's
``prepare_training(layout=...)`` on 4 virtual CPU devices, from the same
weights and loader batches, at ``tests/test_rules.py``'s tolerance
(losses rtol 2e-4, atol 2e-5).  The CLI's ``--layout dp_fsdp`` equals
``train()`` with the same arguments bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_rules_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.parallel import layout as jlayout
from fluxdistributed_tpu.parallel import rules as jrules
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models import (flax_to_state_dict,
                                              flax_vit_to_state_dict,
                                              load_flax_simple)
from fluxdistributed_tpu_torch.parallel import layout, rules
from fluxdistributed_tpu_torch.sharding import P, local_block

N = 4
AXES = {"data": 1, "fsdp": 2, "model": 2}


def _fake_mesh(axes: dict, coords=None) -> Mesh:
    """A mesh of no process group (block cutting and checks only)."""
    return Mesh(group=None, rank=0, size=math.prod(axes.values()),
                device=torch.device("cpu"), axis=next(iter(axes)),
                axes=tuple(axes.items()),
                coords=tuple(coords or (0,) * len(axes)))


def _jax_block(x: np.ndarray, spec, coord: dict) -> np.ndarray:
    """JAX device ``coord``'s block of ``x`` under a PartitionSpec."""
    for d, e in enumerate(spec):
        if e is None:
            continue
        names = (e,) if isinstance(e, str) else tuple(e)
        n = math.prod(AXES[a] for a in names)
        i = 0
        for a in names:
            i = i * AXES[a] + coord[a]
        m = x.shape[d] // n
        x = np.take(x, np.arange(i * m, (i + 1) * m), axis=d)
    return x


def _valued(shapes):
    """Distinct values for every leaf of a probe's shape tree."""
    return jax.tree.map(
        lambda s: np.arange(math.prod(s.shape), dtype=np.float32).reshape(
            s.shape) / 7.0, shapes)


def _coords():
    names = list(AXES)
    for idx in np.ndindex(*AXES.values()):
        yield dict(zip(names, idx)), idx


@pytest.mark.parametrize("table", ["lm_tp", "vit_tp", "dp"])
def test_tables_place_as_jax_tables(table):
    """Every registered JAX probe: the port table's block of each leaf
    (port names) equals the conversion of JAX's block (JAX names)."""
    jtab = jrules.RULE_TABLES[table]
    for probe in jtab.probes:
        shapes, note = probe()
        params = _valued(shapes)
        vit = "ViT" in note
        convert = flax_vit_to_state_dict if vit else flax_to_state_dict
        if "CNN" in note:
            continue  # no TP table covers it; the dp case is below
        jspecs = jrules.match_partition_rules(jtab.build(), params)
        full = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in convert(params).items()}
        pspecs = rules.match_partition_rules(rules.RULE_TABLES[table].build(),
                                             full)
        for coord, idx in _coords():
            jb = convert(jax.tree.map(
                lambda x, s, c=coord: _jax_block(x, s, c), params, jspecs,
                is_leaf=lambda x: isinstance(x, np.ndarray)))
            mesh = _fake_mesh(AXES, idx)
            for k, v in full.items():
                got = local_block(v, pspecs[k], mesh).numpy()
                np.testing.assert_array_equal(got, jb[k],
                                              err_msg=f"{note} {coord} {k}")


def test_fsdp_table_matches_jax_shard_sizes():
    """The one-rule FSDP table: the same leaves split, to the same
    per-rank element counts (the dim may differ, C9)."""
    jmesh = jmake_mesh(AXES)
    pmesh = _fake_mesh(AXES)
    for probe in jrules.RULE_TABLES["fsdp"].probes:
        shapes, note = probe()
        params = _valued(shapes)
        if "ViT" in note:
            full = flax_vit_to_state_dict(params)
        elif "CNN" in note:
            from fluxdistributed_tpu_torch.models import SimpleCNN

            full = load_flax_simple(SimpleCNN(num_classes=4, features=8,
                                              device="cpu"),
                                    params).state_dict()
            full = {k: v.numpy() for k, v in full.items()}
        else:
            full = flax_to_state_dict(params)
        jspecs = jrules.match_partition_rules(
            jrules.fsdp_rules(min_size=16), params, mesh=jmesh)
        pspecs = rules.match_partition_rules(
            rules.fsdp_rules(min_size=16), full, mesh=pmesh)
        jn = [2 if "fsdp" in tuple(s) else 1 for s in jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, tuple))]
        pn = [2 if "fsdp" in tuple(s) else 1 for s in pspecs.values()]
        assert sorted(jn) == sorted(pn), note
        for k, s in pspecs.items():
            if "fsdp" in repr(s):
                blk = local_block(torch.from_numpy(full[k]), s, pmesh)
                assert blk.numel() * 2 == full[k].size, (note, k)


def test_registered_tables_have_no_dead_rules_or_silent_replication():
    for name, table in rules.RULE_TABLES.items():
        dead = None
        for probe in table.probes:
            params, note = probe()
            assert all(p.device.type == "meta" for p in params.values())
            rep = rules.rule_report(table.build(), params)
            dead = set(rep.dead) if dead is None else dead & set(rep.dead)
            if table.check_unmatched:
                assert not rep.large_unmatched, (name, note)
        assert not dead, (name, dead)
    assert set(rules.RULE_TABLES) == set(jrules.RULE_TABLES)


def test_rules_for_model():
    from fluxdistributed_tpu_torch.models import SimpleCNN, lm_tiny, vit_tiny

    with torch.device("meta"):
        lm = lm_tiny(device="meta")
        vit = vit_tiny(device="meta")
        cnn = SimpleCNN(device="meta")
    assert rules.rules_for_model(lm) == rules.lm_tp_rules_table()
    assert rules.rules_for_model(vit) == rules.vit_tp_rules_table()
    assert rules.rules_for_model(cnn) == []
    assert rules.rules_for_model(lm, tp=False) == []


def test_first_match_wins_and_scalars_replicate():
    params = {"block.qkv.weight": np.zeros((8, 8)), "scale": np.zeros(())}
    specs = rules.match_partition_rules(
        [(r"qkv\.weight$", P(None, "model")),
         (r"weight$", P("data", None)),
         (r"scale$", P("data"))],
        params)
    assert specs["block.qkv.weight"] == P(None, "model")
    assert specs["scale"] == P()


def test_fallback_report_and_strict():
    params = {"big": np.zeros((4096, 4)), "small": np.zeros((8,)),
              "hit": np.zeros((16, 16))}
    rep = rules.RuleReport({}, [], [], [])
    rules.match_partition_rules(
        [(r"hit$", P()), (r"matches_nothing$", P())], params, report=rep)
    assert rep.dead == ["matches_nothing$"]
    assert {p for p, _ in rep.unmatched} == {"big", "small"}
    assert [p for p, _ in rep.large_unmatched] == ["big"]
    with pytest.raises(ValueError, match="fell to replication"):
        rules.match_partition_rules([(r"hit$", P())], params, strict=True)
    rep = rules.rule_report(rules.fsdp_rules(), {"w": np.zeros((64, 64))})
    assert rep.matched[r".*"] == ["w"] and rep.dead == []


def test_unknown_axis_and_bad_values_rejected():
    mesh24 = _fake_mesh({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="bogus.*not on the mesh"):
        rules.match_partition_rules([(r".*", P("bogus"))],
                                    {"w": np.zeros((8, 8))}, mesh=mesh24)
    with pytest.raises(ValueError, match="not on the mesh"):
        rules.match_partition_rules([(r".*", rules.ShardLargest("bogus"))],
                                    {"w": np.zeros((8, 8))}, mesh=mesh24)
    with pytest.raises(TypeError, match="neither a spec"):
        rules.match_partition_rules([(r".*", "data")],
                                    {"w": np.zeros((8, 8))})
    with pytest.raises(ValueError, match="needs a mesh"):
        rules.match_partition_rules(rules.fsdp_rules(),
                                    {"w": np.zeros((64, 64))})


def test_validate_specs_divisibility():
    mesh24 = _fake_mesh({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="not divisible"):
        rules.validate_specs({"w": P("model", None)},
                             {"w": np.zeros((6, 8))}, mesh24, where="toy")
    # Adam's (m, v) pair is two leaves, not a shape literal
    rules.validate_specs({"w": (P("model", None),) * 2},
                         {"w": (np.zeros((8, 8)), np.zeros((8, 8)))},
                         mesh24, where="toy")
    with pytest.raises(ValueError, match="spec tree has"):
        rules.validate_specs({"w": P()}, {"w": np.zeros(4),
                                          "v": np.zeros(4)}, mesh24)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_presets_equal_jax(n):
    for name in jlayout.LAYOUT_PRESETS:
        ref = jlayout.LAYOUT_PRESETS[name](n)
        got = layout.LAYOUT_PRESETS[name](n)
        if ref is None:
            assert got is None, (name, n)
        else:
            assert (got.name, got.dp, got.fsdp, got.tp) == (
                ref.name, ref.dp, ref.fsdp, ref.tp)
            assert got.batch_axes == ref.batch_axes
            assert got.sizes == ref.sizes
    assert ([c.name for c in layout.layout_candidates(n)]
            == [c.name for c in jlayout.layout_candidates(n)])


def test_resolve_layout_errors():
    with pytest.raises(layout.LayoutError, match="unknown layout"):
        layout.resolve_layout("nope", 8)
    with pytest.raises(layout.LayoutError, match="does not exist"):
        layout.resolve_layout("dp_fsdp_tp", 4)
    with pytest.raises(layout.LayoutError, match="covers 4"):
        layout.resolve_layout(layout.Layout("x", dp=2, fsdp=2), 8)
    lay = layout.resolve_layout("dp", 8)
    with pytest.raises(layout.LayoutError, match="do not match"):
        lay.validate_mesh(_fake_mesh({"data": 1, "fsdp": 8, "model": 1}))
    lay.validate_mesh(_fake_mesh({"data": 8, "fsdp": 1, "model": 1}))


def test_tp_layout_without_a_table_is_refused():
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.parallel import TrainState

    model = SimpleCNN(num_classes=4, features=8, device="cpu")
    state = TrainState.create(dict(model.named_parameters()),
                              optim.adam(1e-3))
    lay = layout.resolve_layout("fsdp_tp", 8)
    with pytest.raises(layout.LayoutError, match="no tensor-parallel"):
        layout.state_specs_for(model, state, lay,
                               _fake_mesh({"data": 1, "fsdp": 4,
                                           "model": 2}))


def test_picker_is_not_ported():
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import prepare_training

    for fn in (layout.pick, layout.price_layouts):
        with pytest.raises(NotImplementedError, match="slice 7"):
            fn(None, {}, optim.adam(1e-3))
    with pytest.raises(NotImplementedError, match="slice 7"):
        layout.resolve_layout("auto", 4)
    with pytest.raises(NotImplementedError, match="slice 7"):
        prepare_training(SimpleCNN(num_classes=4, device="cpu"),
                         SyntheticDataset(nsamples=16, nclasses=4,
                                          shape=(8, 8, 3)),
                         optim.adam(1e-3), batch_size=8, cycles=1,
                         layout="auto", device="cpu")


def test_layout_conflicts_rejected():
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import prepare_training

    def prep(**kw):
        return prepare_training(
            SimpleCNN(num_classes=4, features=8, device="cpu"),
            SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3)),
            optim.adam(1e-3), batch_size=12, cycles=1, device="cpu", **kw)

    with pytest.raises(ValueError, match="cannot combine with spmd"):
        prep(layout="dp", spmd="fsdp")
    with pytest.raises(ValueError, match="ZeRO-3 placement subsumes"):
        prep(layout="dp", zero1=True)
    with pytest.raises(ValueError, match="steps_per_call > 1 is not "
                                         "supported with layout"):
        prep(layout="dp", steps_per_call=2)


@pytest.fixture(scope="module")
def jax_tasks():
    """JAX ``prepare_training(layout=...)`` over 4 virtual devices, per
    layout, and its initial weights in the port's names."""
    from fluxdistributed_tpu.data.synthetic import (SyntheticDataset,
                                                    SyntheticTextDataset)
    from fluxdistributed_tpu.models.simple import SimpleCNN
    from fluxdistributed_tpu.models.transformer_lm import (TransformerLM,
                                                           lm_loss_fn)
    from fluxdistributed_tpu.train.trainer import prepare_training

    devs = jax.devices()[:N]
    out = {}
    lay = jlayout.Layout("dp_fsdp", dp=2, fsdp=2)
    cnn = SimpleCNN(**ranks.CNN)
    task = prepare_training(
        cnn, SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3)),
        joptim.adam(1e-3), batch_size=16, cycles=3, seed=0, layout=lay,
        mesh=lay.build_mesh(devs=devs))
    from fluxdistributed_tpu_torch.models import SimpleCNN as PCNN

    init = jax.tree.map(np.asarray, task.state.params)
    out["cnn_sd"] = {k: v.numpy() for k, v in load_flax_simple(
        PCNN(**ranks.CNN, device="cpu"), init).state_dict().items()}
    out["dp_fsdp"] = task

    lay = jlayout.Layout("fsdp_tp", fsdp=2, tp=2)
    lm = TransformerLM(**ranks.LM, dtype=jnp.float32)
    task = prepare_training(
        lm, SyntheticTextDataset(vocab=ranks.LM["vocab"], seqlen=16),
        joptim.adam(1e-3), loss_fn=lm_loss_fn(lm), topk=(), batch_size=8,
        cycles=3, seed=0, layout=lay, mesh=lay.build_mesh(devs=devs))
    out["lm_sd"] = flax_to_state_dict(jax.tree.map(np.asarray,
                                                   task.state.params))
    out["fsdp_tp"] = task
    return out


@pytest.fixture(scope="module")
def spawn(jax_tasks):
    """The ranks' run, started before the JAX layouts step."""
    return Spawned(ranks.layout_modes, N, jax_tasks["cnn_sd"],
                   jax_tasks["lm_sd"])


@pytest.fixture(scope="module")
def jax_layouts(jax_tasks, spawn):
    """The JAX layouts' 3 losses each."""
    return {name: _jax_losses(jax_tasks[name])
            for name in ("dp_fsdp", "fsdp_tp")}


def _jax_losses(task) -> list:
    out, state = [], task.state
    for batch in task.loader:
        state, m = task.step_fn(state, batch)
        out.append(float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def four(spawn):
    return spawn.result()


@pytest.mark.parametrize("name", ["dp_fsdp", "fsdp_tp"])
def test_layouts_train_at_jax_loss_parity(jax_layouts, four, name):
    """``tests/test_rules.py:203``'s bar at 4 ranks: the rule-derived
    layout trains at loss parity with the JAX layout."""
    for out in four:
        got = out[name]
        assert len(got) == 3
        np.testing.assert_allclose(got, jax_layouts[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_layout_meshes_and_specs(four):
    out = four[0]
    assert out["dp_fsdp_mesh"] == {"data": 2, "fsdp": 2, "model": 1}
    # the tiny CNN's leaves are all under the overlay's 2048 elements
    assert not any("'" in s for s in out["dp_fsdp_specs"].values())
    assert out["fsdp_tp_mesh"] == {"data": 1, "fsdp": 2, "model": 2}
    assert out["fsdp_tp_heads"] == 2
    assert out["fsdp_tp_specs"]["embed.weight"] == "P('model', 'fsdp')"
    assert out["fsdp_tp_specs"]["blocks.0.fc2.weight"] == "P('fsdp', 'model')"


def test_cli_layout_equals_train(four):
    for out in four:
        assert len(out["cli_losses"]) == 3
        assert out["cli_losses"] == out["train_losses"]


# per-rank bytes of lm_small's (vocab 32000) f32 params and Adam moments,
# counted (not measured) from the blocks each spec cuts: (params, moments)
LM_SMALL_STATE_BYTES = {
    ("dp", 4): (438_528_000, 877_056_000),
    ("spmd fsdp", 4): (109_802_496, 219_604_992),
    ("spmd tp", 4): (109_802_496, 219_604_992),
    ("spmd fsdp_tp data 2 x model 2", 4): (109_867_008, 219_734_016),
    ("layout dp_fsdp", 4): (219_377_664, 438_755_328),
    ("layout fsdp_tp", 4): (109_867_008, 219_734_016),
    ("layout dp_fsdp_tp", 8): (109_867_008, 219_734_016),
}


def test_lm_small_state_bytes_per_rank():
    """What a rank holds of lm_small's state under each mode, from the
    specs on meta tensors (the shapes a gloo or NCCL rank cuts): every
    sharded mode keeps 1/N of the large leaves, the norms and the
    row-parallel biases whole."""
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.parallel import TrainState, fsdp, tp
    from fluxdistributed_tpu_torch.sharding import map_with_specs
    from fluxdistributed_tpu_torch.tree import leaves

    with torch.device("meta"):
        model = lm_small(vocab=32000, device="meta")
    params = dict(model.named_parameters())
    st = TrainState.create(params, optim.adam(1e-3))

    def count(specs, mesh):
        return tuple(sum(x.numel() * 4 for x in leaves(map_with_specs(
            lambda x, s: local_block(x, s, mesh), tree, spec)))
            for tree, spec in ((st.params, specs.params),
                               (st.opt_state, specs.opt_state)))

    got = {}
    dm = _fake_mesh({"data": 4})
    got[("dp", 4)] = count(tp.state_specs(st, {k: P() for k in params}), dm)
    got[("spmd fsdp", 4)] = count(fsdp.fsdp_specs(st, dm), dm)
    mm = _fake_mesh({"data": 1, "model": 4})
    got[("spmd tp", 4)] = count(tp.state_specs(st, tp.param_specs(
        params, tp.lm_tp_rules())), mm)
    mm = _fake_mesh({"data": 2, "model": 2})
    got[("spmd fsdp_tp data 2 x model 2", 4)] = count(tp.state_specs(
        st, fsdp.hybrid_fsdp_tp_specs(params, mm, tp.lm_tp_rules())), mm)
    for name, n in (("dp_fsdp", 4), ("fsdp_tp", 4), ("dp_fsdp_tp", 8)):
        lay = layout.resolve_layout(name, n)
        mesh = _fake_mesh(lay.sizes)
        got[(f"layout {name}", n)] = count(
            layout.state_specs_for(model, st, lay, mesh), mesh)
    assert got == LM_SMALL_STATE_BYTES


def test_layout_guard_sentinel_equals_dp():
    """``guard=True`` with a layout (the JAX layout path takes it): on
    one gloo rank the dp layout's sentinel, each leaf's squares summed
    over its blocks, equals the one-device DP step's bit for bit."""
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.mesh import shutdown_distributed
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import prepare_training

    ds = SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3))
    metrics = {}
    try:
        for name, kw in (("dp", {}), ("layout", {"layout": "dp"})):
            task = prepare_training(
                SimpleCNN(num_classes=4, features=8, device="cpu"), ds,
                optim.lars(0.1), batch_size=16, cycles=1, guard=True,
                device="cpu", **kw)
            _, metrics[name] = task.step_fn(task.state,
                                            next(iter(task.loader)))
    finally:
        shutdown_distributed()
    assert torch.equal(metrics["layout"]["guard"], metrics["dp"]["guard"])
    assert torch.equal(metrics["layout"]["loss"], metrics["dp"]["loss"])
