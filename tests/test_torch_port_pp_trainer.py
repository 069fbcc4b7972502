"""Port parity: ``prepare_training(spmd="pp"|"pp_1f1b")`` and the
training CLI's pipeline flags, against the JAX trainer.

On 4 gloo CPU ranks laid out ``{data: 2, pipe: 2}`` (one spawn, bodies
in ``test_torch_port_pp_ranks.py``), from the JAX trainer's own initial
weights (its split tree carried across by
``models.flax_split_to_state_dict``): 3 adam steps (lr 3e-3) on the same
batch under GPipe, 1F1B, zero-bubble 1F1B and the interleaved placement,
2 microbatches a data row, f32.  Losses and the eval loss within 1e-5
relative of JAX's (ZB against JAX's 1F1B, which JAX pins bit-equal to
its ZB), the gathered params within 2 lr (adam's first steps move each
entry by about lr, whatever the gradient's size), and ZB equal to the
port's 1F1B bit for bit.  Also on the ranks: the val slice and
``evaluate`` at the data x microbatch quantum, a checkpoint resume
equal to the straight run bit for bit, a GPipe checkpoint restored
into a 1F1B task, and ``--spmd pp --pipe 2`` / ``--spmd pp_1f1b``
through the CLI equal to ``prepare_training`` + ``train``.  In this
process: every refusal of the JAX tests (``tests/test_trainer_pp.py``,
``tests/test_pp_zb.py``) with the same ``match=``, the CLI's refusals
with ``bin/driver.py``'s messages, and ``--spmd pp --pipe 1`` on one
rank against the one-device step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_pp_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.data import SyntheticTextDataset as JText
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models.transformer_lm import TransformerLM as JLM
from fluxdistributed_tpu.parallel import pp_plan as jplan
from fluxdistributed_tpu.train import prepare_training as jprepare
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import SyntheticTextDataset
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models import (SimpleCNN,
                                              flax_split_to_state_dict,
                                              lm_loss_fn, lm_tiny)
from fluxdistributed_tpu_torch.parallel.pp_plan import plan_stages
from fluxdistributed_tpu_torch.train import prepare_training

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

N = 4
LR = ranks.LR


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh():
    return jmake_mesh({"data": 2, "pipe": 2}, jax.devices()[:N])


def _jtask(**kw):
    return jprepare(JLM(dtype=jnp.float32, dropout=0.0, **ranks.TRAIN_LM),
                    JText(vocab=32, seqlen=16), joptim.adam(LR),
                    mesh=_jmesh(), batch_size=8, cycles=3,
                    num_microbatches=2, topk=(), **kw)


def _model_sd(split: dict, S: int) -> dict:
    """The model's names (``blocks.{i}.``) of a blocked global flat split
    tree of ``S`` stages (``(S, V, ...)`` stage leaves)."""
    V = ranks.TRAIN_LM["depth"] // S
    out = {}
    for k, v in split.items():
        kind, name = k.split("/", 1)
        if kind == "outer":
            out[name] = v
        else:
            for i, b in enumerate(v.reshape((S * V,) + v.shape[2:])):
                out[f"blocks.{i}.{name}"] = b
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    toks = np.random.default_rng(5).integers(0, 32, (8, 16)).astype(np.int32)
    split = flax_split_to_state_dict(_np_tree(_jtask(spmd="pp").state.params))
    ckpt = str(tmp_path_factory.mktemp("pp_ckpt"))
    ckpt_ab = str(tmp_path_factory.mktemp("pp_ckpt_ab"))
    return toks, split, ckpt, ckpt_ab


@pytest.fixture(scope="module")
def spawn(data):
    toks, split, ckpt, ckpt_ab = data
    return Spawned(ranks.trainer_all, N, _model_sd(split, 2), toks, ckpt,
                   ckpt_ab)


@pytest.fixture(scope="module")
def jax_runs(data, spawn):
    toks = data[0]
    out = {}
    for name, kw in (("pp", {"spmd": "pp"}),
                     ("pp_1f1b", {"spmd": "pp_1f1b"}),
                     ("interleaved", {"spmd": "pp_1f1b",
                                      "pipeline_interleave": True})):
        task = _jtask(**kw)
        st = task.state
        batch = jsharding.shard_batch({"tokens": toks}, task.mesh)
        losses = []
        for _ in range(ranks.TRAIN_STEPS):
            st, m = task.step_fn(st, batch)
            losses.append(float(m["loss"]))
        ev, metrics = task.eval_fn(st, batch)
        out[name] = {"losses": losses, "eval": float(ev),
                     "metrics": dict(metrics),
                     "params": flax_split_to_state_dict(_np_tree(st.params)),
                     "quantum": task.batch_quantum}
    return out


@pytest.fixture(scope="module")
def four(spawn, jax_runs):
    return spawn.result()


@pytest.mark.parametrize("name", ["pp", "pp_1f1b", "zb", "interleaved"])
def test_pp_trainer_matches_jax(jax_runs, four, name):
    ref = jax_runs["pp_1f1b" if name == "zb" else name]
    for r in range(N):
        got = four[r]["runs"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5)
        assert got["metrics"] == ref["metrics"] == {}
        assert got["quantum"] == ref["quantum"] == 4
        assert set(got["params"]) == set(ref["params"])
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=2 * LR, err_msg=k)
            np.testing.assert_array_equal(got["params"][k],
                                          four[0]["runs"][name]["params"][k])
        # this rank holds its stage: a (1, ...) block of every stage leaf
        for k, shape in got["local_shapes"].items():
            if k.startswith("stages/"):
                assert shape[0] == 1, (k, shape)
    if name == "zb":
        for r in range(N):
            a, b = four[r]["runs"]["zb"], four[r]["runs"]["pp_1f1b"]
            assert a["losses"] == b["losses"]
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k],
                                              b["params"][k])


def test_val_slice_and_evaluate_round_to_the_quantum(four):
    """val_samples=6 at quantum data 2 x microbatches 2 = 4: the slice
    takes 4 rows (2 a data row), and ``evaluate`` at batch_size 10 runs
    batches of 8 and a remainder rounded to the quantum."""
    for r in range(N):
        got = four[r]
        assert got["val_rows"] * 2 == 4
        assert np.isfinite(got["val_eval"])
        ev = got["evaluate"]
        assert ev["exact"] and ev["samples"] % 4 == 0 and ev["samples"] > 0
        assert np.isfinite(ev["loss"])
        assert ev["loss"] == four[0]["evaluate"]["loss"]


def test_checkpoint_resume_is_bit_exact(four):
    """2 steps, a checkpoint (global shapes), a fresh task restored from
    it and 1 more step: the straight 3-step run bit for bit."""
    for r in range(N):
        got, ref = four[r]["resume"], four[r]["runs"]["pp_1f1b"]
        assert got["step"] == 3
        assert got["losses"] == ref["losses"]
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_gpipe_checkpoint_restores_into_1f1b(four):
    for r in range(N):
        got = four[r]["gpipe_into_1f1b"]
        assert got["step"] == 2
        for k, v in got["saved"].items():
            np.testing.assert_array_equal(got["restored"][k], v, err_msg=k)
        assert all(np.isfinite(got["losses"]))


def test_cli_pp_equals_train(four):
    for r in range(N):
        for flags, got in four[r]["cli"].items():
            assert got["mesh"] == {"data": 2, "pipe": 2}, flags
            assert len(got["cli"]) == 3 and got["cli"] == got["train"], flags


# ------------------------------------------------------------ refusals

def _fake(axes):
    """A one-rank mesh of the given shape: the checks run before any
    collective."""
    names = tuple(axes)
    return Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                axis=names[0], axes=tuple(axes.items()),
                coords=(0,) * len(names))


def _model(depth=4):
    return ranks.lm_model(depth, True)


def test_pp_mode_rejects_bad_configs():
    """``tests/test_trainer_pp.py::test_pp_mode_rejects_bad_configs``
    with its ``match=`` patterns."""
    ds = SyntheticTextDataset(vocab=32, seqlen=24)
    pp = _fake({"data": 2, "pipe": 4})
    with pytest.raises(ValueError, match="TransformerLM only"):
        prepare_training(SimpleCNN(num_classes=10, device="cpu"), ds,
                         optim.adam(1e-3), mesh=pp, batch_size=16,
                         spmd="pp")
    with pytest.raises(ValueError, match="data.*pipe|pipe.*data"):
        prepare_training(_model(), ds, optim.adam(1e-3),
                         mesh=_fake({"data": 8}), batch_size=16, spmd="pp",
                         topk=())
    with pytest.raises(ValueError, match="data.*pipe|pipe.*data"):
        prepare_training(_model(), ds, optim.adam(1e-3), device="cpu",
                         batch_size=16, spmd="pp", topk=())
    with pytest.raises(ValueError, match="microbatches"):
        prepare_training(_model(), ds, optim.adam(1e-3), mesh=pp,
                         batch_size=16, spmd="pp", topk=(),
                         num_microbatches=3)
    m = _model()
    with pytest.raises(ValueError, match="loss_fn override"):
        prepare_training(m, ds, optim.adam(1e-3), mesh=pp, batch_size=16,
                         spmd="pp", topk=(), loss_fn=lm_loss_fn(m))
    with pytest.raises(ValueError, match="num_microbatches requires"):
        prepare_training(_model(), ds, optim.adam(1e-3), device="cpu",
                         batch_size=16, spmd="jit", topk=(),
                         num_microbatches=8)
    with pytest.raises(ValueError, match="pipeline_interleave requires"):
        prepare_training(_model(8), ds, optim.adam(1e-3), mesh=pp,
                         batch_size=16, spmd="pp", topk=(),
                         pipeline_interleave=True)
    with pytest.raises(ValueError, match="accum_steps > 1 requires"):
        prepare_training(_model(), ds, optim.adam(1e-3), mesh=pp,
                         batch_size=16, spmd="pp", accum_steps=2)
    for kw, msg in (({"zero1": True}, "zero1=True applies"),
                    ({"steps_per_call": 2}, "steps_per_call > 1 requires"),
                    ({"spmd": "pp_1f1b", "guard": True},
                     "guard=True builds the grad sentinel")):
        kw = {"spmd": "pp", **kw}
        with pytest.raises(ValueError, match=msg):
            prepare_training(_model(), ds, optim.adam(1e-3), mesh=pp,
                             batch_size=16, **kw)


def test_trainer_validation_surface():
    """``tests/test_pp_zb.py::test_trainer_validation_surface``: the
    pipeline options are checked before any model wiring."""
    ds = SyntheticTextDataset(vocab=16, seqlen=8)
    cnn = SimpleCNN(num_classes=4, device="cpu")
    for spmd in ("pp", "pp_1f1b"):
        with pytest.raises(ValueError, match="must be >= 1"):
            prepare_training(cnn, ds, optim.adam(1e-3), batch_size=8,
                             spmd=spmd, num_microbatches=0)
    with pytest.raises(ValueError, match="unknown pipeline_schedule"):
        prepare_training(cnn, ds, optim.adam(1e-3), batch_size=8,
                         spmd="pp_1f1b", pipeline_schedule="eager")
    with pytest.raises(ValueError, match="requires spmd='pp_1f1b'"):
        prepare_training(cnn, ds, optim.adam(1e-3), batch_size=8,
                         spmd="jit", pipeline_schedule="zb")
    with pytest.raises(ValueError, match="pp_plan requires"):
        prepare_training(cnn, ds, optim.adam(1e-3), batch_size=8,
                         spmd="jit", pp_plan=plan_stages([1.0] * 4, 2, 2))
    with pytest.raises(ValueError, match="pipeline_interleave"):
        prepare_training(cnn, ds, optim.adam(1e-3), batch_size=8,
                         spmd="pp_1f1b", pp_plan=plan_stages([1.0] * 4, 2, 2),
                         pipeline_interleave=True)


def test_trainer_plan_mismatch_and_mask_rejected(tmp_path):
    """``tests/test_pp_zb.py::test_trainer_plan_mismatch_rejected`` (a
    plan the JAX package saved, by path), and 1F1B's refusal of a
    masked dataset."""
    ds = SyntheticTextDataset(vocab=32, seqlen=8)
    mesh = _fake({"data": 2, "pipe": 4})
    path = jplan.plan_stages([1.0] * 8, 2, 4).save(str(tmp_path / "p.json"))
    with pytest.raises(ValueError, match="re-plan for this mesh"):
        prepare_training(_model(8), ds, optim.adam(1e-3), mesh=mesh,
                         batch_size=16, spmd="pp_1f1b", num_microbatches=4,
                         topk=(), pp_plan=path)
    with pytest.raises(ValueError, match="re-plan for this model"):
        prepare_training(_model(8), ds, optim.adam(1e-3), mesh=mesh,
                         batch_size=16, spmd="pp_1f1b", num_microbatches=4,
                         topk=(), pp_plan=plan_stages([1.0] * 12, 4, 4))

    class Masked(SyntheticTextDataset):
        def batch(self, rng, n, **kw):
            toks = super().batch(rng, n, **kw)
            return {"tokens": toks, "mask": np.ones_like(toks)}

    with pytest.raises(ValueError, match="does not support batch\\['mask'\\]"):
        prepare_training(_model(8), Masked(vocab=32, seqlen=8),
                         optim.adam(1e-3), mesh=mesh, batch_size=16,
                         spmd="pp_1f1b", num_microbatches=4)


def test_cli_pipeline_refusals_mirror_the_jax_cli(tmp_path):
    for extra, msg in (
            (["--pipe", "2"], "--pipe only applies with --spmd pp or pp_1f1b"),
            (["--microbatches", "2"],
             "--microbatches only applies with --spmd pp or pp_1f1b"),
            (["--spmd", "pp", "--pp-interleave"],
             "--pp-interleave only applies with --spmd pp_1f1b"),
            (["--spmd", "pp", "--pp-schedule", "zb"],
             "--pp-schedule zb only applies with --spmd pp_1f1b"),
            (["--pp-plan", "p.json"],
             "--pp-plan only applies with --spmd pp or pp_1f1b"),
            (["--spmd", "pp_1f1b", "--pp-plan", "p.json", "--pp-interleave"],
             "--pp-plan cannot combine with --pp-interleave"),
            (["--spmd", "pp", "--pipe", "2"],
             "--pipe 2 must be >=1 and divide 1 devices"),
            (["--spmd", "pp_1f1b", "--pipe", "1"],
             "1F1B needs >= 2 pipeline stages"),
            (["--spmd", "pp", "--model", "resnet18", "--dataset", "synthetic",
              "--image-size", "8", "--num-classes", "4"],
             "supports TransformerLM only")):
        with pytest.raises(SystemExit, match=msg):
            cli.run(ranks.CLI_ARGS + extra)
    # a cost profile from another topology is refused at resolution
    from fluxdistributed_tpu_torch.obs.profile import Profile

    foreign = str(tmp_path / "foreign.profile.json")
    Profile(fingerprint="0" * 16, static={"model": {
        "depth": 4, "block": {"flops": 1.0, "bytes": 1.0},
        "outer": {"flops": 1.0, "bytes": 1.0}}}).save(foreign)
    with pytest.raises(SystemExit, match="does not match this process"):
        cli.run(ranks.CLI_ARGS + ["--spmd", "pp", "--pp-plan", foreign])


def test_cli_pp_one_rank_against_the_one_device_step(tmp_path):
    """``--spmd pp --pipe 1`` (GPipe, S = 1, 2 microbatches) on one gloo
    rank against the one-device DP run: the first loss equal, the later
    ones within 1e-3 relative (the CLI's lm_tiny computes in bf16, and
    the half-batch microbatches' matmuls and the gradient sum over them
    round apart from the whole batch's); a saved one-stage plan
    (``--pp-plan``) gives the uniform run bit for bit."""
    pp = cli.run(ranks.CLI_ARGS + ["--spmd", "pp", "--pipe", "1",
                                   "--microbatches", "2"])
    dp = cli.run(ranks.CLI_ARGS)
    assert pp.mesh.shape == {"data": 1, "pipe": 1}
    assert pp.batch_quantum == 2
    assert pp.losses[0] == dp.losses[0]
    np.testing.assert_allclose(pp.losses, dp.losses, rtol=1e-3)
    path = plan_stages([1.0] * 4, 1, 2).save(str(tmp_path / "one.json"))
    planned = cli.run(ranks.CLI_ARGS + ["--spmd", "pp", "--pipe", "1",
                                        "--microbatches", "2", "--pp-plan",
                                        path])
    assert planned.losses == pp.losses
    # --pp-plan auto prices the blocks; one stage holds them all
    auto = cli.run(ranks.CLI_ARGS + ["--spmd", "pp", "--pipe", "1",
                                     "--microbatches", "2", "--pp-plan",
                                     "auto"])
    assert auto.losses == pp.losses
    assert lm_tiny(vocab=32, device="cpu").depth == 4
