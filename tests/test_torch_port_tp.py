"""Port parity: Megatron tensor parallelism (``parallel/tp.py``), the
FSDP x TP hybrid and their refusals, against the JAX package.

The port's world is 4 gloo ranks on the CPU laid out ``{data: 2, model:
2}`` (one spawn, bodies in ``test_torch_port_tp_ranks.py``); the JAX
side runs ``make_train_step_tp`` on ``make_mesh({"data": 2, "model":
2})`` over 4 of the conftest's virtual CPU devices, device ``r`` at the
coordinates of rank ``r``.  Weights are the flax models' (converted by
``models/from_jax.py``), batches the same global arrays.

Tolerances are the JAX files' own: vit_tiny (f32, dropout 0, 2 momentum
steps) losses rtol 1e-5, params rtol/atol 2e-4
(``tests/test_tensor_parallel.py``); the LM variants (3 steps) losses
rtol 1e-5, params rtol 2e-4 / atol 1e-5
(``tests/test_transformer_lm.py:331``).  A rank's blocks before the
first step equal the conversion of JAX device ``r``'s addressable
shards bit for bit (the same numbers, cut the same way).  The CLI's
``--spmd fsdp_tp --tp 2`` equals ``train()`` with the same arguments
bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_tp_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import onehot as jonehot
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models import lm_loss_fn as jlm_loss_fn
from fluxdistributed_tpu.models import lm_tiny as jlm_tiny
from fluxdistributed_tpu.models import vit_tiny as jvit_tiny
from fluxdistributed_tpu.ops import logitcrossentropy as jxent
from fluxdistributed_tpu.parallel import TrainState as JState
from fluxdistributed_tpu.parallel import fsdp as jfsdp
from fluxdistributed_tpu.parallel import tp as jtp
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models import (flax_to_state_dict,
                                              flax_vit_to_state_dict,
                                              lm_loss_fn, lm_tiny)
from fluxdistributed_tpu_torch.parallel import tp

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

N = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _device_shards(tree, dev):
    """JAX device ``dev``'s addressable shard of every leaf."""
    def one(a):
        return next(np.asarray(s.data) for s in a.addressable_shards
                    if s.device == dev)

    return jax.tree.map(one, tree)


def _jax_tp(mesh, loss_fn, opt, params, specs, batch, steps, convert):
    st = jtp.shard_state(JState.create(params, opt), mesh, specs)
    devs = list(mesh.devices.reshape(-1))
    blocks = [convert(_device_shards(st.params, d)) for d in devs]
    step = jtp.make_train_step_tp(loss_fn, opt, mesh, specs, st,
                                  donate=False)
    losses = []
    for _ in range(steps):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    return blocks, (losses, convert(_np_tree(st.params)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 32, 32, 3)).astype(np.float32)
    y = np.asarray(jonehot(rng.integers(0, 10, 16), 10))
    toks = np.random.default_rng(7).integers(
        0, ranks.VOCAB, (16, 24)).astype(np.int32)
    vit = jvit_tiny(num_classes=10, dtype=jnp.float32, dropout=0.0)
    vparams = vit.init(jax.random.PRNGKey(0), x[:1], train=False)["params"]
    lms = {}
    for name, kw in ranks.LM_CASES.items():
        m = jlm_tiny(vocab=ranks.VOCAB, dtype=jnp.float32, **ranks.SMALL,
                     **kw)
        lms[name] = (m, m.init(jax.random.PRNGKey(0), toks[:2],
                               train=False)["params"])
    return x, y, toks, (vit, vparams), lms


@pytest.fixture(scope="module")
def spawn(data):
    """The ranks' run, started before the JAX references compute."""
    x, y, toks, (_, vparams), lms = data
    sds = {k: flax_to_state_dict(_np_tree(p)) for k, (_, p) in lms.items()}
    return Spawned(ranks.tp_modes, N,
                   flax_vit_to_state_dict(_np_tree(vparams)), x, y, sds,
                   toks)


@pytest.fixture(scope="module")
def jax_runs(data, spawn):
    x, y, toks, (vit, vparams), lms = data
    mesh = jmake_mesh({"data": 2, "model": 2})
    out = {"coords": [dict(zip(mesh.axis_names, np.argwhere(
        mesh.devices == d)[0].tolist())) for d in mesh.devices.reshape(-1)]}
    out["vit_blocks"], out["vit"] = _jax_tp(
        mesh, flax_loss_fn(vit, jxent), joptim.momentum(0.1, 0.9), vparams,
        jtp.param_specs(vparams, jtp.vit_tp_rules()),
        jsharding.shard_batch({"image": x, "label": y}, mesh), 2,
        flax_vit_to_state_dict)
    b = jsharding.shard_batch({"tokens": toks}, mesh)
    for name, (m, params) in lms.items():
        rules = jtp.lm_tp_rules(shard_vocab=name != "untied")
        out[f"{name}_blocks"], out[name] = _jax_tp(
            mesh, jlm_loss_fn(m), joptim.momentum(0.05, 0.9), params,
            jtp.param_specs(params, rules), b, 3, flax_to_state_dict)
    m, params = lms["tied"]
    specs = jfsdp.hybrid_fsdp_tp_specs(params, mesh, jtp.lm_tp_rules(),
                                       min_size=ranks.MIN_SIZE)
    out["hybrid_blocks"], out["hybrid"] = _jax_tp(
        mesh, jlm_loss_fn(m), joptim.momentum(0.05, 0.9), params, specs, b,
        3, flax_to_state_dict)
    return out


@pytest.fixture(scope="module")
def four(spawn):
    return spawn.result()


def _close(got, ref, what, rtol, atol, loss_rtol=1e-5):
    np.testing.assert_allclose(got[0], ref[0], rtol=loss_rtol, atol=0,
                               err_msg=what)
    assert set(got[1]) == set(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {k}")


def test_rank_coordinates_are_jax_devices(jax_runs, four):
    for r in range(N):
        assert four[r]["coords"] == jax_runs["coords"][r]


def test_vit_tp_matches_jax(jax_runs, four):
    for r in range(N):
        _close(four[r]["vit"], jax_runs["vit"], f"vit rank {r}", 2e-4, 2e-4)
        assert four[r]["vit_heads"] == 2


@pytest.mark.parametrize("case", ["vit", "tied", "gqa", "swiglu", "untied",
                                  "hybrid"])
def test_rank_blocks_are_jax_device_shards(jax_runs, four, case):
    """Rank ``r``'s blocks of every leaf equal the conversion of JAX
    device ``r``'s addressable shard (qkv / out / MLP / embedding split,
    the rest whole).  One exception, the hybrid's qkv bias: JAX splits
    its ``[3, H, hd]`` heads over model and ``hd`` over data, which is
    no block of the port's flat ``3 H hd`` bias, so the port keeps the
    bias split over model only: rank ``r``'s block is the two data
    ranks' JAX shards joined on ``hd`` (ROADMAP C9)."""
    hd = ranks.SMALL["dim"] // ranks.SMALL["num_heads"]
    for r in range(N):
        got, ref = four[r][f"{case}_blocks"], jax_runs[f"{case}_blocks"][r]
        assert set(got) == set(ref)
        for k in ref:
            want = ref[k]
            if case == "hybrid" and k.endswith("qkv.bias"):
                m = r % 2  # the model coordinate; data ranks m and 2 + m
                parts = [jax_runs["hybrid_blocks"][d * 2 + m][k].reshape(
                    3, -1, hd // 2) for d in (0, 1)]
                want = np.concatenate(parts, axis=2).reshape(-1)
            np.testing.assert_array_equal(got[k], want,
                                          err_msg=f"{case} rank {r}: {k}")


@pytest.mark.parametrize("case", ["tied", "gqa", "swiglu", "untied"])
def test_lm_tp_matches_jax(jax_runs, four, case):
    for r in range(N):
        _close(four[r][case], jax_runs[case], f"{case} rank {r}", 2e-4, 1e-5)


def test_hybrid_matches_jax(jax_runs, four):
    """``hybrid_fsdp_tp_specs`` (``tests/test_fsdp.py:185``): the
    embedding split over model (vocab) and data (dim), the qkv over
    model (heads) and data (its input dim), as the JAX specs place
    them; 3 steps at the JAX limits."""
    specs = four[0]["hybrid_specs"]
    assert specs["embed.weight"] == "P('model', 'data')"
    assert specs["blocks.0.attn.qkv.weight"] == (
        "P(Stacked(axis='model', parts=3), 'data')")
    for r in range(N):
        _close(four[r]["hybrid"], jax_runs["hybrid"], f"hybrid rank {r}",
               2e-4, 1e-5)
        emb = four[r]["hybrid_blocks"]["embed.weight"]
        assert emb.size * N == jax_runs["hybrid"][1]["embed.weight"].size


def test_fsdp_tp_through_trainer(four):
    out = four[0]
    losses = out["trainer_losses"]
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert out["trainer_embed_spec"] == "P('model', 'data')"
    assert out["trainer_embed_local"] == (16, 32)
    assert out["trainer_embed_global"] == (32, 64)
    # the model keeps its tensor-parallel block of the vocab
    assert out["trainer_model_embed"] == (16, 64)


def test_cli_fsdp_tp_equals_train(four):
    for out in four:
        assert out["cli_mesh"] == {"data": 2, "model": 2}
        assert len(out["cli_losses"]) == 4
        assert out["cli_losses"] == out["train_losses"]


def _fake_mesh(axes: dict, coords=None) -> Mesh:
    """A mesh of no process group (to cut blocks and check refusals)."""
    return Mesh(group=None, rank=0, size=int(np.prod(list(axes.values()))),
                device=torch.device("cpu"), axis=next(iter(axes)),
                axes=tuple(axes.items()),
                coords=coords or (0,) * len(axes))


def _lm(**kw):
    return lm_tiny(vocab=ranks.VOCAB, dtype=torch.float32, device="cpu",
                   **{**ranks.SMALL, **kw})


def test_tensor_parallel_refusals():
    from fluxdistributed_tpu_torch.models import SimpleCNN

    with pytest.raises(ValueError, match="do not split"):
        tp.tensor_parallel(_lm(), _fake_mesh({"model": 8}), tp.lm_tp_rules())
    with pytest.raises(ValueError, match="no tensor-parallel modules"):
        tp.tensor_parallel(SimpleCNN(device="cpu"), _fake_mesh({"model": 2}),
                           tp.lm_tp_rules())
    # a module split in part: qkv split, its output projection not
    from fluxdistributed_tpu_torch.sharding import P, Stacked

    half = [(r"\.qkv\.weight$", P(Stacked("model", 3), None)),
            (r"\.qkv\.bias$", P(Stacked("model", 3)))]
    with pytest.raises(ValueError, match="are not split"):
        tp.tensor_parallel(_lm(), _fake_mesh({"model": 2}), half)
    with pytest.raises(ValueError, match="needs dim 1"):
        tp.tensor_parallel(_lm(), _fake_mesh({"model": 2}), [
            (r"\.fc1\.weight$", P("model", None)),
            (r"\.fc1\.bias$", P("model")),
            (r"\.fc2\.weight$", P("model", None))])
    m = tp.tensor_parallel(_lm(), _fake_mesh({"model": 1}), tp.lm_tp_rules())
    with pytest.raises(ValueError, match="already"):
        tp.tensor_parallel(m, _fake_mesh({"model": 1}), tp.lm_tp_rules())
    with pytest.raises(NotImplementedError, match="decode"):
        from fluxdistributed_tpu_torch.models import generate

        generate(m, torch.zeros((1, 4), dtype=torch.int64), 6)


def test_prepare_training_tp_refusals():
    """The JAX trainer's refusals for spmd tp/fsdp_tp, on one gloo rank."""
    from fluxdistributed_tpu_torch.data import (SyntheticDataset,
                                                SyntheticTextDataset)
    from fluxdistributed_tpu_torch.mesh import (data_mesh, init_distributed,
                                                make_mesh,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import prepare_training

    text = SyntheticTextDataset(vocab=ranks.VOCAB, seqlen=16)

    def prep(model=None, ds=text, **kw):
        model = model or _lm()
        lm = isinstance(ds, SyntheticTextDataset)
        return prepare_training(model, ds, optim.adam(1e-3), batch_size=4,
                                cycles=2, device="cpu",
                                loss_fn=lm_loss_fn(model) if lm else None,
                                **kw)

    with pytest.raises(ValueError, match="accum_steps > 1 requires"):
        prep(spmd="tp", accum_steps=2)
    with pytest.raises(ValueError, match="needs a mesh with a 'model' axis"):
        prep(spmd="tp")
    with pytest.raises(ValueError, match="requires spmd='jit'"):
        prep(spmd="fsdp_tp", steps_per_call=2)
    with pytest.raises(ValueError, match="loss-only"):
        prep(spmd="tp", guard=True)
    with pytest.raises(ValueError, match="DP paths only"):
        prep(spmd="fsdp_tp", zero1=True)
    init_distributed("cpu")
    try:
        with pytest.raises(ValueError, match="'model' axis"):
            prep(spmd="tp", mesh=data_mesh(device="cpu"))
        mm = make_mesh({"data": 1, "model": 1}, device="cpu")
        with pytest.raises(ValueError, match="dropout=0 only"):
            prep(_lm(dropout=0.1), spmd="fsdp_tp", mesh=mm)
        with pytest.raises(ValueError, match="no TP sharding rules for "
                                             "SimpleCNN"):
            prep(SimpleCNN(num_classes=4, device="cpu"),
                 SyntheticDataset(nsamples=16, nclasses=4, shape=(8, 8, 3)),
                 spmd="tp", mesh=mm)
        task = prep(spmd="tp", mesh=mm)
        assert task.specs is not None and task.model.tp_applied
    finally:
        shutdown_distributed()


def test_cli_refusals_mirror_the_driver():
    base = ["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
            "--batch-size", "4", "--cycles", "1", "--device", "cpu"]
    for extra, match in [
            (["--tp", "2"], "--tp only applies with --spmd tp or fsdp_tp"),
            (["--spmd", "tp", "--tp", "2"],
             "--tp 2 must be >=1 and divide 1 devices"),
            (["--spmd", "fsdp_tp"], "--spmd fsdp_tp needs --tp < device "
                                    "count"),
            (["--spmd", "fsdp_tp", "--tp", "1"], "--spmd fsdp_tp needs --tp"),
            (["--spmd", "tp", "--tp", "2", "--kv-heads", "1"],
             r"--kv-heads 1 must be a multiple of the TP model-axis size "
             r"\(2\)"),
            (["--spmd", "fsdp", "--zero1"], "--zero1 only applies"),
            (["--layout", "dp", "--spmd", "fsdp"],
             "--layout builds the rule-derived 3-D step"),
            (["--layout", "dp", "--zero1"], "--layout cannot combine"),
            (["--hbm-bytes", "1e9"], "--hbm-bytes/--layout-report only "
                                     "apply with --layout auto"),
            (["--layout", "fsdp"], "--layout fsdp: layout preset 'fsdp' "
                                   "does not exist on 1 device")]:
        with pytest.raises(SystemExit, match=match):
            cli.run(base + extra)
    # the picker prices and nothing fits 1 byte
    with pytest.raises(SystemExit, match="no layout fits"):
        cli.run(base + ["--layout", "auto", "--hbm-bytes", "1"])
    import torch.distributed as dist

    assert not dist.is_initialized()
