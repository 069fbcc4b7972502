"""Port parity: FSDP (``parallel/fsdp.py``) against the JAX package.

The port's N-rank world is 4 gloo ranks on the CPU (one spawn, bodies
in ``test_torch_port_fsdp_ranks.py``); the JAX side runs on
``data_mesh(4)`` of the conftest's virtual CPU devices, from the same
flax SimpleCNN weights and the same global batch (``tests/test_fsdp.py``'s
setup).

Tolerances are the JAX file's own: losses rtol 1e-6, params rtol 2e-5 /
atol 1e-6 against JAX's ``make_train_step_fsdp`` (GSPMD sums in another
order).  FSDP against the port's DP step: bit for bit over 2-rank groups,
where a sum of two values is the same in either order; over 4 ranks
gloo's all-reduce and reduce-scatter add the four values in other
orders, so within the same limits.  LARS under FSDP against DP: its norms are
``sqrt`` of summed squares over the blocks, where DP's are
``torch.linalg.vector_norm`` of the whole leaf, so rtol 1e-5 / atol
1e-6.  The fsdp CLI on one CPU rank equals the one-device step bit for
bit (every collective of one rank is a copy).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_fsdp_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import SimpleCNN as JSimpleCNN
from fluxdistributed_tpu.ops import logitcrossentropy as jxent
from fluxdistributed_tpu.parallel import TrainState as JState
from fluxdistributed_tpu.parallel import fsdp as jfsdp
from fluxdistributed_tpu.parallel import make_train_step as jmake_step
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu_torch.models import load_flax_simple
from fluxdistributed_tpu_torch.parallel import fsdp
from fluxdistributed_tpu_torch.sharding import P
from fluxdistributed_tpu_torch.train.checkpoint import load_checkpoint

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

N, BATCH, NCLASS = 4, 32, ranks.NCLASS


def _port_names(params) -> dict:
    """A flax SimpleCNN tree (numpy) as the port's state_dict."""
    from fluxdistributed_tpu_torch.models import SimpleCNN

    m = load_flax_simple(SimpleCNN(num_classes=NCLASS, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def setup():
    model = JSimpleCNN(num_classes=NCLASS)
    x = jax.random.normal(jax.random.PRNGKey(1), (BATCH, 8, 8, 3),
                          jnp.float32)
    y = jax.nn.one_hot(jax.random.randint(jax.random.PRNGKey(2), (BATCH,),
                                          0, NCLASS), NCLASS)
    params = model.init(jax.random.PRNGKey(0), x[:2], train=True)["params"]
    return (params, flax_loss_fn(model, jxent), np.asarray(x),
            np.asarray(y))


@pytest.fixture(scope="module")
def spawn(setup, tmp_path_factory):
    """The ranks' run (and its checkpoint directory), started before the
    JAX references compute."""
    params, _, x, y = setup
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    return Spawned(ranks.fsdp_modes, N, _port_names(params), x, y,
                   ckpt), ckpt


@pytest.fixture(scope="module")
def jax_runs(setup, spawn):
    """JAX FSDP (momentum 3 steps; accum_steps=2 and the eval step) and
    JAX DP with LARS, on data_mesh(4)."""
    params, loss_fn, x, y = setup
    mesh = jdata_mesh(N)
    b = jsharding.shard_batch({"image": x, "label": y}, mesh)
    opt = joptim.momentum(0.05, 0.9)

    def fsdp_state():
        st = JState.create(params, opt)
        specs = jfsdp.fsdp_specs(st, mesh, min_size=ranks.MIN_SIZE)
        return jfsdp.shard_state(st, specs, mesh), specs

    out = {}
    st, specs = fsdp_state()
    step = jfsdp.make_train_step_fsdp(loss_fn, opt, mesh, specs,
                                      donate=False)
    losses = []
    for _ in range(3):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    out["fsdp"] = (losses, _port_names(st.params))
    st, specs = fsdp_state()
    step = jfsdp.make_train_step_fsdp(loss_fn, opt, mesh, specs,
                                      donate=False, accum_steps=2)
    st, m = step(st, b)
    out["accum"] = ([float(m["loss"])], _port_names(st.params))
    ev_loss, ev = jfsdp.make_eval_step_fsdp(loss_fn, mesh, specs,
                                            topk=(1,))(st, b)
    out["eval"] = (float(ev_loss), float(ev["top1"]))
    lars = joptim.lars(0.1, weight_decay=1e-4)
    st = JState.create(jsharding.replicate(params, mesh), lars)
    step = jmake_step(loss_fn, lars, mesh, donate=False)
    losses = []
    for _ in range(3):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    out["lars_dp"] = (losses, _port_names(st.params))
    return out


@pytest.fixture(scope="module")
def four(spawn):
    return spawn[0].result(), spawn[1]


def _close(got, ref, what, rtol=2e-5, atol=1e-6, loss_rtol=1e-6):
    np.testing.assert_allclose(got[0], ref[0], rtol=loss_rtol, atol=0,
                               err_msg=what)
    assert set(got[1]) == set(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {k}")


def test_leaf_spec_rule():
    """``tests/test_fsdp.py``'s cases, as the port's shapes read them."""
    assert fsdp.fsdp_leaf_spec((4096, 512), "data", 8) == P("data", None)
    assert fsdp.fsdp_leaf_spec((512, 4096), "data", 8) == P(None, "data")
    assert fsdp.fsdp_leaf_spec((4096, 4096), "data", 8) == P(None, "data")
    # a tie goes to the trailing dim: in a torch OIHW conv whose
    # feature dims tie, the input features (dim 1), where the JAX HWIO
    # kernel splits its output features (the same shard size; C9)
    assert fsdp.fsdp_leaf_spec((256, 256, 3, 3), "data", 8) == P(
        None, "data", None, None)
    assert fsdp.fsdp_leaf_spec((3, 3, 256, 256), "data", 8) == P(
        None, None, None, "data")
    assert fsdp.fsdp_leaf_spec((64,), "data", 8) == P()
    assert fsdp.fsdp_leaf_spec((63, 65), "data", 8, min_size=1) == P()
    assert fsdp.fsdp_leaf_spec((), "data", 8) == P()
    # the hybrid's base entries are kept and never chosen again
    assert fsdp.fsdp_leaf_spec((64, 32), "data", 2, min_size=1,
                               base=P("model", None)) == P("model", "data")


def test_leaf_spec_matches_jax_on_the_same_shapes():
    from fluxdistributed_tpu.parallel.fsdp import fsdp_leaf_spec as jspec

    for shape in [(4096, 512), (512, 4096), (4096, 4096), (64,), (63, 65),
                  (3, 3, 256, 256), (256, 256, 3, 3), (12, 8, 6), ()]:
        for n in (1, 2, 4, 8):
            got = fsdp.fsdp_leaf_spec(shape, "data", n, min_size=1)
            ref = jspec(shape, "data", n, min_size=1)
            assert tuple(got) == tuple(ref), (shape, n, got, ref)


def test_fsdp_matches_jax_fsdp(jax_runs, four):
    for r in range(N):
        _close(four[0][r]["fsdp"], jax_runs["fsdp"], f"rank {r}")


@pytest.mark.parametrize("ranks_", [2, 4])
def test_fsdp_matches_port_dp(four, ranks_):
    """Bit for bit over 2-rank groups (a sum of two is the same in any
    order); over 4 ranks gloo's all-reduce and reduce-scatter add the
    four values in other orders, so within the JAX limits."""
    for out in four[0]:
        if ranks_ == 2:
            got, ref = out["fsdp2"], out["dp2"]
            assert got[0] == ref[0]
            for k, v in ref[1].items():
                np.testing.assert_array_equal(got[1][k], v, err_msg=k)
        else:
            _close(out["fsdp"], out["dp"], "fsdp vs port dp")


def test_fsdp_shards_memory(four):
    """Sharded leaves hold 1/N of their elements on each rank, and
    Adam's moments follow (``tests/test_fsdp.py:98``)."""
    out = four[0][0]
    glob = {k: v.size for k, v in out["dp"][1].items()}
    sharded = 0
    for k, spec in out["specs"].items():
        if any(e is not None for e in spec):
            assert out["local_numel"][k] * N == glob[k], k
            assert out["moment_numel"][k] == (glob[k] // N,) * 2, k
            sharded += 1
        else:
            assert out["local_numel"][k] == glob[k], k
    assert sharded > 0, "no leaf was sharded"


def test_fsdp_accum_and_eval_match_jax(jax_runs, four):
    out = four[0][0]
    _close(out["accum"], jax_runs["accum"], "accum_steps=2")
    np.testing.assert_allclose(out["eval"][0], jax_runs["eval"][0],
                               rtol=1e-6)
    assert out["eval"][1] == jax_runs["eval"][1]
    assert 0.0 <= out["eval"][1] <= 1.0


def test_fsdp_lars_matches_dp(jax_runs, four):
    out = four[0][0]
    _close(out["lars_fsdp"], out["lars_dp"], "lars fsdp vs port dp",
           rtol=1e-5, loss_rtol=1e-6)
    _close(out["lars_fsdp"], jax_runs["lars_dp"], "lars fsdp vs jax dp",
           rtol=1e-5, loss_rtol=1e-6)


def test_fsdp_checkpoint_roundtrip(four):
    """Saved at global shapes, restored onto the blocks bit for bit, and
    the restored state steps (``tests/test_fsdp.py:155``)."""
    for out in four[0]:
        assert out["ckpt_equal"]
        assert np.isfinite(out["ckpt_next_loss"])


def test_fsdp_checkpoint_restores_onto_other_layouts(four):
    """The 4-rank FSDP checkpoint onto a ``dp_fsdp`` (2 x 2) layout of
    the same ranks, and onto one process with no mesh (another rank
    count): the global values each time."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.parallel import TrainState

    outs, ckpt = four
    ref = outs[0]["ckpt_params"]
    for out in outs:
        assert out["layout_mesh"] == {"data": 2, "fsdp": 2, "model": 1}
        assert out["layout_restored_step"] == 1
        for k, v in ref.items():
            np.testing.assert_array_equal(out["layout_restored"][k], v)
    target = TrainState.create({k: torch.zeros(v.shape)
                                for k, v in ref.items()},
                               optim.momentum(0.05, 0.9))
    one = load_checkpoint(ckpt, target)
    assert one.step == 1
    for k, v in ref.items():
        np.testing.assert_array_equal(one.params[k].numpy(), v)


def test_fsdp_through_trainer(four):
    """``prepare_training(spmd="fsdp")`` shards the state and the loss
    falls (``tests/test_fsdp.py:123``); ``train`` returns global
    shapes."""
    out = four[0][0]
    losses = out["trainer_losses"]
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert out["trainer_sharded"], "no trainer param leaf is sharded"
    assert out["trainer_host_shapes"]["conv2.weight"] == (32, 16, 3, 3)


def test_fsdp_val_slice_and_evaluate_take_the_sharded_state(four):
    """The val slice splits over the batch ranks (40 rows, 10 a rank),
    and ``evaluate`` on the FSDP task gives the DP task's metrics (the
    same run; within the FSDP-against-DP limits)."""
    for out in four[0]:
        assert out["trainer_val_rows"] == 10
        fs, dp = out["evaluate_fsdp"], out["evaluate_jit"]
        assert fs["samples"] == dp["samples"] == 64 and fs["exact"]
        np.testing.assert_allclose(fs["loss"], dp["loss"], rtol=2e-5)
        for k in ("top1", "top5", "top10"):
            assert fs[k] == dp[k], k


def test_fsdp_cli_one_rank_equals_one_device(capsys):
    base = ["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
            "--batch-size", "4", "--cycles", "4", "--attn", "flash",
            "--opt", "adam", "--lr", "3e-3", "--eval-every", "2",
            "--device", "cpu"]
    ref = cli.run(base)
    task = cli.run(base + ["--spmd", "fsdp"])
    assert task.specs is not None and task.mesh.shape == {"data": 1}
    assert "spmd fsdp" in capsys.readouterr().out
    assert task.losses == ref.losses and len(ref.losses) == 4
    for k, p in ref.state.params.items():
        assert torch.equal(task.state.params[k], p), k
    import torch.distributed as dist

    assert not dist.is_initialized()  # the CLI ended the group it formed
