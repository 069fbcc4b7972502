"""Port parity: the process-group layer, the collectives, N-rank DP and
ZeRO-1 (composable and fused, through the fused Adam update) against the
JAX package.

The port's N-rank worlds are gloo ranks on the CPU (``mesh.run_ranks``,
bodies in ``test_torch_port_zero1_ranks.py``); the JAX side runs on
``data_mesh(N)`` of the conftest's virtual CPU devices, from the same
flax weights (lm_tiny at depth 2, f32, dropout 0) and the same global
batches.

Tolerances: the update's plain version against the JAX ``"xla"`` and
interpret-mode Pallas kernel rtol 1e-6 / atol 1e-8 (the JAX file's
own; f32 powers from two libraries), against the port's ``optim.adam``
bitwise (the same eager ops); pack/unpack bitwise.  Losses within 1e-5
relative and params within 1e-5 absolute against the JAX steps: each
rank's mean loss summed over the ranks rounds differently from one
global mean.  The port's fused and composable ZeRO-1 and its DP step
agree bit for bit at 2 ranks (a sum of two is exact in either order),
within 1e-6 at 4 (gloo sums four in another order).  The rank-mean
gradient holds to the global-batch gradient at rtol 1e-4 / atol 1e-5,
as ``tests/test_dp_invariants.py`` holds the JAX one.

The JAX fused step (``make_train_step_zero1_fused``) is not a reference
here: with this jax its shard_map takes each device's unsummed gradient
(the failing bitwise pin in ``tests/test_zero1_fused.py``).  The fused
port is held instead to JAX's GSPMD ZeRO-1 and to the JAX fused
schedule assembled from ``pack_tree``, ``fused_adam_update(impl="xla")``
and ``unpack_tree`` over the summed gradient.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_zero1_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import lm_tiny as jlm_tiny
from fluxdistributed_tpu.models.transformer_lm import lm_loss_fn as jlm_loss_fn
from fluxdistributed_tpu.parallel import zero1 as jzero1
from fluxdistributed_tpu.parallel import zero1_fused as jzf
from fluxdistributed_tpu.parallel.dp import (TrainState as JState,
                                             make_train_step as jmake_step)
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import SyntheticTextDataset
from fluxdistributed_tpu_torch.mesh import (Mesh, data_mesh, init_distributed,
                                            run_ranks, shutdown_distributed)
from fluxdistributed_tpu_torch.models import (flax_to_state_dict, lm_loss_fn,
                                              lm_tiny)
from fluxdistributed_tpu_torch.ops import fused_adam_plain
from fluxdistributed_tpu_torch.parallel import (fused_adam_update, local_grads,
                                                pack_tree, packed_size,
                                                unpack_tree, zero1_optimizer)
from fluxdistributed_tpu_torch.sharding import shard_batch
from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                             train)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

T, GLOBAL_B, LR, STEPS = 32, 8, 1e-3, 3


@pytest.fixture(scope="module")
def weights():
    jm = jlm_tiny(vocab=ranks.VOCAB, dtype=jnp.float32, **ranks.SMALL)
    params = jm.init(jax.random.PRNGKey(1), np.zeros((1, T), np.int32),
                     train=False)["params"]
    state = flax_to_state_dict(jax.tree.map(np.asarray, params))
    batches = [np.random.default_rng(s).integers(
        0, ranks.VOCAB, (GLOBAL_B, T)).astype(np.int32) for s in range(STEPS)]
    return jm, params, state, batches


def _jax_steps(step, state, batches, mesh):
    losses = []
    for b in batches:
        state, m = step(state, jsharding.shard_batch({"tokens": b}, mesh))
        losses.append(float(m["loss"]))
    return losses, flax_to_state_dict(jax.tree.map(np.asarray, state.params))


def _jax_fused_reference(jm, params, batches, n):
    """The JAX fused schedule over the summed gradient, from the JAX
    package's own pieces: pack → N chunks → ``fused_adam_update("xla")``
    → concatenate → unpack."""
    loss_fn = jlm_loss_fn(jm)
    size = jzf.packed_size(params, n)
    m = v = jnp.zeros((size,), jnp.float32)
    losses = []
    for step, b in enumerate(batches):
        (loss, _), g = jax.value_and_grad(
            lambda p: loss_fn(p, {}, {"tokens": jnp.asarray(b)}, True),
            has_aux=True)(params)
        losses.append(float(loss))
        fg, fp, c = jzf.pack_tree(g, n), jzf.pack_tree(params, n), size // n
        outs = [jzf.fused_adam_update(
            fp[i * c:(i + 1) * c], fg[i * c:(i + 1) * c], m[i * c:(i + 1) * c],
            v[i * c:(i + 1) * c], step, lr=LR, impl="xla") for i in range(n)]
        p2, m, v = (jnp.concatenate([o[j] for o in outs]) for j in range(3))
        params = jzf.unpack_tree(p2, params)
    return losses, flax_to_state_dict(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX DP and GSPMD ZeRO-1 on data_mesh(2), and the fused schedule."""
    jm, params, _, batches = weights
    mesh, opt = jdata_mesh(2), joptim.adam(LR)
    loss_fn = jlm_loss_fn(jm)
    out = {"dp": _jax_steps(
        jmake_step(loss_fn, opt, mesh, donate=False),
        JState.create(jsharding.replicate(params, mesh), opt), batches, mesh)}
    zstate, sh = jzero1.zero1_state(params, opt, mesh)
    out["zero1"] = _jax_steps(
        jzero1.make_train_step_zero1(loss_fn, opt, mesh, sh, donate=False),
        zstate, batches, mesh)
    out["fused"] = _jax_fused_reference(jm, params, batches, 2)
    return out


@pytest.fixture(scope="module")
def two_ranks(weights):
    _, _, state, batches = weights
    return run_ranks(ranks.train_modes, 2, state, batches, LR)


@pytest.fixture(scope="module")
def four_ranks(weights):
    _, _, state, batches = weights
    return run_ranks(ranks.train_modes, 4, state, batches, LR)


def _close(got, ref, what):
    gl, gp = got
    rl, rp = ref
    np.testing.assert_allclose(gl, rl, rtol=1e-5, atol=0, err_msg=what)
    assert set(gp) == set(rp)
    for k in rp:
        np.testing.assert_allclose(gp[k], rp[k], rtol=0, atol=1e-5,
                                   err_msg=f"{what}: {k}")


def _equal(a, b):
    assert a[0] == b[0]
    for k in b[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=k)


# -- pack / unpack and the update ------------------------------------------


@pytest.mark.parametrize("nshards", [1, 2, 4])
def test_pack_unpack_match_jax(nshards):
    rng = np.random.default_rng(nshards)
    tree = {"w": rng.normal(size=(7, 13)).astype(np.float32),
            "b": rng.normal(size=(29,)).astype(np.float32),
            "frozen": None,
            "blk": {"z": rng.normal(size=(3, 4, 5)).astype(np.float32),
                    "a": rng.normal(size=(2,)).astype(np.float32)}}

    def conv(t, f):
        return {k: None if v is None else conv(v, f) if isinstance(v, dict)
                else f(v) for k, v in t.items()}

    ref = np.asarray(jzf.pack_tree(conv(tree, jnp.asarray), nshards))
    got = pack_tree(conv(tree, torch.from_numpy), nshards)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape[0] == packed_size(conv(tree, torch.from_numpy), nshards)
    assert got.shape[0] % (nshards * 1024) == 0
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[91 + 29 + 60 + 2:].any()  # zero tail
    back = unpack_tree(got, conv(tree, torch.from_numpy))
    assert back["frozen"] is None and list(back) == list(tree)
    for k, v in (("w", tree["w"]), ("b", tree["b"])):
        np.testing.assert_array_equal(back[k].numpy(), v)
    np.testing.assert_array_equal(back["blk"]["z"].numpy(), tree["blk"]["z"])


def _buffers(n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    g = (rng.normal(size=n) * 0.1).astype(np.float32)
    m = (rng.normal(size=n) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=n)) * 0.01).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("n", [2 * 1024, 3 * 1024])
@pytest.mark.parametrize("sched", [False, True])
def test_fused_update_matches_jax_kernel(impl, step, n, sched):
    """The port's update (the kernel's plain version on the CPU) against
    the JAX fused kernel: its XLA expression and the Pallas body itself
    in interpret mode (block_rows=16 does not divide 24 rows at 3072)."""
    bufs = _buffers(n, seed=n + step)
    jlr = joptim.step_decay(3e-3, 0.5, 2) if sched else 3e-3
    tlr = optim.step_decay(3e-3, 0.5, 2) if sched else 3e-3
    ref = jzf.fused_adam_update(*map(jnp.asarray, bufs), step, lr=jlr,
                                impl=impl, block_rows=16)
    got = fused_adam_update(*map(torch.from_numpy, bufs), step, lr=tlr)
    for name, a, r in zip(("p", "m", "v"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("sched", [False, True])
def test_fused_update_bitwise_vs_optim_adam(step, sched):
    lr = optim.cosine_decay(3e-3, 10, 0.1) if sched else 3e-3
    p, g, m, v = map(torch.from_numpy, _buffers(2048, seed=step))
    ref_p, ref_s = optim.adam(lr).apply({"x": p}, {"x": g}, {"x": (m, v)},
                                        step)
    got = fused_adam_update(p, g, m, v, step, lr=lr)
    for a, r in zip(got, (ref_p["x"], *ref_s["x"])):
        assert torch.equal(a, r)
    assert all(a.data_ptr() != b.data_ptr() for a in got
               for b in (p, g, m, v))  # fresh buffers, inputs untouched


def test_fused_update_rejects_ragged_and_bad_scalars():
    x = torch.zeros(1000)
    with pytest.raises(ValueError, match="pack_tree"):
        fused_adam_update(x, x, x, x, 0)
    y = torch.zeros(1024)
    with pytest.raises(ValueError, match="scalars"):
        from fluxdistributed_tpu_torch.ops import fused_adam
        fused_adam(y, y, y, y, torch.zeros(2))
    with pytest.raises(TypeError, match="float32"):
        fused_adam(y, y, y.double(), y, torch.zeros(3))
    # the plain version is the CPU path of the wrapper
    s = torch.tensor([1e-3, 0.1, 0.001])
    out = fused_adam(y + 1, y + 0.5, y, y, s)
    for a, r in zip(out, fused_adam_plain(y + 1, y + 0.5, y, y, s, 0.9,
                                          0.999, 1e-8)):
        assert torch.equal(a, r)


# -- the N-rank world --------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_on_gloo_ranks(n):
    res = run_ranks(ranks.collectives_check, n)
    base = np.arange(4 * n, dtype=np.float32)
    total = n * base + 100 * sum(range(n))
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["psum"], total)
        assert out["pmean"] == pytest.approx((n - 1) / 2)
        assert out["none_kept"] and out["input_unchanged"]
        np.testing.assert_array_equal(out["reduce_scatter"],
                                      total[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(
            out["all_gather"],
            np.concatenate([base[:2] + 100 * q for q in range(n)]))


def test_zero1_two_ranks_matches_jax_gspmd_zero1(two_ranks, jax_runs):
    for out in two_ranks:
        _close(out["zero1"], jax_runs["zero1"], "zero1 vs JAX zero1")
        _close(out["zero1_shardmap"], jax_runs["zero1"],
               "zero1_shardmap vs JAX zero1")


def test_zero1_fused_two_ranks_matches_jax(two_ranks, jax_runs):
    for out in two_ranks:
        _close(out["fused"], jax_runs["fused"], "fused vs JAX fused schedule")
        _close(out["fused"], jax_runs["zero1"], "fused vs JAX zero1")


def test_dp_two_ranks_matches_jax_dp(two_ranks, jax_runs):
    for out in two_ranks:
        _close(out["dp"], jax_runs["dp"], "dp vs JAX dp")


def test_dp_four_ranks_matches_jax_dp(weights, four_ranks):
    jm, params, _, batches = weights
    mesh, opt = jdata_mesh(4), joptim.adam(LR)
    ref = _jax_steps(jmake_step(jlm_loss_fn(jm), opt, mesh, donate=False),
                     JState.create(jsharding.replicate(params, mesh), opt),
                     batches, mesh)
    for out in four_ranks:
        _close(out["dp"], ref, "4-rank dp vs JAX dp")


def test_two_ranks_fused_equals_composable_and_dp_bitwise(two_ranks):
    for out in two_ranks:
        _equal(out["fused"], out["zero1"])
        _equal(out["zero1_shardmap"], out["zero1"])
        _equal(out["dp"], out["zero1"])
        assert out["zero1_synced"] and out["fused_synced"]
    _equal(two_ranks[0]["fused"], two_ranks[1]["fused"])


def test_four_ranks_agree_within_tolerance(four_ranks, two_ranks):
    for out in four_ranks:
        for mode in ("zero1", "zero1_shardmap", "dp"):
            np.testing.assert_allclose(out[mode][0], out["fused"][0],
                                       rtol=1e-6)
            for k, r in out["fused"][1].items():
                np.testing.assert_allclose(out[mode][1][k], r, rtol=0,
                                           atol=1e-6, err_msg=f"{mode} {k}")
        _close(out["fused"], two_ranks[0]["fused"], "4 ranks vs 2")


def test_opt_state_is_one_nth_per_rank(weights, two_ranks, four_ranks):
    _, params, state, _ = weights
    n_params = sum(v.size for v in state.values())
    for world, outs in ((2, two_ranks), (4, four_ranks)):
        packed = jzf.packed_size(params, world)  # the JAX packed length
        for out in outs:
            assert out["fused_mv_elems"] == (packed // world,) * 2
            assert out["fused_mv_bytes"] == 2 * 4 * packed // world
            # composable: each leaf padded to a multiple of N, then 1/N
            assert n_params <= world * out["zero1_opt_elems"] // 2 \
                < n_params + world * len(state)


def test_dp_invariants_on_two_ranks(weights):
    """Rank-mean gradient == global-batch gradient; after three momentum
    steps the replicas are bit-identical."""
    _, _, state, batches = weights
    res = run_ranks(ranks.dp_invariants, 2, state, batches[0])
    tm = ranks._model(state)
    params = {k: p.detach() for k, p in tm.named_parameters()}
    _, _, gg = local_grads(lm_loss_fn(tm))(
        params, {}, {"tokens": torch.from_numpy(batches[0])}, 0)
    for out in res:
        assert out["synced"]
        for k, g in gg.items():
            np.testing.assert_allclose(out["mean_grad"][k], g.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    for k in res[0]["params"]:
        np.testing.assert_array_equal(res[0]["params"][k],
                                      res[1]["params"][k])


# -- one rank in this process: mesh, trainer, CLI ---------------------------


def test_one_rank_group_and_refusals(monkeypatch):
    mesh = init_distributed("cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"data": 1})
        assert data_mesh(device="cpu") == mesh and data_mesh() == mesh
        with pytest.raises(ValueError, match="requested 2"):
            data_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="not divisible"):
            shard_batch({"tokens": np.zeros((3, 4))},
                        Mesh(None, 0, 2, torch.device("cpu")))
        with pytest.raises(ValueError, match="needs cross-slice"):
            zero1_optimizer(optim.clip_by_global_norm(optim.adam(), 1.0), mesh)
    finally:
        shutdown_distributed()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="incomplete"):
        init_distributed("cpu")


def test_prepare_training_zero1_rules():
    tm = lm_tiny(vocab=ranks.VOCAB, dtype=torch.float32, device="cpu",
                 **ranks.SMALL)

    def prep(**kw):
        return prepare_training(
            tm, SyntheticTextDataset(vocab=ranks.VOCAB, seqlen=16),
            optim.adam(1e-3), loss_fn=lm_loss_fn(tm), batch_size=4,
            cycles=2, device="cpu", **kw)

    with pytest.raises(ValueError, match="DP paths only"):
        prep(spmd="fsdp", zero1=True)
    with pytest.raises(ValueError, match="requires spmd='jit'"):
        prep(spmd="shard_map", accum_steps=2)
    try:
        task = prep(zero1=True, accum_steps=2)
        assert task.mesh.size == 1 and task.loader.mesh is task.mesh
        _, _, task = train(task, print_every=0, eval_every=0,
                           logger=NullLogger())
        assert task.state.step == 2 and all(np.isfinite(task.losses))
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("spmd", ["jit", "shard_map"])
def test_cli_zero1_loss_falls(spmd):
    task = cli.run(["--model", "lm_tiny", "--vocab", "64", "--seqlen", "32",
                    "--batch-size", "8", "--attn", "flash", "--opt", "adam",
                    "--lr", "3e-3", "--cycles", "30", "--eval-every", "0",
                    "--print-every", "0", "--zero1", "--spmd", spmd,
                    "--device", "cpu"])
    assert task.mesh is not None and task.mesh.size == 1
    assert task.state.step == 30
    first, last = np.mean(task.losses[:3]), np.mean(task.losses[-5:])
    assert last < first - 0.5, (first, last)
    assert not torch.distributed.is_initialized()  # the CLI ended its group
