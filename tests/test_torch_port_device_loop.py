"""Port parity: the device loop (``steps_per_call``), its chunked loader
and the step table, on the CPU, against single port steps and against
the JAX package's device loop (``tests/test_device_loop.py``'s setup).

On the CPU ``steps_per_call = K`` is a plain loop of K steps over the
same step body, so K steps a call equal K single steps bit for bit
(losses, params, optimizer and model state), with dropout, remat and
microbatches.  Against the JAX device loop the tolerance is the single
step's parity limit: losses and params within 1e-5 absolute (SimpleCNN
momentum; lm_tiny momentum under a schedule, a depth-2 f32 stack whose
sums run in another order).  The chunked loader is sub-batch-identical
to JAX's.  The dropout masks are a counter-based hash, so their tests
are statistical where they say so: the keep rate within 5 standard
deviations of ``1 - rate``, and two masks agreeing at the rate of
independent ones within the same bound.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import fluxdistributed_tpu as fd
import test_torch_port_device_loop_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu.data import PrefetchLoader as JLoader
from fluxdistributed_tpu.data import SyntheticDataset as JSynth
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import SimpleCNN as JSimpleCNN
from fluxdistributed_tpu.models import lm_tiny as jlm_tiny
from fluxdistributed_tpu.models.transformer_lm import lm_loss_fn as jlm_loss
from fluxdistributed_tpu.ops.attention import attention_core as jcore
from fluxdistributed_tpu.parallel.dp import TrainState as JState
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu.parallel.dp import make_train_step as jmake_step
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import (PrefetchLoader, SyntheticDataset,
                                            SyntheticTextDataset)
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.models import (SimpleCNN, flax_to_state_dict,
                                              lm_loss_fn, lm_tiny,
                                              load_flax_params,
                                              load_flax_simple)
from fluxdistributed_tpu_torch.models.transformer_lm import (_dropout,
                                                             dropout_keys)
from fluxdistributed_tpu_torch.ops import attention_core
from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
from fluxdistributed_tpu_torch.parallel import (TrainState, make_train_step,
                                                module_loss_fn)
from fluxdistributed_tpu_torch.parallel.graphs import StepTable
from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                             train)
from fluxdistributed_tpu_torch.tree import leaves as _leaves

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

SMALL = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)
VOCAB, T, NCLS = 64, 32, 4


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for part in ("params", "opt_state", "model_state"):
        la, lb = _leaves(getattr(a, part)), _leaves(getattr(b, part))
        assert len(la) == len(lb), part
        for x, y in zip(la, lb):
            assert torch.equal(x, y), part


# ------------------------------------------------------------- the loader


def test_chunked_loader_matches_jax_and_refuses_as_jax_does():
    jds = JSynth(nsamples=256, nclasses=NCLS, shape=(8, 8, 3))
    ds = SyntheticDataset(nsamples=256, nclasses=NCLS, shape=(8, 8, 3))
    jitems = list(JLoader(jds, jdata_mesh(8), 16, cycles=8, seed=3, chunk=4))
    flat = list(PrefetchLoader(ds, 16, cycles=8, seed=3, device="cpu"))
    items = list(PrefetchLoader(ds, 16, cycles=8, seed=3, chunk=4,
                                device="cpu"))
    assert len(items) == len(jitems) == 2
    for c, item in enumerate(items):
        assert item["image"].shape == (4, 16, 8, 8, 3)
        assert item["label"].shape == (4, 16, NCLS)
        for k in ("image", "label"):
            np.testing.assert_array_equal(item[k].numpy(),
                                          np.asarray(jitems[c][k]))
            for j in range(4):
                assert torch.equal(item[k][j], flat[c * 4 + j][k])
    # start counts items; a derived cycle count rounds down to whole items
    resumed = list(PrefetchLoader(ds, 16, cycles=8, seed=3, chunk=4, start=1,
                                  device="cpu"))
    assert len(resumed) == 1
    assert torch.equal(resumed[0]["image"], items[1]["image"])
    assert (len(PrefetchLoader(ds, 16, chunk=3, device="cpu"))
            == len(JLoader(jds, jdata_mesh(8), 16, chunk=3)) == 5)
    for kw in ({"cycles": 7, "chunk": 4}, {"cycles": 8, "chunk": 0}):
        with pytest.raises(ValueError) as jerr:
            JLoader(jds, jdata_mesh(8), 16, **kw)
        with pytest.raises(ValueError) as err:
            PrefetchLoader(ds, 16, device="cpu", **kw)
        assert str(err.value) == str(jerr.value)


# ------------------------------------- K steps a call = K single steps


def _simplecnn_case():
    model = SimpleCNN(num_classes=NCLS, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 16, 8, 8, 3)).astype(np.float32)
    y = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, (4, 16))]
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    return (model, module_loss_fn(model, logitcrossentropy),
            optim.momentum(0.1, 0.9), batch)


def _lm_case(remat):
    model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                    attn_fn=attention_core("flash", 16), dropout=0.1,
                    remat=remat, seed=1, **SMALL)
    toks = np.random.default_rng(2).integers(0, VOCAB, (4, 4, T))
    return (model, lm_loss_fn(model),
            optim.adam(optim.warmup_cosine(3e-3, 2, 8)),
            {"tokens": torch.from_numpy(toks.astype(np.int32))})


@pytest.mark.parametrize("case,accum", [("simplecnn", 1), ("simplecnn", 2),
                                        ("lm_tiny", 1), ("lm_tiny_remat", 1),
                                        ("lm_tiny", 2)])
def test_steps_per_call_equals_single_steps_bitwise(case, accum):
    model, loss_fn, opt, stacked = (_simplecnn_case() if case == "simplecnn"
                                    else _lm_case(case.endswith("remat")))

    def fresh():
        return TrainState.create(
            {k: p.detach().clone() for k, p in model.named_parameters()},
            opt, model_state={k: b.clone() for k, b in model.named_buffers()})

    single = make_train_step(loss_fn, opt, accum_steps=accum, seed=7,
                             guard=True)
    state, losses, guards = fresh(), [], []
    for j in range(4):
        state, m = single(state, {k: v[j] for k, v in stacked.items()})
        losses.append(m["loss"])
        guards.append(m["guard"])
    looped = make_train_step(loss_fn, opt, accum_steps=accum, seed=7,
                             guard=True, steps_per_call=4)
    state4, m4 = looped(fresh(), stacked)
    assert m4["loss"].shape == (4,) and m4["guard"].shape == (4, 2)
    assert torch.equal(m4["loss"], torch.stack(losses))
    assert torch.equal(m4["guard"], torch.stack(guards))
    assert len(set(m4["loss"].tolist())) == 4
    _assert_states_equal(state4, state)
    with pytest.raises(ValueError, match="stacked on a leading dim of 4"):
        looped(state4, {k: v[:2] for k, v in stacked.items()})


# --------------------------------------------- against the JAX device loop


def _jax_stacked(arrays):
    mesh = jdata_mesh(1)
    return mesh, {k: jax.device_put(v, NamedSharding(mesh, P(None, "data")))
                  for k, v in arrays.items()}


@pytest.mark.parametrize("case,k,accum", [("simplecnn", 4, 1),
                                          ("simplecnn", 2, 2),
                                          ("lm_tiny", 4, 1)])
def test_device_loop_matches_jax_device_loop(case, k, accum):
    rng = np.random.default_rng(1)
    if case == "simplecnn":
        n = 16 * accum
        x = rng.normal(0, 1, (k, n, 8, 8, 3)).astype(np.float32)
        y = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, (k, n))]
        arrays = {"image": x, "label": y}
        jm = JSimpleCNN(num_classes=NCLS)
        params = jm.init(jax.random.PRNGKey(0), x[0, :1])["params"]
        jloss = flax_loss_fn(jm, fd.logitcrossentropy)
        model = load_flax_simple(SimpleCNN(num_classes=NCLS, device="cpu"),
                                 jax.tree.map(np.asarray, params))
        loss_fn = module_loss_fn(model, logitcrossentropy)
        jopt, opt = joptim.momentum(0.1, 0.9), optim.momentum(0.1, 0.9)
    else:
        arrays = {"tokens": rng.integers(0, VOCAB, (k, 4, T)).astype(
            np.int32)}
        jm = jlm_tiny(vocab=VOCAB, dtype=jnp.float32,
                      attn_fn=jcore("flash", 16), **SMALL)
        params = jm.init(jax.random.PRNGKey(1), np.zeros((1, T), np.int32),
                         train=False)["params"]
        jloss = jlm_loss(jm)
        model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                        attn_fn=attention_core("flash", 16), **SMALL)
        load_flax_params(model, jax.tree.map(np.asarray, params))
        loss_fn = lm_loss_fn(model)
        jopt = joptim.momentum(joptim.warmup_cosine(0.05, 2, 6), 0.9)
        opt = optim.momentum(optim.warmup_cosine(0.05, 2, 6), 0.9)
    mesh, jbatch = _jax_stacked(arrays)
    jstep = jmake_step(jloss, jopt, mesh, donate=False, accum_steps=accum,
                       steps_per_call=k)
    jstate, jm_ = jstep(JState.create(params, jopt), jbatch)
    step = make_train_step(loss_fn, opt, accum_steps=accum,
                           steps_per_call=k)
    state, m = step(TrainState.create(dict(model.named_parameters()), opt),
                    {kk: torch.from_numpy(v) for kk, v in arrays.items()})
    assert int(jstate.step) == state.step == k
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm_["loss"]),
                               atol=1e-5, rtol=0)
    if case == "lm_tiny":
        sd = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
        for name, r in sd.items():
            np.testing.assert_allclose(state.params[name].numpy(), r,
                                       atol=1e-5, rtol=0, err_msg=name)
    else:
        back = load_flax_simple(
            SimpleCNN(num_classes=NCLS, device="cpu"),
            jax.tree.map(np.asarray, jstate.params))
        for name, r in back.named_parameters():
            np.testing.assert_allclose(state.params[name].numpy(),
                                       r.detach().numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)


# ------------------------------------------ composable ZeRO-1 on 2 ranks


def test_zero1_device_loop_on_two_gloo_ranks_equals_single_steps():
    out = run_ranks(ranks.zero1_device_loop, 2)
    for r in out:
        assert r["loader_equal"] and r["rows"] == (2, ranks.BATCH // 2,
                                                   ranks.SEQ)
        (l1, p1, o1, s1), (l2, p2, o2, s2) = r[1], r[2]
        assert s1 == s2 == ranks.STEPS and len(set(l1)) == ranks.STEPS
        assert l1 == l2
        for k in p1:
            assert torch.equal(p1[k], p2[k]), k
        for a, b in zip(o1, o2):
            assert torch.equal(a, b)
    # the replicas agree
    for k, v in out[0][2][1].items():
        assert torch.equal(v, out[1][2][1][k]), k


# ------------------------------------------------------ trainer and CLI


def _train_task(steps_per_call, **kw):
    model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                    dropout=0.1, seed=0, **SMALL)
    ds = SyntheticTextDataset(vocab=VOCAB, seqlen=16)
    task = prepare_training(model, ds, optim.adam(3e-3),
                            loss_fn=lm_loss_fn(model), batch_size=4, cycles=8,
                            device="cpu", steps_per_call=steps_per_call, **kw)
    return task


def test_trainer_steps_per_call_equals_single_steps():
    """K=4 gives K=1's losses, four distinct losses a call (each call's
    metrics are fresh tensors, never a buffer the next call rewrites),
    the same state and step count; the cadences tick per item."""
    tasks = {}
    for k in (1, 4):
        task = _train_task(k)
        train(task, print_every=1, eval_every=1, logger=NullLogger())
        tasks[k] = task
    one, four = tasks[1], tasks[4]
    assert len(four.loader) == 2 and four.state.step == one.state.step == 8
    assert four.losses == one.losses and len(set(four.losses)) == 8
    for k, v in one.state.params.items():
        assert torch.equal(four.state.params[k], v), k


def test_trainer_oom_skip_counts_the_item_steps():
    task = _train_task(4)
    step_fn, seen = task.step_fn, {"n": 0}

    def flaky(state, batch):
        seen["n"] += 1
        if seen["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return step_fn(state, batch)

    task.step_fn = flaky
    train(task, print_every=0, eval_every=0, logger=NullLogger())
    assert task.num_missed == 4 and task.skipped_items == [0]
    assert task.state.step == 4 and len(task.losses) == 4


def test_cli_steps_per_call_and_refusals():
    argv = ["--model", "lm_tiny", "--vocab", "64", "--seqlen", "16",
            "--batch-size", "4", "--opt", "adam", "--lr", "3e-3",
            "--cycles", "8", "--device", "cpu", "--eval-every", "0",
            "--print-every", "0"]
    one = cli.run(argv)
    four = cli.run(argv + ["--steps-per-call", "4"])
    assert four.steps_per_call == 4 and four.state.step == 8
    assert four.losses == one.losses and len(set(four.losses)) == 8
    with pytest.raises(SystemExit, match="requires spmd='jit'"):
        cli.run(argv + ["--zero1", "--spmd", "shard_map",
                        "--steps-per-call", "2"])
    with pytest.raises(SystemExit, match="multiple of chunk"):
        cli.run(argv + ["--steps-per-call", "3"])
    with pytest.raises(SystemExit, match="must be >= 1"):
        cli.run(argv + ["--steps-per-call", "0"])
    assert not torch.distributed.is_initialized()


def test_prepare_training_refusals_match_jax():
    from fluxdistributed_tpu.train import prepare_training as jprepare

    jds = JSynth(nsamples=64, nclasses=NCLS, shape=(8, 8, 3))
    for kw in ({"steps_per_call": 0}, {"steps_per_call": 2,
                                       "spmd": "shard_map"}):
        with pytest.raises(ValueError) as jerr:
            jprepare(JSimpleCNN(num_classes=NCLS), jds,
                     joptim.momentum(0.05, 0.9), mesh=fd.data_mesh(8),
                     batch_size=16, cycles=8, **kw)
        with pytest.raises(ValueError) as err:
            _train_task(**kw)
        assert str(err.value) == str(jerr.value)


# ------------------------------------------------------- dropout masks


def test_dropout_masks_depend_only_on_seed_layer_and_site():
    seed = (5 << 32) | 77
    host = dropout_keys(seed, 3)
    dev = dropout_keys(torch.tensor(seed, dtype=torch.int64), 3)
    assert dev.dtype == torch.int32 and dev.tolist() == host
    assert len(set(host)) == 9
    assert dropout_keys(seed + 1, 3) != host
    assert dropout_keys(seed + (1 << 32), 3) != host
    x = torch.ones(64, 1000)
    masks = [(_dropout(x, 0.1, key) > 0) for key in host]
    n, p = x.numel(), 0.9
    sd = (p * (1 - p) / n) ** 0.5
    for m in masks:
        assert abs(m.float().mean().item() - p) < 5 * sd
    # the int key and the tensor key draw one mask; a key draws it again
    assert torch.equal(_dropout(x, 0.1, dev[4]), _dropout(x, 0.1, host[4]))
    assert torch.equal(_dropout(x, 0.1, host[4]) > 0, masks[4])
    # distinct keys agree at the rate of independent masks
    agree = p * p + (1 - p) * (1 - p)
    sd2 = (agree * (1 - agree) / n) ** 0.5
    for a in range(len(masks)):
        for b in range(a + 1, len(masks)):
            rate = (masks[a] == masks[b]).float().mean().item()
            assert abs(rate - agree) < 5 * sd2, (a, b)
    # neighbouring elements are not correlated
    m = masks[0].reshape(-1).float()
    lag = ((m[1:] == m[:-1]).float().mean().item())
    assert abs(lag - agree) < 5 * sd2
    # kept entries are scaled by 1 / (1 - rate)
    y = _dropout(x, 0.1, host[0])
    assert torch.equal(y[masks[0]], torch.full_like(y[masks[0]], 1 / 0.9))


def test_lm_forward_same_masks_from_int_and_tensor_seeds():
    model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                    dropout=0.2, seed=3, **SMALL)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, VOCAB, (2, T)).astype(np.int32))
    with torch.no_grad():
        a = model(toks, train=True, dropout_seed=123456789)
        b = model(toks, train=True, dropout_seed=torch.tensor(123456789))
        c = model(toks, train=True, dropout_seed=123456790)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------------- the step table


def _rules():
    sched = {"constant": 0.05, "warmup_cosine": (0.05, 2, 5),
             "step_decay": (0.05, 0.5, 2), "cosine_decay": (0.05, 4, 0.1)}
    out = {}
    for name, args in sched.items():
        tl = args if name == "constant" else getattr(optim, name)(*args)
        jl = args if name == "constant" else getattr(joptim, name)(*args)
        for rule in ("descent", "momentum", "nesterov", "adam", "adamw",
                     "lars"):
            out[f"{rule}-{name}"] = (getattr(optim, rule)(tl),
                                     getattr(joptim, rule)(jl))
        out[f"ema_momentum-{name}"] = (
            optim.with_ema(optim.momentum(tl), 0.99),
            joptim.with_ema(joptim.momentum(jl), 0.99))
        out[f"clip_adam-{name}"] = (
            optim.clip_by_global_norm(optim.adam(tl), 1.0),
            joptim.clip_by_global_norm(joptim.adam(jl), 1.0))
    return out


RULES = _rules()


@pytest.mark.parametrize("name", list(RULES))
def test_step_table_holds_the_optimizer_scalars(name):
    """The table's rows are the host values in float32; the rule reading
    them from the table updates as ``apply`` does, bit for bit, and as
    the JAX optimizer does within 1e-6 relative over 4 steps."""
    opt, jopt = RULES[name]
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    n = len(opt.scalars(0))
    table = StepTable(4, 1, n, torch.device("cpu"))
    table.fill([([s], opt.scalars(s)) for s in range(4)])
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ap, jp = dict(tp), {k: jnp.asarray(v) for k, v in p0.items()}
    ts = opt.init(tp)
    st_a, js = opt.init(ap), jopt.init(jp)
    for s, g in enumerate(grads):
        want = [float(np.float32(float(x))) for x in opt.scalars(s)]
        assert table.scalars[s].tolist() == want
        assert table.seeds[s].tolist() == [s]
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tp, ts = opt.rule(tp, tg, ts, table.scalars[s])
        ap, st_a = opt.apply(ap, tg, st_a, s)
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js, s)
        for k in tp:
            assert torch.equal(tp[k], ap[k]), k
    for k in tp:
        ref = np.asarray(jp[k])
        assert np.abs(tp[k].numpy() - ref).max() <= 1e-6 * max(
            np.abs(ref).max(), 1e-30), k


def test_step_table_refuses_a_row_of_another_width():
    table = StepTable(2, 1, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="1 seeds and 3 scalars"):
        table.fill([([0], [1.0, 2.0])])
