"""Port parity: LM training (loss, optimizers, data, step, trainer, CLI)
against the JAX package, on the same numpy inputs and the same flax
weights (``load_flax_params``), f32 and ``dropout=0`` unless a test
says otherwise.  The JAX flash core runs its Pallas kernels in
interpret mode; the port's runs the kernels' plain versions.

Tolerances: ``next_token_loss`` 1e-6 (one f32 log-softmax); the loss
and its gradients 1e-5 relative to the largest reference entry (a
depth-2 f32 stack, summed in another order); optimizer rules 1e-6
relative over 5 steps (the same f32 op order, scalar powers from two
libraries); three ``descent``/``momentum`` steps within 1e-5 (losses
and params); ``adam`` pins losses only, within 1e-4 (its first update
is ~lr * sign(g), so a near-zero gradient whose sign differs by
rounding moves its parameter by up to 2 lr).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu.data.loader import PrefetchLoader as JLoader
from fluxdistributed_tpu.data.synthetic import SyntheticTextDataset as JSynth
from fluxdistributed_tpu.data.text import ByteTextDataset as JByteText
from fluxdistributed_tpu.mesh import data_mesh
from fluxdistributed_tpu.models import lm_tiny as jlm_tiny
from fluxdistributed_tpu.models.transformer_lm import (
    lm_loss_fn as jlm_loss_fn, next_token_loss as jnext_token_loss)
from fluxdistributed_tpu.ops.attention import attention_core as jcore
from fluxdistributed_tpu.parallel.dp import (
    TrainState as JState, make_train_step as jmake_train_step)
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import (ByteTextDataset, PrefetchLoader,
                                            SyntheticTextDataset)
from fluxdistributed_tpu_torch.models import (flax_to_state_dict, lm_loss_fn,
                                              lm_tiny, load_flax_params,
                                              next_token_loss)
from fluxdistributed_tpu_torch.ops import attention_core
from fluxdistributed_tpu_torch.parallel import (TrainState, guard_sentinel,
                                                make_train_step)
from fluxdistributed_tpu_torch.train import (NullLogger, evaluate,
                                             prepare_training, train)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

SMALL = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)
VOCAB, T = 64, 32


def _pair(attn, block=16, **kw):
    """(flax model, flax params, port model) with the same weights."""
    jm = jlm_tiny(vocab=VOCAB, dtype=jnp.float32,
                  attn_fn=jcore(attn, block), **SMALL, **kw)
    params = jm.init(jax.random.PRNGKey(1), np.zeros((1, T), np.int32),
                     train=False)["params"]
    tm = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                 attn_fn=attention_core(attn, block), **SMALL, **kw)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _tokens(n=4, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, T)).astype(
        np.int32)


def _rel(a, r):
    return np.abs(np.asarray(a) - np.asarray(r)).max() / max(
        np.abs(np.asarray(r)).max(), 1e-30)


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 9, 17)).astype(np.float32) * 3
    toks = rng.integers(0, 17, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.3) if masked else None
    ref = jnext_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                           None if mask is None else jnp.asarray(mask))
    got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_lm_loss_and_grads_match_jax(attn):
    jm, params, tm = _pair(attn)
    toks = _tokens()
    (jl, _), jg = jax.value_and_grad(jlm_loss_fn(jm), has_aux=True)(
        params, {}, {"tokens": jnp.asarray(toks)}, True)
    tp = {k: p.detach().requires_grad_() for k, p in tm.named_parameters()}
    loss, (_, logits) = lm_loss_fn(tm)(tp, {}, {"tokens": torch.from_numpy(
        toks)}, True)
    loss.backward()
    assert logits.shape == (4, T, VOCAB)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jg))
    assert set(ref) == set(tp)
    for name, r in ref.items():
        assert _rel(tp[name].grad.numpy(), r) <= 1e-5, name


@pytest.mark.parametrize("rule", ["descent", "momentum", "nesterov", "adam",
                                  "adamw"])
@pytest.mark.parametrize("sched", ["constant", "step_decay", "cosine_decay",
                                   "warmup_cosine"])
def test_optimizer_rules_match_jax(rule, sched):
    """5 steps on identical numpy params and grads, wrapped in global-norm
    clipping (which the larger grads trip)."""
    args = {"constant": (0.05,), "step_decay": (0.05, 0.5, 2),
            "cosine_decay": (0.05, 4, 0.1), "warmup_cosine": (0.05, 2, 5)}
    jlr = getattr(joptim, sched)(*args[sched])
    tlr = getattr(optim, sched)(*args[sched])
    jopt = joptim.clip_by_global_norm(getattr(joptim, rule)(jlr), 3.0)
    topt = optim.clip_by_global_norm(getattr(optim, rule)(tlr), 3.0)
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(7, 5)).astype(np.float32),
          "b": rng.normal(size=(11,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * (s + 1)).astype(np.float32)
              for k, v in p0.items()} for s in range(5)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for s, g in enumerate(grads):
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                            s)
        tp, ts = topt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                            ts, s)
    for k in p0:
        assert _rel(tp[k].numpy(), jp[k]) <= 1e-6, k
    for s in range(6):
        assert float(tlr(s)) == pytest.approx(float(jlr(s)), rel=1e-6)


def test_optimizer_keeps_frozen_leaves_and_inputs():
    p = {"a": torch.ones(3), "b": torch.ones(2)}
    opt = optim.adam(0.1)
    st = opt.init(p)
    new, st2 = opt.apply(p, {"a": torch.ones(3), "b": None}, st, 0)
    assert torch.equal(p["a"], torch.ones(3))  # the update is pure
    assert new["b"] is p["b"] and st2["b"] is st["b"]
    assert not torch.equal(new["a"], p["a"])


def _jax_steps(jm, params, opt, batches):
    mesh = data_mesh(1)
    state = JState.create(params, opt)
    step = jmake_train_step(jlm_loss_fn(jm), opt, mesh, donate=False)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return losses, state.params


def _torch_steps(tm, opt, batches, **kw):
    state = TrainState.create(dict(tm.named_parameters()), opt)
    step = make_train_step(lm_loss_fn(tm), opt, **kw)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        losses.append(m["loss"].item())
    return losses, state


@pytest.mark.parametrize("rule", ["descent", "momentum"])
def test_train_step_flash_matches_jax(rule):
    jm, params, tm = _pair("flash")
    batches = [_tokens(seed=s) for s in range(3)]
    jl, jp = _jax_steps(jm, params, getattr(joptim, rule)(0.05), batches)
    tl, ts = _torch_steps(tm, getattr(optim, rule)(0.05), batches)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jp))
    for name, r in ref.items():
        np.testing.assert_allclose(ts.params[name].numpy(), r, atol=1e-5,
                                   rtol=0, err_msg=name)


def test_train_step_adam_losses_match_jax():
    jm, params, tm = _pair("flash")
    batches = [_tokens(seed=s) for s in range(3)]
    jl, _ = _jax_steps(jm, params, joptim.adam(1e-3), batches)
    tl, _ = _torch_steps(tm, optim.adam(1e-3), batches)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_accum_steps_equals_one_full_batch():
    _, _, tm = _pair("dense")
    batches = [_tokens(n=4, seed=s) for s in range(2)]
    l1, s1 = _torch_steps(tm, optim.momentum(0.05), batches)
    l2, s2 = _torch_steps(tm, optim.momentum(0.05), batches, accum_steps=2)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for k in s1.params:
        torch.testing.assert_close(s2.params[k], s1.params[k], atol=1e-6,
                                   rtol=1e-6)


def test_guard_sentinel_and_step_validation():
    g = {"a": torch.tensor([3.0, 4.0]), "b": None}
    out = guard_sentinel(torch.tensor(1.5), g)
    assert out.tolist() == [1.5, 5.0]
    assert torch.isnan(guard_sentinel(torch.tensor(1.0), {
        "a": torch.tensor([float("inf")])})[0])
    with pytest.raises(ValueError, match="steps_per_call must be >= 1"):
        make_train_step(lambda *a: None, optim.descent(), steps_per_call=0)
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(lambda *a: None, optim.descent(), accum_steps=0)


def test_dropout_seeded_and_remat_agrees():
    kw = dict(vocab=VOCAB, dtype=torch.float32, device="cpu", dropout=0.2,
              **SMALL)
    toks = {"tokens": torch.from_numpy(_tokens())}

    def loss_and_grads(model, rng):
        p = {k: v.detach().requires_grad_() for k, v in
             model.named_parameters()}
        loss, _ = lm_loss_fn(model)(p, {}, toks, True, rng=rng)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in p.items()}

    plain, remat = lm_tiny(**kw), lm_tiny(remat=True, **kw)
    la, ga = loss_and_grads(plain, 5)
    assert loss_and_grads(plain, 5)[0] == la
    assert loss_and_grads(plain, 6)[0] != la
    lr_, gr = loss_and_grads(remat, 5)
    assert lr_ == la
    for k in ga:
        torch.testing.assert_close(gr[k], ga[k], atol=1e-6, rtol=0)
    # eval (train=False) ignores dropout; training without a seed refuses
    p = dict(plain.named_parameters())
    e1, _ = lm_loss_fn(plain)(p, {}, toks, False)
    e2, _ = lm_loss_fn(lm_tiny(**{**kw, "dropout": 0.0}))(p, {}, toks, False)
    assert e1.item() == e2.item()
    with pytest.raises(ValueError, match="dropout seed"):
        lm_loss_fn(plain)(p, {}, toks, True)


def test_synthetic_and_text_data_match_jax(tmp_path):
    for seed in (0, 3):
        a = SyntheticTextDataset(vocab=50, seqlen=12, seed=seed).batch(
            np.random.default_rng(seed + 7), 5)
        b = JSynth(vocab=50, seqlen=12, seed=seed).batch(
            np.random.default_rng(seed + 7), 5)
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 3)
    tds, jds = ByteTextDataset(path, seqlen=10), JByteText(path, seqlen=10)
    assert len(tds) == len(jds)
    np.testing.assert_array_equal(tds.batch(np.random.default_rng(1), 4),
                                  jds.batch(np.random.default_rng(1), 4))
    np.testing.assert_array_equal(tds.batch(None, 2, indices=[3, 70]),
                                  jds.batch(None, 2, indices=[3, 70]))
    assert tds.decode([104, 105]) == "hi"


def test_loader_batches_match_jax_loader():
    ds = SyntheticTextDataset(vocab=VOCAB, seqlen=T)
    ours = [b["tokens"].numpy() for b in PrefetchLoader(
        ds, 8, cycles=4, seed=7, device="cpu", buffersize=2, num_threads=3)]
    theirs = [np.asarray(b["tokens"]) for b in JLoader(
        JSynth(vocab=VOCAB, seqlen=T), data_mesh(), 8, cycles=4, seed=7)]
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    start = [b["tokens"].numpy() for b in PrefetchLoader(
        ds, 8, cycles=4, seed=7, device="cpu", start=2)]
    np.testing.assert_array_equal(np.stack(start), np.stack(ours[2:]))


class _Capture:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))

    def info(self, msg):
        pass


def test_cli_matches_driver_path(monkeypatch):
    """``python -m fluxdistributed_tpu_torch.train`` on lm_tiny /
    synthetic-text for 4 cycles against the JAX driver's path
    (prepare_training + train) from the same weights, both computing in
    f32: in bf16 the two frameworks round activations at other points
    and the losses part by ~5e-4 relative."""
    from fluxdistributed_tpu.train import prepare_training as jprepare
    from fluxdistributed_tpu.train import train as jtrain

    vocab, seqlen, bs = 64, 32, 8
    jm = jlm_tiny(vocab=vocab, dtype=jnp.float32, attn_fn=jcore("flash", 16))
    jtask = jprepare(jm, JSynth(vocab=vocab, seqlen=seqlen), joptim.adam(1e-3),
                     mesh=data_mesh(1), batch_size=bs, cycles=4,
                     loss_fn=jlm_loss_fn(jm), topk=())
    init = jax.tree.map(np.asarray, jtask.state.params)
    cap = _Capture()
    jtrain(jtask, print_every=0, eval_every=1, logger=cap)
    ref = [m["train_step_loss"] for _, m in cap.records
           if "train_step_loss" in m]

    build = cli.build_model

    def carried(args, device, **kw):
        model = build(args, device, dtype=torch.float32, **kw)
        return load_flax_params(model, init)

    monkeypatch.setattr(cli, "build_model", carried)
    task = cli.run(["--model", "lm_tiny", "--dataset", "synthetic-text",
                    "--vocab", str(vocab), "--seqlen", str(seqlen),
                    "--batch-size", str(bs), "--attn", "flash",
                    "--attn-block", "16", "--opt", "adam", "--lr", "1e-3",
                    "--cycles", "4", "--eval-every", "0", "--device", "cpu"])
    assert task.state.step == 4 and len(task.losses) == 4
    np.testing.assert_allclose(task.losses, ref, rtol=1e-4, atol=0)


def test_cli_main_and_refusals(capsys):
    assert cli.main(["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
                     "--batch-size", "2", "--cycles", "3", "--attn", "flash",
                     "--print-every", "1", "--eval-every", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps, 0 missed" in out and "train_loss=" in out
    assert "tokens_per_sec=" in out
    base = ["--model", "lm_tiny", "--cycles", "1", "--device", "cpu"]
    for extra, match in [(["--sinks", "2"], "--window"),
                         (["--attn-block", "16"], "blockwise"),
                         (["--dataset", "synthetic"], "synthetic-text"),
                         (["--kv-heads", "3"], "num_kv_heads")]:
        with pytest.raises(SystemExit, match=match):
            cli.run(base + extra)
    for flag in (["--aot", "d"], ["--steady-after", "3"]):
        with pytest.raises(SystemExit):  # argparse: not accepted
            cli.build_parser().parse_args(base + flag)
    # the cost profile is ported (tests/test_torch_port_profile.py)
    assert cli.build_parser().parse_args(
        base + ["--profile-out", "d"]).profile_out == "d"
    with pytest.raises(SystemExit, match="--resume needs --checkpoint-dir"):
        cli.run(base + ["--resume"])
    with pytest.raises(SystemExit, match="--fault-plan"):
        cli.run(base + ["--fault-plan", '{"sigkill_at_step": 1}'])
    with pytest.raises(SystemExit, match="--cycles"):
        cli.run(["--model", "lm_tiny", "--device", "cpu"])


def _task(**kw):
    tm = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu", **SMALL)
    ds = SyntheticTextDataset(vocab=VOCAB, seqlen=16)
    return prepare_training(tm, ds, optim.descent(0.1), loss_fn=lm_loss_fn(tm),
                            batch_size=4, cycles=3, device="cpu", **kw)


def test_prepare_training_refuses_other_modes():
    with pytest.raises(ValueError, match="loss_fn override cannot apply"):
        _task(spmd="pp")  # the pipeline trains on its own loss
    with pytest.raises(TypeError):  # not accepted, never ignored
        _task(donate=True)
    with pytest.raises(ValueError, match="requires spmd='jit'"):
        _task(steps_per_call=3, spmd="shard_map")
    assert _task(spmd="dp").state.step == 0


def test_train_oom_skip_keeps_state_and_counts():
    """A device OOM in a step skips that batch: the pre-step state goes
    on, the batch is counted, and the loop finishes the other items."""
    task = _task()
    step_fn = task.step_fn
    seen = {"n": 0}

    def flaky(state, batch):
        seen["n"] += 1
        if seen["n"] == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return step_fn(state, batch)

    task.step_fn = flaky
    _, _, task = train(task, eval_every=0, print_every=0, logger=NullLogger())
    assert task.num_missed == 1 and task.skipped_items == [1]
    assert task.state.step == 2 and len(task.losses) == 2
    # the model holds the trained params afterwards
    for name, p in task.model.named_parameters():
        assert torch.equal(p, task.state.params[name])


def test_evaluate_exact_coverage(tmp_path):
    path = tmp_path / "corpus.bin"
    path.write_bytes(np.random.default_rng(0).integers(
        0, 256, 16 * 11, dtype=np.uint8).tobytes())
    ds = ByteTextDataset(path, seqlen=16)
    tm = lm_tiny(vocab=256, dtype=torch.float32, device="cpu", **SMALL)
    task = prepare_training(tm, ds, optim.descent(), loss_fn=lm_loss_fn(tm),
                            batch_size=4, cycles=1, device="cpu")
    out = evaluate(task, ds, batch_size=4)
    assert out["exact"] and out["samples"] == len(ds) == 11
    windows = torch.from_numpy(ds.batch(None, 11, indices=np.arange(11)))
    with torch.no_grad():
        want = np.mean([next_token_loss(tm(w[None]), w[None]).item()
                        for w in windows])
    assert out["loss"] == pytest.approx(want, rel=1e-5)
