"""Port parity: the anomaly guard (``train/guard.py``) and the guarded
trainer against the JAX package.

The policy engine (:class:`TrainGuard`) is held to the JAX one on the
same loss and sentinel sequences: the same verdicts, z-scores, events
and ``fdtpu_guard_*`` values, exactly (both compute in float64 numpy).
Guarded runs from the same flax weights under the same fault plans
(SimpleCNN with a ``train.grad`` NaN, lm_tiny with a ``train.loss``
inf, ZeRO-1 on 2 gloo ranks with a ``train.grad`` inf; momentum, f32)
give the JAX run's stepped losses and final params within 1e-5
absolute (the single step's parity limit: the two frameworks sum in
other orders) and the same quarantined items.  Within the port the
guard's contracts are bitwise, as the JAX tests pin them: a guarded run
with an injected anomaly equals a clean run that skips the same item, a
rollback equals the clean-skip run, and the guard policy is transparent
without anomalies.  After an elastic ZeRO-1 resume (2 gloo ranks -> 1)
the accepted losses match the clean-skip run within 1e-4 relative (the
JAX test's limit; 2 ranks sum the gradient in another order).  The
rank bodies are in ``test_torch_port_guard_ranks.py``.
"""

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_guard_ranks as ranks
from fluxdistributed_tpu import faults as jfaults
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu.data import SyntheticDataset as JSynth
from fluxdistributed_tpu.data.synthetic import SyntheticTextDataset as JText
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import MLP as JMLP
from fluxdistributed_tpu.models import SimpleCNN as JSimpleCNN
from fluxdistributed_tpu.models import lm_tiny as jlm_tiny
from fluxdistributed_tpu.models.transformer_lm import lm_loss_fn as jlm_loss
from fluxdistributed_tpu.obs.metrics import Registry as JRegistry
from fluxdistributed_tpu.train import GuardConfig as JGuardConfig
from fluxdistributed_tpu.train import TrainGuard as JTrainGuard
from fluxdistributed_tpu.train import prepare_training as jprepare
from fluxdistributed_tpu.train import train as jtrain
from fluxdistributed_tpu.train.logging import NullLogger as JNull
from fluxdistributed_tpu_torch import faults, optim
from fluxdistributed_tpu_torch.data import (SyntheticDataset,
                                            SyntheticTextDataset)
from fluxdistributed_tpu_torch.mesh import run_ranks, shutdown_distributed
from fluxdistributed_tpu_torch.models import (MLP, SimpleCNN, lm_loss_fn,
                                              lm_tiny, load_flax_params,
                                              load_flax_simple)
from fluxdistributed_tpu_torch.obs.metrics import Registry
from fluxdistributed_tpu_torch.train import (GuardConfig, GuardHalt,
                                             NullLogger, TrainGuard,
                                             prepare_training,
                                             read_resume_manifest,
                                             replay_item, resume_training,
                                             train)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

CYCLES = 8
LM = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)
VOCAB, T = 64, 32


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def _plan(*entries):
    faults.install_plan(faults.FaultPlan.from_spec({"fail": list(entries)}))


# ------------------------------------------------------- the policy engine


NAN, INF = float("nan"), float("inf")
# each case: GuardConfig kwargs and the observed metrics, one an item; a
# loss is ("loss", x), a compiled sentinel ("guard", loss, grad_norm)
POLICY_CASES = {
    "spike": (dict(warmup=4, zmax=6.0),
              [("loss", 1.0 + 0.01 * (i % 2)) for i in range(6)]
              + [("loss", 50.0), ("loss", 1.0), ("loss", 1.02)]),
    "zero_mad": (dict(warmup=4),
                 [("loss", 2.0)] * 5 + [("loss", 2.1), ("loss", 2.0)]),
    "nonfinite": (dict(rollback_after=10),
                  [("guard", 1.0, 0.5), ("guard", NAN, 0.5),
                   ("guard", 1.0, INF), ("loss", NAN), ("guard", 1.1, 0.4)]),
    "ladder": (dict(rollback_after=2, anomaly_window=8, max_rollbacks=1,
                    progress_steps=4),
               [("guard", NAN, 1.0)] * 4),
    "progress": (dict(rollback_after=2, anomaly_window=4, max_rollbacks=1,
                      progress_steps=3),
                 [("guard", NAN, 1.0)] * 2 + [("guard", 1.0, 1.0)] * 3
                 + [("guard", NAN, 1.0)] * 2),
    "no_rollback_target": (dict(rollback_after=2),
                           [("guard", NAN, 1.0)] * 2),
    "taps": (dict(warmup=2, rollback_after=5),
             [("guard", 1.0 + 0.1 * i, 0.5) for i in range(6)]),
}


def _metrics(obs, torch_side):
    if obs[0] == "loss":
        return {"loss": torch.tensor(obs[1]) if torch_side else
                np.float32(obs[1])}
    arr = np.array(obs[1:], np.float32)
    return {"guard": torch.from_numpy(arr) if torch_side else arr}


def _drive(guard_cls, cfg_cls, reg, cfg, seq, torch_side, can_rollback):
    g = guard_cls(cfg_cls(**cfg), registry=reg,
                  logger=NullLogger() if torch_side else JNull())
    out = []
    for i, obs in enumerate(seq):
        v = g.observe(i, _metrics(obs, torch_side), can_rollback=can_rollback)
        out.append((v, g.zscore(1.5), g.is_quarantined(i)))
    return out, g


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_jax(case):
    cfg, seq = POLICY_CASES[case]
    can_rollback = case != "no_rollback_target"
    if case == "taps":
        spec = {"fail": [{"site": "train.loss", "at": 2, "action": "nan"},
                         {"site": "train.grad", "at": 4, "action": "inf"}]}
        faults.install_plan(faults.FaultPlan.from_spec(spec))
        jfaults.install_plan(jfaults.FaultPlan.from_spec(spec))
    reg, jreg = Registry(), JRegistry()
    got, g = _drive(TrainGuard, GuardConfig, reg, cfg, seq, True,
                    can_rollback)
    ref, jg = _drive(JTrainGuard, JGuardConfig, jreg, cfg, seq, False,
                     can_rollback)
    assert [v for v, _, _ in got] == [v for v, _, _ in ref]
    for (_, z, q), (_, jz, jq) in zip(got, ref):
        assert q == jq
        assert (z is None and jz is None) or z == jz or (
            math.isnan(z) and math.isnan(jz))
    assert json.dumps(g.snapshot(), default=str) == json.dumps(
        jg.snapshot(), default=str)
    for name, labels in (("fdtpu_guard_anomalies_total", ("nonfinite",)),
                         ("fdtpu_guard_anomalies_total", ("loss_spike",)),
                         ("fdtpu_guard_quarantined_total", ()),
                         ("fdtpu_guard_replay_skips_total", ()),
                         ("fdtpu_guard_rollbacks_total", ()),
                         ("fdtpu_guard_halts_total", ()),
                         ("fdtpu_guard_quarantine_size", ()),
                         ("fdtpu_guard_last_z", ()),
                         ("fdtpu_guard_grad_norm", ())):
        a, b = reg.value(name, *labels), jreg.value(name, *labels)
        assert a == b or (math.isnan(a) and math.isnan(b)), name
    if case == "ladder":
        err, jerr = g.halt("test"), jg.halt("test")
        assert isinstance(err, GuardHalt) and err.retryable is False
        assert err.quarantined == jerr.quarantined == [0, 1, 2, 3]


def test_guard_config_validation():
    for kw, match in ((dict(window=1), "window"), (dict(warmup=1), "warmup"),
                      (dict(zmax=0), "zmax"),
                      (dict(rollback_after=0), "rollback_after"),
                      (dict(anomaly_window=0), "anomaly_window"),
                      (dict(max_rollbacks=-1), "max_rollbacks")):
        with pytest.raises(ValueError, match=match):
            GuardConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JGuardConfig(**kw)


# ------------------------------------------------ guarded runs against JAX


def _record(task, out):
    orig = task.step_fn

    def wrapped(state, batch):
        new, m = orig(state, batch)
        out.append(float(m["loss"]))
        return new, m

    task.step_fn = wrapped
    return out


def _jax_task(case):
    if case == "simplecnn":
        return jprepare(JSimpleCNN(num_classes=10),
                        JSynth(nsamples=64, nclasses=10, shape=(8, 8, 3)),
                        joptim.momentum(0.1, 0.9), mesh=jdata_mesh(1),
                        batch_size=8, cycles=CYCLES, topk=(), guard=True)
    jm = jlm_tiny(vocab=VOCAB, dtype=jnp.float32, **LM)
    return jprepare(jm, JText(vocab=VOCAB, seqlen=T),
                    joptim.momentum(0.05, 0.9), mesh=jdata_mesh(1),
                    batch_size=4, cycles=CYCLES, loss_fn=jlm_loss(jm),
                    topk=(), guard=True)


def _port_model(case, params):
    if case == "simplecnn":
        return load_flax_simple(SimpleCNN(num_classes=10, device="cpu"),
                                params)
    return load_flax_params(lm_tiny(vocab=VOCAB, dtype=torch.float32,
                                    device="cpu", **LM), params)


def _port_task(case, init):
    model = _port_model(case, init)
    if case == "simplecnn":
        return prepare_training(
            model, SyntheticDataset(nsamples=64, nclasses=10,
                                    shape=(8, 8, 3)),
            optim.momentum(0.1, 0.9), batch_size=8, cycles=CYCLES, topk=(),
            guard=True, device="cpu")
    return prepare_training(
        model, SyntheticTextDataset(vocab=VOCAB, seqlen=T),
        optim.momentum(0.05, 0.9), loss_fn=lm_loss_fn(model), batch_size=4,
        cycles=CYCLES, topk=(), guard=True, device="cpu")


PLANS = {"simplecnn": {"site": "train.grad", "at": 2, "action": "nan"},
         "lm_tiny": {"site": "train.loss", "at": 3, "action": "inf"}}


@pytest.fixture(scope="module")
def jax_guarded():
    """The JAX guarded runs: initial params, stepped losses, quarantine,
    final params (numpy)."""
    out = {}
    for case, entry in PLANS.items():
        t = _jax_task(case)
        init = jax.tree.map(np.asarray, t.state.params)
        stepped = _record(t, [])
        jfaults.install_plan(jfaults.FaultPlan.from_spec({"fail": [entry]}))
        try:
            params, _, t = jtrain(t, print_every=0, eval_every=0,
                                  logger=JNull(), guard=JGuardConfig())
        finally:
            jfaults.clear_plan()
        out[case] = (init, stepped, list(t.quarantined_items),
                     jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("case", sorted(PLANS))
def test_guarded_run_matches_jax(jax_guarded, case):
    init, jstepped, jquarantined, jparams = jax_guarded[case]
    t = _port_task(case, init)
    stepped = _record(t, [])
    _plan(PLANS[case])
    _, _, t = train(t, print_every=0, eval_every=0, logger=NullLogger(),
                    guard=GuardConfig())
    assert t.quarantined_items == jquarantined == [PLANS[case]["at"]]
    np.testing.assert_allclose(stepped, jstepped, atol=1e-5, rtol=0)
    # the discarded item's loss is not committed
    assert len(t.losses) == len(stepped) - 1
    ref = _port_model(case, jparams)  # the JAX final params, port layout
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(t.state.params[name].numpy(),
                                   p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------- the port's contracts


def make_task(cycles=CYCLES, **kw):
    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    return prepare_training(MLP(8 * 8 * 3, (10, 10), device="cpu", seed=0),
                            ds, optim.adam(1e-3), batch_size=8, cycles=cycles,
                            topk=(), guard=True, device="cpu", **kw)


def _state_equal(a, b):
    from fluxdistributed_tpu_torch.tree import leaves

    la = leaves((a.params, a.opt_state, a.model_state))
    lb = leaves((b.params, b.opt_state, b.model_state))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def clean_skip2():
    t = make_task()
    train(t, print_every=0, eval_every=0, logger=NullLogger(),
          guard=GuardConfig(quarantine=(2,)))
    return t


@pytest.mark.parametrize("site,action", [("train.loss", "nan"),
                                         ("train.grad", "inf")])
def test_injected_anomaly_matches_clean_skip(clean_skip2, site, action):
    t = make_task()
    stepped = _record(t, [])
    _plan({"site": site, "at": 2, "action": action})
    train(t, print_every=0, eval_every=0, logger=NullLogger(),
          guard=GuardConfig())
    assert t.quarantined_items == [2]
    assert len(stepped) == len(clean_skip2.losses) + 1
    assert t.losses == clean_skip2.losses
    assert _state_equal(t.state, clean_skip2.state)


def test_guard_policy_is_transparent_without_anomalies():
    t1, t2 = make_task(), make_task()
    train(t1, print_every=0, eval_every=0, logger=NullLogger(),
          guard=GuardConfig())
    train(t2, print_every=0, eval_every=0, logger=NullLogger())
    assert t1.quarantined_items == [] and t1.losses == t2.losses
    assert _state_equal(t1.state, t2.state)


def test_sentinel_shape_values_and_poisoning():
    t = make_task()
    batch = next(iter(t.loader))
    _, m = t.step_fn(t.state, batch)
    g = m["guard"]
    assert g.shape == (2,) and g.dtype == torch.float32
    assert g[0].item() == m["loss"].float().item()  # bit-equal when finite
    assert g[1].item() > 0 and bool(torch.isfinite(g).all())
    bad = dict(batch)
    bad["image"] = batch["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    _, m = t.step_fn(t.state, bad)
    assert not math.isfinite(m["guard"][0].item())


def test_prepare_guard_refuses_modes_without_the_sentinel():
    ds = SyntheticDataset(nsamples=16, nclasses=4, shape=(8, 8, 3))
    with pytest.raises(ValueError, match="loss-only"):
        prepare_training(MLP(192, (4,), device="cpu"), ds, optim.adam(1e-3),
                         batch_size=8, cycles=2, topk=(), guard=True,
                         spmd="shard_map", device="cpu")
    with pytest.raises(ValueError, match="loss-only"):
        jprepare(JMLP(features=(4,)), JSynth(nsamples=16, nclasses=4,
                                             shape=(8, 8, 3)),
                 joptim.adam(1e-3), batch_size=8, cycles=2, topk=(),
                 guard=True, spmd="fsdp")


ROLLBACK_CFG = ranks.ROLLBACK_CFG


def test_rollback_matches_clean_skip_run(tmp_path):
    from fluxdistributed_tpu_torch.obs import get_registry

    clean = make_task(cycles=10)
    train(clean, print_every=0, eval_every=0, logger=NullLogger(),
          guard=GuardConfig(quarantine=(3, 4, 5), **ROLLBACK_CFG))
    t = make_task(cycles=10)
    _plan({"site": "train.loss", "at": 3, "action": "nan"},
          {"site": "train.grad", "at": 4, "action": "inf"},
          {"site": "train.loss", "at": 5, "action": "nan"})
    before = get_registry().value("fdtpu_guard_rollbacks_total")
    train(t, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=str(tmp_path), checkpoint_every=2,
          guard=GuardConfig(**ROLLBACK_CFG))
    assert t.quarantined_items == [3, 4, 5]
    assert get_registry().value("fdtpu_guard_rollbacks_total") == before + 1
    assert t.losses == clean.losses and _state_equal(t.state, clean.state)
    assert read_resume_manifest(tmp_path) is None  # a finished run


def test_rollback_loop_halts_with_manifest(tmp_path):
    t = make_task()
    _plan({"site": "train.loss", "times": 99, "action": "nan"})
    with pytest.raises(GuardHalt) as ei:
        train(t, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=str(tmp_path), checkpoint_every=2,
              guard=GuardConfig(rollback_after=2, anomaly_window=8,
                                max_rollbacks=1))
    assert ei.value.retryable is False
    m = read_resume_manifest(tmp_path)
    assert m is not None and m["reason"] == "guard"
    assert m["quarantined_items"] == ei.value.quarantined
    assert m["checkpoint_step"] == 0 and m["next_item"] == 0


def test_rollback_without_checkpoint_dir_halts():
    t = make_task()
    _plan({"site": "train.loss", "times": 99, "action": "nan"})
    with pytest.raises(GuardHalt, match="no checkpoint_dir"):
        train(t, print_every=0, eval_every=0, logger=NullLogger(),
              guard=GuardConfig(rollback_after=2, anomaly_window=8))


def test_resume_skips_the_manifests_quarantine(clean_skip2, tmp_path):
    """Quarantine at item 2, SIGTERM at item 5, resume: the manifest's
    quarantine is skipped again and the run ends as the clean skip."""
    t = make_task()
    faults.install_plan(faults.FaultPlan.from_spec({"fail": [
        {"site": "train.grad", "at": 2, "action": "nan"}]}
    ).sigterm_at_step(5))
    with pytest.raises(faults.Preempted):
        train(t, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=str(tmp_path), checkpoint_every=0,
              handle_signals=True, guard=GuardConfig())
    faults.clear_plan()
    head = list(t.losses)
    r = make_task()
    m = resume_training(r, str(tmp_path))
    assert m["next_item"] == 5 and r.quarantined_items == [2]
    train(r, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=str(tmp_path), guard=GuardConfig())
    assert head + r.losses == clean_skip2.losses
    assert _state_equal(r.state, clean_skip2.state)


def test_replay_item_reproduces_the_step_and_keeps_the_state():
    t = make_task()
    before = [x.clone() for x in t.state.params.values()]
    report = replay_item(t, 2)
    assert report["item"] == 2 and report["finite"] is True
    assert report["sentinel"] == "compiled" and len(report["loss"]) == 1
    assert replay_item(t, 2, debug_nans=False)["loss"] == report["loss"]
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                  t.state.params.values()))
    # the loader draws item 2 as the run does
    batch = t.loader._put(t.loader._assemble(2))
    _, m = t.step_fn(t.state, batch)
    assert report["loss"] == [m["loss"].item()]
    with pytest.raises(ValueError, match="outside"):
        replay_item(t, 10**6)


class _NaNAt:
    """A SyntheticDataset whose draws carry a NaN pixel."""

    nclasses = 10

    def __init__(self):
        self.ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))

    def __len__(self):
        return len(self.ds)

    def batch(self, rng, n):
        x, y = self.ds.batch(rng, n)
        x[0, 0, 0, 0] = np.nan
        return x, y


def test_replay_item_names_the_backward_op_that_made_a_nan():
    t = prepare_training(SimpleCNN(num_classes=10, device="cpu"), _NaNAt(),
                         optim.adam(1e-3), batch_size=4, cycles=2, topk=(),
                         guard=True, device="cpu")
    report = replay_item(t, 1)
    assert report["finite"] is False
    assert "Backward" in report["error"] and "nan" in report["error"]
    assert replay_item(t, 1, debug_nans=False)["finite"] is False


def test_cli_guard_quarantine_replay_and_halt_rc(tmp_path, capsys):
    base = ["--model", "SimpleCNN", "--dataset", "synthetic",
            "--num-classes", "4", "--image-size", "8", "--batch-size", "8",
            "--cycles", "6", "--print-every", "0", "--eval-every", "0",
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
            "0", "--guard", "--device", "cpu"]
    assert cli.main(base + ["--fault-plan", json.dumps({"fail": [
        {"site": "train.loss", "at": 2, "action": "nan"}]})]) == 0
    out = capsys.readouterr().out
    assert "guard: nonfinite anomaly at item 2" in out
    assert "done: 5 steps" in out
    assert cli.main(base + ["--resume", "--replay-step", "2"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["item"] == 2 and report["finite"] is True
    rc = cli.main(base + ["--checkpoint-dir", str(tmp_path / "halt"),
                          "--checkpoint-every", "2",
                          "--guard-rollback-after", "2", "--fault-plan",
                          json.dumps({"fail": [{"site": "train.loss",
                                                "times": 99,
                                                "action": "nan"}]})])
    assert rc == faults.HALTED_RC == jfaults.HALTED_RC
    assert "retryable: false" in capsys.readouterr().out


# ------------------------------------------ ZeRO-1 on 2 gloo ranks, elastic


@pytest.fixture(scope="module")
def jax_zero1_two():
    """The JAX guarded ZeRO-1 run on data_mesh(2) (momentum 0.1) under a
    ``train.grad`` inf at item 2, and its initial params."""
    t = jprepare(JMLP(features=(10, 10)),
                 JSynth(nsamples=64, nclasses=10, shape=(8, 8, 3)),
                 joptim.momentum(0.1, 0.9), mesh=jdata_mesh(2), batch_size=8,
                 cycles=8, topk=(), zero1=True, guard=True)
    init = jax.tree.map(np.asarray, t.state.params)
    stepped = _record(t, [])
    jfaults.install_plan(jfaults.FaultPlan.from_spec({"fail": [
        {"site": "train.grad", "at": 2, "action": "inf"}]}))
    try:
        params, _, t = jtrain(t, print_every=0, eval_every=0,
                              logger=JNull(), guard=JGuardConfig())
    finally:
        jfaults.clear_plan()
    return init, stepped, list(t.quarantined_items), jax.tree.map(
        np.asarray, params)


def test_zero1_two_ranks_match_jax_and_roll_back_after_elastic_resume(
        jax_zero1_two, tmp_path):
    init, jstepped, jquarantined, jparams = jax_zero1_two
    out = run_ranks(ranks.two_ranks, 2, init, str(tmp_path))
    ref = load_flax_simple(MLP(192, (10, 10), device="cpu"), jparams)
    for r in out:
        assert r["quarantined"] == jquarantined == [2]
        np.testing.assert_allclose(r["stepped"], jstepped, atol=1e-5, rtol=0)
        for name, p in ref.named_parameters():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       p.detach().numpy(), atol=1e-5,
                                       rtol=0, err_msg=name)
        assert r["preempted"] and r["head"] == out[0]["head"]
    assert read_resume_manifest(tmp_path)["next_item"] == 6

    try:
        # the clean-skip oracle on one rank of this process
        clean = ranks.task(None)
        train(clean, print_every=0, eval_every=0, logger=NullLogger(),
              guard=GuardConfig(quarantine=(6, 7, 8), **ROLLBACK_CFG))
        # elastic: the 2-rank checkpoint resumes on 1 rank, then
        # anomalies at 6, 7, 8 roll back onto the re-banked baseline
        resumed = ranks.task(None)
        assert resume_training(resumed, str(tmp_path)) is not None
        _plan({"site": "train.loss", "at": 6, "action": "nan"},
              {"site": "train.loss", "at": 7, "action": "nan"},
              {"site": "train.grad", "at": 8, "action": "inf"})
        train(resumed, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=str(tmp_path), checkpoint_every=2,
              guard=GuardConfig(**ROLLBACK_CFG))
        assert resumed.quarantined_items == [6, 7, 8]
        np.testing.assert_allclose(out[0]["head"] + resumed.losses,
                                   clean.losses, rtol=1e-4, atol=1e-6)
        assert read_resume_manifest(tmp_path) is None
    finally:
        shutdown_distributed()
