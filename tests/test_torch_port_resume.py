"""Port parity: preemption and resume (``train(checkpoint_dir=,
handle_signals=)``, ``resume_training``, the CLI's ``--checkpoint-dir``,
``--resume`` and ``--fault-plan``) against uninterrupted runs and the
JAX package.

A run SIGTERMed at item k by the fault plan, checkpointed with its
RESUME manifest and resumed in a fresh task, equals the uninterrupted
run bit for bit: losses and every state tensor, at steps_per_call 1 and
2, on one device and on two gloo ranks for DP and for composable and
fused ZeRO-1.  Its losses equal the JAX package's preempted-and-resumed
run on the same weights within 1e-5 relative (the two frameworks' f32
products sum in other orders).  Elastic: ZeRO-1 and fused ZeRO-1 saved
at two ranks resume at three (the flat buffers' pad changes), equal to
the saved state over the real entries and to the two-rank run within
1e-5.  Edge cases: no manifest (the step counter is the cursor), an
empty directory (a fresh run), no ``checkpoint_dir`` (nothing
persisted), and a resumed run preempted again.  The CLI chain runs as
two subprocesses (SIGTERM at step 3 -> rc 75 -> ``--resume`` ->
"done"), as the JAX package's ``tests/test_preempt_resume.py`` runs
``bin/driver.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fluxdistributed_tpu_torch import faults
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.train import (NullLogger, latest_step,
                                             read_resume_manifest,
                                             resume_training, train)

import test_torch_port_resume_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLES = ranks.CYCLES


@pytest.fixture(autouse=True)
def _clean_plan():
    yield
    faults.clear_plan()


def _task(spc=1, **kw):
    return ranks._task(None, spc=spc, **kw)


def _leaves(state):
    return ranks._leaves(state)


def _preempted(directory, at, spc=1):
    """Losses of a run SIGTERMed at item ``at`` (checkpoint and
    manifest in ``directory``); checks the Preempted it raises."""
    task = _task(spc)
    faults.install_plan(faults.FaultPlan().sigterm_at_step(at))
    with pytest.raises(faults.Preempted) as ei:
        train(task, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=str(directory), checkpoint_every=0,
              handle_signals=True)
    faults.clear_plan()
    assert ei.value.step == at * spc and ei.value.next_item == at
    assert len(task.losses) == at * spc
    return list(task.losses)


def _resumed(directory, spc=1):
    task = _task(spc)
    manifest = resume_training(task, str(directory))
    train(task, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=str(directory), checkpoint_every=0)
    return list(task.losses), manifest, task


@pytest.fixture(scope="module")
def baselines():
    out = {}
    for spc in (1, 2):
        task = _task(spc)
        train(task, print_every=0, eval_every=0, logger=NullLogger())
        out[spc] = task
    return out


@pytest.mark.parametrize("spc", [1, 2])
def test_preempt_resume_is_bitwise_on_one_device(tmp_path, baselines, spc):
    at = 4 // spc
    head = _preempted(tmp_path, at, spc)
    m = read_resume_manifest(str(tmp_path))
    assert m["checkpoint_step"] == 4 and m["next_item"] == at
    assert m["reason"] == "sigterm" and m["steps_per_call"] == spc
    assert m["mesh"] == {"data": 1} and m["device_count"] == 1
    assert latest_step(str(tmp_path)) == 4
    tail, manifest, task = _resumed(tmp_path, spc)
    assert manifest == m and task.state.step == CYCLES
    base = baselines[spc]
    assert head + tail == base.losses
    for a, b in zip(_leaves(task.state), _leaves(base.state)):
        assert torch.equal(a, b)
    # a completed run clears the manifest
    assert read_resume_manifest(str(tmp_path)) is None


def _jax_resumed(directory):
    """The JAX package's MLP run preempted at item 3 and resumed: its
    initial params and the losses of every step."""
    import jax

    from fluxdistributed_tpu import faults as jfaults
    from fluxdistributed_tpu import optim as joptim
    from fluxdistributed_tpu.data import SyntheticDataset
    from fluxdistributed_tpu.mesh import data_mesh
    from fluxdistributed_tpu.models import MLP
    from fluxdistributed_tpu.train import prepare_training as jprepare
    from fluxdistributed_tpu.train import resume_training as jresume
    from fluxdistributed_tpu.train import train as jtrain
    from fluxdistributed_tpu.train.logging import NullLogger as JNull

    def make():
        ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
        task = jprepare(MLP(features=(10, 10)), ds, joptim.adam(ranks.LR),
                        mesh=data_mesh(1), batch_size=8, cycles=CYCLES,
                        topk=())
        losses, orig = [], task.step_fn

        def wrapped(state, batch):
            out = orig(state, batch)
            losses.append(float(out[1]["loss"]))
            return out

        task.step_fn = wrapped
        return task, losses

    task, head = make()
    init = jax.tree.map(np.asarray, task.state.params)
    jfaults.install_plan(jfaults.FaultPlan().sigterm_at_step(3))
    try:
        with pytest.raises(jfaults.Preempted):
            jtrain(task, print_every=0, eval_every=0, logger=JNull(),
                   checkpoint_dir=str(directory), checkpoint_every=0,
                   handle_signals=True)
    finally:
        jfaults.clear_plan()
    manifest = json.loads((directory / "RESUME.json").read_text())
    task, tail = make()
    jresume(task, str(directory))
    jtrain(task, print_every=0, eval_every=0, logger=JNull(),
           checkpoint_dir=str(directory), checkpoint_every=0)
    return init, head + tail, manifest


def test_resumed_losses_and_manifest_keys_match_jax(tmp_path, monkeypatch):
    """The port's preempted-and-resumed run on the JAX run's initial
    weights gives the JAX run's losses (1e-5 relative), and its RESUME
    manifest has the JAX manifest's keys and cursor."""
    from fluxdistributed_tpu_torch.models import load_flax_simple

    init, want, jmanifest = _jax_resumed(tmp_path / "jax")
    orig = ranks._task

    def carried(mesh, **kw):
        task = orig(mesh, **kw)
        load_flax_simple(task.model, init)
        task.state.params.update({k: p.detach().clone() for k, p in
                                  task.model.named_parameters()})
        return task

    monkeypatch.setattr(ranks, "_task", carried)
    d = tmp_path / "port"
    head = _preempted(d, 3)
    manifest = read_resume_manifest(str(d))
    tail, _, _ = _resumed(d)
    np.testing.assert_allclose(head + tail, want, rtol=1e-5, atol=0)
    assert set(manifest) == set(jmanifest)
    for k in ("version", "reason", "checkpoint_step", "next_item",
              "steps_per_call", "num_missed", "skipped_items"):
        assert manifest[k] == jmanifest[k], k
    assert set(manifest["rng"]) == set(jmanifest["rng"])


# --------------------------------------------------------------- ranks


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Two gloo ranks (every resume mode, and the checkpoints for the
    elastic case), then three ranks resuming those checkpoints."""
    root = str(tmp_path_factory.mktemp("resume_ranks"))
    two = run_ranks(ranks.two_ranks, 2, root)
    three = run_ranks(ranks.three_ranks, 3, root)
    return two, three


@pytest.mark.parametrize("mode", ["dp_k1", "dp_k2", "zero1_k1", "zero1_k2",
                                  "fused"])
def test_preempt_resume_is_bitwise_on_two_ranks(rank_runs, mode):
    two, _ = rank_runs
    for r in two:
        run = r[mode]
        assert run["state_equal"] and run["step"] == CYCLES
        assert run["head"] + run["tail"] == run["base"]
        if mode != "fused":
            assert run["manifest"]["mesh"] == {"data": 2}
            assert run["manifest"]["device_count"] == 2
    assert two[0][mode]["base"] == two[1][mode]["base"]
    assert all(r["refused"] for r in two)  # overwrite=False, every rank


def test_zero1_ema_params_gather_the_shards(rank_runs):
    two, _ = rank_runs
    for r in two:
        assert r["ema_equal"]
        assert r["ema_shapes"] == {"layers.0.weight": (10, 192),
                                   "layers.0.bias": (10,),
                                   "layers.1.weight": (10, 10),
                                   "layers.1.bias": (10,)}


@pytest.mark.parametrize("kind", ["zero1", "fused"])
def test_elastic_resume_two_to_three_ranks(rank_runs, kind):
    """Saved at two ranks, resumed at three: the flat buffers' pads
    change (bias 10 -> 12; the fused buffer to a multiple of 3 x 1024),
    the gathered restored state equals the saved one over the real
    entries, and the losses follow the two-rank run within 1e-5
    (the gradients' sum over three ranks rounds otherwise)."""
    two, three = rank_runs
    if kind == "zero1":
        head, base = two[0]["elastic_head"], two[0]["elastic_base"]
        for r in three:
            assert r["zero1_restored_equal"] and r["zero1_start"] == 3
            assert r["zero1_manifest"]["mesh"] == {"data": 2}
            np.testing.assert_allclose(head + r["zero1_tail"], base,
                                       rtol=1e-5, atol=0)
    else:
        head, base = two[0]["fused_elastic_head"], two[0]["fused_elastic_base"]
        want = two[0]["fused_elastic_base_params"]
        for r in three:
            assert r["fused_restored_equal"] and r["fused_plain_load_refused"]
            np.testing.assert_allclose(head + r["fused_tail"], base,
                                       rtol=1e-5, atol=0)
            for k, v in want.items():
                np.testing.assert_allclose(r["fused_params"][k], v,
                                           rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- edges


def test_preempt_without_checkpoint_dir_persists_nothing(tmp_path):
    task = _task()
    faults.install_plan(faults.FaultPlan().sigterm_at_step(1))
    with pytest.raises(faults.Preempted) as ei:
        train(task, print_every=0, eval_every=0, logger=NullLogger(),
              handle_signals=True)
    assert ei.value.checkpoint_dir is None and ei.value.manifest["next_item"] == 1
    assert not os.listdir(tmp_path)


def test_resume_without_manifest_uses_step_cursor(tmp_path, baselines):
    """A checkpoint without a manifest (a run killed without signal
    handling) resumes at item step // K."""
    _preempted(tmp_path, 1, spc=2)
    os.remove(tmp_path / "RESUME.json")
    tail, manifest, task = _resumed(tmp_path, spc=2)
    assert manifest is None
    assert tail == baselines[2].losses[2:]
    for a, b in zip(_leaves(task.state), _leaves(baselines[2].state)):
        assert torch.equal(a, b)


def test_resume_on_empty_dir_is_fresh_run(tmp_path):
    task = _task()
    assert resume_training(task, str(tmp_path / "nothing")) is None
    assert task.state.step == 0 and task.loader.start == 0


def test_fresh_signal_mid_resumed_run_preempts_again(tmp_path, baselines):
    """A resumed run preempted again at item 5 and resumed once more
    still gives the uninterrupted run."""
    head = _preempted(tmp_path, 2)
    task = _task()
    resume_training(task, str(tmp_path))
    faults.install_plan(faults.FaultPlan().sigterm_at_step(5))
    with pytest.raises(faults.Preempted):
        train(task, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=str(tmp_path), checkpoint_every=0,
              handle_signals=True)
    faults.clear_plan()
    mid = list(task.losses)
    m = read_resume_manifest(str(tmp_path))
    assert m["next_item"] == 5 and m["checkpoint_step"] == 5
    tail, _, task = _resumed(tmp_path)
    assert head + mid + tail == baselines[1].losses


def test_cadence_checkpoints_do_not_change_the_run(tmp_path, baselines):
    """Non-blocking cadence saves every 3 items: steps 4 and 7 land on
    disk, the losses are the run's without them, and the manifest stays
    absent."""
    task = _task()
    train(task, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert task.losses == baselines[1].losses
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_7"]


# ------------------------------------------------------------------ CLI


def _cli(extra, ck):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "fluxdistributed_tpu_torch.train",
         "--model", "SimpleCNN", "--dataset", "synthetic",
         "--num-classes", "4", "--image-size", "8", "--batch-size", "8",
         "--cycles", "6", "--print-every", "0", "--eval-every", "0",
         "--checkpoint-dir", str(ck), "--checkpoint-every", "0",
         "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_cli_sigterm_checkpoint_resume_chain(tmp_path):
    """A fault-plan SIGTERM at step 3 exits with rc 75 after writing the
    checkpoint and manifest; ``--resume`` finishes the other steps and
    clears the manifest."""
    ck = tmp_path / "ck"
    p1 = _cli(["--fault-plan", '{"sigterm_at_step": 3}'], ck)
    assert p1.returncode == faults.PREEMPTED_RC, (p1.stdout[-1500:],
                                                  p1.stderr[-1500:])
    assert "preempted: training preempted at step 3 (item 3)" in p1.stdout
    assert f"--resume --checkpoint-dir {ck}" in p1.stdout
    manifest = json.loads((ck / "RESUME.json").read_text())
    assert manifest["checkpoint_step"] == 3 and manifest["next_item"] == 3
    p2 = _cli(["--resume"], ck)
    assert p2.returncode == 0, (p2.stdout[-1500:], p2.stderr[-1500:])
    assert "resumed from step 3 at item 3 via RESUME manifest" in p2.stdout
    assert "done: 6 steps, 0 missed" in p2.stdout
    assert not (ck / "RESUME.json").exists()
