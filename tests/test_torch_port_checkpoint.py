"""Port parity: the checkpoint's atomicity contract
(``fluxdistributed_tpu_torch/train/checkpoint.py``), case for case the
JAX package's ``tests/test_checkpoint_atomic.py``, and the RESUME
manifest against the JAX writer.

The port writes its own format (``torch.save``; orbax imports jax), so
the JAX cases are held against the port itself: a death between write
and rename, a death mid-write, an asynchronous save published at the
drain, an atomic overwrite and its refusal, a failed asynchronous
commit that must not wedge later saves, injected I/O transients on save
and load, and one real ``kill -9`` of a saving process.  Each runs on a
dict of tensors and on a ZeRO-1 ``TrainState`` of a one-rank gloo group
(the optimizer state gathered into whole padded buffers on save, sliced
back on load).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import fluxdistributed_tpu_torch.train.checkpoint as ck_mod
from fluxdistributed_tpu_torch import faults, optim
from fluxdistributed_tpu_torch.mesh import init_distributed, shutdown_distributed
from fluxdistributed_tpu_torch.parallel import zero1_state
from fluxdistributed_tpu_torch.parallel.dp import TrainState
from fluxdistributed_tpu_torch.train import (latest_step, load_checkpoint,
                                             save_checkpoint, wait_for_pending)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group for the ZeRO-1 state, ended with the file."""
    m = init_distributed("cpu")
    yield m
    shutdown_distributed()


def _params(value):
    return {"w": torch.full((4, 3), value), "b": torch.full((10,), value)}


class _Dense:
    kw: dict = {}

    def __call__(self, value=1.0):
        return {"params": _params(value), "step": 7}


class _Zero1:
    def __init__(self, mesh):
        self.kw = {"mesh": mesh, "zero1": True}
        self.mesh = mesh

    def __call__(self, value=1.0):
        st = zero1_state(_params(value), optim.adam(1e-3), self.mesh)
        # optimizer slots that differ from the params' value
        m = {k: None if s is None else tuple(x + value for x in s)
             for k, s in st.opt_state.items()}
        return TrainState(st.params, m, st.model_state, step=int(value))


@pytest.fixture(params=["dense", "zero1"])
def make_state(request, mesh):
    return _Dense() if request.param == "dense" else _Zero1(mesh)


def _leaves(tree):
    if isinstance(tree, TrainState):
        tree = (tree.params, tree.opt_state, tree.model_state)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _save(make_state, value, d, step, **kw):
    return save_checkpoint(make_state(value), str(d), step,
                           **make_state.kw, **kw)


def _load(make_state, d, **kw):
    mesh = make_state.kw.get("mesh")
    return load_checkpoint(str(d), make_state(0.0), mesh=mesh, **kw)


def test_interrupted_rename_leaves_previous_loadable(
        tmp_path, make_state, monkeypatch):
    """Death between the finished write and the publish rename: the
    staging dir is complete but uncommitted, and step 1 stays latest."""
    _save(make_state, 1.0, tmp_path, 1)

    def die(tmp, final):
        raise RuntimeError("simulated kill between write and rename")

    monkeypatch.setattr(ck_mod, "_commit_rename", die)
    with pytest.raises(RuntimeError, match="simulated kill"):
        _save(make_state, 2.0, tmp_path, 2)
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 1
    names = os.listdir(tmp_path)
    assert "step_2" not in names and any(".tmp." in n for n in names)
    _same(_load(make_state, tmp_path), make_state(1.0))
    # the next save of that step sweeps the stale staging dir
    _save(make_state, 3.0, tmp_path, 2)
    assert latest_step(str(tmp_path)) == 2
    assert not any(".tmp." in n for n in os.listdir(tmp_path))


def test_interrupted_write_leaves_previous_loadable(
        tmp_path, make_state, monkeypatch):
    """Death mid-write: only partial staging garbage exists, never a
    committed half-checkpoint."""
    _save(make_state, 1.0, tmp_path, 1)
    real_save = torch.save

    def dying(obj, path, *a, **k):
        with open(path, "w") as f:
            f.write("garbage")
        raise RuntimeError("simulated kill mid-write")

    monkeypatch.setattr(torch, "save", dying)
    with pytest.raises(RuntimeError, match="mid-write"):
        _save(make_state, 2.0, tmp_path, 2)
    monkeypatch.setattr(torch, "save", real_save)
    assert latest_step(str(tmp_path)) == 1
    _same(_load(make_state, tmp_path), make_state(1.0))


def test_async_save_commits_at_wait(tmp_path, make_state):
    """``block=False`` publishes at ``wait_for_pending``: then the step
    dir is complete and no staging dir remains."""
    _save(make_state, 5.0, tmp_path, 3, block=False)
    wait_for_pending()
    assert latest_step(str(tmp_path)) == 3
    assert not any(".tmp." in n for n in os.listdir(tmp_path))
    _same(_load(make_state, tmp_path), make_state(5.0))


def test_async_snapshot_is_taken_before_the_save_returns(tmp_path):
    """A state written in place after a ``block=False`` save returns
    (as a graph replay donates it) does not reach the checkpoint."""
    state = {"params": _params(1.0), "step": 1}
    save_checkpoint(state, str(tmp_path), 1, block=False)
    for p in state["params"].values():
        p.fill_(-9.0)
    wait_for_pending()
    _same(load_checkpoint(str(tmp_path)), {"params": _params(1.0)})


def test_overwrite_same_step_swaps_atomically(tmp_path, make_state):
    _save(make_state, 1.0, tmp_path, 1)
    _save(make_state, 9.0, tmp_path, 1)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    _same(_load(make_state, tmp_path), make_state(9.0))
    with pytest.raises(FileExistsError):
        _save(make_state, 2.0, tmp_path, 1, overwrite=False)
    _same(_load(make_state, tmp_path), make_state(9.0))


def test_failed_async_commit_does_not_wedge_later_saves(tmp_path):
    """A commit that refuses (overwrite=False on an existing step) raises
    once at the drain and is dropped: later saves go through."""
    dense = _Dense()
    _save(dense, 1.0, tmp_path, 1)
    _save(dense, 2.0, tmp_path, 1, overwrite=False, block=False)
    with pytest.raises(FileExistsError):
        wait_for_pending()
    wait_for_pending()  # drained: no re-raise
    _save(dense, 3.0, tmp_path, 2)
    assert latest_step(str(tmp_path)) == 2
    _same(load_checkpoint(str(tmp_path), dense(0.0), step=1), dense(1.0))


def test_checkpoint_save_retries_injected_transient(tmp_path, make_state):
    faults.install_plan(faults.FaultPlan().fail(
        "checkpoint_save", times=1,
        exc=lambda: OSError("injected disk hiccup")))
    try:
        _save(make_state, 4.0, tmp_path, 1)
    finally:
        faults.clear_plan()
    assert latest_step(str(tmp_path)) == 1
    _same(_load(make_state, tmp_path), make_state(4.0))


def test_checkpoint_load_retries_injected_transient(tmp_path, make_state):
    _save(make_state, 4.0, tmp_path, 1)
    faults.install_plan(faults.FaultPlan().fail(
        "checkpoint_load", times=1,
        exc=lambda: OSError("injected read hiccup")))
    try:
        restored = _load(make_state, tmp_path)
    finally:
        faults.clear_plan()
    _same(restored, make_state(4.0))


def test_raw_load_layouts_and_refusals(tmp_path, mesh):
    """``target=None`` gives the saved tree (a ZeRO-1 state's optimizer
    buffers whole and padded); a target gives its own dtypes and
    layouts (a channels-last conv weight stays channels-last); a leaf
    the checkpoint lacks, and a ZeRO-1 checkpoint read at another rank
    count without the elastic path, are refused."""
    z = _Zero1(mesh)
    save_checkpoint(z(2.0), str(tmp_path), 5, mesh=mesh, zero1=True)
    raw = load_checkpoint(str(tmp_path))
    assert raw["step"] == 2 and set(raw) == {"params", "opt_state",
                                            "model_state", "step"}
    assert raw["opt_state"]["w"][0].shape == (12,)
    conv = torch.randn(4, 3, 2, 2).contiguous(
        memory_format=torch.channels_last)
    save_checkpoint({"params": {"c": conv}, "step": 1}, str(tmp_path / "c"), 1)
    target = {"params": {"c": torch.zeros_like(conv, dtype=torch.float64)},
              "step": 0}
    got = load_checkpoint(str(tmp_path / "c"), target)
    assert got["params"]["c"].dtype == torch.float64 and got["step"] == 1
    assert got["params"]["c"].is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got["params"]["c"], conv.double())
    with pytest.raises(ValueError, match="lacks 1 leaves"):
        load_checkpoint(str(tmp_path / "c"), {"params": {"d": conv}})
    fake = ck_mod.Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="use load_checkpoint_elastic"):
        load_checkpoint(str(tmp_path), z(0.0), mesh=fake)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_resume_manifest_matches_the_jax_writer(tmp_path):
    """``write_resume_manifest`` writes the JAX package's bytes for the
    same manifest, atomically; read and clear behave alike."""
    from fluxdistributed_tpu.train import checkpoint as jck

    manifest = {"version": 1, "reason": "sigterm", "checkpoint_step": 3,
                "next_item": 3, "steps_per_call": 1, "num_missed": 0,
                "skipped_items": [], "mesh": {"data": 1},
                "device_count": 1, "process_count": 1,
                "rng": {"step": "s", "loader": "l"}}
    for mod, d in ((ck_mod, tmp_path / "port"), (jck, tmp_path / "jax")):
        assert mod.read_resume_manifest(str(d)) is None
        mod.write_resume_manifest(str(d), manifest)
        assert mod.read_resume_manifest(str(d)) == manifest
        assert not [n for n in os.listdir(d) if ".tmp." in n]
    assert ((tmp_path / "port" / "RESUME.json").read_bytes()
            == (tmp_path / "jax" / "RESUME.json").read_bytes())
    (tmp_path / "port" / "RESUME.json").write_text("{half")
    assert ck_mod.read_resume_manifest(str(tmp_path / "port")) is None
    ck_mod.clear_resume_manifest(str(tmp_path / "port"))
    assert not (tmp_path / "port" / "RESUME.json").exists()
    ck_mod.clear_resume_manifest(str(tmp_path / "port"))  # absent: no error


_CHILD = r"""
import sys, time
import torch
import fluxdistributed_tpu_torch.train.checkpoint as ck

directory = sys.argv[1]
ck.save_checkpoint({"w": torch.full((64, 64), 1.0)}, directory, 1)
orig = ck._commit_rename

def pending(tmp, final):
    print("KILL_ME_NOW", flush=True)
    time.sleep(120)
    orig(tmp, final)

ck._commit_rename = pending
ck.save_checkpoint({"w": torch.full((64, 64), 2.0)}, directory, 2)
"""


def test_kill_9_before_the_rename_keeps_the_previous_checkpoint(tmp_path):
    """A real ``kill -9`` of a process whose step-2 write is on disk but
    not yet published: step 1 stays the latest and loads."""
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, str(child), str(tmp_path / "ck")],
                         stdout=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        for line in p.stdout:
            if "KILL_ME_NOW" in line:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("the child never reached the kill point")
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    ck = tmp_path / "ck"
    assert latest_step(str(ck)) == 1
    assert any(".tmp." in n for n in os.listdir(ck))
    got = load_checkpoint(str(ck), {"w": torch.zeros(64, 64)})
    assert torch.equal(got["w"], torch.full((64, 64), 1.0))
    meta = json.loads((ck / "step_1" / "meta.json").read_text())
    assert meta == {"format": 1, "step": 1, "zero1_ranks": None}
