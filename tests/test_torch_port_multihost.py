"""Port parity: multi-process runs (``parallel/multihost.py`` and the
training CLI's ``--coordinator``/``--num-processes``/``--process-id``)
against the in-process ranks and the JAX package.

The checks of the JAX package's slow ``tests/test_multihost.py``, at a
smaller cost: two CLI processes form one gloo group over TCP on
localhost and train SimpleCNN on synthetic images for 3 momentum steps.
Their losses (read from the coordinator's flight recorder, which keeps
each loss as the float it was) must equal, bit for bit, the same CLI
run on 2 ranks of ``mesh.run_ranks`` (one spawn, bodies in
``test_torch_port_multihost_ranks.py``; every collective is the same
2-rank gloo sum).  Those ranks' losses and parameters are held to the
JAX DP step on ``data_mesh(2)`` from the same weights and the same
batches with the DP parity tests' tolerances: losses rtol 1e-5,
parameters rtol 1e-4 / atol 1e-6.  ``--spmd fsdp`` saves a sharded
checkpoint across the processes, and a fresh 2-process group resumes
from it and finishes at step 6.
"""

import importlib
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_multihost_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import SimpleCNN as JSimpleCNN
from fluxdistributed_tpu.ops import logitcrossentropy as jxent
from fluxdistributed_tpu.parallel import TrainState as JState
from fluxdistributed_tpu.parallel import make_train_step as jmake_step
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu_torch.parallel import multihost

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH, NCLASS, SIZE, STEPS = 2, 8, 10, 24, 3
ARGS = ["--model", "SimpleCNN", "--dataset", "synthetic",
        "--num-classes", str(NCLASS), "--image-size", str(SIZE),
        "--batch-size", str(BATCH), "--cycles", str(STEPS),
        "--opt", "momentum", "--lr", "0.05", "--print-every", "1",
        "--eval-every", "0"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(argv: list, extra: list) -> list:
    """The CLI as ``N`` processes of one group over a fresh port."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    coord = ["--coordinator", f"localhost:{_free_port()}",
             "--num-processes", str(N)]
    return [subprocess.Popen(
        [sys.executable, "-m", "fluxdistributed_tpu_torch.train", *argv,
         *coord, "--process-id", str(i), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(N)]


def _finish(procs, timeout: float = 240.0) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rc {p.returncode}:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-process CLI run and the 2-rank in-process run, started
    together before the JAX reference computes."""
    tmp = tmp_path_factory.mktemp("multihost")
    flight = str(tmp / "flight.jsonl")
    procs = _start(ARGS, ["--device", "cpu", "--flight", flight])
    spawn = Spawned(ranks.cli_and_api, N, ARGS + ["--device", "cpu"])
    return procs, flight, spawn


@pytest.fixture(scope="module")
def cli_run(runs):
    procs, flight, _ = runs
    outs = _finish(procs)
    with open(flight) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if r.get("kind") == "record"]
    return outs, losses


@pytest.fixture(scope="module")
def rank_run(runs):
    return runs[2].result()


def _flax_params(sd: dict) -> dict:
    """The port SimpleCNN's state_dict as the flax tree (the inverse of
    ``models.load_flax_simple``)."""
    return {"Conv_0": {"kernel": sd["conv1.weight"].transpose(2, 3, 1, 0),
                       "bias": sd["conv1.bias"]},
            "Conv_1": {"kernel": sd["conv2.weight"].transpose(2, 3, 1, 0),
                       "bias": sd["conv2.bias"]},
            "Dense_0": {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}}


@pytest.fixture(scope="module")
def jax_run(runs):
    """The JAX DP step on ``data_mesh(2)``: the CLI's seed-0 weights and
    its loader's batches (item ``i`` is drawn from
    ``default_rng((0, 0, i))``, as both packages' loaders draw it)."""
    from fluxdistributed_tpu_torch import data, models
    from fluxdistributed_tpu_torch.data.loader import batch_to_dict

    port = models.SimpleCNN(num_classes=NCLASS, device="cpu", seed=0)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    back = models.load_flax_simple(
        models.SimpleCNN(num_classes=NCLASS, device="cpu", seed=1),
        _flax_params(sd))
    for k, v in back.state_dict().items():  # the inverse is exact
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    ds = data.SyntheticDataset(nsamples=max(BATCH * 8, 1024),
                               nclasses=NCLASS, shape=(SIZE, SIZE, 3))
    mesh = jdata_mesh(N)
    opt = joptim.momentum(0.05, 0.9)
    st = JState.create(jsharding.replicate(
        jax.tree.map(jnp.asarray, _flax_params(sd)), mesh), opt)
    step = jmake_step(flax_loss_fn(JSimpleCNN(num_classes=NCLASS), jxent),
                      opt, mesh, donate=False)
    losses, images = [], []
    for i in range(STEPS):
        b = batch_to_dict(ds.batch(np.random.default_rng((0, 0, i)), BATCH),
                          NCLASS)
        images.append(b["image"])
        st, m = step(st, jsharding.shard_batch(b, mesh))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, st.params), images


def test_two_process_cli_equals_in_process_ranks(cli_run, rank_run):
    outs, losses = cli_run
    assert len(losses) == STEPS
    for r in range(N):
        assert rank_run[r]["losses"] == losses, (r, rank_run[r]["losses"],
                                                 losses)
    assert "devices: 2 (1/host x 2 hosts), platform cpu" in outs[0]
    assert f"done: {STEPS} steps" in outs[0]
    # only the coordinator logs
    assert "done:" not in outs[1] and "device:" not in outs[1]


def test_each_process_feeds_its_own_rows(rank_run, jax_run):
    """Rank ``r`` feeds rows ``[r B/2, (r + 1) B/2)`` of each global
    batch, as JAX process ``r`` feeds its devices' rows (a swap would
    leave the DP losses unchanged)."""
    half = BATCH // N
    for r, out in enumerate(rank_run):
        for got, glob in zip(out["rows"], jax_run[2]):
            np.testing.assert_array_equal(got, glob[r * half:(r + 1) * half])


def test_ranks_match_jax_dp(rank_run, jax_run):
    losses, params, _ = jax_run
    np.testing.assert_allclose(rank_run[0]["losses"], losses, rtol=1e-5)
    got = _flax_params(rank_run[0]["params"])
    for layer in params:
        for k in params[layer]:
            np.testing.assert_allclose(got[layer][k], params[layer][k],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{layer}/{k}")
    for k, v in rank_run[0]["params"].items():  # replicas agree
        np.testing.assert_array_equal(rank_run[1]["params"][k], v)


def test_multihost_api_on_two_ranks(rank_run):
    for r, out in enumerate(rank_run):
        assert out["index"] == (r, N, r == 0, True)
        assert out["local_batch"] == 4
        assert "not divisible by 2 processes" in out["odd_batch"]
        assert out["stop_one"] is True and out["stop_none"] is False
        assert out["bcast"] == {"rank": 0, "tag": "from 0"}
        np.testing.assert_array_equal(out["gathered"], [0, 1, 10, 11])
        np.testing.assert_array_equal(
            out["global"], np.concatenate([np.arange(4) + 100.0 * p
                                           for p in range(N)]))
        assert out["global_spec"] == ("data",)
        np.testing.assert_array_equal(
            out["committed"], np.arange(8).reshape(4, 2)[2 * r:2 * r + 2])
        assert out["device"] == "cpu"


def test_fsdp_checkpoint_resumes_on_a_fresh_group(tmp_path, cli_run):
    ck = str(tmp_path / "ck")
    argv = ARGS + ["--spmd", "fsdp", "--checkpoint-dir", ck,
                   "--checkpoint-every", "2"]
    outs = _finish(_start(argv, ["--platform", "cpu"]))
    assert f"done: {STEPS} steps" in outs[0], outs[0][-2000:]
    assert os.path.isdir(os.path.join(ck, f"step_{STEPS}"))
    argv[argv.index("--cycles") + 1] = "6"
    outs = _finish(_start(argv + ["--resume"], ["--platform", "cpu"]))
    assert f"resumed from step {STEPS}" in outs[0], outs[0][-2000:]
    assert "done: 6 steps" in outs[0], outs[0][-2000:]


def test_one_process_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is None
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_coordinator() and not multihost.is_distributed()
    assert multihost.agree_to_stop(True) is True
    assert multihost.broadcast_from_coordinator({"a": 1}) == {"a": 1}
    np.testing.assert_array_equal(multihost.host_local_values([1, 2]),
                                  [1, 2])
    assert multihost.local_batch_size(7) == 7
    multihost.sync_global_devices()


@pytest.mark.parametrize("args", [
    dict(coordinator_address="localhost:1"),
    dict(num_processes=2, process_id=0),
    dict(coordinator_address="localhost:1", num_processes=2),
])
def test_partial_cluster_arguments_raise(args):
    with pytest.raises(ValueError, match="needs all of"):
        multihost.initialize(device="cpu", **args)


def test_partial_torchrun_environment_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="incomplete"):
        multihost.initialize(device="cpu")


@pytest.mark.parametrize("extra, msg", [
    (["--local-devices", "2"], "one process drives one device"),
    (["--platform", "tpu"], "runs on a CUDA card"),
    (["--platform", "gpu", "--device", "cpu"], "conflicts"),
    (["--coordinator", "localhost:1", "--device", "cpu"], "needs all of"),
])
def test_cli_refusals(extra, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.run(ARGS + extra)


def test_platform_cpu_is_device_cpu():
    task = cli.run(ARGS + ["--platform", "cpu", "--cycles", "1",
                           "--local-devices", "1"])
    assert task.device == torch.device("cpu") and task.state.step == 1
