"""Port parity: model selection (``train/model_selection.py``, the
reference's legacy per-worker trainer) against the JAX package.

Invariants, as ``tests/test_model_selection.py`` pins them: replicas
train independently (they differ between selections), a selection gives
every replica the min-val-loss one's weights (equal right after it, and
that one is the argmin), and the loop learns a separable task.  Against
JAX: 4 replicas of the MLP on ``data_mesh(2)`` and on 2 gloo ranks (2
replicas a rank), from the JAX task's stacked init, give the same
val-loss history and final params within 1e-5 absolute (f32, the sums
in another order).  The rank body is in
``test_torch_port_model_selection_ranks.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_model_selection_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu.data import SyntheticDataset as JSynth
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import MLP as JMLP
from fluxdistributed_tpu.ops import onehot as jonehot
from fluxdistributed_tpu.train.logging import NullLogger as JNull
from fluxdistributed_tpu.train.model_selection import (
    prepare_model_selection as jprepare, train_model_selection as jtrain)
from fluxdistributed_tpu_torch import models, optim
from fluxdistributed_tpu_torch.data import SyntheticDataset
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.models import MLP, load_flax_simple
from fluxdistributed_tpu_torch.ops.metrics import onehot
from fluxdistributed_tpu_torch.train import (NullLogger,
                                             prepare_model_selection,
                                             train_model_selection)


def _val(ds, n=32, seed=1):
    imgs, labels = ds.batch(np.random.default_rng(seed), n)
    return {"image": imgs,
            "label": np.eye(ds.nclasses, dtype=np.float32)[labels]}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _mlp(features):
    return functools.partial(MLP, 8 * 8 * 3, features)


def test_replicas_independent_then_identical_after_selection():
    ds = SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3))
    task = prepare_model_selection(_mlp((16, 4)), optim.momentum(0.05, 0.9),
                                   replicas=8, input_shape=(8, 8, 3),
                                   device="cpu")
    w = [p["layers.0.weight"] for p in task.params]
    assert not torch.equal(w[0], w[1])
    _, history = train_model_selection(
        task, ds, _torch(_val(ds)), cycles=1, steps_per_cycle=2,
        batch_size_per_replica=4, logger=NullLogger())
    for p in task.params[1:]:
        for k, v in p.items():
            assert torch.equal(v, task.params[0][k]), k
    assert len(history) == 1 and history[0].shape == (8,)


def test_selection_learns_separable_task():
    ds = SyntheticDataset(nsamples=256, nclasses=2, shape=(8, 8, 3),
                          noise=0.1)
    task = prepare_model_selection(
        _mlp((32, 2)), optim.momentum(optim.step_decay(0.1, 0.2, every=10),
                                      0.9),
        replicas=8, input_shape=(8, 8, 3), device="cpu")
    _, history = train_model_selection(
        task, ds, _torch(_val(ds, n=64)), cycles=8, steps_per_cycle=4,
        batch_size_per_replica=8, logger=NullLogger())
    assert history[-1].min() < history[0].min() * 0.7


def test_best_replica_is_the_argmin():
    ds = SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3))
    task = prepare_model_selection(_mlp((16, 4)), optim.momentum(0.05, 0.9),
                                   replicas=8, input_shape=(8, 8, 3),
                                   device="cpu")
    before = [{k: v.clone() for k, v in p.items()} for p in task.params]
    new, _, _, losses = task.select_fn(task.params, task.opt_state,
                                       task.model_state, _torch(_val(ds)))
    best = int(np.argmin(losses.numpy()))
    for p in new:
        for k, v in p.items():
            assert torch.equal(v, before[best][k]), k


def test_batchnorm_replicas_select_their_running_stats():
    """A ResNet-18 (BatchNorm) runs the replica loop: the running stats
    train per replica and follow the selected one."""
    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    task = prepare_model_selection(
        functools.partial(models.resnet18, num_classes=10),
        optim.momentum(0.05, 0.9), replicas=2, input_shape=(8, 8, 3),
        device="cpu")
    batch = {"image": torch.from_numpy(ds.batch(np.random.default_rng(0),
                                                8)[0]).reshape(2, 4, 8, 8, 3),
             "label": onehot(torch.zeros(2, 4, dtype=torch.long), 10)}
    p, o, m, losses = task.step_fn(task.params, task.opt_state,
                                   task.model_state, batch, 0)
    key = "bn1.running_mean"
    assert losses.shape == (2,)
    assert not torch.equal(m[0][key], task.model_state[0][key])
    _, _, sel, vl = task.select_fn(p, o, m, _torch(_val(ds)))
    best = int(np.argmin(vl.numpy()))
    assert all(torch.equal(s[key], m[best][key]) for s in sel)


def test_two_ranks_match_jax_on_the_same_stacked_init():
    ds = JSynth(nsamples=64, nclasses=4, shape=(8, 8, 3))
    val = _val(ds)
    jtask = jprepare(JMLP(features=(16, 4)), joptim.momentum(0.05, 0.9),
                     mesh=jdata_mesh(2), replicas=ranks.REPLICAS,
                     input_shape=(8, 8, 3))
    init = jax.tree.map(np.asarray, jtask.params)
    jval = {"image": jnp.asarray(val["image"]),
            "label": jonehot(jnp.asarray(val["label"].argmax(-1)), 4)}
    jbest, jhistory = jtrain(jtask, ds, jval, cycles=ranks.CYCLES,
                             steps_per_cycle=ranks.STEPS,
                             batch_size_per_replica=ranks.BPR,
                             logger=JNull())
    out = run_ranks(ranks.selection, 2, init, val)
    ref = load_flax_simple(MLP(192, (16, 4), device="cpu"),
                           jax.tree.map(np.asarray, jbest))
    assert [r["first"] for r in out] == [0, 2]
    for r in out:
        assert r["local"] == 2 and r["equal_after"]
        np.testing.assert_allclose(np.asarray(r["history"]),
                                   np.stack(jhistory), atol=1e-5, rtol=0)
        for name, p in ref.named_parameters():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       p.detach().numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
    assert [int(np.argmin(h)) for h in out[0]["history"]] == [
        int(np.argmin(h)) for h in jhistory]


def test_replicas_must_divide_over_the_ranks():
    class _Mesh:
        size, rank, device, group = 3, 0, torch.device("cpu"), None

    with pytest.raises(ValueError, match="divide"):
        prepare_model_selection(_mlp((4,)), optim.descent(), mesh=_Mesh(),
                                replicas=4, input_shape=(8, 8, 3))
