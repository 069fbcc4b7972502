"""Rank bodies for the port's N-rank image tests
(``test_torch_port_vision.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name.  So the module imports the port and numpy
only, never JAX; the parent test compares what the ranks return with
the JAX package.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's resnet18 at the tests' width
MODEL = dict(num_classes=10, width=8, dtype=torch.float32, device="cpu")


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _load(model, sd: dict):
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model


def _batch(x: np.ndarray, y: np.ndarray, mesh=None) -> dict:
    from fluxdistributed_tpu_torch.sharding import shard_batch

    b = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    return b if mesh is None else shard_batch(b, mesh)


def resnet_steps(mesh, sd: dict, batches: list, lr: float,
                 modes: tuple) -> dict:
    """Momentum steps of resnet18 (width 8) from the weights ``sd`` over
    the global ``batches`` (``(images, one-hot labels)``), in each of
    ``modes``: ``"sync"`` (the DP step, BatchNorm over the global batch),
    ``"local"`` (the DP step, BatchNorm over this rank's rows: the
    control) and ``"zero1"`` (composable ZeRO-1, global BatchNorm).
    Each gives its losses, this rank's params and model state.  With
    ``"sync"`` also: whether the first step's model state is exactly
    the one the loss function returned (no mean over the ranks)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, local_grads, make_train_step, make_train_step_zero1,
        module_loss_fn, zero1_state)
    from fluxdistributed_tpu_torch.sharding import replicate

    model = _load(resnet18(**MODEL), sd)
    params = {k: p.detach() for k, p in model.named_parameters()}
    mstate = {k: b.detach().clone() for k, b in model.named_buffers()}
    opt = optim.momentum(lr, 0.9)
    out = {}
    for mode in modes:
        loss_fn = module_loss_fn(model, logitcrossentropy,
                                 None if mode == "local" else mesh)
        if mode == "zero1":
            st = zero1_state(params, opt, mesh, model_state=mstate)
            step = make_train_step_zero1(loss_fn, opt, mesh)
        else:
            st = TrainState.create(replicate(params, mesh), opt,
                                   model_state=replicate(mstate, mesh))
            step = make_train_step(loss_fn, opt, mesh=mesh)
        if mode == "sync":
            _, own, _ = local_grads(loss_fn, mesh=mesh)(
                st.params, st.model_state, _batch(*batches[0], mesh), 0)
        losses = []
        for i, (x, y) in enumerate(batches):
            st, m = step(st, _batch(x, y, mesh))
            losses.append(m["loss"].item())
            if mode == "sync" and i == 0:
                out["sync_stats_exact"] = all(
                    torch.equal(st.model_state[k], v) for k, v in own.items())
        out[mode] = {"losses": losses, "params": _np(st.params),
                     "stats": _np(st.model_state)}
    return out


def simplecnn_invariants(mesh, sd: dict, x: np.ndarray, y: np.ndarray):
    """The reference's two invariants on ``SimpleCNN``: (1) the mean over
    the ranks of each rank's gradient equals the global batch's gradient;
    (2) one DP ``descent(1.0)`` step equals the one-device step on the
    global batch (and the replicas stay equal, which the parent checks
    across the ranks' results)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, collectives, local_grads, make_train_step,
        module_loss_fn)
    from fluxdistributed_tpu_torch.sharding import replicate

    model = _load(SimpleCNN(num_classes=10, device="cpu"), sd)
    loss_fn = module_loss_fn(model, logitcrossentropy)
    params = {k: p.detach() for k, p in model.named_parameters()}
    _, _, g_rank = local_grads(loss_fn, mesh=mesh)(
        params, {}, _batch(x, y, mesh), 0)
    _, _, g_global = local_grads(loss_fn)(params, {}, _batch(x, y), 0)
    opt = optim.descent(1.0)
    dp, _ = make_train_step(loss_fn, opt, mesh=mesh)(
        TrainState.create(replicate(params, mesh), opt), _batch(x, y, mesh))
    one, _ = make_train_step(loss_fn, opt)(TrainState.create(params, opt),
                                          _batch(x, y))
    return {"g_mean": _np(collectives.pmean(g_rank, mesh)),
            "g_global": _np(g_global), "dp": _np(dp.params),
            "one": _np(one.params)}


def global_moments(mesh, x: np.ndarray) -> tuple:
    """The synchronised BatchNorm statistics of this rank's rows of the
    NCHW batch ``x``: the global mean and biased variance."""
    from fluxdistributed_tpu_torch.models.norm import _global_moments
    from fluxdistributed_tpu_torch.sharding import shard_batch

    rows = shard_batch({"x": torch.from_numpy(x)}, mesh)["x"]
    mean, var = _global_moments(rows, mesh)
    return mean.numpy(), var.numpy()


def two_ranks(mesh, sd: dict, batches: list, lr: float, cnn_sd: dict,
              x: np.ndarray, y: np.ndarray, moments_x: np.ndarray) -> dict:
    """Every 2-rank check in one spawn: :func:`resnet_steps` in all
    modes, :func:`simplecnn_invariants` and :func:`global_moments`."""
    return {"steps": resnet_steps(mesh, sd, batches, lr,
                                  ("sync", "local", "zero1")),
            "invariants": simplecnn_invariants(mesh, cnn_sd, x, y),
            "moments": global_moments(mesh, moments_x)}
