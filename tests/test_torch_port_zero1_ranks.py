"""Rank bodies for the port's N-rank tests (``test_torch_port_zero1.py``);
this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name.  So the module imports the port and numpy
only, never JAX: the ranks start fast, and the parent test compares
what they return with the JAX package.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# the port's lm_tiny at the tests' width (f32, dropout 0)
SMALL = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)
VOCAB = 64


def _model(state: dict):
    from fluxdistributed_tpu_torch.models import lm_tiny

    model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


def _np(params: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _run(step, state, batches, mesh):
    from fluxdistributed_tpu_torch.sharding import shard_batch

    losses = []
    for b in batches:
        state, m = step(state, shard_batch({"tokens": torch.from_numpy(b)},
                                           mesh))
        losses.append(m["loss"].item())
    return losses, state


def train_modes(mesh, state: dict, batches: list, lr: float) -> dict:
    """Adam from the same weights on the same global batches through
    the N-rank DP step, composable ZeRO-1 (both names), and fused
    ZeRO-1: losses, this rank's params and its optimizer-state sizes."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, make_train_step_zero1,
        make_train_step_zero1_fused, make_train_step_zero1_shardmap,
        per_device_state_bytes, zero1_fused_state, zero1_state)
    from fluxdistributed_tpu_torch.sharding import ensure_synced, replicate

    model = _model(state)
    loss_fn = lm_loss_fn(model)
    params = dict(model.named_parameters())
    opt = optim.adam(lr)
    out = {}

    st = TrainState.create(replicate(params, mesh), opt)
    losses, st = _run(make_train_step(loss_fn, opt, mesh=mesh), st, batches,
                      mesh)
    out["dp"] = (losses, _np(st.params))

    st = zero1_state(params, opt, mesh)
    opt_elems = sum(m.numel() + v.numel() for m, v in st.opt_state.values())
    losses, st = _run(make_train_step_zero1(loss_fn, opt, mesh), st,
                      batches, mesh)
    out["zero1"] = (losses, _np(st.params))
    out["zero1_opt_elems"] = opt_elems
    out["zero1_synced"] = ensure_synced(st.params, mesh)

    st = zero1_state(params, opt, mesh)
    losses, st = _run(make_train_step_zero1_shardmap(loss_fn, opt, mesh), st,
                      batches, mesh)
    out["zero1_shardmap"] = (losses, _np(st.params))

    st = zero1_fused_state(params, mesh)
    out["fused_mv_elems"] = (st.opt_state["m"].numel(),
                             st.opt_state["v"].numel())
    out["fused_mv_bytes"] = sum(per_device_state_bytes(st.opt_state).values())
    losses, st = _run(make_train_step_zero1_fused(loss_fn, mesh, lr=lr), st,
                      batches, mesh)
    out["fused"] = (losses, _np(st.params))
    out["fused_synced"] = ensure_synced(st.params, mesh)
    return out


def dp_invariants(mesh, state: dict, batch: np.ndarray) -> dict:
    """The reference's DP invariants on this rank: its rows' gradient,
    the rank-mean gradient (all-reduce / N), and params after three
    momentum steps (to compare bit for bit across ranks)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.parallel import (TrainState, local_grads,
                                                    make_train_step)
    from fluxdistributed_tpu_torch.parallel.collectives import pmean
    from fluxdistributed_tpu_torch.sharding import (ensure_synced, replicate,
                                                    shard_batch)

    model = _model(state)
    loss_fn = lm_loss_fn(model)
    params = replicate(dict(model.named_parameters()), mesh)
    rows = shard_batch({"tokens": torch.from_numpy(batch)}, mesh)
    _, _, grads = local_grads(loss_fn, mesh=mesh)(params, {}, rows, 0)
    mean = pmean(grads, mesh)
    opt = optim.momentum(0.05, 0.9)
    st = TrainState.create(params, opt)
    step = make_train_step(loss_fn, opt, mesh=mesh)
    for _ in range(3):
        st, _ = step(st, rows)
    return {"mean_grad": _np(mean), "params": _np(st.params),
            "synced": ensure_synced(st.params, mesh)}


def collectives_check(mesh) -> dict:
    """psum, pmean, reduce_scatter and all_gather on values that name
    the rank, with a ``None`` leaf."""
    from fluxdistributed_tpu_torch.parallel import collectives as c

    n, r = mesh.size, mesh.rank
    x = torch.arange(4 * n, dtype=torch.float32) + 100 * r
    tree = {"x": x, "frozen": None, "nested": {"s": torch.tensor(float(r))}}
    return {
        "psum": c.psum(tree, mesh)["x"].numpy(),
        "pmean": c.pmean(tree, mesh)["nested"]["s"].item(),
        "none_kept": c.psum(tree, mesh)["frozen"] is None,
        "reduce_scatter": c.reduce_scatter({"x": x}, mesh)["x"].numpy(),
        "all_gather": c.all_gather(x[:2].clone(), mesh).numpy(),
        "input_unchanged": bool(torch.equal(
            x, torch.arange(4 * n, dtype=torch.float32) + 100 * r)),
    }


def linear_loss(params, model_state, batch, train):
    """``sum(w * rows' sum of x) + sum(y)``: its gradient is the sum of
    the rows of x and its value (at w = 0) the sum of y, both exact for
    the division tests' dyadic inputs, so that a step's only rounding is
    its division by the number of ranks (or microbatches)."""
    loss = (params["w"] * batch["x"].sum(0)).sum() + batch["y"].sum()
    return loss, (model_state, None)


def division_steps(mesh, w: np.ndarray, x: np.ndarray, y: np.ndarray,
                   lr: float) -> dict:
    """One step of :func:`linear_loss` from ``w`` on the global rows
    ``x``, ``y`` through the N-rank DP step and composable ZeRO-1
    (descent at ``lr``), and fused ZeRO-1 (adam at ``lr``): losses,
    params, and the fused step's optimizer chunks of this rank."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, make_train_step_zero1,
        make_train_step_zero1_fused, zero1_fused_state, zero1_state)
    from fluxdistributed_tpu_torch.sharding import replicate, shard_batch

    params = {"w": torch.from_numpy(w)}
    batch = shard_batch({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                        mesh)
    opt = optim.descent(lr)
    out = {}
    st = TrainState.create(replicate(params, mesh), opt)
    st, m = make_train_step(linear_loss, opt, mesh=mesh)(st, batch)
    out["dp"] = (m["loss"].item(), _np(st.params))
    st = zero1_state(params, opt, mesh)
    st, m = make_train_step_zero1(linear_loss, opt, mesh)(st, batch)
    out["zero1"] = (m["loss"].item(), _np(st.params))
    st = zero1_fused_state(params, mesh)
    st, m = make_train_step_zero1_fused(linear_loss, mesh, lr=lr)(st, batch)
    out["fused"] = (m["loss"].item(), _np(st.params))
    out["fused_mv"] = (st.opt_state["m"].numpy().copy(),
                       st.opt_state["v"].numpy().copy())
    return out
