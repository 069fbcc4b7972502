"""Rank bodies for the port's FSDP tests (``test_torch_port_fsdp.py``);
this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

NCLASS = 10
MIN_SIZE = 64  # the JAX test's: force sharding on a small model


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _cnn(sd: dict, num_classes: int = NCLASS):
    from fluxdistributed_tpu_torch.models import SimpleCNN

    model = SimpleCNN(num_classes=num_classes, device="cpu")
    if sd is not None:
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model


def _run(step, st, batch, steps):
    losses = []
    for _ in range(steps):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    return losses, st


def _fsdp(mesh, model, opt, min_size=MIN_SIZE):
    from fluxdistributed_tpu_torch.parallel import TrainState, fsdp

    params = {k: p.detach() for k, p in model.named_parameters()}
    st = TrainState.create(params, opt)
    specs = fsdp.fsdp_specs(st, mesh, min_size=min_size)
    return fsdp.shard_state(st, specs, mesh), specs


def fsdp_modes(mesh, sd: dict, x: np.ndarray, y: np.ndarray,
               ckpt_dir: str) -> dict:
    """SimpleCNN on the global batch ``(x, y)`` through the port's DP and
    FSDP steps: momentum, Adam's per-rank state, accum_steps=2 with the
    eval step, LARS, a checkpoint round trip, a restore onto a
    ``dp_fsdp`` layout, and the trainer's ``spmd="fsdp"``."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, fsdp, make_eval_step_fsdp, make_train_step,
        make_train_step_fsdp, module_loss_fn)
    from fluxdistributed_tpu_torch.sharding import replicate, shard_batch
    from fluxdistributed_tpu_torch.train.checkpoint import (load_checkpoint,
                                                            save_checkpoint)
    from fluxdistributed_tpu_torch.tree import leaves

    model = _cnn(sd)
    loss_fn = module_loss_fn(model, logitcrossentropy, mesh)
    batch = shard_batch({"image": torch.from_numpy(x),
                         "label": torch.from_numpy(y)}, mesh)
    params = {k: p.detach() for k, p in model.named_parameters()}
    out = {}

    def dp_run(opt, steps=3):
        st = TrainState.create(replicate(params, mesh), opt)
        losses, st = _run(make_train_step(loss_fn, opt, mesh=mesh), st,
                          batch, steps)
        return losses, _np(st.params)

    def fsdp_run(opt, steps=3, accum_steps=1):
        st, specs = _fsdp(mesh, model, opt)
        step = make_train_step_fsdp(loss_fn, opt, mesh, specs,
                                    accum_steps=accum_steps)
        losses, st = _run(step, st, batch, steps)
        return losses, st, specs

    opt = optim.momentum(0.05, 0.9)
    out["dp"] = dp_run(opt)
    losses, st, specs = fsdp_run(opt)
    out["fsdp"] = (losses, _np(fsdp.gather_state(st.params, specs.params,
                                                 mesh)))
    out["specs"] = {k: tuple(s) for k, s in specs.params.items()}
    out.update(_pairs(model, loss_fn, x, y, opt))

    # the memory: Adam's moments follow their params' blocks
    st, specs = _fsdp(mesh, model, optim.adam(1e-3))
    out["local_numel"] = {k: v.numel() for k, v in st.params.items()}
    out["moment_numel"] = {k: (m.numel(), v.numel())
                           for k, (m, v) in st.opt_state.items()}

    # accum_steps=2, then the eval step on the sharded state
    losses, st, specs = fsdp_run(opt, steps=1, accum_steps=2)
    ev_loss, ev = make_eval_step_fsdp(loss_fn, mesh, specs, topk=(1,))(
        st, batch)
    out["accum"] = (losses, _np(fsdp.gather_state(st.params, specs.params,
                                                  mesh)))
    out["eval"] = (ev_loss.item(), ev["top1"].item())

    # LARS: per-leaf norms summed over the blocks
    lars = optim.lars(0.1, weight_decay=1e-4)
    out["lars_dp"] = dp_run(lars)
    losses, st, specs = fsdp_run(lars)
    out["lars_fsdp"] = (losses, _np(fsdp.gather_state(st.params,
                                                      specs.params, mesh)))

    # checkpoint: saved at global shapes, restored onto the blocks
    losses, st, specs = fsdp_run(opt, steps=1)
    save_checkpoint(st, ckpt_dir, 1, mesh=mesh, specs=specs)
    back = load_checkpoint(ckpt_dir, st, mesh=mesh, specs=specs)
    mine = leaves(st.params) + leaves(st.opt_state)
    out["ckpt_equal"] = len(mine) == len(leaves(back.params)) * 2 and all(
        torch.equal(a, b) for a, b in zip(
            mine, leaves(back.params) + leaves(back.opt_state)))
    out["ckpt_params"] = _np(fsdp.gather_state(st.params, specs.params,
                                               mesh))
    step = make_train_step_fsdp(loss_fn, opt, mesh, specs)
    out["ckpt_next_loss"] = step(back, batch)[1]["loss"].item()
    out.update(_restore_onto_layout(model, opt, ckpt_dir))
    out.update(_trainer_fsdp(mesh))
    return out


def _pairs(model, loss_fn, x, y, opt) -> dict:
    """DP and FSDP over 2-rank groups (each pair of ranks of the world
    its own data axis, every pair training the same rows), where the
    sum of two values is the same in any order."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, fsdp, make_train_step, make_train_step_fsdp)
    from fluxdistributed_tpu_torch.sharding import replicate, shard_batch

    pair = make_mesh({"pair": 2, "data": 2}, device="cpu").sub("data")
    batch = shard_batch({"image": torch.from_numpy(x),
                         "label": torch.from_numpy(y)}, pair)
    params = {k: p.detach() for k, p in model.named_parameters()}
    st = TrainState.create(replicate(params, pair), opt)
    dl, st = _run(make_train_step(loss_fn, opt, mesh=pair), st, batch, 3)
    fst, specs = _fsdp(pair, model, opt)
    fl, fst = _run(make_train_step_fsdp(loss_fn, opt, pair, specs), fst,
                   batch, 3)
    return {"dp2": (dl, _np(st.params)),
            "fsdp2": (fl, _np(fsdp.gather_state(fst.params, specs.params,
                                                pair)))}


def _restore_onto_layout(model, opt, ckpt_dir: str) -> dict:
    """The FSDP checkpoint restored onto a ``dp_fsdp`` layout task (2 x 2):
    another layout of the same ranks."""
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.parallel.fsdp import gather_state
    from fluxdistributed_tpu_torch.train import prepare_training
    from fluxdistributed_tpu_torch.train.trainer import restore_training

    ds = SyntheticDataset(nsamples=64, nclasses=NCLASS, shape=(8, 8, 3))
    task = prepare_training(model, ds, opt, batch_size=16, cycles=1,
                            layout="dp_fsdp", device="cpu")
    restore_training(task, ckpt_dir)
    return {"layout_restored": _np(gather_state(
        task.state.params, task.specs.params, task.mesh)),
        "layout_restored_step": task.state.step,
        "layout_mesh": dict(task.mesh.shape)}


def _trainer_fsdp(mesh) -> dict:
    """``prepare_training(spmd="fsdp")`` with a val slice, then
    ``train`` and ``evaluate``, beside the DP trainer on the same run:
    the losses, whether a param leaf holds 1/N of its elements, the val
    rows a rank holds and both tasks' ``evaluate``."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.sharding import global_shape
    from fluxdistributed_tpu_torch.train import (NullLogger, evaluate,
                                                 prepare_training, train)

    ds = SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3))
    out = {}
    for spmd in ("fsdp", "jit"):
        task = prepare_training(_cnn(None, num_classes=4), ds,
                                optim.momentum(0.1, 0.9), mesh=mesh,
                                batch_size=16, cycles=30, spmd=spmd,
                                val_dataset=ds, val_samples=40,
                                device="cpu")
        host, _, _ = train(task, print_every=0, eval_every=10,
                           logger=NullLogger())
        out[f"evaluate_{spmd}"] = evaluate(task, ds, batch_size=16)
        if spmd == "fsdp":
            out.update(
                trainer_losses=list(task.losses),
                trainer_sharded=[
                    k for k, p in task.state.params.items()
                    if p.numel() * mesh.size == int(np.prod(global_shape(
                        p.shape, task.specs.params[k], mesh)))],
                trainer_host_shapes={k: tuple(v.shape)
                                     for k, v in host.items()},
                trainer_val_rows=task.val_batch["image"].shape[0])
    return out
