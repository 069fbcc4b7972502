"""Rank bodies for the FSDP gather-schedule tests
(``test_torch_port_fsdp_schedule.py``); this module holds no tests of
its own.  Each function runs inside one gloo rank of
``fluxdistributed_tpu_torch.mesh.run_ranks``: the port and numpy only,
never JAX.

The reference is today's step held here as a plain copy: the
gather-everything ``view`` of the FSDP plan before the schedule, every
sharded leaf gathered once at the start of the loss call and kept
through the step.
"""

from __future__ import annotations

import numpy as np

STEPS = 3
MIN_SIZE = 64  # shard the small models' norms and biases too


def _gather_all_loss(loss_fn, plan):
    """The FSDP loss before the schedule: every leaf gathered through
    ``AllGatherShard`` up front (the former ``_Plan.view``)."""
    from fluxdistributed_tpu_torch.parallel import dp
    from fluxdistributed_tpu_torch.parallel.fsdp import AllGatherShard
    from fluxdistributed_tpu_torch.parallel.zero1 import restore_layout

    def view(params):
        out = {}
        for k, p in params.items():
            x = p
            for d, axes in plan.gathers.get(k, ()):
                sub = plan.sub(axes)
                x = AllGatherShard.apply(x, d, sub.group, sub.size)
            out[k] = restore_layout(x, p) if x is not p else p
        return out

    with_rng = dp._accepts_rng(loss_fn)

    def fn(params, model_state, batch, train, rng=None):
        kw = {"rng": rng} if with_rng else {}
        return loss_fn(view(params), model_state, batch, train, **kw)

    fn.global_model_state = getattr(loss_fn, "global_model_state", False)
    return fn


def _task(name: str, spmd: str, mesh):
    """``prepare_training`` of ``name`` under ``spmd``, the FSDP leaf
    threshold at ``MIN_SIZE``."""
    import torch

    from fluxdistributed_tpu_torch import data, models, optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.parallel import fsdp
    from fluxdistributed_tpu_torch.train import trainer

    if name == "lm_tiny":
        model = models.lm_tiny(vocab=64, device="cpu", dtype=torch.float32)
        ds = data.SyntheticTextDataset(vocab=64, seqlen=32)
        kw = {"loss_fn": lm_loss_fn(model)}
        opt = optim.adam(1e-3)
    else:
        model = models.resnet18(num_classes=10, device="cpu",
                                dtype=torch.float32)
        ds = data.SyntheticDataset(nsamples=64, nclasses=10,
                                   shape=(32, 32, 3))
        kw = {}
        opt = optim.momentum(0.05)
    spec = fsdp.fsdp_leaf_spec
    fsdp.fsdp_leaf_spec = (
        lambda shape, axis="data", n=1, min_size=MIN_SIZE, base=None:
        spec(shape, axis, n, MIN_SIZE, base))
    try:
        return model, trainer.prepare_training(
            model, ds, opt, batch_size=8, cycles=STEPS, spmd=spmd,
            mesh=mesh, device="cpu", **kw)
    finally:
        fsdp.fsdp_leaf_spec = spec


def _steps(task):
    """Three steps; the losses and each step's peak of live gathered
    bytes."""
    plan = task.step_fn.gather_plan
    st, losses, peaks = task.state, [], []
    for _, batch in zip(range(STEPS), task.loader):
        plan.live.peak = plan.live.now
        st, m = task.step_fn(st, batch)
        losses.append(m["loss"])
        peaks.append(plan.live.peak)
    return st, losses, peaks


def _gathered_bytes(k, shard, specs, mesh) -> int:
    """Leaf ``k``'s gathered bytes (its non-model entries gathered), 0
    for a leaf that is not gathered."""
    from fluxdistributed_tpu_torch.sharding import entry_axes

    axes = [a for e in specs.params[k] for a in entry_axes(e)
            if a != "model"]
    n = 1
    for a in axes:
        n *= mesh.axis_size(a)
    return shard.numel() * n * shard.element_size() if axes else 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None and hasattr(tree, "shape"):
        yield tree


def schedule(mesh, cases: list) -> dict:
    """For each ``(model, spmd)``: the scheduled step and
    today's gather-all step, 3 steps each from one seed; whether their
    losses, final params and optimizer state are equal, and the
    scheduled step's peaks of live gathered bytes with the gathered
    bytes of its largest block, of the leaves outside the blocks and of
    all leaves."""
    import torch

    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import fsdp

    out = {}
    for name, spmd in cases:
        m = (make_mesh({"data": 2, "model": 2}, device="cpu")
             if spmd == "fsdp_tp" else mesh)
        model, task = _task(name, spmd, m)
        st, losses, peaks = _steps(task)
        keep = fsdp._gathered_loss
        fsdp._gathered_loss = _gather_all_loss
        try:
            _, ref_task = _task(name, spmd, m)
            ref, ref_losses, _ = _steps(ref_task)
        finally:
            fsdp._gathered_loss = keep
        equal = all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
        equal &= all(torch.equal(st.params[k], ref.params[k])
                     for k in st.params)
        equal &= all(torch.equal(a, b) for a, b in zip(
            _leaves(st.opt_state), _leaves(ref.opt_state)))
        size = {k: _gathered_bytes(k, p, task.specs, m)
                for k, p in st.params.items()}
        plan = task.step_fn.gather_plan
        inside = {k for b in plan.order for _, _, k in plan.blocks[b][1]}
        out[(name, spmd)] = {
            "equal": bool(equal),
            "losses": np.array([float(v) for v in losses]),
            "peaks": peaks,
            "blocks": len(plan.order),
            "block": max(sum(size[k] for _, _, k in plan.blocks[b][1])
                         for b in plan.order),
            "rest": sum(v for k, v in size.items() if k not in inside),
            "all": sum(size.values())}
    return out
