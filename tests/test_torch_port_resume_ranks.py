"""Rank bodies for ``test_torch_port_resume.py``; this module holds no
tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks`` (a fresh interpreter that
imports this module by name), so it imports the port and numpy only.
The runs train the port's MLP (192 -> 10 -> 10, adam) on synthetic 8x8
images: the bias of 10 pads to 10 at two ranks and to 12 at three, so
an elastic resume has to re-split ZeRO-1's flat buffers.
"""

from __future__ import annotations

import torch

CYCLES = 8
LR = 1e-3


def _task(mesh, *, zero1=False, spc=1, batch=8, cycles=CYCLES, opt=None):
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import MLP
    from fluxdistributed_tpu_torch.train import prepare_training

    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    return prepare_training(
        MLP(8 * 8 * 3, (10, 10), device="cpu", seed=0), ds,
        opt or optim.adam(LR),
        mesh=mesh, zero1=zero1, batch_size=batch, cycles=cycles, topk=(),
        steps_per_call=spc, device="cpu")


def _leaves(state):
    from fluxdistributed_tpu_torch.tree import leaves

    return leaves((state.params, state.opt_state, state.model_state))


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _preempt(mesh, directory, at, **kw):
    """A run SIGTERMed (by each rank's own fault plan) at item ``at``:
    its task, checkpointed with the RESUME manifest in ``directory``."""
    from fluxdistributed_tpu_torch import faults
    from fluxdistributed_tpu_torch.train import NullLogger, train

    task = _task(mesh, **kw)
    faults.install_plan(faults.FaultPlan().sigterm_at_step(at))
    try:
        train(task, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=directory, checkpoint_every=0,
              handle_signals=True)
        raise AssertionError("the run was not preempted")
    except faults.Preempted:
        pass
    finally:
        faults.clear_plan()
    return task


def _preempted_then_resumed(mesh, directory, at, **kw):
    """:func:`_preempt`, then a fresh task resumed from the checkpoint
    and trained to the end: (head losses, tail losses, the manifest, the
    final task)."""
    from fluxdistributed_tpu_torch.train import (NullLogger, resume_training,
                                                 train)

    head = list(_preempt(mesh, directory, at, **kw).losses)
    task = _task(mesh, **kw)
    manifest = resume_training(task, directory)
    train(task, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=directory, checkpoint_every=0)
    return head, list(task.losses), manifest, task


def _uninterrupted(mesh, **kw):
    from fluxdistributed_tpu_torch.train import NullLogger, train

    task = _task(mesh, **kw)
    train(task, print_every=0, eval_every=0, logger=NullLogger())
    return task


def _fused(mesh, steps, state=None, start=0, batch=8):
    """Fused ZeRO-1 adam steps ``start .. steps - 1`` on the loader's
    rows of this rank; returns (state, losses)."""
    from fluxdistributed_tpu_torch.data import PrefetchLoader, SyntheticDataset
    from fluxdistributed_tpu_torch.models import MLP
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        make_train_step_zero1_fused, module_loss_fn, zero1_fused_state)

    model = MLP(8 * 8 * 3, (10, 10), device="cpu", seed=0)
    if state is None:
        state = zero1_fused_state(dict(model.named_parameters()), mesh)
    step = make_train_step_zero1_fused(
        module_loss_fn(model, logitcrossentropy, mesh), mesh, lr=LR)
    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    losses = []
    for b in PrefetchLoader(ds, batch, cycles=steps, start=start,
                            device="cpu", mesh=mesh):
        state, m = step(state, b)
        losses.append(m["loss"].item())
    return state, losses


def _fresh_fused(mesh):
    from fluxdistributed_tpu_torch.models import MLP
    from fluxdistributed_tpu_torch.parallel import zero1_fused_state

    model = MLP(8 * 8 * 3, (10, 10), device="cpu", seed=0)
    return zero1_fused_state(dict(model.named_parameters()), mesh)


def two_ranks(mesh, root: str) -> dict:
    """At two ranks: DP and composable ZeRO-1 at steps_per_call 1 and 2
    preempted and resumed against their uninterrupted runs, fused ZeRO-1
    saved at step 4 and resumed; then the checkpoints the three-rank
    elastic resume reads (ZeRO-1 preempted at item 3, fused at step 3,
    batch 12)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.parallel import zero1_ema_params
    from fluxdistributed_tpu_torch.train import (NullLogger, load_checkpoint,
                                                 save_checkpoint, train)

    out = {}
    for zero1 in (False, True):
        for spc in (1, 2):
            name = f"{'zero1' if zero1 else 'dp'}_k{spc}"
            base = _uninterrupted(mesh, zero1=zero1, spc=spc)
            head, tail, manifest, task = _preempted_then_resumed(
                mesh, f"{root}/{name}", 4 // spc, zero1=zero1, spc=spc)
            out[name] = {"base": list(base.losses), "head": head,
                         "tail": tail, "manifest": manifest,
                         "state_equal": _equal(task.state, base.state),
                         "step": task.state.step}
    # the EMA of with_ema(adam) gathered from the ZeRO-1 shards equals
    # the replicated DP run's
    ema = {}
    for zero1 in (False, True):
        t = _task(mesh, zero1=zero1, cycles=2,
                  opt=optim.with_ema(optim.adam(LR), 0.9))
        train(t, print_every=0, eval_every=0, logger=NullLogger())
        ema[zero1] = (zero1_ema_params(t.state, mesh) if zero1
                      else optim.ema_params(t.state.opt_state))
    out["ema_equal"] = all(torch.equal(ema[True][k], ema[False][k])
                           for k in ema[False])
    out["ema_shapes"] = {k: tuple(v.shape) for k, v in ema[True].items()}
    base, base_losses = _fused(mesh, CYCLES)
    st, head = _fused(mesh, 4)
    save_checkpoint(st, f"{root}/fused", st.step, mesh=mesh, zero1=True)
    st = load_checkpoint(f"{root}/fused", _fresh_fused(mesh), mesh=mesh)
    st, tail = _fused(mesh, CYCLES, state=st, start=4)
    out["fused"] = {"base": base_losses, "head": head, "tail": tail,
                    "state_equal": _equal(st, base), "step": st.step}
    # a blocking save that refuses an existing step raises on every rank
    try:
        save_checkpoint(st, f"{root}/fused", 4, overwrite=False, mesh=mesh,
                        zero1=True)
        out["refused"] = False
    except FileExistsError:
        out["refused"] = True
    # the checkpoints the elastic resume at three ranks reads
    out["elastic_head"] = list(_preempt(mesh, f"{root}/elastic_zero1", 3,
                                        zero1=True, batch=12).losses)
    out["elastic_base"] = list(_uninterrupted(mesh, zero1=True,
                                              batch=12).losses)
    fbase, fbase_losses = _fused(mesh, CYCLES, batch=12)
    st, fhead = _fused(mesh, 3, batch=12)
    save_checkpoint(st, f"{root}/elastic_fused", st.step, mesh=mesh,
                    zero1=True)
    out["fused_elastic_head"] = fhead
    out["fused_elastic_base"] = fbase_losses
    out["fused_elastic_base_params"] = {
        k: v.numpy().copy() for k, v in fbase.params.items()}
    return out


def three_ranks(mesh, root: str) -> dict:
    """At three ranks: resume the two-rank ZeRO-1 run (its manifest says
    two ranks, so the elastic path re-splits the buffers) and the fused
    checkpoint; the gathered optimizer state must equal the saved one
    over the real entries, with zero pads."""
    from fluxdistributed_tpu_torch.parallel import collectives, packed_size
    from fluxdistributed_tpu_torch.train import (NullLogger, load_checkpoint,
                                                 load_checkpoint_elastic,
                                                 resume_training, train)

    out = {}
    d = f"{root}/elastic_zero1"
    raw = load_checkpoint(d)
    task = _task(mesh, zero1=True, batch=12)
    manifest = resume_training(task, d)
    gathered = collectives.all_gather(task.state.opt_state, mesh)
    ok = True
    for k, p in task.state.params.items():
        n = p.numel()
        for g, s in zip(gathered[k], raw["opt_state"][k]):
            ok &= torch.equal(g[:n], s[:n]) and not g[n:].any()
            ok &= g.shape[0] == -(-n // 3) * 3
    out["zero1_restored_equal"] = ok
    out["zero1_manifest"] = manifest
    out["zero1_start"] = task.loader.start
    train(task, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=d, checkpoint_every=0)
    out["zero1_tail"] = list(task.losses)
    try:
        load_checkpoint(f"{root}/elastic_fused", _fresh_fused(mesh),
                        mesh=mesh)
        out["fused_plain_load_refused"] = False
    except ValueError:
        out["fused_plain_load_refused"] = True
    st = load_checkpoint_elastic(f"{root}/elastic_fused", _fresh_fused(mesh),
                                 mesh=mesh)
    raw = load_checkpoint(f"{root}/elastic_fused")
    real = sum(p.numel() for p in st.params.values())
    ok = st.step == 3
    for k in ("m", "v"):
        g = collectives.all_gather(st.opt_state[k], mesh)
        ok &= g.shape[0] == packed_size(st.params, 3)
        ok &= torch.equal(g[:real], raw["opt_state"][k][:real])
        ok &= not g[real:].any()
    out["fused_restored_equal"] = ok
    st, tail = _fused(mesh, CYCLES, state=st, start=3, batch=12)
    out["fused_tail"] = tail
    out["fused_params"] = {k: v.numpy().copy() for k, v in st.params.items()}
    return out
