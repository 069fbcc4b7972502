"""Rank bodies for ``test_torch_port_guard.py``; this module holds no
tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks`` (a fresh interpreter that
imports this module by name), so it imports the port and numpy only.
The runs train the port's MLP (192 -> 10 -> 10) on synthetic 8x8
images with ZeRO-1 and the guard.
"""

from __future__ import annotations

CYCLES = 10
ROLLBACK_CFG = dict(rollback_after=3, anomaly_window=8)


def task(mesh, init=None, opt=None, cycles=CYCLES):
    """The guarded ZeRO-1 MLP task on ``mesh`` (None: a one-rank group
    of this process), weights from the flax ``init`` when given."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import MLP, load_flax_simple
    from fluxdistributed_tpu_torch.train import prepare_training

    model = MLP(8 * 8 * 3, (10, 10), device="cpu", seed=0)
    if init is not None:
        load_flax_simple(model, init)
    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(8, 8, 3))
    return prepare_training(model, ds, opt or optim.adam(1e-3), mesh=mesh,
                            zero1=True, batch_size=8, cycles=cycles,
                            topk=(), guard=True, device="cpu")


def record(t) -> list:
    """Every stepped item's loss (discarded ones too), as the JAX guard
    tests record them."""
    out, orig = [], t.step_fn

    def wrapped(state, batch):
        new, m = orig(state, batch)
        out.append(float(m["loss"]))
        return new, m

    t.step_fn = wrapped
    return out


def two_ranks(mesh, init: dict, directory: str) -> dict:
    """(a) the guarded ZeRO-1 run (momentum 0.1, from ``init``) under a
    ``train.grad`` inf at item 2; (b) the first half of the elastic
    test: a guarded adam run SIGTERMed at item 6, checkpointing every 2
    items into ``directory``."""
    from fluxdistributed_tpu_torch import faults, optim
    from fluxdistributed_tpu_torch.train import GuardConfig, NullLogger, train

    t = task(mesh, init, optim.momentum(0.1, 0.9), cycles=8)
    stepped = record(t)
    faults.install_plan(faults.FaultPlan.from_spec(
        {"fail": [{"site": "train.grad", "at": 2, "action": "inf"}]}))
    try:
        params, _, t = train(t, print_every=0, eval_every=0,
                             logger=NullLogger(), guard=GuardConfig())
    finally:
        faults.clear_plan()
    out = {"stepped": stepped, "losses": list(t.losses),
           "quarantined": list(t.quarantined_items),
           "params": {k: v.clone() for k, v in params.items()}}

    t = task(mesh)
    faults.install_plan(faults.FaultPlan().sigterm_at_step(6))
    try:
        train(t, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=directory, checkpoint_every=2,
              handle_signals=True, guard=GuardConfig(**ROLLBACK_CFG))
        out["preempted"] = False
    except faults.Preempted:
        out["preempted"] = True
    finally:
        faults.clear_plan()
    out["head"] = list(t.losses)
    return out
