"""Rank bodies for ``test_torch_port_model_selection.py``; this module
holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks`` (a fresh interpreter that
imports this module by name), so it imports the port and numpy only.
"""

from __future__ import annotations

REPLICAS, BPR, CYCLES, STEPS = 4, 4, 2, 2


def selection(mesh, init: dict, val: dict) -> dict:
    """Model selection of the port's MLP (192 -> 16 -> 4, momentum
    0.05) over the ranks of ``mesh``, each replica from its slice of the
    flax stacked ``init``: the val-loss history, the final params, and
    whether this rank's replicas differ before a selection and are equal
    after it."""
    import functools

    import torch

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import MLP, load_flax_simple
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_model_selection,
                                                 train_model_selection)

    factory = functools.partial(MLP, 8 * 8 * 3, (16, 4))
    task = prepare_model_selection(factory, optim.momentum(0.05, 0.9),
                                   mesh=mesh, replicas=REPLICAS,
                                   input_shape=(8, 8, 3))
    for i in range(len(task.params)):
        one = {k: {n: x[task.first + i] for n, x in leaf.items()}
               for k, leaf in init.items()}
        task.params[i] = {k: p.detach() for k, p in load_flax_simple(
            factory(device="cpu"), one).named_parameters()}
    ds = SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3))
    val = {k: torch.from_numpy(v) for k, v in val.items()}
    best, history = train_model_selection(
        task, ds, val, cycles=CYCLES, steps_per_cycle=STEPS,
        batch_size_per_replica=BPR, logger=NullLogger())
    equal = all(torch.equal(task.params[0][k], p[k])
                for p in task.params for k in p)
    return {"history": [h.tolist() for h in history],
            "params": {k: v.clone() for k, v in best.items()},
            "equal_after": equal, "first": task.first,
            "local": len(task.params)}
