"""Rank bodies for the collective-ledger tests
(``test_torch_port_comms.py``); this module holds no tests of its own.
Each function runs inside one gloo rank of
``fluxdistributed_tpu_torch.mesh.run_ranks`` (the port and numpy only,
never JAX), or in the test process on a fake world of the same ranks:
:func:`step_inputs` builds one step either way.
"""

from __future__ import annotations

import numpy as np

ROWS = 8  # the global batch


def lm(device):
    """An LM whose embedding and block matrices FSDP shards (>= 2048
    elements each)."""
    import torch

    from fluxdistributed_tpu_torch.models import TransformerLM

    return TransformerLM(vocab=64, dim=64, depth=2, num_heads=2, mlp_dim=128,
                         dtype=torch.float32, device=device, seed=0)


def step_inputs(mesh, model, spmd: str, make_batch):
    """``(step_fn, state, batch)`` of ``prepare_training`` on ``mesh``;
    ``make_batch(arrays, shards)`` turns this rank's rows of the global
    batch (numpy) into tensors."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.data.loader import batch_to_dict
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.train import prepare_training

    ds = SyntheticTextDataset(vocab=64, seqlen=16)
    task = prepare_training(model, ds, optim.adam(1e-3), mesh=mesh,
                            batch_size=ROWS, cycles=1, device="cpu",
                            spmd=spmd, loss_fn=lm_loss_fn(model), topk=())
    arrays = batch_to_dict(ds.batch(np.random.default_rng(0), ROWS))
    return task.step_fn, task.state, make_batch(arrays, mesh.size)


def recorded_ledgers(mesh, spmds):
    """This rank's ledger of one steady step (after a first call, which
    learns FSDP's gather order) of each ``spmd``'s real step on real
    gloo ranks: ``{spmd: entries}``."""
    import torch

    from fluxdistributed_tpu_torch.obs import comms

    def real_batch(arrays, shards):
        i = mesh.rank
        return {k: torch.from_numpy(np.ascontiguousarray(
            v[i * len(v) // shards:(i + 1) * len(v) // shards]))
            for k, v in arrays.items()}

    out = {}
    for spmd in spmds:
        fn, state, batch = step_inputs(mesh, lm("cpu"), spmd, real_batch)
        fn(state, batch)
        with comms.recording(mesh) as rec:
            fn(state, batch)
        out[spmd] = rec.entries()
    return out
