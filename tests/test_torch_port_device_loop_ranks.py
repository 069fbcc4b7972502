"""Rank bodies of ``tests/test_torch_port_device_loop.py``: each runs in
a spawned gloo rank (``mesh.run_ranks``), so this module imports no
JAX."""

import numpy as np
import torch

VOCAB, SEQ, BATCH, STEPS = 64, 16, 8, 4


def zero1_device_loop(mesh):
    """Composable ZeRO-1 (adam, dropout 0.1) on this rank, ``STEPS``
    steps fed by the chunked loader, at one step a call and at two:
    ``{k: (losses, params, opt_state leaves)}``, plus the loader's
    stacked items against its unchunked ones."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import (PrefetchLoader,
                                                SyntheticTextDataset)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.parallel import (make_train_step_zero1,
                                                    zero1_state)

    ds = SyntheticTextDataset(vocab=VOCAB, seqlen=SEQ)
    out = {}
    for k in (1, 2):
        model = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                        dropout=0.1, depth=2, dim=64, num_heads=4,
                        mlp_dim=128, seed=0)
        opt = optim.adam(3e-3)
        state = zero1_state(dict(model.named_parameters()), opt, mesh)
        step = make_train_step_zero1(lm_loss_fn(model), opt, mesh, seed=3,
                                     steps_per_call=k)
        loader = PrefetchLoader(ds, BATCH, cycles=STEPS, chunk=k, mesh=mesh,
                                device="cpu")
        losses = []
        for batch in loader:
            state, m = step(state, batch)
            losses.append(m["loss"].reshape(-1))
        opt_leaves = [t for pair in state.opt_state.values() for t in pair]
        out[k] = (torch.cat(losses).tolist(), dict(state.params), opt_leaves,
                  state.step)
    flat = list(PrefetchLoader(ds, BATCH, cycles=STEPS, mesh=mesh,
                               device="cpu"))
    stacked = list(PrefetchLoader(ds, BATCH, cycles=STEPS, chunk=2,
                                  mesh=mesh, device="cpu"))
    out["loader_equal"] = all(
        torch.equal(item["tokens"][j], flat[2 * c + j]["tokens"])
        for c, item in enumerate(stacked) for j in range(2))
    out["rows"] = tuple(stacked[0]["tokens"].shape)
    return out
