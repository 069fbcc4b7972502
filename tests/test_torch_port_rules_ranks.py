"""Rank bodies for the port's rules and layout tests
(``test_torch_port_rules.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import torch

CNN = dict(num_classes=4, features=8)
LM = dict(vocab=64, dim=64, depth=2, num_heads=4, mlp_dim=128)
CLI_ARGS = ["--model", "SimpleCNN", "--image-size", "8", "--num-classes",
            "4", "--batch-size", "16", "--cycles", "3", "--opt", "adam",
            "--lr", "1e-3", "--eval-every", "0", "--print-every", "0",
            "--device", "cpu", "--layout", "dp_fsdp"]


def _losses(task) -> list:
    out, state = [], task.state
    for batch in task.loader:
        state, m = task.step_fn(state, batch)
        out.append(m["loss"].item())
    return out


def layout_modes(mesh, cnn_sd: dict, lm_sd: dict) -> dict:
    """``prepare_training(layout=...)`` at 4 ranks: SimpleCNN under
    ``dp_fsdp`` (2 x 2) and an f32 LM under ``fsdp_tp`` (fsdp 2 x tp 2),
    3 steps each from the given weights; then the CLI's ``--layout
    dp_fsdp`` beside ``train()`` with the same arguments."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import (SyntheticDataset,
                                                SyntheticTextDataset)
    from fluxdistributed_tpu_torch.models import (SimpleCNN, TransformerLM,
                                                  lm_loss_fn)
    from fluxdistributed_tpu_torch.train import prepare_training

    out = {}
    cnn = SimpleCNN(**CNN, device="cpu")
    cnn.load_state_dict({k: torch.tensor(v) for k, v in cnn_sd.items()})
    task = prepare_training(
        cnn, SyntheticDataset(nsamples=64, nclasses=4, shape=(8, 8, 3)),
        optim.adam(1e-3), batch_size=16, cycles=3, seed=0,
        layout="dp_fsdp", device="cpu")
    out["dp_fsdp"] = _losses(task)
    out["dp_fsdp_mesh"] = task.mesh.shape
    out["dp_fsdp_specs"] = {k: repr(s) for k, s in task.specs.params.items()}

    lm = TransformerLM(**LM, dtype=torch.float32, device="cpu")
    lm.load_state_dict({k: torch.tensor(v) for k, v in lm_sd.items()})
    task = prepare_training(
        lm, SyntheticTextDataset(vocab=LM["vocab"], seqlen=16),
        optim.adam(1e-3), loss_fn=lm_loss_fn(lm), topk=(), batch_size=8,
        cycles=3, seed=0, layout="fsdp_tp", device="cpu")
    out["fsdp_tp"] = _losses(task)
    out["fsdp_tp_mesh"] = task.mesh.shape
    out["fsdp_tp_heads"] = lm.blocks[0].attn.num_heads
    out["fsdp_tp_specs"] = {k: repr(s) for k, s in task.specs.params.items()}
    out.update(_cli_and_train())
    return out


def _cli_and_train() -> dict:
    import importlib

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_training, train)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    task = cli.run(CLI_ARGS)
    ds = SyntheticDataset(nsamples=1024, nclasses=4, shape=(8, 8, 3))
    ref = prepare_training(SimpleCNN(num_classes=4, device="cpu", seed=0),
                           ds, optim.adam(1e-3), batch_size=16, cycles=3,
                           layout="dp_fsdp", device="cpu")
    train(ref, print_every=0, eval_every=0, logger=NullLogger())
    return {"cli_losses": list(task.losses),
            "train_losses": list(ref.losses)}
