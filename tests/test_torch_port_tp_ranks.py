"""Rank bodies for the port's tensor-parallel tests
(``test_torch_port_tp.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# the LMs' width (f32, dropout 0): 4 heads split over a model axis of 2
SMALL = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)
VOCAB = 64
LM_CASES = {"tied": {}, "gqa": {"num_kv_heads": 2},
            "swiglu": {"mlp": "swiglu"}, "untied": {"tie_embeddings": False}}
MIN_SIZE = 64  # the JAX hybrid test's
CLI_ARGS = ["--model", "lm_tiny", "--vocab", "64", "--seqlen", "16",
            "--batch-size", "8", "--cycles", "4", "--attn", "flash",
            "--opt", "adam", "--lr", "3e-3", "--print-every", "2",
            "--eval-every", "2", "--device", "cpu"]


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _load(model, sd: dict):
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model


def _tp_run(mm, model, loss_fn, opt, specs: dict, batch: dict, steps: int):
    """``steps`` tensor-parallel steps from the model's weights: this
    rank's blocks before the first, the losses and the global params
    after the last."""
    from fluxdistributed_tpu_torch.parallel import TrainState, fsdp, tp

    params = {k: p.detach() for k, p in model.named_parameters()}
    gst = TrainState.create(params, opt)
    st = tp.shard_state(gst, mm, specs)
    blocks = _np(st.params)
    tp.tensor_parallel(model, mm, specs)
    step = tp.make_train_step_tp(loss_fn, opt, mm, specs, gst)
    losses = []
    for _ in range(steps):
        st, m = step(st, batch)
        losses.append(m["loss"].item())
    return blocks, (losses, _np(fsdp.gather_state(st.params, specs, mm)))


def tp_modes(mesh, vit_sd: dict, vit_x, vit_y, lm_sds: dict,
             toks: np.ndarray) -> dict:
    """On ``{data: 2, model: 2}``: vit_tiny TP (momentum, 2 steps), the
    LM variants TP and the hybrid (momentum, 3 steps), the trainer's
    ``spmd="fsdp_tp"`` and the CLI's ``--spmd fsdp_tp --tp 2`` beside
    ``train()`` with the same arguments."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny, vit_tiny
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import fsdp, module_loss_fn, tp
    from fluxdistributed_tpu_torch.sharding import shard_batch

    mm = make_mesh({"data": 2, "model": 2}, device="cpu")
    out = {"coords": mm.coord}
    vit = _load(vit_tiny(num_classes=10, dtype=torch.float32, device="cpu",
                         image_size=32), vit_sd)
    specs = tp.param_specs(dict(vit.named_parameters()), tp.vit_tp_rules())
    batch = shard_batch({"image": torch.from_numpy(vit_x),
                         "label": torch.from_numpy(vit_y)}, mm, axis="data")
    out["vit_blocks"], out["vit"] = _tp_run(
        mm, vit, module_loss_fn(vit, logitcrossentropy),
        optim.momentum(0.1, 0.9), specs, batch, 2)
    out["vit_heads"] = vit.encoder.layers.encoder_layer_0.self_attention\
        .num_heads

    tok = shard_batch({"tokens": torch.from_numpy(toks)}, mm, axis="data")
    for name, kw in LM_CASES.items():
        lm = _load(lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                           **SMALL, **kw), lm_sds[name])
        rules = tp.lm_tp_rules(shard_vocab=name != "untied")
        specs = tp.param_specs(dict(lm.named_parameters()), rules)
        out[f"{name}_blocks"], out[name] = _tp_run(
            mm, lm, lm_loss_fn(lm), optim.momentum(0.05, 0.9), specs, tok, 3)

    lm = _load(lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                       **SMALL), lm_sds["tied"])
    specs = fsdp.hybrid_fsdp_tp_specs(dict(lm.named_parameters()), mm,
                                      tp.lm_tp_rules(), min_size=MIN_SIZE)
    out["hybrid_specs"] = {k: repr(s) for k, s in specs.items()}
    out["hybrid_blocks"], out["hybrid"] = _tp_run(
        mm, lm, lm_loss_fn(lm), optim.momentum(0.05, 0.9), specs, tok, 3)
    out.update(_trainer(mm))
    out.update(_cli_and_train(mm))
    return out


def _trainer(mm) -> dict:
    """``prepare_training(spmd="fsdp_tp")`` then ``train``
    (``tests/test_fsdp.py:235``)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_training, train)

    lm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL)
    task = prepare_training(lm, SyntheticTextDataset(vocab=32, seqlen=32),
                            optim.adam(3e-3), mesh=mm, batch_size=16,
                            cycles=30, loss_fn=lm_loss_fn(lm), topk=(),
                            spmd="fsdp_tp", device="cpu")
    emb = task.state.params["embed.weight"]
    host, _, _ = train(task, print_every=0, eval_every=0, topk=(),
                       logger=NullLogger())
    return {"trainer_losses": list(task.losses),
            "trainer_embed_spec": repr(task.specs.params["embed.weight"]),
            "trainer_embed_local": tuple(emb.shape),
            "trainer_embed_global": tuple(host["embed.weight"].shape),
            "trainer_model_embed": tuple(lm.embed.weight.shape)}


def _cli_and_train(mm) -> dict:
    """The CLI's ``--spmd fsdp_tp --tp 2`` on the world's ranks, and
    ``prepare_training`` + ``train`` with the same arguments."""
    import importlib

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_training, train)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    task = cli.run(CLI_ARGS + ["--spmd", "fsdp_tp", "--tp", "2"])
    lm = lm_tiny(vocab=64, device="cpu", seed=0,
                 attn_fn=attention_core("flash", 128))
    ref = prepare_training(lm, SyntheticTextDataset(vocab=64, seqlen=16),
                           optim.adam(3e-3), loss_fn=lm_loss_fn(lm),
                           batch_size=8, cycles=4, spmd="fsdp_tp", mesh=mm,
                           device="cpu")
    train(ref, print_every=2, eval_every=2, topk=(), logger=NullLogger())
    return {"cli_losses": list(task.losses), "cli_mesh": task.mesh.shape,
            "train_losses": list(ref.losses)}
