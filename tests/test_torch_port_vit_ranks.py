"""Rank bodies for the port's N-rank ViT and ConvNeXt tests
(``test_torch_port_vit.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name.  So the module imports the port and numpy
only, never JAX; the parent test compares what the ranks return with
the JAX package.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _steps(mesh, model, opt, batches: list) -> dict:
    """DP steps of ``model`` over the global ``batches`` (``(images,
    one-hot labels)``): the losses and this rank's params."""
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (TrainState,
                                                    make_train_step,
                                                    module_loss_fn)
    from fluxdistributed_tpu_torch.sharding import replicate, shard_batch

    params = {k: p.detach() for k, p in model.named_parameters()}
    st = TrainState.create(replicate(params, mesh), opt)
    step = make_train_step(module_loss_fn(model, logitcrossentropy, mesh),
                           opt, mesh=mesh)
    losses = []
    for x, y in batches:
        b = shard_batch({"image": torch.from_numpy(x),
                         "label": torch.from_numpy(y)}, mesh)
        st, m = step(st, b)
        losses.append(m["loss"].item())
    return {"losses": losses,
            "params": {k: v.numpy().copy() for k, v in st.params.items()}}


def vit_and_convnext_steps(mesh, vit_sd: dict, convnext_sd: dict,
                           batches: list, lr: float) -> dict:
    """The f32 ``vit_tiny`` (32², mean-pooled) under adamw and the f32
    ``convnext_test`` under lars, each from its weights, over the same
    global batches."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import convnext_test, vit_tiny

    out = {}
    for name, factory, sd, opt in (
            ("vit", vit_tiny, vit_sd, optim.adamw(lr)),
            ("convnext", convnext_test, convnext_sd, optim.lars(lr))):
        kw = {"image_size": 32} if name == "vit" else {}
        model = factory(num_classes=10, dtype=torch.float32, device="cpu",
                        **kw)
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
        out[name] = _steps(mesh, model, opt, batches)
    return out
