"""Rank bodies for the sequence-sharded ViT tests
(``test_torch_port_vit_ring.py``); this module holds no tests of its
own.  Each function runs inside one gloo rank of
``fluxdistributed_tpu_torch.mesh.run_ranks``: the port and numpy only,
never JAX.
"""

from __future__ import annotations

import numpy as np

MESHES = {"data_seq": {"data": 2, "seq": 2}, "seq": {"seq": 4}}
CORES = ("xla", "flash", "ulysses")


def _model(attn, flax: dict, image_size: int, class_token: bool = False):
    import torch

    from fluxdistributed_tpu_torch import models

    m = models.vit_tiny(num_classes=10, dtype=torch.float32, attn_fn=attn,
                        image_size=image_size, use_class_token=class_token,
                        device="cpu")
    return models.load_flax_vit(m, flax)


def _attn(mesh, core: str):
    from fluxdistributed_tpu_torch.parallel import (make_ring_attention,
                                                    make_ulysses_attention)

    batch = "data" if "data" in mesh.shape else None
    if core == "ulysses":
        return make_ulysses_attention(mesh, batch_axis=batch)
    return make_ring_attention(mesh, batch_axis=batch, impl=core,
                               block_q=8, block_k=8)


def vit_ring(mesh, flax: dict, x: np.ndarray, flax_cls: dict,
             x_cls: np.ndarray) -> dict:
    """The sequence-sharded ViT on each mesh and core: this rank's
    logits and the gradient of ``sum(logits ** 2)`` over the global
    batch (each rank's part is its rows' sum over ``S``; the parts'
    gradients summed over every rank); then the class-token readout on
    ``{data: 2, seq: 2}``."""
    import torch

    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel.collectives import psum

    out = {}
    for name, axes in MESHES.items():
        m = make_mesh(axes, device="cpu")
        s = m.axis_size("seq")
        for core in CORES:
            model = _model(_attn(m, core), flax, x.shape[1])
            logits = model(torch.tensor(x))
            part = (logits ** 2).sum() / s
            names = [k for k, _ in model.named_parameters()]
            grads = torch.autograd.grad(part, list(model.parameters()))
            out[(name, core)] = (
                logits.detach().numpy(),
                {k: psum(g, m).numpy() for k, g in zip(names, grads)})
    m = make_mesh(MESHES["data_seq"], device="cpu")
    model = _model(_attn(m, "xla"), flax_cls, x_cls.shape[1],
                   class_token=True)
    with torch.no_grad():
        out["class_token"] = model(torch.tensor(x_cls)).numpy()
    out["coord"] = m.coord
    return out
