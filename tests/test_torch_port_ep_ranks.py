"""Rank bodies for the port's expert-parallel tests
(``test_torch_port_ep.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

D = 8  # token width of the moe_apply cases
# name: moe_apply keywords; every case holds 2 experts a rank
MOE_CASES = {
    "top1": dict(capacity_factor=2.0),
    "top2": dict(capacity_factor=1.25, top_k=2),
    "expert_choice": dict(capacity=3, routing="expert_choice"),
    "pad_top2": dict(capacity=8, top_k=2, pad_tokens=True),
    "drop": dict(capacity=1),
}
MOE_MESHES = {"expert4": {"expert": 4}, "data2_expert2": {"data": 2,
                                                           "expert": 2}}
T_MOE, T_PAD = 32, 30  # global tokens; the pad case's do not split in 4
AUX_W = 0.5  # the aux term's weight in the gradient check's loss
# the MoE LM of the trainer tests (f32): every 2nd block routed over 4
# experts, 2 a rank on an expert axis of 2
LM = dict(vocab=32, dim=32, depth=2, num_heads=2, mlp_dim=64, moe_every=2,
          num_experts=4)
LR = 3e-3
CLI_ARGS = ["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
            "--batch-size", "8", "--cycles", "3", "--opt", "adam",
            "--lr", "3e-3", "--print-every", "1", "--eval-every", "0",
            "--device", "cpu"]


def expert_fn(p, x):
    """The JAX test's expert: ``gelu(x @ w1) @ w2`` over leading expert
    dims."""
    return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _rows(x: np.ndarray, i: int, n: int) -> np.ndarray:
    """Shard ``i`` of ``n`` of a global token array, as JAX cuts one
    padded to a multiple of ``n``: ``ceil(T / n)`` rows a shard, the
    last ones short."""
    m = -(-x.shape[0] // n)
    return np.ascontiguousarray(x[i * m:(i + 1) * m])


def moe(mesh, per_expert: dict, router: dict, xs: dict, g: dict) -> dict:
    """Every case of ``MOE_CASES`` on each mesh of ``MOE_MESHES``: this
    rank's output rows and aux; for ``top2`` the gradients of ``sum(out
    g) + AUX_W aux / n`` (the ``n`` ranks' losses sum to the JAX test's)
    for this rank's tokens, the router and its experts."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import (moe_apply,
                                                    stack_expert_params)

    out = {}
    for mname, axes in MOE_MESHES.items():
        mm = make_mesh(axes, device="cpu")
        batch_axis = "data" if "data" in axes else None
        n = mm.axis_size(tuple(axes))
        i = mm.axis_index(tuple(axes))
        experts = [{k: torch.from_numpy(v) for k, v in p.items()}
                   for p in per_expert[mname]]
        for name, kw in MOE_CASES.items():
            fn = moe_apply(expert_fn, mm, batch_axis=batch_axis, **kw)
            stacked = stack_expert_params(experts, mm)
            x = torch.from_numpy(_rows(xs[name], i, n))
            rw = torch.from_numpy(router[mname])
            if name == "top2":
                for t in (x, rw, *stacked.values()):
                    t.requires_grad_(True)
            y, aux = fn(stacked, rw, x)
            res = {"out": y.detach().numpy().copy(), "aux": aux.item(),
                   "stacked_rows": stacked["w1"].shape[0]}
            if name == "top2":
                gl = torch.from_numpy(_rows(g[name], i, n))
                # the ranks' losses add up to the JAX loss: the aux, the
                # same on every rank, counts once
                ((y * gl).sum() + AUX_W * aux / n).backward()
                res.update(dx=x.grad.numpy().copy(),
                           drouter=rw.grad.numpy().copy(),
                           dexperts={k: v.grad.numpy().copy()
                                     for k, v in stacked.items()})
            out[f"{mname}/{name}"] = res
    return out


class _Margins:
    """A ``moe_fn`` that records each call's smallest top-1/top-2 router
    probability margin over its tokens, then routes."""

    def __init__(self, inner):
        self.inner, self.margins = inner, []
        self.mesh = inner.mesh

    def __call__(self, experts, router_w, x):
        with torch.no_grad():
            p = torch.softmax(x.float() @ router_w.float(), dim=-1)
            top = torch.topk(p, 2, dim=-1).values
            self.margins.append((top[:, 0] - top[:, 1]).min().item())
        return self.inner(experts, router_w, x)


def _moe_lm(mm, sd=None, cap=2.0):
    from fluxdistributed_tpu_torch.models import TransformerLM, moe_expert_fn
    from fluxdistributed_tpu_torch.parallel import moe_apply

    fn = _Margins(moe_apply(moe_expert_fn, mm, capacity_factor=cap,
                            batch_axis="data"))
    model = TransformerLM(dtype=torch.float32, dropout=0.0, moe_fn=fn,
                          device="cpu", **LM)
    if sd is not None:
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model, fn


def _ep_task(model, mm, cycles=3):
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.train import prepare_training

    return prepare_training(model, SyntheticTextDataset(vocab=32, seqlen=24),
                            optim.adam(LR), mesh=mm, batch_size=16,
                            cycles=cycles, spmd="ep")


def ep_trainer(mesh, sd: dict, toks: np.ndarray, ckpt: str) -> dict:
    """On ``{data: 2, expert: 2}``: ``prepare_training(spmd="ep")`` 3
    steps from the flax weights on this rank's rows (split over data and
    expert jointly), the routing margins, the eval loss, a checkpoint
    restored onto ``{data: 1, expert: 4}``, then the CLI's ``--spmd ep
    --expert-parallel 2`` beside ``train()`` and its refusals."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel.fsdp import gather_state
    from fluxdistributed_tpu_torch.sharding import shard_batch
    from fluxdistributed_tpu_torch.train import (load_checkpoint,
                                                 save_checkpoint)

    mm = make_mesh({"data": 2, "expert": 2}, device="cpu")
    model, fn = _moe_lm(mm, sd)
    task = _ep_task(model, mm)
    init_blocks = _np({k: v for k, v in task.state.params.items()
                       if k.rsplit(".", 1)[-1] in ("w1", "b1", "w2", "b2")})
    batch = shard_batch({"tokens": torch.from_numpy(toks).long()}, mm,
                        axis=("data", "expert"))
    st, losses = task.state, []
    for _ in range(3):
        st, m = task.step_fn(st, batch)
        losses.append(m["loss"].item())
    ev, _ = task.eval_fn(st, batch)
    out = {"coord": mm.coord, "losses": losses, "eval": float(ev),
           "init_blocks": init_blocks,
           "local_w1": tuple(st.params["blocks.1.w1"].shape),
           "params": _np(gather_state(st.params, task.specs.params, mm)),
           "margin": min(fn.margins)}
    save_checkpoint(st, ckpt, 3, mesh=mm, specs=task.specs)
    other = make_mesh({"data": 1, "expert": 4}, device="cpu")
    t2 = _ep_task(_moe_lm(other)[0], other)
    st2 = load_checkpoint(ckpt, t2.state, mesh=other, specs=t2.specs)
    out["restored_step"] = st2.step
    out["restored_local_w1"] = tuple(st2.params["blocks.1.w1"].shape)
    out["restored"] = _np(gather_state(st2.params, t2.specs.params, other))
    out["cli"] = _cli_against_train()
    out["cli_refusals"] = _cli_refusals()
    return out


def _cli_against_train() -> dict:
    import importlib

    from fluxdistributed_tpu_torch import models, optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.parallel import moe_apply
    from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                                 train)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    task = cli.run(CLI_ARGS + ["--spmd", "ep", "--expert-parallel", "2"])
    mesh = make_mesh({"data": 2, "expert": 2}, device="cpu")
    model = lm_tiny(vocab=32, device="cpu", seed=0, moe_every=2,
                    num_experts=2,
                    moe_fn=moe_apply(models.moe_expert_fn, mesh,
                                     capacity_factor=2.0, batch_axis="data"))
    ref = prepare_training(model, SyntheticTextDataset(vocab=32, seqlen=16),
                           optim.adam(3e-3), loss_fn=lm_loss_fn(model),
                           batch_size=8, cycles=3, spmd="ep", mesh=mesh)
    train(ref, print_every=1, eval_every=0, topk=(), logger=NullLogger())
    return {"cli": task.losses, "train": ref.losses,
            "mesh": task.mesh.shape, "moe_every": task.model.moe_every,
            "experts": task.model.num_experts}


def _cli_refusals() -> dict:
    import importlib

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    out = {}
    for extra in (["--spmd", "ep", "--expert-parallel", "2", "--experts",
                   "3"],
                  ["--spmd", "ep", "--expert-parallel", "3"],
                  ["--spmd", "ep", "--expert-parallel", "2", "--model",
                   "resnet18", "--image-size", "8", "--num-classes", "4"]):
        try:
            cli.run(CLI_ARGS + extra)
        except SystemExit as e:
            out[" ".join(extra)] = str(e)
    return out


def ep_all(mesh, per_expert, router, xs, g, sd, toks, ckpt) -> dict:
    """The file's one spawn: :func:`moe`, then :func:`ep_trainer`."""
    return {"moe": moe(mesh, per_expert, router, xs, g),
            **ep_trainer(mesh, sd, toks, ckpt)}
