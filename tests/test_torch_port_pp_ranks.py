"""Rank bodies for the port's pipeline tests (``test_torch_port_pp.py``
and ``test_torch_port_pp_trainer.py``); this module holds no tests of
its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

D = 8  # the toy stages' width
B = 8  # the toy batch (global rows)
MESHES = {"pipe4": {"pipe": 4}, "data2_pipe2": {"data": 2, "pipe": 2}}
# name: the toy pipeline_apply cases (the chunked ones host 2 chunks a
# device; "counts" pads a plan's non-uniform split)
TOY_CASES = ("plain", "switch", "chunk", "counts", "remat")
COUNTS = {"pipe4": (1, 2, 2, 1), "data2_pipe2": (1, 2)}
M_TOY = 4
# the 1F1B toy on the ranks: (mesh, M, V, schedule)
F1B_RANK_CASES = {"pipe4_m4_v2_zb": ("pipe4", 4, 2, "zb"),
                  "data2_pipe2_m4_v1": ("data2_pipe2", 4, 1, "1f1b")}
# the LM cases (f32, vocab 32, dim 32, 2 heads): name -> (mesh, depth,
# tied, schedule ("gpipe", "1f1b", "zb"), M, interleave, boundaries)
LM = dict(vocab=32, dim=32, num_heads=2, mlp_dim=64)
LM_CASES = {
    "gpipe_tied": ("pipe4", 4, True, "gpipe", 4, False, None),
    "gpipe_untied": ("pipe4", 4, False, "gpipe", 4, False, None),
    "gpipe_planned": ("pipe4", 6, True, "gpipe", 4, False, (0, 1, 3, 4, 6)),
    "1f1b_blocked_tied": ("pipe4", 8, True, "1f1b", 4, False, None),
    "zb_interleaved_untied": ("pipe4", 8, False, "zb", 4, True, None),
    "zb_planned_untied": ("pipe4", 6, False, "zb", 8, False,
                          (0, 1, 3, 4, 6)),
}
LM_TOKENS = (8, 16)
LR = 3e-3
TRAIN_LM = dict(vocab=32, dim=32, depth=4, num_heads=2, mlp_dim=64)
TRAIN_STEPS = 3
CLI_ARGS = ["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
            "--batch-size", "8", "--cycles", "3", "--opt", "adam",
            "--lr", "3e-3", "--print-every", "1", "--eval-every", "0",
            "--device", "cpu"]


def toy_stage(p, x):
    return x + F.gelu(x @ p["w"] + p["b"], approximate="tanh")


def tanh_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def toy_embed(o, tok):
    return o["e"][tok.long()]


def toy_head(o, y, lab):
    return ((y @ o["h"] - lab) ** 2).mean()


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _rows(x: np.ndarray, mm, axis="data"):
    """This rank's rows of a global batch split over ``axis`` (whole
    when the mesh has no such axis)."""
    if axis not in mm.shape:
        return x
    n, i = mm.axis_size(axis), mm.axis_index(axis)
    k = x.shape[0] // n
    return np.ascontiguousarray(x[i * k:(i + 1) * k])


def toy_stage_fn(case: str, mname: str):
    from fluxdistributed_tpu_torch.parallel import chunk_stages, switch_stage

    if case == "switch":
        return switch_stage([toy_stage if s % 2 == 0 else tanh_stage
                             for s in range(MESHES[mname]["pipe"])])
    if case == "chunk":
        return chunk_stages(toy_stage)
    if case == "counts":
        return chunk_stages(toy_stage, counts=COUNTS[mname])
    return toy_stage


def toy_pipeline(mesh, toy: dict) -> dict:
    """Each ``TOY_CASES`` pipeline on each mesh: this rank's output rows,
    the gradients of ``sum(out * g)`` over this rank's rows for its
    stage block and its rows of ``x``."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import (pipeline_apply,
                                                    stack_stage_params)

    out = {}
    for mname, axes in MESHES.items():
        mm = make_mesh(axes, device="cpu")
        batch_axis = "data" if "data" in axes else None
        for case in TOY_CASES:
            fwd = pipeline_apply(toy_stage_fn(case, mname), mm,
                                 num_microbatches=M_TOY,
                                 batch_axis=batch_axis,
                                 remat=case == "remat")
            per = [_t(p) for p in toy[f"{mname}/{case}"]["per_device"]]
            stacked = {k: v.requires_grad_(True) for k, v in
                       stack_stage_params(per, mm).items()}
            x = torch.from_numpy(_rows(toy["x"], mm)).requires_grad_(True)
            g = torch.from_numpy(_rows(toy["g"], mm))
            y = fwd(stacked, x)
            dx, *dp = torch.autograd.grad((y * g).sum(),
                                          [x, *stacked.values()])
            out[f"{mname}/{case}"] = {
                "out": y.detach().numpy().copy(), "dx": dx.numpy().copy(),
                "dstacked": {k: v.numpy().copy()
                             for k, v in zip(stacked, dp)}}
    return out


def f1b_on_ranks(mesh, toy: dict) -> dict:
    """``pipeline_grads_1f1b`` over the process group for each
    ``F1B_RANK_CASES``: the loss, this rank's stage-grad block and the
    outer grads."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import pipeline_grads_1f1b

    out = {}
    for name, (mname, M, V, schedule) in F1B_RANK_CASES.items():
        mm = make_mesh(MESHES[mname], device="cpu")
        s = mm.axis_index("pipe")
        stacked = {k: torch.from_numpy(v[s:s + 1])
                   for k, v in toy[f"f1b/{name}"]["stacked"].items()}
        run = pipeline_grads_1f1b(
            toy_stage, toy_embed, toy_head, mm, num_microbatches=M,
            batch_axis="data" if "data" in mm.shape else None,
            interleave=V, schedule=schedule)
        loss, g_st, g_out = run(stacked, _t(toy["outer"]),
                                torch.from_numpy(_rows(toy["tok"], mm)),
                                torch.from_numpy(_rows(toy["lab"], mm)))
        out[name] = {"loss": loss.item(), "stages": _np(g_st),
                     "outer": _np(g_out)}
    return out


def lm_model(depth: int, tied: bool, sd=None, **kw):
    from fluxdistributed_tpu_torch.models import TransformerLM

    model = TransformerLM(depth=depth, tie_embeddings=tied,
                          dtype=torch.float32, device="cpu", **LM, **kw)
    if sd is not None:
        model.load_state_dict(_t(sd))
    return model


def lm_pipelines(mesh, sds: dict, toks: np.ndarray) -> dict:
    """Each ``LM_CASES`` wiring from the flax weights ``sds[name]`` on
    its mesh: the loss, this rank's split tree (its stage block) and its
    gradients (each rank's rows of ``toks``)."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_pp, lm_pp_1f1b
    from fluxdistributed_tpu_torch.parallel import pipeline_grads_1f1b
    from fluxdistributed_tpu_torch.parallel.pp import join_tree, split_tree

    out = {}
    for name, (mname, depth, tied, sched, M, inter, bounds) in \
            LM_CASES.items():
        mm = make_mesh(MESHES[mname], device="cpu")
        model = lm_model(depth, tied, sds[name])
        params = dict(model.named_parameters())
        batch_axis = "data" if "data" in mm.shape else None
        tokens = torch.from_numpy(_rows(toks, mm)).long()
        if sched == "gpipe":
            split, loss_fn, _ = lm_pp(model, mm, batch_axis=batch_axis,
                                      num_microbatches=M, boundaries=bounds)
            flat = {k: v.requires_grad_(True)
                    for k, v in split(params).items()}
            loss, _ = loss_fn(flat, {}, {"tokens": tokens}, True)
            grads = dict(zip(flat, torch.autograd.grad(
                loss, list(flat.values()))))
        else:
            w = lm_pp_1f1b(model, mm, interleave=inter, boundaries=bounds)
            flat = w.split_params(params)
            run = pipeline_grads_1f1b(*w.fns, mm, num_microbatches=M,
                                      batch_axis=batch_axis,
                                      interleave=w.interleave,
                                      schedule=sched)
            outer, stages = split_tree(flat)
            loss, g_st, g_out = run(stages, outer, tokens, tokens)
            grads = join_tree(g_out, g_st)
        out[name] = {"loss": loss.item(), "split": _np(flat),
                     "grads": _np(grads)}
    return out


def pp_train_steps(mesh) -> list:
    """``make_train_step_pp`` on ``{pipe: 4}`` (the JAX
    ``test_pp_train_step_loss_falls``): 4 residual stages of width 16
    read out as logits, momentum 0.1, 25 steps on a separable batch;
    the losses."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.ops import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (TrainState,
                                                    make_train_step_pp,
                                                    stack_stage_params)

    mm = make_mesh({"pipe": 4}, device="cpu")
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 32)
    x = rng.normal(0, 0.3, (32, 16)).astype(np.float32)
    x[:, 0] += y * 2.0  # a separable signal in feature 0
    per = [{"w": torch.from_numpy((rng.normal(size=(16, 16)) * 0.3)
                                  .astype(np.float32)),
            "b": torch.zeros(16)} for _ in range(4)]
    opt = optim.momentum(0.1, 0.9)
    state = TrainState.create(stack_stage_params(per, mm), opt)
    step = make_train_step_pp(toy_stage, logitcrossentropy, opt, mm,
                              num_microbatches=4)
    batch = {"image": torch.from_numpy(x),
             "label": F.one_hot(torch.from_numpy(y), 16).float()}
    losses = []
    for _ in range(25):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return losses


def layers_all(mesh, toy, sds, toks) -> dict:
    """``test_torch_port_pp.py``'s one spawn."""
    from fluxdistributed_tpu_torch.mesh import make_mesh

    return {"coord": make_mesh({"data": 2, "pipe": 2}, device="cpu").coord,
            "toy": toy_pipeline(mesh, toy), "f1b": f1b_on_ranks(mesh, toy),
            "lm": lm_pipelines(mesh, sds, toks),
            "train_step": pp_train_steps(mesh)}


# ------------------------------------------------------------ the trainer

def _task(mm, spmd, sd=None, cycles=TRAIN_STEPS, **kw):
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import TransformerLM
    from fluxdistributed_tpu_torch.train import prepare_training

    model = TransformerLM(dtype=torch.float32, device="cpu", seed=0,
                          **TRAIN_LM)
    if sd is not None:
        model.load_state_dict(_t(sd))
    return prepare_training(model, SyntheticTextDataset(vocab=32, seqlen=16),
                            optim.adam(LR), mesh=mm, batch_size=8,
                            cycles=cycles, spmd=spmd, num_microbatches=2,
                            **kw)


def _steps(task, batch, n=TRAIN_STEPS):
    st, losses = task.state, []
    for _ in range(n):
        st, m = task.step_fn(st, batch)
        losses.append(m["loss"].item())
    return st, losses


def _global(task, st):
    from fluxdistributed_tpu_torch.parallel.fsdp import gather_state

    return _np(gather_state(st.params, task.specs.params, task.mesh))


def trainer_all(mesh, sd: dict, toks: np.ndarray, ckpt: str,
                ckpt_ab: str) -> dict:
    """On ``{data: 2, pipe: 2}``: ``prepare_training(spmd="pp"|
    "pp_1f1b")`` (and zb, and interleaved) 3 steps from the flax weights
    on this rank's rows; the eval loss; the val slice at the quantum;
    ``evaluate``; a checkpoint resume against the straight run; a GPipe
    checkpoint restored into a 1F1B task; the CLI beside ``train()``."""
    from fluxdistributed_tpu_torch.data import ByteTextDataset
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.sharding import shard_batch
    from fluxdistributed_tpu_torch.train import (evaluate, load_checkpoint,
                                                 save_checkpoint)

    mm = make_mesh({"data": 2, "pipe": 2}, device="cpu")
    batch = shard_batch({"tokens": torch.from_numpy(toks).long()}, mm)
    out = {"runs": {}}
    for name, kw in (("pp", {"spmd": "pp"}),
                     ("pp_1f1b", {"spmd": "pp_1f1b"}),
                     ("zb", {"spmd": "pp_1f1b", "pipeline_schedule": "zb"}),
                     ("interleaved", {"spmd": "pp_1f1b",
                                      "pipeline_interleave": True})):
        task = _task(mm, sd=sd, **kw)
        st, losses = _steps(task, batch)
        ev, metrics = task.eval_fn(st, batch)
        out["runs"][name] = {"losses": losses, "eval": float(ev),
                             "metrics": dict(metrics),
                             "params": _global(task, st),
                             "quantum": task.batch_quantum,
                             "local_shapes": {
                                 k: tuple(v.shape)
                                 for k, v in task.state.params.items()}}
    # the val slice and evaluate round to data x microbatches = 4
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".txt")
    os.write(fd, bytes(range(32)) * 13)  # 416 bytes: 26 windows of 16
    os.close(fd)
    ds = ByteTextDataset(path, seqlen=16)
    task = _task(mm, "pp", sd=sd, val_dataset=ds, val_samples=6)
    out["val_rows"] = int(task.val_batch["tokens"].shape[0])
    ev, _ = task.eval_fn(task.state, task.val_batch)
    out["val_eval"] = float(ev)
    out["evaluate"] = evaluate(task, ds, batch_size=10)
    os.remove(path)
    # a resume: 2 steps, a checkpoint, a fresh task restored from it and
    # 1 more step, against the straight 3 steps (pp_1f1b)
    task = _task(mm, "pp_1f1b", sd=sd)
    st, first = _steps(task, batch, 2)
    save_checkpoint(st, ckpt, 2, mesh=mm, specs=task.specs)
    fresh = _task(mm, "pp_1f1b")
    st2 = load_checkpoint(ckpt, fresh.state, mesh=mm, specs=fresh.specs)
    fresh.state = st2
    st3, last = _steps(fresh, batch, 1)
    out["resume"] = {"losses": first + last, "step": st3.step,
                     "params": _global(fresh, st3)}
    # a GPipe checkpoint restored into a 1F1B task, and trained on
    task = _task(mm, "pp", sd=sd)
    st, _ = _steps(task, batch, 2)
    save_checkpoint(st, ckpt_ab, 2, mesh=mm, specs=task.specs)
    other = _task(mm, "pp_1f1b")
    st2 = load_checkpoint(ckpt_ab, other.state, mesh=mm, specs=other.specs)
    out["gpipe_into_1f1b"] = {"restored": _global(other, st2),
                              "saved": _global(task, st),
                              "step": st2.step}
    other.state = st2
    _, out["gpipe_into_1f1b"]["losses"] = _steps(other, batch, 1)
    out["cli"] = _cli_against_train()
    return out


def _cli_against_train() -> dict:
    import importlib

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_tiny
    from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                                 train)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    out = {}
    for extra, kw in ((["--spmd", "pp", "--pipe", "2"], {"spmd": "pp"}),
                      (["--spmd", "pp_1f1b", "--pipe", "2",
                        "--microbatches", "2", "--pp-schedule", "zb"],
                       {"spmd": "pp_1f1b", "num_microbatches": 2,
                        "pipeline_schedule": "zb"})):
        task = cli.run(CLI_ARGS + extra)
        mesh = make_mesh({"data": 2, "pipe": 2}, device="cpu")
        ref = prepare_training(
            lm_tiny(vocab=32, device="cpu", seed=0),
            SyntheticTextDataset(vocab=32, seqlen=16), optim.adam(3e-3),
            batch_size=8, cycles=3, mesh=mesh, **kw)
        train(ref, print_every=1, eval_every=0, topk=(),
              logger=NullLogger())
        out[" ".join(extra)] = {"cli": task.losses, "train": ref.losses,
                                "mesh": task.mesh.shape}
    return out
