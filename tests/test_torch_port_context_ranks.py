"""Rank bodies for the port's context-parallel tests
(``test_torch_port_context.py``); this module holds no tests of its own.

Each function runs inside one gloo rank spawned by
``fluxdistributed_tpu_torch.mesh.run_ranks``: a fresh interpreter that
imports this module by name, so it imports the port and numpy only,
never JAX.  Results are numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# the LM of the trainer tests (f32): 4 heads over a seq axis of 2
SMALL = dict(depth=2, dim=32, num_heads=4, mlp_dim=64)
VOCAB = 32
LR = 3e-3
# name: (strategy, impl, causal, hkv); q has 8 heads of 16
ATTN_CASES = {
    "ring_xla": ("ring", "xla", False, 8),
    "ring_xla_causal": ("ring", "xla", True, 8),
    "ring_xla_gqa": ("ring", "xla", True, 2),
    "ring_flash": ("ring", "flash", False, 8),
    "ring_flash_causal": ("ring", "flash", True, 8),
    "ring_flash_gqa": ("ring", "flash", True, 2),
    "ulysses": ("ulysses", None, False, 8),
    "ulysses_causal": ("ulysses", None, True, 8),
    "ulysses_hkv2": ("ulysses", None, True, 2),  # expanded before
    "ulysses_hkv4": ("ulysses", None, True, 4),  # rides at hkv heads
}
MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2}}
CLI_ARGS = ["--model", "lm_tiny", "--vocab", "32", "--seqlen", "16",
            "--batch-size", "8", "--cycles", "3", "--opt", "adam",
            "--lr", "3e-3", "--print-every", "1", "--eval-every", "0",
            "--device", "cpu"]


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _block(x: np.ndarray, mm) -> torch.Tensor:
    """This rank's [B/D, T/S, ...] block of a global [B, T, ...] array."""
    d = mm.shape.get("data", 1)
    b, t = x.shape[0] // d, x.shape[1] // mm.shape["seq"]
    i, s = mm.coord.get("data", 0), mm.coord["seq"]
    return torch.from_numpy(np.ascontiguousarray(
        x[i * b:(i + 1) * b, s * t:(s + 1) * t]))


def attention(mesh, q, k, v, g) -> dict:
    """Every case of ``ATTN_CASES`` on each mesh of ``MESHES``: this
    rank's output block and the gradients of ``sum(out * g)`` for its
    q/k/v blocks; and Ulysses' head-count refusal."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import (make_ring_attention,
                                                    make_ulysses_attention)

    out = {}
    for mname, axes in MESHES.items():
        mm = make_mesh(axes, device="cpu")
        out[f"{mname}_coord"] = mm.coord
        batch_axis = "data" if "data" in axes else None
        for name, (strategy, impl, causal, hkv) in ATTN_CASES.items():
            if strategy == "ring":
                fn = make_ring_attention(mm, batch_axis=batch_axis,
                                         causal=causal, impl=impl,
                                         block_q=4, block_k=4)
            else:
                fn = make_ulysses_attention(mm, batch_axis=batch_axis,
                                            causal=causal)
            ts = [_block(x, mm).requires_grad_(True)
                  for x in (q, k[:, :, :hkv], v[:, :, :hkv])]
            o = fn(*ts)
            (o * _block(g, mm)).sum().backward()
            out[f"{mname}/{name}"] = [o.detach().numpy().copy()] + [
                t.grad.numpy().copy() for t in ts]
        if mname == "seq4":
            try:
                make_ulysses_attention(mm)(*(_block(x[:, :, :6], mm)
                                             for x in (q, k, v)))
            except ValueError as e:
                out["ulysses_refusal"] = str(e)
    return out


class _Seen:
    """An ``attn_fn`` that records the shapes of the q it is given."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []
        for a in ("mesh", "seq_axis", "batch_axis", "strategy", "causal"):
            setattr(self, a, getattr(inner, a))

    def __call__(self, q, k, v):
        self.seen.append(tuple(q.shape))
        return self.inner(q, k, v)


def _lm(sd, attn_fn, dropout=0.0):
    from fluxdistributed_tpu_torch.models import lm_tiny

    m = lm_tiny(vocab=VOCAB, dtype=torch.float32, device="cpu",
                dropout=dropout, attn_fn=attn_fn, **SMALL)
    if sd is not None:
        m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return m


def _trainer_run(model, mm, toks, steps, spmd, seed=0):
    """``prepare_training`` with ``spmd`` on ``mm`` and ``steps`` steps
    on this rank's rows of ``toks``: losses and params after."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.sharding import shard_batch
    from fluxdistributed_tpu_torch.train import prepare_training

    ds = SyntheticTextDataset(vocab=VOCAB, seqlen=toks.shape[1])
    task = prepare_training(model, ds, optim.adam(LR), mesh=mm,
                            batch_size=toks.shape[0], cycles=steps,
                            spmd=spmd, loss_fn=lm_loss_fn(model), topk=(),
                            seed=seed)
    batch = shard_batch({"tokens": torch.from_numpy(toks).long()}, mm,
                        axis="data")
    st, losses = task.state, []
    for _ in range(steps):
        st, m = task.step_fn(st, batch)
        losses.append(m["loss"].item())
    ev, _ = task.eval_fn(st, batch)
    return losses, _np(st.params), float(ev)


def sp_trainer(mesh, sd: dict, toks: np.ndarray) -> dict:
    """On ``{data: 2, seq: 2}``: ``prepare_training(spmd="sp")`` 3 steps
    with the flash ring and with Ulysses (the shapes each attention
    call saw), dropout 0.1 against the data-parallel step over the data
    rows with the same seed, then the CLI's ``--spmd sp --seq-parallel 2
    --sp-strategy ulysses`` beside ``train()`` with the same arguments,
    and the CLI's refusals that need two ranks."""
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.parallel import (make_ring_attention,
                                                    make_ulysses_attention)

    mm = make_mesh({"data": 2, "seq": 2}, device="cpu")
    out = {"coord": mm.coord}
    for name, attn in (
            ("ring", make_ring_attention(mm, batch_axis="data", causal=True,
                                         impl="flash", block_q=8,
                                         block_k=8)),
            ("ulysses", make_ulysses_attention(mm, batch_axis="data",
                                               causal=True))):
        seen = _Seen(attn)
        out[name] = _trainer_run(_lm(sd, seen), mm, toks, 3, "sp")
        out[f"{name}_seen"] = sorted(set(seen.seen))
    # dropout: the shards draw one rank's masks, so the sp step is the
    # data-parallel step over the data rows
    ring = make_ring_attention(mm, batch_axis="data", causal=True)
    out["dropout_sp"] = _trainer_run(_lm(sd, ring, 0.1), mm, toks, 2, "sp",
                                     seed=5)
    out["dropout_dp"] = _trainer_run(_lm(sd, None, 0.1), mm.sub("data"),
                                     toks, 2, "jit", seed=5)
    out["cli"] = _cli_against_train(mm)
    out["cli_refusals"] = _cli_refusals()
    return out


def _cli_against_train(mm) -> dict:
    import importlib

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_tiny
    from fluxdistributed_tpu_torch.parallel import make_ulysses_attention
    from fluxdistributed_tpu_torch.train import (NullLogger, prepare_training,
                                                 train)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    task = cli.run(CLI_ARGS + ["--spmd", "sp", "--seq-parallel", "2",
                               "--sp-strategy", "ulysses"])
    mesh = make_mesh({"data": 2, "seq": 2}, device="cpu")
    model = lm_tiny(vocab=32, device="cpu", seed=0,
                    attn_fn=make_ulysses_attention(mesh, batch_axis="data",
                                                   causal=True))
    ref = prepare_training(model, SyntheticTextDataset(vocab=32, seqlen=16),
                           optim.adam(3e-3), loss_fn=lm_loss_fn(model),
                           batch_size=8, cycles=3, spmd="sp", mesh=mesh)
    train(ref, print_every=1, eval_every=0, topk=(), logger=NullLogger())
    return {"cli": task.losses, "train": ref.losses,
            "mesh": task.mesh.shape,
            "strategy": task.model.attn_fn.strategy}


def _cli_refusals() -> dict:
    import importlib

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    out = {}
    for extra in (["--spmd", "sp", "--window", "4"],
                  ["--spmd", "sp", "--attn", "flash"],
                  ["--spmd", "sp", "--seq-parallel", "3"],
                  ["--spmd", "sp", "--seqlen", "15"]):
        argv = CLI_ARGS + extra
        try:
            cli.run(argv)
        except SystemExit as e:
            out[" ".join(extra)] = str(e)
    return out


def context_all(mesh, q, k, v, g, sd: dict, toks: np.ndarray) -> dict:
    """The file's one spawn: :func:`attention`, then :func:`sp_trainer`."""
    return {"attn": attention(mesh, q, k, v, g),
            **sp_trainer(mesh, sd, toks)}
