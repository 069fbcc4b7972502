"""Train a language model with the port:
``python -m fluxdistributed_tpu_torch.train``.

The LM subset of the JAX package's ``bin/driver.py``, with its flag
names and defaults::

    python -m fluxdistributed_tpu_torch.train --model lm_small \\
        --dataset synthetic-text --vocab 256 --seqlen 1024 --batch-size 8 \\
        --attn flash --opt adam --lr 3e-4 --cycles 40

runs on the GPU, through the hand-written flash-attention kernels with
``--attn flash``.  ``--device cpu`` runs the same path on the CPU with
the kernels' plain versions.  ``--zero1`` shards the optimizer state and
update over the ranks (ZeRO-1), ``--spmd shard_map`` names the explicit
per-rank step; both run on a process group, which is one rank unless
the command runs under ``torchrun``::

    torchrun --nproc-per-node 4 -m fluxdistributed_tpu_torch.train ...

(one rank per GPU; ``--batch-size`` is the global batch).  The JAX
CLI's image models and datasets, its other ``--spmd`` modes,
checkpoints, the guard, fault plans and AOT belong to later slices and
are not accepted.
"""

from __future__ import annotations

import argparse
import os
import sys

__all__ = ["build_model", "build_parser", "main", "run"]

MODELS = ("lm_tiny", "lm_small", "lm_medium")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.train",
        description="Train an LM with the PyTorch/H100 port.")
    p.add_argument("--model", default="lm_small", choices=MODELS,
                   help="model factory in fluxdistributed_tpu_torch.models")
    p.add_argument("--dataset", default="synthetic-text",
                   help="'synthetic-text' (a learnable Markov token stream) "
                        "or 'text:PATH' (byte-level LM on a local file)")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocab size for the model and synthetic-text")
    p.add_argument("--seqlen", type=int, default=128,
                   help="sequence length of a training window")
    p.add_argument("--batch-size", type=int, default=256,
                   help="batch size (sequences per step)")
    p.add_argument("--epochs", type=int, default=1,
                   help="epochs for text: datasets (derives --cycles)")
    p.add_argument("--cycles", type=int, default=None,
                   help="explicit step count (required for synthetic-text)")
    p.add_argument("--opt", default="momentum",
                   choices=["momentum", "nesterov", "adam", "adamw",
                            "descent"],
                   help="optimizer (fluxdistributed_tpu_torch.optim)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--total-steps", type=int, default=None,
                   help="enable the warmup-cosine schedule to this horizon")
    p.add_argument("--print-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--attn", default="dense",
                   choices=["dense", "blockwise", "flash"],
                   help="attention core: dense, the blockwise walk, or the "
                        "hand-written flash kernels (fused fwd + bwd)")
    p.add_argument("--attn-block", type=int, default=None,
                   help="block size for --attn blockwise|flash (default "
                        "128; the flash kernels' own tiles are 64 rows)")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: number of KV heads")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window attention: each query attends its "
                        "WINDOW newest keys")
    p.add_argument("--sinks", type=int, default=0,
                   help="attention sinks kept outside the window (requires "
                        "--window)")
    p.add_argument("--norm", default="layernorm",
                   choices=["layernorm", "rmsnorm"])
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--spmd", default="jit",
                   choices=["jit", "dp", "shard_map"],
                   help="data-parallel mode: jit/dp (one device, or DP "
                        "across torchrun ranks) or shard_map (the explicit "
                        "per-rank step); the JAX CLI's other modes are not "
                        "ported")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding for the DP paths "
                        "(--spmd jit/dp/shard_map): reduce-scatter grads, "
                        "shard the optimizer state and update 1/N over the "
                        "ranks, all-gather updated params — DP-identical "
                        "numerics, ~N x lower optimizer memory")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the kernels' plain "
                        "versions)")
    return p


def build_model(args, device, **kwargs):
    """The ``--model`` LM on ``device``, random weights from seed 0."""
    from .. import models

    return getattr(models, args.model)(vocab=args.vocab, device=device,
                                       seed=0, **kwargs)


def _model_kwargs(args) -> dict:
    """The attention core and architecture flags, validated as the
    driver validates them."""
    from ..ops import attention_core, validate_window

    kw = {}
    if args.attn_block is not None and args.attn == "dense":
        raise SystemExit("--attn-block only applies with --attn "
                         "blockwise|flash")
    if args.attn_block is not None and args.attn_block <= 0:
        raise SystemExit(f"--attn-block must be > 0, got {args.attn_block}")
    try:
        validate_window(True, args.window, args.sinks)
    except ValueError as e:
        raise SystemExit(f"--window/--sinks: {e}")
    if args.window is not None:
        # the model field windows the dense core AND the decode path; a
        # non-dense attn_fn gets its own window below
        kw["window"] = args.window
        if args.sinks:
            kw["sinks"] = args.sinks
    if args.attn != "dense":
        kw["attn_fn"] = attention_core(
            args.attn, args.attn_block if args.attn_block else 128,
            window=args.window, sinks=args.sinks)
    if args.kv_heads is not None:
        if args.kv_heads <= 0:
            raise SystemExit(f"--kv-heads must be > 0, got {args.kv_heads}")
        kw["num_kv_heads"] = args.kv_heads
    if args.norm != "layernorm" or args.mlp != "gelu":
        kw["norm"], kw["mlp"] = args.norm, args.mlp
    return kw


def run(argv=None):
    """Parse ``argv``, train, and return the finished
    :class:`~.trainer.TrainTask` (``task.losses`` holds every step's
    loss).  ``main`` is this plus an exit code."""
    args = build_parser().parse_args(argv)

    from ..data import ByteTextDataset, SyntheticTextDataset
    from ..device import resolve_device

    device = resolve_device(args.device)
    if args.dataset == "synthetic-text":
        dataset = SyntheticTextDataset(vocab=args.vocab, seqlen=args.seqlen)
    elif args.dataset.startswith("text:"):
        dataset = ByteTextDataset(args.dataset[len("text:"):],
                                  seqlen=args.seqlen)
        args.vocab = dataset.vocab
    else:
        raise SystemExit(
            f"--dataset {args.dataset}: the port trains LMs on "
            "'synthetic-text' or 'text:PATH' (image datasets come with the "
            "vision slice)")
    if args.cycles is None and not hasattr(dataset, "__len__"):
        raise SystemExit("--cycles is required for unbounded token streams "
                         "(synthetic-text has no epoch length; text: "
                         "datasets derive cycles from --epochs)")
    # a process group for ZeRO-1, the shard_map step, or torchrun's ranks;
    # one this call forms, it also ends
    mesh, formed = None, False
    if args.zero1 or args.spmd == "shard_map" or "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from ..mesh import init_distributed

        formed = not dist.is_initialized()
        mesh = init_distributed(device)
        device = mesh.device
    try:
        return _train(args, dataset, device, mesh)
    finally:
        if formed:
            from ..mesh import shutdown_distributed

            shutdown_distributed()


def _train(args, dataset, device, mesh):
    import torch

    from .. import optim
    from ..models import lm_loss_fn
    from .logging import ConsoleLogger, NullLogger
    from .trainer import prepare_training, train

    try:
        model = build_model(args, device, **_model_kwargs(args))
    except ValueError as e:  # e.g. --kv-heads not dividing num_heads
        raise SystemExit(f"--model {args.model}: {e}")

    lr = args.lr
    if args.total_steps:
        lr = optim.warmup_cosine(args.lr, args.warmup_steps, args.total_steps)
    opt = getattr(optim, args.opt)(lr)
    try:
        task = prepare_training(
            model, dataset, opt, loss_fn=lm_loss_fn(model),
            batch_size=args.batch_size, epochs=args.epochs,
            cycles=args.cycles, spmd=args.spmd, zero1=args.zero1, mesh=mesh,
            device=device)
    except ValueError as e:  # e.g. a batch that does not split over ranks
        raise SystemExit(f"--spmd {args.spmd}: {e}")
    lead = mesh is None or mesh.rank == 0
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ranks = "" if mesh is None else (
        f", {mesh.size} rank(s) ({torch.distributed.get_backend()})"
        f"{', zero1' if args.zero1 else ''}")
    if lead:
        print(f"device: {device} ({name}){ranks}, model {args.model} "
              f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"params, {str(model.dtype).split('.')[-1]}), attn {args.attn}",
              flush=True)
    train(task, print_every=args.print_every, eval_every=args.eval_every,
          logger=ConsoleLogger() if lead else NullLogger())
    if lead:
        print(f"done: {task.state.step} steps, {task.num_missed} missed",
              flush=True)
    return task


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
