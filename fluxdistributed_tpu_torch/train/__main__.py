"""Train an image classifier or a language model with the port:
``python -m fluxdistributed_tpu_torch.train``.

The data-parallel subset of the JAX package's ``bin/driver.py``, with
its flag names and defaults: the reference's main path, ResNet-50 on
synthetic ImageNet-sized images with momentum, is the default::

    python -m fluxdistributed_tpu_torch.train --model resnet50 \\
        --dataset synthetic --image-size 224 --batch-size 256 \\
        --opt momentum --lr 0.01 --cycles 30

(the eval cadence logs the top-1/5/10 accuracies; ``--model
vit_b16|vit_l16|...`` and ``convnext_*`` train the ViT and ConvNeXt
families), and an LM trains on token data::

    python -m fluxdistributed_tpu_torch.train --model lm_small \\
        --dataset synthetic-text --vocab 256 --seqlen 1024 --batch-size 8 \\
        --attn flash --opt adam --lr 3e-4 --cycles 40

Both run on the GPU; an LM goes through the hand-written flash-attention
kernels with ``--attn flash``.  ``--device cpu`` runs the same path on the CPU with
the kernels' plain versions.  ``--zero1`` shards the optimizer state and
update over the ranks (ZeRO-1), ``--spmd shard_map`` names the explicit
per-rank step; both run on a process group, which is one rank unless
the command runs under ``torchrun``::

    torchrun --nproc-per-node 4 -m fluxdistributed_tpu_torch.train ...

(one rank per GPU; ``--batch-size`` is the global batch, and a ResNet's
BatchNorm statistics are those of the global batch).  ``--steps-per-call
K`` runs K optimizer steps a call (the JAX device loop): the loader
stacks K batches an item, and on the GPU the K steps are one CUDA graph
replay (``--cycles`` must be a multiple of K; ``--spmd jit`` only).

``--dataset`` takes the JAX CLI's forms: ``synthetic``,
``synthetic-text``, ``text:PATH`` and a name registered by
``--data-toml`` (a ``[[datasets]]`` TOML: ImageNet, CIFAR-10, synthetic
or text drivers, :mod:`..data.registry`); ``cifar:PATH`` registers a
``cifar10`` entry for PATH and opens it the same way.  ``--val-dataset``
names a registered dataset whose slice the eval cadence reports, and
``--final-eval`` evaluates the whole of it after training.

``--checkpoint-dir DIR`` saves the state every ``--checkpoint-every``
items (default 20, the reference's cadence), and a SIGTERM or SIGINT
checkpoints at the next step boundary, writes ``DIR/RESUME.json`` and
exits with code 75 (``faults.PREEMPTED_RC``: requeue me); ``--resume``
then continues from there, step for step::

    python -m fluxdistributed_tpu_torch.train ... --checkpoint-dir ck
    python -m fluxdistributed_tpu_torch.train ... --checkpoint-dir ck --resume

``--fault-plan JSON`` (or ``@file.json``) installs a deterministic
fault plan first (:class:`..faults.FaultPlan`), e.g.
``'{"sigterm_at_step": 3}'``.  The JAX CLI's other ``--spmd`` modes,
the guard and AOT belong to later slices and are not accepted.
"""

from __future__ import annotations

import argparse
import os
import sys

__all__ = ["build_model", "build_parser", "main", "run"]

LM_MODELS = ("lm_tiny", "lm_small", "lm_medium")
VIT_MODELS = ("vit_tiny", "vit_b16", "vit_l16", "vit_h14")
IMAGE_MODELS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                "SimpleCNN", *VIT_MODELS, "convnext_test", "convnext_tiny",
                "convnext_small", "convnext_base", "convnext_large",
                "convnext_xlarge")
MODELS = IMAGE_MODELS + LM_MODELS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.train",
        description="Train an image classifier or an LM with the "
                    "PyTorch/H100 port.")
    p.add_argument("--model", default="resnet50", choices=MODELS,
                   help="model factory in fluxdistributed_tpu_torch.models")
    p.add_argument("--dataset", default=None,
                   help="a registered dataset name (--data-toml), or: "
                        "images: 'synthetic' (learnable class templates; the "
                        "default) or 'cifar:PATH' (the CIFAR-10 binaries); "
                        "tokens: 'synthetic-text' (a learnable Markov token "
                        "stream; the default) or 'text:PATH' (byte-level LM "
                        "on a local file)")
    p.add_argument("--data-toml", default=None,
                   help="dataset registry TOML to load (Data.toml analog)")
    p.add_argument("--val-dataset", default=None,
                   help="registered val dataset name")
    p.add_argument("--final-eval", action="store_true",
                   help="after training, aggregate loss/top-k over the FULL "
                        "--val-dataset with train.evaluate")
    p.add_argument("--image-size", type=int, default=224,
                   help="synthetic image side (and a ViT's input side)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="class count (default: the dataset's; synthetic: "
                        "1000)")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocab size for the model and synthetic-text")
    p.add_argument("--seqlen", type=int, default=128,
                   help="sequence length of a training window")
    p.add_argument("--batch-size", type=int, default=256,
                   help="global batch size (images or sequences per step)")
    p.add_argument("--epochs", type=int, default=1,
                   help="epochs for text: datasets (derives --cycles)")
    p.add_argument("--cycles", type=int, default=None,
                   help="explicit step count (required for synthetic-text)")
    p.add_argument("--opt", default="momentum",
                   choices=["momentum", "nesterov", "adam", "adamw",
                            "descent", "lars"],
                   help="optimizer (fluxdistributed_tpu_torch.optim)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--total-steps", type=int, default=None,
                   help="enable the warmup-cosine schedule to this horizon")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=20,
                   help="cycles between checkpoints (reference: 20)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (and RESUME "
                        "manifest) in --checkpoint-dir")
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="install a deterministic fault-injection plan "
                        "(fluxdistributed_tpu_torch.faults) before anything "
                        "else runs: a JSON object or @path/to/plan.json, "
                        "e.g. '{\"sigterm_at_step\": 50}'")
    p.add_argument("--print-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--attn", default="dense",
                   choices=["dense", "blockwise", "flash"],
                   help="LMs: attention core: dense, the blockwise walk, or "
                        "the hand-written flash kernels (fused fwd + bwd)")
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
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per call (the device loop; spmd="
                        "jit): one CUDA graph replay of K steps on the GPU, "
                        "a plain loop of them on the CPU")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the kernels' plain "
                        "versions)")
    return p


def build_model(args, device, **kwargs):
    """The ``--model`` LM or image model on ``device``, random weights
    from seed 0 (an image model classifies ``args.num_classes``; a ViT
    takes ``args.image_size`` images)."""
    from .. import models

    size = ({"vocab": args.vocab} if args.model in LM_MODELS
            else {"num_classes": args.num_classes})
    if args.model in VIT_MODELS:
        size["image_size"] = args.image_size
    return getattr(models, args.model)(**size, device=device, seed=0,
                                       **kwargs)


def _model_kwargs(args) -> dict:
    """The attention core and architecture flags, validated as the
    driver validates them: they apply to ``lm_*`` models only (an image
    model's attention, a ViT's, is the dense core, as in the JAX CLI)."""
    from ..ops import attention_core, validate_window

    kw = {}
    is_lm = args.model in LM_MODELS
    if args.attn_block is not None and args.attn == "dense":
        raise SystemExit("--attn-block only applies with --attn "
                         "blockwise|flash")
    if args.attn_block is not None and args.attn_block <= 0:
        raise SystemExit(f"--attn-block must be > 0, got {args.attn_block}")
    for flag, given in (("--window", args.window is not None),
                        ("--attn", args.attn != "dense"),
                        ("--kv-heads", args.kv_heads is not None)):
        if given and not is_lm:
            raise SystemExit(f"{flag} only applies to lm_* models")
    if (args.norm != "layernorm" or args.mlp != "gelu") and not is_lm:
        raise SystemExit("--norm/--mlp only apply to lm_* models")
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
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    plan = _install_fault_plan(args.fault_plan)
    try:
        return _run(args)
    finally:
        if plan is not None:
            from .. import faults

            faults.clear_plan()


def _install_fault_plan(spec):
    """``--fault-plan``'s plan, installed, or ``None``."""
    if not spec:
        return None
    import json

    from .. import faults

    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    try:
        plan = faults.FaultPlan.from_spec(json.loads(spec))
    except (ValueError, TypeError) as e:
        raise SystemExit(f"--fault-plan: {e}")
    return faults.install_plan(plan)


def _run(args):
    from ..device import resolve_device

    device = resolve_device(args.device)
    dataset, val_dataset = _dataset(args)
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
        return _train(args, dataset, val_dataset, device, mesh)
    finally:
        if formed:
            from ..mesh import shutdown_distributed

            shutdown_distributed()


def _dataset(args):
    """The ``--dataset`` for the ``--model``'s kind (images for an image
    model, tokens for an LM; the other kind is refused, as the JAX
    package's ``bin/driver.py`` refuses it) and the ``--val-dataset``, or
    ``None``.  A registered dataset's kind is its driver's, checked
    before it is opened."""
    from .. import data

    if args.data_toml:
        data.load_registry(args.data_toml)
    if args.final_eval and args.val_dataset is None:
        raise SystemExit("--final-eval needs --val-dataset")
    is_lm = args.model in LM_MODELS
    name = args.dataset or ("synthetic-text" if is_lm else "synthetic")
    if name.startswith("cifar:"):
        # the port's alias: a cifar10 registry entry for PATH
        data.register_dataset(name, "cifar10", path=name[len("cifar:"):])
    if name in ("synthetic", "synthetic-text") or name.startswith("text:"):
        tokens = name != "synthetic"
    else:
        try:
            tokens = data.driver_of(name) == "text"
        except KeyError as e:
            raise SystemExit(f"--dataset {name}: {e.args[0]}")
    if is_lm and not tokens:
        raise SystemExit(f"--model {args.model} trains on tokens; use "
                         "--dataset synthetic-text or text:PATH")
    if tokens and not is_lm:
        raise SystemExit(f"--dataset {name} is a token stream; use an lm_* "
                         f"model (--model {args.model} classifies images: "
                         "--dataset synthetic or a registered image "
                         "dataset)")
    try:
        val = (data.open_dataset(args.val_dataset) if args.val_dataset
               else None)
    except KeyError as e:
        raise SystemExit(f"--val-dataset {args.val_dataset}: {e.args[0]}")
    if name == "synthetic-text":
        ds = data.SyntheticTextDataset(vocab=args.vocab, seqlen=args.seqlen)
    elif name.startswith("text:"):
        ds = data.ByteTextDataset(name[len("text:"):], seqlen=args.seqlen)
        args.vocab = ds.vocab
    elif name == "synthetic":
        ds = data.SyntheticDataset(
            nsamples=max(args.batch_size * 8, 1024),
            nclasses=args.num_classes or 1000,
            shape=(args.image_size, args.image_size, 3))
    else:
        ds = data.open_dataset(name)
    if not tokens:
        args.num_classes = args.num_classes or ds.nclasses
    return ds, val


def _train(args, dataset, val_dataset, device, mesh):
    import torch

    from .. import optim
    from ..models import lm_loss_fn
    from .logging import ConsoleLogger, NullLogger
    from .trainer import evaluate, prepare_training, train

    is_lm = args.model in LM_MODELS
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
            model, dataset, opt, loss_fn=lm_loss_fn(model) if is_lm else None,
            batch_size=args.batch_size, epochs=args.epochs,
            cycles=args.cycles, spmd=args.spmd, zero1=args.zero1, mesh=mesh,
            device=device, steps_per_call=args.steps_per_call,
            val_dataset=val_dataset)
    except ValueError as e:  # e.g. a batch that does not split over ranks
        raise SystemExit(f"--spmd {args.spmd}: {e}")
    lead = mesh is None or mesh.rank == 0
    if args.resume:
        from .trainer import resume_training

        manifest = resume_training(task, args.checkpoint_dir)
        if lead and (manifest is not None or task.state.step):
            src = ("RESUME manifest" if manifest is not None
                   else "latest checkpoint (no manifest)")
            print(f"resumed from step {task.state.step} at item "
                  f"{task.loader.start} via {src}", flush=True)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ranks = "" if mesh is None else (
        f", {mesh.size} rank(s) ({torch.distributed.get_backend()})"
        f"{', zero1' if args.zero1 else ''}")
    if lead:
        print(f"device: {device} ({name}){ranks}, model {args.model} "
              f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"params, {str(model.dtype).split('.')[-1]})"
              + (f", attn {args.attn}" if is_lm else
                 f", {args.num_classes} classes"), flush=True)
    train(task, print_every=args.print_every, eval_every=args.eval_every,
          logger=ConsoleLogger() if lead else NullLogger(),
          checkpoint_dir=args.checkpoint_dir,
          checkpoint_every=args.checkpoint_every, handle_signals=True)
    if args.final_eval:
        metrics = evaluate(task, val_dataset, batch_size=args.batch_size,
                           topk=() if is_lm else (1, 5, 10))
        if lead:
            parts = ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items())
            print(f"final eval: {parts}", flush=True)
    if lead:
        print(f"done: {task.state.step} steps, {task.num_missed} missed",
              flush=True)
    return task


def main(argv=None) -> int:
    """:func:`run`, with the exit code: 0 when done, ``PREEMPTED_RC``
    (75) when a signal checkpointed the run and stopped it."""
    from ..faults import PREEMPTED_RC, Preempted

    try:
        run(argv)
    except Preempted as e:
        if int(os.environ.get("RANK", "0")) == 0:
            print(f"preempted: {e} — resume with --resume "
                  f"--checkpoint-dir {e.checkpoint_dir} "
                  f"(exit code {PREEMPTED_RC})", flush=True)
        return PREEMPTED_RC
    return 0


if __name__ == "__main__":
    sys.exit(main())
