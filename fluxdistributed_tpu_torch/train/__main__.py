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

Models too big for one replica shard: ``--spmd fsdp`` shards every
large parameter and optimizer-state leaf over the ranks (ZeRO-3),
``--spmd tp --tp K`` makes an LM or a ViT Megatron tensor-parallel over
``{data: N/K, model: K}`` (K defaults to every rank and must divide
them), ``--spmd fsdp_tp --tp K`` (K below the rank count) also shards
each leaf's leftover dim over ``data``, and ``--layout NAME`` (``dp``,
``fsdp``, ``tp``, ``dp_fsdp``, ``fsdp_tp``, ``dp_fsdp_tp``) shards by
the rules engine over a ``(data, fsdp, model)`` mesh, with ``--spmd
jit``.  Each runs as one rank on one card too, and across cards under
``torchrun``::

    torchrun --nproc-per-node 4 -m fluxdistributed_tpu_torch.train \
        --model lm_small --dataset synthetic-text --seqlen 1024 \
        --batch-size 8 --attn flash --opt adam --lr 3e-4 --cycles 40 \
        --spmd fsdp_tp --tp 2

``--layout auto`` (the picker), ``--hbm-bytes`` and ``--layout-report``
come with slice 7 and raise ``NotImplementedError``.

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
``'{"sigterm_at_step": 3}'``.

``--guard`` arms the anomaly guard (:mod:`.guard`): the step carries the
sentinel, an anomalous batch is quarantined and skipped, persisting
anomalies roll back to the last checkpoint of ``--checkpoint-dir``, and
a rollback loop halts with exit code 65 (``faults.HALTED_RC``: not
retryable).  ``--guard-zmax``, ``--guard-window`` and
``--guard-rollback-after`` tune it; ``--replay-step K`` re-runs loader
item K (after ``--resume``, from the checkpoint) under
``torch.autograd.detect_anomaly``, prints one JSON report and exits::

    python -m fluxdistributed_tpu_torch.train ... --checkpoint-dir ck \
        --guard --fault-plan '{"fail": [{"site": "train.loss", "at": 2,
        "action": "nan"}]}'
    python -m fluxdistributed_tpu_torch.train ... --checkpoint-dir ck \
        --guard --resume --replay-step 2

The observation flags are ``bin/driver.py``'s: ``--metrics-port``
serves ``/metrics`` and ``/healthz`` (the watchdog's stall, the
guard's quarantine) for the run, ``--trace-events`` writes a Chrome
trace of the phase spans (and syncs the card each item),
``--metrics-jsonl`` appends registry snapshots, ``--flight`` keeps the
flight recorder, ``--runs-ledger`` appends a run record on every exit,
``--watchdog-factor`` / ``--watchdog-escalate`` set the stall
watchdog, ``--wandb`` logs to Weights & Biases and ``--verbose`` logs
more.  The JAX CLI's context, pipeline and expert ``--spmd`` modes,
``--profile-out``, ``--steady-after``, ``--compile-cache``, ``--aot``,
``--prewarm`` and ``--strict-checks`` belong to later slices and are not
accepted.
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
                   choices=["jit", "dp", "shard_map", "fsdp", "tp",
                            "fsdp_tp"],
                   help="parallel mode: jit/dp (one device, or DP across "
                        "torchrun ranks), shard_map (the explicit per-rank "
                        "step), fsdp (ZeRO-3: params and optimizer state "
                        "sharded over the ranks), tp (Megatron tensor "
                        "parallelism over a model axis of --tp ranks) or "
                        "fsdp_tp (both); the JAX CLI's context, pipeline "
                        "and expert modes are not ported")
    p.add_argument("--layout", default=None, metavar="NAME|auto",
                   help="declarative dp x fsdp x tp layout "
                        "(parallel/layout.py): a preset name (dp, fsdp, tp, "
                        "dp_fsdp, fsdp_tp, dp_fsdp_tp) shards the model "
                        "from its committed rule table + the fsdp overlay; "
                        "'auto' (the picker) comes with slice 7.  Keep "
                        "--spmd jit (default)")
    p.add_argument("--hbm-bytes", type=float, default=None,
                   help="per-device HBM budget for --layout auto (slice 7)")
    p.add_argument("--layout-report", default=None, metavar="PATH",
                   help="the layout picker's report for --layout auto "
                        "(slice 7)")
    p.add_argument("--tp", type=int, default=None,
                   help="model-axis size for --spmd tp / fsdp_tp (the mesh "
                        "becomes {data: N/tp, model: tp}; required for "
                        "fsdp_tp, defaults to all ranks for tp)")
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
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="log to Weights & Biases")
    # observability (fluxdistributed_tpu_torch.obs)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve GET /metrics (Prometheus text: step counter, "
                        "per-phase histograms, OOM skips, prefetch depth, "
                        "HBM gauges, guard counters) and GET /healthz on "
                        "this port for the duration of the run (rank 0 "
                        "only)")
    p.add_argument("--trace-events", default=None, metavar="PATH",
                   help="record nested step-phase spans (data_wait/h2d/"
                        "dispatch/device/eval/checkpoint) and write "
                        "Chrome/Perfetto trace-event JSON here at exit; "
                        "implies a device sync each item so device time is "
                        "honestly attributed")
    p.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="append registry snapshots (JSON lines) here at the "
                        "print cadence — offline run diffing without a "
                        "Prometheus server")
    p.add_argument("--flight", default=None, metavar="PATH",
                   help="black-box flight recorder (obs.flight): append "
                        "per-step records (step, loss, guard verdict, "
                        "phase seconds, headroom) here, flushed + "
                        "checkpointed every few records — a SIGKILL "
                        "loses at most one flush interval, and the dump "
                        "footer (or its absence) says how the run ended")
    p.add_argument("--runs-ledger", default=None, metavar="PATH",
                   help="append one cross-run ledger record (obs.runs "
                        "schema: status, topology fingerprint, steps, "
                        "flight-dump path) here on every exit path")
    p.add_argument("--watchdog-factor", type=float, default=5.0,
                   help="stall watchdog threshold as a multiple of the "
                        "rolling-median step time (warns + flips /healthz "
                        "to 503 when no step lands inside it; eval and "
                        "checkpoint phases are exempt). 0 disables the "
                        "watchdog")
    p.add_argument("--watchdog-escalate", type=int, default=4, metavar="N",
                   help="after a stall persists N further threshold "
                        "windows with no step, count a watchdog "
                        "ESCALATION (fdtpu_watchdog_escalations_total). "
                        "0 disables escalation")
    # the anomaly guard (train/guard.py)
    p.add_argument("--guard", action="store_true",
                   help="self-healing training: build the anomaly sentinel "
                        "into the train step (global isfinite over "
                        "loss+grads and the global grad norm, ONE extra "
                        "scalar fetch per item) and arm the policy ladder "
                        "— quarantine-and-skip anomalous batches, roll "
                        "back to the last checkpoint when anomalies "
                        "persist, halt (exit rc 65, not retryable) when "
                        "rollbacks loop.  Decisions are recorded in the "
                        "RESUME manifest and as fdtpu_guard_* metrics")
    p.add_argument("--guard-zmax", type=float, default=8.0,
                   help="robust z-score above which a finite loss counts "
                        "as a spike anomaly")
    p.add_argument("--guard-window", type=int, default=64,
                   help="rolling window (accepted losses) behind the "
                        "spike detector's median/MAD")
    p.add_argument("--guard-rollback-after", type=int, default=3,
                   help="anomalies within the guard's anomaly window "
                        "that escalate skip -> rollback")
    p.add_argument("--replay-step", type=int, default=None, metavar="K",
                   help="diagnosis harness: instead of training, re-run "
                        "loader item K deterministically against the "
                        "prepared — or, with --resume, the restored — "
                        "state under torch.autograd.detect_anomaly, print "
                        "one JSON report line and exit")
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
    loss), or with ``--replay-step`` the replay's report.  ``main`` is
    this plus an exit code."""
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
    # a process group for ZeRO-1, the shard_map step, the sharded modes,
    # or torchrun's ranks; one this call forms, it also ends
    mesh, formed = None, False
    if (args.zero1 or args.spmd in ("shard_map", "fsdp", "tp", "fsdp_tp")
            or args.layout is not None or "WORLD_SIZE" in os.environ):
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
    from .trainer import evaluate, prepare_training, train

    is_lm = args.model in LM_MODELS
    ndev = 1 if mesh is None else mesh.size
    if (args.kv_heads is not None and args.spmd in ("tp", "fsdp_tp")
            and not (args.spmd == "fsdp_tp" and args.tp is None)):
        # the rules head-shard the kv projection: the model axis must
        # divide the KV head count (fsdp_tp without --tp is refused below)
        model_k = args.tp if args.tp is not None else ndev
        if args.kv_heads % model_k:
            raise SystemExit(
                f"--kv-heads {args.kv_heads} must be a multiple of the TP "
                f"model-axis size ({model_k}) so the grouped kv projection "
                "can be head-sharded")
    try:
        model = build_model(args, device, **_model_kwargs(args))
    except ValueError as e:  # e.g. --kv-heads not dividing num_heads
        raise SystemExit(f"--model {args.model}: {e}")

    lr = args.lr
    if args.total_steps:
        lr = optim.warmup_cosine(args.lr, args.warmup_steps, args.total_steps)
    opt = getattr(optim, args.opt)(lr)
    mesh, layout = _sharded_mesh(args, mesh, ndev)
    lead = mesh is None or mesh.rank == 0
    # the sentinel rides dp.make_train_step; shard_map runs the guard's
    # policy on the loss alone, as bin/driver.py degrades it
    sentinel = args.guard and args.spmd in ("jit", "dp")
    if args.guard and not sentinel and lead:
        print(f"guard: spmd={args.spmd} has no compiled grad sentinel — "
              "running loss-only (non-finite loss + spike detection; "
              "gradient blow-ups that keep the loss finite pass unseen)",
              flush=True)
    try:
        task = prepare_training(
            model, dataset, opt, loss_fn=lm_loss_fn(model) if is_lm else None,
            batch_size=args.batch_size, epochs=args.epochs,
            cycles=args.cycles, spmd=args.spmd, zero1=args.zero1, mesh=mesh,
            device=device, steps_per_call=args.steps_per_call,
            val_dataset=val_dataset, guard=sentinel, layout=layout)
    except ValueError as e:  # e.g. a batch that does not split over ranks
        raise SystemExit(f"--spmd {args.spmd}: {e}")
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
        f", {mesh.size} rank(s) ({torch.distributed.get_backend()}), mesh "
        f"{mesh.shape}{', zero1' if args.zero1 else ''}"
        f"{f', spmd {args.spmd}' if args.spmd not in ('jit', 'dp') else ''}"
        f"{f', layout {layout.describe()}' if layout is not None else ''}")
    if lead:
        print(f"device: {device} ({name}){ranks}, model {args.model} "
              f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
              f"params, {str(model.dtype).split('.')[-1]})"
              + (f", attn {args.attn}" if is_lm else
                 f", {args.num_classes} classes"), flush=True)
    if args.replay_step is not None:
        import json

        from .guard import replay_item

        # one item re-run from the checkpoint and cursor for diagnosis:
        # never trains, never writes the state
        report = replay_item(task, args.replay_step)
        if lead:
            print(json.dumps(report), flush=True)
        return report
    _observed_train(args, task, mesh, lead, is_lm, train)
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


def _sharded_mesh(args, mesh, ndev):
    """The mesh and the layout of ``--spmd tp|fsdp_tp`` / ``--layout``,
    with ``bin/driver.py``'s checks and messages; otherwise ``mesh`` as
    it is and no layout."""
    if args.tp is not None and args.spmd not in ("tp", "fsdp_tp"):
        raise SystemExit("--tp only applies with --spmd tp or fsdp_tp")
    if args.zero1 and args.spmd not in ("jit", "dp", "shard_map"):
        raise SystemExit("--zero1 only applies with --spmd jit/dp/shard_map "
                         "(fsdp already shards the optimizer state)")
    if args.layout is not None:
        if args.spmd not in ("jit", "dp"):
            raise SystemExit("--layout builds the rule-derived 3-D step "
                             "and needs --spmd jit (the default)")
        if args.zero1:
            raise SystemExit("--layout cannot combine with --zero1 (a "
                             "layout's fsdp axis already shards the "
                             "optimizer state)")
    if ((args.hbm_bytes is not None or args.layout_report)
            and args.layout != "auto"):
        raise SystemExit("--hbm-bytes/--layout-report only apply with "
                         "--layout auto")
    if args.spmd in ("tp", "fsdp_tp"):
        from ..mesh import make_mesh

        if args.spmd == "fsdp_tp" and (args.tp is None or args.tp >= ndev):
            raise SystemExit(
                "--spmd fsdp_tp needs --tp < device count: with no data-axis "
                "extent there is nothing for FSDP to shard over")
        k = args.tp if args.tp is not None else ndev
        if k < 1 or ndev % k:
            raise SystemExit(f"--tp {k} must be >=1 and divide {ndev} "
                             "devices")
        return make_mesh({"data": ndev // k, "model": k},
                         device=mesh.device), None
    if args.layout is not None:
        from ..parallel import layout as layout_lib

        try:
            chosen = layout_lib.resolve_layout(args.layout, ndev)
        except layout_lib.LayoutError as e:
            raise SystemExit(f"--layout {args.layout}: {e}")
        return chosen.build_mesh(device=mesh.device), chosen
    return mesh, None


def _logger(args, task, mesh, lead):
    """``--wandb``'s logger with the run configuration, else console
    records on rank 0 (every rank with ``--verbose``)."""
    from .logging import ConsoleLogger, NullLogger, WandbLogger

    if args.wandb:
        config = dict(sorted(vars(args).items()))
        config.update(device=str(task.device),
                      ranks=1 if mesh is None else mesh.size)
        return WandbLogger(project="fluxdistributed_tpu", config=config)
    return ConsoleLogger() if (lead or args.verbose) else NullLogger()


def _observed_train(args, task, mesh, lead, is_lm, train) -> None:
    """``train`` with the observation layer, the guard and the endpoints
    the flags ask for, and a run-ledger record on every exit."""
    import time

    from ..obs import (Observation, SpanTracer, StepWatchdog, get_registry,
                       runs, start_metrics_server)
    from .guard import GuardConfig

    reg = get_registry()
    observation = Observation(
        tracer=SpanTracer() if args.trace_events else None,
        watchdog=(StepWatchdog(factor=args.watchdog_factor,
                               escalate_after=args.watchdog_escalate)
                  if args.watchdog_factor else None),
        trace_path=args.trace_events,
        device_sync=bool(args.trace_events),
        jsonl_path=args.metrics_jsonl, flight_path=args.flight)
    server = None
    if args.metrics_port is not None and lead:
        def health():
            return {
                "ok": reg.value("fdtpu_watchdog_stalled") < 1,
                "steps": reg.value("fdtpu_train_steps_total"),
                "oom_skipped": reg.value("fdtpu_train_oom_skipped_total"),
                "escalations": reg.value("fdtpu_watchdog_escalations_total"),
                "quarantined": reg.value("fdtpu_guard_quarantine_size"),
            }

        server = start_metrics_server(port=args.metrics_port,
                                      health_fn=health)
        print(f"metrics: http://0.0.0.0:{server.port}/metrics (+ /healthz)",
              flush=True)
    guard = None
    if args.guard:
        guard = GuardConfig(zmax=args.guard_zmax, window=args.guard_window,
                            rollback_after=args.guard_rollback_after)
    t0 = time.monotonic()

    def ledger(status, error=None, retryable=None):
        """This run's row of the cross-run ledger; best-effort, it never
        changes an exit code."""
        if not args.runs_ledger or not lead:
            return
        try:
            wall = max(time.monotonic() - t0, 1e-9)
            steps = reg.value("fdtpu_train_steps_total")
            runs.append_run(args.runs_ledger, runs.run_record(
                "train", fingerprint=runs.topology_fingerprint(mesh),
                phase="train", retryable=retryable, error=error,
                metrics={"steps": steps, "steps_per_sec": steps / wall,
                         "wall_seconds": wall,
                         "oom_skipped": reg.value(
                             "fdtpu_train_oom_skipped_total")},
                flight=args.flight, status=status))
        except Exception as e:  # noqa: BLE001
            print(f"runs ledger append failed: {type(e).__name__}: {e}",
                  file=sys.stderr)

    from .. import faults
    from .guard import GuardHalt

    try:
        train(task, print_every=args.print_every, eval_every=args.eval_every,
              topk=() if is_lm else (1, 5, 10),
              logger=_logger(args, task, mesh, lead),
              checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, verbose=args.verbose,
              observation=observation, handle_signals=True, guard=guard)
    except GuardHalt as e:
        ledger("halted", error=str(e), retryable=False)
        raise
    except faults.Preempted as e:
        ledger("preempted", error=str(e), retryable=True)
        raise
    except BaseException as e:
        ledger("crashed", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        if server is not None:
            server.stop()
    ledger("done")


def main(argv=None) -> int:
    """:func:`run`, with the exit code: 0 when done, ``PREEMPTED_RC``
    (75) when a signal checkpointed the run and stopped it,
    ``HALTED_RC`` (65, not retryable) when the guard halted it."""
    from ..faults import HALTED_RC, PREEMPTED_RC, Preempted
    from .guard import GuardHalt

    lead = int(os.environ.get("RANK", "0")) == 0
    try:
        run(argv)
    except GuardHalt as e:
        if lead:
            print(f"guard halt: {e} (exit code {HALTED_RC}, retryable: "
                  "false)", flush=True)
        return HALTED_RC
    except Preempted as e:
        if lead:
            print(f"preempted: {e} — resume with --resume "
                  f"--checkpoint-dir {e.checkpoint_dir} "
                  f"(exit code {PREEMPTED_RC})", flush=True)
        return PREEMPTED_RC
    return 0


if __name__ == "__main__":
    sys.exit(main())
