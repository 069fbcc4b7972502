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
BatchNorm statistics are those of the global batch).  ``bin/driver.py``'s
cluster flags start the processes by hand, one per host or device
(:mod:`..parallel.multihost`)::

    python -m fluxdistributed_tpu_torch.train ... \
        --coordinator host0:29500 --num-processes 2 --process-id $I

(``--platform cpu|gpu`` is ``--device cpu|cuda``; ``--platform tpu``
and ``--local-devices`` other than 1 are refused.)  Only process 0
logs, serves ``--metrics-port``, writes the observation files and the
checkpoints; every process ends at one barrier.  ``--steps-per-call
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

``--layout auto`` runs the layout picker (``parallel.layout.pick``):
every candidate layout's real step is priced once on fake tensors over a
fake world of the run's ranks (before the group forms in one process;
in a child process of the coordinator under a group of several), and
the fastest one that fits
``--hbm-bytes`` (default: the card's total memory) trains;
``--layout-report PATH`` writes the ranking::

    python -m fluxdistributed_tpu_torch.train --model lm_small \
        --dataset synthetic-text --seqlen 1024 --batch-size 8 --attn flash \
        --opt adam --lr 3e-4 --cycles 3 --layout auto --layout-report r.json

Long sequences and MoE models: ``--spmd sp --seq-parallel K`` cuts each
sequence over a ``seq`` axis of K ranks (``{data: N/K, seq: K}``; the LM
attends through ring attention, or Ulysses with ``--sp-strategy
ulysses``), and ``--spmd ep --expert-parallel K`` makes every
``--moe-every``-th block (default 2) a routed MoE layer of
``--experts`` experts (default K) split over an ``expert`` axis of K
ranks (``{data: N/K, expert: K}``; capacity factor 2.0, routed within
each data row).  Both need two ranks at least, as ``bin/driver.py``
needs two devices::

    torchrun --nproc-per-node 4 -m fluxdistributed_tpu_torch.train \
        --model lm_small --dataset synthetic-text --seqlen 1024 \
        --batch-size 8 --opt adam --lr 3e-4 --cycles 40 \
        --spmd sp --seq-parallel 2 --sp-strategy ulysses

Pipelines: ``--spmd pp`` (GPipe) and ``--spmd pp_1f1b`` (the
hand-written 1F1B schedule, ``--pp-schedule zb`` its zero-bubble
variant, ``--pp-interleave`` the Megatron interleaved placement) stage
an LM's blocks over a ``pipe`` axis of ``--pipe`` ranks (``{data:
N/pipe, pipe: pipe}``, all ranks by default) with ``--microbatches``
microbatches a step (default 2 x pipe); ``--pp-plan`` places the stage
boundaries (``parallel.pp_plan``): ``auto`` from the model's block costs
priced on fake tensors, or a saved plan or a cost-profile artifact
(``--profile-out``) by path.  ``--spmd pp --pipe 1`` runs the
GPipe schedule on one card; 1F1B needs two pipe ranks::

    torchrun --nproc-per-node 4 -m fluxdistributed_tpu_torch.train \
        --model lm_small --dataset synthetic-text --seqlen 1024 \
        --batch-size 8 --attn flash --opt adam --lr 3e-4 --cycles 40 \
        --spmd pp_1f1b --pipe 2 --microbatches 4 --pp-schedule zb

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
more, and ``--profile-out PATH`` writes the run's cost profile
(``obs.profile``: the static costs of the model and of the step at the
run's shapes, priced on fake tensors, the step's priced memory and
collective ledger, the measured phase histograms) when training ends.
The JAX CLI's ``--steady-after``, ``--compile-cache``, ``--aot``,
``--prewarm`` and ``--strict-checks`` belong to a later slice and are
not accepted.
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
                            "fsdp_tp", "pp", "pp_1f1b", "sp", "ep"],
                   help="parallel mode: jit/dp (one device, or DP across "
                        "torchrun ranks), shard_map (the explicit per-rank "
                        "step), fsdp (ZeRO-3: params and optimizer state "
                        "sharded over the ranks), tp (Megatron tensor "
                        "parallelism over a model axis of --tp ranks), "
                        "fsdp_tp (both), pp / pp_1f1b (an LM's blocks "
                        "pipelined over --pipe ranks: GPipe, or the "
                        "hand-written 1F1B schedule), sp (context "
                        "parallelism: the sequence cut over --seq-parallel "
                        "ranks) or ep (MoE experts over --expert-parallel "
                        "ranks)")
    p.add_argument("--pipe", type=int, default=None,
                   help="pipe-axis size for --spmd pp / pp_1f1b (the mesh "
                        "becomes {data: N/pipe, pipe: pipe}; defaults to "
                        "all ranks, i.e. data=1)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="pipeline microbatches per step (default 2x pipe "
                        "size; the (S-1)/(M+S-1) bubble shrinks as M grows)")
    p.add_argument("--pp-interleave", action="store_true",
                   help="Megatron interleaved virtual stages for --spmd "
                        "pp_1f1b (depth/pipe chunks per device; ~V-fold "
                        "smaller fill/drain bubble)")
    p.add_argument("--pp-schedule", default="1f1b", choices=["1f1b", "zb"],
                   help="pipeline timetable for --spmd pp_1f1b: classic "
                        "1F1B, or 'zb' (zero-bubble ZB-H1: each backward "
                        "splits into input-grad + deferred weight-grad "
                        "ticks and the weight-grad work fills the drain "
                        "bubble; bit-identical gradients)")
    p.add_argument("--pp-plan", default=None, metavar="PATH|auto",
                   help="stage placement for --spmd pp/pp_1f1b: PATH loads "
                        "a saved plan JSON (parallel.pp_plan; non-uniform "
                        "stage boundaries, which also lift the depth %% "
                        "pipe divisibility requirement; a plan from "
                        "another topology is refused), or a cost-profile "
                        "artifact (--profile-out output) planned here; "
                        "'auto' prices the model's blocks on fake tensors "
                        "for fresh costs")
    p.add_argument("--seq-parallel", type=int, default=None,
                   help="seq-axis size for --spmd sp (the mesh becomes "
                        "{data: N/sp, seq: sp}; the LM attends across the "
                        "sequence shards; defaults to all ranks)")
    p.add_argument("--sp-strategy", default="ring",
                   choices=["ring", "ulysses"],
                   help="context-parallel attention for --spmd sp: 'ring' "
                        "(K/V blocks passed around the seq ranks, any head "
                        "count) or 'ulysses' (two all_to_alls re-shard "
                        "seq<->heads; needs num_heads %% seq-axis == 0)")
    p.add_argument("--expert-parallel", type=int, default=None,
                   help="expert-axis size for --spmd ep (the mesh becomes "
                        "{data: N/ep, expert: ep}; defaults to all ranks)")
    p.add_argument("--experts", type=int, default=None,
                   help="number of MoE experts for --spmd ep (a multiple of "
                        "the expert axis; defaults to the axis size)")
    p.add_argument("--moe-every", type=int, default=None,
                   help="route every K-th decoder block through the MoE "
                        "layer (--spmd ep; default 2)")
    p.add_argument("--layout", default=None, metavar="NAME|auto",
                   help="declarative dp x fsdp x tp layout "
                        "(parallel/layout.py): a preset name (dp, fsdp, tp, "
                        "dp_fsdp, fsdp_tp, dp_fsdp_tp) shards the model "
                        "from its committed rule table + the fsdp overlay; "
                        "'auto' runs the layout picker (prices every "
                        "candidate's real step on fake tensors, ranks by "
                        "headroom with the fit checker's ranking, breaks "
                        "ties by the collective ledger) and trains with the "
                        "fastest layout that fits.  Keep --spmd jit "
                        "(default)")
    p.add_argument("--hbm-bytes", type=float, default=None,
                   help="per-device memory budget in bytes for --layout "
                        "auto (default: the card's total memory; REQUIRED "
                        "for fit verdicts without a card)")
    p.add_argument("--layout-report", default=None, metavar="PATH",
                   help="write the layout picker's report (the chosen "
                        "layout and every candidate's headroom and "
                        "ledger) as JSON here (--layout auto)")
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
    # a multi-process run (parallel/multihost.py), bin/driver.py's flags
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address: form a process group of "
                        "--num-processes processes over TCP (NCCL on the "
                        "card, gloo with --device cpu)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu", "tpu"],
                   help="bin/driver.py's platform: cpu is --device cpu, gpu "
                        "is --device cuda; tpu is refused")
    p.add_argument("--local-devices", type=int, default=None,
                   help="devices a process drives: 1 (one process drives "
                        "one device in the port)")
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
    p.add_argument("--profile-out", default=None, metavar="PATH",
                   help="write a versioned cost-profile artifact "
                        "(obs.profile schema: static per-layer and step "
                        "FLOPs and bytes priced on fake tensors, the run's "
                        "measured phase histograms, topology fingerprint) "
                        "here when training ends — what the pipeline "
                        "planner (--pp-plan PATH) consumes")
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
    model's attention, a ViT's, is the dense core, as in the JAX CLI),
    and ``--spmd sp`` picks its own attention core, unwindowed."""
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
    if args.spmd == "sp":
        if args.window is not None:
            raise SystemExit("--window is not supported with --spmd sp "
                             "(context-parallel attention is unwindowed)")
        if args.attn != "dense":
            raise SystemExit("--attn conflicts with --spmd sp: sequence "
                             "parallelism picks its own attention core "
                             "(use --sp-strategy)")
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
    from .. import faults

    return faults.install_plan_arg(spec)


def platform_device(args) -> None:
    """Fold ``bin/driver.py``'s ``--platform`` into ``--device``, and
    refuse what the port cannot run: a TPU, and more than one device a
    process."""
    if args.platform == "tpu":
        raise SystemExit("--platform tpu: the port runs on a CUDA card "
                         "(--platform gpu) or the CPU (--platform cpu)")
    local = getattr(args, "local_devices", None)
    if local is not None and local != 1:
        raise SystemExit(
            f"--local-devices {local}: in the port one process "
            "drives one device; start one process per device "
            "(--num-processes) instead")
    if args.platform is not None:
        dev = "cpu" if args.platform == "cpu" else "cuda"
        if args.device is not None and args.device.split(":")[0] != dev:
            raise SystemExit(f"--platform {args.platform} conflicts with "
                             f"--device {args.device}")
        args.device = args.device or dev


def _run(args):
    from ..device import resolve_device
    from ..parallel import multihost

    platform_device(args)
    device = resolve_device(args.device)
    cluster = args.coordinator is not None or args.num_processes is not None \
        or args.process_id is not None
    dataset, val_dataset = _dataset(args)
    if args.cycles is None and not hasattr(dataset, "__len__"):
        raise SystemExit("--cycles is required for unbounded token streams "
                         "(synthetic-text has no epoch length; text: "
                         "datasets derive cycles from --epochs)")
    _check_mode_flags(args)
    # a process group for ZeRO-1, the shard_map step, the sharded modes,
    # or torchrun's ranks; one this call forms, it also ends
    import torch.distributed as dist

    # --layout auto in one process prices here, before the run forms its
    # group: a process has one default group (under one, the
    # coordinator prices in a child process)
    layout_rows = None
    if (args.layout == "auto" and not cluster and not dist.is_initialized()
            and "WORLD_SIZE" not in os.environ):
        from ..parallel import layout as layout_lib

        model, shapes, opt, loss = pricing_inputs(
            args, _batch_shapes(args, dataset))
        layout_rows = layout_lib.price_layouts(
            model, shapes, opt, loss_fn=loss, ndev=1, device=device)

    mesh, formed = None, False
    if cluster:
        formed = not dist.is_initialized()
        try:
            mesh = multihost.initialize(args.coordinator, args.num_processes,
                                        args.process_id, device=device)
        except ValueError as e:
            raise SystemExit(f"--coordinator/--num-processes/--process-id: "
                             f"{e}")
        device = mesh.device
    elif (args.zero1 or args.spmd in ("shard_map", "fsdp", "tp", "fsdp_tp",
                                      "sp", "ep", "pp", "pp_1f1b")
            or args.layout is not None or "WORLD_SIZE" in os.environ
            or dist.is_initialized()):
        from ..mesh import init_distributed

        formed = not dist.is_initialized()
        mesh = init_distributed(device)
        device = mesh.device
    try:
        task = _train(args, dataset, val_dataset, device, mesh, layout_rows)
        if mesh is not None and args.replay_step is None:
            # every process ends its run together
            multihost.sync_global_devices("train_done")
            if mesh.rank == 0:
                print(f"done: {task.state.step} steps, {task.num_missed} "
                      "missed", flush=True)
        return task
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


def _train(args, dataset, val_dataset, device, mesh, layout_rows=None):
    import torch

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
    mesh, mode_kw = _context_mesh(args, mesh, ndev, is_lm)
    try:
        model = build_model(args, device, **_model_kwargs(args), **mode_kw)
    except ValueError as e:  # e.g. --kv-heads not dividing num_heads
        raise SystemExit(f"--model {args.model}: {e}")

    opt = _optimizer(args)
    mesh, layout = _sharded_mesh(args, mesh, ndev, dataset, layout_rows)
    lead = mesh is None or mesh.rank == 0
    pp_kw = _pipeline_kwargs(args, model, mesh, ndev, lead)
    if pp_kw:
        mesh = pp_kw.pop("mesh")
    # the sentinel rides dp.make_train_step; shard_map runs the guard's
    # policy on the loss alone, as bin/driver.py degrades it
    sentinel = args.guard and args.spmd in ("jit", "dp", "sp", "ep", "pp")
    if args.guard and not sentinel and lead:
        print(f"guard: spmd={args.spmd} has no compiled grad sentinel — "
              "running loss-only (non-finite loss + spike detection; "
              "gradient blow-ups that keep the loss finite pass unseen)",
              flush=True)
    try:
        # the pipeline modes train on their own per-microbatch loss
        task = prepare_training(
            model, dataset, opt,
            loss_fn=lm_loss_fn(model) if is_lm and not pp_kw else None,
            batch_size=args.batch_size, epochs=args.epochs,
            cycles=args.cycles, spmd=args.spmd, zero1=args.zero1, mesh=mesh,
            device=device, steps_per_call=args.steps_per_call,
            val_dataset=val_dataset, guard=sentinel, layout=layout, **pp_kw)
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
    if lead and (args.coordinator is not None
                 or "WORLD_SIZE" in os.environ):
        # bin/driver.py's banner: a process drives one device here
        world = torch.distributed.get_world_size()
        print(f"devices: {world} (1/host x {world} hosts), platform "
              f"{'gpu' if device.type == 'cuda' else 'cpu'}, mesh "
              f"{mesh.shape}", flush=True)
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
    if lead and mesh is None:
        print(f"done: {task.state.step} steps, {task.num_missed} missed",
              flush=True)
    return task


def _check_mode_flags(args) -> None:
    """The mode flags that apply to one ``--spmd`` only
    (``bin/driver.py``'s checks and messages)."""
    if (args.expert_parallel is not None or args.experts is not None
            or args.moe_every is not None) and args.spmd != "ep":
        raise SystemExit(
            "--expert-parallel/--experts/--moe-every only apply with --spmd ep")
    if args.seq_parallel is not None and args.spmd != "sp":
        raise SystemExit("--seq-parallel only applies with --spmd sp")
    if args.sp_strategy != "ring" and args.spmd != "sp":
        raise SystemExit("--sp-strategy only applies with --spmd sp")
    if args.pipe is not None and args.spmd not in ("pp", "pp_1f1b"):
        raise SystemExit("--pipe only applies with --spmd pp or pp_1f1b")
    if args.microbatches is not None and args.spmd not in ("pp", "pp_1f1b"):
        raise SystemExit(
            "--microbatches only applies with --spmd pp or pp_1f1b")
    if args.pp_interleave and args.spmd != "pp_1f1b":
        raise SystemExit("--pp-interleave only applies with --spmd pp_1f1b")
    if args.pp_schedule != "1f1b" and args.spmd != "pp_1f1b":
        raise SystemExit("--pp-schedule zb only applies with --spmd pp_1f1b")
    if args.pp_plan is not None and args.spmd not in ("pp", "pp_1f1b"):
        raise SystemExit("--pp-plan only applies with --spmd pp or pp_1f1b")
    if args.pp_plan is not None and args.pp_interleave:
        raise SystemExit("--pp-plan cannot combine with --pp-interleave "
                         "(planner boundaries are contiguous block ranges)")


def _data_x_mesh(mesh, ndev: int, axis: str, flag: str, requested,
                 min_k: int = 2):
    """``bin/driver.py``'s ``data_x_mesh``: the ``{data: N/k, axis: k}``
    mesh over the ranks, ``k`` defaulting to all of them."""
    from ..mesh import make_mesh

    k = requested if requested is not None else ndev
    if k < min_k or ndev % k:
        raise SystemExit(
            f"{flag} {k} must be >={min_k} and divide {ndev} devices")
    return make_mesh({"data": ndev // k, axis: k}, device=mesh.device), k


def _context_mesh(args, mesh, ndev: int, is_lm: bool):
    """The mesh and the model arguments of ``--spmd sp|ep``, built
    before the model (its ``attn_fn`` or ``moe_fn`` is bound to the
    mesh), with ``bin/driver.py``'s checks and messages; otherwise ``mesh`` as
    it is and no arguments."""
    if args.spmd == "sp":
        from ..parallel import make_ring_attention, make_ulysses_attention

        if not is_lm:
            raise SystemExit("--spmd sp needs an lm_* model (context-"
                             "parallel attention over the sequence)")
        sp_mesh, sp = _data_x_mesh(mesh, ndev, "seq", "--seq-parallel",
                                   args.seq_parallel)
        if args.seqlen % sp:
            raise SystemExit(f"--seqlen {args.seqlen} must be a multiple of "
                             f"the seq axis size {sp}")
        make_attn = make_ring_attention
        if args.sp_strategy == "ulysses":
            # Ulysses re-shards heads over the seq axis: probe the
            # factory's head count without allocating its weights
            import torch

            with torch.device("meta"):
                nheads = build_model(args, "meta").num_heads
            if nheads % sp:
                raise SystemExit(
                    f"--sp-strategy ulysses needs num_heads ({nheads} for "
                    f"{args.model}) divisible by the seq axis size {sp}; "
                    f"use --seq-parallel accordingly or --sp-strategy ring")
            make_attn = make_ulysses_attention
        return sp_mesh, {"attn_fn": make_attn(sp_mesh, batch_axis="data",
                                              causal=True)}
    if args.spmd == "ep":
        from .. import models
        from ..parallel import moe_apply

        if not is_lm:
            raise SystemExit("--spmd ep needs an lm_* model (MoE blocks)")
        ep_mesh, ep = _data_x_mesh(mesh, ndev, "expert",
                                   "--expert-parallel", args.expert_parallel)
        nex = args.experts if args.experts is not None else ep
        if nex % ep:
            raise SystemExit(f"--experts {nex} must be a multiple of the "
                             f"expert axis size {ep}")
        return ep_mesh, {
            "moe_every": args.moe_every if args.moe_every is not None else 2,
            "num_experts": nex,
            "moe_fn": moe_apply(models.moe_expert_fn, ep_mesh,
                                capacity_factor=2.0, batch_axis="data")}
    return mesh, {}


def _sharded_mesh(args, mesh, ndev, dataset=None, layout_rows=None):
    """The mesh and the layout of ``--spmd tp|fsdp_tp`` / ``--layout``
    (``auto``: the picker over ``dataset``'s batch, or over the rows
    priced before the group formed), with ``bin/driver.py``'s checks and
    messages; otherwise ``mesh`` as it is and no layout."""
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
    if args.layout == "auto":
        chosen = _pick_layout(args, mesh, ndev, dataset, layout_rows)
        return chosen.build_mesh(device=mesh.device), chosen
    if args.layout is not None:
        from ..parallel import layout as layout_lib

        try:
            chosen = layout_lib.resolve_layout(args.layout, ndev)
        except layout_lib.LayoutError as e:
            raise SystemExit(f"--layout {args.layout}: {e}")
        return chosen.build_mesh(device=mesh.device), chosen
    return mesh, None


def _optimizer(args):
    """``--opt`` at ``--lr`` (warmup-cosine with ``--total-steps``)."""
    from .. import optim

    lr = args.lr
    if args.total_steps:
        lr = optim.warmup_cosine(args.lr, args.warmup_steps, args.total_steps)
    return getattr(optim, args.opt)(lr)


def pricing_inputs(args, batch_struct: dict):
    """What the layout picker prices in its child process: the
    ``--model`` on the ``meta`` device, the global batch's shapes, the
    ``--opt`` optimizer and the LM's loss factory (``None``: the image
    adapter).  Module-level, so a spawned child can run it."""
    from ..models import lm_loss_fn

    model = build_model(args, "meta", **_model_kwargs(args))
    return (model, batch_struct, _optimizer(args),
            lm_loss_fn if args.model in LM_MODELS else None)


def _batch_shapes(args, dataset) -> dict:
    """The global batch's ``(shape, dtype)`` by name: one draw."""
    import numpy as np

    from ..data.loader import batch_to_dict

    draw = batch_to_dict(
        dataset.batch(np.random.default_rng(0), args.batch_size),
        getattr(dataset, "nclasses", None))
    return {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in draw.items()}


def _pick_layout(args, mesh, ndev: int, dataset, rows=None):
    """``--layout auto`` (``bin/driver.py``'s) over ``rows`` priced
    before the group formed, or else the coordinator prices every
    candidate in a child process (this process holds the run's process
    group; the child forms a fake world of ``ndev`` ranks and prices rank
    0's step), the rows go to every rank, and each picks the same layout
    from them.  The report is printed and, with ``--layout-report``,
    written by the coordinator."""
    import functools
    import importlib

    from ..parallel import layout as layout_lib
    from ..parallel import multihost

    lead = mesh.rank == 0
    if rows is None and lead:
        # by its module's import name: run as ``python -m``, this module
        # is ``__main__``, which a spawned child cannot name
        this = importlib.import_module(
            __spec__.name if __name__ == "__main__" else __name__)
        rows = layout_lib.price_layouts_in_child(
            functools.partial(this.pricing_inputs, args,
                              _batch_shapes(args, dataset)),
            ndev=ndev, device=mesh.device.type)
    rows = multihost.broadcast_from_coordinator(rows)
    try:
        report = layout_lib.pick(None, None, hbm_bytes=args.hbm_bytes,
                                 rows=rows, ndev=ndev)
    except layout_lib.LayoutError as e:
        rep = getattr(e, "report", None)
        if rep is not None and lead:
            print(rep.describe(), flush=True)
            if args.layout_report:
                rep.save(args.layout_report)
        raise SystemExit(f"--layout auto: {e}")
    if lead:
        print(report.describe(), flush=True)
        if args.layout_report:
            report.save(args.layout_report)
    return report.chosen


def _pipeline_kwargs(args, model, mesh, ndev: int, lead: bool) -> dict:
    """``--spmd pp|pp_1f1b``'s mesh (``{data: N/pipe, pipe: pipe}``) and
    ``prepare_training`` arguments, the ``--pp-plan`` resolved (``auto``,
    a saved plan or a cost-profile artifact, priced for this data row's
    batch; refused with ``bin/driver.py``'s message form); ``{}`` for the
    other modes.  ``--pipe 1`` is accepted (the JAX CLI asks for two
    devices): the GPipe schedule runs on one card."""
    if args.spmd not in ("pp", "pp_1f1b"):
        return {}
    pmesh, S = _data_x_mesh(mesh, ndev, "pipe", "--pipe", args.pipe, min_k=1)
    kw = {"mesh": pmesh, "num_microbatches": args.microbatches,
          "pipeline_interleave": args.pp_interleave,
          "pipeline_schedule": args.pp_schedule}
    if args.pp_plan:
        from ..parallel.pp_plan import PlanError, resolve_plan

        n_data = pmesh.shape["data"]
        try:
            plan = resolve_plan(
                args.pp_plan, S, args.microbatches or 2 * S,
                schedule=(args.pp_schedule if args.spmd == "pp_1f1b"
                          else "1f1b"), model=model,
                batch_size=max(args.batch_size // max(n_data, 1), 1),
                seqlen=args.seqlen, device=mesh.device)
        except (PlanError, ValueError, OSError) as e:
            raise SystemExit(f"--pp-plan {args.pp_plan}: {e}")
        kw["pp_plan"] = plan
        if lead:
            print(plan.describe(), flush=True)
    return kw


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
    # the files are the coordinator's: every process would write one path
    observation = Observation(
        tracer=SpanTracer() if args.trace_events and lead else None,
        watchdog=(StepWatchdog(factor=args.watchdog_factor,
                               escalate_after=args.watchdog_escalate)
                  if args.watchdog_factor else None),
        trace_path=args.trace_events if lead else None,
        device_sync=bool(args.trace_events),
        jsonl_path=args.metrics_jsonl if lead else None,
        profile_path=args.profile_out if lead else None,
        flight_path=args.flight if lead else None)
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

    pid = build_parser().parse_args(argv).process_id
    lead = int(os.environ.get("RANK", "0")) == 0 and not pid
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
