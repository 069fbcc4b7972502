#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``fluxdistributed_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, for the ``sm_90a`` kernels) and ``nvcc``.
Phases, each of which raises on failure (exit code != 0, no result):

1. the card: ``nvidia-smi`` name and power limit, and PyTorch's name;
2. build: every kernel source of the package, compiled by ``nvcc`` into
   a fresh persistent build cache under ``_build/``, removed when the
   run ends (``compilation.enable_persistent_cache``: the cold process,
   one miss a source, each source's ``nvcc`` seconds), and ``ptxas``
   lines with the registers and spills of bf16 B2's mma.sync dQ kernel
   at head dim 32, of the Hopper B2/B3 kernels (wgmma, TMA,
   warp-specialised) at 64, 80 and 128 (no spill in B2 or B3 at 80 outside
   the audit), of the Hopper B1 (``flash_fwd_wg_kernel``) at 64, 80 and
   128 (no spill at 64 and 80), of every B1-B3 instantiation at head dim
   80, the kernels ptxas reports with serialised ``wgmma`` (C7520), and
   every instantiation of B4 (``flash_decode_kernel``) and B5
   (``flash_decode_paged_kernel``), no spill in their bf16 and f32
   forms; then ``cuobjdump --dump-sass`` of the flash attention library,
   which must show ``HGMMA`` and ``UTMALDG`` in all 15 Hopper B1, B2 and
   B3 kernels, and of the flash decode library, which must show the
   tensor copy ``UTMALDG`` in all 72 B4 and B5 kernels and no combine
   kernel;
3. kernel: the dense flash-decode kernel (B4: one launch a call,
   split-KV over runs of whole tiles cut from each slot's cursor, the
   runs of a (slot, KV head) one thread block cluster that merges their
   partials through distributed shared memory (st.async into each CTA's
   slice of the outputs), each run's K/V tiles in flight at once by
   tensor copies on mbarriers; with its split, stage, cluster and CTA
   counts) against its plain PyTorch version at lm_small decode shapes
   (8 slots, 1024 rows, 12 heads, head dim 64, cursors 64-832), with
   its time (mean, median and spread), the plain version's, a library
   yardstick (``scaled_dot_product_attention`` over the dequantised
   cache, mean, median and spread) and the card's bound (live K/V bytes
   over the HBM rate), per variant; then the bf16 main shape at forced
   split counts 1, 2, 3, 7 and 16 (the cluster cap) against the plain
   split-and-merge version and the plain version;
4. paged kernel: the paged flash-decode kernel (B5, the same design over
   runs of whole pages, with its split, stage, cluster and CTA counts)
   the same way, over a 512-block pool of 16-row blocks walked through a
   scattered page table with an unbound page inside one live range, and
   against B4 on the same logical rows laid out densely;
5. serve: random-init lm_small (bf16, vocab 32000) behind the port's
   HTTP server, 8 concurrent ``/v1/generate`` requests (prompts of
   64–768 tokens, 64 new tokens, greedy), with B4's launch count checked
   against depth × decode steps; then a profile of the decode step
   (device time by kernel; B4 one kernel a layer, no combine);
6. paged serve: the same model behind ``python -m
   fluxdistributed_tpu_torch.serve --paged --prefix-cache``'s stack: one
   warm request with a 256-token system prompt, then 8 concurrent
   requests sharing it (suffixes of 32–512 tokens, 64 new tokens), with
   B5's launch count checked against depth × decode steps, B4 unused,
   prefix-cache hits counted and the block pool clean after the drain;
   then a profile of the paged decode step;
7. parity: f32 lm_small greedy tokens from the card's engine, dense (B4)
   and paged with a prefix hit (B5), equal the port's ``generate`` on the
   CPU (plain version);
8. attention kernel: the training kernels B1 (forward), B2 (dQ) and B3
   (dK/dV) against their plain versions at lm_small training shapes
   (B=8, T=1024, 12 heads, head dim 64, bf16, causal) and in nine more
   variants (f32; GQA and window + sinks, each in bf16 and f32;
   non-causal, ragged T, Tq < Tk with an LSE cotangent; 6 heads of 128
   in bf16), gradients held element by element (and shown to catch a
   dropped last tile at the kernels' ``TILE_Q`` x ``TILE_K``), each with
   its design (bf16 B1-B3 on the tensor cores, f32 SIMT), its
   time (mean, median and spread), the plain version's, the library
   yardstick (``scaled_dot_product_attention`` forward for B1, its
   backward for B2 + B3: each fused backend pinned in turn, the fastest
   named) and the card's bound; then the autograd layer's layouts at
   head dims 64 and 80: a ``.sum()`` loss (an expanded cotangent) and a
   q view of a [B, T, H, D + 4] tensor, through ``flash_attention`` and
   ``flash_attention_lse``, each backward held element by element to the
   plain versions on the tensors it was given;
9. train: ``python -m fluxdistributed_tpu_torch.train --model lm_small
   --dataset synthetic-text --vocab 256 --seqlen 1024 --batch-size 8
   --attn flash --opt adam --lr 3e-4 --cycles 40`` in-process: the loss
   falls, and B1, B2 and B3 each launch depth x steps times (B4, B5
   never);
10. train step: lm_small at vocab 32000 (B=8, T=1024, adam, bf16) with
    the flash kernels and with dense attention: step ms, tokens/s and
    MFU (the 6N rule), then a profile of one flash step;
11. train parity: two f32 lm_small steps (flash) on the card and on the
    CPU (plain versions) from the same weights and batches: losses and
    global grad norms agree;
12. rounding audit: bf16 B2 and B3 in their audit instantiations, which
    sum every live pair again in the plain order, at the main attention
    shape over 8 seeds and on the q/k/v/dO of every layer of one lm_small
    train step (vocab 32000, B=8, T=1024): pairs flagged, flagged pairs
    whose bf16 rounding the re-sum changed, and unflagged pairs whose
    rounding differs (the flag's misses), printed as a measurement, with
    B2's and B3's times on the first and last layers' inputs;
13. fused-adam kernel: the fused Adam update (B6) against its plain
    version at lm_small's packed size (109,632,512 f32 elements) at steps
    0 and 7 with a schedule's learning rate: bit for bit, fresh outputs,
    a ragged length refused; its time, the plain version's, the bound
    (7 f32 streams over the HBM rate) and ``torch._fused_adam_`` on the
    same buffers as the library yardstick;
14. ZeRO-1 fused train: on a one-rank NCCL group, lm_small (flash,
    synthetic-text vocab 256, B=8, T=1024, adam 3e-4) trained 40 steps
    through ``make_train_step_zero1_fused``: the loss falls, B6 launches
    once per step and B1-B3 depth x steps times; then at vocab 32000
    (bf16, random tokens) the fused ZeRO-1 step, the composable ZeRO-1
    step and the one-device step timed (step ms, tokens/s, MFU, peak
    memory), and a profile of the fused step;
15. ZeRO-1 CLI: ``python -m fluxdistributed_tpu_torch.train ... --zero1``
    in-process, 20 cycles: the loss falls;
16. ZeRO-1 parity: two f32 lm_small steps, fused ZeRO-1 on the card
    against the one-device adam step on the card and the fused step on
    the CPU (plain versions), from the same weights and batches;
17. vision parity: full-width f32 resnet50 (10 classes, 64², batch 8,
    TF32 off) on the card and on the CPU from the same seed and
    batches: 3 momentum steps (losses within 1e-4 relative, params and
    running stats within 1e-3 relative and 1e-5 of each leaf's scale)
    and the eval step's top-1/top-5 (equal);
18. vision train step: resnet50 at 224², 1000 classes, bf16 compute and
    f32 params, batch 256, momentum 0.01, a bf16 batch made on the card,
    on one device and through a one-rank NCCL group (synchronised
    BatchNorm live): step ms over 10 steps, images/s, MFU from the
    model's own multiply-add count (3 x the forward, over the card's
    bf16 dense peak), peak allocated bytes, and a profile (device busy
    and idle share, kernels a step, the largest device ops, BatchNorm's
    kernel share);
19. vision CLI: ``python -m fluxdistributed_tpu_torch.train --model
    resnet50 --dataset synthetic --image-size 224 --num-classes 10
    --batch-size 256 --opt momentum --lr 0.01 --cycles 30 --eval-every
    10`` in-process: the mean of the last 5 losses is below the first;
    the eval top-1/top-5 on two fresh batches and the loader's and the
    loop's phase sums (``fdtpu_data_*``, ``fdtpu_train_phase_seconds``);
    B1-B6 launch no time in phases 17-19;
20. device loop: the train step at ``steps_per_call`` K as one CUDA
    graph replay (``parallel/graphs.py``), held bit for bit to K eager
    steps from the same state and batches (losses, params, optimizer and
    model state), each with a control that must differ (the same replay
    on a zeroed step table): lm_small (vocab 32000, B=8, T=1024, bf16,
    flash B1-B3, adam under ``warmup_cosine``, dropout 0.1), resnet50
    (224², batch 256, bf16, momentum) on a one-rank NCCL group with the
    synchronised BatchNorm, and composable ZeRO-1 (adam) on that group,
    at K = 4; then those three and the one-device resnet50 step timed at
    K = 1 (eager) and K = 8 (graphed): step ms, tokens/s or images/s,
    MFU, device idle share and kernels a step under the profiler, peak
    allocated bytes, kernel launches a replay; then the dense and paged
    engines' decode steps eager and graphed at the serve shapes: step
    ms, idle share, greedy tokens equal, B4/B5 launches equal depth x
    decode steps.  Every row carries the card's ``nvidia-smi`` name and
    power limit;
21. ViT kernel: B1, B2 and B3 at ViT-L/16's attention (batch 128, 196
    tokens, 16 heads of 64, non-causal, q/k/v strided views of one QKV
    projection that the kernels must read in place), at the class
    token's 197 tokens and in f32, each as in phase 8 (the dropped-tile
    control included: ragged last tiles, every row live);
22. ViT train step: ViT-L/16 (224², 1000 classes, batch 128, bf16
    compute and f32 params, adamw at the JAX defaults) with
    ``attn_fn=partial(flash_attention, causal=False)``: B1-B3 24
    launches each in one step and 192 in a K = 8 replay, step ms at
    K = 1 and K = 8, images/s, MFU (3 x 2 x ``forward_macs`` over the
    bf16 peak), peak allocated bytes, idle share and B1-B3's share of
    device time, K = 4 graphs bit-equal to eager steps at batch 32 with
    the zeroed table control, the rounding audit over the step's 24
    layers (0 unflagged mismatches), the flax LayerNorm's cost a step
    beside ``F.layer_norm``'s, then f32 ViT-B/16 logits (64², TF32 off)
    on the card against the CPU;
23. ConvNeXt train step: ConvNeXt-XL (224², batch 128 or the largest
    power of two below it that fits, bf16, lars 0.1, drop path 0.1),
    the same columns (the K = 4 graphs at batch 32); B1-B6 launch no
    time;
24. ViT CLI: ``python -m fluxdistributed_tpu_torch.train --model
    vit_b16 --dataset synthetic --image-size 224 --num-classes 10
    --batch-size 64 --opt adamw --lr 3e-4 --warmup-steps 5
    --total-steps 20 --cycles 20 --eval-every 10`` in-process (dense
    attention, as the JAX CLI's ViT): the mean of the last 5 losses is
    below the first; eval top-1/top-5;
25. ViT-H kernel: B1, B2 and B3 at head dim 80, ViT-H/14's attention
    (batch 32, 256 tokens and the class token's 257, 16 heads of 80,
    non-causal, strided q/k/v read in place) in bf16 and f32, and a
    causal windowed GQA row with sinks at D = 80 in bf16 and f32, each
    as in phase 8 (the plain versions at one whole-sequence block for the
    ViT-H rows; every bf16 row on the Hopper kernels); then the bf16
    rounding audit at the 257-token shape over 4 seeds (0 unflagged
    mismatches);
26. ViT-H train step: ViT-H/14 (224², 632 M params) with the flash
    core, first f32 at batch 2 against the dense core on the same weights
    (logits within 1e-4 of the largest, each gradient leaf within 1e-3
    of its largest entry; B1-B3 32 launches each), then bf16 compute, f32
    params, adamw, batch 32: B1-B3 32 launches each in one step, the
    eager step ms, images/s, MFU, peak allocated bytes and idle share,
    and a profile of one step with B1-B3's device ms and share, and B1's,
    B2's and B3's each;
27. resume: ResNet-50 (224², batch 256, bf16, momentum) at
    ``steps_per_call`` 8 (graph replays) trained 4 items uninterrupted,
    and again with a fault-plan SIGTERM at item 2, checkpointed and
    resumed in a fresh task: every loss and state tensor equal; the
    checkpoint's bytes, a blocking save's and a load's seconds, an
    item's ms with and without a non-blocking save; then the fused
    ZeRO-1 step (B6) on lm_small (vocab 32000) on one NCCL rank, 6 steps
    against 3, a SIGTERM, a checkpoint and 3 from a fresh state loaded
    from it: equal;
28. vision serve: ``serve.vision.make_app`` on ResNet-50 from phase 27's
    checkpoint, 64 single-image requests through ``predict.from_array``
    (uint8 256x256 images: the card machine has no JPEG decoder), each
    top-1 equal to the model's own eval forward; p50/p99 ms a request
    and images/s;
29. guard: lm_small (vocab 32000, B = 8, T = 1024, bf16, flash, adam)
    at ``steps_per_call`` 8, graphed and guarded: a ``train.grad`` NaN at
    item 2 quarantined, bit-equal to the clean run that skips item 2;
    three poisoned items rolled back onto the banked checkpoint, bit-equal
    to their clean skip; the CLI halted by anomalies that keep coming
    (``HALTED_RC``, the manifest left); the fused ZeRO-1 step (B6)
    guarded on one NCCL rank at K = 1, bit-equal to its clean skip;
    B1-B3 and B6 launches over the phase;
30. guard cost: ms per item guarded and unguarded at K = 8 (median of
    6), ResNet-50 (224², batch 256, bf16) and lm_small; the pre-step
    state copy alone in device ms, the sentinel read's share of the
    item and the state bytes kept;
31. observe: the CLI on lm_small at K = 8 with the observation flags,
    ``/metrics`` and ``/healthz`` scraped mid-run (``fdtpu_hbm_*`` read
    the card), the trace's dispatch and loader h2d spans, the flight
    dump; a ``torch.profiler`` window through ``train(profile_dir=)``
    naming B1; ms per item with ``observation`` None, default and full;
    model selection of 8 ResNet-18 replicas (32², 10 classes);
32. sharded train: lm_small (vocab 32000, B = 8, T = 1024, bf16,
    flash, adam 3e-4, dropout 0) 3 steps from one seed and the same
    batches through the one-device DP step and, on one NCCL rank,
    ``spmd="fsdp"``, ``"tp"`` and ``"fsdp_tp"`` on ``{data: 1, model:
    1}`` and ``layout=Layout("dp_fsdp_tp", 1, 1, 1)``: losses and
    gathered params against DP (fsdp and the layout bit for bit; tp and
    fsdp_tp within 1e-2 relative and 6 lr, the row-parallel bias being
    added after the sum), B1-B3 12 launches each a step on every path,
    step ms (profiler device time) and peak allocated bytes;
33. sharded ViT: ViT-L/16 (224², batch 128, flash core, adamw, dropout
    0) 3 steps under ``spmd="tp"`` against DP, B1-B3 24 launches a step,
    the same columns;
34. FSDP ResNet-50 (224², batch 256, bf16, momentum) 3 steps under
    ``spmd="fsdp"`` against the DP step on the same NCCL rank (bit for
    bit), step ms and images/s;
35. sharded CLI: ``python -m fluxdistributed_tpu_torch.train --model
    lm_small ... --spmd fsdp`` and ``--layout dp``, 6 cycles each, B1-B3
    launching 12 a step; ``--spmd tp --tp 2`` and ``--spmd fsdp_tp``
    refused with ``bin/driver.py``'s messages;
36. context kernel: the ring-flash hop body
    (``parallel.context.ring_flash_hops``) over 4 sequence shards held in
    one process at lm_small's attention (B = 8, T = 1024, 256 a shard,
    12 heads of 64, bf16, causal): the forward against one
    whole-sequence ``flash_attention`` call (within 2e-2); in the
    backward each hop's B2/B3, fed the nonzero LSE cotangent the
    log-sum-exp merge produces, held element by element against the
    plain versions on the same inputs, with the dropped-tile control on
    a causal and a non-causal hop; 16 launches of each of B1-B3; the
    ring's ms against the whole-sequence call's (CUDA events);
37. sp train: lm_small (vocab 32000, B = 8, T = 1024, bf16, adam 3e-4)
    3 steps under ``spmd="sp"`` on one NCCL rank ``{data: 1, seq: 1}``,
    with the flash ring (B1-B3 12 a step) and with Ulysses (the dense
    core), each bit-equal to the one-device DP step with the same core;
    device ms a step and peak bytes over DP;
38. ep train: an MoE lm_small (every 2nd of 12 blocks routed over 8
    experts, top-1, capacity factor 2.0, flash core) 3 steps under
    ``spmd="ep"`` on ``{data: 1, expert: 1}``, bit-equal to the same
    model's DP step; device ms, peak bytes, the dispatch/combine
    einsums' share of the step (timed alone at a block's shapes), and
    one MoE layer at a block's shape against its single-shard golden
    (``router_dispatch``, the einsums, a loop over the experts);
39. sp/ep CLI: ``--spmd sp`` and ``--spmd ep`` on one card refused with
    ``bin/driver.py``'s messages;
40. pp train: lm_small (vocab 32000, B = 8, T = 1024, bf16, flash, adam
    3e-4) 3 steps under the trainer's ``spmd="pp"`` (GPipe, 2
    microbatches) on one NCCL rank ``{data: 1, pipe: 1}`` against the
    one-device DP step, then ``make_train_step_1f1b`` at S = 2, M = 4
    with both pipe devices in this process (``parallel.LocalPipe``):
    1F1B, zero-bubble and interleaved (V = 6) against the GPipe run, zb
    bit for bit against 1F1B (losses within 1e-2 relative and params
    within 6 lr otherwise: bf16 microbatch GEMMs and gradient sums);
    B1-B3 launches a step against the timetable's count (24/24/24,
    96/48/48, 144/96/96, 96/48/48), device ms and peak bytes beside
    DP's;
41. pp CLI: ``--spmd pp --pipe 1`` for 2 cycles (B1-B3 24 a step), and
    ``--spmd pp_1f1b --pipe 1`` refused (1F1B needs two pipe devices);
42. multihost CLI: the training CLI with ``--coordinator localhost:PORT
    --num-processes 1 --process-id 0`` (one NCCL rank formed over TCP)
    on lm_small, 3 cycles, losses bit-equal to ``--spmd dp``, B1-B3 12
    a step, the coordinator's ``devices: 1 (1/host x 1 hosts)`` banner;
    the dp run saves an AOT manifest (``--aot``), and the same run in a
    process of its own loads it (no miss, no compile) and again on the
    warm build cache (``--compile-cache``: no miss, one hit), each with
    the dp run's losses bit for bit and its seconds to the first step;
43. vit ring: ViT-L/16 (batch 128, 196 tokens, bf16) sequence-sharded
    with the flash ring on ``{data: 1, seq: 1}``: its forward and 3
    ``spmd="sp"`` adamw steps bit-equal to the flash DP ViT, B1-B3 24 a
    step;
44. fsdp schedule: lm_small and ResNet-50 under spmd="fsdp" with the
    per-block gather schedule and with every leaf gathered up front:
    equal losses; peak allocated and live gathered bytes, device ms,
    warm wall ms and idle share over steps 2-3;
45. supervise: the supervisor over the lm_small CLI with a SIGTERM
    planted at step 2: rc 75, a resume without the plan, rc 0 at step
    4, the episode ledger; each child on the warm build cache (no miss,
    one hit);
46. generate: GPT-2 small (f32) from a seeded HF-named state_dict
    through ``python -m fluxdistributed_tpu_torch.generate
    --gpt2-weights``: 64 greedy tokens equal to the plain decode's, B4
    12 a single-token step, decode ms a token;
47. router: two in-process lm_small replicas (bf16, dense, 8 slots of
    1024 rows, seed 0 each) behind the port's router: 16 greedy
    requests (prompts of 64-754 tokens, 32 new) straight to r0 as the
    reference, then through the router with r0 killed (its sockets and
    loop) after 8 decode steps: every response equal to the reference
    token for token with its X-Request-Id, a failover, r0's breaker
    open, then closed once r0's restart hook brings a new engine up;
    the fleet's throughput on the 16 against one replica's; a rolling
    restart under 8 requests in flight with none failing; TTFT direct
    and through the router; B4's launches over the 5 engines equal to
    depth x their decode steps;
48. router CLI: two ``python -m fluxdistributed_tpu_torch.serve --model
    lm_small --max-slots 4 --max-len 256`` processes (r0 with a
    ``serve.tick`` exit at tick 20) behind ``SupervisedReplica`` restart
    hooks: 8 requests with no failure across the crash, ``python -m
    fluxdistributed_tpu_torch.serve.router --rolling-restart URL`` with
    4 in flight (none fails), the 8 on one replica process against the
    two in turns, and the router's /metrics rollup naming each
    replica's decode tokens and one decode graph a replica, the
    successors included; the wall s of each start and restart; the
    replicas start ``--prewarm`` on the warm build cache (r1: no miss,
    one hit, in the rollup);
49. prewarm: ``LMEngine(prewarm=True)`` (dense, over HTTP) and the serve
    CLI's ``--prewarm`` (paged, prefix cache) with the serve phases'
    requests: ``decode_compiles`` 1 before the first request and after
    the 8, the un-prewarmed engines' greedy tokens token for token,
    B4/B5 launches depth x decode steps, the first request's TTFT
    beside the cold engine's; an engine whose warmup replaces its cache
    gives other tokens; ``attention_impl="xla"``: each request's first
    8 greedy tokens equal B4's, at most a quarter of all differ, 0 B4
    launches;
50. steady/strict: ``--steady-after 2`` on lm_small at K = 1 and K = 8
    reads 0 steady-state recompiles, the K = 8 run with its last item
    cut short exactly 1 (warned); ``--strict-checks`` passes, a planted
    NaN parameter is named by aten op and a planted ``.item()`` refused;
51. a ``phase_seconds`` line (each phase's wall seconds), a
    ``{"kernels": [...]}`` line (B1-B3 with their ViT-L/16 and ViT-H/14
    rows, launches a step beside the LM's, the sharded paths', the sp,
    ep, pipeline and slice-16 paths' launches a step, and the context
    ring's hops; B4 with generate's launches a step and the router
    phase's launches), then the result line ``{"ok": true, "device":
    {...}}`` last.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

# HBM rate (bytes/s) and dense peak (ops/s) by card; NVIDIA data sheets
_CARDS = (  # (name fragment, HBM B/s, f32 FLOP/s, bf16 FLOP/s, 8-bit OP/s)
    ("H200", 4.8e12, 67e12, 989e12, 1979e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12, 1671e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12),
    ("H100", 3.35e12, 67e12, 989e12, 1979e12),  # SXM ("H100 80GB HBM3")
)

B, R, H, D = 8, 1024, 12, 64  # lm_small decode: 8 slots x 1024 rows
BS, NB = 16, 512  # paged: 16-row blocks, 8 slots x 64 pages of them
KERNEL_SOURCE = "fluxdistributed_tpu_torch/ops/csrc/flash_decode.cu"
KERNEL_REPLACES = "fluxdistributed_tpu/ops/pallas_decode.py:168"
# the pallas_call sites of the dense and paged forms of that body
DENSE_VIA = "fluxdistributed_tpu/ops/pallas_decode.py:350"
PAGED_VIA = "fluxdistributed_tpu/ops/pallas_decode.py:483"
# the training kernels: (wrapper, Pallas body, pallas_call site)
ATTN_SOURCE = "fluxdistributed_tpu_torch/ops/csrc/flash_attention.cu"
_PA = "fluxdistributed_tpu/ops/pallas_attention.py"
ATTN_KERNELS = (("flash_attention_fwd", f"{_PA}:125", f"{_PA}:390"),
                ("flash_attention_dq", f"{_PA}:232", f"{_PA}:477"),
                ("flash_attention_dkv", f"{_PA}:275", f"{_PA}:488"))
T_TRAIN = 1024  # lm_small training: B=8 sequences of 1024 tokens
TRAIN_ARGV = ["--model", "lm_small", "--dataset", "synthetic-text",
              "--vocab", "256", "--seqlen", str(T_TRAIN), "--batch-size", "8",
              "--attn", "flash", "--opt", "adam", "--lr", "3e-4",
              "--cycles", "40", "--eval-every", "0"]
ZERO1_ARGV = [*TRAIN_ARGV[:-4], "--cycles", "20", "--eval-every", "0",
              "--zero1"]
# the fused Adam kernel (B6): lm_small's packed ZeRO-1 buffer at one rank
# (109,632,000 parameters at vocab 32000, padded to a multiple of 1024)
# the image path: the reference's ResNet-50 at its per-chip batch of 256
VISION_B, VISION_SIZE = 256, 224
VISION_ARGV = ["--model", "resnet50", "--dataset", "synthetic",
               "--image-size", str(VISION_SIZE), "--num-classes", "10",
               "--batch-size", str(VISION_B), "--opt", "momentum",
               "--lr", "0.01", "--cycles", "30", "--eval-every", "10"]
# the ViT and ConvNeXt image path: ViT-L/16 at 224² (196 tokens, 16 heads
# of 64) and ConvNeXt-XL, batch 128; the ViT CLI on ViT-B/16
VIT_B, VIT_T, VIT_HEADS = 128, 196, 16
VIT_ARGV = ["--model", "vit_b16", "--dataset", "synthetic",
            "--image-size", str(VISION_SIZE), "--num-classes", "10",
            "--batch-size", "64", "--opt", "adamw", "--lr", "3e-4",
            "--warmup-steps", "5", "--total-steps", "20", "--cycles", "20",
            "--eval-every", "10"]
ADAM_SOURCE = "fluxdistributed_tpu_torch/ops/csrc/fused_adam.cu"
ADAM_REPLACES = "fluxdistributed_tpu/parallel/zero1_fused.py:127"
ADAM_VIA = "fluxdistributed_tpu/parallel/zero1_fused.py:170"
N_PACKED = 109_632_512


#: the persistent build cache the cold build fills (made and removed by
#: main)
CACHE_ROOT = None


def cache_argv() -> list:
    """``--compile-cache`` at the cold build's cache: a CLI process
    started with it loads every kernel library and builds none."""
    return ["--compile-cache", CACHE_ROOT]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(log: str, fragment: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from an
    ``nvcc -Xptxas -v`` log, for the entries whose mangled name holds
    ``fragment`` (``Li64ELb0E``: template arguments 64, false)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1] if "'" in line else ""
            name = m if fragment in m else None
            if name:
                out[name] = {}
        elif name and "spill stores" in line:
            w = [t.rstrip(",") for t in line.split()]
            out[name]["spill_stores"] = int(w[w.index("stores") - 3])
            out[name]["spill_loads"] = int(w[w.index("loads") - 3])
        elif name and "Used" in line and "registers" in line:
            w = [t.rstrip(",") for t in line.split()]
            out[name]["registers"] = int(w[w.index("registers") - 1])
            name = None
    return out


def serialised_wgmma(log: str) -> dict:
    """``{kernel: ptxas's advisory}`` for each kernel of an ``nvcc -Xptxas
    -v`` log whose ``wgmma`` instructions ptxas serialised (C7520 and its
    kin: each ``wgmma`` then waits for the one before it)."""
    out = {}
    for line in log.splitlines():
        if "wgmma" in line and "serializ" in line:
            quoted = line.split("'")
            name = demangle(quoted[-2]) if len(quoted) >= 3 else "?"
            out[name] = line.split(":", 1)[-1].split(
                " in the function", 1)[0].strip()
    return out


def demangle(name: str) -> str:
    """``name`` demangled by ``c++filt`` where the toolkit's host has it,
    else as it is."""
    tool = shutil.which("c++filt")
    if tool is None:
        return name
    return subprocess.run([tool, name], capture_output=True, text=True,
                          timeout=30).stdout.strip() or name


#: what every Hopper B1-B3 kernel's SASS must hold: wgmma and TMA loads
HOPPER_SASS = ("HGMMA", "UTMALDG")


def sass_check(_build) -> dict:
    """``cuobjdump --dump-sass`` of the flash attention library: for each
    Hopper kernel (``*_wg_kernel``), which of :data:`HOPPER_SASS` its SASS
    holds.  Raises if one lacks any, or if the instantiations are not all
    there: B2 and B3 at each of ``HOPPER_BWD_DIMS`` with and without the
    audit, and B1 (``flash_fwd_wg_kernel``) at each of
    ``HOPPER_FWD_DIMS`` (15)."""
    from fluxdistributed_tpu_torch.ops.flash_attention import (
        HOPPER_BWD_DIMS, HOPPER_FWD_DIMS)

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    lib = _build.library_path("flash_attention")
    text = subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if "_wg_kernel" in name else None
            if name:
                found[name] = set()
        elif name:
            found[name].update(op for op in HOPPER_SASS if op in line)
    rows = {demangle(n): {op: op in ops for op in HOPPER_SASS}
            for n, ops in found.items()}
    bad = [n for n, r in rows.items() if not all(r.values())]
    fwd = [n for n in rows if "flash_fwd_wg_kernel" in n]
    if len(rows) != 4 * len(HOPPER_BWD_DIMS) + len(HOPPER_FWD_DIMS) or len(
            fwd) != len(HOPPER_FWD_DIMS) or bad:
        raise RuntimeError(f"sass: {len(rows)} Hopper kernels ({len(fwd)} "
                           f"B1), lacking {HOPPER_SASS} in {bad}")
    return rows


#: what every B4/B5 kernel's SASS must hold: the tensor copy
#: (``cp.async.bulk.tensor``); the library's kernels: 6 dtype pairs x
#: windowed x the state's kHeads (1, 4, shared) x dense and paged
DECODE_SASS = ("UTMALDG",)
DECODE_KERNELS = 72


def decode_sass_check(_build) -> dict:
    """``cuobjdump --dump-sass`` of the flash decode library: every
    kernel's name and whether its SASS holds :data:`DECODE_SASS`.
    Raises unless all :data:`DECODE_KERNELS` B4/B5 kernels are there, each
    with the tensor copy, and no other kernel (no combine)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    lib = _build.library_path("flash_decode")
    text = subprocess.run([str(tool), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            found[name] = set()
        elif name:
            found[name].update(op for op in DECODE_SASS if op in line)
    rows = {demangle(n): {op: op in ops for op in DECODE_SASS}
            for n, ops in found.items()}
    bad = [n for n, r in rows.items() if not all(r.values())
           or "combine" in n or "flash_decode" not in n]
    if len(rows) != DECODE_KERNELS or bad:
        raise RuntimeError(f"sass: {len(rows)} flash decode kernels, "
                           f"{bad} lacking {DECODE_SASS} or not B4/B5")
    return rows


def kernel_design(fa, kname, dt, d) -> str:
    """The design a B1-B3 row ran: the wrapper's dispatch table, held to
    the library's own (``flash_attention_design``)."""
    design = fa.kernel_design(kname, dt, d)
    which = {"fwd": 0, "dq": 1, "dkv": 2}[kname]
    code = fa._kernel().flash_attention_design(which, fa._DTYPES[dt], d)
    if code < 0 or fa.DESIGNS[code] != design:
        raise RuntimeError(f"{kname} {dt} D={d}: the library runs design "
                           f"{code}, the wrapper names {design!r}")
    return design


def card_rates(name: str):
    for frag, bw, f32, bf16, i8 in _CARDS:
        if frag in name:
            return bw, {"f32": f32, "bf16": bf16, "8bit": i8}
    raise RuntimeError(f"no memory rate known for {name!r}; add it to _CARDS")


#: device cycles (~0.1 ms) the card sleeps between the flush and a timed
#: call, so the host's enqueue of the call is over before the start event
HOLD_CYCLES = 200_000


def time_stats(torch, fn, flush, iters=30):
    """Device ms of ``fn`` with a cold L2 (a 256 MB memset runs before
    each timed call, as the other layers' caches would): the mean, the
    median and the spread (min, max) over ``iters`` calls.  A device
    sleep after the memset keeps the card busy while the host enqueues
    ``fn`` (tens of us through a Python wrapper), so host time is not
    read as kernel time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in ev]
    return {"mean": sum(ms) / iters, "median": statistics.median(ms),
            "min": min(ms), "max": max(ms)}


def time_ms(torch, fn, flush, iters=30):
    """Mean device ms of ``fn`` with a cold L2 (:func:`time_stats`)."""
    return time_stats(torch, fn, flush, iters)["mean"]


def ring_state(torch, cursors, rows, sinks):
    sp = torch.full((len(cursors), rows), -1, dtype=torch.int32)
    ring = rows - sinks
    for b, cur in enumerate(cursors):
        for p in list(range(min(sinks, cur + 1))) + list(
                range(max(sinks, cur - ring + 1), cur + 1)):
            sp[b, p if p < sinks else sinks + (p - sinks) % ring] = p
    return sp


def sdpa(q, kd, vd, allow):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    over K/V already laid out densely and dequantised (GQA expanded, a
    boolean mask), returned in the kernel's [B, 1, H, D] layout."""
    import torch.nn.functional as F

    rep = q.shape[2] // kd.shape[2]
    kh = kd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    vh = vd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = allow.to(q.device)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask).transpose(1, 2)


def measure(torch, flush, bw, peaks, *, kernel, plain, library, allow,
            row_bytes, other_bytes, bits, tol, plain_iters):
    """``kernel()`` against ``plain()``: max error, the kernel's and the
    library call's times (mean, median, spread) and the plain version's
    (mean), all with a cold L2, and the bound — the live K/V rows (and
    scales) read once plus ``other_bytes``, over the HBM rate, or 4 * H *
    D operations per live row over the peak, whichever is larger."""
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise RuntimeError("non-finite kernel output")
    live = int(allow.sum())
    nbytes = live * row_bytes + other_bytes
    ops = 4 * live * H * D
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peaks[bits] * 1e3
    kt = time_stats(torch, kernel, flush)
    lt = time_stats(torch, library, flush)
    return out, {
        "live_rows": live,
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "tol": tol,
        "library_max_abs_err":
            (library().float() - ref.float()).abs().max().item(),
        "ms": kt["mean"], "ms_median": kt["median"],
        "ms_spread": [kt["min"], kt["max"]],
        "plain_ms": time_ms(torch, plain, flush, iters=plain_iters),
        "library_ms": lt["mean"], "library_ms_median": lt["median"],
        "library_ms_spread": [lt["min"], lt["max"]],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops,
    }


def check(row) -> None:
    """Raise (after the row was printed) if the kernel disagreed."""
    for key in ("max_abs_err", "vs_dense_max_abs_err"):
        if row.get(key) is not None and not row[key] <= row["tol"]:
            raise RuntimeError(f"{row['phase']} {row['variant']}: {key} = "
                               f"{row[key]} > {row['tol']}")


def decode_design(splits, stages, runs) -> str:
    """The design string of a B4/B5 row."""
    return (f"one launch: split-KV, {splits} runs of {runs}, a (1, "
            f"{splits}, 1) thread block cluster a (slot, KV head) merging "
            f"the partials through distributed shared memory (st.async "
            f"into each CTA's slice of the outputs); K/V tiles by "
            f"cp.async.bulk.tensor on mbarriers, {stages} stage(s) in flight "
            f"a CTA; each warp's state in registers")


def kernel_row_bytes(hkv, kv, quant):
    """HBM bytes of one live K+V row of a KV head group (and scales)."""
    return hkv * D * kv.element_size() * 2 + (hkv * 4 * 2 if quant else 0)


def kernel_phase(torch, bw, peaks, flush):
    """Every variant of the decode kernel against its plain version, then
    the main shape at forced split counts; returns the bf16 dense
    (main-path) row."""
    import importlib

    from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference, flash_decode_split)

    # the module (the ops package exports a function of the same name)
    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(0)
    cursors = torch.randint(64, 833, (B,), generator=g, dtype=torch.int32)
    rows = {}
    for variant in ("bf16", "f32", "gqa", "window", "int8", "fp8"):
        hkv = 4 if variant == "gqa" else H
        dt = torch.float32 if variant == "f32" else torch.bfloat16
        r = 260 if variant == "window" else R
        idx = (torch.randint(0, R, (B,), generator=g, dtype=torch.int32)
               if variant == "window" else cursors)
        q = torch.randn(B, 1, H, D, generator=g).to(dt)
        k = torch.randn(B, r, hkv, D, generator=g)
        v = torch.randn(B, r, hkv, D, generator=g)
        kw, bits = {}, {"f32": "f32"}.get(variant, "bf16")
        if variant == "window":
            kw = dict(slot_pos=ring_state(torch, idx.tolist(), r, 4),
                      window=256, sinks=4)
            sp = kw["slot_pos"].long()
            c = idx.long()[:, None]
            allow = (sp >= 0) & (sp <= c) & ((sp > c - 256) | (sp < 4))
        else:
            allow = torch.arange(r)[None, :] <= idx.long()[:, None]
        if variant in ("int8", "fp8"):
            k, kw["k_scale"] = quantize_kv(k.to(dt), variant)
            v, kw["v_scale"] = quantize_kv(v.to(dt), variant)
            bits = "8bit"
        else:
            k, v = k.to(dt), v.to(dt)
        kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
        q, k, v, idx = q.to(dev), k.to(dev), v.to(dev), idx.to(dev)
        if "k_scale" in kw:
            kd = (k.float() * kw["k_scale"][..., None]).to(dt)
            vd = (v.float() * kw["v_scale"][..., None]).to(dt)
        else:
            kd, vd = k, v
        # other least work: q read, out written, cursors (+ the ring's
        # slot_pos) read
        _, m = measure(
            torch, flush, bw, peaks,
            kernel=lambda: flash_decode(q, k, v, idx, **kw),
            plain=lambda: flash_decode_reference(q, k, v, idx, **kw),
            library=sdpa(q, kd, vd, allow), allow=allow,
            row_bytes=kernel_row_bytes(hkv, k, "k_scale" in kw),
            other_bytes=(2 * q.numel() * q.element_size() + 4 * B
                         + (4 * B * r if variant == "window" else 0)),
            bits=bits, tol=1e-4 if dt == torch.float32 else 2e-2,
            plain_iters=10)
        splits = fd.kernel_plan(q, k)
        flash_decode(q, k, v, idx, **kw)
        stages = fd.last_stages()
        rows[variant] = {
            "phase": "kernel", "variant": variant,
            "shape": [B, r, H, hkv, D], "q_dtype": str(dt).split(".")[-1],
            "kv_dtype": str(k.dtype).split(".")[-1],
            "design": decode_design(splits, stages, "each slot's live tiles "
                                    "(cut from its cursor on the device)"),
            "splits": splits, "cluster": [1, splits, 1], "stages": stages,
            "ctas": B * hkv * splits, "sms": sms, **m}
        emit(rows[variant])
        check(rows[variant])
        if variant == "bf16":
            main_args = (q, k, v, idx)
    # the main shape at forced split counts: the kernel against the plain
    # split-and-merge version at the same count and the plain version
    ref = flash_decode_reference(*main_args)
    forced = {}
    for n in (1, 2, 3, 7, fd.MAX_SPLITS):
        out = fd._launch(*main_args, None, None, 0, None, None, splits=n)
        split_ref = flash_decode_split(*main_args, splits=n)
        torch.cuda.synchronize()
        forced[n] = {
            "vs_plain_split": (out.float() - split_ref.float()).abs().max().item(),
            "vs_plain": (out.float() - ref.float()).abs().max().item()}
    emit({"phase": "kernel_splits", "variant": "bf16",
          "shape": [B, R, H, H, D], "tol": 2e-2, "splits": forced})
    bad = [n for n, e in forced.items() if not max(e.values()) <= 2e-2]
    if bad:
        raise RuntimeError(f"kernel_splits: split counts {bad} out of "
                           f"tolerance: {forced}")
    return rows["bf16"]


def paged_kernel_phase(torch, bw, peaks, flush):
    """Every variant of the paged decode kernel against its plain version
    (and, unwindowed, against the dense kernel on the same stored rows
    laid out densely); returns the bf16 (main-path) row."""
    import importlib

    from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged, flash_decode_paged_reference)

    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the dense kernel phase's cursors (the same seed, the same draw)
    cursors = torch.randint(64, 833, (B,), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    hole = 3  # this slot has an unbound page inside its live range
    rows = {}
    for variant in ("bf16", "f32", "gqa", "window", "int8", "fp8"):
        hkv = 4 if variant == "gqa" else H
        dt = torch.float32 if variant == "f32" else torch.bfloat16
        windowed = variant == "window"
        # window 256 + sinks 4: 260 rows, r_pad 272 = 17 pages
        pages = -(-260 // BS) if windowed else R // BS
        r_pad = pages * BS
        idx = (torch.randint(0, R, (B,), generator=g, dtype=torch.int32)
               if windowed else cursors)
        q = torch.randn(B, 1, H, D, generator=g).to(dt)
        k = torch.randn(NB, BS, hkv, D, generator=g)
        v = torch.randn(NB, BS, hkv, D, generator=g)
        kw, bits = {}, {"f32": "f32"}.get(variant, "bf16")
        if windowed:
            sp = ring_state(torch, idx.tolist(), r_pad, 4)
            kw = dict(slot_pos=sp, window=256, sinks=4)
            spl, c = sp.long(), idx.long()[:, None]
            allow = (spl >= 0) & (spl <= c) & ((spl > c - 256) | (spl < 4))
            used = (sp >= 0).view(B, pages, BS).any(2)
        else:
            allow = torch.arange(r_pad)[None, :] <= idx.long()[:, None]
            used = torch.arange(pages)[None, :] * BS <= idx.long()[:, None]
        # a seeded permutation of the pool: pages scattered, -1 where unused
        pt = torch.randperm(NB, generator=g)[:B * pages].view(B, pages)
        pt = torch.where(used, pt, torch.full_like(pt, -1)).to(torch.int32)
        pt[hole, 1] = -1
        allow &= (pt >= 0).repeat_interleave(BS, dim=1)
        if variant in ("int8", "fp8"):
            k, kw["k_scale"] = quantize_kv(k.to(dt), variant)
            v, kw["v_scale"] = quantize_kv(v.to(dt), variant)
            bits = "8bit"
        else:
            k, v = k.to(dt), v.to(dt)
        kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
        q, k, v, idx, pt = (x.to(dev) for x in (q, k, v, idx, pt))
        ks, vs = kw.get("k_scale"), kw.get("v_scale")

        def take(x):
            """Pool rows laid out densely: [B, r_pad, ...] (a -1 page
            reads block 0; its rows are masked)."""
            blk = pt.long().clamp(min=0)
            y = (x.view(torch.uint8)[blk].view(x.dtype)
                 if x.dtype == torch.float8_e4m3fn else x[blk])
            return y.reshape(B, r_pad, *x.shape[2:])

        def gathered(pool, scale):
            """The dense layout dequantised to dt, [B, r_pad, Hkv, D]."""
            x = take(pool)
            if scale is not None:
                x = x.float() * take(scale)[..., None]
            return x.to(dt)

        def gather_sdpa():
            return sdpa(q, gathered(k, ks), gathered(v, vs), allow)()

        # other least work: the page ids the walk reads, q read, out
        # written, cursors (+ slot_pos) read
        walked = B * pages if windowed else int(
            ((idx.long() + BS) // BS).clamp(max=pages).sum())
        out, m = measure(
            torch, flush, bw, peaks,
            kernel=lambda: flash_decode_paged(q, k, v, pt, idx, **kw),
            plain=lambda: flash_decode_paged_reference(q, k, v, pt, idx, **kw),
            library=sdpa(q, gathered(k, ks), gathered(v, vs), allow),
            allow=allow, row_bytes=kernel_row_bytes(hkv, k, ks is not None),
            other_bytes=(4 * walked + 2 * q.numel() * q.element_size()
                         + 4 * B + (4 * B * r_pad if windowed else 0)),
            bits=bits, tol=1e-4 if dt == torch.float32 else 2e-2,
            plain_iters=5)
        vs_dense = None
        if not windowed:
            # the dense kernel on the same stored rows laid out densely
            # (the hole slot would attend its unbound page: left out)
            dkw = {} if ks is None else dict(k_scale=take(ks), v_scale=take(vs))
            dense = flash_decode(q, take(k), take(v), idx, **dkw)
            keep = torch.arange(B, device=dev) != hole
            vs_dense = (dense.float() - out.float())[keep].abs().max().item()
        runs, per = fd.paged_kernel_plan(q, k, pt)
        flash_decode_paged(q, k, v, pt, idx, **kw)
        stages = fd.last_stages()
        rows[variant] = {
            "phase": "paged_kernel", "variant": variant,
            "shape": [B, pages, BS, NB, H, hkv, D],
            "design": decode_design(runs, stages, f"{per} pages"),
            "splits": runs, "pages_per_split": per,
            "cluster": [1, runs, 1], "stages": stages,
            "ctas": B * hkv * runs, "sms": sms,
            "q_dtype": str(dt).split(".")[-1],
            "kv_dtype": str(k.dtype).split(".")[-1], **m,
            "vs_dense_max_abs_err": vs_dense,
            "library_gather_ms": time_ms(torch, gather_sdpa, flush)}
        emit(rows[variant])
        check(rows[variant])
    return rows["bf16"]


def post(url, body, timeout=600, rid=None):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(url, json.dumps(body).encode(), headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def serve_phase(torch):
    """lm_small behind the HTTP server; returns the kernel launches of
    the 8-request run and the run (its prompts, greedy tokens and the
    first request's TTFT: the cold engine's, for the prewarm phase)."""
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.ops.flash_decode import flash_decode
    from fluxdistributed_tpu_torch.serve import LMEngine, Scheduler, serve_lm

    t0 = time.perf_counter()
    model = lm_small(vocab=32000, seed=0)  # bf16 on cuda
    engine = LMEngine(model, max_slots=8, max_len=1024)
    sched = Scheduler(engine, max_queue=64)
    server, httpd = serve_lm(sched, vocab=32000, host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    setup_s = time.perf_counter() - t0
    try:
        t1 = time.perf_counter()
        first = post(base + "/v1/generate", {"prompt_tokens": [1, 2, 3],
                                             "max_tokens": 4})  # warm-up
        first["wall_ms"] = (time.perf_counter() - t1) * 1e3
        g = torch.Generator().manual_seed(1)
        lens = [64, 160, 256, 352, 448, 544, 640, 768]
        prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
                   for n in lens]
        m0 = sched.metrics()
        steps0 = engine.decode_steps
        flash_decode.launches = 0  # count the main path only
        results = [None] * len(prompts)
        errors = []

        def call(i):
            try:
                results[i] = post(base + "/v1/generate", {
                    "prompt_tokens": prompts[i], "max_tokens": 64,
                    "temperature": 0.0})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t1 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        launches = flash_decode.launches
        steps = engine.decode_steps - steps0
        m1 = sched.metrics()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serve: requests failed: {errors}")
        for p, res in zip(prompts, results):
            gen = res["generated"]
            if (len(gen) != 64 or res["tokens"][:len(p)] != p
                    or not all(0 <= x < 32000 for x in gen)):
                raise RuntimeError(f"serve: malformed response for a "
                                   f"{len(p)}-token prompt: {res}")
        if steps < 63 or launches != model.depth * steps:
            raise RuntimeError(
                f"serve: {launches} kernel launches for {steps} decode "
                f"steps x depth {model.depth}")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        dtok = m1["decode_tokens"] - m0["decode_tokens"]
        dsec = m1["decode_sec"] - m0["decode_sec"]
        emit({
            "phase": "serve", "model": "lm_small", "dtype": "bfloat16",
            "vocab": 32000, "max_slots": 8, "max_len": 1024,
            "requests": len(prompts), "prompt_tokens": lens,
            "new_tokens": 64, "setup_s": setup_s, "wall_s": wall,
            "decode_steps": steps, "kernel_launches": launches,
            "decode_tokens_per_s": dtok / dsec,
            "step_ms_mean": dsec / steps * 1e3,
            "ttft_ms_p50": statistics.median(r["ttft_ms"] for r in results),
            "ttft_ms_max": max(r["ttft_ms"] for r in results),
            "generated_tokens_per_s": 64 * len(prompts) / wall,
            "peak_allocated_bytes": health["memory"]["peak_allocated_bytes"],
            "kv_cache_bytes": engine.kv_cache_bytes()["reserved"],
            "first_request_ttft_ms": first["ttft_ms"],
        })
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=30)
    profile_decode(torch, engine, prompts)
    return launches, {"first": first, "prompts": prompts,
                      "tokens": [r["generated"] for r in results]}


def paged_serve_phase(torch):
    """lm_small behind the paged server stack (``--paged
    --prefix-cache``); returns the paged kernel's launches of the
    8-request run and the run (as :func:`serve_phase`)."""
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from fluxdistributed_tpu_torch.serve.__main__ import (build_parser,
                                                          build_server)

    t0 = time.perf_counter()
    args = build_parser().parse_args(
        ["--model", "lm_small", "--vocab", "32000", "--max-slots", "8",
         "--max-len", "1024", "--paged", "--prefix-cache", "--seed", "0"])
    server, sched = build_server(args)
    engine = sched.engine
    httpd = server.serve("127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    setup_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(5)
    system = torch.randint(0, 32000, (256,), generator=g).tolist()
    suffixes = [32, 96, 160, 224, 288, 352, 416, 512]
    prompts = [system + torch.randint(0, 32000, (n,), generator=g).tolist()
               for n in suffixes]
    try:
        warm = system + torch.randint(0, 32000, (8,), generator=g).tolist()
        t1 = time.perf_counter()
        first = post(base + "/v1/generate", {"prompt_tokens": warm,
                                             "max_tokens": 8})
        first["wall_ms"] = (time.perf_counter() - t1) * 1e3
        m0 = sched.metrics()
        hits0 = engine.pool_stats()["prefix_cache_hits"]
        steps0 = engine.decode_steps
        flash_decode.launches = 0  # count this phase's main path only
        flash_decode_paged.launches = 0
        results = [None] * len(prompts)
        errors = []
        peak = {"active": 0}
        running = threading.Event()
        running.set()

        def sample_pool():
            # 20 Hz of host-side reads: a faster poll steals the GIL
            # from the host-bound scheduler loop
            while running.is_set():
                peak["active"] = max(peak["active"],
                                     engine.pool_stats()["kv_blocks_active"])
                time.sleep(0.05)

        def call(i):
            try:
                results[i] = post(base + "/v1/generate", {
                    "prompt_tokens": prompts[i], "max_tokens": 64,
                    "temperature": 0.0})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        sampler = threading.Thread(target=sample_pool, daemon=True)
        sampler.start()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        running.clear()
        sampler.join(timeout=30)
        launches, dense = flash_decode_paged.launches, flash_decode.launches
        steps = engine.decode_steps - steps0
        m1 = sched.metrics()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"paged serve: requests failed: {errors}")
        for p, res in zip(prompts, results):
            gen = res["generated"]
            if (len(gen) != 64 or res["tokens"][:len(p)] != p
                    or not all(0 <= x < 32000 for x in gen)):
                raise RuntimeError(f"paged serve: malformed response for a "
                                   f"{len(p)}-token prompt: {res}")
        depth = engine.model.depth
        if steps < 63 or launches != depth * steps or dense != 0:
            raise RuntimeError(
                f"paged serve: {launches} paged and {dense} dense kernel "
                f"launches for {steps} decode steps x depth {depth}")
        hits = engine.pool_stats()["prefix_cache_hits"] - hits0
        if hits < len(prompts) * len(system) // BS:
            raise RuntimeError(f"paged serve: {hits} prefix-cache hits, "
                               f"expected >= {len(prompts) * 16}")
        deadline = time.monotonic() + 30
        while not sched.idle and time.monotonic() < deadline:
            time.sleep(0.01)
        ps = engine.pool_stats()
        if (ps["kv_blocks_active"] or ps["kv_blocks_promised"]
                or ps["kv_blocks_free"] + ps["kv_blocks_cached"]
                != ps["kv_blocks_total"]):
            raise RuntimeError(f"paged serve: pool not clean after the "
                               f"drain: {ps}")
        dtok = m1["decode_tokens"] - m0["decode_tokens"]
        dsec = m1["decode_sec"] - m0["decode_sec"]
        kv = engine.kv_cache_bytes()
        emit({
            "phase": "paged_serve", "model": "lm_small", "dtype": "bfloat16",
            "vocab": 32000, "max_slots": 8, "max_len": 1024,
            "kv_block_size": engine.layout.block_size,
            "kv_blocks": ps["kv_blocks_total"],
            "prefill_chunk": engine.prefill_chunk, "prefix_cache": True,
            "requests": len(prompts), "system_tokens": len(system),
            "suffix_tokens": suffixes, "new_tokens": 64, "setup_s": setup_s,
            "wall_s": wall, "decode_steps": steps, "kernel_launches": launches,
            "dense_kernel_launches": dense, "prefix_cache_hits": hits,
            "decode_tokens_per_s": dtok / dsec,
            "step_ms_mean": dsec / steps * 1e3,
            "ttft_ms_p50": statistics.median(r["ttft_ms"] for r in results),
            "ttft_ms_max": max(r["ttft_ms"] for r in results),
            "generated_tokens_per_s": 64 * len(prompts) / wall,
            "kv_cache_reserved_bytes": kv["reserved"],
            # live = reserved x active share, as kv_cache_bytes() counts it
            "kv_cache_live_bytes_peak": kv["reserved"] * peak["active"]
            // ps["kv_blocks_total"],
            "kv_blocks_active_peak": peak["active"],
            "pool_after_drain": ps,
            "first_request_ttft_ms": first["ttft_ms"],
        })
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=30)
    profile_decode(torch, engine, prompts)
    return launches, {"first": first, "warm": warm, "prompts": prompts,
                      "tokens": [r["generated"] for r in results]}


# ------------------------------------------------ cold start: prewarm

def _sched_tokens(engine, prompts, new):
    """Greedy tokens of ``prompts`` (``new`` each) through a scheduler
    driven on this thread."""
    from fluxdistributed_tpu_torch.serve import Request, Scheduler

    sched = Scheduler(engine, max_queue=64)
    reqs = [Request(prompt=p, max_new_tokens=new, temperature=0.0)
            for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return [r.generated for r in reqs]


def _prewarmed_http(torch, engine, server, warm, first_new, prompts, new):
    """The serve phases' run on a prewarmed engine over HTTP: the first
    request (``warm``, ``first_new`` tokens) and the 8 concurrent ones;
    returns the first request, the tokens, the decode steps and B4/B5
    launches."""
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)

    httpd = server.serve("127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        t1 = time.perf_counter()
        first = post(base + "/v1/generate", {"prompt_tokens": warm,
                                             "max_tokens": first_new})
        first["wall_ms"] = (time.perf_counter() - t1) * 1e3
        steps0 = engine.decode_steps
        flash_decode.launches = flash_decode_paged.launches = 0
        results, errors = [None] * len(prompts), []

        def call(i):
            try:
                results[i] = post(base + "/v1/generate", {
                    "prompt_tokens": prompts[i], "max_tokens": new,
                    "temperature": 0.0})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or None in results:
            raise RuntimeError(f"prewarm: requests failed: {errors}")
        return {"first": first, "tokens": [r["generated"] for r in results],
                "steps": engine.decode_steps - steps0,
                "b4_b5": [flash_decode.launches, flash_decode_paged.launches]}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=30)


def prewarm_phase(torch, card, dense_run, paged_run):
    """Cold start on the serving path: ``LMEngine(prewarm=True)`` builds
    and captures before the first request, then restores its slots in
    place.  Dense (B4) over HTTP and paged with the prefix cache (B5)
    through the serve CLI's ``--prewarm``: ``decode_compiles == 1``
    before request 1 and after the 8, the greedy tokens of the serve
    phases' un-prewarmed engines token for token, B4/B5 launches equal
    to depth x decode steps, and the first request's TTFT beside the
    cold engine's.  The check has power: an engine whose warmup REPLACES
    its cache (the JAX engine's way; the captured graph keeps the old
    one) gives other tokens.  Then ``attention_impl="xla"``: the plain
    decode attention's greedy tokens against B4's (C6's rounding: the
    count that differ), with 0 B4 launches."""
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.models.transformer_lm import (
        make_decode_cache)
    from fluxdistributed_tpu_torch.ops.flash_decode import flash_decode
    from fluxdistributed_tpu_torch.serve import LMEngine, Scheduler
    from fluxdistributed_tpu_torch.serve.__main__ import (build_parser,
                                                          build_server)
    from fluxdistributed_tpu_torch.serve.server import LMServer

    model = lm_small(vocab=32000, seed=0)
    depth = model.depth
    rows = {}
    # dense, the serve phase's engine and requests
    t0 = time.perf_counter()
    engine = LMEngine(model, max_slots=8, max_len=1024, prewarm=True)
    build_s = time.perf_counter() - t0
    before = engine.compile_stats()["decode_compiles"]
    sched = Scheduler(engine, max_queue=64)
    run = _prewarmed_http(torch, engine, LMServer(sched, 32000), [1, 2, 3],
                          4, dense_run["prompts"], 64)
    rows["dense"] = {
        "engine_build_s": build_s, "decode_compiles_before": before,
        "decode_compiles_after": engine.compile_stats()["decode_compiles"],
        "first_ttft_ms": run["first"]["ttft_ms"],
        "cold_first_ttft_ms": dense_run["first"]["ttft_ms"],
        "first_wall_ms": run["first"]["wall_ms"],
        "cold_first_wall_ms": dense_run["first"]["wall_ms"],
        "tokens_equal": run["tokens"] == dense_run["tokens"],
        "first_tokens_equal": (run["first"]["generated"]
                               == dense_run["first"]["generated"]),
        "decode_steps": run["steps"], "b4_b5_launches": run["b4_b5"]}
    del engine, sched
    # paged + prefix cache through the CLI's --prewarm
    t0 = time.perf_counter()
    args = build_parser().parse_args(
        ["--model", "lm_small", "--vocab", "32000", "--max-slots", "8",
         "--max-len", "1024", "--paged", "--prefix-cache", "--seed", "0",
         "--prewarm"])
    server, sched = build_server(args)
    engine = sched.engine
    build_s = time.perf_counter() - t0
    before = engine.compile_stats()["decode_compiles"]
    run = _prewarmed_http(torch, engine, server, paged_run["warm"], 8,
                          paged_run["prompts"], 64)
    rows["paged"] = {
        "engine_build_s": build_s, "decode_compiles_before": before,
        "decode_compiles_after": engine.compile_stats()["decode_compiles"],
        "first_ttft_ms": run["first"]["ttft_ms"],
        "cold_first_ttft_ms": paged_run["first"]["ttft_ms"],
        "first_wall_ms": run["first"]["wall_ms"],
        "cold_first_wall_ms": paged_run["first"]["wall_ms"],
        "tokens_equal": run["tokens"] == paged_run["tokens"],
        "first_tokens_equal": (run["first"]["generated"]
                               == paged_run["first"]["generated"]),
        "decode_steps": run["steps"], "b4_b5_launches": run["b4_b5"]}
    del engine, sched, server

    class ReplacedCache(LMEngine):
        """The planted fault: warmup's restore swaps in a NEW cache (the
        old one kept alive, so the captured graph writes memory that is
        still owned) instead of zeroing the captured one in place."""

        def _pristine(self):
            super()._pristine()
            self._captured_cache = self.cache
            self.cache = make_decode_cache(self.model, self.max_slots,
                                           self.max_len, self.kv_quant)

    planted = _sched_tokens(
        ReplacedCache(model, max_slots=8, max_len=1024, prewarm=True),
        dense_run["prompts"][:2], 16)
    rows["replaced_cache_caught"] = [
        a != b[:16] for a, b in zip(planted, dense_run["tokens"][:2])]
    # the plain decode attention, asked for by name
    flash_decode.launches = 0
    t0 = time.perf_counter()
    xla = _sched_tokens(LMEngine(model, max_slots=8, max_len=1024,
                                 attention_impl="xla"),
                        dense_run["prompts"], 64)
    wall = time.perf_counter() - t0
    pairs = [(a, b) for ra, rb in zip(xla, dense_run["tokens"])
             for a, b in zip(ra, rb)]
    lead = [next((i for i, (a, b) in enumerate(zip(ra, rb)) if a != b),
                 len(ra)) for ra, rb in zip(xla, dense_run["tokens"])]
    rows["xla"] = {"wall_s": wall, "b4_launches": flash_decode.launches,
                   "tokens_differing": sum(a != b for a, b in pairs),
                   "tokens": len(pairs), "identical_leading_tokens": lead}
    row = {"phase": "prewarm", "card": card, "model": "lm_small",
           "dtype": "bfloat16", **rows}
    emit(row)
    for name in ("dense", "paged"):
        r = rows[name]
        want = [depth * r["decode_steps"], 0] if name == "dense" else [
            0, depth * r["decode_steps"]]
        if (r["decode_compiles_before"] != 1
                or r["decode_compiles_after"] != 1 or not r["tokens_equal"]
                or not r["first_tokens_equal"] or r["decode_steps"] < 63
                or r["b4_b5_launches"] != want):
            raise RuntimeError(f"prewarm {name}: {row}")
    # the first token comes from prefill, which the decode attention
    # never sees: each request's first 8 tokens must agree, and at most
    # a quarter of all (C6's rounding lets a request diverge later)
    x = rows["xla"]
    if (not any(rows["replaced_cache_caught"]) or x["b4_launches"]
            or min(x["identical_leading_tokens"]) < 8
            or x["tokens_differing"] > x["tokens"] // 4):
        raise RuntimeError(f"prewarm: {row}")


def profile_decode(torch, engine, prompts, steps=10):
    """Where a steady all-slot decode step's time goes: host wall per
    step, device busy time per step (torch.profiler), and the largest
    device kernels.  Leaves every slot free."""
    from torch.profiler import ProfilerActivity, profile

    for s, p in enumerate(prompts):
        engine.prefill(s, p, 0.0, None)
    engine.step_decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step_decode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step_decode()
        torch.cuda.synchronize()
    dev = {}
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0))
            dev[row.key] = dev.get(row.key, 0.0) + us
    busy_ms = sum(dev.values()) / steps / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    # B4/B5: one kernel a layer a step, no combine
    calls = {r.key: r.count for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA
             and "flash_decode" in r.key}
    if dev and (len(calls) != 1 or any("combine" in k for k in calls)
                or sum(calls.values()) != engine.model.depth * steps):
        raise RuntimeError(f"profile: decode kernels {calls} over {steps} "
                           f"steps, depth {engine.model.depth}")
    emit({"phase": "profile", "layout": engine.layout_name,
          "what": "all-slot decode step, 8 live slots",
          "steps": steps, "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms if dev else None,
          "device_idle_share": 1 - busy_ms / wall_ms if dev else None,
          "device_kernels_per_step": None if not dev else sum(
              r.count for r in prof.key_averages()
              if r.device_type == torch.autograd.DeviceType.CUDA) / steps,
          "top_device_ms_per_step": [[k[:60], v / steps / 1e3]
                                     for k, v in top],
          "decode_kernels_ms_per_step": {
              k[:80]: v / steps / 1e3 for k, v in dev.items()
              if "flash_decode" in k},
          "decode_kernel_launches_per_step": {
              k[:80]: n / steps for k, n in calls.items()}})
    for s in range(len(prompts)):
        engine.reset_slot(s)


def parity_phase(torch):
    """f32 lm_small: the card's engine, dense (B4) and paged with a prefix
    hit (B5), vs the port's generate on the CPU (plain versions)."""
    from fluxdistributed_tpu_torch.models import generate, lm_small
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from fluxdistributed_tpu_torch.serve import LMEngine, Request, Scheduler

    kw = dict(vocab=32000, dtype=torch.float32, seed=2)
    gpu, cpu = lm_small(device="cuda", **kw), lm_small(device="cpu", **kw)
    g = torch.Generator().manual_seed(3)
    first = torch.randint(0, 32000, (40,), generator=g).tolist()
    # the second prompt shares the first's full first block (16 tokens)
    prompts = [first, first[:BS] + torch.randint(
        0, 32000, (41,), generator=g).tolist()]
    refs = [generate(cpu, [p], len(p) + 32)[0].tolist() for p in prompts]
    engines = {
        "dense": LMEngine(gpu, max_slots=2, max_len=128, buckets=(64,)),
        "paged": LMEngine(gpu, max_slots=2, max_len=128, layout="paged",
                          prefix_cache=True),
    }
    for layout, engine in engines.items():
        before = (flash_decode.launches, flash_decode_paged.launches)
        sched = Scheduler(engine)
        reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
        for r in reqs:  # one after the other: the second claims the prefix
            sched.generate_all([r])
        used = (flash_decode.launches - before[0],
                flash_decode_paged.launches - before[1])
        want = gpu.depth * engine.decode_steps
        if used != ((want, 0) if layout == "dense" else (0, want)):
            raise RuntimeError(f"parity {layout}: kernel launches {used} "
                               f"for {engine.decode_steps} steps")
        for r, p, ref in zip(reqs, prompts, refs):
            if r.tokens != ref:
                at = next(i for i, (a, b) in enumerate(zip(r.tokens, ref))
                          if a != b)
                with torch.no_grad():
                    lg = cpu(torch.tensor([ref[:at]]))[0, -1]
                top = torch.topk(lg, 2).values.tolist()
                raise RuntimeError(
                    f"parity {layout}: card tokens differ from the CPU at "
                    f"position {at} (card {r.tokens[at]}, cpu {ref[at]}; "
                    f"cpu top-2 logit gap {top[0] - top[1]:.3g})")
        hits = engine.pool_stats().get("prefix_cache_hits")
        if layout == "paged" and hits != 1:
            raise RuntimeError(f"parity paged: {hits} prefix-cache hits, "
                               "expected 1")
        emit({"phase": "parity", "layout": layout, "model": "lm_small",
              "dtype": "float32", "prompts": [len(p) for p in prompts],
              "new_tokens": 32, "tokens_equal": [32, 32],
              "prefix_cache_hits": hits})


def attn_wrappers():
    """The wrappers of B1, B2 and B3 (each counts its launches)."""
    from fluxdistributed_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd)

    return flash_attention_fwd, flash_attention_dq, flash_attention_dkv


def attn_counts():
    return [w.launches for w in attn_wrappers()]


def all_wrappers():
    """The wrappers of B1-B6, in the order of the ``kernels`` line."""
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam

    return (flash_decode, flash_decode_paged, *attn_wrappers(), fused_adam)


def all_counts():
    return [w.launches for w in all_wrappers()]


def reset_all_counts():
    for w in all_wrappers():
        w.launches = 0


def live_pairs(torch, tq, tk, causal, window, sinks):
    """Attended (query, key) pairs of one head: the mask B1-B3 apply."""
    qp = torch.arange(tq)[:, None] + (tk - tq)
    kp = torch.arange(tk)[None, :]
    allow = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        allow = kp <= qp
        if window is not None:
            allow &= (kp >= qp - (window - 1)) | (kp < sinks)
    return allow


# SDPA's fused backends; MATH (unfused) only where none of them takes the
# inputs
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_train(torch, q, k, v, do, allow, causal_square):
    """The library yardstick in [B, H, T, D]: for each SDPA backend that
    takes the inputs, pinned with ``sdpa_kernel``, one
    ``scaled_dot_product_attention`` forward and its backward alone
    (autograd.grad with the graph kept).  Returns ``{backend name: (fwd,
    bwd)}``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k.repeat_interleave(rep, 2),
                            v.repeat_interleave(rep, 2)))
    doh = do.transpose(1, 2).contiguous()
    kw = ({"is_causal": True} if causal_square
          else {"attn_mask": allow.to(q.device)} if not bool(allow.all())
          else {})

    def pinned(backend):
        with sdpa_kernel([backend]):
            out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
            torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)

        def fwd():
            with torch.no_grad(), sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qh, kh, vh, **kw)

        def bwd():  # the forward's graph node fixes the backward kernel
            return torch.autograd.grad(out, (qh, kh, vh), doh,
                                       retain_graph=True)

        return fwd, bwd

    calls = {}
    for name in (*SDPA_BACKENDS, "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None or (name == "MATH" and calls):
            continue
        try:
            calls[name] = pinned(backend)
        except RuntimeError:  # this backend does not take these inputs
            continue
    if not calls:
        raise RuntimeError("no SDPA backend takes the attention inputs")
    return calls


# B2/B3 against their plain versions, element by element:
# |err| <= atol + rtol * |ref|.  The kernels round p and ds where the
# plain versions do, so in bf16 they differ only where f32 sums in
# another order flip the output's last rounding: rtol is two bf16 ulps
# and atol a floor for entries near 0.  f32: 1e-4 abs.  A limit scaled
# by the largest entry would let the small gradients of late causal
# positions go unchecked.
GRAD_TOL = {"f32": (1e-4, 0.0), "bf16": (1e-5, 1.6e-2)}


def grad_check(torch, got, ref, bits):
    """How far ``got`` is from ``ref`` in units of the element-wise
    limit (``excess`` <= 1 passes), and what atol it needed."""
    atol, rtol = GRAD_TOL[bits]
    err, r = (got.float() - ref.float()).abs(), ref.float().abs()
    return {"excess": (err / (atol + rtol * r)).max().item(),
            "needed_atol": (err - rtol * r).clamp(min=0).max().item(),
            "ref_rms": r.square().mean().sqrt().item(),
            "ref_max": r.max().item()}


def dropped_tile_check(torch, fa, bargs, kw, rdq, rdk, rdv, bits):
    """The element-wise check against a B2 that skips its last K tile and
    a B3 that skips its last Q tile (Tq = Tk, no window; causal, or
    non-causal with a ragged last tile), at the kernels' tiles
    (``TILE_Q`` x ``TILE_K``): both faults are built from the plain
    versions and each must exceed the limit.  Returns each fault's
    ``excess`` (> 1 means caught) and its largest change over the
    largest reference entry (``vs_max``)."""
    q, k, v, do, lse, delta = bargs
    nq, nk, tk = fa.TILE_Q, fa.TILE_K, k.shape[1]
    if not kw["causal"]:
        # every query sees the last key tile and every key the last
        # query tile; tiles are cut from 0, so the last may be ragged
        ks, qs = (tk - 1) // nk * nk, (q.shape[1] - 1) // nq * nq
        fdq = fa.flash_attention_dq_reference(
            q, k[:, :ks], v[:, :ks], do, lse, delta, causal=False).float()
        cdk, cdv = fa.flash_attention_dkv_reference(
            q[:, qs:], k, v, do[:, qs:], lse[..., qs:].contiguous(),
            delta[..., qs:].contiguous(), causal=False)
    else:
        tail = (q[:, -nq:], k, v, do[:, -nq:], lse[..., -nq:].contiguous(),
                delta[..., -nq:].contiguous())
        # the last query tile sees every key before the last key tile
        # (nq <= nk): unmasked
        head = (tail[0], k[:, :tk - nk], v[:, :tk - nk], *tail[3:])
        fdq = rdq.float().clone()
        fdq[:, -nq:] = fa.flash_attention_dq_reference(
            *head, causal=False).float()
        cdk, cdv = fa.flash_attention_dkv_reference(*tail, **kw)
    faults = {"dq": (fdq, rdq), "dk": (rdk.float() - cdk.float(), rdk),
              "dv": (rdv.float() - cdv.float(), rdv)}
    return {g: {"excess": grad_check(torch, f, r, bits)["excess"],
                "vs_max": ((f - r.float()).abs().max()
                           / r.float().abs().max()).item()}
            for g, (f, r) in faults.items()}


def attention_kernel_phase(torch, bw, peaks, flush):
    """B1, B2 and B3 against their plain versions at lm_small training
    shapes and eight more variants; returns the main row of each kernel."""
    import importlib

    # the module (the ops package exports a function of the same name)
    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")

    variants = {  # name: (Tq, Tk, H, Hkv, D, dtype, causal, window, sinks,
                  #        g_lse)
        "main": (T_TRAIN, T_TRAIN, H, H, D, "bf16", True, None, 0, False),
        "f32": (T_TRAIN, T_TRAIN, H, H, D, "f32", True, None, 0, False),
        "gqa": (T_TRAIN, T_TRAIN, H, 4, D, "bf16", True, None, 0, False),
        "gqa_f32": (T_TRAIN, T_TRAIN, H, 4, D, "f32", True, None, 0, False),
        "window": (T_TRAIN, T_TRAIN, H, H, D, "bf16", True, 256, 4, False),
        "window_f32": (T_TRAIN, T_TRAIN, H, H, D, "f32", True, 256, 4, False),
        "noncausal": (T_TRAIN, T_TRAIN, H, H, D, "bf16", False, None, 0,
                      False),
        "ragged": (1000, 1000, H, H, D, "bf16", True, None, 0, False),
        "lse": (384, T_TRAIN, H, H, D, "bf16", True, None, 0, True),
        # lm_small's width in 6 heads of 128
        "d128": (T_TRAIN, T_TRAIN, 6, 6, 128, "bf16", True, None, 0, False),
    }
    g = torch.Generator().manual_seed(6)
    main = None
    for name, spec in variants.items():
        rows = attention_variant(torch, fa, bw, peaks, flush,
                                 "attention_kernel", name, spec, g)
        if name == "main":
            main = rows
    autograd_layouts_check(torch, fa)
    return main


def autograd_layouts_check(torch, fa):
    """The autograd functions hand B1-B3 what their designs read: at head
    dims 64 and 80 (bf16, causal, B = 2, T = 256, 4 heads), a ``.sum()``
    loss, whose cotangent autograd expands (strides of 0), and a loss
    through a q view of a [B, T, H, D + 4] tensor (a head stride of 136
    or 168 bytes), each through ``flash_attention`` and
    ``flash_attention_lse``.  Each backward's B2/B3 outputs are held
    element by element (:func:`grad_check`) to the plain versions on the
    tensors the backward was given, and must be the gradients the caller
    gets.  Raises if a limit is broken or a kernel refuses its inputs."""
    from fluxdistributed_tpu_torch.ops import (flash_attention,
                                               flash_attention_lse)

    b, t, h = 2, 256, 4
    bad = []
    for d in (D, VITH_D):
        g = torch.Generator().manual_seed(21)
        src = {"plain": torch.randn(b, t, h, d, generator=g),
               "skewed": torch.randn(b, t, h, d + 4, generator=g)}
        k, v = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
        row = {}
        for name, fn, q_of in (("sum", "flash_attention", "plain"),
                               ("skewed_q", "flash_attention", "skewed"),
                               ("sum_lse", "flash_attention_lse", "plain"),
                               ("skewed_q_lse", "flash_attention_lse",
                                "skewed")):
            leaves = [x.bfloat16().cuda().requires_grad_()
                      for x in (src[q_of], k, v)]
            q = leaves[0][..., :d]
            seen, inner = [], fa._backward

            def recording(*args, _inner=inner, _seen=seen):
                out = _inner(*args)
                _seen.append((args, out))
                return out

            fa._backward = recording
            try:
                if fn == "flash_attention":
                    flash_attention(q, *leaves[1:], True).sum().backward()
                else:
                    out, lse = flash_attention_lse(q, *leaves[1:], True)
                    (out.sum() + lse.sum()).backward()
            finally:
                fa._backward = inner
            torch.cuda.synchronize()
            (q_, k_, v_, o_, lse_, g_, g_lse, _), grads = seen[0]
            delta = (g_.float() * o_.float()).sum(-1).permute(0, 2, 1)
            if g_lse is not None:
                delta = delta - g_lse.float()
            bargs = (q_, k_, v_, g_, lse_, delta.contiguous())
            refs = (fa.flash_attention_dq_reference(*bargs, causal=True),
                    *fa.flash_attention_dkv_reference(*bargs, causal=True))
            excess = {n: grad_check(torch, got, ref, "bf16")["excess"]
                      for n, got, ref in zip(("dq", "dk", "dv"), grads, refs)}
            caller = (leaves[0].grad[..., :d], leaves[1].grad, leaves[2].grad)
            same = all(torch.equal(a, b_) for a, b_ in zip(caller, grads))
            row[name] = {"through": fn, "cotangent_strides": list(g_.stride()),
                         "q_head_stride_bytes": q.stride(2) * q.element_size(),
                         "backward_q_is_a_copy": q_.data_ptr() != q.data_ptr(),
                         "excess": excess,
                         "caller_grads_are_the_kernels": same}
            if not same or any(not x <= 1.0 for x in excess.values()):
                bad.append(f"{name} D={d}")
        emit({"phase": "attention_kernel", "variant": "autograd_layouts",
              "shape": [b, t, t, h, h, d], "dtype": "bf16", "causal": True,
              "design": {kn: kernel_design(fa, kn, torch.bfloat16, d)
                         for kn in ("fwd", "dq", "dkv")},
              "grad_tol": GRAD_TOL["bf16"], "cases": row})
    if bad:
        raise RuntimeError(f"attention_kernel autograd_layouts: {bad} out "
                           f"of the element-wise limit or not the caller's")


def attention_variant(torch, fa, bw, peaks, flush, phase, name, spec, g,
                      batch=B, strided=False, ref_block=128):
    """One variant of B1, B2 and B3 against their plain versions at
    ``batch`` rows: errors, the element-wise gradient check (with the
    dropped-tile control where Tq = Tk and there is no window), times,
    bound and the fastest SDPA backend; emits the row, raises if a
    limit is broken, and returns the three kernels' rows.  ``strided``
    makes q, k and v views of one ``[batch, T, 3, H, D]`` tensor (a
    ViT's QKV projection), which the kernels must read in place.
    ``ref_block`` is the plain versions' query and key block."""
    (tq, tk, h, hkv, d, bits, causal, window, sinks, with_lse) = spec
    B = batch  # noqa: N806 — the rows of this variant
    dt = torch.float32 if bits == "f32" else torch.bfloat16
    dev = torch.device("cuda")
    if strided:
        qkv = torch.randn(B, tq, 3, h, d, generator=g).to(dt).to(dev)
        q, k, v = qkv.unbind(2)
        do = torch.randn(B, tq, h, d, generator=g).to(dt).to(dev)
        # the views the backward kernels read: the Hopper kernels take
        # them through TMA as they are (or raise), the others copy what
        # they cannot read; B1's are checked where it runs, below
        in_place = {"b2_b3": all(a is b for a, b in zip(
            fa._kernel_views("dq", q, k, v, do), (q, k, v, do)))}
    else:
        q, do = (torch.randn(B, tq, h, d, generator=g).to(dt).to(dev)
                 for _ in range(2))
        k, v = (torch.randn(B, tk, hkv, d, generator=g).to(dt).to(dev)
                for _ in range(2))
        in_place = None
    kw = dict(causal=causal, window=window, sinks=sinks)
    rkw = dict(kw, block_q=ref_block, block_k=ref_block)
    if strided:  # the views B1's wrapper hands its kernel
        in_place["b1"] = all(a is b for a, b in zip(fa._b1_views(q, k, v),
                                                    (q, k, v)))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **rkw)
    delta = (do.float() * ref_out.float()).sum(-1).permute(0, 2, 1)
    if with_lse:  # the LSE cotangent folds into delta
        delta = delta - torch.randn(B, h, tq, generator=g).to(dev)
    delta = delta.contiguous()
    bargs = (q, k, v, do, ref_lse, delta)
    dq = fa.flash_attention_dq(*bargs, **kw)
    dk, dv = fa.flash_attention_dkv(*bargs, **kw)
    rdq = fa.flash_attention_dq_reference(*bargs, **rkw)
    rdk, rdv = fa.flash_attention_dkv_reference(*bargs, **rkw)
    torch.cuda.synchronize()
    allow = live_pairs(torch, tq, tk, causal, window, sinks)
    live_rows = ref_lse > -1e29
    pairs = int(allow.sum()) * B * h
    es = q.element_size()
    row_io = B * h * tq * 4  # one f32 [B, H, Tq] row-stat array
    qo_bytes, kv_bytes = B * tq * h * d * es, B * tk * hkv * d * es
    work = {  # kernel: (flops, bytes) of the least work
        "fwd": (4 * pairs * d, 2 * qo_bytes + 2 * kv_bytes + row_io),
        "dq": (6 * pairs * d, 3 * qo_bytes + 2 * kv_bytes + 2 * row_io),
        "dkv": (8 * pairs * d, 2 * qo_bytes + 4 * kv_bytes + 2 * row_io),
    }
    errs = {
        "o": (out.float() - ref_out.float()).abs().max().item(),
        "lse": (lse - ref_lse)[live_rows].abs().max().item(),
    }
    tols = {"o": 1e-5 if bits == "f32" else 2e-2, "lse": 1e-4}
    grads = {"dq": (dq, rdq), "dk": (dk, rdk), "dv": (dv, rdv)}
    for gname, (got, ref) in grads.items():
        errs[gname] = (got.float() - ref.float()).abs().max().item()
        tols[gname] = GRAD_TOL[bits]
    grad_stats = {gname: grad_check(torch, got, ref, bits)
                  for gname, (got, ref) in grads.items()}
    tiled = tq == tk and window is None
    if tiled:  # the check must see a dropped last tile
        grad_stats["dropped_last_tile"] = dropped_tile_check(
            torch, fa, bargs, kw, rdq, rdk, rdv, bits)
    finite = all(bool(torch.isfinite(x.float()).all())
                 for x in (out, dq, dk, dv))
    same_dead = bool(((lse > -1e29) == live_rows).all())
    lib_fwd = lib_bwd = None
    sdpa_ms = {}
    if not with_lse:  # SDPA gives no LSE output to take a cotangent
        for backend, (fwd, bwd) in sdpa_train(
                torch, q, k, v, do, allow,
                causal and window is None and tq == tk).items():
            sdpa_ms[backend] = {"fwd": time_stats(torch, fwd, flush),
                                "bwd": time_stats(torch, bwd, flush)}
        # the yardstick is the fastest backend, named in the row
        lib_fwd = min(sdpa_ms.items(), key=lambda kv: kv[1]["fwd"]["mean"])
        lib_bwd = min(sdpa_ms.items(), key=lambda kv: kv[1]["bwd"]["mean"])
        lib_fwd, lib_bwd = ((lib_fwd[0], lib_fwd[1]["fwd"]),
                            (lib_bwd[0], lib_bwd[1]["bwd"]))
    rows = {}
    calls = {
        "fwd": (lambda: fa.flash_attention_fwd(q, k, v, **kw),
                lambda: fa.flash_attention_fwd_reference(q, k, v, **rkw)),
        "dq": (lambda: fa.flash_attention_dq(*bargs, **kw),
               lambda: fa.flash_attention_dq_reference(*bargs, **rkw)),
        "dkv": (lambda: fa.flash_attention_dkv(*bargs, **kw),
                lambda: fa.flash_attention_dkv_reference(*bargs, **rkw)),
    }
    for kname, (kern, plain) in calls.items():
        flops, nbytes = work[kname]
        t_ops = flops / peaks[bits] * 1e3
        t_bytes = nbytes / bw * 1e3
        kt = time_stats(torch, kern, flush)
        lib = (lib_fwd if kname == "fwd" else lib_bwd) or (None, None)
        lib = lib[1]
        rows[kname] = {
            "design": kernel_design(fa, kname, dt, d),
            "ms": kt["mean"], "ms_median": kt["median"],
            "ms_spread": [kt["min"], kt["max"]],
            "plain_ms": time_ms(torch, plain, flush, iters=3),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib and lib["mean"],
            "library_ms_median": lib and lib["median"],
            "library_ms_spread": lib and [lib["min"], lib["max"]],
            "flops": flops, "bytes": nbytes}
    max_err = {"fwd": errs["o"], "dq": errs["dq"],
               "dkv": max(errs["dk"], errs["dv"])}
    for kname in rows:
        rows[kname]["max_abs_err"] = max_err[kname]
    row = {"phase": phase, "variant": name,
           "shape": [B, tq, tk, h, hkv, d], "dtype": bits,
           "plain_block": ref_block,
           "strided_qkv_read_in_place": in_place,
           "causal": causal, "window": window, "sinks": sinks,
           "lse_cotangent": with_lse, "live_pairs_per_head":
           int(allow.sum()), "errors": errs, "tolerances": tols,
           "grad_check": grad_stats, "finite": finite,
           "library": f"scaled_dot_product_attention forward "
           f"({lib_fwd[0]}, B1) / backward ({lib_bwd[0]}, B2 + B3)"
           if sdpa_ms else None,
           "sdpa_ms": {b: {k: t["mean"] for k, t in ts.items()}
                       for b, ts in sdpa_ms.items()},
           "kernels": rows}
    emit(row)
    bad = [k for k in ("o", "lse") if not errs[k] <= tols[k]]
    bad += [k for k in grads if not grad_stats[k]["excess"] <= 1.0]
    if tiled:
        bad += [f"dropped {k} passed" for k, r in
                grad_stats["dropped_last_tile"].items()
                if not r["excess"] > 1.0]
    if strided and not all(in_place.values()):
        bad.append(f"strided q/k/v copied: {in_place}")
    if bad or not finite or not same_dead:
        raise RuntimeError(f"{phase} {name}: {bad} out of "
                           f"tolerance, finite={finite}, dead rows "
                           f"agree={same_dead}")
    return rows


def train_phase(torch):
    """The CLI's training run, in-process; returns its B1-B3 launches."""
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from fluxdistributed_tpu_torch.train.__main__ import run

    reset_all_counts()  # count this phase's main path only
    t0 = time.perf_counter()
    task = run(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attn_counts()
    decode = (flash_decode.launches, flash_decode_paged.launches)
    losses = task.losses
    depth, steps = task.model.depth, task.state.step
    first, last = sum(losses[:3]) / 3, sum(losses[-5:]) / 5
    emit({"phase": "train", "argv": TRAIN_ARGV, "steps": steps,
          "wall_s": wall, "losses": losses, "loss_first3_mean": first,
          "loss_last5_mean": last, "attn_launches": launches,
          "decode_launches": list(decode)})
    if len(losses) != 40 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train: {len(losses)} losses, not all finite")
    if not last <= first - 1.0:
        raise RuntimeError(f"train: loss fell from {first:.3f} to "
                           f"{last:.3f}, less than 1 nat")
    if launches != [depth * steps] * 3 or decode != (0, 0):
        raise RuntimeError(f"train: attention launches {launches} (want "
                           f"{depth} x {steps} each), decode {decode}")
    return launches


def train_step_phase(torch, peaks):
    """lm_small (vocab 32000, B=8, T=1024, adam, bf16) train steps timed
    with CUDA events, with the flash kernels and with dense attention;
    then a profile of one flash step."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int32)).cuda()
    batch = {"tokens": toks}
    for attn in ("flash", "dense"):
        model = lm_small(vocab=32000, attn_fn=attention_core(attn), seed=0)
        nparams = sum(p.numel() for p in model.parameters())
        opt = optim.adam(1e-3)
        state = TrainState.create(dict(model.named_parameters()), opt)
        step = make_train_step(lm_loss_fn(model), opt)
        for _ in range(3):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = attn_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
        ev[0].record()
        for i in range(10):
            state, m = step(state, batch)
            ev[i + 1].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(10)]
        launched = [a - b for a, b in zip(attn_counts(), before)]
        step_ms = sum(ms) / len(ms)
        tok_s = B * T_TRAIN / (step_ms / 1e3)
        row = {"phase": "train_step", "attn": attn, "model": "lm_small",
               "vocab": 32000, "batch": B, "seqlen": T_TRAIN,
               "dtype": "bfloat16", "opt": "adam", "params": nparams,
               "step_ms": step_ms, "step_ms_each": ms, "tokens_per_s": tok_s,
               "mfu": 6 * nparams * tok_s / peaks["bf16"],
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "attn_launches": launched, "loss": m["loss"].item()}
        emit(row)
        want = [model.depth * 10] * 3 if attn == "flash" else [0, 0, 0]
        if launched != want or not math.isfinite(row["loss"]):
            raise RuntimeError(f"train_step {attn}: attention launches "
                               f"{launched} (want {want}), loss "
                               f"{row['loss']}")
        if attn == "flash":
            profile_train_step(torch, step, state, batch)
        del model, state, step, m
        torch.cuda.empty_cache()


def profile_train_step(torch, step, state, batch, steps=3):
    """Where a flash train step's time goes: host wall per step (no
    profiler), device busy time per step under the profiler, and the
    largest device ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    dev, count = {}, 0
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0))
            dev[row.key] = dev.get(row.key, 0.0) + us
            count += row.count
    busy_ms = sum(dev.values()) / steps / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "train_profile", "what": "lm_small flash train step "
          "(bf16, B=8, T=1024, vocab 32000, adam)", "steps": steps,
          "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms if dev else None,
          "device_idle_share": 1 - busy_ms / wall_ms if dev else None,
          "device_kernels_per_step": count / steps if dev else None,
          "top_device_ms_per_step": [[k[:70], v / steps / 1e3]
                                     for k, v in top]})


def train_parity_phase(torch):
    """Two f32 lm_small flash train steps on the card (B1-B3) and on the
    CPU (their plain versions), from the same weights and batches."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 32000, (2, 128)).astype(np.int32)
               for _ in range(2)]
    result = {}
    for where in ("cuda", "cpu"):
        model = lm_small(vocab=32000, dtype=torch.float32, seed=2,
                         attn_fn=attention_core("flash"), device=where)
        opt = optim.adam(3e-4)
        state = TrainState.create(dict(model.named_parameters()), opt)
        step = make_train_step(lm_loss_fn(model), opt, guard=True)
        before = attn_counts()
        rows = []
        for b in batches:
            state, m = step(state, {"tokens": torch.from_numpy(b).to(where)})
            rows.append(m["guard"].tolist())  # [loss, global grad norm]
        used = [a - b for a, b in zip(attn_counts(), before)]
        want = [model.depth * 2] * 3 if where == "cuda" else [0, 0, 0]
        if used != want:
            raise RuntimeError(f"train_parity {where}: attention launches "
                               f"{used}, want {want}")
        result[where] = rows
        del model, state
    rel = [[abs(g - c) / abs(c) for g, c in zip(gr, cr)]
           for gr, cr in zip(result["cuda"], result["cpu"])]
    emit({"phase": "train_parity", "model": "lm_small", "dtype": "float32",
          "batch": 2, "seqlen": 128, "steps": 2, "opt": "adam",
          "card_loss_gnorm": result["cuda"], "cpu_loss_gnorm": result["cpu"],
          "rel_diff": rel, "tol": [1e-4, 1e-3]})
    if any(r[0] > 1e-4 or r[1] > 1e-3 for r in rel):
        raise RuntimeError(f"train_parity: card vs CPU differ: {rel}")


AUDIT_SEEDS = 8


def rounding_audit_phase(torch, flush):
    """bf16 B2 and B3 in their audit instantiations: at the main
    attention shape over ``AUDIT_SEEDS`` seeds, and on the inputs of
    every layer's attention backward in one lm_small train step (vocab
    32000, B=8, T=1024, adam, random tokens), with B2's and B3's times
    on the first and last layers' inputs beside their times on the last
    seed's randn inputs.  Reported, not held: the
    card-only tests hold a fixed seed to 0 misses."""
    import importlib

    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    keys = fa.AUDIT_COUNTS

    def total(runs):
        return {k: {c: sum(r[k][c] for r in runs) for c in keys}
                for k in ("dq", "dkv")}

    t0 = time.perf_counter()
    seeds = []
    for seed in range(AUDIT_SEEDS):
        g = torch.Generator().manual_seed(100 + seed)
        q, do = (torch.randn(B, T_TRAIN, H, D, generator=g).bfloat16().cuda()
                 for _ in range(2))
        k, v = (torch.randn(B, T_TRAIN, H, D, generator=g).bfloat16().cuda()
                for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
        seeds.append(fa.rounding_audit(q, k, v, do, lse, delta.contiguous(),
                                       causal=True))
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    # B2's and B3's times on the last seed's randn inputs, beside the
    # step's layers below (where more pairs are flagged)
    rargs, rkw = (q, k, v, do, lse, delta.contiguous()), dict(causal=True)
    times = {"randn_last_seed": {
        "dq": time_stats(torch, lambda: fa.flash_attention_dq(*rargs, **rkw),
                         flush),
        "dkv": time_stats(torch,
                          lambda: fa.flash_attention_dkv(*rargs, **rkw),
                          flush)}}
    del rargs

    # one train step whose attention backward is audited layer by layer
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int32)).cuda()
    model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
    opt = optim.adam(1e-3)
    state = TrainState.create(dict(model.named_parameters()), opt)
    step = make_train_step(lm_loss_fn(model), opt)
    for _ in range(2):  # the audited step is the third, as in training
        state, _ = step(state, {"tokens": toks})
    layers, captured, backward = [], [], fa._backward

    def audited(q, k, v, o, lse, g, g_lse, cfg):
        # the same delta as the backward's (the LM takes no LSE cotangent)
        delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
        args = (q, k, v, g, lse, delta.contiguous())
        kw = {n: cfg[n] for n in ("causal", "window", "sinks")}
        layers.append(fa.rounding_audit(*args, **kw))
        captured.append((args, kw))
        return backward(q, k, v, o, lse, g, g_lse, cfg)

    fa._backward = audited
    try:
        state, _ = step(state, {"tokens": toks})
    finally:
        fa._backward = backward
    torch.cuda.synchronize()
    # autograd runs the layers' backwards last layer first
    for name, (args, kw) in (("last_layer", captured[0]),
                             ("first_layer", captured[-1])):
        times[name] = {
            "dq": time_stats(torch, lambda: fa.flash_attention_dq(*args, **kw),
                             flush),
            "dkv": time_stats(torch,
                              lambda: fa.flash_attention_dkv(*args, **kw),
                              flush)}
    del model, state, step, captured
    torch.cuda.empty_cache()
    if len(layers) != 12:
        raise RuntimeError(f"rounding_audit: {len(layers)} layers audited")
    row = {"phase": "rounding_audit", "counts": list(keys),
           "main_shape": {"shape": [B, T_TRAIN, H, D], "dtype": "bf16",
                          "causal": True, "seeds": AUDIT_SEEDS,
                          "total": total(seeds), "per_seed": seeds,
                          "seconds": seed_s},
           "train_step": {"model": "lm_small", "vocab": 32000, "batch": B,
                          "seqlen": T_TRAIN, "step": 3, "layers": len(layers),
                          "total": total(layers), "per_layer": layers,
                          "kernel_ms": times}}
    for where in ("main_shape", "train_step"):
        for kname, c in row[where]["total"].items():
            c["flag_rate"] = c["flagged"] / max(c["live_pairs"], 1)
    emit(row)
    return row


def no_overlap(outs, ins) -> bool:
    """True when no output's bytes overlap any input's."""
    def span(t):
        lo = t.data_ptr()
        return lo, lo + t.numel() * t.element_size()

    return all(span(o)[1] <= span(i)[0] or span(i)[1] <= span(o)[0]
               for o in outs for i in ins)


def fused_adam_phase(torch, bw, flush):
    """B6 against its plain version at lm_small's packed size, steps 0
    and 7, with a cosine schedule's learning rate; returns the step-7
    row."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.ops.fused_adam import (fused_adam,
                                                          fused_adam_plain)
    from fluxdistributed_tpu_torch.parallel.zero1_fused import (
        _step_scalars, fused_adam_update)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    p, grad, m, v = (torch.randn(N_PACKED, generator=g, device=dev)
                     for _ in range(4))
    grad.mul_(0.1)
    m.mul_(0.01)
    v.abs_().mul_(0.01)
    lr = optim.cosine_decay(3e-4, 40)
    b1, b2, eps = 0.9, 0.999, 1e-8
    nbytes = 7 * 4 * N_PACKED  # p, g, m, v read; p', m', v' written
    row = None
    for step in (0, 7):
        sc = _step_scalars(step, lr, b1, b2).to(dev)
        out = fused_adam_update(p, grad, m, v, step, lr=lr)
        ref = fused_adam_plain(p, grad, m, v, sc, b1, b2, eps)
        torch.cuda.synchronize()
        err = max((a - r).abs().max().item() for a, r in zip(out, ref))
        equal = all(torch.equal(a, r) for a, r in zip(out, ref))
        fresh = no_overlap(out, (p, grad, m, v, sc))
        # the library yardstick: torch's fused Adam on copies (in place;
        # it divides sqrt(v) by sqrt(c2) and adds eps after, so its
        # numbers differ and are recorded, not held)
        lib = [t.clone() for t in (p, grad, m, v)]
        t_step = [torch.tensor([float(step + 1)], device=dev)]
        eta = float(sc[0])

        def library():
            torch._fused_adam_([lib[0]], [lib[1]], [lib[2]], [lib[3]], [],
                               t_step, lr=eta, beta1=b1, beta2=b2,
                               weight_decay=0.0, eps=eps, amsgrad=False,
                               maximize=False)

        library()
        torch.cuda.synchronize()
        lib_err = (lib[0] - out[0]).abs().max().item()
        del out, ref
        row = {"phase": "fused_adam_kernel", "n": N_PACKED, "step": step,
               "lr": eta, "max_abs_err": err, "bitwise_equal": equal,
               "outputs_fresh": fresh, "tol": 0.0,
               "ms": time_ms(torch, lambda: fused_adam(
                   p, grad, m, v, sc, b1=b1, b2=b2, eps=eps), flush),
               "plain_ms": time_ms(torch, lambda: fused_adam_plain(
                   p, grad, m, v, sc, b1, b2, eps), flush, iters=10),
               "library_ms": time_ms(torch, library, flush),
               "library": "torch._fused_adam_",
               "library_max_abs_err_p": lib_err,
               "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
               "bytes": nbytes}
        del lib
        emit(row)
        if not (equal and err == 0.0 and fresh):
            raise RuntimeError(f"fused_adam step {step}: bitwise {equal}, "
                               f"max |err| {err}, outputs fresh {fresh}")
    try:
        fused_adam_update(p[:1000], grad[:1000], m[:1000], v[:1000], 0)
    except ValueError:
        pass
    else:
        raise RuntimeError("fused_adam_update took a ragged length")
    del p, grad, m, v
    torch.cuda.empty_cache()
    return row


def zero1_train_phase(torch, peaks):
    """On a one-rank NCCL group: lm_small trained 40 steps through the
    fused ZeRO-1 step, then the three steps timed at vocab 32000 and a
    profile of the fused one.  Returns B6's launches in the 40 steps."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import (PrefetchLoader,
                                                SyntheticTextDataset)
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, make_train_step_zero1,
        make_train_step_zero1_fused, packed_size, zero1_fused_state,
        zero1_state)

    mesh = init_distributed("cuda")
    try:
        if (torch.distributed.get_backend(), mesh.size) != ("nccl", 1):
            raise RuntimeError(f"zero1: expected one NCCL rank, got "
                               f"{torch.distributed.get_backend()} x "
                               f"{mesh.size}")
        steps = 40
        model = lm_small(vocab=256, attn_fn=attention_core("flash"), seed=0)
        loader = PrefetchLoader(
            SyntheticTextDataset(vocab=256, seqlen=T_TRAIN), B, cycles=steps,
            mesh=mesh)
        state = zero1_fused_state(dict(model.named_parameters()), mesh)
        step = make_train_step_zero1_fused(lm_loss_fn(model), mesh, lr=3e-4)
        reset_all_counts()  # count this run's main path only
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            state, m = step(state, batch)
            losses.append(m["loss"])
        losses = torch.stack(losses).float().cpu().tolist()
        wall = time.perf_counter() - t0
        launches, attn = fused_adam.launches, attn_counts()
        first, last = sum(losses[:3]) / 3, sum(losses[-5:]) / 5
        emit({"phase": "zero1_train", "model": "lm_small", "vocab": 256,
              "batch": B, "seqlen": T_TRAIN, "opt": "adam", "lr": 3e-4,
              "ranks": mesh.size, "backend": "nccl", "steps": steps,
              "wall_s": wall, "losses": losses, "loss_first3_mean": first,
              "loss_last5_mean": last, "fused_adam_launches": launches,
              "attn_launches": attn,
              "opt_state_elems": [state.opt_state["m"].numel(),
                                  state.opt_state["v"].numel()]})
        if not all(math.isfinite(x) for x in losses) or not last < 1.5:
            raise RuntimeError(f"zero1_train: loss {first:.3f} -> {last:.3f} "
                               "(want below 1.5)")
        if launches != steps or attn != [model.depth * steps] * 3:
            raise RuntimeError(f"zero1_train: B6 {launches} launches for "
                               f"{steps} steps, B1-B3 {attn}")
        del model, state, step, loader
        torch.cuda.empty_cache()

        model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
        params = dict(model.named_parameters())
        nparams = sum(p.numel() for p in params.values())
        if packed_size(params, 1) != N_PACKED:
            raise RuntimeError(f"lm_small packs to {packed_size(params, 1)}, "
                               f"not {N_PACKED}")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, 32000, (B, T_TRAIN)).astype(np.int32)).cuda()
        batch = {"tokens": toks}
        loss_fn, opt = lm_loss_fn(model), optim.adam(3e-4)
        makers = {
            "zero1_fused": lambda: (
                zero1_fused_state(params, mesh),
                make_train_step_zero1_fused(loss_fn, mesh, lr=3e-4)),
            "zero1": lambda: (zero1_state(params, opt, mesh),
                              make_train_step_zero1(loss_fn, opt, mesh)),
            "one_device": lambda: (
                TrainState.create({k: p.detach().clone()
                                   for k, p in params.items()}, opt),
                make_train_step(loss_fn, opt)),
        }
        for mode, make in makers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, step = make()
            for _ in range(3):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            before = fused_adam.launches
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
            ev[0].record()
            for i in range(10):
                state, m = step(state, batch)
                ev[i + 1].record()
            torch.cuda.synchronize()
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(10)]
            step_ms = sum(ms) / len(ms)
            tok_s = B * T_TRAIN / (step_ms / 1e3)
            row = {"phase": "zero1_step", "mode": mode, "model": "lm_small",
                   "vocab": 32000, "batch": B, "seqlen": T_TRAIN,
                   "dtype": "bfloat16", "opt": "adam", "ranks": mesh.size,
                   "params": nparams, "step_ms": step_ms, "step_ms_each": ms,
                   "tokens_per_s": tok_s,
                   "mfu": 6 * nparams * tok_s / peaks["bf16"],
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "fused_adam_launches": fused_adam.launches - before,
                   "loss": m["loss"].item()}
            emit(row)
            want = 10 if mode == "zero1_fused" else 0
            if row["fused_adam_launches"] != want or not math.isfinite(
                    row["loss"]):
                raise RuntimeError(f"zero1_step {mode}: {row}")
            if mode == "zero1_fused":
                profile_zero1_step(torch, state, step, batch)
            del state, step, m
            torch.cuda.empty_cache()
        del model, params
        torch.cuda.empty_cache()
        return launches
    finally:
        shutdown_distributed()


def profile_zero1_step(torch, state, step, batch, steps=3):
    """Where a fused ZeRO-1 step's time goes: wall per step, device busy
    per step, B6's device time and the NCCL collectives' entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    dev = {}
    for r in prof.key_averages():
        if r.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(r, "self_device_time_total",
                         getattr(r, "self_cuda_time_total", 0.0))
            dev[r.key] = dev.get(r.key, 0.0) + us
    busy_ms = sum(dev.values()) / steps / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    b6 = sum(us for k, us in dev.items() if "fused_adam" in k)
    nccl = {k[:70]: us / steps / 1e3 for k, us in dev.items()
            if "nccl" in k.lower()}
    emit({"phase": "zero1_profile", "what": "lm_small fused ZeRO-1 step "
          "(bf16, B=8, T=1024, vocab 32000, one NCCL rank)", "steps": steps,
          "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms if dev else None,
          "device_idle_share": 1 - busy_ms / wall_ms if dev else None,
          "fused_adam_device_ms_per_step": b6 / steps / 1e3 if dev else None,
          "nccl_device_ms_per_step": nccl,
          "top_device_ms_per_step": [[k[:70], v / steps / 1e3]
                                     for k, v in top]})


def zero1_cli_phase(torch):
    """``python -m fluxdistributed_tpu_torch.train ... --zero1``
    in-process (composable ZeRO-1 on a one-rank NCCL group)."""
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam
    from fluxdistributed_tpu_torch.train.__main__ import run

    reset_all_counts()
    t0 = time.perf_counter()
    task = run(ZERO1_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses, steps = task.losses, task.state.step
    first, last = sum(losses[:3]) / 3, sum(losses[-5:]) / 5
    attn = attn_counts()
    emit({"phase": "zero1_cli", "argv": ZERO1_ARGV, "steps": steps,
          "ranks": task.mesh.size, "wall_s": wall, "losses": losses,
          "loss_first3_mean": first, "loss_last5_mean": last,
          "attn_launches": attn, "fused_adam_launches": fused_adam.launches,
          "group_ended": not torch.distributed.is_initialized()})
    if len(losses) != 20 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"zero1_cli: {len(losses)} losses, not all finite")
    if not last <= first - 1.0 or torch.distributed.is_initialized():
        raise RuntimeError(f"zero1_cli: loss {first:.3f} -> {last:.3f}, "
                           "group ended "
                           f"{not torch.distributed.is_initialized()}")
    if attn != [task.model.depth * steps] * 3:
        raise RuntimeError(f"zero1_cli: attention launches {attn}")


# ZeRO-1 parity: the card's fused step against the card's one-device adam
# step and the CPU's fused step.  Losses 1e-5 relative.  Params: Adam's
# update lr * mhat / (sqrt(vhat) + eps) is about lr * sign(g) for a
# gradient well above eps, so an entry whose gradient is near 0 and
# differs in sign between two runs (the card sums in another order than
# the CPU, and sums the embedding gradient with atomics) moves by up to
# ~2 lr per step apart.  Params are held to 2 lr x steps absolute, and at
# most 1e-3 of the entries may differ by more than 1e-6.
PARITY_LR = 3e-4


def zero1_parity_phase(torch):
    """Two f32 lm_small steps from the same weights and batches: the
    fused ZeRO-1 step on a one-rank NCCL group (B1-B3, B6) against the
    card's one-device adam step and the fused step on the CPU."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, make_train_step_zero1_fused,
        zero1_fused_state)

    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 32000, (2, 128)).astype(np.int32)
               for _ in range(2)]

    def run(where, fused):
        model = lm_small(vocab=32000, dtype=torch.float32, seed=2,
                         attn_fn=attention_core("flash"), device=where)
        loss_fn = lm_loss_fn(model)
        mesh = init_distributed(where) if fused else None
        try:
            if fused:
                state = zero1_fused_state(dict(model.named_parameters()), mesh)
                step = make_train_step_zero1_fused(loss_fn, mesh,
                                                   lr=PARITY_LR)
            else:
                opt = optim.adam(PARITY_LR)
                state = TrainState.create(dict(model.named_parameters()), opt)
                step = make_train_step(loss_fn, opt)
            before = fused_adam.launches
            losses = []
            for b in batches:
                state, m = step(state,
                                {"tokens": torch.from_numpy(b).to(where)})
                losses.append(m["loss"].item())
            used = fused_adam.launches - before
            return losses, {k: p.cpu() for k, p in state.params.items()}, used
        finally:
            if fused:
                shutdown_distributed()

    card = run("cuda", True)
    refs = {"card_one_device": run("cuda", False),
            "cpu_fused": run("cpu", True)}
    row = {"phase": "zero1_parity", "model": "lm_small", "dtype": "float32",
           "batch": 2, "seqlen": 128, "steps": 2, "lr": PARITY_LR,
           "card_fused_losses": card[0], "fused_adam_launches": card[2],
           "tol": {"loss_rel": 1e-5,
                   "param_abs": 2 * PARITY_LR * len(batches),
                   "share_past_1e-6": 1e-3}}
    bad = []
    for name, (losses, params, used) in refs.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(card[0], losses)]
        diff = [(card[1][k] - p).abs() for k, p in params.items()]
        worst = max(d.max().item() for d in diff)
        over = sum(int((d > 1e-6).sum()) for d in diff)
        total = sum(d.numel() for d in diff)
        row[name] = {"losses": losses, "loss_rel_diff": rel,
                     "param_max_abs_diff": worst,
                     "params_past_1e-6": over, "params": total,
                     "fused_adam_launches": used}
        if (max(rel) > 1e-5 or worst > 2 * PARITY_LR * len(batches)
                or over > 1e-3 * total):
            bad.append(name)
    emit(row)
    if bad or card[2] != 2 or refs["cpu_fused"][2] != 0:
        raise RuntimeError(f"zero1_parity: {bad} out of tolerance, B6 "
                           f"launches card {card[2]}")


def image_batch(torch, n, size, classes, dtype, device, seed):
    """A random NHWC image batch and one-hot labels, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, size, size, 3, device=device, generator=g).to(dtype)
    y = torch.randint(0, classes, (n,), device=device, generator=g)
    return {"image": x,
            "label": torch.nn.functional.one_hot(y, classes).float()}


def vision_parity_phase(torch):
    """Full-width f32 resnet50 (10 classes, 64², batch 8; TF32 off) on
    the card and on the CPU from the same seed and batches: 3 momentum
    steps, then the eval step's top-1/top-5 on a fresh batch."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import resnet50
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_eval_step, make_train_step, module_loss_fn)

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("vision_parity: TF32 must be off")
    reset_all_counts()
    batches = [image_batch(torch, 8, 64, 10, torch.float32, "cpu", s)
               for s in range(4)]
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = resnet50(num_classes=10, dtype=torch.float32, device=where,
                         seed=3)
        opt = optim.momentum(0.01, 0.9)
        loss_fn = module_loss_fn(model, logitcrossentropy)
        state = TrainState.create(
            dict(model.named_parameters()), opt,
            model_state={k: b.clone() for k, b in model.named_buffers()})
        step = make_train_step(loss_fn, opt)
        losses = []
        for b in batches[:3]:
            state, m = step(state, {k: v.to(where) for k, v in b.items()})
            losses.append(m["loss"].item())
        _, acc = make_eval_step(loss_fn, topk=(1, 5))(
            state, {k: v.to(where) for k, v in batches[3].items()})
        out[where] = (losses, {k: v.cpu() for k, v in
                               {**state.params, **state.model_state}.items()},
                      {k: v.item() for k, v in acc.items()},
                      time.perf_counter() - t0)
        del model, state, step
    (gl, gs, ga, gt), (cl, cs, ca, ct) = out["cuda"], out["cpu"]
    loss_rel = [abs(g - c) / abs(c) for g, c in zip(gl, cl)]
    # element-wise rtol 1e-3, atol 1e-5 of each leaf's scale
    worst, worst_leaf = 0.0, None
    for k, c in cs.items():
        tol = 1e-3 * c.abs() + 1e-5 * max(1.0, c.abs().max().item())
        r = ((gs[k] - c).abs() / tol).max().item()
        if r > worst:
            worst, worst_leaf = r, k
    counts = all_counts()
    emit({"phase": "vision_parity", "model": "resnet50", "dtype": "float32",
          "tf32": False, "classes": 10, "image": 64, "batch": 8, "steps": 3,
          "opt": "momentum 0.01", "card_losses": gl, "cpu_losses": cl,
          "loss_rel_diff": loss_rel, "worst_leaf_err_over_tol": worst,
          "worst_leaf": worst_leaf, "card_eval": ga, "cpu_eval": ca,
          "card_s": gt, "cpu_s": ct, "b1_b6_launches": counts})
    if max(loss_rel) > 1e-4 or worst > 1.0 or ga != ca:
        raise RuntimeError(f"vision_parity: losses {loss_rel}, worst leaf "
                           f"{worst_leaf} at {worst:.3g} x tol, eval card "
                           f"{ga} cpu {ca}")
    if counts != [0] * 6:
        raise RuntimeError(f"vision_parity: B1-B6 launched {counts}")


def is_bn_kernel(name: str) -> bool:
    """A BatchNorm kernel: PyTorch's native ``batch_norm_*`` kernels and
    cuDNN's ``bn_*`` ones."""
    low = name.lower()
    return "batch_norm" in low or low.startswith("bn_") or "_bn_" in low


def is_flash_kernel(name: str) -> bool:
    """One of B1-B3 (``flash_fwd*``, ``flash_bwd_dq*``,
    ``flash_bwd_dkv*``; the profiler gives the demangled signature)."""
    return "flash_fwd" in name or "flash_bwd" in name


def profile_vision_step(torch, step, state, batch, steps=1, share=None):
    """Where an image model's step time goes: host wall per step, device
    busy and idle share under the profiler, kernels a step, the largest
    device ops, and the device time and share of the kernels ``share``
    picks by name (``{label: predicate}``; default BatchNorm's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    dev, count = {}, 0
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0))
            dev[row.key] = dev.get(row.key, 0.0) + us
            count += row.count
    if not dev:
        return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": None,
                "device_idle_share": None}
    busy_ms = sum(dev.values()) / steps / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "device_kernels_per_step": count / steps}
    for label, pick in (share if share is not None
                        else {"bn": is_bn_kernel}).items():
        ms = sum(us for k, us in dev.items() if pick(k)) / steps / 1e3
        out[f"{label}_kernel_ms_per_step"] = ms
        out[f"{label}_kernel_share"] = ms / busy_ms
    out["top_device_ms_per_step"] = [[k[:80], v / steps / 1e3]
                                     for k, v in top]
    return out


def vision_train_step_phase(torch, peaks, card):
    """The ResNet-50 train step (224², 1000 classes, bf16 compute and f32
    params, batch 256, momentum 0.01, a bf16 batch on the card), on one
    device and through a one-rank NCCL group whose synchronised
    BatchNorm path is live: step ms over 10 steps, images/s, MFU from
    the model's own multiply-add count, peak bytes, and a profile."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import resnet50
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    reset_all_counts()
    batch = image_batch(torch, VISION_B, VISION_SIZE, 1000, torch.bfloat16,
                        "cuda", 0)
    model = resnet50(num_classes=1000, seed=0)
    macs = model.forward_macs(VISION_SIZE)
    # training ~ 3 x the forward (the backward computes the input's and
    # the weights' gradients), 2 FLOPs a multiply-add
    flops_per_image = 3 * 2 * macs
    nparams = sum(p.numel() for p in model.parameters())
    for path in ("one_device", "nccl_rank"):
        mesh = init_distributed("cuda") if path == "nccl_rank" else None
        try:
            opt = optim.momentum(0.01, 0.9)
            state = TrainState.create(
                dict(model.named_parameters()), opt,
                model_state={k: b.clone() for k, b in model.named_buffers()})
            step = make_train_step(
                module_loss_fn(model, logitcrossentropy, mesh), opt,
                mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
            ev[0].record()
            for i in range(10):
                state, m = step(state, batch)
                ev[i + 1].record()
            torch.cuda.synchronize()
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(10)]
            step_ms = sum(ms) / len(ms)
            img_s = VISION_B / (step_ms / 1e3)
            row = {"phase": "vision_train_step", "path": path,
                   "card": card, "model": "resnet50", "image": VISION_SIZE,
                   "classes": 1000, "batch": VISION_B, "dtype": "bfloat16",
                   "params_dtype": "float32", "opt": "momentum 0.01",
                   "params": nparams, "forward_macs_per_image": macs,
                   "train_flops_per_image": flops_per_image,
                   "warm3_s": warm_s, "step_ms": step_ms,
                   "step_ms_each": ms, "images_per_s": img_s,
                   "mfu": flops_per_image * img_s / peaks["bf16"],
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "loss": m["loss"].item()}
            row.update(profile_vision_step(torch, step, state, batch))
            emit(row)
            if not math.isfinite(row["loss"]):
                raise RuntimeError(f"vision_train_step {path}: loss "
                                   f"{row['loss']}")
            del state, step, m
            torch.cuda.empty_cache()
        finally:
            if mesh is not None:
                shutdown_distributed()
    counts = all_counts()
    if counts != [0] * 6:
        raise RuntimeError(f"vision_train_step: B1-B6 launched {counts}")


def vision_cli_phase(torch):
    """``python -m fluxdistributed_tpu_torch.train --model resnet50
    --dataset synthetic ...`` in-process: the loss falls; the eval
    top-1/top-5 and the loader's waits are printed."""
    from fluxdistributed_tpu_torch.obs import get_registry
    from fluxdistributed_tpu_torch.train import evaluate
    from fluxdistributed_tpu_torch.train.__main__ import run

    def loader_series():
        return {k: v for k, v in get_registry().snapshot().items()
                if k.startswith(("fdtpu_data_", "fdtpu_train_phase"))}

    reset_all_counts()
    before = loader_series()
    t0 = time.perf_counter()
    task = run(VISION_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # this run's share of the process registry's sums and counts
    data = {k: v - before.get(k, 0.0) for k, v in loader_series().items()
            if k.endswith(("_sum", "_count", "_total"))}
    losses = task.losses
    ev = evaluate(task, task.loader.dataset, batch_size=VISION_B,
                  max_batches=2, topk=(1, 5))
    counts = all_counts()
    first, last5 = losses[0], sum(losses[-5:]) / 5
    emit({"phase": "vision_cli", "argv": VISION_ARGV, "steps": len(losses),
          "wall_s": wall, "losses": losses, "loss_first": first,
          "loss_last5_mean": last5, "eval": ev, "b1_b6_launches": counts,
          "loader_and_phases": data})
    if len(losses) != 30 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"vision_cli: {len(losses)} losses, not all "
                           "finite")
    if not last5 < first:
        raise RuntimeError(f"vision_cli: loss {first:.3f} -> mean of the "
                           f"last 5 {last5:.3f}")
    if counts != [0] * 6:
        raise RuntimeError(f"vision_cli: B1-B6 launched {counts}")


# the device loop: graphed steps a call in the bit-equality runs and in
# the timing
DL_K, DL_KT = 4, 8


def _state_leaves(state):
    from fluxdistributed_tpu_torch.tree import leaves

    return leaves((state.params, state.opt_state, state.model_state))


def _clone_state(torch, state):
    from fluxdistributed_tpu_torch.tree import tree_map

    return type(state)(*(tree_map(torch.clone, x) for x in (
        state.params, state.opt_state, state.model_state)), step=state.step)


def _stack(torch, batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def graph_equality_run(torch, name, card, make_state, make_step, batches,
                       attn_per_step):
    """``make_step(DL_K)`` called twice — K eager steps and the capture,
    then one replay — against 2K eager steps from the same state and
    batches, bit for bit; then the replay on a zeroed step table from
    the eager state after K steps, which must differ.  The replay must
    launch B1-B3 ``attn_per_step`` times a step each (B4-B6 never)."""
    k = DL_K
    eager, state, losses = make_step(1), make_state(), []
    for j, b in enumerate(batches):
        state, m = eager(state, b)
        losses.append(m["loss"])
        if j == k - 1:
            mid = _clone_state(torch, state)
    graphed = make_step(k)
    g, m1 = graphed(make_state(), _stack(torch, batches[:k]))
    before = all_counts()
    g, m2 = graphed(g, _stack(torch, batches[k:]))
    torch.cuda.synchronize()
    replay_launches = [a - b for a, b in zip(all_counts(), before)]
    want = torch.stack(losses)
    got = torch.cat([m1["loss"], m2["loss"]])
    pairs = list(zip(_state_leaves(g), _state_leaves(state)))
    unequal = sum(not torch.equal(a, b) for a, b in pairs)
    graphed.table.buffer.zero_()
    c, mc = graphed.run(_clone_state(torch, mid), _stack(torch, batches[k:]),
                        fill=False)
    torch.cuda.synchronize()
    control_unequal = sum(not torch.equal(a, b) for a, b in zip(
        _state_leaves(c), _state_leaves(state)))
    row = {"phase": "device_loop_equality", "path": name, "card": card,
           "k": k, "calls": 2, "losses_eager": want.tolist(),
           "losses_graphed": got.tolist(),
           "losses_equal": bool(torch.equal(got, want)),
           "state_tensors": len(pairs), "state_tensors_unequal": unequal,
           "launches_per_replay": graphed.graphs[0].launches_per_replay,
           "replay_launches_b4_b5_b1_b2_b3_b6": replay_launches,
           "control": "zeroed step table, fill=False",
           "control_losses": mc["loss"].tolist(),
           "control_state_tensors_unequal": control_unequal}
    emit(row)
    if not row["losses_equal"] or unequal or g.step != state.step:
        raise RuntimeError(f"device_loop {name}: graphed steps differ from "
                           f"eager ones ({unequal} of {len(pairs)} state "
                           f"tensors, losses equal {row['losses_equal']})")
    if not control_unequal:
        raise RuntimeError(f"device_loop {name}: the control (a zeroed step "
                           "table) matched the eager steps")
    if replay_launches != [0, 0] + [attn_per_step * k] * 3 + [0]:
        raise RuntimeError(f"device_loop {name}: the replay launched "
                           f"B4, B5, B1-B3, B6 {replay_launches} times")
    del graphed, g, c, state, mid


def profile_steps(torch, step, state, batch, calls, steps, wall_ms,
                  top=False):
    """Device busy ms, idle share and kernels per optimizer step under
    the profiler, over ``calls`` calls of ``steps`` steps together; the
    idle share is against ``wall_ms``, the step's ms timed unprofiled by
    the caller (CUDA events between calls: the stream's time, launch
    gaps included).  ``top`` adds the 12 largest device ops' ms a
    step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    busy, count, dev = 0.0, 0, {}
    for r in prof.key_averages():
        if r.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(r, "self_device_time_total",
                         getattr(r, "self_cuda_time_total", 0.0))
            busy += us
            count += r.count
            dev[r.key] = dev.get(r.key, 0.0) + us
    if not count:
        return state, {"wall_ms_per_step": wall_ms,
                       "device_busy_ms_per_step": None,
                       "device_idle_share": None, "kernels_per_step": None}
    busy_ms = busy / steps / 1e3
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "kernels_per_step": count / steps}
    if top:
        out["top_device_ms_per_step"] = [
            [k[:80], v / steps / 1e3]
            for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:12]]
    return state, out


def time_device_loop(torch, name, card, k, make_state, make_step, batch,
                     rate, top=False):
    """One path at ``k`` steps a call: ms per optimizer step over 5
    steps (K = 1, after 3 warm-up steps) or one replay (K > 1, the first
    after the eager call and the capture: launching the graph the first
    time uploads it, microseconds of a replay of seconds) with CUDA
    events, the rate and MFU (``rate(step_ms) -> dict``), peak allocated
    bytes and a profile of one step (K = 1) or one replay (``top``: with
    its largest device ops)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, state = make_step(k), make_state()
    b = batch if k == 1 else _stack(torch, [batch] * k)
    for _ in range(3 if k == 1 else 1):  # K > 1: eager + capture
        state, m = step(state, b)
    calls = 5 if k == 1 else 1
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    ev[0].record()
    for i in range(calls):
        state, m = step(state, b)
        ev[i + 1].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) / k for i in range(calls)]
    step_ms = sum(ms) / len(ms)
    state, prof = profile_steps(torch, step, state, b, 1, k, step_ms, top)
    row = {"phase": "device_loop_step", "path": name, "card": card, "k": k,
           "graphed": k > 1, "step_ms": step_ms, "step_ms_each_call": ms,
           **rate(step_ms), **prof,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_replay": (step.graphs[0].launches_per_replay
                                   if k > 1 else None),
           "loss_last": m["loss"].reshape(-1)[-1].item()}
    emit(row)
    if not math.isfinite(row["loss_last"]):
        raise RuntimeError(f"device_loop_step {name} k={k}: loss "
                           f"{row['loss_last']}")
    del step, state, m, b
    return row


def decode_graph_run(torch, card, model, layout, prompts, steps=48):
    """The decode step of one engine layout, eager and graphed, from the
    same prefilled slots: step ms, idle share, greedy tokens equal, the
    decode kernel's launches against depth x steps."""
    import numpy as np

    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_paged)
    from fluxdistributed_tpu_torch.serve import LMEngine

    kern = flash_decode_paged if layout == "paged" else flash_decode
    row = {"phase": "decode_graph", "layout": layout, "card": card,
           "model": "lm_small", "dtype": "bfloat16", "slots": len(prompts),
           "prompt_tokens": [len(p) for p in prompts], "steps": steps}
    toks = {}
    for graphed in (False, True):
        engine = LMEngine(model, max_slots=len(prompts), max_len=1024,
                          layout=layout, cuda_graph=graphed)
        for s, p in enumerate(prompts):
            engine.prefill(s, p, 0.0, None)
        torch.cuda.synchronize()
        before = kern.launches
        out, walls = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            out.append(engine.step_decode())  # ends in a device sync
            walls.append(time.perf_counter() - t0)
        launches = kern.launches - before
        toks[graphed] = np.stack(out)
        # steady steps only: the first is eager (and the capture)
        wall_ms = statistics.median(walls[1:]) * 1e3
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                engine.step_decode()
            torch.cuda.synchronize()
        busy = sum(getattr(r, "self_device_time_total",
                           getattr(r, "self_cuda_time_total", 0.0))
                   for r in prof.key_averages()
                   if r.device_type == torch.autograd.DeviceType.CUDA)
        busy_ms = busy / 10 / 1e3
        tag = "graphed" if graphed else "eager"
        row[f"{tag}_step_ms_median"] = wall_ms
        row[f"{tag}_device_busy_ms_per_step"] = busy_ms if busy else None
        row[f"{tag}_device_idle_share"] = (1 - busy_ms / wall_ms
                                           if busy else None)
        row[f"{tag}_kernel_launches"] = launches
        if graphed:
            row["launches_per_replay"] = (
                engine.decode_graph.launches_per_replay)
        if launches != model.depth * steps:
            raise RuntimeError(f"decode_graph {layout} {tag}: {launches} "
                               f"launches for {steps} steps x depth "
                               f"{model.depth}")
        del engine
    row["tokens_equal"] = bool((toks[True] == toks[False]).all())
    emit(row)
    if not row["tokens_equal"]:
        raise RuntimeError(f"decode_graph {layout}: graphed greedy tokens "
                           "differ from the eager ones")


def dropout_cost(torch, card, flush):
    """The dropout mask of one lm_small train step on the card: the
    counter-based hash (mask and scaling) at the three sites' shapes,
    device ms a call with a cold L2 and per step (12 layers: two
    [8, 1024, 768] sites and one [8, 1024, 3072] a layer), beside one
    ``torch.rand`` draw of the same shape as the library's yardstick."""
    from fluxdistributed_tpu_torch.models.transformer_lm import (
        _dropout, dropout_keys)

    keys = dropout_keys(torch.tensor(12345, device="cuda"), 12)
    row = {"phase": "dropout_cost", "card": card, "rate": 0.1,
           "dtype": "bfloat16"}
    per_step = per_step_rand = 0.0
    for shape, sites in (((B, T_TRAIN, 768), 2), ((B, T_TRAIN, 3072), 1)):
        x = torch.randn(shape, device="cuda").to(torch.bfloat16)
        t = time_ms(torch, lambda: _dropout(x, 0.1, keys[0]), flush)
        tr = time_ms(torch, lambda: torch.where(
            torch.rand(shape, device="cuda") >= 0.1, x / 0.9,
            torch.zeros((), dtype=x.dtype, device="cuda")), flush)
        row[f"hash_ms_{shape[-1]}"], row[f"rand_ms_{shape[-1]}"] = t, tr
        per_step += 12 * sites * t
        per_step_rand += 12 * sites * tr
    row["hash_ms_per_step"] = per_step
    row["rand_ms_per_step"] = per_step_rand
    emit(row)


def device_loop_phase(torch, peaks, card):
    """Graphed train steps against eager ones bit for bit, with failing
    controls; K = 1 and K = 8 timed on four paths; the decode steps
    eager and graphed."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import (lm_loss_fn, lm_small,
                                                  resnet50)
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, make_train_step_zero1, module_loss_fn,
        zero1_state)

    rng = np.random.default_rng(9)
    tok_batches = [{"tokens": torch.from_numpy(rng.integers(
        0, 32000, (B, T_TRAIN)).astype(np.int32)).cuda()}
        for _ in range(2 * DL_K)]
    lm = lm_small(vocab=32000, attn_fn=attention_core("flash"), dropout=0.1,
                  seed=0)
    lm_params = dict(lm.named_parameters())
    lm_n = sum(p.numel() for p in lm_params.values())
    lm_opt = optim.adam(optim.warmup_cosine(3e-4, 4, 40))
    lm_loss = lm_loss_fn(lm)

    def lm_state():
        return TrainState.create({k: p.detach().clone()
                                  for k, p in lm_params.items()}, lm_opt)

    def lm_rate(ms):
        tok_s = B * T_TRAIN / (ms / 1e3)
        return {"tokens_per_s": tok_s,
                "mfu": 6 * lm_n * tok_s / peaks["bf16"]}

    rn = resnet50(num_classes=1000, seed=0)
    rn_params = dict(rn.named_parameters())
    rn_flops = 3 * 2 * rn.forward_macs(VISION_SIZE)
    rn_opt = optim.momentum(0.01, 0.9)
    img_batches = [image_batch(torch, VISION_B, VISION_SIZE, 1000,
                               torch.bfloat16, "cuda", 10 + s)
                   for s in range(2 * DL_K)]

    def rn_state():
        return TrainState.create(
            {k: p.detach().clone() for k, p in rn_params.items()}, rn_opt,
            model_state={k: b.clone() for k, b in rn.named_buffers()})

    def rn_rate(ms):
        img_s = VISION_B / (ms / 1e3)
        return {"images_per_s": img_s,
                "mfu": rn_flops * img_s / peaks["bf16"]}

    reset_all_counts()
    lm_step = lambda k: make_train_step(  # noqa: E731
        lm_loss, lm_opt, seed=0, steps_per_call=k)
    graph_equality_run(torch, "lm_small_one_device", card, lm_state,
                       lm_step, tok_batches, lm.depth)
    rows = [time_device_loop(torch, "lm_small_one_device", card, k, lm_state,
                             lm_step, tok_batches[0], lm_rate)
            for k in (1, DL_KT)]
    mesh = init_distributed("cuda")
    try:
        rn_mesh_loss = module_loss_fn(rn, logitcrossentropy, mesh)
        rn_step = lambda k: make_train_step(  # noqa: E731
            rn_mesh_loss, rn_opt, mesh=mesh, steps_per_call=k)
        graph_equality_run(torch, "resnet50_nccl_rank", card, rn_state,
                           rn_step, img_batches, 0)
        rows += [time_device_loop(torch, "resnet50_nccl_rank", card, k,
                                  rn_state, rn_step, img_batches[0], rn_rate)
                 for k in (1, DL_KT)]
        z_state = lambda: zero1_state(  # noqa: E731
            {k: p.detach() for k, p in lm_params.items()}, lm_opt, mesh)
        z_step = lambda k: make_train_step_zero1(  # noqa: E731
            lm_loss, lm_opt, mesh, seed=0, steps_per_call=k)
        graph_equality_run(torch, "lm_small_zero1_nccl_rank", card, z_state,
                           z_step, tok_batches, lm.depth)
        rows += [time_device_loop(torch, "lm_small_zero1_nccl_rank", card, k,
                                  z_state, z_step, tok_batches[0], lm_rate)
                 for k in (1, DL_KT)]
    finally:
        shutdown_distributed()
    rn_local = module_loss_fn(rn, logitcrossentropy)
    rows += [time_device_loop(
        torch, "resnet50_one_device", card, k, rn_state,
        lambda kk: make_train_step(rn_local, rn_opt, steps_per_call=kk),
        img_batches[0], rn_rate) for k in (1, DL_KT)]
    emit({"phase": "device_loop_summary", "card": card,
          "speedup_k8_over_k1": {
              r1["path"]: r1["step_ms"] / r8["step_ms"]
              for r1, r8 in zip(rows[::2], rows[1::2])}})
    del lm, lm_params, rn, rn_params, tok_batches, img_batches
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dropout_cost(torch, card, flush)
    del flush

    model = lm_small(vocab=32000, seed=0)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
               for n in (64, 160, 256, 352, 448, 544, 640, 768)]
    for layout in ("dense", "paged"):
        decode_graph_run(torch, card, model, layout, prompts)
    del model
    torch.cuda.empty_cache()


def vit_kernel_phase(torch, bw, peaks, flush):
    """B1, B2 and B3 at ViT-L/16's attention (batch 128, 196 tokens, 16
    heads of 64, non-causal, q/k/v strided views of one QKV projection):
    bf16, the class token's 197 tokens, and f32; each against its plain
    version with the dropped-tile control.  Returns the bf16 rows."""
    import importlib

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    variants = {
        "vit_l16": (VIT_T, VIT_T, VIT_HEADS, VIT_HEADS, D, "bf16", False,
                    None, 0, False),
        "class_token": (VIT_T + 1, VIT_T + 1, VIT_HEADS, VIT_HEADS, D,
                        "bf16", False, None, 0, False),
        "f32": (VIT_T, VIT_T, VIT_HEADS, VIT_HEADS, D, "f32", False, None, 0,
                False),
    }
    g = torch.Generator().manual_seed(16)
    rows = {name: attention_variant(torch, fa, bw, peaks, flush, "vit_kernel",
                                    name, spec, g, batch=VIT_B, strided=True)
            for name, spec in variants.items()}
    return rows["vit_l16"]


def vit_audit(torch, fa, step, state, batch):
    """The bf16 B2/B3 rounding audit on every layer's attention backward
    of one train step (the third, as in training): counts by kernel."""
    for _ in range(2):
        state, _ = step(state, batch)
    layers, backward = [], fa._backward

    def audited(q, k, v, o, lse, g, g_lse, cfg):
        delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
        layers.append(fa.rounding_audit(
            q, k, v, g, lse, delta.contiguous(),
            **{n: cfg[n] for n in ("causal", "window", "sinks")}))
        return backward(q, k, v, o, lse, g, g_lse, cfg)

    fa._backward = audited
    try:
        state, _ = step(state, batch)
    finally:
        fa._backward = backward
    torch.cuda.synchronize()
    total = {k: {c: sum(r[k][c] for r in layers) for c in fa.AUDIT_COUNTS}
             for k in ("dq", "dkv")}
    return layers, total


def device_ms(torch, fn, calls=10):
    """Device ms a call of ``fn``: the profiler's sum of the CUDA
    kernels' time over ``calls`` calls (after one warm-up), so host time
    between launches is not counted.  Every profile here traces the
    CUDA activity alone: the kernels and their times are those of a
    trace with the CPU ops, which costs up to 3x the host time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(r, "self_device_time_total",
                     getattr(r, "self_cuda_time_total", 0.0))
             for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3


def event_ms(torch, fn, calls=5):
    """Stream ms a call of ``fn`` between two CUDA events around
    ``calls`` calls (after one warm-up): kernel time plus any gap the
    host leaves between launches.  For chains whose kernels the
    profiler can miss (:func:`device_ms` read 0.005 ms for B1-B3's
    forward and backward late in a full run)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def layernorm_cost(torch, card, depth):
    """The flax LayerNorm (:class:`models.LayerNorm`, the formula in f32)
    forward and backward on one ViT-L/16 activation ([128, 196, 1024]
    bf16): device ms a call (:func:`device_ms`) and per step (2 a block
    and the final one), beside ``F.layer_norm`` (two-pass variance, eps
    1e-6) on the same input as the library's yardstick."""
    import torch.nn.functional as F

    from fluxdistributed_tpu_torch.models import LayerNorm

    ln = LayerNorm(1024).cuda()
    x = torch.randn(VIT_B, VIT_T, 1024, device="cuda").bfloat16()
    x.requires_grad_(True)
    g = torch.randn_like(x)

    def port():
        torch.autograd.grad(ln(x, torch.bfloat16), x, g)

    def library():
        y = F.layer_norm(x, (1024,), ln.weight.bfloat16(),
                         ln.bias.bfloat16(), 1e-6)
        torch.autograd.grad(y, x, g)

    n = 2 * depth + 1
    t, tl = device_ms(torch, port), device_ms(torch, library)
    emit({"phase": "layernorm_cost", "card": card, "shape": [VIT_B, VIT_T,
                                                              1024],
          "dtype": "bfloat16", "timing": "profiler device time",
          "fwd_bwd_ms": t, "library_fwd_bwd_ms": tl, "per_step": n,
          "ms_per_step": n * t, "library_ms_per_step": n * tl})


def vit_train_step_phase(torch, peaks, card):
    """ViT-L/16 (224², 1000 classes, batch 128, bf16 compute and f32
    params, adamw at the JAX defaults) through B1-B3: K = 4 graphs
    bit-equal to eager steps (batch 32), launches a step and a replay,
    step ms at K = 1 and K = 8, images/s, MFU, peak bytes, a profile
    with B1-B3's share, the rounding audit over the step's 24 layers,
    the LayerNorm's cost; then f32 ViT-B/16 logits on the card against
    the CPU.  Returns B1-B3's launches in one step."""
    import importlib
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import vit_b16, vit_l16
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    flash = partial(flash_attention, causal=False)
    reset_all_counts()
    model = vit_l16(num_classes=1000, attn_fn=flash, seed=0)
    params = dict(model.named_parameters())
    flops = 3 * 2 * model.forward_macs(VISION_SIZE)
    opt = optim.adamw()
    loss_fn = module_loss_fn(model, logitcrossentropy)
    batches = [image_batch(torch, VIT_B, VISION_SIZE, 1000, torch.bfloat16,
                           "cuda", 20 + s) for s in range(2 * DL_K)]

    def make_state():
        return TrainState.create({k: p.detach().clone()
                                  for k, p in params.items()}, opt)

    def make_step(k):
        return make_train_step(loss_fn, opt, seed=0, steps_per_call=k)

    def rate(ms):
        img_s = VIT_B / (ms / 1e3)
        return {"images_per_s": img_s, "mfu": flops * img_s / peaks["bf16"]}

    # K = 4 graphs against eager steps first, while the card's memory is
    # unfragmented, at batch 32 (five copies of the adamw state live)
    graph_equality_run(torch, "vit_l16_one_device_batch32", card,
                       make_state, make_step,
                       [{k: v[:32] for k, v in bt.items()} for bt in batches],
                       model.depth)
    torch.cuda.empty_cache()
    step, state = make_step(1), make_state()
    before = all_counts()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    per_step = [a - b for a, b in zip(all_counts(), before)]
    prof = profile_vision_step(torch, step, state, batches[0],
                               share={"b1_b3": is_flash_kernel})
    del state, step, m
    torch.cuda.empty_cache()
    rows = [time_device_loop(torch, "vit_l16_one_device", card, k,
                             make_state, make_step, batches[0], rate)
            for k in (1, DL_KT)]
    torch.cuda.empty_cache()
    layers, total = vit_audit(torch, fa, make_step(1), make_state(),
                              batches[0])
    torch.cuda.empty_cache()
    layernorm_cost(torch, card, model.depth)
    emit({"phase": "vit_train_step", "card": card, "model": "vit_l16",
          "image": VISION_SIZE, "tokens": model.tokens(VISION_SIZE),
          "classes": 1000, "batch": VIT_B, "dtype": "bfloat16",
          "params_dtype": "float32", "opt": "adamw (1e-3, wd 1e-2)",
          "attn": "flash_attention, causal=False (B1-B3)",
          "params": sum(p.numel() for p in params.values()),
          "forward_macs_per_image": flops // 6,
          "b4_b5_b1_b2_b3_b6_launches_one_step": per_step,
          "k1": {k: rows[0][k] for k in ("step_ms", "images_per_s", "mfu",
                                         "peak_allocated_bytes",
                                         "device_idle_share")},
          "k8": {k: rows[1][k] for k in ("step_ms", "images_per_s", "mfu",
                                         "peak_allocated_bytes",
                                         "device_idle_share",
                                         "launches_per_replay")},
          "profile_k1": prof})
    emit({"phase": "vit_rounding_audit", "card": card, "model": "vit_l16",
          "batch": VIT_B, "layers": len(layers), "counts": list(
              fa.AUDIT_COUNTS), "total": total, "per_layer": layers})
    want = [0, 0] + [model.depth] * 3 + [0]
    replay = rows[1]["launches_per_replay"]
    if per_step != want:
        raise RuntimeError(f"vit_train_step: one step launched B4, B5, "
                           f"B1-B3, B6 {per_step} times, want {want}")
    if replay != {n: model.depth * DL_KT for n in (
            "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv")}:
        raise RuntimeError(f"vit_train_step: a K={DL_KT} replay launched "
                           f"{replay}")
    if len(layers) != model.depth or any(
            t["unflagged_differ"] for t in total.values()):
        raise RuntimeError(f"vit_rounding_audit: {len(layers)} layers, "
                           f"totals {total}")
    del model, params, batches
    torch.cuda.empty_cache()

    # f32 card against CPU (TF32 off): the kernels against the plain
    # versions through the whole model
    x = image_batch(torch, 8, 64, 10, torch.float32, "cpu", 5)["image"]
    logits, launched = {}, {}
    for where in ("cuda", "cpu"):
        before = attn_counts()
        m = vit_b16(num_classes=10, image_size=64, dtype=torch.float32,
                    attn_fn=flash, device=where, seed=1)
        with torch.no_grad():
            logits[where] = m(x.to(where)).cpu()
        launched[where] = [a - b for a, b in zip(attn_counts(), before)]
        del m
    rel = ((logits["cuda"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    emit({"phase": "vit_parity", "model": "vit_b16", "dtype": "float32",
          "tf32": False, "image": 64, "tokens": 16, "batch": 8,
          "logits_max_err_over_max": rel, "tol": 1e-4,
          "b1_b3_launches": launched})
    if not rel <= 1e-4 or launched != {"cuda": [12, 0, 0],
                                       "cpu": [0, 0, 0]}:
        raise RuntimeError(f"vit_parity: {rel} over the largest logit, "
                           f"launches {launched}")
    return per_step[2:5]


def convnext_train_step_phase(torch, peaks, card):
    """ConvNeXt-XL (224², 1000 classes, bf16 compute and f32 params, lars
    0.1, drop path 0.1): K = 4 graphs bit-equal to eager steps (batch
    32); at batch 128, or the largest power of two below that fits,
    step ms at K = 1 and K = 8, images/s, MFU, peak bytes and a profile;
    B1-B6 never launch."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import convnext_xlarge
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    reset_all_counts()
    model = convnext_xlarge(num_classes=1000, drop_path_rate=0.1, seed=0)
    params = dict(model.named_parameters())
    flops = 3 * 2 * model.forward_macs(VISION_SIZE)
    opt = optim.lars(0.1)
    loss_fn = module_loss_fn(model, logitcrossentropy)

    def make_state():
        return TrainState.create({k: p.detach().clone()
                                  for k, p in params.items()}, opt)

    def make_step(k):
        return make_train_step(loss_fn, opt, seed=0, steps_per_call=k)

    graph_equality_run(torch, "convnext_xlarge_one_device_batch32", card,
                       make_state, make_step,
                       [image_batch(torch, 32, VISION_SIZE, 1000,
                                    torch.bfloat16, "cuda", 30 + s)
                        for s in range(2 * DL_K)], 0)
    torch.cuda.empty_cache()
    batch = VIT_B
    while True:
        try:
            batches = [image_batch(torch, batch, VISION_SIZE, 1000,
                                   torch.bfloat16, "cuda", 30)]

            def rate(ms):
                img_s = batch / (ms / 1e3)
                return {"images_per_s": img_s,
                        "mfu": flops * img_s / peaks["bf16"]}

            rows = [time_device_loop(torch, "convnext_xlarge_one_device",
                                     card, k, make_state, make_step,
                                     batches[0], rate, top=k == 1)
                    for k in (1, DL_KT)]
            break
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
            # a capture that runs out raises RuntimeError from the OOM
            if "out of memory" not in str(e):
                raise
            batches = None
            torch.cuda.empty_cache()
            if batch <= 16:
                raise
            batch //= 2
    # the K = 1 row's profile of one step is the step's breakdown
    prof = {k: rows[0][k] for k in ("wall_ms_per_step",
                                    "device_busy_ms_per_step",
                                    "device_idle_share", "kernels_per_step",
                                    "top_device_ms_per_step")}
    counts = all_counts()
    emit({"phase": "convnext_train_step", "card": card,
          "model": "convnext_xlarge", "image": VISION_SIZE,
          "classes": 1000, "batch": batch, "batch_wanted": VIT_B,
          "dtype": "bfloat16", "params_dtype": "float32",
          "opt": "lars 0.1", "drop_path_rate": 0.1,
          "params": sum(p.numel() for p in params.values()),
          "forward_macs_per_image": flops // 6,
          "k1": {k: rows[0][k] for k in ("step_ms", "images_per_s", "mfu",
                                         "peak_allocated_bytes",
                                         "device_idle_share")},
          "k8": {k: rows[1][k] for k in ("step_ms", "images_per_s", "mfu",
                                         "peak_allocated_bytes",
                                         "device_idle_share",
                                         "launches_per_replay")},
          "profile_k1": prof, "b1_b6_launches": counts})
    if counts != [0] * 6:
        raise RuntimeError(f"convnext_train_step: B1-B6 launched {counts}")
    del model, params, batches
    torch.cuda.empty_cache()


def vit_cli_phase(torch):
    """``python -m fluxdistributed_tpu_torch.train --model vit_b16
    --dataset synthetic ...`` in-process (the CLI's ViT is dense, as in
    JAX): the loss falls, eval top-1/top-5 on two fresh batches."""
    from fluxdistributed_tpu_torch.train import evaluate
    from fluxdistributed_tpu_torch.train.__main__ import run

    reset_all_counts()
    t0 = time.perf_counter()
    task = run(VIT_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = task.losses
    ev = evaluate(task, task.loader.dataset, batch_size=64, max_batches=2,
                  topk=(1, 5))
    counts = all_counts()
    first, last5 = losses[0], sum(losses[-5:]) / 5
    emit({"phase": "vit_cli", "argv": VIT_ARGV, "steps": len(losses),
          "wall_s": wall, "losses": losses, "loss_first": first,
          "loss_last5_mean": last5, "eval": ev, "b1_b6_launches": counts})
    if len(losses) != 20 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"vit_cli: {len(losses)} losses, not all finite")
    if not last5 < first:
        raise RuntimeError(f"vit_cli: loss {first:.3f} -> mean of the last "
                           f"5 {last5:.3f}")
    if counts != [0] * 6:
        raise RuntimeError(f"vit_cli: B1-B6 launched {counts}")


VITH_B, VITH_T, VITH_HEADS, VITH_D = 32, 256, 16, 80  # ViT-H/14 at 224²
VITH_AUDIT_SEEDS = 4


def vith_kernel_phase(torch, bw, peaks, flush):
    """B1, B2 and B3 at head dim 80, ViT-H/14's attention (batch 32, 256
    tokens and the class token's 257, 16 heads of 80, non-causal, q/k/v
    strided views of one QKV projection), bf16 and f32, each against its
    plain version with the dropped-tile control; one causal windowed GQA
    row with sinks in bf16 and f32, so that every mask runs at D = 80;
    then the bf16 rounding audit at the ViT-H/14 shape over
    ``VITH_AUDIT_SEEDS`` seeds (0 unflagged mismatches).  Returns the
    bf16 T = 256 rows."""
    import importlib

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    T, H, Dh = VITH_T, VITH_HEADS, VITH_D  # noqa: N806
    strided = {
        "vit_h14": (T, T, H, H, Dh, "bf16", False, None, 0, False),
        "vit_h14_class_token": (T + 1, T + 1, H, H, Dh, "bf16", False, None,
                                0, False),
        "vit_h14_f32": (T, T, H, H, Dh, "f32", False, None, 0, False),
        "vit_h14_class_token_f32": (T + 1, T + 1, H, H, Dh, "f32", False,
                                    None, 0, False),
    }
    g = torch.Generator().manual_seed(18)
    # the plain versions take the whole sequence as one block: a 1-row
    # remainder block (257 = 2 x 128 + 1) sends its products through
    # cuBLAS's matrix-vector path, which sums in another order than the
    # sequential f32 order the kernels' rounding flag re-sums in
    rows = {name: attention_variant(torch, fa, bw, peaks, flush,
                                    "vith_kernel", name, spec, g,
                                    batch=VITH_B, strided=True,
                                    ref_block=512)
            for name, spec in strided.items()}
    for bits in ("bf16", "f32"):
        rows[f"d80_causal_window_gqa_{bits}"] = attention_variant(
            torch, fa, bw, peaks, flush, "vith_kernel",
            f"d80_causal_window_gqa_{bits}",
            (T_TRAIN, T_TRAIN, H, 4, Dh, bits, True, 256, 4, False), g,
            batch=B)
    off = {f"{name} {kname}": r["design"] for name, row in rows.items()
           if "f32" not in name for kname, r in row.items()
           if r["design"] != fa.DESIGNS[2]}
    if off:
        raise RuntimeError(f"vith_kernel: bf16 rows off the Hopper "
                           f"kernels: {off}")
    audits = []
    for seed in range(VITH_AUDIT_SEEDS):
        ga = torch.Generator().manual_seed(200 + seed)
        qkv = torch.randn(VITH_B, T + 1, 3, H, Dh,
                          generator=ga).bfloat16().cuda()
        q, k, v = qkv.unbind(2)
        do = torch.randn(VITH_B, T + 1, H, Dh, generator=ga).bfloat16().cuda()
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
        audits.append(fa.rounding_audit(q, k, v, do, lse, delta.contiguous(),
                                        causal=False))
    torch.cuda.synchronize()
    total = {kn: {c: sum(a[kn][c] for a in audits) for c in fa.AUDIT_COUNTS}
             for kn in ("dq", "dkv")}
    emit({"phase": "vith_rounding_audit", "shape": [VITH_B, T + 1, H, Dh],
          "dtype": "bf16", "causal": False, "seeds": VITH_AUDIT_SEEDS,
          "counts": list(fa.AUDIT_COUNTS), "total": total,
          "per_seed": audits})
    if any(t["unflagged_differ"] for t in total.values()) or not all(
            t["live_pairs"] for t in total.values()):
        raise RuntimeError(f"vith_rounding_audit: {total}")
    return rows["vit_h14"]


def _set_core(model, attn_fn):
    """Every block of a ViT with the attention core ``attn_fn`` (None:
    the dense core)."""
    for mod in model.modules():
        if hasattr(mod, "attn_fn") and hasattr(mod, "in_proj_weight"):
            mod.attn_fn = attn_fn


def vith_train_step_phase(torch, peaks, card):
    """ViT-H/14 (224², 1000 classes, 32 blocks, 632 M params) with the
    flash core: first in f32 (TF32 off) at batch 2, the flash core's
    logits and gradients against the dense core's on the same weights
    and images (logits within 1e-4 of the largest, as ``vit_parity``;
    each gradient leaf within 1e-3 of its largest entry); then in bf16
    compute, f32 params, adamw, batch 32: B1-B3 32 launches each a step,
    the eager step ms, images/s, MFU, peak allocated bytes, idle share
    (the f32 model's weights, switched to bf16 compute).  Returns
    B1-B3's launches in one step."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import vit_h14
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    flash = partial(flash_attention, causal=False)
    torch.cuda.empty_cache()
    model = vit_h14(num_classes=1000, dtype=torch.float32, attn_fn=flash,
                    seed=3)
    batch = image_batch(torch, 2, VISION_SIZE, 1000, torch.float32, "cuda", 9)
    loss_fn = module_loss_fn(model, logitcrossentropy)
    params = dict(model.named_parameters())
    out = {}
    for core in ("flash", "dense"):
        _set_core(model, flash if core == "flash" else None)
        model.zero_grad(set_to_none=True)
        before = attn_counts()
        logits = model(batch["image"]).float()
        logitcrossentropy(logits, batch["label"]).backward()
        torch.cuda.synchronize()
        out[core] = (logits.detach(), {k: p.grad.detach().clone()
                                       for k, p in params.items()},
                     [a - b for a, b in zip(attn_counts(), before)])
    model.zero_grad(set_to_none=True)
    (lf, gf, nf), (ld, gd, nd) = out["flash"], out["dense"]
    logit_rel = ((lf - ld).abs().max() / ld.abs().max()).item()
    grad_rel = max(((gf[k] - gd[k]).abs().max()
                    / gd[k].abs().max().clamp(min=1e-30)).item() for k in gd)
    depth = model.depth
    nparams = sum(p.numel() for p in params.values())
    emit({"phase": "vith_parity", "model": "vit_h14", "dtype": "float32",
          "tf32": False, "image": VISION_SIZE, "batch": 2,
          "tokens": model.tokens(VISION_SIZE), "head_dim": VITH_D,
          "params": nparams, "logits_max_err_over_max": logit_rel,
          "logits_tol": 1e-4, "grad_max_err_over_leaf_max": grad_rel,
          "grad_tol": 1e-3, "b1_b3_launches_flash": nf,
          "b1_b3_launches_dense": nd})
    if not (logit_rel <= 1e-4 and grad_rel <= 1e-3) or nf != [depth] * 3 \
            or nd != [0, 0, 0]:
        raise RuntimeError(f"vith_parity: logits {logit_rel}, grads "
                           f"{grad_rel}, launches flash {nf} dense {nd}")
    del loss_fn, out, lf, gf, ld, gd, batch
    torch.cuda.empty_cache()

    # the same weights (f32 params) in bf16 compute with the flash core:
    # a second 632 M-parameter init would repeat the first
    model.dtype = torch.bfloat16
    _set_core(model, flash)
    flops = 3 * 2 * model.forward_macs(VISION_SIZE)
    opt = optim.adamw()
    loss_fn = module_loss_fn(model, logitcrossentropy)
    batch = image_batch(torch, VITH_B, VISION_SIZE, 1000, torch.bfloat16,
                        "cuda", 21)

    def make_state():
        return TrainState.create({k: p.detach().clone()
                                  for k, p in params.items()}, opt)

    def make_step(k):
        return make_train_step(loss_fn, opt, seed=0, steps_per_call=k)

    def rate(ms):
        img_s = VITH_B / (ms / 1e3)
        return {"images_per_s": img_s, "mfu": flops * img_s / peaks["bf16"]}

    step, state = make_step(1), make_state()
    reset_all_counts()  # one step of this path, counted alone
    state, m = step(state, batch)
    torch.cuda.synchronize()
    per_step = all_counts()
    prof = profile_vision_step(torch, step, state, batch, share={
        "b1_b3": is_flash_kernel, "b1": lambda n: "flash_fwd" in n,
        "b2": lambda n: "flash_bwd_dq" in n,
        "b3": lambda n: "flash_bwd_dkv" in n})
    del step, state, m
    torch.cuda.empty_cache()
    row = time_device_loop(torch, "vit_h14_one_device", card, 1, make_state,
                           make_step, batch, rate)
    emit({"phase": "vith_train_step", "card": card, "model": "vit_h14",
          "image": VISION_SIZE, "tokens": model.tokens(VISION_SIZE),
          "head_dim": VITH_D, "classes": 1000, "batch": VITH_B,
          "dtype": "bfloat16", "params_dtype": "float32",
          "opt": "adamw (1e-3, wd 1e-2)",
          "attn": "flash_attention, causal=False (B1-B3 at D = 80)",
          "params": nparams, "forward_macs_per_image": flops // 6,
          "b4_b5_b1_b2_b3_b6_launches_one_step": per_step,
          "k1": {k: row[k] for k in ("step_ms", "images_per_s", "mfu",
                                     "peak_allocated_bytes",
                                     "device_idle_share",
                                     "device_busy_ms_per_step",
                                     "kernels_per_step")},
          "profile_k1": prof})
    want = [0, 0] + [depth] * 3 + [0]
    if per_step != want:
        raise RuntimeError(f"vith_train_step: one step launched B4, B5, "
                           f"B1-B3, B6 {per_step} times, want {want}")
    del model, params, batch
    torch.cuda.empty_cache()
    return per_step[2:5]


RESUME_K, RESUME_ITEMS, RESUME_AT = 8, 4, 2
#: checkpoints of the resume phases, inside the checkout (git-ignored),
#: removed by the vision server phase
CKPT_DIR = "_chip_smoke_ckpt"


class _ImageBank:
    """Images drawn from a bank of 64 random ones made from a seed: a
    loader's batch is a gather, so a 256-image batch costs the host a
    copy, not 38 M normal draws."""

    def __init__(self, size, nclasses, seed=0):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.bank = rng.standard_normal((64, size, size, 3), np.float32)
        self.bank_labels = rng.integers(0, nclasses, 64).astype(np.int32)
        self.nclasses = nclasses

    def __len__(self):
        return 64

    def batch(self, rng, n):
        idx = rng.integers(0, 64, n)
        return self.bank[idx], self.bank_labels[idx]


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def _preempt_and_resume(torch, make_task, directory, at):
    """A task trained under a fault plan that SIGTERMs at item ``at``
    (checkpoint and RESUME manifest in ``directory``), then a fresh task
    resumed from them and trained to the end: (the resumed task, its
    manifest, the preempted run's losses)."""
    from fluxdistributed_tpu_torch import faults
    from fluxdistributed_tpu_torch.train import (NullLogger, resume_training,
                                                 train)

    task = make_task()
    faults.install_plan(faults.FaultPlan().sigterm_at_step(at))
    try:
        train(task, print_every=0, eval_every=0, logger=NullLogger(),
              checkpoint_dir=directory, checkpoint_every=0,
              handle_signals=True)
        raise RuntimeError("resume: the fault plan's SIGTERM did not "
                           "preempt the run")
    except faults.Preempted:
        pass
    finally:
        faults.clear_plan()
    head = list(task.losses)
    del task
    torch.cuda.empty_cache()
    task = make_task()
    manifest = resume_training(task, directory)
    train(task, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=directory, checkpoint_every=0)
    return task, manifest, head


def resume_phase(torch, card):
    """Preempt and resume on the card, bit for bit.  ResNet-50 (224²,
    1000 classes, batch 256, bf16, momentum 0.01) on one device at
    ``steps_per_call`` 8, each call one CUDA graph replay: 4 items
    uninterrupted, then 4 items with a fault-plan SIGTERM at item 2,
    resumed in a fresh task (its step captured anew); every state tensor
    and every loss must be equal.  Then the checkpoint's bytes, the
    blocking save and the load seconds, and the ms of an item with and
    without a non-blocking save after it.  Then the fused ZeRO-1 step
    (B6) on lm_small (vocab 32000, B=8, T=1024, bf16, flash) on one NCCL
    rank: 6 steps, against 3 steps, a SIGTERM, a checkpoint (the flat
    buffers gathered) and 3 steps from a fresh state loaded from it.
    Returns the ResNet-50 checkpoint's directory."""
    import os
    import shutil

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import resnet50
    from fluxdistributed_tpu_torch.train import (
        NullLogger, load_checkpoint, prepare_training, save_checkpoint,
        train, wait_for_pending)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    bank = _ImageBank(VISION_SIZE, 1000, seed=7)
    cycles = RESUME_K * RESUME_ITEMS

    def make_task():
        model = resnet50(num_classes=1000, seed=0)
        return prepare_training(model, bank, optim.momentum(0.01, 0.9),
                                batch_size=VISION_B, cycles=cycles,
                                steps_per_call=RESUME_K)

    t0 = time.perf_counter()
    base = make_task()
    train(base, print_every=0, eval_every=0, logger=NullLogger())
    base_leaves = [x.clone() for x in _state_leaves(base.state)]
    base_losses, base_step = list(base.losses), base.state.step
    del base
    torch.cuda.empty_cache()
    d = os.path.join(CKPT_DIR, "resnet50")
    task, manifest, head = _preempt_and_resume(torch, make_task, d,
                                               RESUME_AT)
    torch.cuda.synchronize()
    leaves = _state_leaves(task.state)
    unequal = sum(not torch.equal(a, b) for a, b in zip(leaves, base_leaves))
    losses_equal = head + task.losses == base_losses
    wall = time.perf_counter() - t0

    # the checkpoint's cost: bytes, a blocking save and a load
    ck = os.path.join(CKPT_DIR, "cost")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    save_checkpoint(task.state, ck, task.state.step)
    save_s = time.perf_counter() - t1
    nbytes = _dir_bytes(os.path.join(ck, f"step_{task.state.step}"))
    t1 = time.perf_counter()
    back = load_checkpoint(ck, task.state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    back_equal = all(torch.equal(a, b) for a, b in zip(
        _state_leaves(back), leaves))
    del back
    # an item (8 graphed steps) with and without a non-blocking save
    batch = _stack(torch, [image_batch(torch, VISION_B, VISION_SIZE, 1000,
                                       torch.float32, "cuda", 30 + j)
                           for j in range(RESUME_K)])
    state, step = task.state, task.step_fn
    state, _ = step(state, batch)
    # two items a sample: with a save after the first, whose write then
    # overlaps the second, as a cadence save overlaps the next items
    item_ms = {"no_save": [], "nonblocking_save": []}
    for _ in range(3):
        for mode in item_ms:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = step(state, batch)
            if mode == "nonblocking_save":
                save_checkpoint(state, ck, state.step, block=False)
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            item_ms[mode].append((time.perf_counter() - t1) * 1e3 / 2)
            wait_for_pending()
    row = {"phase": "resume_resnet50", "card": card, "model": "resnet50",
           "image": VISION_SIZE, "classes": 1000, "batch": VISION_B,
           "dtype": "bfloat16", "opt": "momentum 0.01",
           "steps_per_call": RESUME_K, "graphed": True,
           "items": RESUME_ITEMS, "preempted_at_item": RESUME_AT,
           "manifest": manifest, "steps": task.state.step,
           "state_tensors": len(leaves), "state_tensors_unequal": unequal,
           "losses_equal": losses_equal, "wall_s": wall,
           "checkpoint_bytes": nbytes, "blocking_save_s": save_s,
           "load_s": load_s, "load_equal": back_equal,
           "item_ms": item_ms,
           "item_ms_mean": {k: sum(v) / len(v) for k, v in item_ms.items()},
           "nonblocking_save_cost_ms_per_item": 2 * (
               sum(item_ms["nonblocking_save"]) - sum(item_ms["no_save"]))
           / len(item_ms["no_save"])}
    emit(row)
    if (unequal or not losses_equal or task.state.step != base_step
            or manifest is None or manifest["next_item"] != RESUME_AT
            or not back_equal):
        raise RuntimeError(f"resume_resnet50: {unequal} of {len(leaves)} "
                           f"state tensors differ, losses equal "
                           f"{losses_equal}, manifest {manifest}")
    shutil.rmtree(ck, ignore_errors=True)
    del task, state, step, batch, leaves, base_leaves
    torch.cuda.empty_cache()
    resume_fused_phase(torch, card)
    return d


def resume_fused_phase(torch, card):
    """The fused ZeRO-1 step (B6) preempted and resumed on one NCCL rank
    (see :func:`resume_phase`)."""
    import os

    from fluxdistributed_tpu_torch import faults
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam
    from fluxdistributed_tpu_torch.parallel import (
        make_train_step_zero1_fused, zero1_fused_state)
    from fluxdistributed_tpu_torch.train import (load_checkpoint,
                                                 save_checkpoint)

    steps, at = 6, 3
    mesh = init_distributed("cuda")
    try:
        model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
        params = dict(model.named_parameters())
        g = torch.Generator(device="cuda").manual_seed(11)
        batches = [{"tokens": torch.randint(0, 32000, (B, T_TRAIN),
                                            generator=g, device="cuda",
                                            dtype=torch.int32)}
                   for _ in range(steps)]
        step = make_train_step_zero1_fused(lm_loss_fn(model), mesh, lr=3e-4)

        def run(state, start, plan_at=None, directory=None):
            """Steps from ``start`` with the trainer's boundary check: a
            signal checkpoints and stops."""
            flag = faults.SignalFlag().install()
            if plan_at is not None:
                faults.install_plan(faults.FaultPlan().sigterm_at_step(
                    plan_at))
            losses = []
            try:
                for j in range(start, steps):
                    faults.fire("step", index=j)
                    if flag.is_set():
                        save_checkpoint(state, directory, state.step,
                                        mesh=mesh, zero1=True)
                        return state, losses, j
                    state, m = step(state, batches[j])
                    losses.append(m["loss"])
            finally:
                flag.uninstall()
                faults.clear_plan()
            return state, losses, steps

        reset_all_counts()
        base, base_losses, _ = run(zero1_fused_state(params, mesh), 0)
        launches = fused_adam.launches
        base_leaves = [x.clone() for x in _state_leaves(base)]
        del base
        d = os.path.join(CKPT_DIR, "lm_small_zero1_fused")
        st, head, stopped = run(zero1_fused_state(params, mesh), 0,
                                plan_at=at, directory=d)
        del st
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        st = load_checkpoint(d, zero1_fused_state(params, mesh), mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        st, tail, _ = run(st, at)
        torch.cuda.synchronize()
        leaves = _state_leaves(st)
        unequal = sum(not torch.equal(a, b)
                      for a, b in zip(leaves, base_leaves))
        losses_equal = bool(torch.equal(torch.stack(head + tail),
                                        torch.stack(base_losses)))
        row = {"phase": "resume_zero1_fused", "card": card,
               "model": "lm_small", "vocab": 32000, "batch": B,
               "seqlen": T_TRAIN, "dtype": "bfloat16", "opt": "adam (B6)",
               "ranks": mesh.size, "backend": "nccl", "steps": steps,
               "preempted_at_step": stopped, "state_tensors": len(leaves),
               "state_tensors_unequal": unequal,
               "losses_equal": losses_equal,
               "fused_adam_launches_uninterrupted": launches,
               "checkpoint_bytes": _dir_bytes(os.path.join(d, f"step_{at}")),
               "load_s": load_s}
        emit(row)
        if unequal or not losses_equal or stopped != at or launches != steps:
            raise RuntimeError(f"resume_zero1_fused: {row}")
        del model, params, batches, st, leaves, base_leaves
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()


VISION_REQUESTS = 64


def vision_serve_phase(torch, card, checkpoint):
    """The vision server's ``predict`` built by ``make_app`` on ResNet-50
    from the resume phase's checkpoint, 64 single-image requests through
    its decode-free twin (uint8 256x256 images; the card machine has no
    JPEG decoder): each top-1 must equal the model's own eval forward on
    the same image, loaded from the checkpoint apart; p50/p99 ms a
    request and images/s.  Removes the checkpoints."""
    import argparse
    import shutil

    import numpy as np

    from fluxdistributed_tpu_torch.data.preprocess import preprocess
    from fluxdistributed_tpu_torch.serve.vision import (load_image_model,
                                                        make_app)

    args = argparse.Namespace(model="resnet50", num_classes=1000,
                              checkpoint=checkpoint, step=None,
                              torch_weights=None, synset=None, topk=5,
                              device="cuda")
    predict = make_app(args)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (VISION_REQUESTS, 256, 256, 3),
                          dtype=np.uint8)
    for img in images[:4]:  # warm-up
        predict.from_array(img)
    ms, top1 = [], []
    t0 = time.perf_counter()
    for img in images:
        t1 = time.perf_counter()
        preds = predict.from_array(img)
        ms.append((time.perf_counter() - t1) * 1e3)
        top1.append(int(preds[0]["label"].split()[-1]))
    wall = time.perf_counter() - t0
    model, source = load_image_model("resnet50", 1000,
                                     checkpoint=checkpoint, device="cuda")
    want = []
    with torch.no_grad():
        for img in images:
            x = torch.from_numpy(preprocess(img)[None]).cuda()
            want.append(int(model(x).float().argmax(-1)))
    agree = sum(a == b for a, b in zip(top1, want))
    q = np.percentile(ms, [50, 99])
    row = {"phase": "vision_serve", "card": card, "model": "resnet50",
           "weights": source, "requests": VISION_REQUESTS,
           "input": "uint8 256x256x3 (predict.from_array)", "topk": 5,
           "p50_ms": float(q[0]), "p99_ms": float(q[1]),
           "mean_ms": sum(ms) / len(ms), "images_per_s": VISION_REQUESTS / wall,
           "top1_agree": agree, "distinct_top1": len(set(top1))}
    emit(row)
    del model, predict
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if agree != VISION_REQUESTS:
        raise RuntimeError(f"vision_serve: top-1 of {agree} of "
                           f"{VISION_REQUESTS} requests equals the model's")



# the guard and observation phases: lm_small (vocab 32000, B = 8,
# T = 1024, bf16, flash, adam) at K = 8 graphed steps an item
GUARD_K = 8
ROLLBACK_CFG = {"rollback_after": 3, "anomaly_window": 8}


class _TokenBank:
    """Random tokens at ``vocab``, drawn from the loader's generator (a
    synthetic Markov stream at vocab 32000 would need 8 GB of host
    tables)."""

    def __init__(self, vocab, seqlen):
        self.vocab, self.seqlen = vocab, seqlen

    def batch(self, rng, n):
        import numpy as np

        return rng.integers(0, self.vocab, (n, self.seqlen), dtype=np.int32)


def _lm_task(items, k=GUARD_K, guard=True):
    """The lm_small task of the guard phases: ``items`` loader items of
    ``k`` steps, the sentinel in the step with ``guard``."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.train import prepare_training

    model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
    return prepare_training(model, _TokenBank(32000, T_TRAIN),
                            optim.adam(3e-4), loss_fn=lm_loss_fn(model),
                            batch_size=B, cycles=k * items,
                            steps_per_call=k, topk=(), guard=guard)


def _guarded_run(torch, make_task, plan=None, **kw):
    """``train`` of a fresh task under a fault plan: (losses, state
    tensors, quarantined items, step)."""
    from fluxdistributed_tpu_torch import faults
    from fluxdistributed_tpu_torch.train import NullLogger, train

    task = make_task()
    if plan:
        faults.install_plan(faults.FaultPlan.from_spec({"fail": plan}))
    try:
        train(task, print_every=0, eval_every=0, logger=NullLogger(), **kw)
    finally:
        faults.clear_plan()
    out = (list(task.losses), [x.clone() for x in _state_leaves(task.state)],
           list(task.quarantined_items), task.state.step)
    del task
    torch.cuda.empty_cache()
    return out


def _same_run(a, b) -> dict:
    return {"losses_equal": a[0] == b[0],
            "state_tensors": len(a[1]),
            "state_tensors_unequal": sum(not x.equal(y)
                                         for x, y in zip(a[1], b[1])),
            "quarantined": a[2], "steps": a[3]}


def guard_phase(torch, card):
    """The anomaly guard on the card.  lm_small at K = 8, graphed: a
    ``train.grad`` NaN at item 2 is quarantined, bit-equal to the clean
    run given ``quarantine=[2]`` (every loss, every state tensor); three
    poisoned items inside the anomaly window roll back to the banked
    checkpoint and replay, bit-equal to their clean-skip run; anomalies
    that keep coming halt the CLI with ``HALTED_RC`` and leave the
    manifest.  Then the fused ZeRO-1 step (B6) guarded on one NCCL rank
    at K = 1: one poisoned step quarantined, bit-equal to its clean
    skip.  B1-B3 and B6 launches over the phase."""
    import importlib
    import os
    import shutil

    from fluxdistributed_tpu_torch import faults, optim
    from fluxdistributed_tpu_torch.data import PrefetchLoader
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.obs import get_registry
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import (
        make_eval_step, make_train_step_zero1_fused, zero1_fused_state)
    from fluxdistributed_tpu_torch.train import (GuardConfig,
                                                 read_resume_manifest)
    from fluxdistributed_tpu_torch.train.trainer import TrainTask

    t0 = time.perf_counter()
    reset_all_counts()
    reg = get_registry()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    clean = _guarded_run(torch, lambda: _lm_task(3),
                         guard=GuardConfig(quarantine=(2,)))
    hit = _guarded_run(torch, lambda: _lm_task(3), plan=[
        {"site": "train.grad", "at": 2, "action": "nan"}],
        guard=GuardConfig())
    skip = _same_run(hit, clean)
    rb_clean = _guarded_run(torch, lambda: _lm_task(5),
                            guard=GuardConfig(quarantine=(2, 3, 4),
                                              **ROLLBACK_CFG))
    before = reg.value("fdtpu_guard_rollbacks_total")
    t1 = time.perf_counter()
    rb = _guarded_run(torch, lambda: _lm_task(5), plan=[
        {"site": "train.grad", "at": 2, "action": "nan"},
        {"site": "train.loss", "at": 3, "action": "inf"},
        {"site": "train.grad", "at": 4, "action": "inf"}],
        checkpoint_dir=os.path.join(CKPT_DIR, "rollback"),
        checkpoint_every=2, guard=GuardConfig(**ROLLBACK_CFG))
    rollback = dict(_same_run(rb, rb_clean), wall_s=time.perf_counter() - t1,
                    rollbacks=reg.value("fdtpu_guard_rollbacks_total")
                    - before)
    del clean, hit, rb_clean, rb

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    d = os.path.join(CKPT_DIR, "halt")
    t1 = time.perf_counter()
    rc = cli.main([*TRAIN_ARGV[:-4], "--cycles", "6", "--eval-every", "0",
                   "--print-every", "0", "--guard", "--checkpoint-dir", d,
                   "--checkpoint-every", "2", "--guard-rollback-after", "2",
                   "--fault-plan", json.dumps({"fail": [
                       {"site": "train.loss", "times": 99,
                        "action": "nan"}]})])
    manifest = read_resume_manifest(d)
    halt = {"rc": rc, "wall_s": time.perf_counter() - t1,
            "manifest_reason": (manifest or {}).get("reason"),
            "manifest_quarantined": (manifest or {}).get(
                "quarantined_items")}
    torch.cuda.empty_cache()

    mesh = init_distributed("cuda")
    try:
        def fused_task():
            model = lm_small(vocab=32000, attn_fn=attention_core("flash"),
                             seed=0)
            loss_fn = lm_loss_fn(model)
            return TrainTask(
                state=zero1_fused_state(dict(model.named_parameters()),
                                        mesh),
                step_fn=make_train_step_zero1_fused(loss_fn, mesh, lr=3e-4,
                                                    guard=True),
                eval_fn=make_eval_step(loss_fn, mesh, topk=()),
                loader=PrefetchLoader(_TokenBank(32000, T_TRAIN), B,
                                      cycles=4, mesh=mesh),
                optimizer=optim.adam(3e-4), model=model, device=mesh.device,
                mesh=mesh, zero1=True)

        f_clean = _guarded_run(torch, fused_task,
                               guard=GuardConfig(quarantine=(1,)))
        f_hit = _guarded_run(torch, fused_task, plan=[
            {"site": "train.grad", "at": 1, "action": "nan"}],
            guard=GuardConfig())
        fused = dict(_same_run(f_hit, f_clean), ranks=mesh.size,
                     backend="nccl")
        del f_clean, f_hit
    finally:
        shutdown_distributed()
    counts = dict(zip(("flash_decode", "flash_decode_paged",
                       "flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv", "fused_adam"), all_counts()))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    row = {"phase": "guard", "card": card, "model": "lm_small",
           "vocab": 32000, "batch": B, "seqlen": T_TRAIN,
           "dtype": "bfloat16", "attn": "flash", "opt": "adam 3e-4",
           "steps_per_call": GUARD_K, "graphed": True,
           "quarantine_item_2": skip, "rollback": rollback, "halt": halt,
           "fused_zero1_k1": fused, "launches": counts,
           "wall_s": time.perf_counter() - t0}
    emit(row)
    bad = [name for name, r in (("skip", skip), ("rollback", rollback),
                                ("fused", fused))
           if not r["losses_equal"] or r["state_tensors_unequal"]]
    if (bad or skip["quarantined"] != [2]
            or rollback["quarantined"] != [2, 3, 4]
            or rollback["rollbacks"] != 1 or fused["quarantined"] != [1]
            or rc != faults.HALTED_RC or halt["manifest_reason"] != "guard"
            or not all(counts[k] for k in ("flash_attention_fwd",
                                           "flash_attention_dq",
                                           "flash_attention_dkv",
                                           "fused_adam"))):
        raise RuntimeError(f"guard: {bad} differ from their clean skips, "
                           f"or a verdict is wrong: {row}")


def _item_ms(torch, step, state, batch, items, guarded):
    """Per-item wall ms of ``items`` items after a warm-up (the eager
    call and the capture, then a replay); guarded items read the
    sentinel and take the verdict before committing, as the trainer
    does.  Returns (ms each item, ms in the sentinel read each item,
    state)."""
    from fluxdistributed_tpu_torch.obs import Registry
    from fluxdistributed_tpu_torch.train import GuardConfig, NullLogger
    from fluxdistributed_tpu_torch.train.guard import TrainGuard

    guard = TrainGuard(GuardConfig(), registry=Registry(),
                       logger=NullLogger())
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms, read = [], []
    for j in range(items):
        t1 = time.perf_counter()
        new, m = step(state, batch)
        if guarded:
            t2 = time.perf_counter()
            verdict = guard.observe(j, m)
            read.append((time.perf_counter() - t2) * 1e3)
            if verdict != "ok":
                raise RuntimeError(f"guard_cost: item {j} read {verdict}")
        state = new
        ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    return ms, read, state


def guard_cost_phase(torch, card):
    """ms per item guarded and unguarded at K = 8 (graph replays),
    median over 6 items: ResNet-50 (224², batch 256, bf16, momentum) and
    lm_small.  The guarded item copies the state into the shadow before
    its replay and reads the sentinel before its commit; the copy alone
    in device ms, the read's share of the item, and the bytes kept."""
    import statistics as st

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import (lm_loss_fn, lm_small,
                                                  resnet50)
    from fluxdistributed_tpu_torch.obs import memstats
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (TrainState,
                                                    make_train_step,
                                                    module_loss_fn)
    from fluxdistributed_tpu_torch.tree import leaves

    items = 6
    rn = resnet50(num_classes=1000, seed=0)
    lm = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
    import numpy as np

    rng = np.random.default_rng(3)
    cases = {
        "resnet50": (rn, module_loss_fn(rn, logitcrossentropy),
                     optim.momentum(0.01, 0.9), _stack(torch, [
                         image_batch(torch, VISION_B, VISION_SIZE, 1000,
                                     torch.bfloat16, "cuda", 40 + j)
                         for j in range(GUARD_K)]), VISION_B),
        "lm_small": (lm, lm_loss_fn(lm), optim.adam(3e-4), {
            "tokens": torch.from_numpy(rng.integers(
                0, 32000, (GUARD_K, B, T_TRAIN)).astype(np.int32)).cuda()},
            B),
    }
    for name, (model, loss_fn, opt, batch, nb) in cases.items():
        row = {"phase": "guard_cost", "card": card, "model": name,
               "batch": nb, "steps_per_call": GUARD_K, "graphed": True,
               "items": items}
        for guarded in (False, True):
            torch.cuda.empty_cache()
            state = TrainState.create(
                {k: p.detach().clone() for k, p in model.named_parameters()},
                opt, model_state={k: b.clone()
                                  for k, b in model.named_buffers()})
            step = make_train_step(loss_fn, opt, steps_per_call=GUARD_K,
                                   guard=guarded)
            ms, read, state = _item_ms(torch, step, state, batch, items,
                                       guarded)
            key = "guarded" if guarded else "unguarded"
            row[f"{key}_item_ms"] = ms
            row[f"{key}_item_ms_median"] = st.median(ms)
            if guarded:
                _, static, _, shadow = next(iter(step._graphs.values()))
                own, kept = leaves(static), leaves(shadow)
                row["sentinel_read_ms"] = read
                row["sentinel_read_share"] = st.median(read) / st.median(ms)
                row["state_bytes_kept"] = memstats.tree_bytes(shadow)
                row["state_copy_device_ms"] = device_ms(
                    torch, lambda: torch._foreach_copy_(kept, own))
                row["state_copy_bound_ms"] = (
                    2 * row["state_bytes_kept"] / card_rates(
                        torch.cuda.get_device_name(0))[0] * 1e3)
            del step, state
        row["guard_cost_ms_per_item"] = (row["guarded_item_ms_median"]
                                         - row["unguarded_item_ms_median"])
        row["guard_cost_share"] = (row["guard_cost_ms_per_item"]
                                   / row["unguarded_item_ms_median"])
        emit(row)
    del rn, lm, cases
    torch.cuda.empty_cache()


def _prom_value(text, prefix):
    for line in text.splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return None


def observe_phase(torch, card):
    """The observation layer on the card.  The port's CLI trains lm_small
    (vocab 256, flash, adam) at K = 8 for 6 items with --metrics-port,
    --trace-events, --metrics-jsonl, --flight and --watchdog-factor 5; a
    thread scrapes /metrics and /healthz mid-run (``fdtpu_hbm_*`` must
    read the card: in use > 0, at most its memory); the trace holds
    dispatch spans and the loader's h2d spans, the flight dump one record
    an item with its phase split.  A library run takes
    ``train(profile_dir=..., profile_start=2, profile_steps=2)``
    (lm_small, vocab 32000, eager steps): the trace names B1.  Then ms
    per item of lm_small at K = 8 with ``observation=None``,
    ``Observation.default()`` and ``Observation.full()`` (5 items each,
    two interleaved rounds, after a warm-up run).  Last, model
    selection: 8 replicas of ResNet-18 at 32², 10 classes, 64 images a
    replica a step, 2 cycles of 4 steps; after each selection the replicas are equal and the
    chosen one is the argmin of the val losses."""
    import functools
    import importlib
    import os
    import shutil

    import numpy as np

    from fluxdistributed_tpu_torch import obs as obs_pkg
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.obs import Observation, read_flight
    from fluxdistributed_tpu_torch.ops.metrics import onehot
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_model_selection,
                                                 train,
                                                 train_model_selection)

    d = os.path.join(CKPT_DIR, "observe")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    total = torch.cuda.mem_get_info()[1]
    started, servers, scraped = threading.Event(), [], {}
    real = obs_pkg.start_metrics_server

    def spy(**kw):
        srv = real(**kw)
        servers.append(srv)
        started.set()
        return srv

    def scrape():
        if not started.wait(300):
            return
        base = f"http://127.0.0.1:{servers[0].port}"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            try:
                text = urllib.request.urlopen(base + "/metrics",
                                              timeout=10).read().decode()
            except OSError:
                return
            step = _prom_value(text, "fdtpu_train_step ")
            if step is not None and step >= 2 * GUARD_K:
                scraped["step"] = step
                scraped["hbm_in_use"] = _prom_value(
                    text, "fdtpu_hbm_bytes_in_use{")
                scraped["hbm_peak"] = _prom_value(text, "fdtpu_hbm_bytes_peak{")
                scraped["hbm_limit"] = _prom_value(
                    text, "fdtpu_hbm_bytes_limit{")
                scraped["headroom"] = _prom_value(
                    text, "fdtpu_hbm_headroom_ratio ")
                scraped["health"] = json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=10).read())
                return
            time.sleep(0.05)

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    obs_pkg.start_metrics_server = spy
    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        rc = cli.main([*TRAIN_ARGV[:-4], "--cycles", str(6 * GUARD_K),
                       "--eval-every", "0", "--print-every", "2",
                       "--steps-per-call", str(GUARD_K), "--metrics-port",
                       "0", "--trace-events", os.path.join(d, "trace.json"),
                       "--metrics-jsonl", os.path.join(d, "metrics.jsonl"),
                       "--flight", os.path.join(d, "flight.jsonl"),
                       "--watchdog-factor", "5"])
    finally:
        obs_pkg.start_metrics_server = real
    th.join(60)
    cli_s = time.perf_counter() - t0
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events]
    main_tid = next(e["tid"] for e in events if e["name"] == "dispatch")
    fl = read_flight(os.path.join(d, "flight.jsonl"))
    flight_phases = sorted({k for r in fl["records"] for k in r["phases"]})
    row = {"phase": "observe_cli", "card": card, "rc": rc, "wall_s": cli_s,
           "scraped": scraped,
           "card_bytes": total, "spans": {n: names.count(n) for n in
                                          sorted(set(names))},
           "h2d_on_loader_threads": all(e["tid"] != main_tid for e in events
                                        if e["name"] == "h2d"),
           "flight_records": len(fl["records"]),
           "flight_phases": flight_phases,
           "flight_end": (fl["end"] or {}).get("status"),
           "jsonl_lines": sum(1 for _ in open(os.path.join(
               d, "metrics.jsonl")))}
    emit(row)
    hbm = scraped.get("hbm_in_use")
    if (rc != 0 or hbm is None or not 0 < hbm <= total
            or scraped.get("hbm_limit") != total
            or not scraped["health"].get("ok")
            or row["spans"].get("dispatch", 0) != 6
            or row["spans"].get("h2d", 0) != 6
            or not row["h2d_on_loader_threads"]
            or row["flight_records"] != 6 or row["flight_end"] != "done"
            or not {"data_wait", "dispatch", "device"} <= set(flight_phases)):
        raise RuntimeError(f"observe_cli: {row}")

    # the profiler window, through the library
    t = _lm_task(5, k=1, guard=False)
    pd = os.path.join(d, "profile")
    train(t, print_every=0, eval_every=0, logger=NullLogger(),
          profile_dir=pd, profile_start=2, profile_steps=2)
    with open(os.path.join(pd, "trace.json")) as f:
        kernels = sorted({e["name"] for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel"})
    flash = [k for k in kernels if "flash_" in k]
    emit({"phase": "observe_profile", "card": card, "model": "lm_small",
          "profile_start": 2, "profile_steps": 2,
          "trace_bytes": os.path.getsize(os.path.join(pd, "trace.json")),
          "kernels": len(kernels), "flash_kernels": flash})
    if not any("flash_fwd" in k for k in flash):
        raise RuntimeError(f"observe_profile: no B1 kernel in the trace "
                           f"({flash})")
    del t
    torch.cuda.empty_cache()

    # observation=None / default / full, on one captured task, in two
    # interleaved rounds (the item time drifts by a few % within a run)
    t = _lm_task(5, guard=False)
    train(t, print_every=0, eval_every=0, logger=NullLogger())  # captures
    item_ms = {"none": [], "default": [], "full": []}
    for _ in range(2):
        for name, make in (("none", lambda: None),
                           ("default", Observation.default),
                           ("full", Observation.full)):
            t.loader.start = 0
            t1 = time.perf_counter()
            train(t, print_every=0, eval_every=0, logger=NullLogger(),
                  observation=make())
            item_ms[name].append((time.perf_counter() - t1) * 1e3 / 5)
    mean = {k: sum(v) / len(v) for k, v in item_ms.items()}
    spread = abs(item_ms["none"][0] - item_ms["none"][1]) / mean["none"]
    row = {"phase": "observe_cost", "card": card, "model": "lm_small",
           "steps_per_call": GUARD_K, "items": 5, "rounds": 2,
           "item_ms": item_ms, "item_ms_mean": mean,
           "none_round_spread": spread,
           "default_over_none": mean["default"] / mean["none"],
           "full_over_none": mean["full"] / mean["none"]}
    emit(row)
    if row["default_over_none"] > 1 + max(0.1, 2 * spread):
        raise RuntimeError(f"observe_cost: Observation.default() costs "
                           f"{row['default_over_none']:.3f}x of None, "
                           f"beyond the noise ({spread:.3f})")
    del t
    torch.cuda.empty_cache()

    # model selection: 8 ResNet-18 replicas on the card
    ds = SyntheticDataset(nsamples=1024, nclasses=10, shape=(32, 32, 3))
    imgs, labels = ds.batch(np.random.default_rng(1), 256)
    val = {"image": torch.from_numpy(imgs).cuda(),
           "label": onehot(torch.from_numpy(labels).cuda(), 10)}
    task = prepare_model_selection(
        functools.partial(resnet18, num_classes=10),
        optim.momentum(0.05, 0.9), replicas=8, input_shape=(32, 32, 3))
    checks = []

    class _Check:
        def log(self, metrics, cycle):
            equal = all(torch.equal(p[k], task.params[0][k])
                        for p in task.params for k in p)
            checks.append({"cycle": cycle, "replicas_equal": equal,
                           **metrics})

        def info(self, msg):
            pass

    t1 = time.perf_counter()
    _, history = train_model_selection(task, ds, val, cycles=2,
                                       steps_per_cycle=4,
                                       batch_size_per_replica=64,
                                       logger=_Check())
    torch.cuda.synchronize()
    row = {"phase": "model_selection", "card": card, "model": "resnet18",
           "image": 32, "classes": 10, "replicas": 8,
           "images_per_replica_step": 64, "cycles": 2, "steps_per_cycle": 4,
           "val_losses": [h.tolist() for h in history], "checks": checks,
           "wall_s": time.perf_counter() - t1}
    emit(row)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if len(checks) != 2 or not all(
            c["replicas_equal"] and c["selection_best_replica"]
            == int(np.argmin(h)) for c, h in zip(checks, history)) or not all(
            np.isfinite(h).all() for h in history):
        raise RuntimeError(f"model_selection: {row}")
    del task, val
    torch.cuda.empty_cache()


SHARD_STEPS = 3
SHARD_LR = 3e-4


def _run_steps(torch, state, step, batches, merge, *, timed=True) -> dict:
    """``step`` from ``state`` over ``batches``: the losses and the
    params after (``merge(params)`` on the model's names, detached
    copies).  When ``timed``, also the launches (B4, B5, B1-B3, B6) over
    the steps, the peak allocated bytes, device ms a step (profiler
    kernel time over 1 more step, host work left out), wall ms a step
    over all of them and over the steps after the first (``warm``), and
    the device's idle share of the warm wall time, 1 - device ms / warm
    wall ms."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    losses, marks = [], [time.perf_counter()]
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())  # waits for the step
        marks.append(time.perf_counter())
    out = {"losses": losses}
    if timed:
        launches = all_counts()
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        plan = getattr(step, "gather_plan", None)
        # the FSDP schedule's live gathered bytes at most (storages)
        out["gather_peak_bytes"] = None if plan is None else plan.live.peak
        ms = device_ms(torch, lambda: step(state, batches[0]), calls=1)
        warm = (marks[-1] - marks[1]) / (len(batches) - 1) * 1e3
        out.update(launches=launches, step_ms=ms,
                   wall_ms_per_step_first3=(marks[-1] - marks[0])
                   / len(batches) * 1e3,
                   wall_ms_per_step_warm=warm,
                   device_idle_share_warm=1 - ms / warm)
    out["params"] = {k: v.detach().clone()
                     for k, v in merge(state.params).items()}
    return out


def _shard_run(torch, make_model, data, opt, batches, kw, *, lm=True,
               batch_size, timed=True):
    """``prepare_training`` of a fresh model under ``kw`` (its ``mesh``
    a function forming it) and ``SHARD_STEPS`` steps on ``batches``
    (:func:`_run_steps`'s columns, the global params), with the shapes
    of the first rank-local leaves.  The process group is ended
    after."""
    from fluxdistributed_tpu_torch.mesh import shutdown_distributed
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.parallel.fsdp import gather_state
    from fluxdistributed_tpu_torch.train import prepare_training

    kw = dict(kw)
    make_mesh = kw.pop("mesh", None)
    model = make_model()
    # the pipeline modes train on their own next-token loss
    own_loss = lm and kw.get("spmd") not in ("pp", "pp_1f1b")
    try:
        task = prepare_training(
            model, data, opt, batch_size=batch_size, cycles=SHARD_STEPS,
            mesh=make_mesh() if make_mesh else None,
            loss_fn=lm_loss_fn(model) if own_loss else None,
            topk=() if lm else (1,), **kw)

        def merge(params):
            if task.specs is not None:
                params = gather_state(params, task.specs.params, task.mesh)
            if task.merge_params is not None:  # a pipeline's split tree
                params = task.merge_params(params)
            return params

        out = _run_steps(torch, task.state, task.step_fn, batches, merge,
                         timed=timed)
        out["local_shapes"] = (None if task.specs is None else
                               {k: list(v.shape) for k, v in list(
                                   task.state.params.items())[:4]})
        del task
        return out
    finally:
        del model
        shutdown_distributed()
        torch.cuda.empty_cache()


def _against(torch, run, ref) -> dict:
    """A sharded run against the DP run: equal losses and params, and
    the largest differences."""
    diffs = [(run["params"][k].float() - v.float()).abs().max().item()
             for k, v in ref["params"].items()]
    return {"losses_equal": run["losses"] == ref["losses"],
            "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                run["losses"], ref["losses"])),
            "params_equal": all(torch.equal(run["params"][k], v)
                                for k, v in ref["params"].items()),
            "param_max_abs_err": max(diffs)}


def _row(torch, phase, card, name, run, ref, per_step, extra=None) -> dict:
    cmp = {} if run is ref else _against(torch, run, ref)
    row = {"phase": phase, "card": card, "path": name, **(extra or {}),
           "losses": run["losses"], **cmp,
           "b1_b2_b3_launches_per_step": per_step,
           "launches_b4_b5_b1_b2_b3_b6": run["launches"],
           "step_ms_device": run["step_ms"],
           "wall_ms_per_step_first3": run["wall_ms_per_step_first3"],
           "wall_ms_per_step_warm": run["wall_ms_per_step_warm"],
           "device_idle_share_warm": run["device_idle_share_warm"],
           "peak_allocated_bytes": run["peak_allocated_bytes"],
           "gather_peak_bytes": run.get("gather_peak_bytes"),
           "local_shapes_first4": run["local_shapes"]}
    emit(row)
    return row


def _check_sharded(phase, name, row, depth, exact, loss_rtol=None,
                   param_atol=None):
    """A sharded path's row: B1, B2, B3 ``depth[i]`` launches a step
    (B4, B5, B6 none), and its reference's result (DP's) bit for bit
    (``exact``) or within the stated limits."""
    launches = row["launches_b4_b5_b1_b2_b3_b6"]
    if (row["b1_b2_b3_launches_per_step"] != depth or launches[0]
            or launches[1] or launches[5]):
        raise RuntimeError(f"{phase} {name}: launches {launches}, want "
                           f"B1-B3 {depth} a step")
    if not all(math.isfinite(x) for x in row["losses"]):
        raise RuntimeError(f"{phase} {name}: losses {row['losses']}")
    if exact:
        if not (row["losses_equal"] and row["params_equal"]):
            raise RuntimeError(f"{phase} {name}: not bit-equal to its "
                               f"reference: {row}")
    elif (row["loss_max_rel_err"] > loss_rtol
          or row["param_max_abs_err"] > param_atol):
        raise RuntimeError(f"{phase} {name}: loss rel err "
                           f"{row['loss_max_rel_err']} (limit {loss_rtol}),"
                           f" param err {row['param_max_abs_err']} (limit "
                           f"{param_atol})")


def sharded_train_phase(torch, card, keep=None):
    """lm_small (vocab 32000, B=8, T=1024, bf16, flash, adam, dropout 0)
    3 steps through the one-device DP step and, on one NCCL rank,
    spmd fsdp, tp and fsdp_tp on {data: 1, model: 1} and the all-size-1
    dp_fsdp_tp layout, from the same weights and batches.  Returns
    B1-B3's launches a step on each sharded path; the DP run goes into
    ``keep["dp_flash"]`` when ``keep`` is given (the sp phase's
    reference)."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import data_mesh, make_mesh
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel.layout import Layout

    batches = [{"tokens": torch.from_numpy(np.random.default_rng(s).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int64)).cuda()}
        for s in range(SHARD_STEPS)]

    def make_model():
        return lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)

    def model_mesh():
        return make_mesh({"data": 1, "model": 1}, device="cuda")

    modes = [("dp", {}),
             ("fsdp", {"spmd": "fsdp",
                       "mesh": lambda: data_mesh(device="cuda")}),
             ("tp", {"spmd": "tp", "mesh": model_mesh}),
             ("fsdp_tp", {"spmd": "fsdp_tp", "mesh": model_mesh}),
             ("layout_dp_fsdp_tp_1x1x1",
              {"layout": Layout("dp_fsdp_tp", 1, 1, 1), "device": "cuda"})]
    ref, out = None, {}
    depth = 12
    for name, kw in modes:
        run = _shard_run(torch, make_model, _TokenBank(32000, T_TRAIN),
                         optim.adam(SHARD_LR), batches, kw, batch_size=B)
        per = [n // SHARD_STEPS for n in run["launches"][2:5]]
        ref = ref or run
        row = _row(torch, "sharded_train", card, name, run, ref, per, {
            "model": "lm_small", "vocab": 32000, "batch": B,
            "seqlen": T_TRAIN, "dtype": "bfloat16", "opt": "adam 3e-4",
            "dp_step_ms_device": ref["step_ms"],
            "dp_peak_allocated_bytes": ref["peak_allocated_bytes"]})
        if run is not ref:
            exact = name in ("fsdp", "layout_dp_fsdp_tp_1x1x1")
            _check_sharded("sharded_train", name, row, [depth] * 3, exact,
                           loss_rtol=1e-2, param_atol=6 * SHARD_LR)
            out[f"lm_small_{name}"] = per
        del run
    if keep is not None:
        keep["dp_flash"] = ref
    del ref
    torch.cuda.empty_cache()
    return out


def sharded_vit_phase(torch, card):
    """ViT-L/16 (224², batch 128, flash core, adamw, dropout 0) 3 steps
    under spmd="tp" on {data: 1, model: 1} against the one-device DP
    step.  Returns B1-B3's launches a step."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import vit_l16
    from fluxdistributed_tpu_torch.ops import flash_attention

    batches = [image_batch(torch, VIT_B, VISION_SIZE, 1000, torch.bfloat16,
                           "cuda", 40 + s) for s in range(SHARD_STEPS)]

    def make_model():
        return vit_l16(num_classes=1000, seed=0,
                       attn_fn=partial(flash_attention, causal=False))

    data = _ImageBank(VISION_SIZE, 1000)
    ref = _shard_run(torch, make_model, data, optim.adamw(), batches, {},
                     lm=False, batch_size=VIT_B)
    extra = {"model": "vit_l16", "batch": VIT_B, "image": VISION_SIZE,
             "dtype": "bfloat16", "opt": "adamw (1e-3, wd 1e-2)",
             "dp_step_ms_device": ref["step_ms"],
             "dp_peak_allocated_bytes": ref["peak_allocated_bytes"]}
    _row(torch, "sharded_vit", card, "dp", ref, ref,
         [n // SHARD_STEPS for n in ref["launches"][2:5]], extra)
    run = _shard_run(torch, make_model, data, optim.adamw(), batches,
                     {"spmd": "tp", "mesh": lambda: make_mesh(
                         {"data": 1, "model": 1}, device="cuda")},
                     lm=False, batch_size=VIT_B)
    per = [n // SHARD_STEPS for n in run["launches"][2:5]]
    row = _row(torch, "sharded_vit", card, "tp", run, ref, per, extra)
    _check_sharded("sharded_vit", "tp", row, [24] * 3, False, loss_rtol=1e-2,
                   param_atol=6e-3)
    del run, ref, batches
    torch.cuda.empty_cache()
    return per


def fsdp_resnet_phase(torch, card):
    """The reference's ResNet-50 (224², batch 256, bf16, momentum 0.01)
    3 steps under spmd="fsdp" against the DP step, both on one NCCL
    rank (the synchronised BatchNorm path): bit for bit; step ms and
    images/s from device time."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import data_mesh
    from fluxdistributed_tpu_torch.models import resnet50

    batches = [image_batch(torch, VISION_B, VISION_SIZE, 1000,
                           torch.bfloat16, "cuda", 60 + s)
               for s in range(SHARD_STEPS)]

    def make_model():
        return resnet50(num_classes=1000, seed=0)

    def mesh():
        return data_mesh(device="cuda")

    data = _ImageBank(VISION_SIZE, 1000)
    runs = {name: _shard_run(torch, make_model, data,
                             optim.momentum(0.01, 0.9), batches,
                             {"spmd": spmd, "mesh": mesh}, lm=False,
                             batch_size=VISION_B)
            for name, spmd in (("dp", "jit"), ("fsdp", "fsdp"))}
    ref = runs["dp"]
    for name, run in runs.items():
        row = _row(torch, "fsdp_resnet", card, name, run, ref, None, {
            "model": "resnet50", "batch": VISION_B, "image": VISION_SIZE,
            "dtype": "bfloat16", "opt": "momentum 0.01",
            "images_per_s_device": VISION_B / (run["step_ms"] / 1e3)})
        if any(run["launches"]) or not all(
                math.isfinite(x) for x in run["losses"]):
            raise RuntimeError(f"fsdp_resnet {name}: {row}")
        if run is not ref and not (row["losses_equal"]
                                   and row["params_equal"]):
            raise RuntimeError(f"fsdp_resnet: fsdp not bit-equal to DP: "
                               f"{row}")
    del runs, ref, batches
    torch.cuda.empty_cache()


SHARD_CLI = ["--model", "lm_small", "--dataset", "synthetic-text", "--vocab",
             "256", "--seqlen", "1024", "--batch-size", "8", "--attn",
             "flash", "--opt", "adam", "--lr", "3e-4", "--cycles", "6",
             "--print-every", "3", "--eval-every", "0"]


def sharded_cli_phase(torch):
    """``python -m fluxdistributed_tpu_torch.train ... --spmd fsdp``
    in-process, 6 cycles; ``--spmd tp --tp 2`` and ``--spmd fsdp_tp`` on
    one card refused with the driver's messages.  (The layout CLI runs
    in the pricing_cli phase: ``--layout auto`` at one rank trains the
    ``dp`` layout, its only candidate.)  Returns B1-B3's launches a step
    of the fsdp run."""
    from fluxdistributed_tpu_torch.train.__main__ import run

    per = None
    for extra in (["--spmd", "fsdp"],):
        reset_all_counts()
        t0 = time.perf_counter()
        task = run(SHARD_CLI + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counts()
        row = {"phase": "sharded_cli", "argv_extra": extra,
               "steps": task.state.step, "losses": task.losses,
               "mesh": task.mesh.shape, "wall_s": wall,
               "launches_b4_b5_b1_b2_b3_b6": launches}
        emit(row)
        if (task.specs is None or len(task.losses) != 6
                or not all(math.isfinite(x) for x in task.losses)
                or launches != [0, 0, 72, 72, 72, 0]):
            raise RuntimeError(f"sharded_cli {extra}: {row}")
        per = per or [n // 6 for n in launches[2:5]]
        del task
        torch.cuda.empty_cache()
    refusals = {}
    for extra, want in (
            (["--spmd", "tp", "--tp", "2"],
             "--tp 2 must be >=1 and divide 1 devices"),
            (["--spmd", "fsdp_tp"],
             "--spmd fsdp_tp needs --tp < device count")):
        try:
            run(SHARD_CLI + extra)
        except SystemExit as e:
            refusals[" ".join(extra)] = str(e)
            if want not in str(e):
                raise RuntimeError(f"sharded_cli {extra}: refused with {e}")
        else:
            raise RuntimeError(f"sharded_cli {extra}: not refused")
    emit({"phase": "sharded_cli_refusals", "refusals": refusals})
    return per


# ------------------------------------------------ context and expert parallelism

CTX_S = 4  # simulated seq ranks of the context kernel phase


def context_kernel_phase(torch, bw, peaks, flush, card):
    """The ring-flash hop body (``parallel.context.ring_flash_hops``)
    over ``CTX_S`` sequence shards held in one process, at lm_small's
    attention (B = 8, T = 1024, 256 a shard, 12 heads of 64, bf16,
    causal): the forward against one whole-sequence ``flash_attention``
    call; in the backward every hop's B2/B3 launch, fed the nonzero LSE
    cotangent the combine produces, held element by element against the
    plain versions on the same inputs, with the dropped-tile control;
    16 launches of each of B1-B3; the ring's ms against the
    whole-sequence call's (CUDA events).  Returns the row."""
    import importlib

    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.parallel.context import ring_flash_hops

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    g = torch.Generator().manual_seed(14)
    q, k, v, do = (torch.randn(B, T_TRAIN, H, D, generator=g).to(
        torch.bfloat16).cuda() for _ in range(4))
    t = T_TRAIN // CTX_S

    def shard(x, s):
        return x[:, s * t:(s + 1) * t]

    def ring(q, k, v):
        """Every simulated rank's hops; blocks in arrival order."""
        outs = []
        for s in range(CTX_S):
            blocks = [(shard(k, (s - i) % CTX_S), shard(v, (s - i) % CTX_S))
                      for i in range(CTX_S)]
            outs.append(ring_flash_hops(shard(q, s), blocks, s, causal=True))
        return torch.cat(outs, dim=1)

    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    hops = []  # each B2/B3 call's inputs and outputs, in backward order
    inner = fa._backward

    def recording(q_, k_, v_, o_, lse_, g_, g_lse, cfg):
        dq, dk, dv = inner(q_, k_, v_, o_, lse_, g_, g_lse, cfg)
        hops.append(((q_, k_, v_, o_, lse_, g_, g_lse, dict(cfg)),
                     (dq, dk, dv)))
        return dq, dk, dv

    reset_all_counts()
    fa._backward = recording
    try:
        out = ring(*leaves)
        out.backward(do)
    finally:
        fa._backward = inner
    torch.cuda.synchronize()
    launches = attn_counts()
    whole = flash_attention(q, k, v, True)
    fwd_err = (out.detach().float() - whole.float()).abs().max().item()
    checks, nonzero, dropped = [], 0, {}
    for (q_, k_, v_, o_, lse_, g_, g_lse, cfg), (dq, dk, dv) in hops:
        delta = (g_.float() * o_.float()).sum(-1).permute(0, 2, 1)
        if g_lse is not None:
            delta = delta - g_lse.float()
            nonzero += bool((g_lse != 0).any())
        kw = dict(causal=cfg["causal"], window=None, sinks=0)
        bargs = (q_, k_, v_, g_, lse_, delta.contiguous())
        rdq = fa.flash_attention_dq_reference(*bargs, **kw)
        rdk, rdv = fa.flash_attention_dkv_reference(*bargs, **kw)
        checks.append({n: grad_check(torch, got, ref, "bf16")["excess"]
                       for n, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                                           ("dv", dv, rdv))})
        name = "causal" if cfg["causal"] else "noncausal"
        if name not in dropped and g_lse is not None:
            dropped[name] = dropped_tile_check(torch, fa, bargs, kw, rdq,
                                               rdk, rdv, "bf16")

    def ring_step():
        o = ring(*leaves)
        o.backward(do)

    def whole_step():
        o = flash_attention(*leaves, True)
        o.backward(do)

    ring_ms = event_ms(torch, ring_step)
    whole_ms = event_ms(torch, whole_step)
    pairs = B * H * (CTX_S * t * (t + 1) // 2 + CTX_S * (CTX_S - 1) * t * t)
    bytes_fb = 0
    for _ in range(CTX_S * CTX_S):  # each hop: B1, B2 and B3's least bytes
        qo, kv = B * t * H * D * 2, B * t * H * D * 2
        bytes_fb += (2 * qo + 2 * kv) + (3 * qo + 2 * kv) + (2 * qo + 4 * kv)
    t_ops = 18 * pairs * D / peaks["bf16"] * 1e3
    t_bytes = bytes_fb / bw * 1e3
    row = {"phase": "context_kernel", "card": card,
           "shape": [B, T_TRAIN, H, D], "shards": CTX_S, "dtype": "bfloat16",
           "designs": {kn: kernel_design(fa, kn, torch.bfloat16, D)
                       for kn in ("fwd", "dq", "dkv")},
           "causal": True, "hops": len(hops),
           "hops_with_nonzero_lse_cotangent": nonzero,
           "launches_b1_b2_b3": launches,
           "fwd_max_abs_err_vs_whole_sequence": fwd_err,
           "fwd_tol": 2e-2, "grad_excess_max": {
               n: max(c[n] for c in checks) for n in ("dq", "dk", "dv")},
           "grad_tol": GRAD_TOL["bf16"], "dropped_last_tile": dropped,
           "ring_fwd_bwd_event_ms": ring_ms,
           "whole_sequence_flash_fwd_bwd_event_ms": whole_ms,
           "ring_over_whole": ring_ms / whole_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    emit(row)
    bad = []
    if launches != [CTX_S * CTX_S] * 3:
        bad.append(f"launches {launches}")
    if not fwd_err <= 2e-2:
        bad.append(f"forward err {fwd_err}")
    if any(x > 1.0 for c in checks for x in c.values()):
        bad.append("a hop's gradient is out of its element-wise limit")
    if not nonzero:
        bad.append("no hop saw a nonzero LSE cotangent")
    if set(dropped) != {"causal", "noncausal"} or not all(
            r["excess"] > 1.0 for d in dropped.values() for r in d.values()):
        bad.append(f"dropped-tile control not caught: {dropped}")
    if not all(bool(torch.isfinite(x.grad.float()).all()) for x in leaves):
        bad.append("non-finite gradients")
    if bad:
        raise RuntimeError(f"context_kernel: {bad}")
    return row


def _one_rank(make, axes):
    """A model factory for ``_shard_run`` whose ``attn_fn`` / ``moe_fn``
    is bound to a one-rank NCCL mesh over ``axes``, and that mesh."""
    from fluxdistributed_tpu_torch.mesh import make_mesh

    box = {}

    def model():
        box["mesh"] = make_mesh(axes, device="cuda")
        return make(box["mesh"])

    return model, lambda: box["mesh"]


def sp_train_phase(torch, card, dp_flash=None):
    """lm_small (vocab 32000, B = 8, T = 1024, bf16, adam 3e-4, dropout
    0) 3 steps under spmd="sp" on one NCCL rank ``{data: 1, seq: 1}``,
    with the flash ring and with Ulysses, each against the one-device
    DP step with the same core (flash; dense), bit for bit.  ``dp_flash``
    is the flash DP run of :func:`sharded_train_phase` (the same model,
    seed, batches and optimizer), run here when not given.  Returns
    B1-B3's launches a step of each path."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import (make_ring_attention,
                                                    make_ulysses_attention)

    batches = [{"tokens": torch.from_numpy(np.random.default_rng(s).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int64)).cuda()}
        for s in range(SHARD_STEPS)]
    axes = {"data": 1, "seq": 1}
    paths = {
        "ring_flash": (lambda m: make_ring_attention(
            m, batch_axis="data", causal=True, impl="flash"),
            attention_core("flash"), 12),
        "ulysses": (lambda m: make_ulysses_attention(
            m, batch_axis="data", causal=True), None, 0)}
    out = {}
    for name, (attn, dp_core, per_step) in paths.items():
        ref = dp_flash if dp_core is not None else None
        if ref is None:
            ref = _shard_run(torch, lambda: lm_small(
                vocab=32000, attn_fn=dp_core, seed=0),
                _TokenBank(32000, T_TRAIN), optim.adam(SHARD_LR), batches,
                {}, batch_size=B)
        make, mesh = _one_rank(lambda m: lm_small(
            vocab=32000, attn_fn=attn(m), seed=0), axes)
        run = _shard_run(torch, make, _TokenBank(32000, T_TRAIN),
                         optim.adam(SHARD_LR), batches,
                         {"spmd": "sp", "mesh": mesh}, batch_size=B)
        extra = {"model": "lm_small", "vocab": 32000, "batch": B,
                 "seqlen": T_TRAIN, "dtype": "bfloat16", "opt": "adam 3e-4",
                 "mesh": axes, "dp_core": "flash" if dp_core else "dense",
                 "dp_step_ms_device": ref["step_ms"],
                 "dp_peak_allocated_bytes": ref["peak_allocated_bytes"],
                 "peak_over_dp_bytes": run["peak_allocated_bytes"]
                 - ref["peak_allocated_bytes"]}
        per = [n // SHARD_STEPS for n in run["launches"][2:5]]
        row = _row(torch, "sp_train", card, name, run, ref, per, extra)
        _check_sharded("sp_train", name, row, [per_step] * 3,
                       exact=True)
        out[f"lm_small_sp_{name}"] = per
        del run, ref
        torch.cuda.empty_cache()
    return out


MOE_EXPERTS, MOE_EVERY, MOE_CF = 8, 2, 2.0


def _moe_golden(torch, experts, router, x, cap):
    """One MoE layer on one shard as the JAX test's golden model
    computes it: ``router_dispatch``, the dispatch einsum, a loop over
    the experts, the combine einsum."""
    from fluxdistributed_tpu_torch.models import moe_expert_fn
    from fluxdistributed_tpu_torch.parallel import router_dispatch

    logits = x.float() @ router.float()
    dispatch, combine, aux = router_dispatch(logits, cap)
    expert_in = torch.einsum("td,tec->ecd", x.float(), dispatch)
    y = torch.stack([moe_expert_fn({n: w[e] for n, w in experts.items()},
                                   expert_in[e])
                     for e in range(router.shape[1])])
    return torch.einsum("ecd,tec->td", y, combine), aux


def ep_train_phase(torch, card):
    """An MoE lm_small (every 2nd of 12 blocks routed over 8 experts,
    top-1, capacity factor 2.0, flash core; vocab 32000, B = 8, T =
    1024, bf16, adam 3e-4) 3 steps under spmd="ep" on one NCCL rank
    ``{data: 1, expert: 1}`` against the same model's one-device DP step,
    bit for bit; device ms, peak bytes and the dispatch/combine einsums'
    share (timed alone with CUDA events at the block's shapes, 6 blocks,
    forward and backward); one MoE layer at the block's shape against its
    single-shard golden.  Returns B1-B3's launches a step."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_small, moe_expert_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import moe_apply

    batches = [{"tokens": torch.from_numpy(np.random.default_rng(20 + s)
                                           .integers(0, 32000, (B, T_TRAIN))
                                           .astype(np.int64)).cuda()}
               for s in range(SHARD_STEPS)]
    axes = {"data": 1, "expert": 1}

    def moe_model(m):
        return lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0,
                        moe_every=MOE_EVERY, num_experts=MOE_EXPERTS,
                        moe_fn=moe_apply(moe_expert_fn, m,
                                         capacity_factor=MOE_CF,
                                         batch_axis="data"))

    make, mesh = _one_rank(moe_model, axes)
    ref = _shard_run(torch, make, _TokenBank(32000, T_TRAIN),
                     optim.adam(SHARD_LR), batches, {}, batch_size=B)
    make, mesh = _one_rank(moe_model, axes)
    run = _shard_run(torch, make, _TokenBank(32000, T_TRAIN),
                     optim.adam(SHARD_LR), batches,
                     {"spmd": "ep", "mesh": mesh}, batch_size=B)
    # the einsums alone at one block's shapes: T = B x T_TRAIN tokens
    tokens = B * T_TRAIN
    cap = math.ceil(tokens / MOE_EXPERTS * MOE_CF)
    g = torch.Generator().manual_seed(15)
    x = torch.randn(tokens, 768, generator=g).to(torch.bfloat16).cuda()
    router = (torch.randn(768, MOE_EXPERTS, generator=g) * 768 ** -0.5).cuda()
    experts = {"w1": torch.randn(MOE_EXPERTS, 768, 3072, generator=g)
               * (768 * 8) ** -0.5, "b1": torch.zeros(MOE_EXPERTS, 3072),
               "w2": torch.randn(MOE_EXPERTS, 3072, 768, generator=g)
               * (3072 * 8) ** -0.5, "b2": torch.zeros(MOE_EXPERTS, 768)}
    experts = {n: w.to(torch.bfloat16).cuda() for n, w in experts.items()}
    from fluxdistributed_tpu_torch.parallel import router_dispatch

    with torch.no_grad():
        dispatch, combine, _ = router_dispatch(x.float() @ router, cap)
    xf = x.float().requires_grad_(True)
    y = torch.randn(MOE_EXPERTS, cap, 768, generator=g).cuda()
    y.requires_grad_(True)
    comb = combine.clone().requires_grad_(True)

    def einsums():
        a = torch.einsum("td,tec->ecd", xf, dispatch)
        b = torch.einsum("ecd,tec->td", y, comb)
        (a.sum() + b.sum()).backward()

    einsum_ms = event_ms(torch, einsums, calls=3) * (12 // MOE_EVERY)
    del dispatch, combine, xf, y, comb
    torch.cuda.empty_cache()
    # one MoE layer against its single-shard golden
    from fluxdistributed_tpu_torch.mesh import make_mesh, shutdown_distributed

    try:
        layer = moe_apply(moe_expert_fn, make_mesh(axes, device="cuda"),
                          capacity_factor=MOE_CF, batch_axis="data")
        with torch.no_grad():
            got, aux = layer(experts, router, x)
            want, want_aux = _moe_golden(torch, experts, router, x, cap)
            p = torch.softmax(x.float() @ router, dim=-1)
            top = torch.topk(p, 2, dim=-1).values
            margin = (top[:, 0] - top[:, 1]).min().item()
    finally:
        shutdown_distributed()
    layer_err = (got.float() - want.float()).abs().max().item()
    layer_tol = 1e-3
    per = [n // SHARD_STEPS for n in run["launches"][2:5]]
    extra = {"model": "lm_small MoE", "vocab": 32000, "batch": B,
             "seqlen": T_TRAIN, "dtype": "bfloat16", "opt": "adam 3e-4",
             "moe_every": MOE_EVERY, "experts": MOE_EXPERTS, "top_k": 1,
             "capacity_factor": MOE_CF, "capacity": cap, "mesh": axes,
             "dp_step_ms_device": ref["step_ms"],
             "dp_peak_allocated_bytes": ref["peak_allocated_bytes"],
             "peak_over_dp_bytes": run["peak_allocated_bytes"]
             - ref["peak_allocated_bytes"],
             "dispatch_combine_einsum_ms_per_step": einsum_ms,
             "einsum_share_of_step": einsum_ms / run["step_ms"],
             "layer_vs_golden_max_abs_err": layer_err,
             "layer_tol": layer_tol,
             "layer_aux": aux.item(), "golden_aux": want_aux.item(),
             "layer_min_top1_top2_margin": margin}
    row = _row(torch, "ep_train", card, "ep", run, ref, per, extra)
    _check_sharded("ep_train", "ep", row, [12] * 3, exact=True)
    if not layer_err <= layer_tol or aux.item() != want_aux.item():
        raise RuntimeError(f"ep_train: the MoE layer against its golden: "
                           f"err {layer_err} (limit {layer_tol}), aux "
                           f"{aux.item()} vs {want_aux.item()}")
    del run, ref, experts, x
    torch.cuda.empty_cache()
    return {"lm_small_moe_ep": per}


def sp_ep_cli_phase(torch):
    """``--spmd sp`` and ``--spmd ep`` on one card, refused with
    ``bin/driver.py``'s messages (it needs two devices for either)."""
    from fluxdistributed_tpu_torch.train.__main__ import run

    refusals = {}
    for extra, want in (
            (["--spmd", "sp"],
             "--seq-parallel 1 must be >=2 and divide 1 devices"),
            (["--spmd", "ep"],
             "--expert-parallel 1 must be >=2 and divide 1 devices")):
        try:
            run(SHARD_CLI + extra)
        except SystemExit as e:
            refusals[" ".join(extra)] = str(e)
            if want not in str(e):
                raise RuntimeError(f"sp_ep_cli {extra}: refused with {e}")
        else:
            raise RuntimeError(f"sp_ep_cli {extra}: not refused")
    emit({"phase": "sp_ep_cli_refusals", "refusals": refusals})


# ------------------------------------------------ pipeline parallelism

PP_S, PP_M = 2, 4  # the local exchange's pipe devices and microbatches
# B1-B3 launches a step the timetables give lm_small (12 blocks, B = 8):
# GPipe at S = 1, M = 2 runs each block forward and backward once a
# microbatch; 1F1B adds the B tick's recompute of each stage forward;
# zb a second recompute and backward at the W tick
PP_EXPECTED = {"gpipe_s1_m2": [24, 24, 24], "1f1b_s2_m4": [96, 48, 48],
               "zb_s2_m4": [144, 96, 96],
               "interleaved_v6_s2_m4": [96, 48, 48]}


# A probe step descends at this rate, a power of two, so that (p0 - p1)
# / rate is the step's gradient to f32 rounding, on the model's names
PROBE_LR = 1024.0
# The pipelines against DP (GPipe) and against GPipe (1F1B, interleaved):
# losses over the 3 steps, and the probe step's gradient, as the largest
# relative norm of a leaf's difference.  On an H100 the losses read
# 7.2e-6 and 4.7e-6 (PERF.md has the gradients').  A dropped microbatch
# reads far above PP_GRAD_RTOL and a doubled cotangent reads 1; the phase
# measures the first and fails if it does not exceed the limit.
PP_LOSS_RTOL = 1e-4
PP_GRAD_RTOL = 5e-2


def _worst_leaf_rel_err(torch, grads, ref) -> float:
    """The largest ``||grads[k] - ref[k]|| / ||ref[k]||`` over leaves."""
    return max(((grads[k].float() - r.float()).norm()
                / r.float().norm().clamp_min(1e-30)).item()
               for k, r in ref.items())


def _probe_grads(p1, p0) -> dict:
    """A probe step's gradient from its params before and after."""
    return {k: (p0[k].float() - v.float()) / PROBE_LR
            for k, v in p1.items()}


def _microbatch_faults(torch, make_model, tokens, counts) -> dict:
    """What the gradient check reads for a dropped microbatch: for each
    M in ``counts``, the DP loss's gradient (autograd through
    ``lm_loss_fn``) on ``M`` equal row slices of ``tokens``, summed over
    all M and over the first M - 1, each over M; the worst leaf's
    relative error of the second against the first."""
    from fluxdistributed_tpu_torch.models import lm_loss_fn

    model = make_model()
    fn = lm_loss_fn(model)
    params = {k: p.detach().requires_grad_(True)
              for k, p in model.named_parameters()}
    out = {}
    for M in counts:
        whole = drop = None
        for i, rows in enumerate(tokens.chunk(M)):
            loss, _ = fn(params, {}, {"tokens": rows}, True)
            g = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            whole = g if whole is None else {
                k: whole[k] + v for k, v in g.items()}
            if i < M - 1:
                drop = g if drop is None else {
                    k: drop[k] + v for k, v in g.items()}
        out[f"m{M}_dropped_microbatch"] = _worst_leaf_rel_err(
            torch, drop, whole)
        del whole, drop
    del model, params
    torch.cuda.empty_cache()
    return out


def _pp_local_run(torch, batches, schedule, interleave, opt=None,
                  timed=True, boundaries=None):
    """lm_small (flash, bf16; ``opt``, adam 3e-4 by default) over
    ``batches`` through ``make_train_step_1f1b`` with all ``PP_S`` pipe
    devices in this process (``parallel.LocalPipe``), stage boundaries
    a planner's when given: :func:`_run_steps`'s columns, params on the
    model's names."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_pp_1f1b, lm_small
    from fluxdistributed_tpu_torch.models.transformer_lm import (
        pp_merge_params)
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import (LocalPipe, TrainState,
                                                    make_train_step_1f1b)

    model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
    pipe, opt = LocalPipe(PP_S), opt or optim.adam(SHARD_LR)
    w = lm_pp_1f1b(model, pipe, interleave=interleave, boundaries=boundaries)
    state = TrainState.create(w.split_params(dict(model.named_parameters())),
                              opt)
    step = make_train_step_1f1b(*w.fns, opt, pipe, num_microbatches=PP_M,
                                interleave=w.interleave, schedule=schedule)
    try:
        return {**_run_steps(torch, state, step, batches, pp_merge_params(
            model, PP_S, interleave=interleave, boundaries=boundaries),
            timed=timed), "local_shapes": None}
    finally:
        del model, state, step, w
        torch.cuda.empty_cache()


def pp_train_phase(torch, card, dp_flash=None, keep=None):
    """lm_small (vocab 32000, B = 8, T = 1024, bf16, flash, adam 3e-4,
    dropout 0) 3 steps from one seed and the same batches: the trainer's
    ``spmd="pp"`` (GPipe, M = 2) on one NCCL rank ``{data: 1, pipe: 1}``
    against the one-device DP step (``dp_flash``, the sharded phase's
    run; run here when not given), then 1F1B, zb and the interleaved
    placement (V = 6) at S = 2, M = 4 over the local exchange against
    the GPipe run, zb against 1F1B bit for bit (with ``keep``, the 1F1B
    row stays there for the pricing phase).  Each path also takes
    one probe step (descent at ``PROBE_LR``) on the first batch, whose
    gradient is held against DP's probe step's within ``PP_GRAD_RTOL``
    (zb's bit for bit against 1F1B's).  GPipe and 1F1B are not bit-equal
    to DP: the microbatches' half- and quarter-batch GEMMs and the
    gradient sums over them round apart in bf16, so losses within
    ``PP_LOSS_RTOL`` and, after 3 steps, params within 6 lr (Adam moves
    an element about lr a step: a cap, not a fault detector).  Returns
    B1-B3's launches a step of each path."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.ops import attention_core

    batches = [{"tokens": torch.from_numpy(np.random.default_rng(s).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int64)).cuda()}
        for s in range(SHARD_STEPS)]

    def make_model():
        return lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)

    def trainer_run(kw, opt, steps, timed=True):
        return _shard_run(torch, make_model, _TokenBank(32000, T_TRAIN),
                          opt, steps, kw, batch_size=B, timed=timed)

    gpipe_kw = {"spmd": "pp", "num_microbatches": 2,
                "mesh": lambda: make_mesh({"data": 1, "pipe": 1},
                                          device="cuda")}
    p0 = {k: p.detach().clone() for k, p in make_model().named_parameters()}
    probe = optim.descent(PROBE_LR)
    dp_grads = _probe_grads(trainer_run({}, probe, batches[:1], False)[
        "params"], p0)
    faults = _microbatch_faults(torch, make_model, batches[0]["tokens"],
                                (2, PP_M))
    emit({"phase": "pp_train_grad_limits", "card": card,
          "grad_rtol": PP_GRAD_RTOL, "loss_rtol": PP_LOSS_RTOL,
          "fault_readings": faults, "doubled_cotangent_reads": 1.0})
    if min(faults.values()) <= PP_GRAD_RTOL:
        raise RuntimeError(f"pp_train: a dropped microbatch reads "
                           f"{faults}, inside the limit {PP_GRAD_RTOL}")

    def grad_err(grads):
        return _worst_leaf_rel_err(torch, grads, dp_grads)

    ref = dp_flash or trainer_run({}, optim.adam(SHARD_LR), batches)
    extra = {"model": "lm_small", "vocab": 32000, "batch": B,
             "seqlen": T_TRAIN, "dtype": "bfloat16", "opt": "adam 3e-4",
             "dp_step_ms_device": ref["step_ms"],
             "dp_wall_ms_per_step_warm": ref["wall_ms_per_step_warm"],
             "dp_peak_allocated_bytes": ref["peak_allocated_bytes"],
             "note": "one card and one process: no collective crosses a "
                     "card, so no bubble or NCCL time; step_ms_device is "
                     "the kernels' time, host work left out, which the "
                     "warm wall time and the idle share hold"}
    out = {}
    gpipe = trainer_run(gpipe_kw, optim.adam(SHARD_LR), batches)
    gpipe_grads = _probe_grads(trainer_run(gpipe_kw, probe, batches[:1],
                                           False)["params"], p0)
    per = [n // SHARD_STEPS for n in gpipe["launches"][2:5]]
    row = _row(torch, "pp_train", card, "gpipe_s1_m2", gpipe, ref, per, {
        **extra, "against": "dp", "mesh": {"data": 1, "pipe": 1},
        "microbatches": 2,
        "probe_grad_worst_leaf_rel_err_vs_dp": grad_err(gpipe_grads)})
    _check_sharded("pp_train", "gpipe_s1_m2", row,
                   PP_EXPECTED["gpipe_s1_m2"], exact=False,
                   loss_rtol=PP_LOSS_RTOL, param_atol=6 * SHARD_LR)
    checked = [("gpipe_s1_m2", row)]
    out["gpipe_s1_m2"] = per
    del gpipe_grads
    f1b = f1b_grads = None
    for name, schedule, inter in (
            ("1f1b_s2_m4", "1f1b", False), ("zb_s2_m4", "zb", False),
            ("interleaved_v6_s2_m4", "1f1b", True)):
        run = _pp_local_run(torch, batches, schedule, inter)
        grads = _probe_grads(_pp_local_run(torch, batches[:1], schedule,
                                           inter, probe, False)["params"],
                             p0)
        per = [n // SHARD_STEPS for n in run["launches"][2:5]]
        zb = name == "zb_s2_m4"
        against = f1b if zb else gpipe
        row = _row(torch, "pp_train", card, name, run, against, per, {
            **extra, "against": "1f1b_s2_m4" if zb else "gpipe_s1_m2",
            "pipe_devices": PP_S, "microbatches": PP_M,
            "exchange": "local", "gpipe_step_ms_device": gpipe["step_ms"],
            "peak_over_dp_bytes": run["peak_allocated_bytes"]
            - ref["peak_allocated_bytes"],
            "probe_grad_worst_leaf_rel_err_vs_dp": grad_err(grads),
            **({"probe_grads_equal_1f1b": all(
                torch.equal(grads[k], v) for k, v in f1b_grads.items())}
               if zb else {})})
        _check_sharded("pp_train", name, row, PP_EXPECTED[name], exact=zb,
                       loss_rtol=PP_LOSS_RTOL, param_atol=6 * SHARD_LR)
        if zb and not row["probe_grads_equal_1f1b"]:
            raise RuntimeError(f"pp_train {name}: probe gradients not "
                               f"bit-equal to 1F1B's: {row}")
        checked.append((name, row))
        out[name] = per
        if name == "1f1b_s2_m4":
            f1b, f1b_grads = run, grads
            if keep is not None:
                keep["pp_1f1b_s2_m4"] = row
        else:
            del run, grads
    for name, row in checked:
        if row["probe_grad_worst_leaf_rel_err_vs_dp"] > PP_GRAD_RTOL:
            raise RuntimeError(
                f"pp_train {name}: probe gradient off DP's by "
                f"{row['probe_grad_worst_leaf_rel_err_vs_dp']} (limit "
                f"{PP_GRAD_RTOL}): {row}")
    del gpipe, f1b, f1b_grads, ref, dp_grads, p0
    torch.cuda.empty_cache()
    return out


def pp_cli_phase(torch):
    """``python -m fluxdistributed_tpu_torch.train ... --spmd pp --pipe
    1 --pp-plan auto`` in-process (the planner's fresh costs priced on
    fake tensors; one stage holds every block), 2 cycles, B1-B3
    launching 24 a step (12 blocks x 2 microbatches); ``--spmd pp_1f1b
    --pipe 1`` refused (1F1B needs two pipe devices)."""
    from fluxdistributed_tpu_torch.train.__main__ import run

    argv = list(SHARD_CLI)
    argv[argv.index("--cycles") + 1] = "2"
    reset_all_counts()
    t0 = time.perf_counter()
    extra = ["--spmd", "pp", "--pipe", "1", "--pp-plan", "auto"]
    task = run(argv + extra)
    torch.cuda.synchronize()
    launches = all_counts()
    row = {"phase": "pp_cli", "argv_extra": extra,
           "steps": task.state.step, "losses": task.losses,
           "mesh": task.mesh.shape, "wall_s": time.perf_counter() - t0,
           "launches_b4_b5_b1_b2_b3_b6": launches}
    emit(row)
    if (task.mesh.shape != {"data": 1, "pipe": 1} or len(task.losses) != 2
            or not all(math.isfinite(x) for x in task.losses)
            or launches != [0, 0, 48, 48, 48, 0]):
        raise RuntimeError(f"pp_cli: {row}")
    del task
    torch.cuda.empty_cache()
    try:
        run(argv + ["--spmd", "pp_1f1b", "--pipe", "1"])
    except SystemExit as e:
        if "1F1B needs >= 2 pipeline stages" not in str(e):
            raise RuntimeError(f"pp_cli pp_1f1b: refused with {e}")
        emit({"phase": "pp_cli_refusal", "refusal": str(e)})
    else:
        raise RuntimeError("pp_cli: --spmd pp_1f1b --pipe 1 not refused")
    return [n // 2 for n in launches[2:5]]


# ------------------------------------------------ multi-process runs, the
# sequence-sharded ViT, the FSDP schedule, the supervisor, generate

MH_ARGV = ["--model", "lm_small", "--dataset", "synthetic-text", "--vocab",
           "256", "--seqlen", str(T_TRAIN), "--batch-size", "8", "--attn",
           "flash", "--opt", "adam", "--lr", "3e-4", "--cycles", "3",
           "--print-every", "1", "--eval-every", "0"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _task_times(torch, task, batch) -> dict:
    """Device ms a step (the profiler over 2 steps), warm wall ms a step
    (3 steps after one, synchronised) and the idle share of a finished
    task's step on one batch."""
    ms = device_ms(torch, lambda: task.step_fn(task.state, batch), calls=2)
    task.step_fn(task.state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        task.step_fn(task.state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    return {"step_ms_device": ms, "wall_ms_per_step_warm": wall,
            "device_idle_share_warm": 1 - ms / wall}


def multihost_cli_phase(torch, card):
    """The training CLI with ``--coordinator localhost:PORT
    --num-processes 1 --process-id 0`` on the card (the process group
    formed over TCP: one NCCL rank, since NCCL refuses two ranks on one
    GPU), lm_small 3 cycles, against ``--spmd dp`` without the flags:
    losses bit for bit, B1-B3 12 launches a step, the coordinator's
    banner.  Returns B1-B3's launches a step of the cluster run."""
    import contextlib
    import io

    from fluxdistributed_tpu_torch.mesh import shutdown_distributed
    from fluxdistributed_tpu_torch.parallel import multihost
    from fluxdistributed_tpu_torch.train.__main__ import run

    import os

    port = _free_port()
    rows = {}
    work = os.path.abspath(os.path.join(CKPT_DIR, "aot"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    aot = ["--aot", os.path.join(work, "aot")]
    for name, extra in (
            ("dp", ["--spmd", "dp", *aot]),
            ("cluster", ["--coordinator", f"localhost:{port}",
                         "--num-processes", "1", "--process-id", "0",
                         "--platform", "gpu", "--local-devices", "1"])):
        try:
            if name == "cluster":
                # formed here, so that the CLI joins it and leaves it up
                # for the timing below
                multihost.initialize(f"localhost:{port}", 1, 0,
                                     device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                task = run(MH_ARGV + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = all_counts()
            peak = torch.cuda.max_memory_allocated()
            batch = next(iter(task.loader))
            rows[name] = {"losses": task.losses, "launches": launches,
                          "wall_s": wall, "peak_allocated_bytes": peak,
                          "stdout_head": out.getvalue().splitlines()[:2],
                          **_task_times(torch, task, batch)}
            del task, batch
        finally:
            shutdown_distributed()
            torch.cuda.empty_cache()
    # the same dp run in processes of their own: with the dp run's AOT
    # manifest (it loads, builds nothing) and on the warm build cache
    try:
        for name, extra in (("aot_process", aot + cache_argv()),
                            ("warm_process", cache_argv())):
            rows[name] = _train_subprocess(MH_ARGV + ["--spmd", "dp", *extra],
                                           work, name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cl, ap, wp = rows["cluster"], rows["aot_process"], rows["warm_process"]
    per = [n // 3 for n in cl["launches"][2:5]]
    row = {"phase": "multihost_cli", "card": card, "model": "lm_small",
           "batch": 8, "seqlen": T_TRAIN, "dtype": "bfloat16", **rows,
           "losses_equal": cl["losses"] == rows["dp"]["losses"],
           "aot_losses_equal": ap["losses"] == rows["dp"]["losses"],
           "warm_losses_equal": wp["losses"] == rows["dp"]["losses"],
           "b1_b2_b3_launches_per_step": per}
    emit(row)
    ac, wc = ap["counters"], wp["counters"]
    if (not row["aot_losses_equal"] or not row["warm_losses_equal"]
            or ac["fdtpu_aot_loads_total"] != 1
            or ac["fdtpu_jax_cache_misses_total"]
            or ac["fdtpu_jax_compiles_total"]
            or wc["fdtpu_jax_cache_misses_total"]
            or wc["fdtpu_jax_cache_hits_total"] != 1):
        raise RuntimeError(f"multihost_cli cold start: {row}")
    if (not row["losses_equal"] or per != [12, 12, 12]
            or cl["launches"][0] or cl["launches"][1] or cl["launches"][5]
            or not any("devices: 1 (1/host x 1 hosts), platform gpu" in ln
                       for ln in cl["stdout_head"])
            or not all(math.isfinite(x) for x in cl["losses"])):
        raise RuntimeError(f"multihost_cli: {row}")
    return per


def vit_ring_phase(torch, card):
    """ViT-L/16 (224², batch 128, 196 tokens, bf16) sequence-sharded on
    one NCCL rank ``{data: 1, seq: 1}`` with the flash ring: one forward
    against the flash DP ViT's (bit for bit, B1 24 launches), then 3
    steps of ``prepare_training(spmd="sp")`` against the flash DP step
    (adamw), bit for bit, B1-B3 24 a step; the same two models serve
    both.  Returns those launches."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import vit_l16
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.parallel import make_ring_attention

    axes = {"data": 1, "seq": 1}
    make, mesh = _one_rank(lambda m: vit_l16(
        num_classes=1000, seed=0,
        attn_fn=make_ring_attention(m, impl="flash")), axes)
    models = {"dp": vit_l16(num_classes=1000, seed=0,
                            attn_fn=partial(flash_attention, causal=False)),
              "ring": make()}  # forms the one-rank group
    x = image_batch(torch, VIT_B, VISION_SIZE, 1000, torch.bfloat16,
                    "cuda", 80)["image"]
    fwd = {}
    for name, model in models.items():
        with torch.no_grad():
            model(x)  # first call: the kernels load
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all_counts()
            t0 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            fwd[name] = {"out": out, "launches": all_counts(),
                         "wall_ms": wall,
                         "peak_allocated_bytes":
                             torch.cuda.max_memory_allocated(),
                         "ms_device": device_ms(torch, lambda: model(x), 2)}
    equal = torch.equal(fwd["ring"]["out"], fwd["dp"]["out"])
    for v in fwd.values():
        v.pop("out")
    row = {"phase": "vit_ring_forward", "card": card, "model": "vit_l16",
           "batch": VIT_B, "tokens": VIT_T, "dtype": "bfloat16",
           "mesh": axes, "bit_equal_to_dp_flash": equal, **fwd}
    emit(row)
    if not equal or fwd["ring"]["launches"][2] != 24:
        raise RuntimeError(f"vit_ring forward: {row}")
    batches = [image_batch(torch, VIT_B, VISION_SIZE, 1000, torch.bfloat16,
                           "cuda", 90 + s) for s in range(SHARD_STEPS)]
    data = _ImageBank(VISION_SIZE, 1000)
    # the sp run first: it ends the group the ring model is bound to
    run = _shard_run(torch, lambda: models.pop("ring"), data, optim.adamw(),
                     batches, {"spmd": "sp", "mesh": mesh}, lm=False,
                     batch_size=VIT_B)
    ref = _shard_run(torch, lambda: models.pop("dp"), data, optim.adamw(),
                     batches, {}, lm=False, batch_size=VIT_B)
    per = [n // SHARD_STEPS for n in run["launches"][2:5]]
    row = _row(torch, "vit_ring", card, "sp_ring_flash", run, ref, per, {
        "model": "vit_l16", "batch": VIT_B, "tokens": VIT_T,
        "dtype": "bfloat16", "opt": "adamw (1e-3, wd 1e-2)", "mesh": axes,
        "dp_step_ms_device": ref["step_ms"],
        "dp_peak_allocated_bytes": ref["peak_allocated_bytes"]})
    _check_sharded("vit_ring", "sp_ring_flash", row, [24] * 3, exact=True)
    del run, ref, batches
    torch.cuda.empty_cache()
    return per


def _fsdp_steps(torch, make_model, data, opt, batches, lm, batch_size):
    """``prepare_training(spmd="fsdp")`` on one NCCL rank, one step (the
    schedule learns the blocks' order), then the others with the peaks
    reset: their losses (all steps), peak allocated bytes, peak live
    gathered bytes, device ms a step, warm wall ms and idle share."""
    from fluxdistributed_tpu_torch.mesh import data_mesh, shutdown_distributed
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.train import prepare_training

    model = make_model()
    try:
        task = prepare_training(
            model, data, opt, batch_size=batch_size, cycles=SHARD_STEPS,
            spmd="fsdp", mesh=data_mesh(device="cuda"),
            loss_fn=lm_loss_fn(model) if lm else None,
            topk=() if lm else (1,))
        plan = task.step_fn.gather_plan
        state, m = task.step_fn(task.state, batches[0])
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plan.live.peak = plan.live.now
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, m = task.step_fn(state, b)
            losses.append(m["loss"].item())
        wall = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
        out = {"losses": losses,
               "peak_allocated_bytes_steps_2_3":
                   torch.cuda.max_memory_allocated(),
               "gather_peak_bytes_steps_2_3": plan.live.peak,
               "blocks_scheduled": len(plan.order or ()),
               "wall_ms_per_step_warm": wall}
        ms = device_ms(torch, lambda: task.step_fn(state, batches[0]),
                       calls=2)
        out.update(step_ms_device=ms, device_idle_share_warm=1 - ms / wall)
        del task, state
        return out
    finally:
        del model
        shutdown_distributed()
        torch.cuda.empty_cache()


def fsdp_schedule_phase(torch, card):
    """The FSDP gather schedule against the gather-everything step
    (every leaf gathered up front, as before it: the step given no
    model): lm_small (B = 8, T = 1024, bf16, flash, adam) and ResNet-50
    (224², batch 256, bf16, momentum) 3 steps each under spmd="fsdp" on
    one NCCL rank; equal losses (sharded_train and fsdp_resnet hold the
    scheduled step to DP bit for bit); over steps 2-3 (the first learns
    the blocks' order) the peak allocated bytes, the peak live gathered
    bytes, device ms, warm wall ms and idle share of both.  At one rank
    an all-gather copies the whole leaf, so the gathered copies are what
    the schedule frees; across ranks it frees the other ranks' blocks
    too (the gloo tests count those)."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_small, resnet50
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.train import trainer

    lm_batches = [{"tokens": torch.from_numpy(
        np.random.default_rng(s).integers(0, 32000, (B, T_TRAIN)).astype(
            np.int64)).cuda()} for s in range(SHARD_STEPS)]
    cases = {
        "lm_small": (lambda: lm_small(vocab=32000, seed=0,
                                      attn_fn=attention_core("flash")),
                     _TokenBank(32000, T_TRAIN), lambda: optim.adam(SHARD_LR),
                     lm_batches, True, B),
        "resnet50": (lambda: resnet50(num_classes=1000, seed=0),
                     _ImageBank(VISION_SIZE, 1000),
                     lambda: optim.momentum(0.01, 0.9), None, False,
                     VISION_B)}
    step = trainer.make_train_step_sharded
    out = {}
    for name, (make, data, opt, batches, lm, bsz) in cases.items():
        if batches is None:
            batches = [image_batch(torch, VISION_B, VISION_SIZE, 1000,
                                   torch.bfloat16, "cuda", 60 + s)
                       for s in range(SHARD_STEPS)]
        runs = {}
        for mode in ("schedule", "gather_all"):
            if mode == "gather_all":
                trainer.make_train_step_sharded = (
                    lambda *a, **k: step(*a, **{**k, "model": None}))
            try:
                runs[mode] = _fsdp_steps(torch, make, data, opt(), batches,
                                         lm, bsz)
            finally:
                trainer.make_train_step_sharded = step
        sch, ga = runs["schedule"], runs["gather_all"]
        row = {"phase": "fsdp_schedule", "card": card, "model": name,
               **runs, "losses_equal": sch["losses"] == ga["losses"],
               "peak_saved_bytes": ga["peak_allocated_bytes_steps_2_3"]
               - sch["peak_allocated_bytes_steps_2_3"],
               "note": "one NCCL rank: each all-gather copies the whole "
                       "leaf; across ranks the saving also holds the "
                       "other ranks' blocks (not shown by one card)"}
        emit(row)
        if (not row["losses_equal"] or not sch["blocks_scheduled"]
                or sch["gather_peak_bytes_steps_2_3"]
                >= ga["gather_peak_bytes_steps_2_3"]):
            raise RuntimeError(f"fsdp_schedule {name}: {row}")
        out[name] = row
        del runs, batches
    return out


# ------------------------------------------------ cold start: the trainer

LM_BASE = ["--model", "lm_small", "--dataset", "synthetic-text", "--vocab",
           "256", "--seqlen", str(T_TRAIN), "--batch-size", "8", "--attn",
           "flash", "--opt", "adam", "--lr", "3e-4", "--eval-every", "0",
           "--print-every", "0"]


def _train_subprocess(argv, work, name):
    """``python -m fluxdistributed_tpu_torch.train argv`` in a process of
    its own, with its flight recorder and registry snapshots on disk:
    its losses, its last snapshot's cold-start counters and the wall
    seconds from the start of the process to its first step (the first
    snapshot after item 0)."""
    import os

    flight = os.path.join(work, f"{name}.flight.jsonl")
    jsonl = os.path.join(work, f"{name}.metrics.jsonl")
    cmd = [sys.executable, "-m", "fluxdistributed_tpu_torch.train", *argv,
           "--flight", flight, "--metrics-jsonl", jsonl]
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if p.returncode:
        raise RuntimeError(f"{name}: rc {p.returncode}\n{p.stdout[-3000:]}"
                           f"\n{p.stderr[-3000:]}")
    with open(flight) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    with open(jsonl) as f:
        snaps = [json.loads(ln) for ln in f if ln.strip()]
    after = next(s for s in snaps if s.get("step") == 1)
    final = snaps[-1]["metrics"]
    keys = ("fdtpu_jax_cache_misses_total", "fdtpu_jax_cache_hits_total",
            "fdtpu_jax_compiles_total", "fdtpu_jax_compile_seconds_total",
            "fdtpu_jax_cache_saved_seconds_total", "fdtpu_aot_loads_total",
            "fdtpu_aot_compiles_total")
    return {"losses": [r["loss"] for r in recs if r.get("kind") == "record"],
            "wall_s": wall, "first_step_s": after["ts"] - t0,
            "counters": {k: final.get(k) for k in keys}}


def steady_strict_phase(torch, card):
    """The trainer's cold-start checks on lm_small (B = 8, T = 1024,
    bf16, flash, adam): ``--steady-after 2`` at K = 1 and on the K = 8
    device loop reads 0 steady-state recompiles, and the K = 8 task run
    again with its last item cut short (a new batch layout: a new graph
    capture after warmup) reads exactly 1 and warns.  ``--strict-checks``
    passes on the sound step; a planted NaN in one parameter is named by
    aten op, and a planted ``.item()`` inside the step is refused by the
    second call's sync guard."""
    import dataclasses

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.obs import Observation, jaxmon
    from fluxdistributed_tpu_torch.train import prepare_training, train
    from fluxdistributed_tpu_torch.train.__main__ import run
    from fluxdistributed_tpu_torch.train.trainer import _StrictFirstCalls

    warned = []
    jaxmon.install(warn=warned.append)
    rows = {}

    def counted(fn):
        s0, c0, w0 = (jaxmon.steady_recompiles(), jaxmon.compile_count(),
                      len(warned))
        reset_all_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"wall_s": time.perf_counter() - t0,
                     "steady_recompiles": jaxmon.steady_recompiles() - s0,
                     "compiles": jaxmon.compile_count() - c0,
                     "warnings": warned[w0:], "b1_launches": attn_counts()[0]}

    try:
        task = None
        for name, extra in (
                ("k1", ["--cycles", "4", "--steady-after", "2"]),
                ("k8", ["--cycles", "32", "--steps-per-call", "8",
                        "--steady-after", "2"])):
            del task
            task, rows[name] = counted(lambda: run(LM_BASE + extra))
            rows[name]["losses"] = list(task.losses)

        class CutLast:
            """The loader, its last item cut to half the batch."""

            def __init__(self, inner):
                self.inner, self.start = inner, 0

            def __len__(self):
                return len(self.inner)

            def __iter__(self):
                items = list(self.inner)
                items[-1] = {k: v[:, :v.shape[1] // 2]
                             for k, v in items[-1].items()}
                return iter(items)

        task.loader = CutLast(task.loader)
        _, rows["k8_cut_last"] = counted(lambda: train(
            task, print_every=0, eval_every=0,
            observation=Observation(steady_after=2)))
        del task
        _, rows["strict"] = counted(lambda: run(
            LM_BASE + ["--cycles", "3", "--strict-checks"]))
    finally:
        jaxmon.install(warn=lambda msg: print(msg, file=sys.stderr))
    # the two checks' power, on an unarmed lm_small step
    from fluxdistributed_tpu_torch.data import SyntheticTextDataset
    from fluxdistributed_tpu_torch.models import lm_small

    model = lm_small(vocab=256, seed=0)
    t = prepare_training(model, SyntheticTextDataset(vocab=256,
                                                     seqlen=T_TRAIN),
                         optim.adam(3e-4), loss_fn=lm_loss_fn(model),
                         batch_size=8, cycles=1)
    it = iter(t.loader)
    batch = next(it)
    it.close()
    params = dict(t.state.params)
    name = next(iter(params))
    params[name] = params[name].clone()
    params[name].view(-1)[0] = float("nan")
    try:
        _StrictFirstCalls(t.step_fn, "train step")(
            dataclasses.replace(t.state, params=params), batch)
        rows["planted_nan"] = None
    except FloatingPointError as e:
        rows["planted_nan"] = str(e)

    def with_item(state, b):
        new, m = t.step_fn(state, b)
        m["loss"].item()  # the planted host sync
        return new, m

    armed = _StrictFirstCalls(with_item, "train step")
    armed(t.state, batch)  # call 1: the NaN check only
    try:
        armed(t.state, batch)
        rows["planted_item"] = None
    except RuntimeError as e:
        rows["planted_item"] = str(e)[:400]
    del t, model
    torch.cuda.empty_cache()
    row = {"phase": "steady_strict", "card": card, "model": "lm_small",
           **rows}
    emit(row)
    k1, k8, cut = rows["k1"], rows["k8"], rows["k8_cut_last"]
    if (k1["steady_recompiles"] or k8["steady_recompiles"]
            or k1["warnings"] or k8["warnings"] or k8["compiles"] != 1
            or cut["steady_recompiles"] != 1 or len(cut["warnings"]) != 1
            or "CUDA graph capture of the train step" not in
            cut["warnings"][0]
            or not all(math.isfinite(x) for x in k1["losses"] + k8["losses"])
            or len(k8["losses"]) != 32
            or rows["planted_nan"] is None
            or "aten." not in rows["planted_nan"]
            or rows["planted_item"] is None
            or "host sync" not in rows["planted_item"]):
        raise RuntimeError(f"steady_strict: {row}")


SUP_ARGV = ["--model", "lm_small", "--dataset", "synthetic-text", "--vocab",
            "256", "--seqlen", str(T_TRAIN), "--batch-size", "8", "--attn",
            "flash", "--opt", "adam", "--lr", "3e-4", "--cycles", "4",
            "--print-every", "1", "--eval-every", "0",
            "--checkpoint-every", "0", "--metrics-port", "0"]


def supervise_phase(torch, card):
    """The supervisor over the port's CLI on the card: lm_small 4 cycles
    with a fault plan that preempts at step 2 gives rc 75 (checkpoint and
    RESUME manifest), a resume without the plan and rc 0 at step 4; the
    episode ledger printed.  The children are processes of their own:
    their device time is not measured here."""
    import os

    from fluxdistributed_tpu_torch.supervise import Supervisor

    torch.cuda.empty_cache()
    work = os.path.join(CKPT_DIR, "supervise")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    snaps = os.path.abspath(os.path.join(work, "metrics.jsonl"))
    cmd = [sys.executable, "-m", "fluxdistributed_tpu_torch.train",
           *SUP_ARGV, "--checkpoint-dir", os.path.join(work, "ck"),
           *cache_argv(), "--metrics-jsonl", snaps,
           "--fault-plan", json.dumps({"sigterm_at_step": 2})]
    ledger = os.path.join(work, "ledger.json")
    sup = Supervisor(cmd, ledger=ledger, stall_timeout=300.0,
                     startup_grace=600.0, poll_interval=0.5, verbose=False)
    t0 = time.perf_counter()
    try:
        rc = sup.run()
        wall = time.perf_counter() - t0
        with open(ledger) as f:
            led = json.load(f)
        with open(snaps) as f:
            # each child's last snapshot, written as it ends
            finals = [json.loads(ln)["metrics"] for ln in f
                      if json.loads(ln).get("final")]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    eps = led["episodes"]
    row = {"phase": "supervise", "card": card, "rc": rc,
           "result": led["result"], "wall_s": wall,
           "episodes": [{k: e[k] for k in ("n", "rc", "class", "action",
                                           "wall_seconds", "steps")}
                        for e in eps],
           "resume_argv_tail": eps[-1]["argv"][-3:],
           "final_tail": eps[-1]["log_tail"][-2:],
           "step_ms_device": None, "note": "the trainer runs in child "
           "processes: device ms, idle share and peak bytes not measured",
           "children_build_cache": [
               {k.replace("fdtpu_jax_", ""): m.get(k) for k in (
                   "fdtpu_jax_cache_misses_total",
                   "fdtpu_jax_cache_hits_total",
                   "fdtpu_jax_compile_seconds_total")} for m in finals]}
    emit(row)
    tail = "\n".join(eps[-1]["log_tail"])
    if (len(finals) != 2 or any(
            c["cache_misses_total"] or c["cache_hits_total"] != 1
            for c in row["children_build_cache"])):
        raise RuntimeError(f"supervise: build cache {row}")
    if (rc != 0 or [e["class"] for e in eps] != ["preempted", "done"]
            or eps[0]["rc"] != 75 or "--resume" not in eps[-1]["argv"]
            or "--fault-plan" in eps[-1]["argv"]
            or "resumed from step 2" not in tail
            or "done: 4 steps" not in tail):
        raise RuntimeError(f"supervise: {row}")


GPT2_LAYERS, GPT2_D, GPT2_VOCAB, GPT2_POS = 12, 768, 50257, 1024
GEN_PROMPT, GEN_NEW = 8, 64


def _gpt2_state_dict(torch, seed: int) -> dict:
    """A GPT-2 small ``state_dict`` with HF's names and shapes, built on
    the card from ``seed`` (weights N(0, 0.02), norms 1, biases 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, device="cuda", generator=g) * 0.02

    d = GPT2_D
    sd = {"transformer.wte.weight": w(GPT2_VOCAB, d),
          "transformer.wpe.weight": w(GPT2_POS, d),
          "transformer.ln_f.weight": torch.ones(d, device="cuda"),
          "transformer.ln_f.bias": torch.zeros(d, device="cuda")}
    for i in range(GPT2_LAYERS):
        t = f"transformer.h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{t}.{ln}.weight"] = torch.ones(d, device="cuda")
            sd[f"{t}.{ln}.bias"] = torch.zeros(d, device="cuda")
        for name, (i_, o_) in (("attn.c_attn", (d, 3 * d)),
                               ("attn.c_proj", (d, d)),
                               ("mlp.c_fc", (d, 4 * d)),
                               ("mlp.c_proj", (4 * d, d))):
            sd[f"{t}.{name}.weight"] = w(i_, o_)  # Conv1D: [in, out]
            sd[f"{t}.{name}.bias"] = torch.zeros(o_, device="cuda")
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def generate_phase(torch, card):
    """GPT-2 small (12 layers, d = 768, 12 heads, vocab 50257, 1024
    positions, f32) from a seeded HF-named ``state_dict`` through
    ``python -m fluxdistributed_tpu_torch.generate --gpt2-weights``:
    greedy decode of 64 tokens from an 8-token prompt; the tokens equal
    the plain decode's (the decode kernel's plain version on the same
    model); B4 12 launches a single-token step; decode ms a token (wall
    and device).  Returns B4's launches a step."""
    import os

    import numpy as np

    from fluxdistributed_tpu_torch import generate as gen
    from fluxdistributed_tpu_torch import models
    from fluxdistributed_tpu_torch.models import gpt2
    from fluxdistributed_tpu_torch.models import transformer_lm as tlm
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode_reference)

    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "gpt2_small.pt")
    sd = _gpt2_state_dict(torch, 0)
    torch.save(sd, path)
    prompt = np.random.default_rng(7).integers(0, GPT2_VOCAB, GEN_PROMPT)
    total = GEN_PROMPT + GEN_NEW
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        t0 = time.perf_counter()
        cli_toks, vocab = gen.run(
            ["--gpt2-weights", path, "--prompt-tokens",
             ",".join(map(str, prompt)), "--length", str(total)])
        cli_s = time.perf_counter() - t0
        cli_launches = all_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.remove(path)
    model = gpt2.gpt2_model(sd, seqlen=total, device="cuda")
    del sd
    p = torch.as_tensor(prompt)[None].cuda()

    def decode():
        with torch.no_grad():
            return models.generate(model, p, total)

    toks = decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = decode()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ms = device_ms(torch, decode, calls=1)
    kernel = decode

    def plain_decode(q, k, v, idx, **kw):
        return flash_decode_reference(q, k, v, idx, **kw)

    keep = tlm.flash_decode
    tlm.flash_decode = plain_decode
    try:
        plain = kernel()
    finally:
        tlm.flash_decode = keep
    steps = GEN_NEW - 1  # single-token steps after the prefill's token
    per_step = cli_launches[0] / steps
    row = {"phase": "generate", "card": card, "model": "gpt2_small (seeded)",
           "layers": GPT2_LAYERS, "dim": GPT2_D, "vocab": vocab,
           "dtype": "float32", "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
           "cli_tokens_equal_decode": bool(np.array_equal(
               cli_toks, toks[0].cpu().numpy())),
           "tokens_equal_plain_decode": torch.equal(toks, plain),
           "b4_launches": cli_launches[0],
           "b4_launches_per_step": per_step,
           "launches_b4_b5_b1_b2_b3_b6": cli_launches,
           "cli_seconds": cli_s, "peak_allocated_bytes": peak,
           "decode_ms_per_token_wall": wall / GEN_NEW,
           "decode_ms_per_token_device": ms / GEN_NEW,
           "device_idle_share": 1 - ms / wall}
    emit(row)
    if (not row["tokens_equal_plain_decode"]
            or not row["cli_tokens_equal_decode"]
            or cli_launches[0] != GPT2_LAYERS * steps
            or any(cli_launches[1:])):
        raise RuntimeError(f"generate: {row}")
    del model
    torch.cuda.empty_cache()
    return GPT2_LAYERS



ROUTER_NEW = 32  # new tokens a routed request
ROUTER_LENS = [64 + 46 * i for i in range(16)]  # prompts of 64-754 tokens
ROUTER_KILL_AFTER = 8  # r0's decode steps into the routed burst
CLI_REPLICA = ["--model", "lm_small", "--max-slots", "4", "--max-len",
               "256", "--port", "0"]


class _LMReplica:
    """One in-process lm_small replica on the card: its own engine
    (dense, 8 slots of 1024 rows), scheduler and LM server on a port.
    ``kill`` is a process death seen from outside: the listening socket
    and every open connection close at once and the engine loop stops,
    so in-flight requests' connections drop before their tokens."""

    def __init__(self, model, port=0):
        import socket

        from fluxdistributed_tpu_torch.serve import (LMEngine, LMServer,
                                                     Scheduler)
        from fluxdistributed_tpu_torch.serve.server import HTTPServer

        class Server(HTTPServer):
            def __init__(self, *a):
                self.conns, self.conns_lock = set(), threading.Lock()
                super().__init__(*a)

            def process_request(self, request, client_address):
                with self.conns_lock:
                    self.conns.add(request)
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                with self.conns_lock:
                    self.conns.discard(request)
                super().shutdown_request(request)

            def sever(self):
                with self.conns_lock:
                    conns = list(self.conns)
                for c in conns:
                    try:
                        c.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        self.model = model
        self.engine = LMEngine(model, max_slots=8, max_len=1024)
        self.sched = Scheduler(self.engine, max_queue=64)
        self.srv = LMServer(self.sched, vocab=32000)
        self.srv.start_loop()
        self.httpd = Server(("127.0.0.1", port), self.srv.make_handler())
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.killed = False
        threading.Thread(target=self.httpd.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True).start()

    def kill(self):
        self.killed = True
        self.httpd.shutdown()
        self.httpd.sever()
        self.httpd.server_close()
        self.srv.stop_loop()

    def close(self, drain_timeout=60.0):
        """The graceful stop a restart hook makes (drain, then close)."""
        if not self.killed:
            if not self.srv.drain(drain_timeout):
                raise RuntimeError("router: a replica did not drain")
            self.httpd.shutdown()
            self.httpd.server_close()
        self.srv.close()


def _generate(base, prompt, rid=None):
    """One greedy non-streaming request; returns the response body."""
    return post(base + "/v1/generate", {
        "prompt_tokens": prompt, "max_tokens": ROUTER_NEW,
        "temperature": 0.0}, rid=rid)


def _burst(base, prompts, ids=None):
    """Every prompt at once; returns (bodies, errors, wall s)."""
    out, errors = [None] * len(prompts), []

    def call(i):
        try:
            out[i] = _generate(base, prompts[i], ids and ids[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        errors.append("a request did not return in 600 s")
    return out, errors, time.perf_counter() - t0


def _stream_ttft_ms(base, prompt) -> float:
    """Client-side time to the first streamed token of one request."""
    req = urllib.request.Request(
        base + "/v1/generate", json.dumps({
            "prompt_tokens": prompt, "max_tokens": 2, "temperature": 0.0,
            "stream": True}).encode(), {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        first = r.readline()
        ms = (time.perf_counter() - t0) * 1e3
        r.read()
    if b"token" not in first:
        raise RuntimeError(f"{base}: no first token ({first!r})")
    return ms


def router_phase(torch, card):
    """Two in-process lm_small replicas (seed 0 each, dense, 8 slots of
    1024 rows) behind the port's router with manual probes: 16 greedy
    requests straight to r0 as the reference; the same 16 through the
    router with r0 killed after 8 decode steps of the burst (every
    response equal to the reference token for token, each keeping its
    X-Request-Id, a failover, r0's breaker open); r0 back through its
    restart hook (breaker closed); the fleet's throughput on the 16;
    a rolling restart under 8 requests in flight (none fails); TTFT
    direct and through the router.  B4's launches over every engine
    since the burst equal depth x their decode steps.  Returns them."""
    from fluxdistributed_tpu_torch.models import lm_small
    from fluxdistributed_tpu_torch.ops.flash_decode import flash_decode
    from fluxdistributed_tpu_torch.serve.router import Replica, Router

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
               for n in ROUTER_LENS]
    models = [lm_small(vocab=32000, seed=0) for _ in range(2)]
    reps = [_LMReplica(m) for m in models]
    engines = [r.engine for r in reps]

    def restart_hook(i):
        def restart(replica):
            old = reps[i]
            old.close()
            reps[i] = _LMReplica(old.model, port=old.port)
            engines.append(reps[i].engine)
            # the successor captures its decode graph before it serves
            _generate(reps[i].url, prompts[0][:8])
            return reps[i].url
        return restart

    # round-robin dispatch (every scrape counts as stale): the burst
    # must reach r0, the replica this phase kills
    router = Router([Replica(f"r{i}", r.url, restart=restart_hook(i))
                     for i, r in enumerate(reps)],
                    probe_interval=3600.0, probe_timeout=30.0,
                    failure_threshold=2, breaker_cooldown=3600.0,
                    metrics_stale_after=0.0, dispatch_tries=4,
                    dispatch_backoff=0.05, upstream_timeout=600.0)
    httpd = router.serve("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever,
                     kwargs={"poll_interval": 0.02}, daemon=True).start()
    base = f"http://127.0.0.1:{router.bound_port}"
    try:
        for r in reps:  # warm-up: each engine captures its decode graph
            _generate(r.url, prompts[0][:8])
        ref, errors, ref_wall = _burst(reps[0].url, prompts)
        if errors:
            raise RuntimeError(f"router: reference requests failed: {errors}")
        want = [b["generated"] for b in ref]

        router.probe_now()
        flash_decode.launches = 0  # count from the routed burst on
        steps0 = {id(e): e.decode_steps for e in engines}
        ids = [f"router-{i}" for i in range(len(prompts))]
        killed = threading.Event()

        def killer():
            e = reps[0].engine
            base_steps = e.decode_steps
            while e.decode_steps - base_steps < ROUTER_KILL_AFTER:
                time.sleep(0.0005)
            reps[0].kill()
            killed.set()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        got, errors, burst_wall = _burst(base, prompts, ids)
        kt.join(timeout=60)
        failovers = router.registry.value("fdtpu_router_failovers_total")
        router.probe_now()
        router.probe_now()
        r0 = router.replicas[0]
        breaker_after_kill = r0.breaker
        mismatched = [i for i, b in enumerate(got)
                      if b is None or b["generated"] != want[i]]
        lost_ids = [i for i, b in enumerate(got)
                    if b is None or b["request_id"] != ids[i]]
        restart_hook(0)(r0)  # r0 back on its port: a new engine
        router.probe_now()
        breaker_recovered = r0.breaker
        opens = router.registry.value("fdtpu_router_breaker_opens_total",
                                      "r0")

        fleet, fleet_errors, fleet_wall = _burst(base, prompts)
        fleet_bad = [i for i, b in enumerate(fleet)
                     if b is None or b["generated"] != want[i]]

        inflight = {}
        lt = threading.Thread(target=lambda: inflight.update(zip(
            ("bodies", "errors", "wall"), _burst(base, prompts[:8]))),
            daemon=True)
        lt.start()
        time.sleep(0.05)  # the 8 are in flight
        restarted = router.rolling_restart(drain_timeout=120.0,
                                           ready_timeout=120.0)
        lt.join(timeout=600)
        rr_bad = [i for i, b in enumerate(inflight.get("bodies") or [None])
                  if b is None or b["generated"] != want[i]]

        ttft = {"direct": [], "router": []}
        for _ in range(8):
            ttft["direct"].append(_stream_ttft_ms(reps[1].url, prompts[0]))
            ttft["router"].append(_stream_ttft_ms(base, prompts[0]))
        launches = flash_decode.launches
        steps = sum(e.decode_steps - steps0.get(id(e), 0) for e in engines)
        depth = models[0].depth
        direct_p50 = statistics.median(ttft["direct"])
        router_p50 = statistics.median(ttft["router"])
        row = {"phase": "router", "card": card, "model": "lm_small",
               "dtype": "bfloat16", "vocab": 32000, "replicas": 2,
               "max_slots": 8, "max_len": 1024, "prompt_tokens": ROUTER_LENS,
               "new_tokens": ROUTER_NEW, "requests": len(prompts),
               "routed_errors": errors, "tokens_mismatched": mismatched,
               "request_ids_lost": lost_ids, "killed": killed.is_set(),
               "failovers": failovers,
               "breaker_after_kill": breaker_after_kill,
               "breaker_after_restart_hook": breaker_recovered,
               "breaker_opens_r0": opens,
               "fleet_errors": fleet_errors,
               "fleet_tokens_mismatched": fleet_bad,
               "rolling_restart": restarted,
               "rolling_restart_errors": inflight.get("errors"),
               "rolling_restart_tokens_mismatched": rr_bad,
               "reference_wall_s": ref_wall, "routed_burst_wall_s": burst_wall,
               "one_replica_generated_tokens_per_s":
                   ROUTER_NEW * len(prompts) / ref_wall,
               "fleet_generated_tokens_per_s":
                   ROUTER_NEW * len(prompts) / fleet_wall,
               "ttft_ms_p50_direct": direct_p50,
               "ttft_ms_p50_router": router_p50,
               "router_hop_ms": router_p50 - direct_p50,
               "engines": len(engines), "decode_steps": steps,
               "b4_launches": launches, "depth": depth,
               "wall_s": time.perf_counter() - t_phase}
        emit(row)
        if (errors or mismatched or lost_ids or not killed.is_set()
                or failovers < 1 or breaker_after_kill != "open"
                or breaker_recovered != "closed" or opens < 1
                or fleet_errors or fleet_bad
                or len(restarted) != 2 or inflight.get("errors")
                or rr_bad or len(inflight.get("bodies") or []) != 8
                or steps < 1 or launches != depth * steps):
            raise RuntimeError(f"router: {row}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
        for r in reps:
            if not r.killed:
                r.kill()
            r.srv.close()
    del models, reps, engines
    torch.cuda.empty_cache()
    return launches


def _rollup_values(text, name) -> dict:
    """``{replica: value}`` of one series in a router's /metrics rollup
    (the replica label the router adds, first in the label set)."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{replica=") or line.startswith(
                name + "_total{replica="):
            rep = line.split('replica="', 1)[1].split('"', 1)[0]
            out[rep] = float(line.rsplit(" ", 1)[1])
    return out


def router_cli_phase(torch, card):
    """The user's path: two ``python -m fluxdistributed_tpu_torch.serve
    --model lm_small --max-slots 4 --max-len 256`` replica processes on
    the card (r0 with ``--fault-plan`` exiting at scheduler tick 20),
    fronted by the port's router through ``SupervisedReplica`` restart
    hooks (``--spawn`` gives every child one command): 8 requests with
    no failure across r0's crash; ``python -m
    fluxdistributed_tpu_torch.serve.router --rolling-restart URL`` with
    4 requests in flight (none fails); the 8 on one replica process
    against the two, in turns; the router's /metrics rollup carries each
    replica's decode tokens and reads one decode graph a replica, the
    successors included.  Wall s of each start and restart."""
    import os

    from fluxdistributed_tpu_torch.serve.router import (Replica, Router,
                                                        SupervisedReplica,
                                                        wait_http_ready)

    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join(
        x for x in (root, os.environ.get("PYTHONPATH")) if x)}
    cmd = [sys.executable, "-m", "fluxdistributed_tpu_torch.serve",
           *CLI_REPLICA, *cache_argv(), "--prewarm"]
    kill = json.dumps({"fail": [{"site": "serve.tick", "at": 20,
                                 "action": "exit"}]})
    sups = [SupervisedReplica(cmd + ["--fault-plan", kill], name="r0",
                              env=env, verbose=False),
            SupervisedReplica(cmd, name="r1", env=env, verbose=False)]
    urls, starts = [None, None], [None, None]

    def spawn(i):
        t0 = time.perf_counter()
        urls[i] = sups[i].spawn()
        wait_http_ready(urls[i] + "/healthz", timeout=300)
        starts[i] = time.perf_counter() - t0

    router = httpd = None
    try:
        threads = [threading.Thread(target=spawn, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=400)
        if None in urls or None in starts:
            raise RuntimeError(f"router_cli: replicas did not start "
                               f"({urls})")
        router = Router([Replica(f"r{i}", u, restart=s.restart)
                         for i, (u, s) in enumerate(zip(urls, sups))],
                        probe_interval=3600.0, probe_timeout=30.0,
                        failure_threshold=2, breaker_cooldown=3600.0,
                        dispatch_tries=4, dispatch_backoff=0.05,
                        upstream_timeout=600.0)
        httpd = router.serve("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True).start()
        base = f"http://127.0.0.1:{router.bound_port}"
        g = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
                   for n in (32, 48, 64, 96, 128, 160, 192, 224)]
        _, errors, crash_wall = _burst(base, prompts)
        t_dead = time.perf_counter()
        while sups[0].alive() and time.perf_counter() - t_dead < 60:
            time.sleep(0.05)
        r0_died = not sups[0].alive()
        failovers = router.registry.value("fdtpu_router_failovers_total")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            before = r.read().decode()
        r1_compiles = _rollup_values(before, "fdtpu_serve_decode_compiles")
        build_cache = {k: _rollup_values(before, "fdtpu_jax_" + k)
                       for k in ("cache_misses", "cache_hits",
                                 "compile_seconds")}

        sups[0].argv = cmd  # the successor carries no kill plan
        inflight = {}
        lt = threading.Thread(target=lambda: inflight.update(zip(
            ("bodies", "errors", "wall"), _burst(base, prompts[:4]))),
            daemon=True)
        lt.start()
        time.sleep(0.05)
        client = subprocess.run(
            [sys.executable, "-m", "fluxdistributed_tpu_torch.serve.router",
             "--rolling-restart", base, "--drain-timeout", "120"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, **env))
        lt.join(timeout=600)
        restarted = (json.loads(client.stdout)["restarted"]
                     if client.returncode == 0 else None)
        for _ in range(2):  # each successor serves (round-robin ties)
            _generate(base, prompts[0])
        # the 8 on one replica process against the two, in turns
        rates = {"one_replica": [], "fleet": []}
        rate_errors = []
        for name in ("one_replica", "fleet", "fleet", "one_replica"):
            url = router.replicas[1].url if name == "one_replica" else base
            bodies, errs, wall = _burst(url, prompts)
            rate_errors += errs
            rates[name].append(ROUTER_NEW * len(prompts) / wall)
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            after = r.read().decode()
        tokens = _rollup_values(after, "fdtpu_serve_decode_tokens")
        compiles = _rollup_values(after, "fdtpu_serve_decode_compiles")
        row = {"phase": "router_cli", "card": card, "model": "lm_small",
               "replica_cmd": " ".join(["python", *cmd[1:]]),
               "requests": len(prompts), "errors": errors,
               "crash_burst_wall_s": crash_wall, "r0_died": r0_died,
               "failovers": failovers,
               "replica_start_s": dict(zip(("r0", "r1"), starts)),
               "rolling_restart_rc": client.returncode,
               "rolling_restart": restarted,
               "rolling_restart_stderr": client.stderr[-500:],
               "rolling_restart_errors": inflight.get("errors"),
               "generated_tokens_per_s": rates,
               "rate_errors": rate_errors,
               "decode_compiles_before_restart": r1_compiles,
               "r1_build_cache": build_cache,
               "decode_tokens_after": tokens,
               "decode_compiles_after": compiles}
        emit(row)
        if (errors or not r0_died or failovers < 1
                or r1_compiles.get("r1") != 1.0
                or client.returncode != 0 or len(restarted or []) != 2
                or inflight.get("errors")
                or len(inflight.get("bodies") or []) != 4 or rate_errors
                or not all(tokens.get(n, 0) > 0 for n in ("r0", "r1"))
                or compiles != {"r0": 1.0, "r1": 1.0}
                or build_cache["cache_misses"].get("r1") != 0.0
                or build_cache["cache_hits"].get("r1") != 1.0):
            raise RuntimeError(f"router_cli: {row}")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if router is not None:
            router.close()
        for s in sups:
            s.stop()


# ------------------------------------------------ pricing a step

# The priced peak of a step against the allocator's peak of the same real
# step: the fake run counts each storage's bytes as the caching allocator
# holds them, rounded less (512-byte blocks) and without the library
# workspaces a first step leaves behind, so the two should agree within
# these bounds
PRICE_RATIO = (0.8, 1.25)


def _storage_bytes(torch, tree) -> int:
    """The bytes of every distinct storage in a tree of tensors."""
    from fluxdistributed_tpu_torch.obs.pricing import _tensors

    return sum({id(st): st.nbytes() for st in (
        t.untyped_storage() for t in _tensors(tree))}.values())


def pricing_phase(torch, card, keep=None):
    """Pricing a step before it runs (``obs/pricing.py``): the private
    APIs it rests on import here; the lm_small DP step (B = 8, T = 1024,
    bf16, flash, adam) priced on fake tensors against
    ``max_memory_allocated`` of the same real step, within PRICE_RATIO,
    pricing launching no kernel and the real step after it launching
    B1-B3 12 times each; the ledger of the lm_small FSDP step recorded
    on one NCCL rank equal to the fake-priced one at one rank; the
    planned 1F1B on the local exchange (S = 2, M = 4, boundaries from
    ``plan_from_model``): its probe gradient within PP_GRAD_RTOL of
    DP's, B1-B3 launching what the timetable gives, its modeled bubble
    beside the measured idle share (one card: no real bubble).  A plan
    with uniform boundaries is pp_train's 1F1B program on the same
    batches, whose row (``keep["pp_1f1b_s2_m4"]``) is read instead of
    running it again.  Returns B1-B3's launches a step of the planned
    1F1B."""
    import numpy as np

    # the private APIs pricing rests on (they moved between releases)
    from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import (  # noqa: F401
        FakeStore)

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import (data_mesh, init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn, lm_small
    from fluxdistributed_tpu_torch.obs import comms
    from fluxdistributed_tpu_torch.obs.pricing import price_step, pricing
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel.pp_1f1b import build_schedule
    from fluxdistributed_tpu_torch.parallel.pp_plan import plan_from_model
    from fluxdistributed_tpu_torch.train import prepare_training

    emit({"phase": "pricing_imports", "torch": torch.__version__,
          "FakeTensorMode": True, "FakeStore": True})
    model = lm_small(vocab=32000, attn_fn=attention_core("flash"), seed=0)
    data = _TokenBank(32000, T_TRAIN)
    tok = [{"tokens": torch.from_numpy(np.random.default_rng(s).integers(
        0, 32000, (B, T_TRAIN)).astype(np.int64)).cuda()}
        for s in range(SHARD_STEPS)]

    def prep(m, **kw):
        return prepare_training(m, data, kw.pop("opt", optim.adam(SHARD_LR)),
                                batch_size=B, cycles=1, loss_fn=lm_loss_fn(m),
                                topk=(), **kw)

    def priced_step(world, **kw):
        """(priced, seconds) of the step ``prep`` builds, on fake tensors
        over a fake world of ``world`` ranks (``None``: none)."""
        t0 = time.perf_counter()
        with pricing(world, device="cuda") as pr:
            mesh = data_mesh(world, device="cuda") if world else None
            fm = pr.module(model)
            task = prep(fm, mesh=mesh, **kw)
            batch = pr.batch({"tokens": ((B, T_TRAIN), torch.int64)},
                             shards=world or 1)
            out = price_step(task.step_fn, (task.state, batch), mesh=mesh)
        return out, time.perf_counter() - t0

    # the DP step: priced, then real
    reset_all_counts()
    priced, price_s = priced_step(None)
    pricing_launches = all_counts()
    task = prep(model)
    task.step_fn(task.state, tok[0])  # warm: library workspaces
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    args_bytes = _storage_bytes(torch, (task.state, tok[0]))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    out = task.step_fn(task.state, tok[0])
    torch.cuda.synchronize()
    real_launches = all_counts()
    allocated = torch.cuda.max_memory_allocated() - base + args_bytes
    del out, task
    torch.cuda.empty_cache()
    ratio = priced["memory"]["peak_bytes"] / allocated
    row = {"phase": "pricing", "card": card, "step": "lm_small dp",
           "batch": B, "seqlen": T_TRAIN, "dtype": "bfloat16",
           "attn": "flash", "opt": "adam", "priced": priced["memory"],
           "priced_ledger": priced["comms"], "pricing_s": price_s,
           "allocated_peak_bytes": allocated,
           "allocated_args_bytes": args_bytes,
           "priced_over_allocated": ratio, "ratio_limits": PRICE_RATIO,
           "pricing_launches_b4_b5_b1_b2_b3_b6": pricing_launches,
           "real_step_launches_b4_b5_b1_b2_b3_b6": real_launches}
    emit(row)
    if not PRICE_RATIO[0] <= ratio <= PRICE_RATIO[1]:
        raise RuntimeError(f"pricing: priced peak over allocated {ratio} "
                           f"outside {PRICE_RATIO}: {row}")
    if pricing_launches != [0] * 6 or real_launches != [0, 0, 12, 12, 12, 0]:
        raise RuntimeError(f"pricing: launches {row}")

    # the FSDP step's ledger: priced on a fake world of one, recorded on
    # one NCCL rank (a steady step: the first call learns the order)
    fake_fsdp, fsdp_s = priced_step(1, spmd="fsdp")
    mesh = init_distributed("cuda")
    try:
        task = prep(model, mesh=mesh, spmd="fsdp")
        task.step_fn(task.state, tok[0])
        with comms.recording(mesh) as rec:
            out = task.step_fn(task.state, tok[0])
            torch.cuda.synchronize()
        real_ledger = rec.entries()
        del out, task
    finally:
        shutdown_distributed()
        torch.cuda.empty_cache()
    row = {"phase": "pricing_ledger", "card": card,
           "step": "lm_small fsdp, one rank", "pricing_s": fsdp_s,
           "priced": fake_fsdp["comms"], "recorded_nccl": real_ledger,
           "equal": fake_fsdp["comms"] == real_ledger,
           "priced_peak_bytes": fake_fsdp["memory"]["peak_bytes"]}
    emit(row)
    if not row["equal"] or not real_ledger:
        raise RuntimeError(f"pricing_ledger: {row}")

    # the planned 1F1B on the local exchange
    t0 = time.perf_counter()
    plan = plan_from_model(model, PP_S, PP_M, batch_size=B, seqlen=T_TRAIN)
    plan_s = time.perf_counter() - t0
    sched = build_schedule(PP_S, PP_M)
    counts = plan.counts
    fwd = sum(int(sched.is_fwd[:, i].sum()) * counts[i] for i in range(PP_S))
    bwd = sum(int(sched.is_bwd[:, i].sum()) * counts[i] for i in range(PP_S))
    # each B tick recomputes its stage forward (B1) before B2 and B3
    expected = [fwd + bwd, bwd, bwd]
    shared = (keep or {}).get("pp_1f1b_s2_m4") if plan.is_uniform else None
    if shared is not None:
        run = {k: shared[k] for k in ("losses", "step_ms_device",
                                      "wall_ms_per_step_warm",
                                      "device_idle_share_warm")}
        per = shared["b1_b2_b3_launches_per_step"]
        grad_err = shared["probe_grad_worst_leaf_rel_err_vs_dp"]
        del model
    else:
        p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
        probe = optim.descent(PROBE_LR)
        task = prep(model, opt=probe)
        state, _ = task.step_fn(task.state, tok[0])
        dp_grads = _probe_grads({k: state.params[k] for k in p0}, p0)
        del task, state, model
        torch.cuda.empty_cache()
        ran = _pp_local_run(torch, tok, "1f1b", False,
                            boundaries=plan.boundaries)
        run = {"losses": ran["losses"], "step_ms_device": ran["step_ms"],
               "wall_ms_per_step_warm": ran["wall_ms_per_step_warm"],
               "device_idle_share_warm": ran["device_idle_share_warm"]}
        per = [n // SHARD_STEPS for n in ran["launches"][2:5]]
        grad_err = _worst_leaf_rel_err(torch, _probe_grads(_pp_local_run(
            torch, tok[:1], "1f1b", False, probe, False,
            boundaries=plan.boundaries)["params"], p0), dp_grads)
        del ran, dp_grads, p0
    torch.cuda.empty_cache()
    row = {"phase": "pricing_planned_1f1b", "card": card,
           "model": "lm_small", "pipe_devices": PP_S, "microbatches": PP_M,
           "exchange": "local", "plan": plan.describe(),
           "boundaries": list(plan.boundaries), "plan_s": plan_s,
           "uniform": plan.is_uniform,
           "run": ("pp_train's 1f1b_s2_m4 (the same program and batches)"
                   if shared is not None else "run here"),
           "modeled_bubble": plan.modeled_bubble,
           "uniform_modeled_bubble": plan.uniform_bubble,
           **run,
           "note": "one card and one process: the stages take turns, so "
                   "the idle share is host time between kernels, not a "
                   "pipeline bubble",
           "probe_grad_worst_leaf_rel_err_vs_dp": grad_err,
           "grad_rtol": PP_GRAD_RTOL,
           "launches_per_step_b1_b2_b3": per,
           "timetable_launches_per_step_b1_b2_b3": expected}
    emit(row)
    if (grad_err > PP_GRAD_RTOL or per != expected
            or not all(math.isfinite(x) for x in run["losses"])):
        raise RuntimeError(f"pricing_planned_1f1b: {row}")
    return per


def pricing_cli_phase(torch, card):
    """The pricing CLIs in-process: ``python -m
    fluxdistributed_tpu_torch.fit --collect P --host-devices 8`` (every
    registered variant priced on 8 fake cuda ranks) and ``--profile P
    --host-devices 8`` under the card's default budget (its total
    memory: every priced variant fits); then the training CLI's
    ``--layout auto --layout-report R`` on lm_small for 6 steps: the
    pick priced in a child process, whose only candidate at one rank is
    ``dp``, so the run is the layout CLI run of the sharded_cli phase,
    held to its checks (a state of blocks, B1-B3 12 a step).  The pp_cli
    phase runs ``--pp-plan auto``.  Returns B1-B3's launches a step of
    the layout-auto run."""
    import contextlib
    import io
    import os
    import tempfile

    from fluxdistributed_tpu_torch import fit
    from fluxdistributed_tpu_torch.train.__main__ import run

    tmp = tempfile.mkdtemp(prefix="fdtpu_pricing_")
    prof = os.path.join(tmp, "fit.profile.json")
    report = os.path.join(tmp, "pick.json")
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = fit.main(["--collect", prof, "--host-devices", "8"])
        collect_s = time.perf_counter() - t0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc2 = fit.main(["--profile", prof, "--host-devices", "8",
                            "--json"])
        ranked = json.loads(out.getvalue())
        _, total = torch.cuda.mem_get_info()
        priced = [r for r in ranked["rows"] if r["peak_bytes"] is not None]
        row = {"phase": "pricing_cli_fit", "card": card,
               "collect_rc": rc, "profile_rc": rc2, "collect_s": collect_s,
               "budget_bytes": ranked["budget_bytes"],
               "card_total_bytes": total, "variants": len(ranked["rows"]),
               "priced": len(priced),
               "unpriced": [r["variant"] for r in ranked["rows"]
                            if r["peak_bytes"] is None],
               "largest_peak": max(priced, key=lambda r: r["peak_bytes"])}
        emit(row)
        if (rc or rc2 or ranked["budget_bytes"] != float(total)
                or len(priced) < 20 or not all(r["fits"] for r in priced)):
            raise RuntimeError(f"pricing_cli fit: {row}")
        reset_all_counts()
        t0 = time.perf_counter()
        task = run(SHARD_CLI + ["--layout", "auto", "--layout-report",
                                report])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_counts()
        doc = json.load(open(report))
        row = {"phase": "pricing_cli_layout_auto", "card": card,
               "chosen": doc["chosen"], "budget_bytes": doc["budget_bytes"],
               "reason": doc["reason"], "rows": [
                   {k: r.get(k) for k in ("layout", "peak_bytes", "fits",
                                          "comms_bytes", "headroom_bytes",
                                          "invalid")} for r in doc["rows"]],
               "steps": task.state.step, "losses": task.losses,
               "mesh": task.mesh.shape, "wall_s": wall,
               "launches_b4_b5_b1_b2_b3_b6": launches}
        emit(row)
        if (doc["chosen"] != "dp" or doc["budget_bytes"] != float(total)
                or task.specs is None or len(task.losses) != 6
                or not all(math.isfinite(x) for x in task.losses)
                or launches != [0, 0, 72, 72, 72, 0]):
            raise RuntimeError(f"pricing_cli --layout auto: {row}")
        del task
        torch.cuda.empty_cache()
        return [n // 6 for n in launches[2:5]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    try:
        from fluxdistributed_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the cold process: a fresh persistent build cache under _build/, which
    # the CLI processes of the phases read warm (--compile-cache); removed
    # when the run ends
    global CACHE_ROOT
    CACHE_ROOT = str(_build.BUILD_DIR / f"cache-{os.getpid()}-"
                     f"{int(time.time())}")
    try:
        return run_phases(torch, _build)
    finally:
        shutil.rmtree(CACHE_ROOT, ignore_errors=True)


def build_phase(_build) -> None:
    """Phase 2: every kernel source built cold into ``CACHE_ROOT``, each
    build's ``ptxas`` lines, the registers and spills of the kernels this
    script holds to (raises if B1 spills at 64 or 80, or B2 or B3 at 80
    outside the audit), the kernels whose ``wgmma`` ptxas serialised, and
    the Hopper kernels' SASS (:func:`sass_check`)."""
    from fluxdistributed_tpu_torch import compilation
    from fluxdistributed_tpu_torch.ops.flash_attention import HOPPER_BWD_DIMS

    ns_dir = compilation.enable_persistent_cache(CACHE_ROOT)
    t0 = time.perf_counter()
    logs = _build.build_all()
    cold = compilation.compile_metrics()
    nvcc_s = {n: json.loads(_build.library_path(n).with_suffix(
        ".json").read_text())["seconds"] for n in sorted(logs)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs), "cache_dir": ns_dir, **cold,
          "nvcc_seconds": nvcc_s})
    if cold["cache_misses"] != len(_build.SOURCES) or cold["cache_hits"]:
        raise RuntimeError(f"build: a fresh cache dir was not cold: {cold}")
    for src, log in logs.items():  # a library built earlier: its saved log
        saved = _build.library_path(src).with_suffix(".log")
        if not log and saved.exists():
            logs[src] = saved.read_text()
    for src, log in logs.items():
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"  {src}: {line.strip()}", flush=True)

    dq_tc = ptxas_summary(logs.get("flash_attention", ""), "flash_bwd_dq_tc")
    emit({"phase": "ptxas", "kernel": "flash_bwd_dq_tc_kernel<D, audit>",
          "by_dim": {f"D=32{' audit' if a else ''}": r
                     for name, r in dq_tc.items() for a in (0, 1)
                     if f"ILi32ELb{a}E" in name}})
    for frag, kname in (("flash_bwd_dq_wg", "flash_bwd_dq_wg_kernel<D, audit>"),
                        ("flash_bwd_dkv_wg",
                         "flash_bwd_dkv_wg_kernel<D, audit>")):
        wg = ptxas_summary(logs.get("flash_attention", ""), frag)
        by_dim = {f"D={d}{' audit' if a else ''}": r
                  for name, r in wg.items()
                  for d in HOPPER_BWD_DIMS for a in (0, 1)
                  if f"ILi{d}ELb{a}E" in name}
        emit({"phase": "ptxas", "kernel": kname,
              "design": "wgmma, TMA, warp-specialised", "by_dim": by_dim})
        d80 = by_dim.get("D=80", {})
        if d80.get("spill_stores", 1) or d80.get("spill_loads", 1):
            raise RuntimeError(f"ptxas: {kname} spills at D = 80, or is "
                               f"missing: {d80}")
    emit({"phase": "ptxas", "kernel": "wgmma serialised (C7520)",
          "kernels": serialised_wgmma(logs.get("flash_attention", ""))})
    b1 = ptxas_summary(logs.get("flash_attention", ""), "flash_fwd_wg")
    b1 = {f"D={d}": r for name, r in b1.items() for d in (64, 80, 128)
          if f"ILi{d}E" in name}
    emit({"phase": "ptxas", "kernel": "flash_fwd_wg_kernel<D>",
          "design": "wgmma, TMA, warp-specialised", "by_dim": b1})
    if len(b1) != 3 or any(b1[f"D={d}"].get("spill_stores", 1) or
                           b1[f"D={d}"].get("spill_loads", 1)
                           for d in (64, 80)):
        raise RuntimeError(f"ptxas: the Hopper B1 spills at D = 64 or 80, "
                           f"or is missing: {b1}")
    emit({"phase": "sass", "library": str(_build.library_path(
        "flash_attention").name), "must_hold": list(HOPPER_SASS),
        "kernels": sass_check(_build)})
    emit({"phase": "ptxas", "kernel": "B1-B3 at D = 80 (ViT-H/14)",
          "instantiations": {
              demangle(n): r for n, r in ptxas_summary(
                  logs.get("flash_attention", ""), "Li80E").items()}})
    decode = ptxas_summary(logs.get("flash_decode", ""), "flash_decode")
    emit({"phase": "ptxas",
          "kernel": "flash_decode_kernel / flash_decode_paged_kernel<TQ, "
                    "TKV, windowed, quant, heads> (any D)",
          "design": "one launch, cluster merge, cp.async.bulk.tensor on "
                    "mbarriers",
          "instantiations": {demangle(n): r for n, r in decode.items()}})
    # the bf16 and f32 forms: template argument quant false (mangled
    # ``Lb<windowed>ELb0ELi<heads>EE``)
    plain = {demangle(n): r for n, r in decode.items()
             if re.search(r"Lb[01]ELb0ELi[014]EE", n)}
    if len(decode) != DECODE_KERNELS or len(plain) != DECODE_KERNELS // 3 \
            or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                   for r in plain.values()):
        raise RuntimeError(f"ptxas: {len(decode)} B4/B5 kernels, or a bf16 "
                           f"/ f32 form spills: {plain}")
    emit({"phase": "sass", "library": str(_build.library_path(
        "flash_decode").name), "must_hold": list(DECODE_SASS),
        "kernels": decode_sass_check(_build)})


def run_phases(torch, _build) -> int:
    """Every phase, then the ``kernels`` line and the last line."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    card = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card.splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    bw, peaks = card_rates(name)
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "hbm_bytes_per_s": bw})

    build_phase(_build)

    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    cardname = card.splitlines()[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    dense_row = timed("kernel", kernel_phase, torch, bw, peaks, flush)
    paged_row = timed("paged_kernel", paged_kernel_phase, torch, bw, peaks,
                      flush)
    attn_rows = timed("attention_kernel", attention_kernel_phase, torch, bw,
                      peaks, flush)
    del flush
    dense_launches, dense_run = timed("serve", serve_phase, torch)
    paged_launches, paged_run = timed("paged_serve", paged_serve_phase,
                                      torch)
    timed("prewarm", prewarm_phase, torch, cardname, dense_run, paged_run)
    del dense_run, paged_run
    timed("parity", parity_phase, torch)
    attn_launches = timed("train", train_phase, torch)
    timed("train_step", train_step_phase, torch, peaks)
    timed("train_parity", train_parity_phase, torch)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timed("rounding_audit", rounding_audit_phase, torch, flush)
    adam_row = timed("fused_adam", fused_adam_phase, torch, bw, flush)
    del flush
    adam_launches = timed("zero1_train", zero1_train_phase, torch, peaks)
    timed("zero1_cli", zero1_cli_phase, torch)
    timed("zero1_parity", zero1_parity_phase, torch)
    timed("vision_parity", vision_parity_phase, torch)
    timed("vision_train_step", vision_train_step_phase, torch, peaks,
          cardname)
    timed("vision_cli", vision_cli_phase, torch)
    timed("device_loop", device_loop_phase, torch, peaks, cardname)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    vit_rows = timed("vit_kernel", vit_kernel_phase, torch, bw, peaks, flush)
    del flush
    vit_launches = timed("vit_train_step", vit_train_step_phase, torch,
                         peaks, cardname)
    timed("convnext_train_step", convnext_train_step_phase, torch, peaks,
          cardname)
    timed("vit_cli", vit_cli_phase, torch)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    vith_rows = timed("vith_kernel", vith_kernel_phase, torch, bw, peaks,
                      flush)
    del flush
    vith_launches = timed("vith_train_step", vith_train_step_phase, torch,
                          peaks, cardname)
    checkpoint = timed("resume", resume_phase, torch, cardname)
    timed("vision_serve", vision_serve_phase, torch, cardname, checkpoint)
    timed("guard", guard_phase, torch, cardname)
    timed("guard_cost", guard_cost_phase, torch, cardname)
    timed("observe", observe_phase, torch, cardname)
    kept = {}
    sharded = timed("sharded_train", sharded_train_phase, torch, cardname,
                    kept)
    sharded["vit_l16_tp"] = timed("sharded_vit", sharded_vit_phase, torch,
                                  cardname)
    timed("fsdp_resnet", fsdp_resnet_phase, torch, cardname)
    sharded["cli_lm_small_fsdp"] = timed("sharded_cli", sharded_cli_phase,
                                         torch)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ctx_row = timed("context_kernel", context_kernel_phase, torch, bw, peaks,
                    flush, cardname)
    del flush
    sp_ep = timed("sp_train", sp_train_phase, torch, cardname,
                  kept["dp_flash"])
    sp_ep.update(timed("ep_train", ep_train_phase, torch, cardname))
    timed("sp_ep_cli", sp_ep_cli_phase, torch)
    pp = timed("pp_train", pp_train_phase, torch, cardname,
               kept.pop("dp_flash"), kept)
    pp["cli_gpipe_s1_m2"] = timed("pp_cli", pp_cli_phase, torch)
    slice16 = {"multihost_cli_lm_small": timed(
        "multihost_cli", multihost_cli_phase, torch, cardname)}
    slice16["vit_ring_vit_l16"] = timed("vit_ring", vit_ring_phase, torch,
                                        cardname)
    timed("fsdp_schedule", fsdp_schedule_phase, torch, cardname)
    # the scheduled fsdp step's launches are sharded_train's fsdp row's
    slice16["fsdp_schedule_lm_small"] = sharded["lm_small_fsdp"]
    timed("steady_strict", steady_strict_phase, torch, cardname)
    timed("supervise", supervise_phase, torch, cardname)
    generate_b4 = timed("generate", generate_phase, torch, cardname)
    router_b4 = timed("router", router_phase, torch, cardname)
    timed("router_cli", router_cli_phase, torch, cardname)
    slice18 = {"planned_1f1b_s2_m4": timed("pricing", pricing_phase, torch,
                                           cardname, kept)}
    slice18["cli_layout_auto_lm_small"] = timed(
        "pricing_cli", pricing_cli_phase, torch, cardname)
    emit({"phase": "phase_seconds", "seconds": seconds,
          "total": sum(seconds.values())})

    def kernel_entry(name, source, replaces, via, launches, row):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "via": via, "launches": launches,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}
        if "design" in row:
            entry["design"] = row["design"]
        return entry

    def vit_entry(row, launches, shape):
        """The kernel on a ViT path: launches in one train step, its row
        at that step's attention shape (bf16, non-causal)."""
        return {"shape": shape, "launches_per_step": launches,
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}

    def ctx_entry(row):
        """B1-B3 through ``flash_attention_lse`` in the ring's hops (the
        context_kernel phase): launches of each over its 4 x 4 hops,
        forward and backward, and the ring's device ms against one
        whole-sequence flash call."""
        return {"shape": row["shape"], "shards": row["shards"],
                "launches": row["launches_b1_b2_b3"][0],
                "hops_with_nonzero_lse_cotangent":
                    row["hops_with_nonzero_lse_cotangent"],
                "fwd_max_abs_err": row["fwd_max_abs_err_vs_whole_sequence"],
                "ring_fwd_bwd_ms": row["ring_fwd_bwd_event_ms"],
                "whole_sequence_fwd_bwd_ms":
                    row["whole_sequence_flash_fwd_bwd_event_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}

    emit({"kernels": [
        dict(kernel_entry("flash_decode", KERNEL_SOURCE, KERNEL_REPLACES,
                          DENSE_VIA, dense_launches, dense_row),
             generate_gpt2_small_launches_per_step=generate_b4,
             router_lm_small_launches=router_b4),
        kernel_entry("flash_decode_paged", KERNEL_SOURCE, KERNEL_REPLACES,
                     PAGED_VIA, paged_launches, paged_row),
        *(dict(kernel_entry(name, ATTN_SOURCE, replaces, via, n, row),
               vit=vit_entry(vrow, vn, [VIT_B, VIT_T, VIT_T, VIT_HEADS,
                                        VIT_HEADS, D]),
               vit_h14=vit_entry(hrow, hn, [VITH_B, VITH_T, VITH_T,
                                            VITH_HEADS, VITH_HEADS,
                                            VITH_D]),
               sharded_launches_per_step={
                   path: per[i] for path, per in sharded.items()},
               sp_ep_launches_per_step={
                   path: per[i] for path, per in sp_ep.items()},
               pp_launches_per_step={
                   path: per[i] for path, per in pp.items()},
               slice16_launches_per_step={
                   path: per[i] for path, per in slice16.items()},
               slice18_launches_per_step={
                   path: per[i] for path, per in slice18.items()},
               context_ring=ctx_entry(ctx_row))
          for i, ((name, replaces, via), n, row, vrow, vn, hrow, hn)
          in enumerate(zip(
              ATTN_KERNELS, attn_launches,
              (attn_rows["fwd"], attn_rows["dq"], attn_rows["dkv"]),
              (vit_rows["fwd"], vit_rows["dq"], vit_rows["dkv"]),
              vit_launches,
              (vith_rows["fwd"], vith_rows["dq"], vith_rows["dkv"]),
              vith_launches))),
        kernel_entry("fused_adam", ADAM_SOURCE, ADAM_REPLACES, ADAM_VIA,
                     adam_launches, adam_row)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
