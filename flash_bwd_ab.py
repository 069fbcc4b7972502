#!/usr/bin/env python3
"""B2 and B3 (the flash attention backward kernels) of several builds of
``csrc/flash_attention.cu`` side by side on one card.

    python3 flash_bwd_ab.py [--parent DIR] [--variant NAME=FILE.cu ...]
                            [--shapes vith,vith_class_token,lm,d128,vith_step]
                            [--rounds 2] [--out FILE.jsonl]

Builds the checkout's source (``change``), the same file of another
checkout (``--parent DIR``, e.g. an unpacked ``git archive`` of the parent
commit) and any variant sources, each with the package's ``nvcc`` flags,
all at once.  Prints each build's ``ptxas`` registers and spills for the
B2/B3 kernels and the kernels whose ``wgmma`` ptxas serialised.  Then,
for each shape, each library in turn (swapped under the wrappers of
``ops.flash_attention``): B2 and B3 held element by element to their
plain versions (``chip_smoke.grad_check``), the bf16 rounding audit's
counts, and the kernels' device times (``chip_smoke.time_stats``: cold
L2, 30 calls); the libraries are timed in rounds, in the order parent,
change, variants, then reversed, so that drift shows.  cuDNN's fused
backward (``scaled_dot_product_attention``, the fastest backend) is timed
at each synthetic shape too.  ``vith_step`` takes the inputs of B2 and
B3 from the third bf16 train step of ViT-H/14 (batch 32, 257 tokens, as
chip_smoke's ``vith_train_step``): five of its 32 layers, first to
last, where training data flag far more pairs for a re-sum than randn
inputs.  One JSON object a line on stdout (and in ``--out``).  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

# name: (B, T, H, Hkv, D, causal, window, sinks, fused q/k/v views)
SHAPES = {
    "vith": (32, 256, 16, 16, 80, False, None, 0, True),
    "vith_class_token": (32, 257, 16, 16, 80, False, None, 0, True),
    "vith_causal_window_gqa": (8, 257, 16, 4, 80, True, 100, 4, False),
    "lm": (8, 1024, 12, 12, 64, True, None, 0, False),
    "d128": (8, 1024, 6, 6, 128, True, None, 0, False),
}


def emit(out, obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def build(_build, sources: dict, work: Path) -> dict:
    """``{name: (library path or None, nvcc log)}``: one ``nvcc`` a
    source, all started at once."""
    procs = {}
    for name, src in sources.items():
        lib = work / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        done[name] = (lib if proc.returncode == 0 else None, log)
    return done


def use(fa, _build, path):
    """Make ``path`` the library the wrappers launch (typed as the
    package types its own)."""
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))
    try:
        fa._lib = None
        return fa._kernel()
    finally:
        _build.load = load


def inputs(torch, shape, seed):
    b, t, h, hkv, d, causal, window, sinks, fused = shape
    g = torch.Generator().manual_seed(seed)
    if fused:
        q, k, v = torch.randn(b, t, 3, h, d, generator=g).bfloat16().cuda(
        ).unbind(2)
    else:
        q = torch.randn(b, t, h, d, generator=g).bfloat16().cuda()
        k, v = (torch.randn(b, t, hkv, d, generator=g).bfloat16().cuda()
                for _ in range(2))
    do = torch.randn(b, t, h, d, generator=g).bfloat16().cuda()
    return q, k, v, do, dict(causal=causal, window=window, sinks=sinks)


def step_inputs(torch, fa, layers=(0, 8, 15, 23, 31)):
    """``{layer: (B2/B3 args, kwargs)}``: what ``_backward`` hands B2 and
    B3 in the third bf16 train step of ViT-H/14 (f32 params, adamw,
    batch 32 at 224², weights and images from seeds) at ``layers``
    (counted from the first block)."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import vit_h14
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    model = vit_h14(num_classes=1000, dtype=torch.float32, seed=3,
                    attn_fn=partial(flash_attention, causal=False))
    model.dtype = torch.bfloat16
    opt = optim.adamw()
    state = TrainState.create({k: p.detach().clone()
                               for k, p in model.named_parameters()}, opt)
    step = make_train_step(module_loss_fn(model, logitcrossentropy), opt,
                           seed=0)
    batch = cs.image_batch(torch, cs.VITH_B, cs.VISION_SIZE, 1000,
                           torch.bfloat16, "cuda", 21)
    for _ in range(2):
        state, _ = step(state, batch)
    seen, backward = [], fa._backward

    def capture(q, k, v, o, lse, g, g_lse, cfg):
        delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
        q_, k_, v_, g_ = fa._readable("dq", q, k, v, g)
        seen.append(((q_, k_, v_, g_, lse, delta.contiguous()),
                     {n: cfg[n] for n in ("causal", "window", "sinks")}))
        return backward(q, k, v, o, lse, g, g_lse, cfg)

    fa._backward = capture
    try:
        state, _ = step(state, batch)
    finally:
        fa._backward = backward
    torch.cuda.synchronize()
    seen.reverse()  # autograd runs the last block's backward first
    out = {n: seen[n] for n in layers}
    del model, state, step, seen
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout's root")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FILE.cu, a variant source")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    from fluxdistributed_tpu_torch.ops import _build

    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        out = open(args.out, "w")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit(out, {"card": card, "torch": torch.__version__,
               "cuda": torch.version.cuda})
    sources = {"change": _build.SOURCES["flash_attention"]}
    if args.parent:
        sources["parent"] = (Path(args.parent) / "fluxdistributed_tpu_torch"
                             / "ops" / "csrc" / "flash_attention.cu")
    for spec in args.variant:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
    work = Path(tempfile.mkdtemp(prefix="flash_bwd_ab-"))
    t0 = time.perf_counter()
    libs = build(_build, sources, work)
    emit(out, {"build_seconds": time.perf_counter() - t0})
    for name, (lib, log) in libs.items():
        regs = {cs.demangle(n): r for frag in ("flash_bwd_dq_wg",
                                               "flash_bwd_dkv_wg",
                                               "flash_bwd_dq_tc",
                                               "flash_bwd_dkv_tc")
                for n, r in cs.ptxas_summary(log, frag).items()}
        emit(out, {"library": name, "built": lib is not None,
                   "ptxas": regs,
                   "wgmma_serialised": cs.serialised_wgmma(log),
                   "errors": None if lib else log[-4000:]})
    names = [n for n in ("parent", "change", *sorted(
        set(sources) - {"parent", "change"}))
        if n in libs and libs[n][0] is not None]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cases = []  # (name, B2/B3 args, kwargs, shape, library yardstick)
    for sname in args.shapes.split(","):
        if sname == "vith_step":
            use(fa, _build, libs["change"][0])
            for layer, (bargs, kw) in step_inputs(torch, fa).items():
                cases.append((f"vith_step_layer{layer}", bargs, kw,
                              SHAPES["vith_class_token"], False))
            continue
        shape = SHAPES[sname]
        q, k, v, do, kw = inputs(torch, shape, seed=22)
        out_ref, lse = fa.flash_attention_fwd_reference(
            q, k, v, block_q=512, block_k=512, **kw)
        delta = (do.float() * out_ref.float()).sum(-1).permute(
            0, 2, 1).contiguous()
        cases.append((sname, (q, k, v, do, lse, delta), kw, shape, True))
    for sname, bargs, kw, shape, yardstick in cases:
        q, k, v, do = bargs[:4]
        rkw = dict(kw, block_q=512, block_k=512)
        rdq = fa.flash_attention_dq_reference(*bargs, **rkw)
        rdk, rdv = fa.flash_attention_dkv_reference(*bargs, **rkw)
        b, t, h, hkv, d = shape[:5]
        allow = cs.live_pairs(torch, t, t, *shape[5:8])
        pairs = int(allow.sum()) * b * h
        io = b * t * h * d * 2
        kv = b * t * hkv * d * 2
        row_io = b * h * t * 4
        bound = {  # ms: the larger of least bytes and least operations
            "dq": max(6 * pairs * d / 989e12,
                      (3 * io + 2 * kv + 2 * row_io) / 3.35e12) * 1e3,
            "dkv": max(8 * pairs * d / 989e12,
                       (2 * io + 4 * kv + 2 * row_io) / 3.35e12) * 1e3}
        checks = {}
        for name in names:
            lib = use(fa, _build, libs[name][0])
            dq = fa.flash_attention_dq(*bargs, **kw)
            dk, dv = fa.flash_attention_dkv(*bargs, **kw)
            audit = fa.rounding_audit(*bargs, **kw)
            torch.cuda.synchronize()
            checks[name] = {
                "design": {kn: fa.DESIGNS[lib.flash_attention_design(
                    w, 1, d)] for w, kn in ((1, "dq"), (2, "dkv"))},
                "excess": {n: cs.grad_check(torch, got, ref, "bf16")[
                    "excess"] for n, got, ref in (
                        ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))},
                "audit": audit}
        times = {n: {"dq": [], "dkv": []} for n in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                use(fa, _build, libs[name][0])
                times[name]["dq"].append(cs.time_stats(
                    torch, lambda: fa.flash_attention_dq(*bargs, **kw),
                    flush)["median"])
                times[name]["dkv"].append(cs.time_stats(
                    torch, lambda: fa.flash_attention_dkv(*bargs, **kw),
                    flush)["median"])
        sdpa = {}
        for backend, (_, bwd) in (cs.sdpa_train(
                torch, q, k, v, do, allow,
                kw["causal"] and kw["window"] is None).items()
                if yardstick else ()):
            sdpa[backend] = cs.time_stats(torch, bwd, flush)["median"]
        emit(out, {"shape": sname, "dims": list(shape), "card": card,
                   "bound_ms": bound, "checks": checks,
                   "median_ms_by_round": times,
                   "sdpa_bwd_median_ms": sdpa})
        bad = [n for n, c in checks.items()
               if any(x > 1.0 for x in c["excess"].values())
               or any(a["unflagged_differ"] for a in c["audit"].values())]
        if bad:
            emit(out, {"shape": sname, "failed": bad})
    fa._lib = None
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
