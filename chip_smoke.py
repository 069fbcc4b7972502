#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``fluxdistributed_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, for the ``sm_90a`` kernels) and ``nvcc``.
Phases, each of which raises on failure (exit code != 0, no result):

1. the card: ``nvidia-smi`` name and power limit, and PyTorch's name;
2. build: every kernel source of the package, compiled by ``nvcc``;
3. kernel: the flash-decode kernel against its plain PyTorch version at
   lm_small decode shapes (8 slots, 1024 rows, 12 heads, head dim 64),
   with its time, the plain version's, a library yardstick
   (``scaled_dot_product_attention`` over the dequantised cache) and the
   card's bound (live K/V bytes over the HBM rate), per variant;
4. serve: random-init lm_small (bf16, vocab 32000) behind the port's
   HTTP server, 8 concurrent ``/v1/generate`` requests (prompts of
   64–768 tokens, 64 new tokens, greedy), with the kernel's launch count
   checked against depth × decode steps;
5. parity: f32 lm_small greedy tokens from the card's engine (kernel)
   equal the port's ``generate`` on the CPU (plain version);
6. a ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# HBM rate (bytes/s) and dense peak (ops/s) by card; NVIDIA data sheets
_CARDS = (  # (name fragment, HBM B/s, f32 FLOP/s, bf16 FLOP/s, 8-bit OP/s)
    ("H200", 4.8e12, 67e12, 989e12, 1979e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12, 1671e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12),
    ("H100", 3.35e12, 67e12, 989e12, 1979e12),  # SXM ("H100 80GB HBM3")
)

B, R, H, D = 8, 1024, 12, 64  # lm_small decode: 8 slots x 1024 rows
KERNEL_SOURCE = "fluxdistributed_tpu_torch/ops/csrc/flash_decode.cu"
KERNEL_REPLACES = "fluxdistributed_tpu/ops/pallas_decode.py:168"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    for frag, bw, f32, bf16, i8 in _CARDS:
        if frag in name:
            return bw, {"f32": f32, "bf16": bf16, "8bit": i8}
    raise RuntimeError(f"no memory rate known for {name!r}; add it to _CARDS")


def time_ms(torch, fn, flush, iters=30):
    """Mean device ms of ``fn`` with a cold L2: a 256 MB memset runs
    before each timed call, as the other layers' caches would."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def ring_state(torch, cursors, rows, sinks):
    sp = torch.full((len(cursors), rows), -1, dtype=torch.int32)
    ring = rows - sinks
    for b, cur in enumerate(cursors):
        for p in list(range(min(sinks, cur + 1))) + list(
                range(max(sinks, cur - ring + 1), cur + 1)):
            sp[b, p if p < sinks else sinks + (p - sinks) % ring] = p
    return sp


def kernel_phase(torch, bw, peaks, flush):
    """Every variant of the decode kernel against its plain version;
    returns the bf16 dense (main-path) row."""
    import torch.nn.functional as F

    from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv
    from fluxdistributed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference)

    dev = torch.device("cuda")
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
        out = flash_decode(q, k, v, idx, **kw)
        torch.cuda.synchronize()
        ref = flash_decode_reference(q, k, v, idx, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise RuntimeError(f"kernel {variant}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        # library yardstick: one SDPA call over the dequantised cache
        # (GQA expanded, boolean mask) prepared outside the timing
        if "k_scale" in kw:
            kd = (k.float() * kw["k_scale"][..., None]).to(dt)
            vd = (v.float() * kw["v_scale"][..., None]).to(dt)
        else:
            kd, vd = k, v
        rep = H // hkv
        kh = kd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        vh = vd.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        qh = q.transpose(1, 2).contiguous()
        mask = allow.to(dev)[:, None, None, :]
        lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: flash_decode(q, k, v, idx, **kw), flush)
        plain_ms = time_ms(
            torch, lambda: flash_decode_reference(q, k, v, idx, **kw), flush,
            iters=10)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), flush)
        # least work: live K/V rows (+ scales) read once, q read, out
        # written, cursors (+ the ring's slot_pos) read
        live = int(allow.sum())
        row = hkv * D * k.element_size() * 2
        if "k_scale" in kw:
            row += hkv * 4 * 2
        nbytes = (live * row + 2 * q.numel() * q.element_size() + 4 * B
                  + (4 * B * r if variant == "window" else 0))
        ops = 4 * live * (H // hkv) * hkv * D
        t_bytes, t_ops = nbytes / bw * 1e3, ops / peaks[bits] * 1e3
        rows[variant] = {
            "phase": "kernel", "variant": variant,
            "shape": [B, r, H, hkv, D], "q_dtype": str(dt).split(".")[-1],
            "kv_dtype": str(k.dtype).split(".")[-1], "live_rows": live,
            "max_abs_err": err, "tol": tol, "library_max_abs_err": lib_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
        }
        emit(rows[variant])
        if not err <= tol:
            raise RuntimeError(f"kernel {variant}: max |kernel - plain| = "
                               f"{err} > {tol}")
    return rows["bf16"]


def post(url, body, timeout=600):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def serve_phase(torch):
    """lm_small behind the HTTP server; returns the kernel launches of
    the 8-request run."""
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
        post(base + "/v1/generate", {"prompt_tokens": [1, 2, 3],
                                     "max_tokens": 4})  # warm-up
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
        })
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        th.join(timeout=30)
    profile_decode(torch, engine, prompts)
    return launches


def profile_decode(torch, engine, prompts, steps=10):
    """Where a steady all-slot decode step's time goes: host wall per
    step, device busy time per step (torch.profiler), and the largest
    device kernels."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    emit({"phase": "profile", "what": "all-slot decode step, 8 live slots",
          "steps": steps, "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms if dev else None,
          "device_idle_share": 1 - busy_ms / wall_ms if dev else None,
          "device_kernels_per_step": None if not dev else sum(
              r.count for r in prof.key_averages()
              if r.device_type == torch.autograd.DeviceType.CUDA) / steps,
          "top_device_ms_per_step": [[k[:60], v / steps / 1e3]
                                     for k, v in top]})
    for s in range(len(prompts)):
        engine.reset_slot(s)


def parity_phase(torch):
    """f32 lm_small: the card's engine (kernel) vs CPU generate (plain)."""
    from fluxdistributed_tpu_torch.models import generate, lm_small
    from fluxdistributed_tpu_torch.serve import LMEngine, Request, Scheduler

    kw = dict(vocab=32000, dtype=torch.float32, seed=2)
    gpu, cpu = lm_small(device="cuda", **kw), lm_small(device="cpu", **kw)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
               for n in (40, 57)]
    engine = LMEngine(gpu, max_slots=2, max_len=128, buckets=(64,))
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    Scheduler(engine).generate_all(reqs)
    same = []
    for r, p in zip(reqs, prompts):
        ref = generate(cpu, [p], len(p) + 32)[0].tolist()
        if r.tokens != ref:
            at = next(i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b)
            with torch.no_grad():
                lg = cpu(torch.tensor([ref[:at]]))[0, -1]
            top = torch.topk(lg, 2).values.tolist()
            raise RuntimeError(
                f"parity: card tokens differ from the CPU at position {at} "
                f"(card {r.tokens[at]}, cpu {ref[at]}; cpu top-2 logit gap "
                f"{top[0] - top[1]:.3g})")
        same.append(len(ref) - len(p))
    emit({"phase": "parity", "model": "lm_small", "dtype": "float32",
          "prompts": [len(p) for p in prompts], "new_tokens": 32,
          "tokens_equal": same})


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

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(logs)})
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main_row = kernel_phase(torch, bw, peaks, flush)
    del flush
    launches = serve_phase(torch)
    parity_phase(torch)

    emit({"kernels": [{
        "name": "flash_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
