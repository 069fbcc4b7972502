#!/usr/bin/env python3
"""B4 and B5 (the flash-decode kernels) of several builds of
``csrc/flash_decode.cu`` side by side on one card.

    python3 flash_decode_ab.py [--parent DIR] [--variant NAME=FILE.cu ...]
                               [--variants lastcta] [--step]
                               [--shapes bf16,paged_bf16,...] [--rounds 2]
                               [--warm] [--out FILE.jsonl]

Builds the checkout's source (``change``), the same file of another
checkout (``--parent DIR``, e.g. an unpacked ``git archive`` of the parent
commit), any variant sources (with the change's C interface) and the
named built-in variants, each with the package's ``nvcc`` flags, all at
once, and prints each build's ``ptxas`` registers and spills for its
decode kernels.  The one built-in variant, ``lastcta``, is the change's
source edited (:data:`VARIANTS`) to merge the split partials in the last
CTA to finish a (slot, KV head), through a global workspace and an
arrival counter that the merger resets, with no cluster.  ``--warm``
adds a second timing of each build with a warm L2.
Each library is called through its own C entry point: a build with
``flash_decode_cuda_launches`` takes its split count and no workspace
(one launch), an older one (the parent's split kernel and combine) a
workspace of B * H * splits * (D + 2) f32 and its own, uncapped split
count.  Then, for each shape, each library's output is held to the plain
version (``ops.flash_decode``'s reference, bf16 2e-2 and f32 1e-4 abs),
and its device time taken (``chip_smoke.time_stats``: cold L2, 30
calls) in rounds, in the order parent, change, variants, then reversed,
so that drift shows, and the host microseconds a call takes to enqueue
(200 calls back to back).  The shapes are chip_smoke's kernel shapes
(lm_small decode: 8 slots of 1024 rows, 12 heads of 64, cursors 64-832
from seed 0): the dense variants bf16, f32, gqa (4 KV heads), window
(260-row ring, window 256, 4 sinks), int8 and fp8; the paged ones over a
512-block pool of 16-row pages; and ``b1`` / ``paged_b1``, one slot of
4096 rows (cursor 4000) whose split count the cluster cap bounds.  The
bf16 shapes also time ``scaled_dot_product_attention`` over the dense
(gathered) cache.  ``--step`` profiles lm_small's graphed decode step
(dense and paged, 8 live slots, the serve phase's prompts) on fresh
engines with the parent's kernels (through stand-ins for the package's
launchers) and the change's, in turns: device ms a step of the decode
kernels and of the whole step.  One JSON object a line on stdout (and
in ``--out``).  Needs a CUDA card and ``nvcc``.

Run it from the repository's root on a machine with the card, the
parent's source unpacked into a git-ignored directory::

    git archive <parent> fluxdistributed_tpu_torch/ops/csrc/flash_decode.cu \
        | tar -x -C _archive/parent
    python3 flash_decode_ab.py --parent _archive/parent --variants lastcta \
        --step --out ab.jsonl
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

B, R, H, D = cs.B, cs.R, cs.H, cs.D
BS, NB = cs.BS, cs.NB
DENSE = ("bf16", "f32", "gqa", "window", "int8", "fp8", "b1")
SHAPES = DENSE + tuple(f"paged_{v}" for v in DENSE)
_QC = {"float32": 0, "bfloat16": 1}
_KVC = {"float32": 0, "bfloat16": 1, "int8": 2, "float8_e4m3fn": 3}


def emit(out, obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


_LAST = """  float* gp = g_part + (static_cast<size_t>(blockIdx.x) * S + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Mw[w * G + g]);
    float acc = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(Mw[w * G + g] - m);
      acc = fmaf(Acc[(w * G + g) * D + d], c, acc);
      l = fmaf(Lw[w * G + g], c, l);
    }
    gp[g * (D + 2) + 2 + d] = acc;
    if (d == 0) {
      gp[g * (D + 2)] = m;
      gp[g * (D + 2) + 1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  int* flag = reinterpret_cast<int*>(smem + L.recv);
  if (tid == 0) *flag = atomicAdd(&g_arrive[blockIdx.x], 1u) == static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* base = g_part + static_cast<size_t>(blockIdx.x) * S * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
    for (int s = 0; s < S; ++s) m = fmaxf(m, __ldcg(base + (s * G + g) * (D + 2)));
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = base + (s * G + g) * (D + 2);
      const float w = expf(__fsub_rn(__ldcg(ps), m));
      l = __fadd_rn(l, __fmul_rn(__ldcg(ps + 1), w));
      acc = __fadd_rn(acc, __fmul_rn(__ldcg(ps + 2 + d), w));
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G + g) * D + d] =
        from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
  }
  if (tid == 0) g_arrive[blockIdx.x] = 0u;
}
"""


def _sub(text, old, new, count=1):
    if text.count(old) != count:
        raise ValueError(f"variant: {old[:60]!r} found {text.count(old)} "
                         f"times, not {count}")
    return text.replace(old, new)


def _lastcta(text):
    """The split partials merged by the last CTA to finish a (slot, KV
    head): each CTA writes its partial to a global workspace and counts
    itself on a global arrival counter, which the merger resets (no
    cluster)."""
    a = text.index("  cluster_wait();   // every peer has initialised")
    b = text.index("// ------------------------------------------------------- "
                   "the dense form")
    text = text[:a] + _LAST + "\n" + text[b:]
    text = _sub(text, "template <typename TQ>\n__device__ __forceinline__ "
                "void merge_and_write(",
                "__device__ float g_part[1 << 22];\n__device__ unsigned "
                "g_arrive[1 << 16];\n\ntemplate <typename TQ>\n__device__ "
                "__forceinline__ void merge_and_write(")
    return _sub(text, "cfg.numAttrs = 1;", "cfg.numAttrs = 0;")


#: the built-in variants: the change's source edited
VARIANTS = {"lastcta": _lastcta}


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


class Lib:
    """One build's two entry points, typed by the interface it has."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        self.one_launch = hasattr(self.lib, "flash_decode_cuda_launches")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci, vp] if self.one_launch else [ci, vp, vp]
        self.lib.flash_decode_launch.argtypes = (
            [ci] * 3 + [vp] * 8 + [ci] * 7 + [cf] + tail)
        self.lib.flash_decode_paged_launch.argtypes = (
            [ci] * 3 + [vp] * 9 + [ci] * 9 + [cf, ci, ci]
            + ([vp] if self.one_launch else [vp, vp]))
        self.lib.flash_decode_launch.restype = ci
        self.lib.flash_decode_paged_launch.restype = ci

    def plan(self, fd, case, sms):
        """``(splits, pages a split)`` of this build for ``case``: a
        one-launch build takes the package's plan, an older one its
        uncapped split count."""
        q, k = case["q"], case["k"]
        b, hkv = q.shape[0], k.shape[2]
        if self.one_launch:
            if case["paged"]:
                return fd.paged_kernel_plan(q, k, case["pt"])
            return fd.kernel_plan(q, k), 0
        if case["paged"]:
            pages = case["pt"].shape[1]
            return fd.split_pages(pages, fd.paged_splits(
                b, hkv, pages, sms, cap=1 << 30))
        return fd.decode_splits(b, hkv, k.shape[1], sms, D, cap=1 << 30), 0

    def call(self, torch, fd, case, sms):
        """A closure launching this build on ``case``; its output tensor
        is ``case['out']``."""
        q, k, v, idx = case["q"], case["k"], case["v"], case["idx"]
        kw = case["kw"]
        b, _, h, d = q.shape
        hkv = k.shape[2]
        splits, per = self.plan(fd, case, sms)
        out = torch.empty_like(q)
        case["out"] = out
        p = ctypes.c_void_p

        def ptr(t):
            return None if t is None else p(t.data_ptr())

        codes = (_QC[str(q.dtype).split(".")[-1]],
                 _KVC[str(k.dtype).split(".")[-1]],
                 int(kw.get("window") is not None))
        common = (ptr(kw.get("slot_pos")), ptr(kw.get("k_scale")),
                  ptr(kw.get("v_scale")), ptr(out))
        win = (int(kw.get("window") or 0), int(kw.get("sinks", 0)),
               1.0 / math.sqrt(d))
        work = None
        if not self.one_launch:
            work = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                               device=q.device)
        lib = self.lib

        def run():
            stream = p(torch.cuda.current_stream().cuda_stream)
            tail = (stream,) if work is None else (ptr(work), stream)
            if case["paged"]:
                nb, bs = k.shape[:2]
                err = lib.flash_decode_paged_launch(
                    *codes, ptr(q), ptr(k), ptr(v), ptr(case["pt"]), ptr(idx),
                    *common, b, case["pt"].shape[1], bs, nb, h, hkv, d, *win,
                    splits, per, *tail)
            else:
                err = lib.flash_decode_launch(
                    *codes, ptr(q), ptr(k), ptr(v), ptr(idx), *common, b,
                    k.shape[1], h, hkv, d, *win, splits, *tail)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out

        return run, splits


def engine_launchers(torch, fd, impl, sms):
    """``(dense, paged)`` stand-ins for the package's ``_launch`` /
    ``_launch_paged`` that run ``impl`` (a :class:`Lib`) on the
    wrappers' arguments, counting as the package's launches count."""
    def dense(q, k, v, idx, slot_pos, window, sinks, k_scale, v_scale,
              splits=None):
        kw = {n: x for n, x in (("slot_pos", slot_pos), ("window", window),
                                ("k_scale", k_scale), ("v_scale", v_scale))
              if x is not None}
        case = {"q": q, "k": k, "v": v, "idx": idx, "paged": False,
                "kw": dict(kw, sinks=sinks)}
        out = impl.call(torch, fd, case, sms)[0]()
        fd.count(fd.flash_decode)
        return out

    def paged(q, k, v, pt, idx, slot_pos, window, sinks, k_scale, v_scale,
              splits=None):
        kw = {n: x for n, x in (("slot_pos", slot_pos), ("window", window),
                                ("k_scale", k_scale), ("v_scale", v_scale))
              if x is not None}
        case = {"q": q, "k": k, "v": v, "idx": idx, "pt": pt, "paged": True,
                "kw": dict(kw, sinks=sinks)}
        out = impl.call(torch, fd, case, sms)[0]()
        fd.count(fd.flash_decode_paged)
        return out

    return dense, paged


def step_profile(torch, model, layout, prompts, steps=10):
    """lm_small's graphed all-slot decode step (8 live slots, the serve
    phase's prompts) on a fresh engine: ``{"busy_ms", "decode_ms",
    "decode_kernels"}`` a step from ``torch.profiler`` (device time;
    the decode kernels by name with their launches a step)."""
    from torch.profiler import ProfilerActivity, profile

    from fluxdistributed_tpu_torch.serve import LMEngine

    engine = LMEngine(model, max_slots=8, max_len=1024, layout=layout)
    for s, p in enumerate(prompts):
        engine.prefill(s, p, 0.0, None)
    for _ in range(3):  # the eager step, the capture, a replay
        engine.step_decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step_decode()
        torch.cuda.synchronize()
    busy, dec, kinds = 0.0, 0.0, {}
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(row, "self_device_time_total",
                     getattr(row, "self_cuda_time_total", 0.0))
        busy += us
        if "flash_decode" in row.key:
            dec += us
            kinds[row.key[:60]] = row.count / steps
    del engine
    return {"busy_ms": busy / steps / 1e3, "decode_ms": dec / steps / 1e3,
            "decode_kernels": kinds}


def dense_case(torch, variant, g, cursors):
    """chip_smoke's kernel shapes (``kernel_phase``) on the card."""
    from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv

    b, r = (1, 4096) if variant == "b1" else (B, R)
    hkv = 4 if variant == "gqa" else H
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    if variant == "window":
        r = 260
        idx = torch.randint(0, R, (b,), generator=g, dtype=torch.int32)
    elif variant == "b1":
        idx = torch.tensor([4000], dtype=torch.int32)
    else:
        idx = cursors
    q = torch.randn(b, 1, H, D, generator=g).to(dt)
    k = torch.randn(b, r, hkv, D, generator=g)
    v = torch.randn(b, r, hkv, D, generator=g)
    kw = {}
    if variant == "window":
        kw = dict(slot_pos=cs.ring_state(torch, idx.tolist(), r, 4),
                  window=256, sinks=4)
        sp, c = kw["slot_pos"].long(), idx.long()[:, None]
        allow = (sp >= 0) & (sp <= c) & ((sp > c - 256) | (sp < 4))
    else:
        allow = torch.arange(r)[None, :] <= idx.long()[:, None]
    if variant in ("int8", "fp8"):
        k, kw["k_scale"] = quantize_kv(k.to(dt), variant)
        v, kw["v_scale"] = quantize_kv(v.to(dt), variant)
    else:
        k, v = k.to(dt), v.to(dt)
    dev = torch.device("cuda")
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    return {"q": q.to(dev), "k": k.to(dev), "v": v.to(dev),
            "idx": idx.to(dev), "kw": kw, "allow": allow, "paged": False}


def paged_case(torch, variant, g, cursors):
    """chip_smoke's paged kernel shapes (``paged_kernel_phase``): a
    512-block pool of 16-row pages scattered by a seeded permutation, an
    unbound page inside slot 3's live range; ``b1``: one slot of 256
    pages (a 4096-row cache) in a 512-block pool, cursor 4000."""
    from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv

    b = 1 if variant == "b1" else B
    hkv = 4 if variant == "gqa" else H
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    windowed = variant == "window"
    pages = -(-260 // BS) if windowed else (256 if variant == "b1"
                                            else R // BS)
    r_pad = pages * BS
    if windowed:
        idx = torch.randint(0, R, (b,), generator=g, dtype=torch.int32)
    elif variant == "b1":
        idx = torch.tensor([4000], dtype=torch.int32)
    else:
        idx = cursors
    q = torch.randn(b, 1, H, D, generator=g).to(dt)
    k = torch.randn(NB, BS, hkv, D, generator=g)
    v = torch.randn(NB, BS, hkv, D, generator=g)
    kw = {}
    if windowed:
        sp = cs.ring_state(torch, idx.tolist(), r_pad, 4)
        kw = dict(slot_pos=sp, window=256, sinks=4)
        spl, c = sp.long(), idx.long()[:, None]
        allow = (spl >= 0) & (spl <= c) & ((spl > c - 256) | (spl < 4))
        used = (sp >= 0).view(b, pages, BS).any(2)
    else:
        allow = torch.arange(r_pad)[None, :] <= idx.long()[:, None]
        used = torch.arange(pages)[None, :] * BS <= idx.long()[:, None]
    pt = torch.randperm(NB, generator=g)[:b * pages].view(b, pages)
    pt = torch.where(used, pt, torch.full_like(pt, -1)).to(torch.int32)
    if b > 3:
        pt[3, 1] = -1
    allow &= (pt >= 0).repeat_interleave(BS, dim=1)
    if variant in ("int8", "fp8"):
        k, kw["k_scale"] = quantize_kv(k.to(dt), variant)
        v, kw["v_scale"] = quantize_kv(v.to(dt), variant)
    else:
        k, v = k.to(dt), v.to(dt)
    dev = torch.device("cuda")
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    return {"q": q.to(dev), "k": k.to(dev), "v": v.to(dev),
            "idx": idx.to(dev), "pt": pt.to(dev), "kw": kw, "allow": allow,
            "paged": True}


def reference(fd, case):
    if case["paged"]:
        return fd.flash_decode_paged_reference(
            case["q"], case["k"], case["v"], case["pt"], case["idx"],
            **case["kw"])
    return fd.flash_decode_reference(case["q"], case["k"], case["v"],
                                     case["idx"], **case["kw"])


def dense_kv(torch, case):
    """The case's K/V laid out densely and dequantised: [B, rows, Hkv,
    D] in q's dtype (the library yardstick's inputs)."""
    k, v, kw = case["k"], case["v"], case["kw"]
    dt = case["q"].dtype
    out = []
    for x, s in ((k, kw.get("k_scale")), (v, kw.get("v_scale"))):
        if case["paged"]:
            blk = case["pt"].long().clamp(min=0)
            take = (lambda y: (y.view(torch.uint8)[blk].view(y.dtype)
                               if y.dtype == torch.float8_e4m3fn else y[blk])
                    .reshape(blk.shape[0], -1, *y.shape[2:]))
            x = take(x)
            s = None if s is None else take(s)
        x = x.float() * s[..., None] if s is not None else x
        out.append(x.to(dt))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout's root")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FILE.cu, a variant source (the change's "
                         "C interface)")
    ap.add_argument("--variants", default="",
                    help="comma-separated built-in variants (VARIANTS)")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--step", action="store_true",
                    help="also profile lm_small's graphed decode step "
                         "(dense and paged) with the parent's and the "
                         "change's kernels")
    ap.add_argument("--warm", action="store_true",
                    help="also time each build with a warm L2 (no flush)")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    from fluxdistributed_tpu_torch.ops import _build

    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
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
    sources = {"change": _build.SOURCES["flash_decode"]}
    if args.parent:
        sources["parent"] = (Path(args.parent) / "fluxdistributed_tpu_torch"
                             / "ops" / "csrc" / "flash_decode.cu")
    for spec in args.variant:
        name, path = spec.split("=", 1)
        sources[name] = Path(path)
    work = Path(tempfile.mkdtemp(prefix="flash_decode_ab-"))
    text = sources["change"].read_text()
    for name in filter(None, args.variants.split(",")):
        path = work / f"{name}.cu"
        path.write_text(VARIANTS[name](text))
        sources[name] = path
    t0 = time.perf_counter()
    libs = build(_build, sources, work)
    emit(out, {"build_seconds": time.perf_counter() - t0})
    for name, (lib, log) in libs.items():
        regs = {cs.demangle(n): r for n, r in cs.ptxas_summary(
            log, "flash_decode").items()}
        emit(out, {"library": name, "built": lib is not None,
                   "ptxas": regs, "errors": None if lib else log[-4000:]})
    if libs["change"][0] is None:
        return 1
    impls = {}
    for name in ("parent", "change", *sorted(
            set(sources) - {"parent", "change"})):
        if name in libs and libs[name][0] is not None:
            impls[name] = Lib(libs[name][0])
    names = list(impls)
    fd._lib = fd.type_library(ctypes.CDLL(str(libs["change"][0])))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bw, _ = cs.card_rates(torch.cuda.get_device_name(0))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    small = torch.empty(16, dtype=torch.uint8, device="cuda")
    cursors = torch.randint(64, 833, (B,), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0))
    failed = []
    for sname in args.shapes.split(","):
        paged = sname.startswith("paged_")
        variant = sname[6:] if paged else sname
        g = torch.Generator().manual_seed(23)
        case = (paged_case if paged else dense_case)(torch, variant, g,
                                                     cursors)
        ref = reference(fd, case)
        torch.cuda.synchronize()
        k = case["k"]
        hkv = k.shape[2]
        quant = "k_scale" in case["kw"]
        live = int(case["allow"].sum())
        nbytes = (live * cs.kernel_row_bytes(hkv, k, quant)
                  + 2 * case["q"].numel() * case["q"].element_size())
        tol = 1e-4 if case["q"].dtype == torch.float32 else 2e-2
        runs, errs, splits = {}, {}, {}
        for name in names:
            runs[name], splits[name] = impls[name].call(torch, fd, case, sms)
            got = runs[name]()
            torch.cuda.synchronize()
            errs[name] = (got.float() - ref.float()).abs().max().item()
            if not errs[name] <= tol:
                failed.append([sname, name, errs[name]])
        times = {n: [] for n in names}
        warm = {n: [] for n in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                times[name].append(cs.time_stats(torch, runs[name],
                                                 flush)["median"])
                if args.warm:
                    warm[name].append(cs.time_stats(torch, runs[name],
                                                    small)["median"])
        host_us = {}  # host time a call to enqueue (the wrapper's ctypes
        for name in names:  # call and the launch), 200 calls back to back
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(200):
                runs[name]()
            host_us[name] = (time.perf_counter() - t) / 200 * 1e6
            torch.cuda.synchronize()
        sdpa = None
        if variant in ("bf16", "b1"):
            kd, vd = dense_kv(torch, case)
            sdpa = cs.time_stats(torch, cs.sdpa(case["q"], kd, vd,
                                                case["allow"]),
                                 flush)["median"]
        emit(out, {"shape": sname, "card": card,
                   "dims": [list(case["q"].shape), list(k.shape)],
                   "live_rows": live, "bound_ms": nbytes / bw * 1e3,
                   "tol": tol, "max_abs_err": errs, "splits": splits,
                   "median_ms_by_round": times, "host_us_per_call": host_us,
                   **({"warm_median_ms_by_round": warm} if args.warm else {}),
                   "sdpa_median_ms": sdpa})
    if args.step and "parent" in impls:
        from fluxdistributed_tpu_torch.models import lm_small

        model = lm_small(vocab=32000, seed=0)  # bf16 on cuda
        g = torch.Generator().manual_seed(1)
        prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
                   for n in (64, 160, 256, 352, 448, 544, 640, 768)]
        own = (fd._launch, fd._launch_paged)
        for layout in ("dense", "paged"):
            res = {"parent": [], "change": []}
            for r in range(args.rounds):
                for name in (("parent", "change") if r % 2 == 0
                             else ("change", "parent")):
                    if name == "parent":
                        fd._launch, fd._launch_paged = engine_launchers(
                            torch, fd, impls["parent"], sms)
                    try:
                        res[name].append(step_profile(torch, model, layout,
                                                      prompts))
                    finally:
                        fd._launch, fd._launch_paged = own
            emit(out, {"step": layout, "card": card,
                       "what": "lm_small graphed decode step, 8 live slots",
                       "by_round": res})
    if failed:
        emit(out, {"failed": failed})
    if out is not None:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
