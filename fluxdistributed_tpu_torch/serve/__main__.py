"""Serve a ``TransformerLM`` over HTTP (``POST /v1/generate``,
optionally streaming, ``GET /healthz`` and ``GET /metrics``), or an
image classifier (the webcam demo: ``GET /`` and ``POST /predict``,
:mod:`.vision`).

    python -m fluxdistributed_tpu_torch.serve --model lm_small --port 8000
    curl -d '{"prompt_tokens": [1, 2, 3], "max_tokens": 64}' \\
        localhost:8000/v1/generate

    # paged KV cache with the prefix cache (on the CPU: add --device cpu)
    python -m fluxdistributed_tpu_torch.serve --paged --prefix-cache

    # an image model serves images: a trained checkpoint's top-3 labels
    python -m fluxdistributed_tpu_torch.serve --model resnet50 \\
        --checkpoint ck/ --synset LOC_synset_mapping.txt --port 8000

    # a router fleet's replica with no model: deterministic fake tokens
    python -m fluxdistributed_tpu_torch.serve --fake-engine --vocab 256 \\
        --port 0 --fault-plan '{"fail": [{"site": "serve.tick",
        "at": 40, "action": "exit"}]}'

The mode follows ``--model``: an ``lm_*`` name serves tokens (the
default, ``lm_small``), an image model serves images (the JAX
``bin/serve.py`` picks with ``--lm``).  An LM's weights are random,
made from ``--seed``, or a trained checkpoint's params (``--checkpoint``,
``--step``); an image model's come from ``--checkpoint``,
``--torch-weights`` (torchvision layout) or seed 0.  Runs on the GPU
unless ``--device cpu`` (or ``--platform cpu``; ``--platform gpu`` is
``--device cuda``, ``tpu`` is refused) is given.  ``--prewarm`` builds
the decode kernel and captures the decode graph before the port is
bound, ``--compile-cache DIR`` keeps the kernel libraries in a build
cache, ``--aot-dir DIR`` keeps the engine's AOT manifest, and
``--attention-impl xla`` runs the plain decode attention instead of
the flash-decode kernels (``pallas``, the default).  ``--fake-engine`` serves
:class:`~.testing.FakeLMEngine` instead: it builds no model and asks no
device (its HBM gauges read no card), on any machine.  SIGTERM drains
(``--drain-timeout``) and exits 0.  The flags are the JAX package's
``bin/serve.py`` flags.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from ..train.__main__ import IMAGE_MODELS, LM_MODELS

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="lm_small",
                   choices=[*LM_MODELS, *IMAGE_MODELS],
                   help="an lm_* model serves /v1/generate; an image model "
                        "serves the webcam demo (/predict)")
    p.add_argument("--checkpoint", default=None,
                   help="trainer checkpoint dir (the latest step, or "
                        "--step); http(s):// or gs:// are fetched")
    p.add_argument("--step", type=int, default=None,
                   help="specific checkpoint step")
    p.add_argument("--torch-weights", default=None,
                   help="image models: a torchvision-layout state_dict "
                        "file (.pt/.pth)")
    p.add_argument("--synset", default=None,
                   help="image models: LOC_synset_mapping.txt for the "
                        "class names")
    p.add_argument("--topk", type=int, default=3,
                   help="image models: predictions per image")
    p.add_argument("--num-classes", type=int, default=1000,
                   help="image models: classes of the head")
    p.add_argument("--vocab", type=int, default=32000,
                   help="LM vocab size (256 = byte-level text prompts)")
    p.add_argument("--max-slots", type=int, default=8,
                   help="concurrent decode slots")
    p.add_argument("--max-len", type=int, default=1024,
                   help="per-slot KV budget: prompt + generated tokens")
    p.add_argument("--buckets", default="128,512,2048",
                   help="comma-separated prefill shape buckets")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission queue bound; beyond it /v1/generate "
                        "returns 429")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache layout: a shared pool of fixed-"
                        "size blocks with per-slot page tables instead "
                        "of worst-case rows per slot; freed blocks "
                        "return to the pool on EOS")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="rows per KV block (--paged)")
    p.add_argument("--kv-blocks", type=int, default=None,
                   help="blocks per layer in the pool (--paged); default "
                        "sizes for full capacity — set it SMALLER to "
                        "make memory scale with live tokens and let "
                        "admission backpressure cover the tail")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="prompt positions per prefill chunk; chunks "
                        "interleave with decode ticks (--paged defaults "
                        "to 128; also valid on the dense layout)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="hash + refcount completed prompt blocks so "
                        "shared system prompts prefill once (needs "
                        "--paged, plain attention)")
    p.add_argument("--kv-dtype", default=None, choices=["int8", "fp8"],
                   help="quantise KV-cache storage (per-row scales)")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="KV heads (grouped-query attention)")
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window attention (ring KV cache)")
    p.add_argument("--sinks", type=int, default=0,
                   help="attention sinks (with --window)")
    p.add_argument("--norm", default="layernorm",
                   choices=["layernorm", "rmsnorm"])
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds an ephemeral port (announced as a "
                        "FDTPU_SERVE_PORT=<n> stdout line)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random-init weights")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--platform", default=None,
                   help="bin/serve.py's platform: cpu is --device cpu, gpu "
                        "is --device cuda; tpu is refused")
    p.add_argument("--attention-impl", default="pallas",
                   choices=["xla", "pallas"],
                   help="decode attention core: 'pallas' runs the "
                        "flash-decode kernels (cursor block-skip, native "
                        "windowed-ring and paged walks); 'xla' is their "
                        "plain PyTorch version")
    # cold start (fluxdistributed_tpu_torch.compilation)
    p.add_argument("--prewarm", action="store_true",
                   help="build the decode kernel, run every prefill bucket "
                        "and the splice, and capture the all-slot decode "
                        "step BEFORE binding the port — the first request "
                        "pays decode latency, not the engine's cold start "
                        "(LM mode)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="keep the kernel libraries in a build cache here "
                        "(namespaced by the toolchain and the card): a "
                        "restarted server loads them instead of running "
                        "nvcc")
    p.add_argument("--aot-dir", default=None, metavar="DIR",
                   help="the engine's AOT manifest: load its kernel "
                        "libraries from DIR when topology + model match "
                        "(nothing is built), else warm the engine up now "
                        "and save the manifest for the next process (LM "
                        "mode)")
    p.add_argument("--trace-requests", default=None, metavar="PATH",
                   help="record request-scoped lifecycle events "
                        "(enqueue/queue-wait/prefill chunks/first "
                        "token/decode ticks/finish) in a bounded ring "
                        "and write a Perfetto trace with one track per "
                        "request here at shutdown; the live ring is "
                        "also served at GET /trace (LM mode)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="graceful-drain bound (LM mode): on SIGTERM the "
                        "server stops admissions (503), finishes "
                        "in-flight decodes for up to this many seconds "
                        "(healthz reports draining), then exits 0 — "
                        "rolling restarts lose no tokens")
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="install a deterministic fault-injection plan "
                        "(fluxdistributed_tpu_torch.faults) before "
                        "serving — JSON object or @path/to/plan.json, "
                        "e.g. '{\"fail\": [{\"site\": \"serve.tick\", "
                        "\"at\": 40, \"action\": \"exit\"}]}' is a "
                        "replica crash at scheduler tick 40 (the "
                        "router failover test harness)")
    p.add_argument("--fake-engine", action="store_true",
                   help="serve a deterministic pure-python engine "
                        "(serve.testing.FakeLMEngine) instead of a real "
                        "model — no model, no device, instant startup; "
                        "the router fleet test/dev scaffold (LM mode)")
    p.add_argument("--fake-step-delay", type=float, default=0.002,
                   help="seconds each fake-engine decode tick sleeps "
                        "(gives drains and kills measurable width)")
    return p


def build_server(args):
    """The serving stack for ``args``: ``(LMServer, Scheduler)``."""
    if args.fake_engine:
        # no model, no device: the router fleet scaffold — the HTTP /
        # scheduler surface is real, only the tokens are fake
        from .testing import FakeLMEngine

        return _wire(args, FakeLMEngine(
            max_slots=args.max_slots, max_len=args.max_len,
            step_delay=args.fake_step_delay, vocab=args.vocab))
    from .. import compilation, models
    from ..obs import Registry, jaxmon
    from .engine import LMEngine

    # the server's registry carries the process's compile counters (the
    # first registry bound wins): a replica's /metrics shows its build
    # cache hits and misses and its captures
    registry = Registry()
    jaxmon.install(registry)
    if args.compile_cache:
        compilation.enable_persistent_cache(args.compile_cache)
    try:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}")
    model = getattr(models, args.model)(
        vocab=args.vocab, num_kv_heads=args.kv_heads, window=args.window,
        sinks=args.sinks, norm=args.norm, mlp=args.mlp, device=args.device,
        seed=args.seed)
    if args.checkpoint:
        from ..data.sources import fetch_checkpoint
        from ..train.checkpoint import load_checkpoint

        restored = load_checkpoint(fetch_checkpoint(args.checkpoint),
                                   step=args.step)
        model.load_state_dict({**restored["params"],
                               **restored.get("model_state", {})})
    t0 = time.perf_counter()
    engine = LMEngine(model, max_slots=args.max_slots, max_len=args.max_len,
                      buckets=buckets, prefill_chunk=args.prefill_chunk,
                      kv_dtype=args.kv_dtype,
                      layout="paged" if args.paged else "dense",
                      kv_block_size=args.kv_block_size,
                      kv_blocks=args.kv_blocks,
                      prefix_cache=args.prefix_cache,
                      attention_impl=args.attention_impl,
                      prewarm=args.prewarm, aot_dir=args.aot_dir)
    if args.aot_dir or args.prewarm:
        print(f"engine ready in {time.perf_counter() - t0:.1f}s "
              f"(compile_stats={engine.compile_stats()}, "
              f"compile_metrics={compilation.compile_metrics()})",
              file=sys.stderr)
    return _wire(args, engine, registry)


def _wire(args, engine, registry=None):
    """Scheduler + LMServer over any engine (real or fake): one place,
    so the fake-engine fleet cannot diverge from the real serving
    path."""
    from ..obs.reqtrace import RequestTracer
    from .scheduler import Scheduler
    from .server import LMServer

    scheduler = Scheduler(
        engine, max_queue=args.max_queue, registry=registry,
        reqtrace=RequestTracer() if args.trace_requests else None)
    return LMServer(scheduler, args.vocab), scheduler


def _serve_images(args) -> int:
    from .vision import make_app, serve

    predict = make_app(args)
    httpd = serve(args, predict)
    print(f"FDTPU_SERVE_PORT={httpd.server_address[1]}", flush=True)
    print(f"serving {args.model} on http://{args.host}:"
          f"{httpd.server_address[1]}/ (ctrl-c to stop)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    from ..train.__main__ import LM_MODELS

    from ..train.__main__ import platform_device

    args = build_parser().parse_args(argv)
    platform_device(args)
    if args.model not in LM_MODELS:
        if args.fake_engine:
            raise SystemExit("--fake-engine serves the LM API; drop "
                             f"--model {args.model}")
        return _serve_images(args)
    if args.torch_weights:
        raise SystemExit("--torch-weights is for image models; an LM "
                         "takes --checkpoint")
    if args.fault_plan:
        from .. import faults

        faults.install_plan_arg(args.fault_plan)
    t0 = time.perf_counter()
    server, scheduler = build_server(args)
    what = ("a fake engine (no model, no device)" if args.fake_engine
            else f"checkpoint {args.checkpoint} {args.model} on "
            f"{scheduler.engine.device}" if args.checkpoint
            else f"random-init {args.model} on {scheduler.engine.device}")
    print(f"{what} ready in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    httpd = server.serve(args.host, args.port)
    # SIGTERM → stop admissions, finish in-flight decodes (bounded),
    # shut the HTTP server down, exit 0 — the graceful-drain path
    server.install_drain_handler(httpd=httpd, timeout=args.drain_timeout)
    # the machine-readable bound-port announcement (--port 0 gives an
    # ephemeral one): routers and tests read THIS line
    print(f"FDTPU_SERVE_PORT={httpd.server_address[1]}", flush=True)
    print(f"serving LM on http://{args.host}:{httpd.server_address[1]}/"
          f"v1/generate (ctrl-c to stop; SIGTERM drains "
          f"<= {args.drain_timeout:.0f}s)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop_loop()
        httpd.server_close()
        if scheduler.reqtrace is not None:
            n = scheduler.reqtrace.export_chrome_trace(args.trace_requests)
            print(f"request trace ({n} events) written to "
                  f"{args.trace_requests}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
