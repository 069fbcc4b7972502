"""Serve a ``TransformerLM`` over HTTP: ``POST /v1/generate`` (optionally
streaming), ``GET /healthz`` and ``GET /metrics``.

    python -m fluxdistributed_tpu_torch.serve --model lm_small --port 8000
    curl -d '{"prompt_tokens": [1, 2, 3], "max_tokens": 64}' \\
        localhost:8000/v1/generate

    # paged KV cache with the prefix cache (on the CPU: add --device cpu)
    python -m fluxdistributed_tpu_torch.serve --paged --prefix-cache

Weights are random, made from ``--seed``.  Runs on the GPU unless
``--device cpu`` is given.  The flags are the JAX package's
``bin/serve.py --lm`` flags for the dense and paged layouts.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="lm_small",
                   choices=["lm_tiny", "lm_small", "lm_medium"])
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
    return p


def build_server(args):
    """The serving stack for ``args``: ``(LMServer, Scheduler)``."""
    from .. import models
    from .engine import LMEngine
    from .scheduler import Scheduler
    from .server import LMServer

    try:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}")
    model = getattr(models, args.model)(
        vocab=args.vocab, num_kv_heads=args.kv_heads, window=args.window,
        sinks=args.sinks, norm=args.norm, mlp=args.mlp, device=args.device,
        seed=args.seed)
    engine = LMEngine(model, max_slots=args.max_slots, max_len=args.max_len,
                      buckets=buckets, prefill_chunk=args.prefill_chunk,
                      kv_dtype=args.kv_dtype,
                      layout="paged" if args.paged else "dense",
                      kv_block_size=args.kv_block_size,
                      kv_blocks=args.kv_blocks,
                      prefix_cache=args.prefix_cache)
    scheduler = Scheduler(engine, max_queue=args.max_queue)
    return LMServer(scheduler, args.vocab), scheduler


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    server, _ = build_server(args)
    print(f"random-init {args.model} ready in "
          f"{time.perf_counter() - t0:.1f}s on {server.scheduler.engine.device}",
          file=sys.stderr)
    httpd = server.serve(args.host, args.port)
    server.install_drain_handler(httpd=httpd)
    print(f"FDTPU_SERVE_PORT={httpd.server_address[1]}", flush=True)
    print(f"serving LM on http://{args.host}:{httpd.server_address[1]}/"
          f"v1/generate (ctrl-c to stop; SIGTERM drains)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop_loop()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
