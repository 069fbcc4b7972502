"""HTTP front end for the continuous-batching engine.

Port of ``fluxdistributed_tpu/serve/server.py``.  Stdlib HTTP: a
``ThreadingHTTPServer`` accepts requests on many threads,
every generation is enqueued onto ONE scheduler loop thread, and
streaming responses ride chunked transfer encoding.

Routes:

* ``POST /v1/generate`` — JSON body::

      {"prompt": "text"            # byte-level (vocab >= 256), OR
       "prompt_tokens": [1, 2],    # explicit token ids
       "max_tokens": 64,           # new tokens to generate
       "temperature": 0.0,         # 0 = greedy (parity with generate())
       "seed": 0, "eos": null,     # optional sampling seed / stop token
       "stream": false}            # chunked per-token streaming

  Non-streaming responses carry ``tokens`` (prompt+generated),
  ``generated``, decoded ``text`` for byte-level vocabs, and per-request
  timings.  Streaming responses emit one JSON line per token and a final
  ``{"done": true, ...}`` line.  A full admission queue returns **429**
  (backpressure), bad shapes return 400 with the engine's actionable
  message.
* ``GET /healthz`` — liveness + slot/queue occupancy, and the device
  memory read from ``torch.cuda.memory_stats``.
* ``GET /metrics`` — Prometheus text: queue depth, active slots,
  prefill/decode tokens-per-sec, time-to-first-token + queue-wait +
  inter-token (TBT) histograms, compile counts.
* ``GET /trace`` — the request-scoped Perfetto timeline
  (``obs.reqtrace``; 404 when the scheduler has no tracer attached).

Request ids: a client ``X-Request-Id`` header becomes the request's
trace id — every reqtrace event and the response's ``request_id`` field
carry it, so a router can stitch its own logs to this replica's
timeline.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

import torch

from .scheduler import Draining, QueueFull, Request, Scheduler

__all__ = ["LMServer", "serve_lm"]


class LMServer:
    """Scheduler loop thread + HTTP handler factory."""

    def __init__(self, scheduler: Scheduler, vocab: int,
                 request_timeout: float = 600.0):
        self.scheduler = scheduler
        self.vocab = vocab
        self.request_timeout = request_timeout
        #: the port :meth:`serve` actually bound (``--port 0`` gives an
        #: ephemeral one); surfaced on /healthz so a router or test
        #: orchestrating a fleet can discover it race-free
        self.bound_port: Optional[int] = None
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self.loop_errors = 0
        self.last_loop_error: Optional[str] = None
        # surfaced on /metrics too: a dead engine loop behind a healthy
        # HTTP listener is the failure mode /healthz exists for
        self.scheduler.registry.gauge(
            "fdtpu_serve_loop_errors",
            "engine-loop exceptions survived (nonzero = check logs)",
        ).set_function(lambda: self.loop_errors)

    def _memory_block(self) -> dict:
        """The /healthz memory payload: the engine device's allocator
        stats plus the KV cache's reserved/live bytes;
        ``{"available": false}`` (with the KV figures) on the CPU.
        Never raises — a broken telemetry read must not take down the
        health endpoint."""
        try:
            engine = self.scheduler.engine
            out = _device_memory(getattr(engine, "device", None))
            kb = getattr(engine, "kv_cache_bytes", None)
            if callable(kb):
                out["kv_cache"] = kb()
            return out
        except Exception:  # noqa: BLE001
            return {"available": False}

    # ---- engine loop ------------------------------------------------------

    def start_loop(self) -> None:
        if self._loop_thread is not None:
            return
        self._loop_thread = threading.Thread(
            target=self._loop, name="lm-engine-loop", daemon=True)
        self._loop_thread.start()

    def stop_loop(self) -> None:
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
            self._loop_thread = None
        self._stop.clear()

    # ---- graceful drain ---------------------------------------------------

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, SIGTERM-shaped: stop admissions (new
        submits get 503), let everything already accepted finish —
        bounded by ``timeout`` seconds — then stop the engine loop.
        ``/healthz`` reports 503 with ``"draining": true`` for the
        whole window, so a load balancer pulls this replica while
        in-flight decodes complete.

        Returns True when the drain finished clean (scheduler idle);
        False when the timeout cut it short — undone requests' clients
        see their own request timeouts, not silent token loss.
        """
        self.scheduler.begin_drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.scheduler.idle:
                break
            time.sleep(0.02)
        drained = self.scheduler.idle
        self.stop_loop()
        return drained

    def install_drain_handler(self, httpd=None, timeout: float = 30.0,
                              signals=None):
        """Install SIGTERM (and optionally more) handlers that run
        :meth:`drain` on a background thread — a signal handler must
        return immediately — and then ``shutdown()`` the HTTP server so
        ``serve_forever`` returns and the process exits 0.  Returns an
        uninstaller (callable) so tests can restore previous handlers."""
        import signal as _signal

        signals = tuple(signals) if signals is not None else (
            _signal.SIGTERM,)
        previous = {}

        def _drain_then_shutdown():
            self.drain(timeout)
            if httpd is not None:
                httpd.shutdown()

        def handler(signum, frame):
            threading.Thread(
                target=_drain_then_shutdown, name="lm-drain",
                daemon=True).start()

        for s in signals:
            previous[s] = _signal.signal(s, handler)

        def uninstall():
            for s, old in previous.items():
                try:
                    _signal.signal(s, old)
                except (ValueError, OSError):
                    pass

        return uninstall

    def close(self) -> None:
        """Full teardown: stop the engine loop and detach this server's
        (and its scheduler's) scrape callbacks from the registry — the
        shared-registry retirement path (see ``Scheduler.close``)."""
        self.stop_loop()
        self.scheduler.registry.unregister("fdtpu_serve_loop_errors")
        self.scheduler.close()

    def _loop(self) -> None:
        import sys
        import traceback

        sched = self.scheduler
        while not self._stop.is_set():
            try:
                if sched.idle:
                    sched.wait_for_work(0.05)
                    continue
                sched.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # a dead loop with a healthy-looking server is a silent
                # permanent outage: log, count (surfaced by /healthz and
                # /metrics), back off a beat, keep serving
                self.loop_errors += 1
                self.last_loop_error = f"{type(e).__name__}: {e}"
                traceback.print_exc(file=sys.stderr)
                self._stop.wait(0.1)

    # ---- helpers ----------------------------------------------------------

    def _decode_text(self, toks) -> Optional[str]:
        if self.vocab != 256:
            return None
        from ..data.text import ByteTextDataset

        return ByteTextDataset.decode(toks)

    def _parse_request(self, body: dict) -> Request:
        if "prompt" in body and "prompt_tokens" in body:
            raise ValueError("pass prompt OR prompt_tokens, not both")
        if "prompt" in body:
            if self.vocab < 256:
                raise ValueError(
                    "text prompts are byte-encoded and need vocab >= 256; "
                    "this model has vocab "
                    f"{self.vocab} — pass prompt_tokens instead")
            prompt = list(str(body["prompt"]).encode("utf-8"))
        elif "prompt_tokens" in body:
            prompt = [int(t) for t in body["prompt_tokens"]]
            if prompt and (min(prompt) < 0 or max(prompt) >= self.vocab):
                raise ValueError(
                    f"prompt tokens must be in [0, {self.vocab})")
        else:
            raise ValueError("body needs prompt or prompt_tokens")
        temperature = float(body.get("temperature", 0.0))
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        eos = body.get("eos")
        return Request(
            prompt=prompt,
            max_new_tokens=int(body.get("max_tokens", 64)),
            temperature=temperature,
            seed=int(body.get("seed", 0)),
            eos_id=None if eos is None else int(eos),
        )

    def metrics_text(self) -> str:
        """Prometheus text exposition — rendered by the scheduler's
        shared metrics registry (``obs.metrics``).  Every pre-registry
        series name (``fdtpu_serve_*``) is preserved; the registry adds
        HELP/TYPE comment lines and histogram series."""
        return self.scheduler.registry.prometheus_text()

    # ---- HTTP -------------------------------------------------------------

    def make_handler(self):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, obj):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    sched = outer.scheduler
                    loop = outer._loop_thread
                    alive = loop is not None and loop.is_alive()
                    draining = sched.draining
                    body = {
                        # a draining replica is deliberately unhealthy:
                        # the load balancer must pull it while in-flight
                        # decodes finish
                        "ok": alive and not draining,
                        "draining": draining,
                        "active_slots": sched.active_slots,
                        "max_slots": sched.engine.max_slots,
                        "queue_depth": sched.queue_depth,
                        "loop_errors": outer.loop_errors,
                        # device memory (torch.cuda.memory_stats), or
                        # {"available": false} on CPU — a router can
                        # see a replica running out of margin before
                        # it starts OOMing requests
                        "memory": outer._memory_block(),
                    }
                    if outer.bound_port is not None:
                        body["port"] = outer.bound_port
                    if outer.last_loop_error:
                        body["last_loop_error"] = outer.last_loop_error
                    self._send_json(
                        200 if (alive and not draining) else 503, body)
                elif self.path == "/metrics":
                    self._send(200, outer.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/trace":
                    rt = outer.scheduler.reqtrace
                    if rt is None:
                        self._send_json(404, {
                            "error": "request tracing is not enabled — "
                                     "attach an obs.RequestTracer to the "
                                     "scheduler"})
                    else:
                        self._send_json(200, rt.trace_document())
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/generate":
                    self._send_json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    req = outer._parse_request(body)
                    rid = self.headers.get("X-Request-Id")
                    if rid:
                        # the caller's correlation id becomes the trace
                        # id every downstream event carries
                        req.rid = str(rid)[:128]
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    # TypeError covers type-malformed fields (e.g.
                    # prompt_tokens: 5) — still the client's 400, not a 500
                    self._send_json(400, {"error": str(e)})
                    return
                stream = bool(body.get("stream", False))
                if stream:
                    self._stream(req)
                else:
                    self._blocking(req)

            def _submit(self, req) -> bool:
                try:
                    outer.scheduler.submit(req)
                    return True
                except Draining as e:
                    # 503 (not 429): retrying this instance is
                    # pointless, route to another replica
                    self._send_json(503, {"error": str(e),
                                          "draining": True})
                except QueueFull as e:
                    self.send_response(429)
                    self.send_header("Retry-After", "1")
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                return False

            def _result(self, req) -> dict:
                out = {
                    "id": req.id,
                    "request_id": req.trace_id,
                    "tokens": req.tokens,
                    "generated": list(req.generated),
                }
                text = outer._decode_text(req.tokens)
                if text is not None:
                    out["text"] = text
                if req.admitted_at and req.submitted_at:
                    out["queue_wait_ms"] = round(
                        (req.admitted_at - req.submitted_at) * 1e3, 2)
                if req.first_token_at and req.submitted_at:
                    out["ttft_ms"] = round(
                        (req.first_token_at - req.submitted_at) * 1e3, 2)
                if req.finished_at and req.first_token_at:
                    dt = req.finished_at - req.first_token_at
                    if dt > 0 and len(req.generated) > 1:
                        out["decode_tokens_per_sec"] = round(
                            (len(req.generated) - 1) / dt, 2)
                        out["tbt_ms_avg"] = round(
                            dt / (len(req.generated) - 1) * 1e3, 2)
                return out

            def _blocking(self, req):
                if not self._submit(req):
                    return
                if not req.done.wait(outer.request_timeout):
                    self._send_json(504, {"error": "generation timed out"})
                    return
                self._send_json(200, self._result(req))

            def _stream(self, req):
                import queue as _q

                toks: _q.Queue = _q.Queue()
                req.on_token = lambda r, t: toks.put(t)
                if not self._submit(req):
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                try:
                    import time as _time

                    deadline = _time.monotonic() + outer.request_timeout
                    while _time.monotonic() < deadline:
                        try:
                            t = toks.get(timeout=0.05)
                        except _q.Empty:
                            # on_token fires BEFORE done is set; only a
                            # drained queue + done means truly finished
                            if req.done.is_set() and toks.empty():
                                break
                            continue
                        chunk({"token": int(t)})
                    if req.done.is_set():
                        chunk({"done": True, **self._result(req)})
                    else:
                        # deadline hit with the request still running:
                        # report the truncation (the blocking path's 504)
                        # instead of masquerading as a clean completion
                        chunk({"done": False,
                               "error": "generation timed out",
                               **self._result(req)})
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: cancel so the slot —
                    # and, on a paged engine, its KV blocks — frees on
                    # the next tick instead of decoding to max_tokens
                    # for nobody
                    outer.scheduler.cancel(req)
                finally:
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except OSError:
                        pass

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        """Build the HTTP server (started loop included); the caller
        runs ``serve_forever``, so tests can drive the server in a
        thread."""
        import http.server

        self.start_loop()
        httpd = http.server.ThreadingHTTPServer((host, port),
                                                self.make_handler())
        self.bound_port = httpd.server_address[1]
        return httpd


def _device_memory(device) -> dict:
    """Allocator statistics of a CUDA ``device``; ``{"available":
    false}`` for the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return {"available": False}
    stats = torch.cuda.memory_stats(device)
    return {
        "available": True,
        "device": torch.cuda.get_device_name(device),
        "allocated_bytes": stats.get("allocated_bytes.all.current", 0),
        "peak_allocated_bytes": stats.get("allocated_bytes.all.peak", 0),
        "reserved_bytes": stats.get("reserved_bytes.all.current", 0),
        "total_bytes": torch.cuda.get_device_properties(device).total_memory,
    }


def serve_lm(scheduler: Scheduler, vocab: int, host: str = "127.0.0.1",
             port: int = 8000, request_timeout: float = 600.0):
    """One-call wiring: ``(LMServer, ThreadingHTTPServer)``."""
    srv = LMServer(scheduler, vocab, request_timeout=request_timeout)
    return srv, srv.serve(host, port)
