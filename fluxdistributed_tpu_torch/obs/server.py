"""Stdlib HTTP ``/metrics`` + ``/healthz`` for training runs.

(A copy of the JAX package's stdlib-only ``obs/server.py``.)

The LM server proved the pattern (serve/server.py: ThreadingHTTPServer,
no dependencies); this reuses it for the TRAINER so a long-running
``python -m fluxdistributed_tpu_torch.train --metrics-port 9100`` run
is scrapeable like the serving tier:

* ``GET /metrics``  — Prometheus text exposition of a registry;
* ``GET /healthz``  — liveness JSON from a caller hook (the CLI
  reports step progress and watchdog state), 200/503 on ``ok``.

The server runs ``serve_forever`` on a daemon thread; ``stop()`` (or
letting the process exit) tears it down.  Handler threads only READ the
registry, so scraping never blocks a training step.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

from .metrics import Registry, get_registry

__all__ = ["MetricsServer", "start_metrics_server"]


class MetricsServer:
    """One registry + optional health hook behind stdlib HTTP."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        health_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry or get_registry()
        self.health_fn = health_fn
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def make_handler(self):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # scrapes are not log lines
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, outer.registry.prometheus_text().encode(),
                               "text/plain; version=0.0.4")
                elif self.path == "/healthz":
                    body = {"ok": True}
                    if outer.health_fn is not None:
                        try:
                            body = dict(outer.health_fn())
                        except Exception as e:  # noqa: BLE001 — a broken
                            # health hook IS an unhealthy report
                            body = {"ok": False,
                                    "error": f"{type(e).__name__}: {e}"}
                    code = 200 if body.get("ok", True) else 503
                    self._send(code, json.dumps(body).encode(),
                               "application/json")
                else:
                    self._send(404, b'{"error": "not found"}',
                               "application/json")

        return Handler

    def start(self, host: str = "0.0.0.0", port: int = 9100):
        """Bind + serve on a daemon thread; returns the underlying
        ``ThreadingHTTPServer`` (its ``server_address[1]`` is the bound
        port — pass ``port=0`` for an ephemeral one in tests)."""
        import http.server

        if self._httpd is not None:
            return self._httpd
        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), self.make_handler()
        )
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fdtpu-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self._httpd

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def start_metrics_server(
    host: str = "0.0.0.0",
    port: int = 9100,
    registry: Optional[Registry] = None,
    health_fn: Optional[Callable[[], dict]] = None,
) -> MetricsServer:
    """One-call wiring: build + start; returns the :class:`MetricsServer`
    (``.port`` for the bound port, ``.stop()`` to tear down)."""
    srv = MetricsServer(registry=registry, health_fn=health_fn)
    srv.start(host, port)
    return srv
