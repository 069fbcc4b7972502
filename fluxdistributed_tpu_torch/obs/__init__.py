"""Observability: the metrics registry and the request tracer (copies
of the JAX package's stdlib-only modules)."""

from .metrics import Registry, get_registry
from .reqtrace import RequestTracer

__all__ = ["Registry", "RequestTracer", "get_registry"]
