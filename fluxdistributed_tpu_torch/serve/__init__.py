"""Continuous-batching LM serving on the dense slot KV cache: the
engine, the prefill/decode scheduler and the streaming HTTP front end.
``python -m fluxdistributed_tpu_torch.serve`` runs the server."""

from .cache_layout import DenseLayout
from .engine import DEFAULT_BUCKETS, LMEngine
from .scheduler import Draining, QueueFull, Request, Scheduler
from .server import LMServer, serve_lm

__all__ = [
    "DEFAULT_BUCKETS",
    "DenseLayout",
    "Draining",
    "LMEngine",
    "LMServer",
    "QueueFull",
    "Request",
    "Scheduler",
    "serve_lm",
]
