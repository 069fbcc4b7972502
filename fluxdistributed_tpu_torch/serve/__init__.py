"""Continuous-batching LM serving on the dense slot KV cache or the paged
block pool: the engine, the prefill/decode scheduler and the streaming
HTTP front end.  ``python -m fluxdistributed_tpu_torch.serve`` runs the
server."""

from .cache_layout import BlockPool, DenseLayout, PagedLayout, prefix_digests
from .engine import DEFAULT_BUCKETS, DEFAULT_KV_BLOCK_SIZE, LMEngine
from .scheduler import Draining, QueueFull, Request, Scheduler
from .server import LMServer, serve_lm

__all__ = [
    "BlockPool",
    "DEFAULT_BUCKETS",
    "DEFAULT_KV_BLOCK_SIZE",
    "DenseLayout",
    "Draining",
    "LMEngine",
    "LMServer",
    "PagedLayout",
    "QueueFull",
    "Request",
    "Scheduler",
    "prefix_digests",
    "serve_lm",
]
