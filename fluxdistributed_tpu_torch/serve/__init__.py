"""Continuous-batching LM serving on the dense slot KV cache or the paged
block pool: the engine, the prefill/decode scheduler, the streaming
HTTP front end and the N-replica router.  ``python -m
fluxdistributed_tpu_torch.serve`` runs the server, ``python -m
fluxdistributed_tpu_torch.serve.router`` the router."""

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
    "NoReplicaAvailable",
    "PagedLayout",
    "QueueFull",
    "Replica",
    "Request",
    "Router",
    "RouterError",
    "Scheduler",
    "SupervisedReplica",
    "prefix_digests",
    "serve_lm",
]

_ROUTER = ("NoReplicaAvailable", "Replica", "Router", "RouterError",
           "SupervisedReplica")


def __getattr__(name):
    # the router's names load on first use: ``python -m
    # fluxdistributed_tpu_torch.serve.router`` imports this package
    # first, and must find the router module not yet imported
    if name in _ROUTER:
        from . import router

        return getattr(router, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
