"""Kernel launch counts that stay exact when several threads launch.

Each kernel wrapper counts its launches in its ``.launches`` attribute
(``flash_decode.launches``, ...): chip checks reset it, drive a path and
hold it against the path's own count.  Two serving replicas in one
process decode on two threads, and a replica's engine can capture its
decode graph while the other decodes, so a count is added under a lock,
and a launch onto a stream that a CUDA graph is capturing goes to that
capture (:func:`capturing`), whose replays then add it.  The stream, not
the thread, names the capture: autograd runs a captured backward's
kernels on its own thread, on the forward's stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

__all__ = ["capturing", "count"]

_lock = threading.Lock()
_captures: Dict[int, Dict[object, int]] = {}  # capturing stream -> counts


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches of ``wrapper``'s kernel, just launched on the
    current CUDA stream: to that stream's open capture if there is one,
    else to ``wrapper.launches``."""
    with _lock:
        if _captures:
            import torch

            captured = _captures.get(torch.cuda.current_stream().cuda_stream)
            if captured is not None:
                captured[wrapper] = captured.get(wrapper, 0) + n
                return
        wrapper.launches += n


@contextlib.contextmanager
def capturing(stream) -> Iterator[Dict[object, int]]:
    """Collect the launches onto ``stream`` (``{wrapper: n}``) instead
    of counting them: a CUDA graph capture records kernels, it runs
    none."""
    captured: Dict[object, int] = {}
    with _lock:
        _captures[stream.cuda_stream] = captured
    try:
        yield captured
    finally:
        with _lock:
            del _captures[stream.cuda_stream]
