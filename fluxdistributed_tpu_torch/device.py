"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on the GPU by default.
The CPU is used only when the caller asks for it (``device="cpu"``, as
the tests do).  A missing GPU is an error, never a silent fall-back:
a CPU run is orders of magnitude slower and would pass for a GPU result.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; ``"cuda[:n]"`` → that
    card; ``"meta"`` → shapes without data (a model built there under
    ``with torch.device("meta")`` counts its parameters and multiply-adds
    without allocating them).  Raises ``RuntimeError`` when a CUDA
    device is asked for (or defaulted to) and PyTorch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default. Pass device='cpu' (or --device cpu) to run its "
            "plain PyTorch path on the CPU.")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu|meta)")
    return dev
