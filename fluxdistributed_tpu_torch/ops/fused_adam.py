"""The fused Adam update over flat f32 buffers.

Port of ``fluxdistributed_tpu/parallel/zero1_fused.py:_adam_kernel`` (the
Pallas body behind ``fused_adam_update``).  :func:`fused_adam` is two
versions of one function:

* on CUDA tensors, the hand-written Hopper kernel ``csrc/fused_adam.cu``
  (built by :mod:`._build`, bound with ``ctypes``); it launches or
  raises, never falls back;
* on CPU tensors, :func:`fused_adam_plain`, the same expression in eager
  PyTorch ops.

Both compute, in the op order of :func:`..optim.adam`, ``m' = b1 m +
(1 - b1) g``, ``v' = b2 v + (1 - b2) g²`` and ``p' = p - eta (m' / c1) /
(sqrt(v' / c2) + eps)`` from the step's scalars ``[eta, c1, c2]`` (an
f32 [3] tensor on the buffers' device), and return three new buffers:
nothing is written in place.  The kernel rounds each operation as the
plain version's op does, so the two agree bit for bit.
``fused_adam.launches`` counts kernel launches.  On fake tensors (a
priced step, :mod:`..fake`) it takes the shape-only branch: the three
new buffers, fake, on any device, with no launch and no count.
"""

from __future__ import annotations

import ctypes

import torch

from ..fake import is_fake
from .counts import count

__all__ = ["fused_adam", "fused_adam_plain"]


def fused_adam_plain(p, g, m, v, scalars, b1: float, b2: float,
                     eps: float):
    """The update in eager PyTorch ops: ``(p', m', v')``.  ``scalars`` is
    ``[eta, c1, c2]`` on the buffers' device (a CUDA divisor must not be
    a CPU scalar: PyTorch turns division by one into multiplication by
    its reciprocal, which rounds differently)."""
    eta, c1, c2 = scalars[0], scalars[1], scalars[2]
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * (g * g)
    p2 = p - eta * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
    return p2, m2, v2


def _check(p, g, m, v, scalars) -> None:
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} must match p ({tuple(p.shape)} on "
                             f"{p.device}), got {tuple(t.shape)} on "
                             f"{t.device}")
    if p.ndim != 1:
        raise ValueError(f"fused_adam takes flat 1-D buffers, got "
                         f"{tuple(p.shape)}")
    for t in (p, g, m, v, scalars):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam takes float32 buffers, got "
                            f"{t.dtype}")
    if scalars.shape != (3,) or scalars.device != p.device:
        raise ValueError(f"scalars must be f32 [3] on {p.device}, got "
                         f"{tuple(scalars.shape)} on {scalars.device}")


_lib = None


def _kernel():
    """The loaded kernel library, its entry point typed."""
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fused_adam")
        lib.fused_adam_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_float] * 5
            + [ctypes.c_void_p])
        lib.fused_adam_launch.restype = ctypes.c_int
        lib.fused_adam_error_string.argtypes = [ctypes.c_int]
        lib.fused_adam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(p, g, m, v, scalars, b1, b2, eps):
    for t in (p, g, m, v, scalars):
        if not t.is_contiguous():
            raise ValueError("fused_adam kernel needs contiguous buffers")
    fake = is_fake(p)
    for t in (p, g, m, v):
        if not fake and t.data_ptr() % 16:
            raise ValueError("fused_adam kernel needs 16-byte aligned "
                             "buffers (a chunk of a packed buffer is)")
    n = p.shape[0]
    if n % 4:
        raise ValueError(f"fused_adam kernel needs a length divisible by 4, "
                         f"got {n}")
    outs = [torch.empty_like(p) for _ in range(3)]
    if fake:  # the shape-only branch: no launch, no count
        return tuple(outs)
    lib = _kernel()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = lib.fused_adam_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (p, g, m, v, scalars,
                                                      *outs)),
            n, b1, b2, 1 - b1, 1 - b2, eps, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.fused_adam_error_string(err).decode()
        raise RuntimeError(f"fused_adam kernel launch failed: {msg} "
                           f"(cudaError {err})")
    count(fused_adam)
    return tuple(outs)


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scalars: torch.Tensor, *, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over flat f32 buffers ``p``, ``g``, ``m``, ``v``:
    ``(p', m', v')``, three new buffers.  ``scalars`` is f32 ``[eta,
    1 - b1^t, 1 - b2^t]`` on the buffers' device.  On CUDA tensors this
    launches the Hopper kernel (16-byte aligned buffers, length divisible
    by 4); on CPU tensors it runs :func:`fused_adam_plain`."""
    _check(p, g, m, v, scalars)
    if p.device.type == "cuda" or is_fake(p):
        return _launch(p, g, m, v, scalars, b1, b2, eps)
    if p.device.type != "cpu":
        raise ValueError(f"fused_adam runs on cuda or cpu, got {p.device}")
    return fused_adam_plain(p, g, m, v, scalars, b1, b2, eps)


#: kernel launches since the last reset (plain int; the CPU path and the
#: plain version never count)
fused_adam.launches = 0
