"""PyTorch/CUDA port of ``fluxdistributed_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package re-implements its
slices in PyTorch, with every TPU (Pallas) kernel on a ported path
replaced by a kernel written by hand for ``sm_90a``.  The first slice is
LM serving over the dense slot KV cache: the model and its decode cache
(:mod:`.models.transformer_lm`), the flash-decode kernel
(:mod:`.ops.flash_decode`), and the engine, scheduler and HTTP server
(:mod:`.serve`).

The port imports ``torch`` and never ``jax``, ``flax`` or the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
