"""PyTorch/CUDA port of ``fluxdistributed_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package re-implements its
slices in PyTorch, with every TPU (Pallas) kernel on a ported path
replaced by a kernel written by hand for ``sm_90a``.  Ported so far:
LM serving over the dense slot KV cache and the paged block pool (the
model and its decode caches, :mod:`.models.transformer_lm`; the
flash-decode kernels, :mod:`.ops.flash_decode`; the engine, scheduler
and HTTP server, :mod:`.serve`), LM training on one GPU (the
flash-attention kernels, :mod:`.ops.flash_attention`; :mod:`.optim`,
:mod:`.data`, :mod:`.parallel` and :mod:`.train`, with the CLI
``python -m fluxdistributed_tpu_torch.train``), and data-parallel and
ZeRO-1 training across process ranks (:mod:`.mesh`, :mod:`.sharding`,
:mod:`.parallel.zero1`, :mod:`.parallel.zero1_fused` and the fused Adam
kernel, :mod:`.ops.fused_adam`), image training (ResNet, ViT, ConvNeXt
and the ImageNet data path), checkpoints with preemption and resume
(:mod:`.faults`, :mod:`.train.checkpoint`), and image inference
(:mod:`.serve.vision`, ``python -m fluxdistributed_tpu_torch.infer``).

The port imports ``torch`` and never ``jax``, ``flax`` or the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
