"""BatchNorm over NCHW activations, with running statistics that are
returned, never written in place, and taken over the mesh when asked.

The port's counterpart of ``flax.linen.BatchNorm`` as the JAX ResNet
uses it (``momentum=0.9``, ``epsilon=1e-5``, statistics in float32):

* in train mode the batch mean and the **biased** variance normalise
  the input, and the new running stats are ``0.9 * old + 0.1 * batch``
  (flax's ``momentum`` is the weight of the old value; torch's
  ``BatchNorm2d`` weighs the new one and keeps the unbiased variance);
* in eval mode the running stats normalise the input;
* the running stats are never mutated: a train-mode forward records the
  new ones in the :class:`BatchStats` it is given, and the caller
  decides what becomes of them (``torch.nn.BatchNorm2d`` overwrites the
  tensors passed to ``torch.func.functional_call``, which would change a
  ``TrainState`` before its step had finished);
* with a mesh, each rank's ``[mean, mean(x²)]`` is all-reduced (one
  call a layer) before the variance is formed, so the statistics are
  those of the global batch (flax's ``axis_name``, and what the JAX
  ``jit`` step computes over a sharded batch), and the backward
  all-reduces BatchNorm's two channel sums (one call a layer), so it
  carries the terms between ranks (:class:`_SyncNorm`).  Without one,
  the statistics are this rank's, from ``torch.native_batch_norm`` (one
  library kernel for the output and the statistics).

The variance is computed without flax's float32 ``E[x²] - E[x]²``,
which cancels where a channel's mean is large against its spread; so
the port is held to the JAX package evaluated in float64 where that
matters (ROADMAP C7).

The output is in the layer's dtype (the model's ``norm_dtype`` or
``dtype``); the arithmetic is float32 whatever the input's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..obs import comms


__all__ = ["BatchNorm", "BatchStats"]


class BatchStats:
    """What a train-mode forward does with BatchNorm statistics:
    ``mesh`` is the group they are taken over (``None``: this rank's
    rows only), and ``new`` collects each layer's new ``(running_mean,
    running_var)`` by module.  A layer recorded once keeps its first
    record, so a block recomputed in the backward (remat) adds none."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.new: Dict[nn.Module, tuple] = {}


@torch.no_grad()
def _global_moments(x: torch.Tensor, mesh):
    """Mean and biased variance per channel over every rank's rows.

    Each rank's ``[mean, mean(x²)]`` is summed over the ranks and divided
    by their number (the JAX ``pmean``), but in float64: the local
    variance comes without cancellation (PyTorch's Welford statistics
    kernel on the GPU, the one :class:`torch.nn.SyncBatchNorm` uses;
    ``torch.var_mean`` on the CPU), and forming ``mean(x²) - mean²`` of
    the global batch in float32 would lose it again wherever ``|mean|``
    is large against the spread (the fault of flax's float32
    ``E[x²] - E[x]²``, ROADMAP C7).  The vectors hold two numbers a
    channel, so the wider type costs nothing measurable.  No gradient
    flows through here: :class:`_SyncNorm`'s backward carries the
    statistics' terms."""
    if x.is_cuda:
        mean, invstd = torch.batch_norm_stats(x, 0.0)
        var = invstd.double().reciprocal().square()
    else:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        var = var.double()
    mean = mean.double()
    moments = torch.stack([mean, var + mean * mean])
    comms.all_reduce(moments, group=mesh.group)
    moments /= mesh.size
    mean, mean2 = moments[0], moments[1]
    return mean.float(), torch.clamp(mean2 - mean * mean, min=0.0).float()


class _SyncNorm(torch.autograd.Function):
    """BatchNorm with statistics of the global batch: the forward
    normalises with the given global ``mean``/``var`` (one library
    kernel); the backward is BatchNorm's, with its two sums over the
    channel taken over every rank's rows by one all-reduce:

        dx = w / σ · (dy - mean(dy) - x̂ · mean(dy · x̂))

    (means over the global batch), and ``dw``, ``db`` this rank's own
    sums, which the step averages over the ranks as it does every other
    gradient.  Only ``x`` is kept for the backward, in its own dtype.
    On the GPU the sums and ``dx`` come from PyTorch's BatchNorm
    kernels (the ones :class:`torch.nn.SyncBatchNorm` uses); on the CPU
    from the formula above in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, mesh):
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.mesh = mesh
        return torch.native_batch_norm(x, weight, bias, mean, var, False,
                                       0.0, eps)[0]

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        group, size = ctx.mesh.group, ctx.mesh.size
        if x.is_cuda:
            if not dy.is_contiguous(memory_format=torch.channels_last):
                dy = dy.contiguous()
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, True, True, True)
            total = torch.cat([sum_dy, sum_dy_xmu])
            comms.all_reduce(total, group=group)
            counts = torch.full((size,), x.numel() // x.shape[1],
                                dtype=torch.int32, device=x.device)
            c = sum_dy.shape[0]
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, weight, total[:c], total[c:], counts)
            return dx, dw, db, None, None, None, None
        c = (slice(None), None, None)
        xhat = (x.float() - mean[c]) * invstd[c]
        dyf = dy.float()
        local = torch.stack([dyf.sum(dim=(0, 2, 3)),
                             (dyf * xhat).sum(dim=(0, 2, 3))])
        total = local.clone()
        comms.all_reduce(total, group=group)
        total /= x.numel() // x.shape[1] * size
        dx = (weight * invstd)[c] * (dyf - total[0][c] - xhat * total[1][c])
        return dx.to(x.dtype), local[1], local[0], None, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of NCHW input.  ``weight``/``bias`` are
    float32 params; ``running_mean``/``running_var`` float32 buffers
    (torchvision's names).  ``momentum`` is flax's (the old value's
    weight); ``dtype`` the output's."""

    def __init__(self, channels: int, *, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.full(
            (channels,), 0.0 if zero_scale else 1.0))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                stats: Optional[BatchStats] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if not train:
            return torch.native_batch_norm(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, False, 0.0, self.eps)[0]
        mesh = None if stats is None else stats.mesh
        if mesh is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = torch.clamp(invstd.reciprocal().square() - self.eps,
                                  min=0.0)
        else:
            mean, var = _global_moments(x, mesh)
            y = _SyncNorm.apply(x, self.weight, self.bias, mean, var,
                                self.eps, mesh)
        if stats is not None and self not in stats.new:
            m = self.momentum
            with torch.no_grad():
                stats.new[self] = (m * self.running_mean + (1 - m) * mean,
                                   m * self.running_var + (1 - m) * var)
        return y
