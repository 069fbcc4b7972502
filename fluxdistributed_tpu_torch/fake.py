"""Fake tensors: what the pricing of a step (:mod:`.obs.pricing`) runs on.

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``) has a
shape, a dtype, strides and a device, and no memory: an op on it
computes only the shapes and dtypes of its outputs.  The port runs a
real step once on such tensors to learn what it would allocate and
which collectives it would issue, without touching the device.

* :func:`is_fake` is the test each kernel wrapper makes before it
  launches: a fake tensor takes the wrapper's shape-only branch, which
  allocates the kernel's outputs (fake as well) and neither launches
  nor counts.  A real tensor never takes it.
* :func:`storage_key` names a tensor's storage on either kind of tensor
  (a fake storage has no address);
* :func:`real` suspends the fake mode, for the few host-side objects a
  step keeps (a staging buffer for the step table, a model built on the
  ``meta`` device before it is made fake).
"""

from __future__ import annotations

import torch

__all__ = ["is_fake", "real", "storage_key"]


def is_fake(x) -> bool:
    """True for a fake tensor (or a parameter that wraps one)."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(x)


def storage_key(t: torch.Tensor) -> int:
    """A key of ``t``'s storage, shared by every view of it: its address,
    or, for a fake tensor (whose storage has none), the storage object's
    identity, which lives as long as the storage."""
    st = t.untyped_storage()
    return id(st) if is_fake(t) else st.data_ptr()


def real():
    """A context in which factory functions make real tensors again,
    inside a fake mode (a no-op outside one)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()
