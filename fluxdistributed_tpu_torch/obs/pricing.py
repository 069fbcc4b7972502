"""Pricing a step before it runs: the step, run once on fake tensors.

The JAX package prices a program by compiling it abstractly on N
virtual devices and asking XLA (``memory_analysis``, ``cost_analysis``,
the HLO's collectives).  Eager PyTorch has no compiler to ask, so the
port runs the real step once on fake tensors
(``torch._subclasses.fake_tensor``, :mod:`..fake`): every op computes
only the shapes and dtypes of its outputs, nothing is allocated on a
device and nothing is sent.  While it runs:

* :class:`LiveBytes` counts the bytes of every storage the step holds
  live (each counted once however many views share it, freed when the
  last one dies), and their peak: the step's peak memory on the device;
  it also sums each op's input and output bytes (the bytes a profile
  records);
* :func:`.comms.recording` notes the collectives the step issues, per
  mesh axis;
* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of its
  matmuls, convolutions and attention (:func:`.profile.step_cost`).

A kernel wrapper given a fake tensor takes its shape-only branch (the
kernel's outputs, no launch, no count; :func:`..fake.is_fake`), so a
priced step is the card's program: flash attention keeps no
``B x H x T x T`` scores.  The collectives need a process group of the
ranks the step spans: :func:`fake_world` forms the fake default group of
N ranks (the ``fake`` backend of ``torch.testing``), which answers every
collective at once.  This process is rank 0 of it: a priced step is rank
0's.  :func:`pricing` opens both and makes models and batches fake
(:meth:`Pricing.module`, :meth:`Pricing.batch`).  Pricing touches no
device memory.

:func:`price_step` runs one step and returns its memory (the JAX
``memory_analysis`` keys, with ``"source": "fake"``) and its ledger;
:func:`.memstats.step_memory` is the memory alone.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..fake import is_fake, real
from . import comms

__all__ = ["LiveBytes", "Pricing", "fake_world", "price_step", "pricing"]


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """The fake default process group of ``n`` ranks, this process rank
    0, formed when there is no group and destroyed on exit.  An open fake
    group of ``n`` ranks is used as it is; a real group (or a fake one of
    another size) raises: a process has one default group, and a priced
    step under a real one would send."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"pricing needs a fake world of {n} rank(s), but a "
                f"{dist.get_backend()} group of {dist.get_world_size()} is "
                "formed: price in a process of its own (parallel.layout "
                "prices in a child process under a real group)")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


class Pricing:
    """A fake mode (and, with :func:`pricing`, a fake world) to build a
    step in: models and batches made here are fake tensors on
    ``device``."""

    def __init__(self, mode, device: torch.device):
        self.mode, self.device = mode, device

    def module(self, model: torch.nn.Module) -> torch.nn.Module:
        """A fake copy of ``model`` on this device: its parameters and
        buffers fake tensors of the same shapes, dtypes and
        ``requires_grad``; the model itself is left as it was (a real
        model's weights are never read or copied)."""
        with real():
            memo: Dict[int, Any] = {}
            # callables the model holds (an attn_fn bound to a mesh, a
            # moe_fn) are shared, not copied: a process group has no copy
            for mod in model.modules():
                for v in vars(mod).values():
                    if callable(v) and not isinstance(
                            v, (torch.nn.Module, torch.Tensor, type)):
                        memo[id(v)] = v
            for t in list(model.parameters()) + list(model.buffers()):
                meta = torch.empty_like(t, device="meta")
                memo[id(t)] = (torch.nn.Parameter(meta, t.requires_grad)
                               if isinstance(t, torch.nn.Parameter) else meta)
            clone = copy.deepcopy(model, memo)
        conv = self.mode.fake_tensor_converter
        for mod in clone.modules():
            for store in (mod._parameters, mod._buffers):
                for name, t in list(store.items()):
                    if t is None:
                        continue
                    with real():
                        meta = t.detach()
                    fake = conv.from_meta_and_device(self.mode, meta,
                                                     self.device)
                    store[name] = (torch.nn.Parameter(fake, t.requires_grad)
                                   if isinstance(t, torch.nn.Parameter)
                                   else fake)
        return clone

    def batch(self, arrays: dict, shards: int = 1) -> dict:
        """A fake batch of one rank: for each entry (an array, a tensor,
        or a ``(shape, dtype)`` pair) zeros of its shape, dim 0 divided
        by ``shards`` (the ranks the batch splits over), its dtype (a
        numpy dtype maps as ``torch.from_numpy`` maps it)."""
        out = {}
        for k, v in arrays.items():
            shape, dtype = ((v[0], v[1]) if isinstance(v, tuple)
                            else (tuple(v.shape), v.dtype))
            shape = tuple(int(d) for d in shape)
            if shape and shape[0] % shards:
                raise ValueError(f"batch[{k!r}] dim 0 ({shape[0]}) does not "
                                 f"split over {shards} ranks")
            if shape:
                shape = (shape[0] // shards,) + shape[1:]
            if not isinstance(dtype, torch.dtype):
                with real():
                    dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            out[k] = torch.zeros(shape, dtype=dtype, device=self.device)
        return out


@contextlib.contextmanager
def pricing(world: Optional[int] = 1, device=None) -> Iterator[Pricing]:
    """A fake world of ``world`` ranks (see :func:`fake_world`; ``None``:
    none, for a step that issues no collective) and a fake mode over it;
    ``device`` (default ``cuda``) is where the fake tensors say they
    live.  On a machine without a card pass
    ``device="cpu"``: the kernel wrappers still take their shape-only
    branches, so the step priced is the card's program."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world_ctx = (contextlib.nullcontext() if world is None
                 else fake_world(world))
    with world_ctx, FakeTensorMode() as mode:
        yield Pricing(mode, dev)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # no storage (sparse, ...)
        return None


def _tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses
    (a ``TrainState``)."""
    import dataclasses

    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


class LiveBytes(TorchDispatchMode):
    """Live storage bytes while a step runs, and their peak.

    Each op's output storages are added once (views share one) and
    leave when their last tensor dies; :meth:`hold` adds storages that
    exist before the run (the step's arguments).  ``bytes_accessed``
    sums each op's input and output tensor bytes; ``written`` holds the
    storages an op wrote in place."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.now = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.written: set = set()

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages as live; their bytes (each storage
        once)."""
        before = self.now
        for t in tensors:
            self._add(t)
        return self.now - before

    def _add(self, t: torch.Tensor) -> None:
        st = _storage(t)
        if st is None or id(st) in self.live:
            return
        n = int(st.nbytes())
        self.live[id(st)] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, id(st))

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(v, torch.Tensor):
                st = _storage(v)
                if st is not None:
                    self.written.add(id(st))
        out = func(*args, **kwargs)
        for t in _tensors((args, kwargs, out)):
            self.bytes_accessed += t.numel() * t.element_size()
        for t in _tensors(out):
            self._add(t)
        return out


def _fake_args(args) -> bool:
    return any(is_fake(t) for t in _tensors(args))


def _learns(fn) -> bool:
    """A step whose first call learns a schedule (the sharded steps'
    FSDP gather order, ``gather_plan.order``, empty until then)."""
    plan = getattr(fn, "gather_plan", None)
    return plan is not None and not getattr(plan, "order", True)


def price_step(fn, args: Tuple[Any, ...], mesh=None) -> dict:
    """Run ``fn(*args)`` once on fake tensors (``args`` built under
    :func:`pricing`) and return ``{"memory": ..., "comms": [...]}``.  A
    step that learns its schedule on its first call (FSDP's gather
    order) runs once unpriced before, so the price is a steady step's:

    * ``memory``: ``argument_bytes`` (the arguments' storages),
      ``output_bytes`` (the outputs' and the arguments' it wrote in
      place: XLA counts a donated, updated buffer as an output),
      ``alias_bytes`` (the argument storages among those: the state the
      step updates in place),
      ``temp_bytes`` (the rest of the peak), ``generated_code_bytes``
      (0) and ``peak_bytes``, the most bytes live at once, so that
      ``peak = argument + output + temp - alias`` as in XLA's model;
      ``"source": "fake"``;
    * ``comms``: the collectives it issued (:mod:`.comms`; axes named
      by ``mesh``).

    Raises when the step fails on fake tensors (a wrong shape is a fault
    of the step, never a price)."""
    if not _fake_args(args):
        raise ValueError("price_step runs a step on fake tensors: build "
                         "its arguments under obs.pricing.pricing()")
    if _learns(fn):
        fn(*args)
    live = LiveBytes()
    held = _tensors(args)
    arg_st = {id(s): s for s in (_storage(t) for t in held) if s is not None}
    argument = live.hold(held)
    with comms.recording(mesh) as rec, live:
        out = fn(*args)
    out_st = {id(s): s for s in (_storage(t) for t in _tensors(out))
              if s is not None}
    out_st.update({k: s for k, s in arg_st.items() if k in live.written})
    output = sum(int(s.nbytes()) for s in out_st.values())
    alias = sum(int(s.nbytes()) for k, s in out_st.items() if k in arg_st)
    peak = max(live.peak, argument + output - alias)
    memory = {"argument_bytes": int(argument), "output_bytes": int(output),
              "temp_bytes": int(peak - argument - output + alias),
              "alias_bytes": int(alias), "generated_code_bytes": 0,
              "peak_bytes": int(peak), "source": "fake"}
    return {"memory": memory, "comms": rec.entries(),
            "bytes_accessed": int(live.bytes_accessed)}
