"""Fully-sharded data parallelism (ZeRO-3), and the sharded train step
that FSDP, tensor parallelism, their hybrid and the dp x fsdp x tp
layouts share.

Port of ``fluxdistributed_tpu/parallel/fsdp.py``.  The JAX package
shards every large parameter and optimizer-state leaf over the ``data``
axis by annotation and compiles the unchanged DP step with those
shardings; XLA inserts an all-gather where a full parameter is needed
and a reduce-scatter for its gradient.  Eager PyTorch has no
partitioner, so the port writes that schedule out, with its own
collectives:

* each rank holds its block of every sharded leaf
  (:func:`fsdp_leaf_spec` picks the dim, :func:`shard_state` cuts the
  blocks), and the optimizer runs on the blocks;
* the step reaches each sharded leaf through :class:`AllGatherShard`,
  whose forward all-gathers the blocks along the spec's dim over the
  axis's group and whose backward reduce-scatters (sums) the gradient
  along it, so each rank's gradient is its block of the sum over the
  axis's ranks;
* a gradient is then summed over the batch axes it was not yet summed
  over (an all-reduce; all of them for a replicated leaf) and divided
  by the batch group's size as ``collectives.pmean`` divides
  (``div_const``): the DP step's sum-then-divide, so a step whose specs
  shard nothing is the DP step;
* the loss is averaged, and BatchNorm statistics taken, over the batch
  group; the norms of LARS and global-norm clipping sum their squares
  over the ranks that hold a leaf's blocks (:func:`..optim.sharded_norms`),
  which ZeRO-1's sliced update refuses.

Given the ``model`` the loss applies, the gathers follow its blocks
(:func:`model_blocks`: the modules its ``ModuleList``, ``ModuleDict``
and ``Sequential`` containers hold), the schedule the JAX package's XLA
emits (an all-gather per layer where the forward or backward needs the
full parameter):

* the first forward gathers every leaf up front and records the order in
  which the blocks run; from then on each block's sharded leaves are
  gathered when its forward starts (a forward pre-hook swaps them in for
  placeholders on the ``meta`` device, which fail loudly if anything
  reads them outside the block) and dropped when it ends;
* what the backward needs of them is not kept: a
  ``saved_tensors_hooks`` pair packs a saved tensor that is a gathered
  leaf, a view of one or a cast of one as a recipe (the leaf's shard and
  the view's geometry) and re-gathers it when the backward unpacks it;
* the next block's all-gathers are posted, in the recorded order,
  before the current block computes: on the card NCCL runs them on its
  own stream beside that compute (gloo on a worker thread), and the
  next block waits for them;
* the leaves outside the blocks (embeddings, heads, final norms) are
  gathered up front, live through the step, as before.

The gathers move in time and nothing else changes: every leaf is the
same all-gather of the same shard, its gradient the same reduce-scatter
in the same graph, so a step is bit-equal to the gather-everything step.
The plan counts the live gathered bytes (a step's ``gather_plan.live``).
``torch.distributed.fsdp`` is not
used: its reduction divides before or while it sums (pre/post division,
``ReduceOp.AVG``), which rounds otherwise than the sum-then-divide the
port's DP and ZeRO-1 steps are held to, and its sharded parameters hide
their blocks from the port's plain-tensor optimizer.

A spec entry naming ``tp_axis`` (the model axis) is not gathered: the
tensor-parallel modules (:mod:`.tp`) compute on those blocks as they
are, and no gradient is reduced over that axis.  Nor is one naming a
``block_axes`` axis (the expert axis, :mod:`.ep`): the MoE layer
computes on this rank's experts, and its exchanges' backward has
already summed their gradient over that axis, which is also a batch
axis.  Over ``partial_axes`` (the sequence axis, :mod:`.context`) each
rank's loss is a part of one mean: the loss and every gradient are
summed over them and divided by the batch group's size alone.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .. import optim as optim_lib
from ..mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..ops.metrics import topkaccuracy
from ..optim import Optimizer, div_const
from ..sharding import (P, Stacked, entry_axes, gather_dim, local_block,
                        map_with_specs, reduce_scatter_dim, spec_axes,
                        start_gather_dim)
from ..tree import tree_map
from . import collectives, dp
from .zero1 import restore_layout

__all__ = [
    "AllGatherShard",
    "MIN_SHARD_ELEMS",
    "fsdp_leaf_spec",
    "fsdp_specs",
    "gather_state",
    "hybrid_fsdp_tp_specs",
    "make_eval_step_fsdp",
    "make_eval_step_sharded",
    "make_train_step_fsdp",
    "make_train_step_sharded",
    "model_blocks",
    "shard_state",
]

# Leaves smaller than this stay replicated: sharding a 64-float BatchNorm
# bias saves nothing and costs a latency-bound collective per use.
MIN_SHARD_ELEMS = 2**11


def fsdp_leaf_spec(shape, axis: str = DATA_AXIS, nshards: int = 1,
                   min_size: int = MIN_SHARD_ELEMS,
                   base: Optional[P] = None) -> P:
    """The spec of one leaf, from its shape alone (the JAX rule, copied).

    Shards the largest dim divisible by ``nshards`` (ties go to the
    trailing dim).  Leaves under ``min_size`` elements, or with no
    divisible dim, stay replicated.  ``base`` composes with an existing
    spec (the hybrid FSDP x TP path): only dims it leaves unsplit are
    candidates, and its entries are kept.  The rule reads the port's
    shapes: a torch weight is ``(out, in)`` and a conv OIHW where the
    JAX kernel is ``(in, out)`` / HWIO, so at a tie the chosen dim can be
    the other one; the shard sizes are the same (ROADMAP C9)."""
    shape = tuple(shape)
    entries = (list(base) + [None] * (len(shape) - len(base))
               if base is not None else [None] * len(shape))
    keep = P(*entries) if base is not None else P()
    if not shape or math.prod(shape) < min_size:
        return keep
    best = None  # (extent, dim)
    for d, extent in enumerate(shape):
        if entries[d] is None and extent % nshards == 0 and extent >= nshards:
            if best is None or extent >= best[0]:
                best = (extent, d)
    if best is None:
        return keep
    entries[best[1]] = axis
    return P(*entries)


def fsdp_specs(state: dp.TrainState, mesh: Mesh, axis: str = DATA_AXIS,
               min_size: int = MIN_SHARD_ELEMS) -> dp.TrainState:
    """A ``TrainState`` of specs: params and optimizer state sharded by
    :func:`fsdp_leaf_spec`; the mutable model state (BatchNorm running
    stats) and the step replicated."""
    n = mesh.axis_size(axis)

    def leaf(x):
        return fsdp_leaf_spec(tuple(x.shape), axis, n, min_size)

    return dp.TrainState(
        params=tree_map(leaf, state.params),
        opt_state=tree_map(leaf, state.opt_state),
        model_state=tree_map(lambda _: P(), state.model_state), step=P())


def hybrid_fsdp_tp_specs(params: dict, mesh: Mesh, tp_rules: Callable,
                         data_axis: str = DATA_AXIS,
                         min_size: int = MIN_SHARD_ELEMS) -> dict:
    """Sharding on a ``(data, model)`` mesh: tensor parallelism by
    ``tp_rules`` (e.g. :func:`.tp.lm_tp_rules`) and FSDP over
    ``data_axis`` on each leaf's largest dim the rule left unsplit.  A
    rank holds about 1/(|data| |model|) of each large leaf.  Returns the
    params' spec dict (:func:`.tp.state_specs` extends it to a state)."""
    from .tp import param_specs

    n = mesh.axis_size(data_axis)
    tp_specs = param_specs(params, tp_rules)
    return {k: fsdp_leaf_spec(tuple(p.shape), data_axis, n, min_size,
                              base=tp_specs[k])
            for k, p in params.items()}


def shard_state(state: dp.TrainState, specs: dp.TrainState,
                mesh: Mesh) -> dp.TrainState:
    """This rank's blocks of a global ``state`` (each leaf copied from
    rank 0 first, so every rank cuts from the same values), in new
    tensors; replicated leaves are whole copies."""
    from ..sharding import replicate

    def put(x, spec):
        return local_block(replicate(x, mesh), spec, mesh)

    return dp.TrainState(
        params=map_with_specs(put, state.params, specs.params),
        opt_state=map_with_specs(put, state.opt_state, specs.opt_state),
        model_state=map_with_specs(put, state.model_state,
                                   specs.model_state),
        step=state.step)


def gather_state(tree, specs, mesh: Mesh, keep_axis: Optional[str] = None):
    """The global tensors of a tree of blocks (a collective: every rank
    of ``mesh`` calls it): the inverse of :func:`shard_state`'s cut.
    Entries over ``keep_axis`` stay split (a tensor-parallel model's
    blocks)."""
    from ..sharding import gather_global

    def one(x, spec):
        if keep_axis is not None:
            spec = P(*(None if keep_axis in entry_axes(e) else e
                       for e in spec))
        return gather_global(x, spec, mesh)

    return map_with_specs(one, tree, specs)


class AllGatherShard(torch.autograd.Function):
    """``x``'s blocks all-gathered along ``dim`` over ``group`` (``n``
    ranks); the backward reduce-scatters (sums) the gradient along that
    dim, so each rank gets its block of the sum.  ``ready``, when given,
    is the ``finish`` of that gather already posted
    (:func:`..sharding.start_gather_dim`)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, ready=None):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return ready() if ready is not None else gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None,
                None, None, None)


_CONTAINERS = (nn.ModuleList, nn.ModuleDict, nn.Sequential)


def model_blocks(model: nn.Module) -> list:
    """``(name, module)`` of each block of ``model``, in registration
    order: a module that a container (``ModuleList``, ``ModuleDict``,
    ``Sequential``) holds and that is not a container itself (a
    transformer's layers, a ResNet stage's residual blocks; a container
    of containers is walked into).  A block's own submodules are not
    blocks."""
    out = []

    def walk(prefix: str, mod: nn.Module, held: bool) -> None:
        for name, child in mod.named_children():
            full = prefix + name
            if isinstance(child, _CONTAINERS):
                walk(full + ".", child, True)
            elif held:
                out.append((full, child))
            else:
                walk(full + ".", child, False)

    walk("", model, isinstance(model, _CONTAINERS))
    return out


def _sub(mesh: Mesh, axes) -> Mesh:
    """The sub-mesh over ``axes`` in the mesh's order."""
    order = mesh.axis_names
    return mesh.sub(tuple(sorted(set(axes), key=order.index)))


class _Plan:
    """How a sharded step reaches each param: the (dim, axes) gathers of
    its spec's non-model entries, the batch (and partial-loss) axes its
    gradient is still summed over, and the axes its blocks span (its
    norms' reduction)."""

    def __init__(self, mesh: Mesh, p_specs: dict, batch_axes: tuple,
                 tp_axis: Optional[str], block_axes: tuple = (),
                 partial_axes: tuple = ()):
        self.mesh = mesh
        self.gathers, self.rest, self.held, self._subs = {}, {}, {}, {}
        local = set(block_axes) | ({tp_axis} if tp_axis is not None else set())
        for k, spec in p_specs.items():
            gathers = []
            summed = set()  # block axes: summed by the model's exchanges
            for d, e in enumerate(spec):
                axes = entry_axes(e)
                if not axes or local & set(axes):
                    if len(axes) > 1:
                        raise ValueError(f"{k}: spec entry {e!r} mixes the "
                                         f"model or expert axis with others")
                    summed |= set(axes) & set(block_axes)
                    continue
                if isinstance(e, Stacked):
                    raise ValueError(f"{k}: a stacked entry {e!r} over a "
                                     "data axis is not supported")
                gathers.append((d, axes))
            done = {a for _, axes in gathers for a in axes}
            extra = done - set(batch_axes)
            if extra:
                raise ValueError(
                    f"{k}: spec {spec!r} shards over {sorted(extra)}, which "
                    f"the batch does not split over (batch axes "
                    f"{tuple(batch_axes)})")
            self.gathers[k] = gathers
            done |= summed
            self.rest[k] = tuple(a for a in batch_axes + tuple(partial_axes)
                                 if a not in done)
            self.held[k] = spec_axes(spec)

    def sub(self, axes) -> Mesh:
        """The sub-mesh over ``axes`` (made once)."""
        if axes not in self._subs:
            self._subs[axes] = _sub(self.mesh, axes)
        return self._subs[axes]

    def gather(self, k: str, p: torch.Tensor, ready=None) -> torch.Tensor:
        """Leaf ``k``'s global value from its shard ``p``, through
        :class:`AllGatherShard` (``ready``: the first gather, posted),
        in the shard's memory layout."""
        x = p
        for i, (d, axes) in enumerate(self.gathers.get(k, ())):
            sub = self.sub(axes)
            x = AllGatherShard.apply(x, d, sub.group, sub.size,
                                     ready if i == 0 else None)
        return restore_layout(x, p) if x is not p else p

    def start(self, k: str, p: torch.Tensor):
        """Post leaf ``k``'s first all-gather without waiting for it
        (NCCL runs it on its own stream, beside the compute the current
        stream goes on with) and return what :meth:`gather` takes as
        ``ready``: its ``finish``, which makes the current stream wait
        for it."""
        d, axes = self.gathers[k][0]
        sub = self.sub(axes)
        return self.live.posted(
            start_gather_dim(p.detach(), d, sub.group, sub.size))

    def view(self, params: dict) -> dict:
        """The params the model computes with: each sharded leaf
        gathered (through :class:`AllGatherShard`), in its block's
        memory layout."""
        return {k: self.gather(k, p) for k, p in params.items()}

    def bind(self, model: Optional[nn.Module]):
        """The blocks of ``model`` whose leaves the schedule gathers
        (:class:`_Schedule`): for each, ``[(owner module, attribute,
        key)]`` of its sharded leaves."""
        self.blocks, self.order, self.seen = {}, None, []
        self.live = _LiveBytes()
        if model is None:
            return
        for name, blk in model_blocks(model):
            leaves = []
            for pname, _ in blk.named_parameters(prefix=name):
                if self.gathers.get(pname):
                    owner, _, attr = pname[len(name) + 1:].rpartition(".")
                    leaves.append((blk.get_submodule(owner), attr, pname))
            if leaves:
                self.blocks[name] = (blk, leaves)

    def global_shape(self, k: str, p: torch.Tensor) -> tuple:
        """Leaf ``k``'s gathered shape, from its shard ``p``."""
        shape = list(p.shape)
        for d, axes in self.gathers.get(k, ()):
            shape[d] *= self.sub(axes).size
        return tuple(shape)


    def reduce(self, k: str, g: Optional[torch.Tensor], n: int):
        """Gradient ``g`` of leaf ``k`` summed over its remaining batch
        axes, divided by the batch group's size ``n``."""
        if g is None:
            return None
        rest = self.rest.get(k, ())
        if rest:
            g = collectives.psum(g, self.sub(rest))
        return div_const(g, n)

    def norm_sq(self, k: str, sq: torch.Tensor) -> torch.Tensor:
        """A leaf's sum of squares over the ranks holding its blocks."""
        held = self.held.get(k, ())
        return collectives.psum(sq, self.sub(held)) if held else sq

    def global_sq(self, grads: dict) -> torch.Tensor:
        """The squares of every gradient summed (f32), each leaf's over
        the ranks holding its blocks: one all-reduce a set of axes."""
        by_axes: dict = {}
        for k, g in grads.items():
            if g is not None:
                sq = torch.sum(torch.square(g.float()))
                held = self.held.get(k, ())
                by_axes[held] = by_axes.get(held, 0.0) + sq
        total = torch.zeros((), dtype=torch.float32,
                            device=self.mesh.device)
        for held, sq in by_axes.items():
            total = total + (collectives.psum(sq, self.sub(held))
                             if held else sq)
        return total


class _LiveBytes:
    """The gathered bytes the plan holds now and at most (``peak``): the
    storage of each gathered tensor, counted once from the first tracked
    tensor on it until the last is freed (``weakref.finalize``), and
    each posted gather's buffer from its post until it is finished (the
    backend may hold a finished buffer a moment longer: its worker
    thread's reference is not the plan's)."""

    def __init__(self):
        self.now = self.peak = 0
        self._refs: dict = {}  # storage pointer -> [bytes, tensors]

    def add(self, t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr in self._refs:
            self._refs[ptr][1] += 1
        else:
            self._refs[ptr] = [st.nbytes(), 1]
            self._count(st.nbytes())
        weakref.finalize(t, self._free, ptr)
        return t

    def _count(self, n: int) -> None:
        self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, ptr: int) -> None:
        ent = self._refs[ptr]
        ent[1] -= 1
        if ent[1] == 0:
            del self._refs[ptr]
            self.now -= ent[0]

    def posted(self, finish):
        """``finish`` of a posted gather, its buffer counted until it
        is called."""
        n = finish.out.untyped_storage().nbytes()
        self._count(n)

        def ready() -> torch.Tensor:
            x = self.add(finish())
            self.now -= n
            return x

        return ready


# the autograd nodes a saved view of a gathered leaf's cast may pass
# through on its way back to the cast
_VIEW_NODES = frozenset({
    "TBackward0", "TransposeBackward0", "PermuteBackward0", "ViewBackward0",
    "UnsafeViewBackward0", "ReshapeAliasBackward0", "AliasBackward0",
    "ExpandBackward0", "SliceBackward0", "SelectBackward0",
    "UnsqueezeBackward0", "SqueezeBackward0", "SqueezeBackward1",
    "AsStridedBackward0"})


class _Schedule:
    """One loss call's gathers over the plan's blocks (see the module
    docstring): the model's forward pre-hooks and hooks and the saved
    tensors' pack and unpack hooks call it."""

    def __init__(self, plan: _Plan, params: dict):
        self.plan, self.params = plan, params
        self.record = plan.order is None  # the first call learns the order
        self.ready: dict = {}  # block -> {key: posted gather}
        # storage pointer -> (key, gathered tensor) of each block leaf
        # gathered now, and its autograd node's id -> key
        self.by_ptr: dict = {}
        self.by_node: dict = {}
        self.placeholders: dict = {}  # (owner, attr) -> the meta tensor

    def view(self) -> dict:
        """The params for the model: gathered up front on the first call
        and outside the scheduled blocks, ``meta`` placeholders of the
        global shape for the scheduled blocks' leaves."""
        plan, out = self.plan, {}
        later = set() if self.record else {
            k for b in plan.order for _, _, k in plan.blocks[b][1]}
        for k, p in self.params.items():
            if k in later:
                out[k] = torch.empty(plan.global_shape(k, p), dtype=p.dtype,
                                     device="meta")
            else:
                x = plan.gather(k, p)
                out[k] = p if x is p else plan.live.add(x)
        return out

    def enter(self, name: str) -> None:
        """Block ``name``'s forward starts: gather its leaves (posted
        ones finished), swap them in, post the next block's."""
        plan = self.plan
        if self.record:
            if name not in plan.seen:
                plan.seen.append(name)
            return
        ready = self.ready.pop(name, {})
        for owner, attr, k in plan.blocks[name][1]:
            # popped: a posted buffer goes as soon as its leaf is made
            x = plan.live.add(plan.gather(k, self.params[k],
                                          ready.pop(k, None)))
            self.by_ptr[x.untyped_storage().data_ptr()] = (k, x)
            self.by_node[id(x.grad_fn)] = (k, x.grad_fn, x)
            self.placeholders[(id(owner), attr)] = owner._parameters[attr]
            owner._parameters[attr] = x
        i = plan.order.index(name)
        if i + 1 < len(plan.order):
            self.post(plan.order[i + 1])

    def leave(self, name: str) -> None:
        """Block ``name``'s forward ends: its gathered leaves go (what
        the backward needs was packed as recipes)."""
        if self.record:
            return
        keys = set()
        for owner, attr, k in self.plan.blocks[name][1]:
            owner._parameters[attr] = self.placeholders.pop((id(owner), attr))
            keys.add(k)
        self.by_ptr = {p: v for p, v in self.by_ptr.items()
                       if v[0] not in keys}
        self.by_node = {i: v for i, v in self.by_node.items()
                        if v[0] not in keys}

    def post(self, name: str) -> None:
        """Post block ``name``'s first all-gathers (leaves with one)."""
        plan = self.plan
        if name in self.ready:
            return
        self.ready[name] = {k: plan.start(k, self.params[k])
                            for _, _, k in plan.blocks[name][1]
                            if len(plan.gathers[k]) == 1}

    def pack(self, t: torch.Tensor):
        """A saved tensor that is a gathered block leaf, a view of one or
        a cast of one becomes a recipe to gather it again; anything else
        is kept as it is."""
        if t.device.type == "meta" or not (self.by_ptr or self.by_node):
            return t
        hit = self._origin(t)
        if hit is None:
            return t
        k, dtype = hit
        return (_Regather, self, k, dtype, t.size(), t.stride(),
                t.storage_offset())

    def _origin(self, t: torch.Tensor):
        """``(key, None)`` when ``t`` shares storage with a gathered
        leaf, ``(key, dtype)`` when it is a view of the whole leaf's
        cast (storage of the leaf's size in ``t``'s dtype), else None."""
        hit = self.by_ptr.get(t.untyped_storage().data_ptr())
        if hit is not None:
            return hit[0], None
        node = t.grad_fn
        while node is not None:
            name = type(node).__name__
            if name == "ToCopyBackward0":
                parent = node.next_functions[0][0]
                hit = self.by_node.get(id(parent))
                if hit is None or hit[1] is not parent:
                    return None
                x = hit[2]
                if (t.untyped_storage().nbytes()
                        != x.numel() * t.element_size()
                        or not (x.is_contiguous() or x.is_contiguous(
                            memory_format=torch.channels_last))):
                    return None
                return hit[0], t.dtype
            if name not in _VIEW_NODES:
                return None
            node = node.next_functions[0][0]
        return None

    def regather(self, k: str, dtype) -> torch.Tensor:
        """Leaf ``k`` gathered again outside the graph (the backward only
        reads it), cast to ``dtype`` when the saved tensor was a cast."""
        live = self.plan.live
        with torch.no_grad():
            x = live.add(self.plan.gather(k, self.params[k].detach()))
            return x if dtype is None else live.add(x.to(dtype))


class _Regather:
    """The tag of a packed recipe."""


def _unpack(packed):
    if not (isinstance(packed, tuple) and packed
            and packed[0] is _Regather):
        return packed
    _, sched, k, dtype, size, stride, offset = packed
    return sched.regather(k, dtype).as_strided(size, stride, offset)


class _Scheduled:
    """The context of one loss call on :class:`_Schedule`: the view to
    pass the model, the blocks' hooks and the saved-tensor hooks."""

    def __init__(self, plan: _Plan, params: dict):
        self.sched = _Schedule(plan, params)
        self.handles = []
        self.saved = None

    def __enter__(self) -> dict:
        sched, plan = self.sched, self.sched.plan
        view = sched.view()
        for name, (blk, _) in plan.blocks.items():
            if sched.record or name in plan.order:
                self.handles.append(blk.register_forward_pre_hook(
                    lambda m, a, n=name: sched.enter(n)))
                self.handles.append(blk.register_forward_hook(
                    lambda m, a, o, n=name: sched.leave(n)))
        if not sched.record and plan.order:
            self.saved = torch.autograd.graph.saved_tensors_hooks(
                sched.pack, _unpack)
            self.saved.__enter__()
        return view

    def __exit__(self, *exc) -> None:
        if self.saved is not None:
            self.saved.__exit__(*exc)
        for h in self.handles:
            h.remove()
        plan = self.sched.plan
        if self.sched.record:
            plan.order = [n for n in plan.seen if n in plan.blocks]
        # a posted gather no block took (the order changed) is finished
        for ready in self.sched.ready.values():
            for finish in ready.values():
                finish()


def _gathered_loss(loss_fn: Callable, plan: _Plan) -> Callable:
    """``loss_fn`` on the blocks: the params gathered on the schedule
    (all of them up front without a model)."""
    with_rng = dp._accepts_rng(loss_fn)

    def fn(params, model_state, batch, train: bool, rng=None):
        kw = {"rng": rng} if with_rng else {}
        with _Scheduled(plan, params) as view:
            return loss_fn(view, model_state, batch, train, **kw)

    fn.global_model_state = getattr(loss_fn, "global_model_state", False)
    return fn


def _batch_axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _step_plan(mesh: Mesh, specs: dp.TrainState, batch_axes, tp_axis,
               block_axes, partial_axes, model=None):
    """(batch-group mesh, partial-loss mesh or None, :class:`_Plan`) of
    a sharded step, its schedule bound to ``model``'s blocks."""
    axes, partial = _batch_axes(batch_axes), _batch_axes(partial_axes)
    plan = _Plan(mesh, specs.params, axes, tp_axis, _batch_axes(block_axes),
                 partial)
    plan.bind(model)
    return (_sub(mesh, axes), _sub(mesh, partial) if partial else None,
            plan)


def _loss_mean(loss, bmesh: Mesh, pmesh: Optional[Mesh]):
    """The loss over the batch group: summed over the partial-loss
    axes first, when there are any."""
    if pmesh is not None:
        loss = collectives.psum(loss, pmesh)
    return collectives.pmean(loss, bmesh)


def make_train_step_sharded(loss_fn: Callable, optimizer: Optimizer,
                            mesh: Mesh, specs: dp.TrainState, *,
                            batch_axes: Sequence[str] = (DATA_AXIS,),
                            tp_axis: Optional[str] = MODEL_AXIS,
                            block_axes: Sequence[str] = (),
                            partial_axes: Sequence[str] = (),
                            accum_steps: int = 1, seed: int = 0,
                            guard: bool = False,
                            model: Optional[nn.Module] = None):
    """``step_fn(state, batch) -> (state, metrics)`` on a state of blocks
    placed by ``specs`` (a ``TrainState`` of :class:`~..sharding.P`):
    the DP step with each sharded leaf gathered for the forward and its
    gradient reduce-scattered (see the module docstring).  ``batch``
    holds this rank's rows of the batch split over ``batch_axes``;
    ``metrics["loss"]`` is the mean over the batch group.  The dropout
    seeds fold in the rank's index in the batch group (ranks that differ
    on the model axis draw the same masks).  ``accum_steps`` and
    ``seed`` are the DP step's.  The model's entries over ``tp_axis``
    must already be the tensor-parallel modules' blocks
    (:func:`.tp.tensor_parallel`).  Entries over ``block_axes`` (a batch
    axis: the expert axis) are blocks the model computes on and whose
    gradient its exchanges already summed over that axis; over
    ``partial_axes`` (the sequence axis) the loss of each rank is a part
    of one mean, so the loss and the gradients are summed over them and
    divided by the batch group alone (see the module docstring); the
    dropout seeds do not fold in those axes.  ``guard=True`` adds
    ``metrics["guard"]``, :func:`.dp.guard_sentinel`'s ``[poisoned_loss,
    grad_norm]`` with each leaf's squares summed over its blocks.
    ``model``, the module ``loss_fn`` applies, puts the gathers on its
    blocks' schedule; without it every leaf is gathered up front.  The
    step's ``gather_plan`` holds the block order the schedule learned
    (``order``) and the live gathered bytes (``live.now``,
    ``live.peak``)."""
    dp._check_step_options(accum_steps, 1)
    bmesh, pmesh, plan = _step_plan(mesh, specs, batch_axes, tp_axis,
                                    block_axes, partial_axes, model)
    grads_of = dp._grads_of(_gathered_loss(loss_fn, plan), accum_steps)

    def body(state: dp.TrainState, batch, seeds, scalars):
        loss, mstate, grads = grads_of(state.params, state.model_state,
                                       batch, seeds)
        with torch.no_grad():
            grads = {k: plan.reduce(k, g, bmesh.size)
                     for k, g in grads.items()}
            loss = _loss_mean(loss, bmesh, pmesh)
            mstate = dp.sync_model_state(loss_fn, mstate, bmesh)
            with optim_lib.sharded_norms(plan.norm_sq):
                new_params, new_opt = optimizer.rule(
                    state.params, grads, state.opt_state, scalars)
            metrics = {"loss": loss}
            if guard:
                gnorm = torch.sqrt(plan.global_sq(grads))
                metrics["guard"] = torch.stack([loss.float() + 0.0 * gnorm,
                                                gnorm])
        return dp.TrainState(params=new_params, opt_state=new_opt,
                             model_state=mstate,
                             step=state.step + 1), metrics

    loop = dp.device_loop(body, optimizer, seed=seed,
                          accum_steps=accum_steps, mesh=bmesh,
                          steps_per_call=1)
    loop.gather_plan = plan
    return loop


def make_eval_step_sharded(loss_fn: Callable, mesh: Mesh,
                           specs: dp.TrainState, *,
                           batch_axes: Sequence[str] = (DATA_AXIS,),
                           tp_axis: Optional[str] = MODEL_AXIS,
                           block_axes: Sequence[str] = (),
                           partial_axes: Sequence[str] = (),
                           topk: tuple = (1, 5, 10),
                           model: Optional[nn.Module] = None):
    """The eval step on a state of blocks: the params gathered (on
    ``model``'s block schedule, as the train step's), one forward in
    eval mode, the loss (summed over ``partial_axes`` first) and top-k
    accuracies averaged over the batch group (see
    :func:`.dp.make_eval_step`)."""
    bmesh, pmesh, plan = _step_plan(mesh, specs, batch_axes, tp_axis,
                                    block_axes, partial_axes, model)

    @torch.no_grad()
    def step(state: dp.TrainState, batch):
        with _Scheduled(plan, state.params) as view:
            loss, (_, logits) = loss_fn(view, state.model_state, batch,
                                        False)
        metrics = {f"top{k}": topkaccuracy(logits, batch["label"], k=k)
                   for k in topk}
        return (_loss_mean(loss, bmesh, pmesh),
                collectives.pmean(metrics, bmesh))

    return step


def make_train_step_fsdp(loss_fn: Callable, optimizer: Optimizer,
                         mesh: Mesh, specs: dp.TrainState,
                         axis: str = DATA_AXIS, accum_steps: int = 1,
                         seed: int = 0):
    """The DP train step on the FSDP-sharded state of
    :func:`fsdp_specs` / :func:`shard_state`, the batch split over
    ``axis`` as in DP; ``accum_steps`` and ``seed`` are the DP step's."""
    return make_train_step_sharded(loss_fn, optimizer, mesh, specs,
                                   batch_axes=(axis,), tp_axis=None,
                                   accum_steps=accum_steps, seed=seed)


def make_eval_step_fsdp(loss_fn: Callable, mesh: Mesh, specs: dp.TrainState,
                        axis: str = DATA_AXIS, topk: tuple = (1, 5, 10)):
    """The eval step on the FSDP-sharded state directly."""
    return make_eval_step_sharded(loss_fn, mesh, specs, batch_axes=(axis,),
                                  tp_axis=None, topk=topk)
