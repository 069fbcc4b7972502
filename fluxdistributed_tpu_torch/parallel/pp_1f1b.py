"""Hand-scheduled 1F1B pipeline parallelism, its zero-bubble variant and
the Megatron interleaved placement.

Port of ``fluxdistributed_tpu/parallel/pp_1f1b.py``.  The GPipe schedule
(:mod:`.pp`) derives its backward from autograd and keeps every tick's
activations; this one writes the 1F1B (one-forward-one-backward)
schedule by hand, as Megatron-LM runs it.  A static lockstep timetable
(:func:`build_schedule`, a numpy copy of the JAX builder with its
placement oracle) says for every tick what each pipe device does: one
stage forward (F), one stage backward (B), under ``schedule="zb"`` one
deferred weight-gradient pass (W), or nothing.

* An F tick runs the stage forward with no graph kept and stashes its
  input in a ring of ``min(S, M)`` slots a chunk; the embedding runs at
  logical stage 0.
* A B tick recomputes the stage forward from the stashed input under
  ``torch.enable_grad`` and takes ``torch.autograd.grad`` of it with
  respect to its input and its parameters, fed the incoming cotangent;
  at the last logical stage the head (final norm, logits, the
  microbatch's loss) runs on top and the cotangent is ``1 / M``.
* Under ``"zb"`` the B tick pulls only the input cotangent and banks the
  incoming cotangent in a stash ring; the W tick re-runs the same
  recompute from the stashed input and pulls only the parameter (and
  embedding or head) gradients.  Both ticks record the same graph on
  the same operands and differ only in the gradients they ask for, and
  the accumulations follow the timetable's order, so loss and gradients
  equal 1F1B's bit for bit.

Each tick every device hands its activation to the next pipe device and
its cotangent to the previous one (JAX's two ``ppermute``s), through a
small exchange object, and the tick bodies run over that exchange's
list of local pipe devices:

* :class:`GroupPipe` is the product path: this rank is the pipe device
  at its index on the mesh's ``pipe`` axis, and the two hand-offs are
  :func:`.collectives.ring_shift_start` hops over the axis's process
  group, taken by every rank every tick (idle devices send zeros), so
  the send/recv pairs match on every rank;
* :class:`LocalPipe` holds all S pipe devices in one process and moves
  the tensors between their buffers.  NCCL refuses two ranks on one GPU
  and the timetable needs S >= 2, so this is how 1F1B and ZB run on one
  card (``chip_smoke.py``) and how the CPU tests cover their grids.

The tick bodies, the rings, the latches and the accumulation are the
same code for both.  Activation memory is the ring, O(S) microbatch
inputs a device, not GPipe's O(M) ticks.

``interleave=V`` is the round-robin layout: ``[i, c]`` of the stacked
stage params is logical stage ``c S + i``, and activations wrap from
device S - 1 back to 0 between chunks.  The outer (embedding and head)
gradients are summed over the pipe devices once at the end, which
sums a tied embedding's two parts; with a ``batch_axis`` every gradient
and the loss are then averaged over the data ranks (the sum over the
batch group divided by ``optim.div_const``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..mesh import PIPE_AXIS, Mesh
from ..optim import Optimizer, div_const, sharded_norms
from ..tree import accum
from . import collectives
from .dp import TrainState, device_loop
from .pp import STAGES, _accepts_stage, join_tree, split_tree

__all__ = ["GroupPipe", "LocalPipe", "SCHEDULES", "Schedule1F1B",
           "build_schedule", "make_train_step_1f1b", "pipeline_grads_1f1b",
           "split_state_specs"]

#: the hand-written schedules: classic 1F1B, and the ZB-H1-style
#: zero-bubble variant that splits each microbatch backward into an
#: input-grad (B) tick and a deferred weight-grad (W) tick
SCHEDULES = ("1f1b", "zb")


def split_state_specs(axis: str = PIPE_AXIS) -> Callable:
    """``state_specs(state)`` for the flat split tree: ``P(axis)`` on the
    ``stages/`` leaves (their leading dim is the stage), the ``outer/``
    leaves replicated, the optimizer state following its param: the
    port's ``split_state_shardings``, shared by both schedules."""
    from ..sharding import P
    from .tp import state_specs

    def specs(state: TrainState) -> TrainState:
        return state_specs(state, {
            k: P(axis) if k.startswith(STAGES) else P()
            for k in state.params})

    return specs


class Schedule1F1B(NamedTuple):
    """Static lockstep timetable: ``[T, S]`` arrays, one row per tick.

    ``is_fwd[t, i]``/``is_bwd[t, i]`` — does device i run a stage
    forward / backward at tick t (at most one of the two is set);
    ``fwd_mb``/``bwd_mb`` — which microbatch (0 when inactive);
    ``fwd_chunk``/``bwd_chunk`` — which of the device's V interleaved
    chunks (always 0 when V = 1): selects the chunk's params and its
    input-ring slab;
    ``fwd_slot``/``bwd_slot`` — the ring-buffer slot inside that chunk;
    ``fwd_latch``/``bwd_latch`` — FLAT index (``chunk·D + mb mod D``)
    into the depth-D latch buffers a consuming tick reads from;
    ``recv_act[t, i]`` — the neighbor to the left (ring order) produced
    an activation this tick, so latch the incoming ppermute value at
    flat index ``recv_act_ix[t, i]``; ``recv_cot``/``recv_cot_ix`` —
    same for cotangents from the right.

    ``ring`` — input-ring slots per chunk; ``n_chunks`` — V;
    ``latch_depth`` — D latch slots per chunk per direction.

    Zero-bubble timetables (``schedule="zb"``) additionally carry
    ``is_w``/``w_mb``/``w_chunk``/``w_slot`` — the deferred weight-grad
    (W) pass of each microbatch, reading the stashed input AND the
    cotangent the B tick banked at the same ``m % ring`` slot; the
    input-ring slot retires at W, not B.  For ``schedule="1f1b"`` the W
    columns are all-zero and the runtime never reads them.
    """

    is_fwd: np.ndarray
    is_bwd: np.ndarray
    fwd_mb: np.ndarray
    bwd_mb: np.ndarray
    fwd_chunk: np.ndarray
    bwd_chunk: np.ndarray
    fwd_slot: np.ndarray
    bwd_slot: np.ndarray
    fwd_latch: np.ndarray
    bwd_latch: np.ndarray
    recv_act: np.ndarray
    recv_act_ix: np.ndarray
    recv_cot: np.ndarray
    recv_cot_ix: np.ndarray
    ring: int
    n_chunks: int
    latch_depth: int
    max_in_flight: int
    is_w: np.ndarray = None
    w_mb: np.ndarray = None
    w_chunk: np.ndarray = None
    w_slot: np.ndarray = None
    schedule: str = "1f1b"

    @property
    def ticks(self) -> int:
        return self.is_fwd.shape[0]

    def busy_per_device(self) -> np.ndarray:
        """Scheduled actions per device over the T ticks (F + B, plus W
        for zero-bubble timetables) — ``[S]`` ints."""
        busy = self.is_fwd.sum(axis=0) + self.is_bwd.sum(axis=0)
        if self.is_w is not None:
            busy = busy + self.is_w.sum(axis=0)
        return busy.astype(np.int64)

    @property
    def idle_ticks(self) -> np.ndarray:
        """Idle ticks per device — the bubble, counted where it sits."""
        return self.ticks - self.busy_per_device()

    @property
    def utilization(self) -> float:
        """Busy fraction over all devices and ticks (every device
        performs the same action count, so this equals any single
        device's busy share)."""
        S = self.is_fwd.shape[1]
        return float(self.busy_per_device().sum()) / (self.ticks * S)

    def render(self, max_ticks: Optional[int] = None) -> str:
        """ASCII timetable, one row per device, one column per tick:
        ``F3``/``B3``/``W3`` = forward / input-grad backward /
        weight-grad of microbatch 3 (lowercase letter + chunk digit
        when V > 1, e.g. ``f1:3`` → chunk 1, microbatch 3), ``.`` =
        idle.  Each device row ends with its idle-tick count — the
        per-device bubble at a glance.  Interleaved (V > 1) layouts
        render in full by default; pass ``max_ticks`` to truncate wide
        timetables instead.  Eyeball the warmup ramp, the steady state,
        and the (W-filled, for zb) drain directly:

        >>> print(build_schedule(4, 8).render())
        """
        T, S = self.is_fwd.shape
        V = self.n_chunks
        shown = T if max_ticks is None else min(T, max_ticks)
        cells = []
        width = 0
        for i in range(S):
            row = []
            for t in range(shown):
                if self.is_fwd[t, i]:
                    c = (f"F{self.fwd_mb[t, i]}" if V == 1 else
                         f"f{self.fwd_chunk[t, i]}:{self.fwd_mb[t, i]}")
                elif self.is_bwd[t, i]:
                    c = (f"B{self.bwd_mb[t, i]}" if V == 1 else
                         f"b{self.bwd_chunk[t, i]}:{self.bwd_mb[t, i]}")
                elif self.is_w is not None and self.is_w[t, i]:
                    c = (f"W{self.w_mb[t, i]}" if V == 1 else
                         f"w{self.w_chunk[t, i]}:{self.w_mb[t, i]}")
                else:
                    c = "."
                width = max(width, len(c))
                row.append(c)
            cells.append(row)
        idle = self.idle_ticks
        lines = [
            f"dev{i} " + " ".join(c.rjust(width) for c in row)
            + f"  idle={int(idle[i])}"
            for i, row in enumerate(cells)
        ]
        tail = "" if T <= shown else f"\n... ({T - shown} more ticks)"
        name = "ZB" if self.schedule == "zb" else "1F1B"
        head = (f"{name} schedule: S={S} M={int(self.is_fwd[:, 0].sum()) // V} "
                f"V={V} T={T} util={self.utilization:.3f} "
                f"in-flight<={self.max_in_flight}")
        return head + "\n" + "\n".join(lines) + tail


def _verify_placement(S: int, M: int, V: int, ring: int, D: int,
                      fdone, bdone, wdone=None) -> None:
    """The dependency oracle: PROVE a placement safe for the runtime's
    fixed-size buffers, raising ``RuntimeError`` on the first violated
    invariant.  ``fdone``/``bdone``/``wdone`` are tick-of-action arrays
    ``[device][chunk][mb]`` (``wdone=None`` = classic 1F1B, where the
    backward is one joint tick).

    Checked, for every edge/chunk/slot:

    * **act/cot order + latch safety** — a produced activation (left
      neighbor's F, or the S-1 → 0 chunk wrap) / cotangent (right
      neighbor's B, or the 0 → S-1 wrap) lands strictly before its
      consumer fires, and is consumed before the producer's D-th next
      value for that chunk overwrites the latch;
    * **action order** (zb) — F(m) < B(m) < W(m) on each (device,
      chunk);
    * **ring safety** — an input's ``m % ring`` slot is not reused by
      F(m+ring) until its occupant retires: at B for 1F1B, at W for zb
      (W re-reads the stashed input for the weight-grad recompute);
    * **cot-stash safety** (zb) — the cotangent B(m) banks at
      ``m % ring`` survives until W(m) consumes it, i.e. B(m+ring)
      lands after W(m).

    Exposed at module level so tests can feed deliberately corrupted
    placements and property-test the oracle itself — a proof that never
    fires proves nothing.  Real exceptions, not asserts: a placement
    bug here means silently corrupted gradients at runtime, and asserts
    vanish under ``-O``.
    """
    def _prove(ok: bool, i: int, c: int, m: int, what: str):
        if not ok:
            raise RuntimeError(
                f"pipeline schedule unsafe for S={S}, M={M}, V={V}: "
                f"{what} (device {i}, chunk {c}, microbatch {m})"
            )

    retire = wdone if wdone is not None else bdone
    for c in range(V):
        for i in range(S):
            # activation latch into device i's chunk c: produced by the
            # left neighbor (or the S-1 -> 0 wrap from chunk c-1)
            if i > 0:
                prod = [fdone[i - 1][c][m] for m in range(M)]
            elif c > 0:
                prod = [fdone[S - 1][c - 1][m] for m in range(M)]
            else:
                prod = None  # embeds, no latch
            if prod is not None:
                cons = [fdone[i][c][m] for m in range(M)]
                for m in range(M):
                    _prove(prod[m] < cons[m], i, c, m, "act order")
                    if m + D < M:
                        _prove(prod[m + D] >= cons[m], i, c, m,
                               "act latch overwritten before consumption")
            # cotangent latch into device i's chunk c: produced by the
            # right neighbor (or the 0 -> S-1 wrap from chunk c+1)
            if i < S - 1:
                prod = [bdone[i + 1][c][m] for m in range(M)]
            elif c < V - 1:
                prod = [bdone[0][c + 1][m] for m in range(M)]
            else:
                prod = None  # local loss, no latch
            if prod is not None:
                cons = [bdone[i][c][m] for m in range(M)]
                for m in range(M):
                    _prove(prod[m] < cons[m], i, c, m, "cot order")
                    if m + D < M:
                        _prove(prod[m + D] >= cons[m], i, c, m,
                               "cot latch overwritten before consumption")
            for m in range(M):
                _prove(fdone[i][c][m] < bdone[i][c][m], i, c, m,
                       "backward before its own forward")
                if wdone is not None:
                    _prove(bdone[i][c][m] < wdone[i][c][m], i, c, m,
                           "weight-grad before its input-grad")
    for i in range(S):  # ring-slot + cot-stash reuse, per chunk
        for c in range(V):
            for m in range(M - ring):
                _prove(fdone[i][c][m + ring] > retire[i][c][m], i, c, m,
                       "ring slot reused while occupant still in flight")
                if wdone is not None:
                    _prove(bdone[i][c][m + ring] > wdone[i][c][m], i, c, m,
                           "cot stash overwritten before its W consumed it")


def build_schedule(S: int, M: int, V: int = 1,
                   schedule: str = "1f1b") -> Schedule1F1B:
    """Build and VERIFY the lockstep timetable for S pipe devices, M
    microbatches, and V interleaved chunks per device (virtual stages;
    logical stage ``c·S + i`` lives on device i as chunk c).
    ``schedule`` picks the discipline: ``"1f1b"`` (one joint backward
    tick per microbatch) or ``"zb"`` (zero-bubble: the backward splits
    into an input-grad B tick and a deferred weight-grad W tick, and
    the dependency-free W work fills idle ticks — above all the drain,
    ZB-H1-style).

    Placement is dependency-driven lockstep greedy list-scheduling.
    Because no single greedy discipline wins across (S, M, V) — the
    1F1B backward-first rule is best for V ≤ 2, forward-first (memory
    gates throttling) often wins at deeper interleave — the builder
    tries a small PORTFOLIO (backward-first / forward-first × latch
    depth D ∈ {1, 2}; for zb, B>F>W vs B>W>F) and keeps the timetable
    with the fewest ticks.  Readiness = upstream forward / downstream
    cotangent placed at a strictly earlier tick, plus the resource
    gates that bound the runtime's buffers: the per-chunk input-ring
    slot gate (in-flight ≤ min(S, M) per chunk; for zb a slot retires
    at W, not B), the depth-D latch gate (a producer may not send value
    m until its consumer consumed m−D), and for zb the cot-stash gate
    (B(m) may not overwrite the stash slot of m−ring before W(m−ring)
    read it).

    For V = 1 the 1F1B backward-first/D=1 member reproduces the classic
    warmup/steady/cooldown sequence and the canonical 2(M+S-1) ticks;
    for V > 1 the fill/drain bubble shrinks toward (S-1)/V chunk-ticks
    per side — the Megatron interleaving effect.  The zb timetable runs
    3·V·M cheaper actions instead of 2·V·M, trading tick count for
    near-zero idle: its drain is W work, not waiting (the returned
    ``utilization``/``idle_ticks`` report the achieved occupancy).

    The builder then PROVES the chosen placement safe for the runtime's
    fixed-size buffers via :func:`_verify_placement` — the dependency
    oracle tests can (and do) feed corrupted placements.
    """
    if S < 2:
        raise ValueError(f"1F1B needs >= 2 pipeline stages, got {S}")
    if M < 1:
        raise ValueError(f"need >= 1 microbatch, got {M}")
    if V < 1:
        raise ValueError(f"need >= 1 chunk per device, got {V}")
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}; pick one of "
            f"{SCHEDULES}")
    zb = schedule == "zb"

    ring = min(S, M)
    # portfolio: D > 1 only helps interleaved placements; keep V = 1 on
    # the canonical single-latch schedule.  Ties on tick count break
    # toward the placement with fewer in-flight microbatches (less
    # stash memory) — e.g. a forward-greedy member that merely matches
    # backward-first on ticks must not win on memory-hungrier shape.
    if zb:
        prios = ["bfw", "bwf"]
    else:
        prios = ["bfirst", "ffirst"]
    variants = [(p, 1) for p in prios] if V == 1 else \
        [(p, d) for d in (1, 2) for p in prios]
    best = best_key = None
    for prio, depth in variants:
        placed = _place(S, M, V, ring, depth, prio, zb=zb)
        if placed is None:
            continue
        fdone_v, bdone_v, wdone_v, ticks_v, max_if_v = placed
        key = (ticks_v, max_if_v)
        if best_key is None or key < best_key:
            best_key = key
            best = (fdone_v, bdone_v, wdone_v, ticks_v, max_if_v, depth)
    if best is None:
        raise RuntimeError(
            f"{schedule} schedule failed to converge (S={S}, M={M}, V={V})")
    fdone, bdone, wdone, T, max_in_flight, D = best

    _verify_placement(S, M, V, ring, D, fdone, bdone, wdone)

    # ---- timetable arrays from the placement
    shape = (T, S)
    is_fwd = np.zeros(shape, bool)
    is_bwd = np.zeros(shape, bool)
    is_w = np.zeros(shape, bool)
    fwd_mb = np.zeros(shape, np.int32)
    bwd_mb = np.zeros(shape, np.int32)
    w_mb = np.zeros(shape, np.int32)
    fwd_chunk = np.zeros(shape, np.int32)
    bwd_chunk = np.zeros(shape, np.int32)
    w_chunk = np.zeros(shape, np.int32)
    for i in range(S):
        for c in range(V):
            for m in range(M):
                tf, tb = fdone[i][c][m], bdone[i][c][m]
                is_fwd[tf, i], fwd_mb[tf, i], fwd_chunk[tf, i] = True, m, c
                is_bwd[tb, i], bwd_mb[tb, i], bwd_chunk[tb, i] = True, m, c
                if wdone is not None:
                    tw = wdone[i][c][m]
                    is_w[tw, i], w_mb[tw, i], w_chunk[tw, i] = True, m, c

    # receiver-side latch tables: device i latches the incoming
    # activation when its ring-left neighbor fired a forward — into the
    # same chunk, or chunk c+1 across the S-1 -> 0 wrap (the final
    # logical stage's output latches nowhere: it is consumed by the
    # head on device S-1 itself).  Cotangents mirror this to the left.
    # Latch indices are FLAT: chunk·D + (mb mod D).
    recv_act = np.zeros(shape, bool)
    recv_act_ix = np.zeros(shape, np.int32)
    recv_cot = np.zeros(shape, bool)
    recv_cot_ix = np.zeros(shape, np.int32)
    recv_act[:, 1:] = is_fwd[:, :-1]
    recv_act_ix[:, 1:] = fwd_chunk[:, :-1] * D + fwd_mb[:, :-1] % D
    wrap = is_fwd[:, S - 1] & (fwd_chunk[:, S - 1] < V - 1)
    recv_act[:, 0] = wrap
    recv_act_ix[:, 0] = np.where(
        wrap, (fwd_chunk[:, S - 1] + 1) * D + fwd_mb[:, S - 1] % D, 0)
    recv_cot[:, :-1] = is_bwd[:, 1:]
    recv_cot_ix[:, :-1] = bwd_chunk[:, 1:] * D + bwd_mb[:, 1:] % D
    wrap_b = is_bwd[:, 0] & (bwd_chunk[:, 0] > 0)
    recv_cot[:, S - 1] = wrap_b
    recv_cot_ix[:, S - 1] = np.where(
        wrap_b, (bwd_chunk[:, 0] - 1) * D + bwd_mb[:, 0] % D, 0)

    return Schedule1F1B(
        is_fwd, is_bwd, fwd_mb, bwd_mb, fwd_chunk, bwd_chunk,
        (fwd_mb % ring).astype(np.int32), (bwd_mb % ring).astype(np.int32),
        (fwd_chunk * D + fwd_mb % D).astype(np.int32),
        (bwd_chunk * D + bwd_mb % D).astype(np.int32),
        recv_act, recv_act_ix, recv_cot, recv_cot_ix,
        ring, V, D, max_in_flight,
        is_w, w_mb, w_chunk, (w_mb % ring).astype(np.int32),
        schedule,
    )


def _place(S, M, V, ring, D, prio, zb: bool = False):
    """One greedy lockstep placement: returns ``(fdone, bdone, wdone,
    ticks, max_in_flight)`` (tick of each action, [device][chunk][mb];
    peak stashed microbatches on any device; ``wdone`` is None unless
    ``zb``) or None on non-convergence.  ``prio`` picks which ready
    action a device fires: ``bfirst`` retires the oldest ready backward
    (1F1B discipline), ``ffirst`` advances the oldest ready forward and
    lets the memory gates force backwards (depth-first, better at deep
    interleave); the zb disciplines are ``bfw`` (B > F > W: keep the
    pipe fed, W genuinely fills idle ticks) and ``bwf`` (B > W > F:
    retire stash slots eagerly)."""
    fdone = [[[-1] * M for _ in range(V)] for _ in range(S)]
    bdone = [[[-1] * M for _ in range(V)] for _ in range(S)]
    wdone = [[[-1] * M for _ in range(V)] for _ in range(S)] if zb else None
    retire = wdone if zb else bdone  # what frees an input-ring slot

    def f_ready(i, c, m, t):
        if fdone[i][c][m] >= 0:
            return False
        # upstream activation: left neighbor same chunk, or the S-1 -> 0
        # chunk wrap; chunk 0 on device 0 embeds (always ready)
        if i > 0:
            if not 0 <= fdone[i - 1][c][m] < t:
                return False
        elif c > 0:
            if not 0 <= fdone[S - 1][c - 1][m] < t:
                return False
        # ring-slot gate: the slot's previous occupant must be retired
        # (backward for 1F1B; the deferred weight-grad for zb, which
        # re-reads the stashed input)
        prev = m - ring
        if prev >= 0 and retire[i][c][prev] < 0:
            return False
        # forwards of a chunk run in m order (keeps the in-flight window
        # contiguous, which is what makes m % ring collision-free)
        if m > 0 and fdone[i][c][m - 1] < 0:
            return False
        # depth-D latch gate: my activation m-D for this chunk must be
        # consumed before value m lands — the dynamic counterpart of
        # the classic warmup cap S-1-i
        if m >= D:
            if i < S - 1:
                if not 0 <= fdone[i + 1][c][m - D] < t:
                    return False
            elif c < V - 1:
                if not 0 <= fdone[0][c + 1][m - D] < t:
                    return False
        return True

    def b_ready(i, c, m, t):
        if bdone[i][c][m] >= 0 or fdone[i][c][m] < 0:
            return False
        if not fdone[i][c][m] < t:
            return False
        # zb cot-stash gate: B(m) banks its cotangent at slot m % ring,
        # whose previous occupant must have been consumed by its W
        if zb:
            prev = m - ring
            if prev >= 0 and wdone[i][c][prev] < 0:
                return False
        # depth-D latch gate for the cotangent channel (mirror of f_ready)
        if m >= D:
            if i > 0:
                if not 0 <= bdone[i - 1][c][m - D] < t:
                    return False
            elif c > 0:
                if not 0 <= bdone[S - 1][c - 1][m - D] < t:
                    return False
        if i == S - 1 and c == V - 1:
            return True  # loss cotangent is local (own fwd checked above)
        if i < S - 1:
            return 0 <= bdone[i + 1][c][m] < t
        return 0 <= bdone[0][c + 1][m] < t  # 0 -> S-1 chunk wrap

    def w_ready(i, c, m, t):
        # weight-grad: needs only its own B (stashed input + cotangent
        # both local), run in m order per chunk so the stash ring stays
        # a contiguous window
        if wdone[i][c][m] >= 0:
            return False
        if not 0 <= bdone[i][c][m] < t:
            return False
        return m == 0 or wdone[i][c][m - 1] >= 0

    total = S * V * M
    placed_f = placed_b = placed_w = 0
    w_target = total if zb else 0
    t = 0
    # the interleaved critical path alone is 2·S·V ticks (one full
    # logical-pipeline traversal each way), so the non-convergence cap
    # must scale with V·(M+S), not M+S — at S=8, M=1, V=4 the feasible
    # schedule needs exactly 64 ticks.  zb places 3·V·M actions, so its
    # cap scales with the larger action count too.
    cap = (6 if zb else 4) * V * (M + S) + 8
    while placed_f < total or placed_b < total or placed_w < w_target:
        if t > cap:
            return None
        # decide every device against PRE-tick state, commit after
        chosen = []
        for i in range(S):
            pick_b = pick_f = pick_w = None
            for m in range(M):
                for c in reversed(range(V)):
                    if b_ready(i, c, m, t):
                        pick_b = ("B", c, m)
                        break
                if pick_b:
                    break
            for m in range(M):
                for c in range(V):
                    if f_ready(i, c, m, t):
                        pick_f = ("F", c, m)
                        break
                if pick_f:
                    break
            if zb:
                for m in range(M):
                    for c in range(V):
                        if w_ready(i, c, m, t):
                            pick_w = ("W", c, m)
                            break
                    if pick_w:
                        break
            if prio == "bfirst":
                pick = pick_b or pick_f
            elif prio == "ffirst":
                pick = pick_f or pick_b
            elif prio == "bfw":
                pick = pick_b or pick_f or pick_w
            else:  # bwf
                pick = pick_b or pick_w or pick_f
            chosen.append(pick)
        for i, pick in enumerate(chosen):
            if pick is None:
                continue
            act, c, m = pick
            if act == "F":
                fdone[i][c][m] = t
                placed_f += 1
            elif act == "B":
                bdone[i][c][m] = t
                placed_b += 1
            else:
                wdone[i][c][m] = t
                placed_w += 1
        t += 1

    # peak stashed microbatches on any device (fwd done, not yet
    # retired — at B for 1F1B, at W for zb)
    max_if = 0
    for i in range(S):
        events = []
        for c in range(V):
            for m in range(M):
                events.append((fdone[i][c][m], 1))
                events.append((retire[i][c][m], -1))
        events.sort()
        cur = 0
        for _, d in events:
            cur += d
            max_if = max(max_if, cur)
    return fdone, bdone, wdone, t, max_if


class LocalPipe:
    """All ``S`` pipe devices of a schedule in this process: the
    hand-offs move tensors between their buffers.  Pass it as the
    ``mesh`` of :func:`pipeline_grads_1f1b` (or of the LM wiring); the
    stage params then carry every device's block on their leading dim.
    It holds one data row (no ``batch_axis``)."""

    def __init__(self, S: int):
        if S < 1:
            raise ValueError(f"need >= 1 pipe device, got {S}")
        self.S = S
        self.devices = tuple(range(S))

    def shift(self, sends: list, step: int) -> list:
        """What each device receives when every device sends its tensor
        ``step`` devices on (+1 the next, -1 the previous, in ring
        order)."""
        return [sends[(i - step) % self.S] for i in self.devices]

    def pipe_sum(self, trees: list):
        """The sum of one tree a device, in device order."""
        total = trees[0]
        for t in trees[1:]:
            total = accum(total, t)
        return total

    def norm_sq(self, name: str, sq: torch.Tensor) -> torch.Tensor:
        return sq  # every stage's block is here


class GroupPipe:
    """This rank as the pipe device at its index on ``axis`` of
    ``mesh``: the hand-offs are ring hops over the axis's process group
    (:func:`.collectives.ring_shift_start`), every rank every tick."""

    def __init__(self, mesh: Mesh, axis: str = PIPE_AXIS):
        self.mesh, self.axis = mesh, axis
        self.S = mesh.axis_size(axis)
        self.devices = (mesh.axis_index(axis),)
        self._group = mesh.sub(axis)

    def shift(self, sends: list, step: int) -> list:
        return list(collectives.ring_shift_start(
            sends, self.mesh, self.axis, reverse=step < 0).wait())

    def pipe_sum(self, trees: list):
        (tree,) = trees
        return collectives.psum(tree, self._group)

    def norm_sq(self, name: str, sq: torch.Tensor) -> torch.Tensor:
        """A leaf's sum of squares over its blocks: the stage leaves'
        over the pipe ranks."""
        return (collectives.psum(sq, self._group)
                if name.startswith(STAGES) else sq)


class _Device:
    """One pipe device's buffers in a run: its stage params, the
    activation and cotangent latches (``V D`` slots each), the input
    ring and, under zb, the cotangent stash (``V`` x ``ring``), and its
    accumulated gradients and loss."""

    def __init__(self, i: int, sp: dict, sched: "Schedule1F1B"):
        V, D = sched.n_chunks, sched.latch_depth
        self.i, self.sp = i, sp
        self.h_act = [None] * (V * D)
        self.h_cot = [None] * (V * D)
        self.ring = [[None] * sched.ring for _ in range(V)]
        self.cotstash = [[None] * sched.ring for _ in range(V)]
        self.g_sp = [None] * V
        self.g_out = None
        self.loss = None


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_(True)


def _filled(grads: Optional[dict], like: dict) -> dict:
    """``grads`` with every missing or ``None`` entry a zero of
    ``like``'s."""
    grads = grads or {}
    return {k: torch.zeros_like(v) if grads.get(k) is None else grads[k]
            for k, v in like.items()}


def pipeline_grads_1f1b(
    stage_fn: Callable,
    embed_fn: Callable,
    head_fn: Callable,
    mesh,
    axis: str = PIPE_AXIS,
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
    interleave: int = 1,
    schedule: str = "1f1b",
):
    """Build ``run(stacked_params, outer, inputs, labels) -> (loss,
    stage_grads, outer_grads)`` running the full forward and backward of
    the 1F1B (or ``schedule="zb"``) timetable.

    * ``stage_fn(stage_params, x) -> y`` keeps the activation's shape
      (a three-argument stage receives the logical stage ``c S + i``);
    * ``embed_fn(outer, inputs_mb) -> x0`` runs at logical stage 0;
    * ``head_fn(outer, y, labels_mb) -> scalar`` at the last logical
      stage: the microbatch's mean loss.  The run's loss is the mean over
      microbatches, and the gradients are those of that mean.

    ``mesh`` is a :class:`..mesh.Mesh` with a ``pipe`` axis (this rank
    is one pipe device, :class:`GroupPipe`) or a :class:`LocalPipe`.
    ``stacked_params`` carries the local devices' blocks on its leading
    dim (1 on a rank, S for a ``LocalPipe``), then ``(V, ...)`` with
    ``interleave=V``; ``inputs``/``labels`` are this rank's rows.
    ``stage_grads`` come back in the same layout; ``outer_grads`` are
    summed over the pipe devices (the embedding's part from device 0,
    the head's from device S - 1).  ``batch_axis`` averages the loss and
    every gradient over that axis of the mesh."""
    if isinstance(mesh, LocalPipe):
        if batch_axis is not None:
            raise ValueError("a LocalPipe holds one data row: batch_axis "
                             "needs a process-group mesh")
        pipe, bmesh = mesh, None
    else:
        pipe = GroupPipe(mesh, axis)
        bmesh = None if batch_axis is None else mesh.sub(batch_axis)
    S = pipe.S
    M = num_microbatches or S
    V = interleave
    zb = schedule == "zb"
    sched = build_schedule(S, M, V, schedule=schedule)
    with_stage = _accepts_stage(stage_fn)

    def chunk(sp: dict, c: int) -> dict:
        return sp if V == 1 else {k: v[c] for k, v in sp.items()}

    def run(stacked_params, outer, inputs, labels):
        b = inputs.shape[0]
        if b % M:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        mb_in = inputs.reshape(M, b // M, *inputs.shape[1:])
        mb_lab = labels.reshape(M, b // M, *labels.shape[1:])
        with torch.no_grad():
            zero_act = torch.zeros_like(embed_fn(outer, mb_in[0]))
        # d(mean over microbatches) / d(microbatch loss)
        seed = torch.tensor(1.0 / M, dtype=torch.float32,
                            device=zero_act.device)
        devs = [_Device(i, {k: v[j] for k, v in stacked_params.items()},
                        sched) for j, i in enumerate(pipe.devices)]

        def is_last(d, c):
            return d.i == S - 1 and c == V - 1

        def recompute(d, c, s, m):
            """The stage, and the head at the last logical stage, re-run
            from the stashed input with a graph on leaves: (output, x,
            stage leaves, outer leaves or None).  Every backward flavour
            records this same graph."""
            x = _leaf(d.ring[c][s])
            pc = {k: _leaf(v) for k, v in chunk(d.sp, c).items()}
            og = ({k: _leaf(v) for k, v in outer.items()}
                  if is_last(d, c) else None)
            with torch.enable_grad():
                y = (stage_fn(pc, x, c * S + d.i) if with_stage
                     else stage_fn(pc, x))
                if og is not None:
                    y = head_fn(og, y, mb_lab[m])
            return y, x, pc, og

        def pull(y, cot, x, pc, og, want_x, want_params):
            """The gradients of ``y`` fed ``cot`` that are asked for:
            (input, stage dict, outer dict or None)."""
            targets = []
            if want_params:
                targets += list(pc.values())
                if og is not None:
                    targets += list(og.values())
            if want_x:
                targets.append(x)
            gs = torch.autograd.grad(y, targets, cot, allow_unused=True)
            gx = gs[-1] if want_x else None
            if not want_params:
                return gx, None, None
            g_st = dict(zip(pc, gs[:len(pc)]))
            g_out = (None if og is None else
                     dict(zip(og, gs[len(pc):len(pc) + len(og)])))
            return gx, g_st, g_out

        def embed_grads(m, gx):
            og = {k: _leaf(v) for k, v in outer.items()}
            with torch.enable_grad():
                x0 = embed_fn(og, mb_in[m])
            gs = torch.autograd.grad(x0, list(og.values()), gx,
                                     allow_unused=True)
            return dict(zip(og, gs))

        def bank(d, c, g_st, g_out):
            d.g_sp[c] = accum(d.g_sp[c], g_st)
            d.g_out = accum(d.g_out, g_out)

        def fwd_tick(d, t):
            i = d.i
            m, c = int(sched.fwd_mb[t, i]), int(sched.fwd_chunk[t, i])
            with torch.no_grad():
                if i == 0 and c == 0:
                    x_in = embed_fn(outer, mb_in[m])
                else:
                    x_in = d.h_act[sched.fwd_latch[t, i]]
                pc = chunk(d.sp, c)
                y = (stage_fn(pc, x_in, c * S + i) if with_stage
                     else stage_fn(pc, x_in))
            d.ring[c][sched.fwd_slot[t, i]] = x_in
            return y

        def bwd_tick(d, t):
            i = d.i
            m, c = int(sched.bwd_mb[t, i]), int(sched.bwd_chunk[t, i])
            s = sched.bwd_slot[t, i]
            y, x, pc, og = recompute(d, c, s, m)
            last = is_last(d, c)
            cot = seed if last else d.h_cot[sched.bwd_latch[t, i]]
            if last:
                d.loss = accum(d.loss, y.detach())
            if zb:  # input cotangent only; bank the cotangent for W
                gx, _, _ = pull(y, cot, x, pc, og, True, False)
                d.cotstash[c][s] = None if last else cot
                return gx
            gx, g_st, g_out = pull(y, cot, x, pc, og, True, True)
            if i == 0 and c == 0:
                g_out = accum(g_out, embed_grads(m, gx))
            bank(d, c, g_st, g_out)
            return gx

        def w_tick(d, t):
            i = d.i
            m, c = int(sched.w_mb[t, i]), int(sched.w_chunk[t, i])
            s = sched.w_slot[t, i]
            y, x, pc, og = recompute(d, c, s, m)
            cot = seed if is_last(d, c) else d.cotstash[c][s]
            first = i == 0 and c == 0
            gx, g_st, g_out = pull(y, cot, x, pc, og, first, True)
            if first:
                g_out = accum(g_out, embed_grads(m, gx))
            bank(d, c, g_st, g_out)

        for t in range(sched.ticks):
            acts, cots = [], []
            for d in devs:
                y = gx = zero_act
                if sched.is_fwd[t, d.i]:
                    y = fwd_tick(d, t)
                elif sched.is_bwd[t, d.i]:
                    gx = bwd_tick(d, t)
                elif zb and sched.is_w[t, d.i]:
                    w_tick(d, t)
                acts.append(y)
                cots.append(gx)
            recv_a = pipe.shift(acts, 1)
            recv_c = pipe.shift(cots, -1)
            for d, ra, rc in zip(devs, recv_a, recv_c):
                if sched.recv_act[t, d.i]:
                    d.h_act[sched.recv_act_ix[t, d.i]] = ra
                if sched.recv_cot[t, d.i]:
                    d.h_cot[sched.recv_cot_ix[t, d.i]] = rc

        zero = torch.zeros((), dtype=torch.float32, device=zero_act.device)
        loss = div_const(pipe.pipe_sum(
            [zero if d.loss is None else d.loss for d in devs]), M)
        g_out = pipe.pipe_sum([_filled(d.g_out, outer) for d in devs])
        per_dev = []
        for d in devs:
            if V == 1:
                per_dev.append(_filled(d.g_sp[0], d.sp))
            else:
                chunks = [_filled(d.g_sp[c], chunk(d.sp, c))
                          for c in range(V)]
                per_dev.append({k: torch.stack([g[k] for g in chunks])
                                for k in d.sp})
        g_st = {k: torch.stack([g[k] for g in per_dev])
                for k in stacked_params}
        if bmesh is not None:  # DP composition: mean over the data rows
            loss = collectives.pmean(loss, bmesh)
            g_out = collectives.pmean(g_out, bmesh)
            g_st = collectives.pmean(g_st, bmesh)
        return loss, g_st, g_out

    run.schedule = sched
    run.utilization = sched.utilization
    run.pipe = pipe
    return run


def make_train_step_1f1b(
    stage_fn: Callable,
    embed_fn: Callable,
    head_fn: Callable,
    optimizer: Optimizer,
    mesh,
    axis: str = PIPE_AXIS,
    num_microbatches: Optional[int] = None,
    batch_axis: Optional[str] = None,
    interleave: int = 1,
    input_key: str = "tokens",
    label_key: Optional[str] = None,
    schedule: str = "1f1b",
    seed: int = 0,
):
    """``step_fn(state, batch) -> (state, metrics)``: a 1F1B (or
    ``schedule="zb"``) training step.  ``state.params`` is the flat split
    tree (``outer/``, ``stages/``: ``lm_pp_1f1b``'s ``split_params``
    builds it), this rank's block of the stage leaves; the stage
    gradients stay on their pipe device and the outer ones are summed
    over the pipe (:func:`pipeline_grads_1f1b`), so the update is local.
    ``label_key`` defaults to ``input_key`` (the LM's next-token loss
    reads the shifted inputs).  (The JAX function returns
    ``compile_for(state)``; an eager step has nothing to compile.)"""
    run = pipeline_grads_1f1b(
        stage_fn, embed_fn, head_fn, mesh, axis=axis,
        num_microbatches=num_microbatches, batch_axis=batch_axis,
        interleave=interleave, schedule=schedule)

    def body(state: TrainState, batch, seeds, scalars):
        outer, stages = split_tree(state.params)
        loss, g_st, g_out = run(stages, outer, batch[input_key],
                                batch[label_key or input_key])
        with torch.no_grad(), sharded_norms(run.pipe.norm_sq):
            new_params, new_opt = optimizer.rule(
                state.params, join_tree(g_out, g_st), state.opt_state,
                scalars)
        return TrainState(params=new_params, opt_state=new_opt,
                          model_state=state.model_state,
                          step=state.step + 1), {"loss": loss}

    return device_loop(body, optimizer, seed=seed, accum_steps=1, mesh=None,
                       steps_per_call=1)
