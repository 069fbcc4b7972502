"""Checkpoint save / load / resume.

Port of ``fluxdistributed_tpu/train/checkpoint.py``.  The JAX package
writes orbax checkpoints, which the port cannot read (orbax imports
jax); the port's format is its own and keeps the JAX contract:

* ``step_<n>/state.pt`` holds the full ``TrainState`` as a nested dict
  of host tensors (``params``, ``opt_state``, ``model_state``) and the
  ``step`` int, written by ``torch.save`` and read back with
  ``weights_only=True``; ``step_<n>/meta.json`` says how the optimizer
  state was laid out (``zero1_ranks``: the rank count of a ZeRO-1
  state, else null);
* writes are atomic: a save stages in ``step_<n>.tmp.stage`` and renames
  it to ``step_<n>`` only once fully on disk, so a ``kill -9`` mid-write
  leaves the previous checkpoint as the latest; stale ``.tmp.``/``.old.``
  debris is swept by the next save, and an overwrite moves the old
  directory aside before the publish rename;
* ``block=False`` snapshots the state to host memory before it returns
  (device tensors are copied into pinned buffers on the current stream,
  so a later step or graph replay that overwrites the state in place,
  being queued behind the copies, cannot change the snapshot) and writes
  on a background thread; the publish rename happens at
  :func:`wait_for_pending` (the next save, or the end of ``train``), and
  a failed write or commit is dropped rather than wedging later saves;
* I/O is retried through :func:`..faults.with_retries`, and the
  ``checkpoint_save`` / ``checkpoint_load`` fault sites fire inside the
  retried attempt;
* on the ranks of a mesh, replicated leaves are written once, by rank 0;
  a ZeRO-1 state (``zero1=True``: every optimizer-state tensor is this
  rank's 1/N slice of a flat zero-padded buffer, :mod:`..parallel.zero1`
  and :mod:`..parallel.zero1_fused`) is all-gathered first, so the file
  holds each whole padded buffer, as the JAX checkpoint holds the global
  array.  A load slices this rank's part back out;
  :func:`load_checkpoint_elastic` re-pads the buffers for another rank
  count (the pad is zeros and inert, at the end of each buffer);
* a state of blocks (FSDP, tensor parallelism, their hybrid, a layout:
  ``specs=``, a ``TrainState`` of :class:`~..sharding.P`) is
  all-gathered to global shapes first and written once, by rank 0, as
  the JAX checkpoint holds each global array; a load cuts this rank's
  blocks for the target's specs, so it restores onto any layout and
  rank count (or onto a plain replicated state);
* ``RESUME.json`` (``write_``/``read_``/``clear_resume_manifest``) is
  the manifest a preempted run leaves beside its checkpoint, written
  atomically, with the JAX package's keys.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .. import faults
from ..mesh import Mesh
from ..parallel.dp import TrainState
from ..parallel.zero1 import restore_layout

__all__ = [
    "RESUME_MANIFEST",
    "clear_resume_manifest",
    "latest_step",
    "load_checkpoint",
    "load_checkpoint_elastic",
    "read_resume_manifest",
    "save_checkpoint",
    "wait_for_pending",
    "write_resume_manifest",
]

_STEP_RE = re.compile(r"^step_(\d+)$")
_STATE_FILE = "state.pt"
_META_FILE = "meta.json"
_FIELDS = ("params", "opt_state", "model_state")

#: filename of the preemption manifest inside a checkpoint directory
RESUME_MANIFEST = "RESUME.json"

# (writer, commit) pairs of block=False saves still in flight; at most
# one at a time: save_checkpoint drains it before the next, and train()
# drains at its end.  _SAVE_LOCK spans a whole save (drain -> snapshot
# -> write or append) so two savers cannot race their sweeps and writes.
_PENDING: list = []
_PENDING_LOCK = threading.Lock()
_SAVE_LOCK = threading.Lock()


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _lead(mesh: Optional[Mesh] = None) -> bool:
    """Rank 0 of the mesh (or of the default group), or no group."""
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def _as_tree(state) -> dict:
    if isinstance(state, TrainState):
        return {"params": state.params, "opt_state": state.opt_state,
                "model_state": state.model_state, "step": int(state.step)}
    if isinstance(state, dict):
        return state
    raise TypeError(f"save_checkpoint takes a TrainState or a dict, got "
                    f"{type(state).__name__}")


def _map(fn, tree):
    """``fn`` on every tensor leaf of a tree of dicts, lists and tuples;
    ``None`` and other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class _Writer:
    """A background write: ``thread`` runs ``job`` and keeps its error."""

    def __init__(self, job):
        self.error: Optional[BaseException] = None

        def run():
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — raised at the drain
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True,
                                       name="checkpoint-writer")
        self.thread.start()


def wait_for_pending() -> None:
    """Block until any in-flight ``block=False`` save is on disk and
    published (the staging dir renamed to ``step_<n>``).  A write or
    commit that failed raises here, and is dropped: its staging dir is
    garbage the next save sweeps, so it cannot wedge later saves."""
    with _PENDING_LOCK:
        while _PENDING:
            writer, commit = _PENDING[-1]
            writer.thread.join()
            try:
                if writer.error is not None:
                    raise writer.error
                commit()
            finally:
                _PENDING.pop()


def _commit_rename(tmp: str, final: str) -> None:
    """The atomic-publish rename, apart so that a test can interpose on
    exactly this boundary."""
    os.rename(tmp, final)


def _commit(tmp: str, final: str, overwrite: bool) -> None:
    """Publish a fully written staging dir as ``step_<n>``.  A previous
    ``final`` (a re-save of the step) is moved aside before the publish
    rename and deleted after, so either the old or the new complete
    checkpoint exists under the committed name at every instant."""
    if not overwrite and os.path.exists(final):
        shutil.rmtree(tmp, ignore_errors=True)
        raise FileExistsError(
            f"checkpoint {final} exists and overwrite=False")
    trash = None
    if os.path.exists(final):
        trash = f"{final}.old.{os.getpid()}"
        os.rename(final, trash)
    _commit_rename(tmp, final)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


def _snapshot(tree: dict):
    """Host copies of every tensor leaf, and the CUDA event after the
    last device copy (or ``None``).  Device tensors go to pinned buffers
    by copies queued on the current stream, so whatever later work on
    that stream writes the state in place runs after them."""
    on_card = []

    def one(x):
        x = x.detach()
        if x.device.type == "cuda":
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x, non_blocking=True)
            on_card.append(x.device)
            return out
        return x.clone(memory_format=torch.contiguous_format)

    host = _map(one, tree)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(on_card[0]))
    return host, event


def _sweep(directory: str) -> None:
    """Remove staging and aside debris: a dead predecessor's, or ours
    from a failed attempt (the pending list was just drained, so none is
    owned by a live write)."""
    root = os.path.abspath(directory)
    for name in os.listdir(root):
        for marker in (".tmp.", ".old."):
            stem, sep, _ = name.partition(marker)
            if sep and _STEP_RE.match(stem):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
                break


def save_checkpoint(state, directory: str, step: int, overwrite: bool = True,
                    block: bool = True, *, mesh: Optional[Mesh] = None,
                    zero1: bool = False, specs=None) -> str:
    """Write ``state`` (a ``TrainState`` or a dict of tensors) at
    ``directory/step_<n>``; returns that path.

    Write-then-rename (see the module docstring): the staging dir
    ``step_<n>.tmp.stage`` becomes ``step_<n>`` only once fully written.
    ``block=False`` returns once the host snapshot is queued; the write
    runs on a background thread and is published at
    :func:`wait_for_pending`.  ``overwrite=False`` refuses an existing
    ``step_<n>`` with ``FileExistsError`` at the publish (at the drain,
    for ``block=False``), leaving it as it was.

    ``mesh``: every rank of it calls this; rank 0 writes.  ``zero1``:
    the optimizer state is ZeRO-1-sharded over ``mesh`` and is
    all-gathered (a collective) before the write.  ``specs``: the state
    is this rank's blocks by those specs, gathered to global shapes (a
    collective) before the write.  A blocking save on several ranks
    returns on every rank after rank 0 has published, and a refusal
    raises on every rank."""
    tree = dict(_as_tree(state))
    if specs is not None:
        if mesh is None:
            raise ValueError("specs= needs the mesh the state is sharded "
                             "over")
        from ..parallel.fsdp import gather_state

        for f in _FIELDS:
            tree[f] = gather_state(tree[f], getattr(specs, f), mesh)
    if zero1:
        if mesh is None:
            raise ValueError("zero1=True needs the mesh the optimizer "
                             "state is sharded over")
        from ..parallel import collectives

        tree["opt_state"] = collectives.all_gather(tree["opt_state"], mesh)
    final = _step_dir(directory, step)
    tmp = f"{final}.tmp.stage"
    meta = {"format": 1, "step": int(step),
            "zero1_ranks": mesh.size if zero1 else None}
    lead = _lead(mesh)
    ranks = mesh is not None and mesh.size > 1
    with _SAVE_LOCK:
        wait_for_pending()
        job = None
        if lead:
            host, event = _snapshot(tree)
            os.makedirs(os.path.abspath(directory), exist_ok=True)
            _sweep(directory)

            def write():
                faults.fire("checkpoint_save")
                if os.path.exists(tmp):  # a failed attempt's partial write
                    shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                torch.save(host, os.path.join(tmp, _STATE_FILE))
                with open(os.path.join(tmp, _META_FILE), "w") as f:
                    json.dump(meta, f)

            def job():
                if event is not None:
                    event.synchronize()
                faults.with_retries(
                    write, tries=3, backoff=0.2, site="checkpoint_save",
                    retryable=lambda e: isinstance(e, OSError))

        if not block:
            if job is not None:
                with _PENDING_LOCK:
                    _PENDING.append((_Writer(job), lambda: _commit(
                        tmp, final, overwrite)))
            return final
        if not ranks:
            job()
            _commit(tmp, final, overwrite)
            return final
        # several ranks: every rank decides a refusal before rank 0 can
        # publish, and rank 0's failure is raised after the barriers, so
        # that no rank is left waiting in one
        refused = not overwrite and os.path.exists(final)
        err = None
        if job is not None:
            try:
                job()
            except Exception as e:  # noqa: BLE001 — re-raised below
                err = e
        dist.barrier(group=mesh.group)
        if job is not None and err is None:
            if refused:
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                try:
                    _commit(tmp, final, overwrite)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    err = e
        dist.barrier(group=mesh.group)
        if err is not None:
            raise err
        if refused:
            raise FileExistsError(
                f"checkpoint {final} exists and overwrite=False")
    return final


def latest_step(directory: str) -> Optional[int]:
    """Largest ``step_<n>`` present in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def _read(directory: str, step: Optional[int]):
    """``(saved tree, meta)`` of ``step`` (default: the latest), read
    inside the retried ``checkpoint_load`` attempt."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)

    def attempt():
        faults.fire("checkpoint_load")
        tree = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                          weights_only=True)
        with open(os.path.join(path, _META_FILE)) as f:
            return tree, json.load(f)

    return faults.with_retries(
        attempt, tries=3, backoff=0.2, site="checkpoint_load",
        retryable=lambda e: isinstance(e, OSError))


def _restore(saved: dict, meta: dict, target, mesh: Optional[Mesh],
             elastic: bool, specs=None):
    """``saved`` in ``target``'s structure, each tensor leaf with the
    target leaf's dtype, device and memory layout.  Optimizer-state
    leaves of a ZeRO-1 checkpoint are whole padded buffers: this rank's
    slice is cut at the target's slice length; at another rank count the
    buffer is first trimmed or zero-padded (``elastic``) or refused.
    With ``specs`` (the target's, a tree beside it) each global leaf is
    cut to this rank's block first."""
    from ..sharding import P, local_block

    saved_ranks = meta.get("zero1_ranks")
    rank, size = (mesh.rank, mesh.size) if mesh is not None else (0, 1)

    def leaf(path, s, t, spec):
        where = "/".join(path)
        if not isinstance(s, torch.Tensor):
            raise ValueError(f"checkpoint leaf {where} is not a tensor")
        if saved_ranks is not None and path[0] == "opt_state":
            if t.ndim != 1:
                raise ValueError(
                    f"leaf {where}: the checkpoint holds a ZeRO-1 state "
                    f"(flat buffers) and the target's leaf is "
                    f"{tuple(t.shape)}")
            n = t.shape[0] * size
            if s.shape[0] != n:
                if not elastic:
                    raise ValueError(
                        f"leaf {where}: saved at {saved_ranks} rank(s) "
                        f"({s.shape[0]} elements), restoring at {size} "
                        f"({n}); use load_checkpoint_elastic")
                # the pad is zeros at the end: trim or extend it
                out = torch.zeros(n, dtype=s.dtype)
                m = min(n, s.shape[0])
                out[:m] = s[:m]
                s = out
            s = s[rank * t.shape[0]:(rank + 1) * t.shape[0]]
        if isinstance(spec, P) and any(e is not None for e in spec):
            s = local_block(s, spec, mesh)
        if tuple(s.shape) != tuple(t.shape):
            raise ValueError(f"leaf {where}: saved shape {tuple(s.shape)}, "
                             f"the target's {tuple(t.shape)}")
        return restore_layout(s.to(device=t.device, dtype=t.dtype,
                                   copy=True), t)

    def sub(spec, key):
        return None if spec is None or isinstance(spec, P) else spec[key]

    def walk(path, s, t, spec=None):
        if isinstance(t, dict):
            if not isinstance(s, dict):
                raise ValueError(f"checkpoint node {'/'.join(path)} is not "
                                 "a dict")
            missing = [k for k in t if k not in s]
            if missing:
                raise ValueError(
                    f"checkpoint lacks {len(missing)} leaves the restoring "
                    f"state needs (e.g. {'/'.join(path + (missing[0],))}) "
                    "— was it saved by another model or optimizer?")
            return {k: walk(path + (k,), s[k], v, sub(spec, k))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if not isinstance(s, (list, tuple)) or len(s) != len(t):
                raise ValueError(f"checkpoint node {'/'.join(path)} does "
                                 "not match the target's sequence")
            return type(t)(walk(path + (str(i),), a, b, sub(spec, i))
                           for i, (a, b) in enumerate(zip(s, t)))
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return leaf(path, s, t, spec)
        return s

    if isinstance(target, TrainState):
        fields = {f: walk((f,), saved[f], getattr(target, f),
                          None if specs is None else getattr(specs, f))
                  for f in _FIELDS}
        return TrainState(**fields, step=int(saved["step"]))
    return walk((), saved, target, specs)


def load_checkpoint(directory: str, target=None, step: Optional[int] = None,
                    mesh: Optional[Mesh] = None, specs=None):
    """Restore a checkpoint onto the structure of ``target``.

    ``target=None`` returns the raw tree as saved (nested dicts of host
    tensors and the ``step`` int; a ZeRO-1 state's optimizer buffers
    whole) — what an inference tool that needs only ``["params"]``
    reads.  ``step=None`` picks the latest.  With a target (a
    ``TrainState`` or a dict), each leaf takes the target leaf's dtype,
    device and layout, in new tensors (a state that a captured step
    owns is copied into its buffers by the step's next call, never
    rebound under it); a ZeRO-1 target's optimizer state is this rank
    of ``mesh``'s slice, and a checkpoint saved at another rank count is
    refused (:func:`load_checkpoint_elastic` takes it).  ``specs``: the
    target is a state of blocks by those specs (every global leaf is cut
    to this rank of ``mesh``'s block)."""
    saved, meta = _read(directory, step)
    if target is None:
        return saved
    return _restore(saved, meta, target, mesh, elastic=False, specs=specs)


def load_checkpoint_elastic(directory: str, target,
                            step: Optional[int] = None,
                            mesh: Optional[Mesh] = None, specs=None):
    """Restore a checkpoint saved at another rank count (the elastic
    resume: the next grant had a different number of GPUs).  The one
    rank-count-dependent layout is ZeRO-1's flat padded optimizer
    state: each buffer is trimmed or zero-padded to the new count's
    padded length, which is sound because the pad is identically zero
    and inert through every elementwise update rule (both lengths hold
    every real entry), and then this rank's slice is cut.  Replicated
    leaves need no adaptation."""
    faults.fire("resume")
    saved, meta = _read(directory, step)
    return _restore(saved, meta, target, mesh, elastic=True, specs=specs)


# ------------------------------------------------------------ manifest


def _manifest_path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), RESUME_MANIFEST)


def write_resume_manifest(directory: str, manifest: dict) -> str:
    """Atomically (write-then-rename) persist the preemption manifest;
    rank 0 writes, every rank may call."""
    path = _manifest_path(directory)
    if not _lead():
        return path
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_resume_manifest(directory: str) -> Optional[dict]:
    """The manifest a preempted run left, or None (absent or corrupt: a
    half-written manifest is pre-rename garbage, never read)."""
    try:
        with open(_manifest_path(directory)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def clear_resume_manifest(directory: str) -> None:
    """Remove the manifest: a run that completes must not leave a
    mid-run cursor for the next resume to trust."""
    if not _lead():
        return
    try:
        os.remove(_manifest_path(directory))
    except OSError:
        pass

