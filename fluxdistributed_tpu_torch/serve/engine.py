"""Slot-based continuous-batching engine for the port's ``TransformerLM``.

Port of ``fluxdistributed_tpu/serve/engine.py``.  Two cache layouts
(``serve/cache_layout.py``):

* ``layout="dense"`` (default) — every slot owns ``max_len`` (or
  ``sinks + window``) rows per layer; HBM scales with capacity.
* ``layout="paged"`` — a shared pool of ``kv_blocks`` fixed-size blocks
  per layer and one int32 page table per slot, kept as device data and
  updated by whole-row copies, so HBM scales with live tokens and freed
  blocks return to the pool on EOS.  Prefill runs in fixed-size chunks
  written straight through the page table (no splice); with
  ``prefix_cache=True`` completed prompt blocks are hash-keyed and
  refcounted so shared prefixes prefill once.  On the GPU every decode
  attention walks the page table in the paged flash-decode kernel.

Dense prefill and decode:

* **Bucketed prefill** — a batch-1 cache is prefilled over the prompt
  padded up to a shape bucket (or in fixed ``prefill_chunk`` pieces)
  and then spliced into the request's slot row.  Right-padding is safe:
  a position's cache row is a function of the position alone, the
  causal mask admits only positions <= the query's, and a pad row is
  overwritten by the real token for its position before it could
  become attendable; a windowed ring gates pads out of its write with
  the call's real token count (``valid_len``).
* **Fixed-slot decode** — ONE single-token step over all ``max_slots``
  cache rows, each slot at its own cursor; on the GPU every layer's
  attention runs the flash-decode kernel.  Finished requests free their
  slot; admissions splice a prefilled cache into a free row mid-flight.

On the GPU the decode step is one CUDA graph replay, the counterpart of
the JAX engine's one compiled decode program: the model's forward over
the engine's token buffer, its in-place cache writes and the greedy
``argmax``, captured after the first (eager) decode step.  The host
keeps the page-table bookkeeping and its pinned row copies before the
replay, and samples the rows with a temperature from the replay's
logits after it.  Prefill stays eager (its shapes vary by bucket), and
so does the decode step on the CPU.  ``compile_stats`` keeps the JAX
engine's keys for the scheduler's gauges (``decode_compiles`` counts
the capture; the others read 0) and reports the decode kernels' launch
counts.

Greedy decoding is token-for-token identical to sequential
:func:`..models.generate` (the golden parity test).  Temperature
sampling draws from each request's own seeded CPU ``torch.Generator``,
so a request's stream depends on its seed and its logits only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..fake import is_fake
from ..models.transformer_lm import (KV_QUANTS, DecodeCache, PagedCache,
                                     TransformerLM, make_decode_cache,
                                     make_paged_cache)
from ..ops.flash_decode import flash_decode, flash_decode_paged
from ..parallel.graphs import Graph
from .cache_layout import DenseLayout, PagedLayout, reserved_kv_bytes

__all__ = ["LMEngine", "DEFAULT_BUCKETS", "DEFAULT_KV_BLOCK_SIZE"]

DEFAULT_BUCKETS = (128, 512, 2048)
DEFAULT_KV_BLOCK_SIZE = 16


class _PrefillState:
    """In-flight prefill for one slot — the scheduler advances it one
    chunk per call so a long prompt interleaves with decode ticks."""

    __slots__ = ("slot", "tokens", "temperature", "key", "plen", "pos",
                 "small", "padded", "rid")

    def __init__(self, slot, tokens, temperature, key, small, rid=None):
        self.slot = slot
        self.tokens = [int(t) for t in tokens]
        self.temperature = float(temperature)
        self.key = key
        self.plen = len(self.tokens)
        self.pos = 0          # next prompt position to process
        self.small = small    # dense: the carried batch-1 cache
        self.padded = 0       # padded tokens computed so far
        self.rid = rid        # request trace id (host metadata only)


@torch.no_grad()
def _cast_floating(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """``model.to(dtype)`` for its floating parameters and buffers, in
    place (each parameter keeps its identity), also on a fake model (a
    priced engine, :mod:`..obs.pricing`), which ``Module.to`` refuses."""
    for mod in model.modules():
        for p in mod._parameters.values():
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
        for name, b in mod._buffers.items():
            if b is not None and b.is_floating_point() and b.dtype != dtype:
                mod._buffers[name] = b.to(dtype)


class LMEngine:
    """Slot KV cache + prefill/decode for continuous batching.

    ``model`` is the port's ``TransformerLM`` on its device; the engine
    casts its floating parameters to the compute dtype ONCE, in place
    (the per-step forward would otherwise cast every weight each step).
    Not thread-safe by itself — the scheduler serialises all calls onto
    one loop thread.

    * ``buckets`` — dense prefill shapes; clamped to ``max_len`` and
      always topped out AT ``max_len``.
    * ``prefill_chunk`` — prompt positions per prefill chunk; chunks
      interleave with decode ticks.  Paged prefill is always chunked
      (default 128); dense prefill is whole-bucket without it.
    * ``kv_dtype`` — ``None`` (the model dtype), ``"int8"`` or ``"fp8"``.
    * ``layout`` — ``"dense"`` or ``"paged"``; ``kv_block_size`` and
      ``kv_blocks`` size the paged pool (``kv_blocks=None``: full
      capacity, ``max_slots`` worst-case slots).
    * ``prefix_cache`` — paged, plain attention only: completed prompt
      blocks are shared by later prompts with the same prefix.
    * ``cuda_graph`` — on the GPU, replay the decode step as one CUDA
      graph (the default); ``False`` runs it eagerly (the comparison).
    """

    def __init__(self, model: TransformerLM, *, max_slots: int = 8,
                 max_len: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 layout: str = "dense",
                 kv_block_size: int = DEFAULT_KV_BLOCK_SIZE,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = False, cuda_graph: bool = True):
        if getattr(model, "moe_every", 0):
            raise ValueError(
                "the serving engine supports dense models only (MoE decode "
                "routes per-token expert dispatch; build the model with "
                "moe_every=0)")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache layout {layout!r} (dense|paged)")
        if not model.use_rope and (model.max_len is None
                                   or model.max_len < max_len):
            raise ValueError(
                f"use_rope=False needs the model's learned positional "
                f"table to cover the engine's max_len ({max_len}); got "
                f"model.max_len={model.max_len}")
        if prefix_cache and layout != "paged":
            raise ValueError(
                "prefix_cache=True needs layout='paged' (the dense layout "
                "has no shareable blocks)")
        if prefix_cache and model.window is not None:
            raise ValueError(
                "prefix_cache is not supported with sliding-window "
                "attention: ring eviction makes a stored block's contents "
                "depend on everything decoded after it, so equal prefixes "
                "stop implying equal blocks. Drop window= or prefix_cache.")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        kv_quant = kv_dtype or "none"
        if kv_quant not in KV_QUANTS:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r} "
                f"(None|{'|'.join(q for q in KV_QUANTS if q != 'none')})")
        self.kv_quant = kv_quant
        self.layout_name = layout
        self.max_slots = max_slots
        self.max_len = max_len
        if layout == "paged":
            self.prefill_chunk: Optional[int] = min(prefill_chunk or 128,
                                                    max_len)
            self.buckets: tuple = ()
        else:
            self.prefill_chunk = (min(prefill_chunk, max_len)
                                  if prefill_chunk else None)
            self.buckets = tuple(sorted({int(b) for b in buckets
                                         if 0 < int(b) < max_len} | {max_len}))
        #: chunked prefill (paged always; dense with prefill_chunk=)
        #: advances through prefill_begin/prefill_step
        self.prefill_incremental = self.prefill_chunk is not None
        _cast_floating(model, model.dtype)
        model.eval()
        self.model = model
        self.device = model.device
        #: per-slot per-layer KV rows: sinks + window for a windowed
        #: ring (exact), max_len otherwise
        self.kv_rows_per_slot = (
            max_len if model.window is None
            else min(model.window + model.sinks, max_len))
        if layout == "paged":
            if kv_block_size < 1:
                raise ValueError(
                    f"kv_block_size must be >= 1, got {kv_block_size}")
            pages_per_slot = -(-self.kv_rows_per_slot // kv_block_size)
            if kv_blocks is None:
                kv_blocks = max_slots * pages_per_slot
            self.layout = PagedLayout(
                max_slots, self.kv_rows_per_slot, kv_block_size, kv_blocks,
                prefix_cache=prefix_cache, kv_quant=kv_quant)
            self.cache = make_paged_cache(model, max_slots, max_len,
                                          kv_block_size, kv_blocks, kv_quant)
        else:
            self.layout = DenseLayout(max_slots, self.kv_rows_per_slot,
                                      kv_quant=kv_quant)
            self.cache = make_decode_cache(model, max_slots, max_len,
                                           kv_quant)
        # paged host mirrors: which slots are decoding, and each slot's
        # next write position (drives just-in-time block binding)
        self._decoding: set = set()
        self._host_pos = [0] * max_slots
        # per-slot decode state: input tokens stay on the device between
        # steps; temperatures and sampling generators are host state
        self._tok = torch.zeros(max_slots, dtype=torch.int64,
                                device=self.device)
        self._temp: List[float] = [0.0] * max_slots
        self._keys: List[Optional[torch.Generator]] = [None] * max_slots
        #: all-slot decode steps run so far
        self.decode_steps = 0
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        #: the captured decode step (a :class:`..parallel.graphs.Graph`)
        self.decode_graph: Optional[Graph] = None

    # ---- device work ------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, padded: np.ndarray, plen: int, cache0: DecodeCache):
        """Prefill ``padded`` [1, T] into the batch-1 ``cache0`` (in
        place); ``plen`` — the call's REAL token count — is also the
        windowed ring's write gate.  Returns the f32 logits at the last
        real position."""
        toks = torch.as_tensor(padded, dtype=torch.int64, device=self.device)
        logits = self.model(toks, cache0, valid_len=plen)
        return logits[:, plen - 1].float()

    @torch.no_grad()
    def _insert(self, small: DecodeCache, slot: int, plen: int) -> None:
        """Splice a prefilled batch-1 cache into slot row ``slot``.  The
        cursor is set to the TRUE prompt length (the prefill ran over the
        padded bucket); ring entries holding pad positions (>= plen) are
        scrubbed back to -1, so the slot holds exactly what an unpadded
        prefill of ``plen`` tokens would."""
        big = self.cache
        for dst, src in zip(big.buffers(), small.buffers()):
            dst[slot].copy_(src[0])
        big.index[slot] = plen
        if big.slot_pos is not None:
            sp = small.slot_pos[0]
            big.slot_pos[slot] = torch.where(sp < plen, sp,
                                             torch.full_like(sp, -1))

    @torch.no_grad()
    def _chunk(self, padded: np.ndarray, slot: int, start: int, nvalid: int,
               arm: bool):
        """One paged prefill chunk straight into ``slot``'s pages.

        A batch-1 view of the slot's row (the shared pools pass through)
        runs the model at chunk shape: its cursor starts at ``start``, its
        write gate is open and its ring positions at or past ``start``
        are scrubbed to -1 (drift garbage from decode ticks).  The
        writeback pins the slot's cursor to ``start + nvalid`` (host
        truth: the all-slot decode step may have drifted it, and a padded
        chunk overshoots), keeps its ring positions below that, and opens
        its write gate on the final chunk (``arm``) — until then decode
        ticks drop its writes.  Returns the f32 logits at the last real
        position."""
        big = self.cache
        dev = self.device
        sp = None
        if big.slot_pos is not None:
            row = big.slot_pos[slot:slot + 1]
            sp = torch.where(row < start, row, torch.full_like(row, -1))
        view = PagedCache(
            k=big.k, v=big.v, k_scale=big.k_scale, v_scale=big.v_scale,
            index=torch.full((1,), start, dtype=torch.int32, device=dev),
            page_table=big.page_table[slot:slot + 1],
            slot_live=torch.ones(1, dtype=torch.int32, device=dev),
            slot_pos=sp, block_size=big.block_size, kv_quant=big.kv_quant)
        toks = torch.as_tensor(padded, dtype=torch.int64, device=dev)
        logits = self.model(toks, view, valid_len=nvalid)
        end = start + nvalid
        big.index[slot] = end
        big.slot_live[slot] = int(arm)
        if sp is not None:
            big.slot_pos[slot] = torch.where(
                view.slot_pos[0] < end, view.slot_pos[0],
                torch.full_like(view.slot_pos[0], -1))
        return logits[:, nvalid - 1].float()

    def _bind(self, slot: int) -> None:
        """Copy slot ``slot``'s host page-table row to the device: ONE
        whole-row copy however many pages just changed.  The row is
        staged in pinned memory so the copy is asynchronous: a copy from
        pageable memory would wait for the whole queued step."""
        row = torch.tensor(self.layout.slot_pages[slot], dtype=torch.int32)
        if self.device.type == "cuda" and not is_fake(row):
            row = row.pin_memory()
        self.cache.page_table[slot].copy_(row, non_blocking=True)

    def _release(self, slot: int) -> None:
        """Park a freed paged slot on the device: cursor and write gate
        to 0, page-table row and ring positions to -1 — writes drop and
        reads are masked."""
        c = self.cache
        c.index[slot] = 0
        c.slot_live[slot] = 0
        c.page_table[slot] = -1
        if c.slot_pos is not None:
            c.slot_pos[slot] = -1

    @staticmethod
    def _draw(logits: torch.Tensor, temp: float, key) -> int:
        """A softmax draw from one row: f32 logits / temperature, sampled
        with the row's own CPU generator."""
        p = torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)
        return int(torch.multinomial(p.cpu(), 1, generator=key)[0])

    def _sample(self, logits: torch.Tensor, temps, keys) -> torch.Tensor:
        """Greedy (temperature 0) or softmax draw (:meth:`_draw`) per
        row."""
        nxt = logits.argmax(dim=-1)
        for s, (temp, key) in enumerate(zip(temps, keys)):
            if temp > 0:
                nxt[s] = self._draw(logits[s], temp, key)
        return nxt

    # ---- host-side API (called by the scheduler loop thread) --------------

    def pick_bucket(self, plen: int) -> int:
        """Smallest bucket covering ``plen``."""
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(
            f"prompt length {plen} exceeds the largest prefill bucket "
            f"({self.buckets[-1]}). Either shorten the prompt or construct "
            f"the engine with a larger bucket (buckets={self.buckets}, "
            f"max_len={self.max_len}).")

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Admission-time shape checks — every error is actionable."""
        if prompt_len < 1:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if self.buckets:
            self.pick_bucket(prompt_len)
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {prompt_len + max_new_tokens} exceeds the engine's slot "
                f"cache (max_len={self.max_len}). Lower max_new_tokens or "
                "rebuild the engine with a larger max_len.")
        if self.layout_name == "paged":
            need = self.layout.pages_for(prompt_len + max_new_tokens)
            total = self.layout.pool.num_blocks
            if need > total:
                raise ValueError(
                    f"request needs {need} KV blocks at its token budget "
                    f"(prompt {prompt_len} + max_new_tokens "
                    f"{max_new_tokens}, block size "
                    f"{self.layout.block_size}) but the pool only has "
                    f"{total}. Lower max_new_tokens, or rebuild the engine "
                    f"with kv_blocks >= {need}.")

    def can_admit(self, prompt: Sequence[int], max_new_tokens: int) -> bool:
        """Admission gate beyond free slots: always open for dense; the
        paged layout admits only when the block pool covers the
        request's WORST-CASE footprint on top of every admitted slot's,
        so pool exhaustion shows as queueing, never as a stuck slot."""
        return self.layout.can_admit(prompt, max_new_tokens)

    def prefill_begin(self, slot: int, tokens: Sequence[int],
                      temperature: float, key: torch.Generator,
                      max_new_tokens: Optional[int] = None,
                      rid: Optional[str] = None) -> _PrefillState:
        """Start prefilling ``tokens`` into ``slot``; the scheduler
        advances the returned state with :meth:`prefill_step`.
        ``max_new_tokens`` sizes the paged worst-case reservation
        (default: the whole slot budget); the dense layout reserves
        nothing per request.  In the paged layout the longest cached
        prefix is claimed and its pages bound now, and prefill starts
        after it."""
        if self.layout_name == "dense":
            small = make_decode_cache(self.model, 1, self.max_len,
                                      self.kv_quant)
            return _PrefillState(slot, tokens, temperature, key, small,
                                 rid=rid)
        st = _PrefillState(slot, tokens, temperature, key, None, rid=rid)
        budget = (self.max_len - st.plen if max_new_tokens is None
                  else max_new_tokens)
        st.pos = self.layout.admit(slot, st.tokens, budget)
        if st.pos:
            self._bind(slot)  # one row copy however long the prefix
        self._host_pos[slot] = st.pos
        return st

    def prefill_step(self, st: _PrefillState):
        """Advance one chunk (or, without chunking, the whole prompt).
        Returns ``(first_token | None, real_tokens, padded_tokens)``."""
        if not self.prefill_incremental:
            return self._prefill_whole(st), st.plen, self.pick_bucket(st.plen)
        chunk = self.prefill_chunk
        nvalid = min(chunk, st.plen - st.pos)
        padded = np.zeros((1, chunk), np.int64)
        padded[0, :nvalid] = st.tokens[st.pos:st.pos + nvalid]
        if self.layout_name == "paged":
            return self._paged_step(st, padded, nvalid)
        start = st.pos
        if start + chunk > self.max_len:
            # a padded FINAL chunk would write past the batch-1 cache:
            # shift the window back instead — re-prefilled positions
            # rewrite identical K/V, pad rows land in [plen, max_len)
            start = self.max_len - chunk
            padded[0] = 0
            padded[0, :st.plen - start] = st.tokens[start:st.plen]
            nvalid_w = st.pos + nvalid - start
            st.small.index.fill_(start)
        else:
            nvalid_w = nvalid
        last = self._prefill(padded, nvalid_w, st.small)
        st.pos += nvalid
        st.padded += chunk
        if st.pos < st.plen:
            return None, nvalid, chunk
        self._insert(st.small, st.slot, st.plen)
        first = self._arm(st.slot, last, st.temperature, st.key)
        return first, nvalid, chunk

    def _paged_step(self, st: _PrefillState, padded: np.ndarray,
                    nvalid: int):
        """One paged chunk: bind the rows it covers, run it, and on the
        final chunk register the prompt's full blocks and arm decode."""
        chunk = self.prefill_chunk
        final = st.pos + nvalid >= st.plen
        if self.layout.alloc_rows(st.slot, st.pos + nvalid):
            self._bind(st.slot)
        last = self._chunk(padded, st.slot, st.pos, nvalid, final)
        st.pos += nvalid
        st.padded += chunk
        if not final:
            return None, nvalid, chunk
        self.layout.register_prompt(st.slot, st.tokens)
        self._host_pos[st.slot] = st.plen
        self._decoding.add(st.slot)
        return self._arm(st.slot, last, st.temperature, st.key), nvalid, chunk

    def _arm(self, slot: int, last_logits, temperature: float, key) -> int:
        """Sample the first token from the prefill logits and arm the
        slot's decode state."""
        first = int(self._sample(last_logits, [temperature], [key])[0])
        self._tok[slot] = first
        self._temp[slot] = float(temperature)
        self._keys[slot] = key
        return first

    def _prefill_whole(self, st: _PrefillState) -> int:
        """Whole-prompt path: one bucketed prefill spliced into the
        slot; returns the first token."""
        padded = np.zeros((1, self.pick_bucket(st.plen)), np.int64)
        padded[0, :st.plen] = st.tokens
        last = self._prefill(padded, st.plen, st.small)
        self._insert(st.small, st.slot, st.plen)
        return self._arm(st.slot, last, st.temperature, st.key)

    def prefill(self, slot: int, tokens: Sequence[int], temperature: float,
                key: torch.Generator):
        """Prefill ``tokens`` into slot ``slot`` and arm its decode
        state; returns ``(first_token, padded_tokens)``."""
        st = self.prefill_begin(slot, tokens, temperature, key)
        if not self.prefill_incremental:
            return self.prefill_step(st)[0], self.pick_bucket(st.plen)
        while True:
            first, _, _ = self.prefill_step(st)
            if first is not None:
                return first, st.padded

    @torch.no_grad()
    def _decode(self) -> torch.Tensor:
        """The device work of a decode step: the model over the token
        buffer (the cache written in place) and the greedy next tokens
        written back into it.  Returns the f32 logits [S, vocab]."""
        logits = self.model(self._tok[:, None], self.cache)[:, 0]
        self._tok.copy_(logits.argmax(dim=-1))
        return logits

    @torch.no_grad()
    def step_decode(self) -> np.ndarray:
        """One step over all slots; returns ``next[S]`` on the host (the
        scheduler's stop checks and streaming).  Parked rows compute
        too; their output is discarded.  In the paged layout each
        decoding slot's next write position is bound just in time
        (reservation guarantees the pool can serve it).  On the GPU the
        device work is one graph replay after the first step."""
        for slot in self._decoding:
            if self.layout.alloc_rows(slot, self._host_pos[slot] + 1):
                self._bind(slot)
            self._host_pos[slot] += 1
        if self.decode_graph is not None:
            logits = self.decode_graph.replay()
        else:
            logits = self._decode()
            if self.cuda_graph:
                # the eager step above was the capture's warm-up
                self.decode_graph = Graph(self._decode, "the decode step")
        for s, (temp, key) in enumerate(zip(self._temp, self._keys)):
            if temp > 0:
                self._tok[s] = self._draw(logits[s], temp, key)
        self.decode_steps += 1
        return self._tok.cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        """Park a freed slot: zero its cursor (so it cannot creep toward
        int32 wraparound) and its temperature.  Parked slots still ride
        the decode step; their writes drop and their outputs are
        discarded.  The paged layout also returns the slot's blocks to
        the pool (prefix-cached blocks stay reclaimable) and unbinds its
        page-table row."""
        if self.layout_name == "paged":
            self.layout.release(slot)
            self._release(slot)
            self._decoding.discard(slot)
            self._host_pos[slot] = 0
        else:
            self.cache.index[slot] = 0
        self._temp[slot] = 0.0
        self._keys[slot] = None

    # ---- reporting --------------------------------------------------------

    def pool_stats(self) -> dict:
        return self.layout.stats()

    def kv_cache_bytes(self) -> dict:
        """KV accounting: ``reserved`` measured off the cache buffers
        (K/V plus quantisation scales; the paged pools' scratch block is
        not counted), ``live`` (== reserved for the dense layout; the
        active share of the pool for paged) and ``predicted`` by the
        layout's sizing model."""
        total = sum(t.numel() * t.element_size() for t in self.cache.buffers())
        m = self.model
        predicted = reserved_kv_bytes(
            self.layout, m.depth, m.num_kv_heads or m.num_heads,
            m.dim // m.num_heads,
            torch.empty((), dtype=m.dtype).element_size())
        out = {"reserved": total, "live": total, "predicted": predicted}
        if self.layout_name == "paged":
            s = self.layout.stats()
            out["live"] = int(total * s["kv_blocks_active"]
                              / max(1, s["kv_blocks_total"]))
        return out

    def compile_stats(self) -> dict:
        """The JAX engine's compile-count keys (``decode_compiles``: the
        decode step's graph captures; the others 0: prefill and inserts
        run eagerly) plus ``decode_kernel_launches`` and
        ``paged_kernel_launches``, the two flash-decode kernels' launch
        counts."""
        stats = {"decode_compiles": int(self.decode_graph is not None),
                 "insert_compiles": 0,
                 "prefill_compiles": 0, "aot_programs": 0,
                 "decode_kernel_launches": flash_decode.launches,
                 "paged_kernel_launches": flash_decode_paged.launches}
        if self.layout_name == "paged":
            stats.update(bind_compiles=0, release_compiles=0)
        return stats
