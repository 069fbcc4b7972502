"""Slot-based continuous-batching engine for the port's ``TransformerLM``.

Port of ``fluxdistributed_tpu/serve/engine.py`` for the dense layout:

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

PyTorch runs eagerly, so there are no compiled programs to pool:
``compile_stats`` keeps the JAX engine's keys (at 0) for the
scheduler's gauges and reports the decode kernel's launch count.

Greedy decoding is token-for-token identical to sequential
:func:`..models.generate` (the golden parity test).  Temperature
sampling draws from each request's own seeded CPU ``torch.Generator``,
so a request's stream depends on its seed and its logits only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer_lm import (KV_QUANTS, DecodeCache, TransformerLM,
                                     make_decode_cache)
from ..ops.flash_decode import flash_decode
from .cache_layout import DenseLayout, reserved_kv_bytes

__all__ = ["LMEngine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (128, 512, 2048)


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
        self.small = small    # the carried batch-1 cache
        self.padded = 0       # padded tokens computed so far
        self.rid = rid        # request trace id (host metadata only)


class LMEngine:
    """Slot KV cache + prefill/decode for continuous batching.

    ``model`` is the port's ``TransformerLM`` on its device; the engine
    casts its floating parameters to the compute dtype ONCE, in place
    (the per-step forward would otherwise cast every weight each step).
    Not thread-safe by itself — the scheduler serialises all calls onto
    one loop thread.

    * ``buckets`` — prefill shapes; clamped to ``max_len`` and always
      topped out AT ``max_len``.
    * ``prefill_chunk`` — prompt positions per prefill chunk; chunks
      interleave with decode ticks (whole-bucket prefill without it).
    * ``kv_dtype`` — ``None`` (the model dtype), ``"int8"`` or ``"fp8"``.
    """

    def __init__(self, model: TransformerLM, *, max_slots: int = 8,
                 max_len: int = 1024,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if not model.use_rope and (model.max_len is None
                                   or model.max_len < max_len):
            raise ValueError(
                f"use_rope=False needs the model's learned positional "
                f"table to cover the engine's max_len ({max_len}); got "
                f"model.max_len={model.max_len}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        kv_quant = kv_dtype or "none"
        if kv_quant not in KV_QUANTS:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r} "
                f"(None|{'|'.join(q for q in KV_QUANTS if q != 'none')})")
        self.kv_quant = kv_quant
        self.layout_name = "dense"
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_chunk = min(prefill_chunk, max_len) if prefill_chunk else None
        #: chunked prefill advances through prefill_begin/prefill_step
        self.prefill_incremental = self.prefill_chunk is not None
        self.buckets = tuple(sorted({int(b) for b in buckets
                                     if 0 < int(b) < max_len} | {max_len}))
        model.to(model.dtype)
        model.eval()
        self.model = model
        self.device = model.device
        #: per-slot per-layer KV rows: sinks + window for a windowed
        #: ring (exact), max_len otherwise
        self.kv_rows_per_slot = (
            max_len if model.window is None
            else min(model.window + model.sinks, max_len))
        self.layout = DenseLayout(max_slots, self.kv_rows_per_slot,
                                  kv_quant=kv_quant)
        self.cache = make_decode_cache(model, max_slots, max_len, kv_quant)
        # per-slot decode state: input tokens stay on the device between
        # steps; temperatures and sampling generators are host state
        self._tok = torch.zeros(max_slots, dtype=torch.int64,
                                device=self.device)
        self._temp: List[float] = [0.0] * max_slots
        self._keys: List[Optional[torch.Generator]] = [None] * max_slots
        #: all-slot decode steps run so far
        self.decode_steps = 0

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

    def _sample(self, logits: torch.Tensor, temps, keys) -> torch.Tensor:
        """Greedy (temperature 0) or softmax draw per row: f32 logits /
        temperature, sampled with the row's own CPU generator."""
        nxt = logits.argmax(dim=-1)
        for s, (temp, key) in enumerate(zip(temps, keys)):
            if temp > 0:
                p = torch.softmax(logits[s].float() / max(temp, 1e-6), dim=-1)
                nxt[s] = torch.multinomial(p.cpu(), 1, generator=key)[0]
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
        self.pick_bucket(prompt_len)
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {prompt_len + max_new_tokens} exceeds the engine's slot "
                f"cache (max_len={self.max_len}). Lower max_new_tokens or "
                "rebuild the engine with a larger max_len.")

    def can_admit(self, prompt: Sequence[int], max_new_tokens: int) -> bool:
        """Admission gate beyond free slots (always open for dense)."""
        return self.layout.can_admit(prompt, max_new_tokens)

    def prefill_begin(self, slot: int, tokens: Sequence[int],
                      temperature: float, key: torch.Generator,
                      max_new_tokens: Optional[int] = None,
                      rid: Optional[str] = None) -> _PrefillState:
        """Start prefilling ``tokens`` into ``slot``; the scheduler
        advances the returned state with :meth:`prefill_step`.
        ``max_new_tokens`` is accepted for the scheduler's calling
        convention (the dense layout reserves nothing per request)."""
        small = make_decode_cache(self.model, 1, self.max_len, self.kv_quant)
        return _PrefillState(slot, tokens, temperature, key, small, rid=rid)

    def prefill_step(self, st: _PrefillState):
        """Advance one chunk (or, without chunking, the whole prompt).
        Returns ``(first_token | None, real_tokens, padded_tokens)``."""
        if not self.prefill_incremental:
            return self._prefill_whole(st), st.plen, self.pick_bucket(st.plen)
        chunk = self.prefill_chunk
        nvalid = min(chunk, st.plen - st.pos)
        padded = np.zeros((1, chunk), np.int64)
        padded[0, :nvalid] = st.tokens[st.pos:st.pos + nvalid]
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
    def step_decode(self) -> np.ndarray:
        """One step over all slots; returns ``next[S]`` on the host (the
        scheduler's stop checks and streaming).  Parked rows compute
        too; their output is discarded."""
        logits = self.model(self._tok[:, None], self.cache)
        self._tok = self._sample(logits[:, 0], self._temp, self._keys)
        self.decode_steps += 1
        return self._tok.cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        """Park a freed slot: zero its cursor (so it cannot creep toward
        int32 wraparound) and its temperature.  Parked slots still ride
        the decode step; their writes past the cache end drop and their
        outputs are discarded."""
        self.cache.index[slot] = 0
        self._temp[slot] = 0.0
        self._keys[slot] = None

    # ---- reporting --------------------------------------------------------

    def pool_stats(self) -> dict:
        return self.layout.stats()

    def kv_cache_bytes(self) -> dict:
        """KV accounting: ``reserved`` measured off the cache buffers
        (K/V plus quantisation scales), ``live`` (== reserved for the
        dense layout) and ``predicted`` by the layout's sizing model."""
        total = sum(t.numel() * t.element_size() for t in self.cache.buffers())
        m = self.model
        predicted = reserved_kv_bytes(
            self.layout, m.depth, m.num_kv_heads or m.num_heads,
            m.dim // m.num_heads,
            torch.empty((), dtype=m.dtype).element_size())
        return {"reserved": total, "live": total, "predicted": predicted}

    def compile_stats(self) -> dict:
        """The JAX engine's compile-count keys (eager PyTorch compiles
        nothing, so they read 0) plus ``decode_kernel_launches``, the
        flash-decode kernel's launch count."""
        return {"decode_compiles": 0, "insert_compiles": 0,
                "prefill_compiles": 0, "aot_programs": 0,
                "decode_kernel_launches": flash_decode.launches}
