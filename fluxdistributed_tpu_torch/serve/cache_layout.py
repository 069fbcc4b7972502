"""Cache-layout sizing for the serving engine: dense fixed slots vs a
paged block pool, and the KV byte model.

Copied from the JAX package's ``serve/cache_layout.py`` (pure host code,
kept as the port's own copy):

* :class:`DenseLayout` — each slot owns its rows for the engine's
  lifetime; HBM scales with capacity.
* :class:`PagedLayout` — a shared pool of fixed-size KV blocks plus a
  per-slot page table.  Blocks are bound as a request's cursor advances
  and returned on EOS, so the live KV footprint tracks live tokens.
  Completed prompt blocks are keyed by a prefix digest and refcounted
  (:class:`BlockPool`), so a shared system prompt prefills once.

Everything here is host bookkeeping (plain ints and dicts).  The device
side carries the page table as int32 data that the engine updates in
place.  Sharing is restricted to FULL, exact-match prompt blocks, and a
shared block is never written again: the divergence block is
re-prefilled into a fresh block (copy-on-write with no copy).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["BlockPool", "DenseLayout", "KV_STORE_BYTES", "PagedLayout",
           "kv_row_bytes", "prefix_digests", "reserved_kv_bytes"]


def prefix_digests(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chain digest per FULL block of ``tokens``: digest *i* commits to
    every token in blocks ``0..i`` (a prefix hash, not a content hash),
    so equal digests imply equal whole prefixes — the property that
    makes a cached block's K/V valid for a new request (K/V at position
    p depends on ALL tokens ≤ p)."""
    out: List[bytes] = []
    h = b""
    full = len(tokens) // block_size
    for i in range(full):
        blk = tokens[i * block_size:(i + 1) * block_size]
        m = hashlib.sha1(h)
        m.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                          for t in blk))
        h = m.digest()
        out.append(h)
    return out


#: bytes per stored K or V element under each quant scenario (None =
#: the model's compute itemsize); quantized scenarios additionally
#: carry a per-row-per-head f32 scale (``models.transformer_lm
#: .quantize_kv``)
KV_STORE_BYTES = {"none": None, "int8": 1, "fp8": 1}


def kv_row_bytes(hkv: int, head_dim: int, kv_quant: str,
                 compute_itemsize: int) -> int:
    """HBM bytes one cache row (K + V, all KV heads) costs per layer:
    stored values plus the sibling scale rows for quantized scenarios —
    the sizing model behind the engine's measured ``kv_cache_bytes``
    (the bytes-halved test pins the two against each other)."""
    if kv_quant not in KV_STORE_BYTES:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r} ({'|'.join(KV_STORE_BYTES)})")
    item = KV_STORE_BYTES[kv_quant] or compute_itemsize
    per = hkv * head_dim * item
    if KV_STORE_BYTES[kv_quant]:
        per += hkv * 4  # f32 scale per row per head
    return 2 * per  # K and V


def reserved_kv_bytes(layout, depth: int, hkv: int, head_dim: int,
                      compute_itemsize: int) -> int:
    """Total HBM bytes a layout's KV storage reserves across ``depth``
    layers — THE sizing model.  ``layout.reserved_rows()`` supplies the
    per-layer row count each layout actually allocates (dense: every
    slot's rows; paged: the whole block pool, shared), and
    :func:`kv_row_bytes` prices one row including the quantization
    scale leaves.  The engine's MEASURED ``kv_cache_bytes()`` is
    cross-checked against this figure (its ``predicted`` key; parity
    pinned by test in both layouts for every kv_quant scenario) so the
    accounting the fit checker and the benches report can never drift
    from the math admission control sizes pools with."""
    return depth * layout.reserved_rows() * kv_row_bytes(
        hkv, head_dim, layout.kv_quant, compute_itemsize)


class DenseLayout:
    """The original fixed-slot layout: each slot statically owns
    ``rows_per_slot`` contiguous KV rows per layer.  Admission never
    waits on memory — capacity IS ``max_slots`` — so the allocator
    surface is trivially permissive.  ``kv_quant`` records the storage
    scenario riding in the device cache (scale leaves live NEXT TO their
    K/V rows, same indexing) so stats and sizing math stay layout-aware.
    """

    name = "dense"

    def __init__(self, max_slots: int, rows_per_slot: int,
                 kv_quant: str = "none"):
        self.max_slots = max_slots
        self.rows_per_slot = rows_per_slot
        self.kv_quant = kv_quant

    def can_admit(self, prompt: Sequence[int], max_new_tokens: int) -> bool:
        return True

    def reserved_rows(self) -> int:
        """KV rows allocated per layer: every slot statically owns its
        full span for the engine's lifetime."""
        return self.max_slots * self.rows_per_slot

    def stats(self) -> dict:
        return {"kv_quant": self.kv_quant}


class BlockPool:
    """Free-list + refcount + prefix-cache bookkeeping for one shared
    pool of KV blocks (block ids ``0..num_blocks-1``, mirrored by every
    layer's device-side pool).

    Block states: **free** (on the free list), **active** (ref > 0,
    owned by ≥ 1 slot), **cached** (ref == 0 but registered under a
    prefix digest — reclaimable: it sits in an LRU and is evicted only
    when the free list runs dry).  ``available()`` counts free + cached
    — what an admission-time reservation can draw on.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need >= 1 KV block, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(num_blocks))
        self._ref: Dict[int, int] = {}
        self._digest_of: Dict[int, bytes] = {}
        self._by_digest: Dict[bytes, int] = {}
        # reclaimable cached blocks (ref == 0), oldest first
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ---- queries ----------------------------------------------------------

    def available(self) -> int:
        return len(self._free) + len(self._lru)

    def stats(self) -> dict:
        free, cached = len(self._free), len(self._lru)
        return {
            "kv_blocks_total": self.num_blocks,
            "kv_blocks_free": free,
            "kv_blocks_cached": cached,
            "kv_blocks_active": self.num_blocks - free - cached,
            "prefix_cache_hits": self.hits,
            "prefix_cache_misses": self.misses,
            "prefix_cache_evictions": self.evictions,
        }

    def peek(self, digests: Sequence[bytes]) -> Tuple[int, int]:
        """How far the cache covers ``digests``: ``(hits,
        hits_in_lru)`` — without claiming anything."""
        hits = in_lru = 0
        for d in digests:
            b = self._by_digest.get(d)
            if b is None:
                break
            hits += 1
            if b in self._lru:
                in_lru += 1
        return hits, in_lru

    # ---- transitions ------------------------------------------------------

    def claim(self, digests: Sequence[bytes]) -> List[int]:
        """Take a reference on the longest cached prefix of ``digests``
        and return the claimed block ids (counts hits/misses)."""
        out: List[int] = []
        for d in digests:
            b = self._by_digest.get(d)
            if b is None:
                break
            self._lru.pop(b, None)
            self._ref[b] = self._ref.get(b, 0) + 1
            out.append(b)
        self.hits += len(out)
        self.misses += len(digests) - len(out)
        return out

    def alloc(self) -> int:
        """One fresh block (ref = 1): the free list first, else evict
        the oldest reclaimable cached block.  Raises when the pool is
        truly exhausted — reservations (see :class:`PagedLayout`) are
        supposed to make that unreachable."""
        if self._free:
            b = self._free.popleft()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            d = self._digest_of.pop(b)
            self._by_digest.pop(d, None)
            self.evictions += 1
        else:
            raise RuntimeError(
                "KV block pool exhausted — admission reservation failed "
                "to hold blocks back (engine bug)")
        self._ref[b] = 1
        return b

    def register(self, block: int, digest: bytes) -> None:
        """Enter a completed prompt block into the prefix cache.  First
        writer wins: if the digest is already cached under another
        block, the duplicate is simply not registered."""
        if block in self._digest_of or digest in self._by_digest:
            return
        self._digest_of[block] = digest
        self._by_digest[digest] = block

    def release(self, block: int) -> None:
        """Drop one reference; at zero the block returns to the free
        list, or to the reclaimable LRU if it is prefix-cached."""
        n = self._ref.get(block, 0) - 1
        if n > 0:
            self._ref[block] = n
            return
        self._ref.pop(block, None)
        if block in self._digest_of:
            self._lru[block] = None
        else:
            self._free.append(block)


class PagedLayout:
    """Paged block-pool layout: host-side allocator + per-slot page
    bookkeeping, mirroring the device-side int32 page tables the model
    reads (``models/transformer_lm.py`` paged branch).

    ``rows_per_slot`` is the slot's LOGICAL row span (``max_len`` plain,
    ``sinks + window`` windowed) — rounded up to whole blocks it
    becomes ``r_pad = pages_per_slot * block_size``, the per-slot page
    count.  Windowed rings reuse their rows, so a slot can never need
    more than ``pages_per_slot`` blocks no matter how long it decodes.

    **Reservation discipline** (the admission-backpressure fix): every
    admitted slot records the worst-case blocks it may still allocate
    (``promised``).  ``can_admit`` only accepts a request when
    ``available - Σ promised`` covers its own worst case, so an admitted
    request can ALWAYS run to its token budget — block exhaustion shows
    up as queueing/backpressure at admission, never as a stuck active
    slot.
    """

    name = "paged"

    def __init__(self, max_slots: int, rows_per_slot: int, block_size: int,
                 num_blocks: int, prefix_cache: bool = False,
                 kv_quant: str = "none"):
        if block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {block_size}")
        self.max_slots = max_slots
        self.block_size = block_size
        self.rows_per_slot = rows_per_slot
        #: KV storage scenario: scale blocks mirror the K/V pools
        #: ([num_blocks, block_size, hkv] next to each pool) so block
        #: ids index values and scales identically
        self.kv_quant = kv_quant
        self.pages_per_slot = -(-rows_per_slot // block_size)
        self.r_pad = self.pages_per_slot * block_size
        self.prefix_enabled = prefix_cache
        self.pool = BlockPool(num_blocks)
        #: per-slot page → block id (-1 = unbound), a host mirror of the
        #: device page-table rows
        self.slot_pages: List[List[int]] = [
            [-1] * self.pages_per_slot for _ in range(max_slots)]
        self._allocated = [0] * max_slots  # bound page count (prefix incl.)
        self._promised = [0] * max_slots   # worst-case blocks still to bind
        # single-entry digest memo: can_admit re-runs for the SAME queue
        # head every scheduler tick (and admit then register_prompt
        # follow it), so without this each tick re-hashes the whole
        # prompt under the scheduler lock.  Keyed by IDENTITY — the
        # held reference keeps the id from being recycled by another
        # list — so a memo hit is O(1), not O(plen)
        self._memo: Tuple[Optional[Sequence[int]], List[bytes]] = (None, [])

    def _digests(self, tokens: Sequence[int]) -> List[bytes]:
        if self._memo[0] is not tokens:
            self._memo = (tokens, prefix_digests(tokens, self.block_size))
        return self._memo[1]

    # ---- sizing -----------------------------------------------------------

    def pages_for(self, ntokens: int) -> int:
        """Blocks needed to hold ``ntokens`` positions: row reuse caps
        the answer at ``pages_per_slot`` for windowed rings."""
        return -(-min(ntokens, self.r_pad) // self.block_size)

    def reserved_rows(self) -> int:
        """KV rows allocated per layer: the whole shared block pool
        (slots bind pool blocks; nothing is reserved per slot)."""
        return self.pool.num_blocks * self.block_size

    # ---- admission --------------------------------------------------------

    def can_admit(self, prompt: Sequence[int], max_new_tokens: int) -> bool:
        """Would admitting this request keep every already-admitted
        slot's worst case coverable?"""
        need = self.pages_for(len(prompt) + max_new_tokens)
        hits = in_lru = 0
        if self.prefix_enabled:
            hits, in_lru = self.pool.peek(
                self._digests(prompt)
                [: max(0, (len(prompt) - 1) // self.block_size)])
        promised = sum(self._promised)
        return (self.pool.available() - in_lru - promised) >= (need - hits)

    def admit(self, slot: int, prompt: Sequence[int],
              max_new_tokens: int) -> int:
        """Claim cached prefix blocks into ``slot`` and reserve its
        worst case; returns the position prefill starts from (0 when
        nothing was reusable).  The claim is capped so the LAST prompt
        token is always re-prefilled into a fresh block — its logits
        seed the first generated token, and the cap guarantees shared
        blocks are never written to (copy-on-write at the divergence
        block, with the "copy" being a fresh prefill)."""
        plen = len(prompt)
        claimed: List[int] = []
        if self.prefix_enabled:
            cap = max(0, (plen - 1) // self.block_size)
            claimed = self.pool.claim(self._digests(prompt)[:cap])
        pages = self.slot_pages[slot]
        for i, b in enumerate(claimed):
            pages[i] = b
        self._allocated[slot] = len(claimed)
        self._promised[slot] = (
            self.pages_for(plen + max_new_tokens) - len(claimed))
        return len(claimed) * self.block_size

    # ---- growth -----------------------------------------------------------

    def alloc_rows(self, slot: int, nrows: int) -> List[Tuple[int, int]]:
        """Bind fresh blocks so the slot covers ``nrows`` logical rows;
        returns the new ``(page, block)`` bindings for the engine to
        write into the device page tables."""
        target = self.pages_for(nrows)
        binds: List[Tuple[int, int]] = []
        pages = self.slot_pages[slot]
        while self._allocated[slot] < target:
            b = self.pool.alloc()
            page = self._allocated[slot]
            pages[page] = b
            binds.append((page, b))
            self._allocated[slot] += 1
            self._promised[slot] = max(0, self._promised[slot] - 1)
        return binds

    # ---- completion / teardown -------------------------------------------

    def register_prompt(self, slot: int, prompt: Sequence[int]) -> None:
        """After prefill completes, enter every FULL prompt block into
        the prefix cache (full = wholly covered by prompt positions, so
        its K/V can never be touched by this request's decode)."""
        if not self.prefix_enabled:
            return
        pages = self.slot_pages[slot]
        for i, d in enumerate(self._digests(prompt)):
            if pages[i] >= 0:
                self.pool.register(pages[i], d)

    def release(self, slot: int) -> None:
        """Return the slot's blocks to the pool (cached blocks drop a
        reference and stay reclaimable) and clear its reservation."""
        pages = self.slot_pages[slot]
        for i, b in enumerate(pages):
            if b >= 0:
                self.pool.release(b)
            pages[i] = -1
        self._allocated[slot] = 0
        self._promised[slot] = 0

    # ---- reporting --------------------------------------------------------

    def stats(self) -> dict:
        s = self.pool.stats()
        s["kv_blocks_promised"] = sum(self._promised)
        s["kv_quant"] = self.kv_quant
        return s
