"""Test/dev scaffolding for the serve stack: a deterministic pure-python
engine with the surface of :class:`~.engine.LMEngine` that the scheduler
calls.

A copy of ``fluxdistributed_tpu/serve/testing.py``.  The router's whole
contract — failover, drain ordering, rolling restarts — is about
processes and sockets, not about attention math, so its tests (and
``python -m fluxdistributed_tpu_torch.serve --fake-engine`` replica
fleets, and the router's ``--smoke``) run on :class:`FakeLMEngine`: no
model, no device, a scheduler tick costs ``step_delay`` seconds of
sleep.  The port's :class:`~.scheduler.Scheduler` drives it through the
same surface; the fake ignores the sampling key (a ``torch.Generator``).

The token stream is a **pure function of the prompt**: the first token
is a digest of the prompt, every later token increments it (mod vocab).
That makes cross-replica determinism an assertable invariant — a request
transparently retried on a *different* replica after a mid-burst kill
must produce byte-identical output, exactly the property a greedy real
engine has and the router's zero-failed-requests guarantee rides on.
"""

from __future__ import annotations

import time
from typing import List

__all__ = ["FakeLMEngine", "fake_tokens"]


def fake_tokens(prompt, n: int, vocab: int = 256) -> List[int]:
    """The exact stream any :class:`FakeLMEngine` produces for
    ``prompt`` — the oracle router tests compare failover output
    against."""
    first = (sum(int(t) for t in prompt) + len(prompt)) % vocab
    return [(first + i) % vocab for i in range(n)]


class FakeLMEngine:
    """Deterministic slot engine (the methods the
    :class:`~.scheduler.Scheduler` calls, nothing else).

    ``step_delay`` is a plain mutable attribute: tests raise it
    mid-flight to simulate a replica that goes slow or wedges after its
    first tokens (the router's fail-fast-after-first-token path).
    """

    def __init__(self, max_slots: int = 4, max_len: int = 512,
                 step_delay: float = 0.0, vocab: int = 256):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self.max_len = max_len
        self.step_delay = step_delay
        self.vocab = vocab
        self._last = [0] * max_slots
        self._live = [False] * max_slots

    # -- what the Scheduler calls ---------------------------------------
    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len < 1:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")

    def prefill(self, slot: int, prompt, temperature, key):
        first = fake_tokens(prompt, 1, self.vocab)[0]
        self._last[slot] = first
        self._live[slot] = True
        return first, len(prompt)  # (first token, "bucket" = real len)

    def step_decode(self):
        if self.step_delay:
            time.sleep(self.step_delay)
        out = []
        for s in range(self.max_slots):
            if self._live[s]:
                self._last[s] = (self._last[s] + 1) % self.vocab
            out.append(self._last[s])
        return out

    def reset_slot(self, slot: int) -> None:
        self._live[slot] = False
        self._last[slot] = 0

    def compile_stats(self) -> dict:
        # the shape the scheduler's compile gauges scrape; a fake engine
        # trivially satisfies the ONE-decode-compile invariant
        return {"decode_compiles": 1, "prefill_compiles": 1,
                "insert_compiles": 1}
