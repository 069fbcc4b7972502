"""Byte-level text: the decode half of the JAX package's
``data/text.py:ByteTextDataset`` (vocab 256, one token per byte), which
the server needs to turn byte-prompt outputs back into text."""

from __future__ import annotations

__all__ = ["ByteTextDataset"]


class ByteTextDataset:
    """Byte-level vocabulary: token ids are UTF-8 bytes."""

    vocab = 256

    @staticmethod
    def decode(tokens) -> str:
        """Bytes → text (lossy on invalid UTF-8), for eyeballing samples."""
        return bytes(int(t) & 0xFF for t in tokens).decode(
            "utf-8", errors="replace")
