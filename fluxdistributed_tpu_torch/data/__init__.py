"""Data helpers the serving slice needs."""

from .text import ByteTextDataset

__all__ = ["ByteTextDataset"]
