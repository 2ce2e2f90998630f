"""Packed-storage widths read by folding and the resource model.

Only the size algebra is here.  The bit-packing functions themselves
(``pack_bits``, ``pack_int2`` and their inverses) come with the xnor and
packed-weight slices (ROADMAP queue A item 1, queue B rows 2, 5, 6).
"""

from __future__ import annotations

WORD_BITS = 32
INT2_PER_BYTE = 4


def padded_bits(k: int) -> int:
    """K rounded up to a whole number of 32-bit words (0 stays 0)."""
    if k < 0:
        raise ValueError(f"bit count must be non-negative, got {k}")
    return ((k + WORD_BITS - 1) // WORD_BITS) * WORD_BITS


def num_words(k: int) -> int:
    return padded_bits(k) // WORD_BITS


def padded_int2(k: int) -> int:
    """K rounded up to a whole number of 4-field bytes (0 stays 0)."""
    if k < 0:
        raise ValueError(f"lane count must be non-negative, got {k}")
    return ((k + INT2_PER_BYTE - 1) // INT2_PER_BYTE) * INT2_PER_BYTE


def num_int2_bytes(k: int) -> int:
    return padded_int2(k) // INT2_PER_BYTE
