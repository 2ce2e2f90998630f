"""Bit-packing helpers for the XNOR-popcount and packed-weight datapaths.

32 binary synapses pack into one 32-bit word, LSB-first, so one word is
SIMD = 32 FINN lanes.  A stored bit b encodes the bipolar value (2b - 1)
(paper Fig. 4a); for two packed operands over K bits

    dot = 2 * popcount(~(a ^ w)) - pad_correction(K)

holds for any K, a whole number of words or not (:func:`pad_correction`).
2-bit weights use the sibling lane format (:func:`pack_int2`): four signed
2-bit two's-complement fields per uint8 byte, LSB-first.

Torch has no ``>>`` or ``~`` on ``uint32``, so the port carries packed
words as **int32 bit patterns**: the same 32 bits as the JAX package's
uint32 words (``np.ndarray.view`` turns one into the other).  ``>>`` on an
int32 is arithmetic (it copies the sign bit), so every right shift here is
masked before its bits are read.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import swar_popcount

WORD_BITS = 32
INT2_PER_BYTE = 4


def padded_bits(k: int) -> int:
    """K rounded up to a whole number of 32-bit words (0 stays 0)."""
    if k < 0:
        raise ValueError(f"bit count must be non-negative, got {k}")
    return ((k + WORD_BITS - 1) // WORD_BITS) * WORD_BITS


def num_words(k: int) -> int:
    return padded_bits(k) // WORD_BITS


def pad_correction(k: int, kp: int | None = None) -> int:
    """The constant subtracted in the padded XNOR-popcount identity.

    With both operands zero-padded from K up to ``kp`` bits (default
    ``padded_bits(K)``), each pad bit adds xnor(0, 0) = 1 to the popcount
    on top of the bipolar -K offset:

        dot = 2 * popcount(~(a ^ w)) - (Kp + (Kp - K))
    """
    if kp is None:
        kp = padded_bits(k)
    if kp < k:
        raise ValueError(f"padded width {kp} is smaller than bit count {k}")
    return kp + (kp - k)


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack integers along the last axis into 32-bit words (int32 patterns).

    (..., K) -> (..., ceil(K/32)), LSB-first within each word.  Each value
    is masked to its LSB first: a multi-bit value (a 2-bit activation fed
    to a 1-bit layer) would otherwise leak into the neighbouring bit, and
    into the pad bits of the last word, where it breaks the pad correction.
    """
    k = bits.shape[-1]
    kp = padded_bits(k)
    b = bits.to(torch.int64) & 1
    if kp != k:
        b = torch.nn.functional.pad(b, (0, kp - k))
    b = b.reshape(*b.shape[:-1], kp // WORD_BITS, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=b.device)
    return _to_int32_bits((b << shifts).sum(-1))


def pack_bits_pad_set(bits: torch.Tensor, extra_words: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """``pack_bits(bits)`` for (N, K) {0,1} bits with every pad bit of the
    last word set to 1 and ``extra_words`` random words more a row: a
    bitplane operand (``Wd > ceil(K/32)``) of which a kernel must count
    neither part."""
    n, k = bits.shape
    words = pack_bits(bits)
    if k % WORD_BITS:
        words[:, -1] |= -(1 << (k % WORD_BITS))  # the bits past K, as an int32 pattern
    extra = torch.randint(-2**31, 2**31 - 1, (n, extra_words), generator=generator,
                          dtype=torch.int32)
    return torch.cat([words, extra.to(words.device)], 1).contiguous()


def unpack_bits(words: torch.Tensor, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., W) words -> (..., count) int32 in {0,1}.

    ``count`` beyond the packed width (W*32) raises instead of silently
    truncating to the bits there are.
    """
    if count < 0:
        raise ValueError(f"bit count must be non-negative, got {count}")
    width = words.shape[-1] * WORD_BITS
    if count > width:
        raise ValueError(
            f"cannot unpack {count} bits from {words.shape[-1]} words "
            f"({width} bits packed)")
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1  # mask: >> is arithmetic
    return bits.reshape(*words.shape[:-1], width)[..., :count]


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element number of set bits of a 32-bit pattern (int32 result)."""
    return swar_popcount(x)


def bipolar_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Map {-1,+1} (or any sign) to the stored-bit convention {0,1}."""
    return (x > 0).to(torch.int32)


def bits_to_bipolar(b: torch.Tensor) -> torch.Tensor:
    return (2 * b.to(torch.int32) - 1).to(torch.int32)


# ------------------------------------------------------------------ 2-bit lanes
def padded_int2(k: int) -> int:
    """K rounded up to a whole number of 4-field bytes (0 stays 0)."""
    if k < 0:
        raise ValueError(f"lane count must be non-negative, got {k}")
    return ((k + INT2_PER_BYTE - 1) // INT2_PER_BYTE) * INT2_PER_BYTE


def num_int2_bytes(k: int) -> int:
    return padded_int2(k) // INT2_PER_BYTE


def pack_int2(values: torch.Tensor) -> torch.Tensor:
    """Pack signed 2-bit integers in [-2, 1] along the last axis into uint8.

    (..., K) -> (..., ceil(K/4)); each byte holds four two's-complement
    2-bit fields, LSB-first.  Zero pads decode back to weight 0.
    """
    k = values.shape[-1]
    kp = padded_int2(k)
    f = values.to(torch.int32) & 0x3
    if kp != k:
        f = torch.nn.functional.pad(f, (0, kp - k))
    f = f.reshape(*f.shape[:-1], kp // INT2_PER_BYTE, INT2_PER_BYTE)
    shifts = torch.arange(0, 2 * INT2_PER_BYTE, 2, dtype=torch.int32, device=f.device)
    return (f << shifts).sum(-1).to(torch.uint8)


def pack_int2_pad_set(values: torch.Tensor, extra_bytes: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """``pack_int2(values)`` for (N, K) lanes in [-2, 1] with every pad lane
    of the last byte set (0b11) and ``extra_bytes`` random bytes more a row:
    a 2-bit operand (``Bd > ceil(K/4)``) of which a kernel must count
    neither part."""
    n, k = values.shape
    lanes = pack_int2(values)
    if k % INT2_PER_BYTE:
        lanes[:, -1] |= (0xFF << (2 * (k % INT2_PER_BYTE))) & 0xFF  # the lanes past K
    extra = torch.randint(0, 256, (n, extra_bytes), generator=generator, dtype=torch.uint8)
    return torch.cat([lanes, extra.to(lanes.device)], 1).contiguous()


def unpack_int2(bytes_: torch.Tensor, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_int2`: (..., B) uint8 -> (..., count) int32 in [-2, 1].

    Like :func:`unpack_bits`, ``count`` beyond the packed width raises.
    """
    if count < 0:
        raise ValueError(f"lane count must be non-negative, got {count}")
    width = bytes_.shape[-1] * INT2_PER_BYTE
    if count > width:
        raise ValueError(
            f"cannot unpack {count} lanes from {bytes_.shape[-1]} bytes "
            f"({width} lanes packed)")
    shifts = torch.arange(0, 2 * INT2_PER_BYTE, 2, dtype=torch.int32,
                          device=bytes_.device)
    fields = (bytes_.to(torch.int32)[..., None] >> shifts) & 0x3
    fields = fields.reshape(*bytes_.shape[:-1], width)
    # sign-extend the 2-bit two's-complement field: 0b10 -> -2, 0b11 -> -1
    return torch.where(fields >= 2, fields - 4, fields)[..., :count]
