"""Shared pieces of the MVU kernel wrappers and their plain versions.

The hand kernels (``csrc/*.cu``) fuse one epilogue after their int32
accumulator (``csrc/epilogue.cuh``); :func:`epilogue_value` is that
epilogue written once in PyTorch, in the same priority: thresholds > scale
> raw accumulator.  :func:`check_operands` is the one set of checks every
wrapper makes before it launches, and :func:`int_dot` the integer product
every plain version sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.thresholds import apply_thresholds

# the broadcast product of a plain version stays under this many bytes
PLAIN_CHUNK_BYTES = 1 << 28
# activation dtypes a wrapper widens to int32 (float and int64 raise)
WIDEN = (torch.int8, torch.uint8, torch.int16)


def epilogue_value(acc: torch.Tensor, thresholds: torch.Tensor | None,
                   out_scale: torch.Tensor | None) -> torch.Tensor:
    """MVTU epilogue of an (M, N) int32 accumulator."""
    if thresholds is not None:
        # act = sum_t (acc >= T[n, t]) -- the multi-threshold unit.
        return apply_thresholds(acc, thresholds)
    if out_scale is not None:
        return acc.to(torch.float32) * out_scale.reshape(1, -1)
    return acc


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad ``axis`` at its end up to a whole multiple of ``multiple``."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs starting from the LAST axis
    pad[2 * (x.ndim - 1 - axis) + 1] = rem
    return F.pad(x, pad, value=value)


def swar_popcount(x: torch.Tensor) -> torch.Tensor:
    """Branch-free SWAR popcount of 32-bit patterns (int32 result).

    Taken in int64 on the low 32 bits, where no step overflows or
    sign-extends (the kernels use the hardware ``__popc``).
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def narrow_int8(a: torch.Tensor) -> torch.Tensor:
    """The wrapping int32 -> int8 cast of the packed kernels (``astype(int8)``
    in the JAX package), returned as int32: x mod 256 in [-128, 127]."""
    v = a.to(torch.int32) & 0xFF
    return torch.where(v >= 128, v - 256, v)


def int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) -> (M, N) int32: products summed in int64, truncated
    to int32 (the wraparound of the kernels' and XLA's int32 sum).

    The CPU has an int64 matmul; CUDA has no integer matmul, so there the
    sum is a broadcast product.  Both are chunked over M to stay under
    ``PLAIN_CHUNK_BYTES`` (the size of the broadcast product).
    """
    m, k = a.shape
    n = w.shape[0]
    if m == 0:
        return torch.zeros((0, n), dtype=torch.int32, device=a.device)
    w64 = w.to(torch.int64)
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, 8 * n * k))
    if a.device.type == "cpu":
        def dot(c):
            return c.to(torch.int64) @ w64.T
    else:
        def dot(c):
            return (c.to(torch.int64)[:, None, :] * w64[None]).sum(-1)
    acc = torch.cat([dot(a[i:i + rows]) for i in range(0, m, rows)])
    return acc.to(torch.int32)


def check_operands(name: str, a: torch.Tensor, w: torch.Tensor,
                   thresholds: torch.Tensor | None, out_scale: torch.Tensor | None,
                   *, w_dtype: torch.dtype, lanes_per_col: int = 1,
                   words: bool = False) -> tuple[torch.Tensor, str]:
    """Validate one kernel call's operands; returns ``a`` as int32 and the
    epilogue's name (``raw``, ``thresholds`` or ``scale``).

    ``a`` is (M, K) integer activations (int8/uint8/int16 are widened), or
    with ``words`` (M, Wd) int32 bit patterns taken as they are.  ``w`` is
    (N, C) of ``w_dtype``, ``lanes_per_col`` synapses per column: C == K
    for one, C * lanes_per_col >= K for packed storage.
    """
    if a.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{name}: need a 2-D a and w, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    k, cols = a.shape[1], w.shape[1]
    fits = cols == k if lanes_per_col == 1 else cols * lanes_per_col >= k
    if not fits:
        raise ValueError(f"{name}: w {tuple(w.shape)} does not hold the "
                         f"{k} synapses of a {tuple(a.shape)}")
    if words:
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: packed a must be int32 bit patterns, got {a.dtype}")
    elif a.dtype != torch.int32 and a.dtype not in WIDEN:
        raise TypeError(f"{name}: a must be int32 (int8/uint8/int16 are widened), "
                        f"got {a.dtype}")
    if w.dtype != w_dtype:
        raise TypeError(f"{name}: w must be {w_dtype}, got {w.dtype}")
    return a.to(torch.int32), check_epilogue(name, a, w, thresholds, out_scale)


def check_epilogue(name: str, a: torch.Tensor, w: torch.Tensor,
                   thresholds: torch.Tensor | None,
                   out_scale: torch.Tensor | None) -> str:
    """Validate the epilogue operand against w's N rows, and that every
    operand is contiguous and on ``a``'s device; returns the epilogue's
    name (``raw``, ``thresholds`` or ``scale``)."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    n = w.shape[0]
    operands = [("a", a), ("w", w)]
    if thresholds is not None:
        if thresholds.dtype != torch.int32 or thresholds.ndim != 2 \
                or thresholds.shape[0] != n or thresholds.shape[1] < 1:
            raise ValueError(f"{name}: thresholds must be (N={n}, T>=1) int32, got "
                             f"{tuple(thresholds.shape)} {thresholds.dtype}")
        operands.append(("thresholds", thresholds))
        epi = "thresholds"
    elif out_scale is not None:
        if out_scale.dtype != torch.float32 or tuple(out_scale.shape) != (n,):
            raise ValueError(f"{name}: out_scale must be (N={n},) float32, got "
                             f"{tuple(out_scale.shape)} {out_scale.dtype}")
        operands.append(("out_scale", out_scale))
        epi = "scale"
    else:
        epi = "raw"
    for arg, t in operands:
        if t.device != a.device:
            raise ValueError(f"{name}: {arg} is on {t.device} but a is on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return epi
