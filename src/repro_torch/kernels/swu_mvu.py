"""Fused SWU+MVU convolution (FINN Fig. 1 without the im2col matrix) on the H100.

``conv_mvu`` computes ``out[B, OH*OW, N] = epilogue(SWU(x) . W^T)`` from
the (B, H, W, C) NHWC image and the (N, Kd^2*C) weight matrix in (ky, kx,
c) order (``core/swu.py::pack_conv_weights``).  It replaces
``src/repro/kernels/swu_mvu.py::conv_mvu_pallas`` (``pallas_call`` at line
207).  The kernel, ``csrc/conv_mvu.cu``, loads the input rows its pixel
tile's windows touch into a shared-memory line buffer as int8 (or, where
those rows do not fit a block's shared memory, reads each tap from the
image in device memory), multiplies on the int8 tensor cores
(``mma.sync`` s8 x s8 -> s32), streams the weights through a ring of
``cp.async`` stages and, for outputs of few tiles, splits K across a
thread-block cluster summed in distributed shared memory: one launch a
call.  :func:`conv_launch_plan` picks the arrangement, the K splits and
the shared memory from the shape and the layer's tile (:func:`conv_tile`:
the output channels from ``block_n``, the pixels from a tuned
``rows_per_tile``, one of :data:`CONV_TILES`).  The window matrix never
exists in device memory.  The source note says what bounds it.

Datapaths (the TPU kernel's ``MODES``), all narrowing x to int8 with a
wrap as the TPU kernel does (an activation >= 128 wraps):

    standard  acc = A . W^T                               int8 weight rows
    binary    acc = 2 * (A . W01^T) - rowsum(A)           {0,1} int8 rows
    xnor      acc = 2 * (A01 . W+-1^T) - colsum(W+-1)     packed int32 words,
                                                          x in {0,1}

Like every wrapper: a CUDA tensor launches the kernel or raises, a CPU
tensor takes the plain version :func:`conv_mvu_plain`, and ``LAUNCHES``
counts launches.  The JAX package's ``backend="xla"`` arm, which does not
narrow, is ``ref.conv_mvu_ref`` (``ops.conv_mvu(backend="torch")``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.swu import out_dim
from repro_torch.kernels import packing, ref
from repro_torch.kernels._common import WIDEN, check_epilogue, narrow_int8
from repro_torch.kernels._cuda import (
    EPILOGUE,
    SMEM_BYTES,
    Library,
    device_ptr,
    k_slices,
    round_up_to,
    split_k,
)

MODES = ("standard", "binary", "xnor")

LIB = Library("conv_mvu.cu", {
    "repro_conv_mvu": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 + [ctypes.c_void_p]})

# The kernel's compiled tiles (csrc/conv_mvu.cu ConvTile), (tile_m pixels,
# tile_n output channels) by the index it dispatches on; K steps 32 taps
# (one mma k) in each.  A block holds in shared memory tile_n int32 column
# sums and a step's 32 taps decoded (two int32 each), the epilogue operand
# of tile_n columns (up to 16 thresholds each, and 64 bytes of slack), and
# a ring of 8 weight stages of tile_n rows x 48 bytes.
# 32 x 32, and 32, 64 and 128 pixels at 64 channels: the taller pixel tiles
# pay at 64 channels (chip_smoke's tiles phase), and PE rounds onto 32 or 64.
CONV_TILE_NS = (32, 64)
CONV_TILES = ((32, 32), (32, 64), (64, 64), (128, 64))
TILE_M = 32  # the default tile, and every untuned launch's pixels
TILE_N = CONV_TILE_NS[0]
KSTEP = 32


def head_bytes(tile_n: int) -> int:
    """The column sums, the decoded taps and the staged epilogue operand."""
    return (tile_n + 2 * KSTEP) * 4 + tile_n * 16 * 4 + 64


def ring_bytes(tile_n: int) -> int:
    """The weight ring: 8 stages of tile_n rows x 48 bytes."""
    return 8 * tile_n * 48


# Where the A fragments come from: the line buffer in shared memory, or
# (an image whose rows do not fit it) each tap from the image itself.
ARRANGEMENTS = ("line", "gather")

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def conv_rows_per_tile(oh: int, ow: int, block_m: int) -> int:
    """Output rows per tile of the JAX kernel's grid: ~block_m pixels, as in
    the JAX package.  A conv entry's ``rows_per_tile`` pins the CUDA
    kernel's pixel tile at about that many output rows
    (:func:`conv_tile`)."""
    return max(1, min(oh, -(-block_m // ow)))


def conv_tile(ow: int, *, block_n: int = TILE_N,
              rows_per_tile: int | None = None) -> tuple[int, int]:
    """The compiled tile (tile_m, tile_n) a launch on output rows of ``ow``
    pixels takes: ``block_n`` rounded up onto :data:`CONV_TILE_NS`, then
    32 pixels, or ``rows_per_tile * ow`` pixels rounded up onto the pixel
    tiles compiled at that tile_n where a tuned entry pins the rows (the
    largest where they exceed them)."""
    tile_n = round_up_to(block_n, CONV_TILE_NS)
    if rows_per_tile is None:
        return TILE_M, tile_n
    pixels = tuple(tm for tm, tn in CONV_TILES if tn == tile_n)
    return round_up_to(rows_per_tile * ow, pixels), tile_n


def line_buffer_pitch(c: int) -> int:
    """32-bit words a pixel takes in the kernel's line buffer: at least
    ceil(C / 4), and 4 mod 8, so the eight pixel rows an mma fragment reads
    fall in distinct shared-memory banks."""
    p = -(-c // 4)
    return p + (4 - p) % 8


def conv_smem_bytes(arrangement: str, h: int, w: int, c: int, kernel: int, stride: int = 1,
                    pad: int = 0, tile_m: int = TILE_M, tile_n: int = TILE_N) -> int:
    """Dynamic shared memory of one block of a plan, in bytes: the xnor
    column sums, the decoded taps and the staged epilogue operand, then
    the weight ring and (arrangement ``"line"``) the line buffer, or the
    (tile_m, tile_n) uint32 partial tile of the cluster sum, which reuses
    them.  The line buffer holds the input rows a tile's windows can
    touch: tile_m pixels span at most ``span`` output rows, so their
    windows at most ``(span - 1) * stride + kernel`` input rows, all W
    pixels, C channels as int8 in :func:`line_buffer_pitch` words a pixel.
    The same formula is ``smem_needed`` in ``csrc/conv_mvu.cu``, which
    checks it."""
    line = 0
    if arrangement == "line":
        oh, ow = out_dim(h, kernel, stride, pad), out_dim(w, kernel, stride, pad)
        span = min(oh, (ow + tile_m - 2) // ow + 1)
        rows = min(h, (span - 1) * stride + kernel)
        line = rows * w * line_buffer_pitch(c) * 4
    return head_bytes(tile_n) + max(ring_bytes(tile_n) + line, tile_m * tile_n * 4)


class ConvPlan(NamedTuple):
    """One ``conv_mvu`` launch: the arrangement (:data:`ARRANGEMENTS`),
    ``tile_m`` pixels x ``tile_n`` channels a block, K cut into
    ``splits`` slices of its ``steps`` 32-tap steps (one cluster of
    ``splits`` blocks an output tile), ``smem_bytes`` of dynamic shared
    memory a block, ``tile`` the index of the compiled tile in
    :data:`CONV_TILES`."""
    arrangement: str
    tile_m: int
    tile_n: int
    splits: int
    steps: int
    smem_bytes: int
    tile: int = 0

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The taps [lo, hi) of each K slice, in rank order."""
        return k_slices(self.steps, self.splits, KSTEP, k)


@functools.lru_cache(maxsize=None)
def conv_launch_plan(b: int, h: int, w: int, c: int, n: int, kernel: int, stride: int = 1,
                     pad: int = 0, *, block_n: int = TILE_N,
                     rows_per_tile: int | None = None) -> ConvPlan:
    """The launch plan of ``conv_mvu`` on a (b, h, w, c) image with n output
    channels and a layer's tile blocks (:func:`conv_tile`).

    The line buffer where it fits the H100's 232,448 bytes of shared
    memory a block, else the gather arrangement (an image row too wide
    for it); K split (``_cuda.split_k``) when the output tiles are too few
    to fill the card."""
    oh, ow = out_dim(h, kernel, stride, pad), out_dim(w, kernel, stride, pad)
    tm, tn = conv_tile(ow, block_n=block_n, rows_per_tile=rows_per_tile)
    steps = -(-kernel * kernel * c // KSTEP)
    splits = split_k(b * -(-oh * ow // tm) * -(-n // tn), steps)
    geometry = (h, w, c, kernel, stride, pad, tm, tn)
    arrangement = "line" if conv_smem_bytes("line", *geometry) <= SMEM_BYTES else "gather"
    return ConvPlan(arrangement, tm, tn, splits, steps, conv_smem_bytes(arrangement, *geometry),
                    CONV_TILES.index((tm, tn)))


def _check(x: torch.Tensor, w: torch.Tensor, thresholds, out_scale, *, kernel: int,
           stride: int, pad: int, mode: str):
    """Validate one call; returns (x as int32, epilogue name, OH, OW)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.ndim != 4:
        raise ValueError(f"conv_mvu: x must be (B, H, W, C), got {tuple(x.shape)}")
    if kernel < 1 or stride < 1 or pad < 0:
        raise ValueError(f"conv_mvu: bad window kernel={kernel} stride={stride} pad={pad}")
    b, h, wdim, c = x.shape
    k = kernel * kernel * c
    oh, ow = out_dim(h, kernel, stride, pad), out_dim(wdim, kernel, stride, pad)
    if oh < 1 or ow < 1:
        raise ValueError(f"conv_mvu: a {kernel}x{kernel} window (pad {pad}) does not "
                         f"fit a {h}x{wdim} image")
    cols = packing.num_words(k) if mode == "xnor" else k
    if w.ndim != 2 or w.shape[1] != cols:
        raise ValueError(f"conv_mvu: {mode} weights must be (N, {cols}) for K={k} "
                         f"(kernel {kernel}, C={c}), got {tuple(w.shape)}")
    w_dtype = torch.int32 if mode == "xnor" else torch.int8
    if w.dtype != w_dtype:
        raise TypeError(f"conv_mvu: {mode} weights must be {w_dtype}, got {w.dtype}")
    if x.dtype not in (torch.int32, *WIDEN):
        raise TypeError(f"conv_mvu: x must be int32 (int8/uint8/int16 are widened), "
                        f"got {x.dtype}")
    epi = check_epilogue("conv_mvu", x, w, thresholds, out_scale)
    return x.to(torch.int32), epi, oh, ow


def conv_mvu(x: torch.Tensor, w: torch.Tensor,
             thresholds: torch.Tensor | None = None,
             out_scale: torch.Tensor | None = None, *,
             kernel: int, stride: int = 1, pad: int = 0,
             mode: str = "standard", block_n: int = TILE_N,
             rows_per_tile: int | None = None) -> torch.Tensor:
    """out[B, OH*OW, N] = epilogue(SWU(x) . W^T), without materialising SWU(x).

    x: (B, H, W, C) integer activations ({0,1} bits for xnor), contiguous;
    w: (N, Kd^2*C) int8 in (ky, kx, c) order (binary: {0,1}-coded +/-1
    rows), or for xnor the packed (N, ceil(K/32)) int32 words;
    thresholds: optional (N, T) int32 -> int32 levels; out_scale: optional
    (N,) float32 -> float32; neither -> the raw int32 accumulator.
    ``block_n`` and ``rows_per_tile`` pick the kernel's compiled tile
    (:func:`conv_tile`); the plain version takes none.
    """
    global LAUNCHES
    x, epi, oh, ow = _check(x, w, thresholds, out_scale, kernel=kernel,
                            stride=stride, pad=pad, mode=mode)
    if x.device.type == "cpu":
        return conv_mvu_plain(x, w, thresholds, out_scale, kernel=kernel,
                              stride=stride, pad=pad, mode=mode)
    if not x.is_cuda:
        raise ValueError(f"conv_mvu runs on CUDA or CPU tensors, got {x.device}")
    b, h, wdim, c = x.shape
    n = w.shape[0]
    m = b * oh * ow
    if max(x.numel(), m, w.numel()) >= 2**31 or -(-n // TILE_N) > 65535:
        raise ValueError(f"conv_mvu: x {tuple(x.shape)} with N={n} exceeds the "
                         "kernel's int32 indices or grid")
    out = torch.empty((m, n), dtype=torch.float32 if epi == "scale" else torch.int32,
                      device=x.device)
    if out.numel():  # an empty output launches nothing
        plan = conv_launch_plan(b, h, wdim, c, n, kernel, stride, pad, block_n=block_n,
                                rows_per_tile=rows_per_tile)
        LIB.run("repro_conv_mvu", x.device, x.data_ptr(), w.data_ptr(),
                device_ptr(thresholds), device_ptr(out_scale), out.data_ptr(),
                b, h, wdim, c, n, kernel, stride, pad, w.shape[1],
                thresholds.shape[1] if thresholds is not None else 0,
                MODES.index(mode), EPILOGUE[epi], ARRANGEMENTS.index(plan.arrangement),
                plan.tile, plan.tile_m, plan.tile_n, plan.splits, plan.smem_bytes)
        LAUNCHES += 1
    return out.reshape(b, oh * ow, n)


def conv_mvu_plain(x: torch.Tensor, w: torch.Tensor,
                   thresholds: torch.Tensor | None = None,
                   out_scale: torch.Tensor | None = None, *,
                   kernel: int, stride: int = 1, pad: int = 0,
                   mode: str = "standard") -> torch.Tensor:
    """The kernel's function in plain PyTorch, on CPU or CUDA tensors: the
    oracle ``ref.conv_mvu_ref`` (materialised windows) on the int8-narrowed
    image, with xnor's packed words unpacked to {0,1} rows."""
    if mode == "xnor":
        w = packing.unpack_bits(w, kernel * kernel * x.shape[-1])
    return ref.conv_mvu_ref(narrow_int8(x), w, kernel=kernel, stride=stride, pad=pad,
                            mode=mode, thresholds=thresholds, out_scale=out_scale)
