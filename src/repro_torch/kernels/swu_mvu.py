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
the shared memory from the shape alone.  The window matrix never exists
in device memory.  The source note says what bounds it.

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
    split_k,
)

MODES = ("standard", "binary", "xnor")

LIB = Library("conv_mvu.cu", {
    "repro_conv_mvu": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p]})

# The kernel's fixed shape (csrc/conv_mvu.cu): 32 pixels x 32 output
# channels a block, K stepped 32 taps (one mma k) at a time; in shared
# memory 32 int32 column sums and a step's 32 taps decoded (two int32
# each), the epilogue operand of 32 columns (up to 16 thresholds each, and
# 64 bytes of slack), and a ring of 8 weight stages of 32 rows x 48 bytes.
TILE_M = 32
TILE_N = 32
KSTEP = 32
HEAD_BYTES = (TILE_N + 2 * KSTEP) * 4 + TILE_N * 16 * 4 + 64
RING_BYTES = 8 * TILE_N * 48
# Where the A fragments come from: the line buffer in shared memory, or
# (an image whose rows do not fit it) each tap from the image itself.
ARRANGEMENTS = ("line", "gather")

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def conv_rows_per_tile(oh: int, ow: int, block_m: int) -> int:
    """Output rows per tile of the JAX kernel's grid: ~block_m pixels, as in
    the JAX package.  The CUDA kernel tiles pixels, not rows: the autotuner
    records it in a conv entry (``rows_per_tile``) and the launch ignores
    it; only per-layer tiles wait for ROADMAP queue A item 3, step 3."""
    return max(1, min(oh, -(-block_m // ow)))


def line_buffer_pitch(c: int) -> int:
    """32-bit words a pixel takes in the kernel's line buffer: at least
    ceil(C / 4), and 4 mod 8, so the eight pixel rows an mma fragment reads
    fall in distinct shared-memory banks."""
    p = -(-c // 4)
    return p + (4 - p) % 8


def conv_smem_bytes(arrangement: str, h: int, w: int, c: int, kernel: int, stride: int = 1,
                    pad: int = 0) -> int:
    """Dynamic shared memory of one block of a plan, in bytes: the xnor
    column sums, the decoded taps and the staged epilogue operand, then
    the weight ring and (arrangement ``"line"``) the line buffer, or the
    (32, 32) uint32 partial tile of the cluster sum, which reuses them.
    The line buffer holds the input rows a tile's windows can touch: 32
    pixels span at most ``span`` output rows, so their windows at most
    ``(span - 1) * stride + kernel`` input rows, all W pixels, C channels
    as int8 in :func:`line_buffer_pitch` words a pixel.  The same formula
    is ``smem_needed`` in ``csrc/conv_mvu.cu``, which checks it."""
    line = 0
    if arrangement == "line":
        oh, ow = out_dim(h, kernel, stride, pad), out_dim(w, kernel, stride, pad)
        span = min(oh, (ow + TILE_M - 2) // ow + 1)
        rows = min(h, (span - 1) * stride + kernel)
        line = rows * w * line_buffer_pitch(c) * 4
    return HEAD_BYTES + max(RING_BYTES + line, TILE_M * TILE_N * 4)


class ConvPlan(NamedTuple):
    """One ``conv_mvu`` launch: the arrangement (:data:`ARRANGEMENTS`),
    ``tile_m`` pixels x ``tile_n`` channels a block, K cut into
    ``splits`` slices of its ``steps`` 32-tap steps (one cluster of
    ``splits`` blocks an output tile), ``smem_bytes`` of dynamic shared
    memory a block."""
    arrangement: str
    tile_m: int
    tile_n: int
    splits: int
    steps: int
    smem_bytes: int

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The taps [lo, hi) of each K slice, in rank order."""
        return k_slices(self.steps, self.splits, KSTEP, k)


@functools.lru_cache(maxsize=None)
def conv_launch_plan(b: int, h: int, w: int, c: int, n: int, kernel: int, stride: int = 1,
                     pad: int = 0) -> ConvPlan:
    """The launch plan of ``conv_mvu`` on a (b, h, w, c) image with n output
    channels: a function of the shape alone.

    The line buffer where it fits the H100's 232,448 bytes of shared
    memory a block, else the gather arrangement (an image row too wide
    for it); K split (``_cuda.split_k``) when the 32 x 32 output tiles are
    too few to fill the card."""
    oh, ow = out_dim(h, kernel, stride, pad), out_dim(w, kernel, stride, pad)
    steps = -(-kernel * kernel * c // KSTEP)
    splits = split_k(b * -(-oh * ow // TILE_M) * -(-n // TILE_N), steps)
    arrangement = ("line" if conv_smem_bytes("line", h, w, c, kernel, stride, pad) <= SMEM_BYTES
                   else "gather")
    return ConvPlan(arrangement, TILE_M, TILE_N, splits, steps,
                    conv_smem_bytes(arrangement, h, w, c, kernel, stride, pad))


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
             mode: str = "standard") -> torch.Tensor:
    """out[B, OH*OW, N] = epilogue(SWU(x) . W^T), without materialising SWU(x).

    x: (B, H, W, C) integer activations ({0,1} bits for xnor), contiguous;
    w: (N, Kd^2*C) int8 in (ky, kx, c) order (binary: {0,1}-coded +/-1
    rows), or for xnor the packed (N, ceil(K/32)) int32 words;
    thresholds: optional (N, T) int32 -> int32 levels; out_scale: optional
    (N,) float32 -> float32; neither -> the raw int32 accumulator.
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
        plan = conv_launch_plan(b, h, wdim, c, n, kernel, stride, pad)
        LIB.run("repro_conv_mvu", x.device, x.data_ptr(), w.data_ptr(),
                device_ptr(thresholds), device_ptr(out_scale), out.data_ptr(),
                b, h, wdim, c, n, kernel, stride, pad, w.shape[1],
                thresholds.shape[1] if thresholds is not None else 0,
                MODES.index(mode), EPILOGUE[epi], ARRANGEMENTS.index(plan.arrangement),
                plan.splits, plan.smem_bytes)
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
