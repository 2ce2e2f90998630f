"""Fused SWU+MVU convolution (FINN Fig. 1 without the im2col matrix) on the H100.

``conv_mvu`` computes ``out[B, OH*OW, N] = epilogue(SWU(x) . W^T)`` from
the (B, H, W, C) NHWC image and the (N, Kd^2*C) weight matrix in (ky, kx,
c) order (``core/swu.py::pack_conv_weights``).  It replaces
``src/repro/kernels/swu_mvu.py::conv_mvu_pallas`` (``pallas_call`` at line
207).  The kernel, ``csrc/conv_mvu.cu``, gathers each sliding window
straight from the image as it stages the activation tile (an implicit
GEMM), so the (B*OH*OW, K) window matrix never exists in device memory.
Its source note says what bounds it on the card.

Datapaths (the TPU kernel's ``MODES``), all narrowing x to int8 with a
wrap as the TPU kernel does (an activation >= 128 wraps):

    standard  acc = A . W^T                               int8 weight rows
    binary    acc = 2 * (A . W01^T) - rowsum(A)           {0,1} int8 rows
    xnor      acc = 4 * (A01 . W01^T) - 2 * rowsum        packed int32 words,
                    - 2 * colsum + K                      x in {0,1}

Like every wrapper: a CUDA tensor launches the kernel or raises, a CPU
tensor takes the plain version :func:`conv_mvu_plain`, and ``LAUNCHES``
counts launches.  The JAX package's ``backend="xla"`` arm, which does not
narrow, is ``ref.conv_mvu_ref`` (``ops.conv_mvu(backend="torch")``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.swu import out_dim
from repro_torch.kernels import packing, ref
from repro_torch.kernels._common import WIDEN, check_epilogue, narrow_int8
from repro_torch.kernels._cuda import (
    BLOCK_K,
    BLOCK_M,
    BLOCK_N,
    EPILOGUE,
    Library,
    device_ptr,
)

MODES = ("standard", "binary", "xnor")

LIB = Library("conv_mvu.cu", ("repro_conv_mvu",),
              argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p])

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def conv_rows_per_tile(oh: int, ow: int, block_m: int) -> int:
    """Output rows per tile of the JAX kernel's grid: ~block_m pixels, as in
    the JAX package.  The CUDA kernel tiles pixels, not rows, and the port
    has no autotuner yet, so nothing in the port calls it (ROADMAP queue A
    item 6)."""
    return max(1, min(oh, -(-block_m // ow)))


def conv_smem_bytes() -> int:
    """Shared memory of one block of the CUDA kernel, in bytes: the
    (BLOCK_K, BLOCK_M) activation slice and the (BLOCK_K, BLOCK_N) weight
    slice of one K step, as 32-bit words, each row padded by one word
    (``csrc/mvu_tile.cuh``).  It does not grow with the image or with K:
    the windows are gathered a K step at a time."""
    return 4 * BLOCK_K * ((BLOCK_M + 1) + (BLOCK_N + 1))


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
    if max(x.numel(), m, w.numel()) >= 2**31 or n > 65535 * BLOCK_N:
        raise ValueError(f"conv_mvu: x {tuple(x.shape)} with N={n} exceeds the "
                         "kernel's int32 indices or grid")
    out = torch.empty((m, n), dtype=torch.float32 if epi == "scale" else torch.int32,
                      device=x.device)
    if out.numel():  # an empty output launches nothing
        LIB.run("repro_conv_mvu", x.device, x.data_ptr(), w.data_ptr(),
                device_ptr(thresholds), device_ptr(out_scale), out.data_ptr(),
                b, h, wdim, c, n, kernel, stride, pad, w.shape[1],
                thresholds.shape[1] if thresholds is not None else 0,
                MODES.index(mode), EPILOGUE[epi])
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
