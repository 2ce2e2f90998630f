"""Binary-weight MVU (paper Fig. 4b) on the H100: the hand CUDA kernel.

``mvu_binary`` computes ``out[M, N] = epilogue(A[M, K] . (2 W01 - 1)^T)``
for {0,1}-coded +/-1 weights.  It replaces
``src/repro/kernels/mvu_binary.py::mvu_binary_pallas`` (``pallas_call`` at
line 108); the source is ``csrc/mvu_binary.cu``, the dense core of
``csrc/dense_mvu.cuh`` with int8 weight rows.  The activations are int32
and not narrowed, so the kernel stays on the CUDA cores, in one of two
arrangements that :func:`binary_launch_plan` (``dense_mvu.
dense_launch_plan``) picks from the shape: a warp a column (``gemv``) for
M <= 8, the CNV's dense layers at one image; 32 x 32 tiles with
``cp.async`` double buffering and, for outputs of few tiles, K split
across a thread-block cluster (``tiled``) above.  One launch a call
either way.  Like every wrapper: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version
:func:`mvu_binary_plain`, and ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import check_operands, epilogue_value, int_dot
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N, PLAN_ARGTYPES, Library
from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan

LIB = Library("mvu_binary.cu", {"repro_mvu_binary": PLAN_ARGTYPES})

# mvu_binary's plan (int8 weight rows), by the name its callers know
binary_launch_plan = dense_launch_plan

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def mvu_binary(a: torch.Tensor, w_bits: torch.Tensor,
               thresholds: torch.Tensor | None = None,
               out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
               block_k: int = BLOCK_K, rows_per_tile: int | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A[M,K] . (2*W01[N,K]-1)^T).

    a: (M, K) int32 (int8/uint8/int16 are widened; the value is not
    narrowed); w_bits: (N, K) int8 in {0,1}.  block_n / block_k /
    rows_per_tile pick the kernel's compiled tile, as for ``mvu_int``.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_binary", a, w_bits, thresholds, out_scale,
                            w_dtype=torch.int8)
    if a.device.type == "cpu":
        return mvu_binary_plain(a, w_bits, thresholds, out_scale)
    (m, k), n = a.shape, w_bits.shape[0]
    out = LIB.launch("repro_mvu_binary", a, w_bits, thresholds, out_scale, epi, n=n, k=k,
                     plan=dense_launch_plan(m, n, k, CODING["mvu_binary"], block_n=block_n,
                                            block_k=block_k, rows_per_tile=rows_per_tile).c_args)
    if out.numel():  # an empty output launches nothing
        LAUNCHES += 1
    return out


def mvu_binary_plain(a: torch.Tensor, w_bits: torch.Tensor,
                     thresholds: torch.Tensor | None = None,
                     out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on CPU or CUDA tensors; also
    the port's oracle (``ref.mvu_binary_ref``) and its ``backend="torch"``:
    the integer dot of ``a`` with the bipolar rows ``2 w - 1``, which equals
    the kernel's ``2 * dot - rowsum`` mod 2^32."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    bipolar = 2 * w_bits.to(torch.int64) - 1
    return epilogue_value(int_dot(a, bipolar), thresholds, out_scale)
