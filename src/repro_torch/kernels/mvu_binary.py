"""Binary-weight MVU (paper Fig. 4b) on the H100: the hand CUDA kernel.

``mvu_binary`` computes ``out[M, N] = epilogue(A[M, K] . (2 W01 - 1)^T)``
for {0,1}-coded +/-1 weights.  It replaces
``src/repro/kernels/mvu_binary.py::mvu_binary_pallas`` (``pallas_call`` at
line 108); the source is ``csrc/mvu_binary.cu``.  The activations are
int32 and not narrowed, so the kernel stays on the CUDA cores, in one of
two arrangements that :func:`binary_launch_plan` picks from the shape: a
warp a column (``gemv``) for M <= 8, the CNV's dense layers at one image;
32 x 32 tiles with ``cp.async`` double buffering and, for outputs of few
tiles, K split across a thread-block cluster (``tiled``) above.  One
launch a call either way.  Like every wrapper: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version
:func:`mvu_binary_plain`, and ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._common import check_operands, epilogue_value, int_dot
from repro_torch.kernels._cuda import _ARGTYPES, Library, k_slices, split_k

LIB = Library("mvu_binary.cu", ("repro_mvu_binary",),
              argtypes=_ARGTYPES[:-1] + [ctypes.c_int] * 5 + [ctypes.c_void_p])

ARRANGEMENTS = ("gemv", "tiled")
GEMV_MAX_M = 8  # rows a gemv warp keeps (csrc/mvu_binary.cu)
GEMV_WARPS = 8  # columns (warps) a gemv block
TILE = 32  # tiled: the output tile, and synapses a K step
# tiled: the staged epilogue operand (32 columns x up to 16 thresholds, and
# 64 bytes of slack, csrc/cluster_reduce.cuh), then two stages of a (32, 36)
# int32 A slice and a (32, 48) byte W slice
TILED_SMEM = 32 * 16 * 4 + 64 + 2 * (TILE * (TILE + 4) * 4 + TILE * (TILE + 16))

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


class BinaryPlan(NamedTuple):
    """One ``mvu_binary`` launch: the arrangement, ``tile_m`` x ``tile_n``
    outputs a block (gemv: up to 8 rows x 8 columns, a warp each), K cut
    into ``splits`` slices of its ``steps`` 32-synapse steps (one
    cluster an output tile), ``smem_bytes`` of dynamic shared memory."""
    arrangement: str
    tile_m: int
    tile_n: int
    splits: int
    steps: int
    smem_bytes: int

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The synapses [lo, hi) of each K slice, in rank order (gemv: one
        warp's lanes stride the whole K)."""
        if self.arrangement == "gemv":
            return [(0, k)]
        return k_slices(self.steps, self.splits, TILE, k)


@functools.lru_cache(maxsize=None)
def binary_launch_plan(m: int, n: int, k: int) -> BinaryPlan:
    """The launch plan of ``mvu_binary`` at (M, N, K): a function of the
    shape alone.  ``gemv`` for M <= 8, else ``tiled`` with K split
    (``_cuda.split_k``) when the 32 x 32 tiles are too few to fill the
    card."""
    steps = max(1, -(-k // TILE))
    if m <= GEMV_MAX_M:
        return BinaryPlan("gemv", GEMV_MAX_M, GEMV_WARPS, 1, steps, 0)
    tiles = -(-m // TILE) * -(-n // TILE)
    return BinaryPlan("tiled", TILE, TILE, split_k(tiles, steps), steps, TILED_SMEM)


def mvu_binary(a: torch.Tensor, w_bits: torch.Tensor,
               thresholds: torch.Tensor | None = None,
               out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A[M,K] . (2*W01[N,K]-1)^T).

    a: (M, K) int32 (int8/uint8/int16 are widened; the value is not
    narrowed); w_bits: (N, K) int8 in {0,1}.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_binary", a, w_bits, thresholds, out_scale,
                            w_dtype=torch.int8)
    if a.device.type == "cpu":
        return mvu_binary_plain(a, w_bits, thresholds, out_scale)
    (m, k), n = a.shape, w_bits.shape[0]
    plan = binary_launch_plan(m, n, k)
    out = LIB.launch("repro_mvu_binary", a, w_bits, thresholds, out_scale, epi, n=n, k=k,
                     plan=(ARRANGEMENTS.index(plan.arrangement), plan.tile_m, plan.tile_n,
                           plan.splits, plan.smem_bytes))
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
