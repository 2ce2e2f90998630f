"""The launch plan of the CUDA-core dense MVU core (``csrc/dense_mvu.cuh``).

Five hand kernels run that core (six entry points), each with its own
operand coding:

    mvu_int            int32 A, int8 W rows                  acc
    mvu_binary         int32 A, int8 W rows                  2 acc - rowsum
    mvu_binary_packed  A narrowed to int8, 32-bit bitplanes  2 acc - rowsum
    mvu_int2_packed    A narrowed to int8, 2-bit lanes       acc
    mvu_xnor           packed A and W words (K unit: word)   K - 2 popc(a ^ w)
    mvu_xnor_bits      int32 A packed in-kernel, W words     K - 2 popc(a ^ w)

:func:`dense_launch_plan` picks, from the shape alone, one of its two
arrangements: a warp a column (``gemv``) for M <= 8, or 32 x 32 tiles
double-buffered by ``cp.async`` with K split across a thread-block cluster
when the tiles are too few to fill the card (``tiled``).  Of the coding
only the way W is staged matters here: it sets the tiled arrangement's
shared memory.  The K of a plan is in the coding's K unit: synapses, or
words for ``mvu_xnor``'s packed operands.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from repro_torch.kernels._cuda import k_slices, split_k

# the entry points on the core -> the coding of their W operand
CODING = {"mvu_int": "int8", "mvu_binary": "int8", "mvu_binary_packed": "bitplanes",
          "mvu_int2_packed": "int2", "mvu_xnor": "words", "mvu_xnor_bits": "bits"}
ARRANGEMENTS = ("gemv", "tiled")
GEMV_MAX_M = 8  # rows a gemv warp keeps
GEMV_WARPS = 8  # columns (warps) a gemv block
TILE = 32  # tiled: the output tile, and K units a step
# tiled: the staged epilogue operand (32 columns x up to 16 thresholds, and
# 64 bytes of slack, csrc/cluster_reduce.cuh), then two stages of a (32, 36)
# int32 A slice and the coding's W slice
A_STAGE_BYTES = TILE * (TILE + 4) * 4
EPI_STAGE_BYTES = 32 * 16 * 4 + 64
# How a K step's W is staged, by weight coding: 32 int8 rows of 48 bytes;
# one 32-bit word a column (bitplanes, and the xnor bit entry's W); eight
# bytes of 2-bit lanes a column; 32 words a column, laid out like A.
W_STAGE_BYTES = {"int8": TILE * (TILE + 16), "bitplanes": TILE * 4, "int2": TILE * 8,
                 "words": A_STAGE_BYTES, "bits": TILE * 4}


class DensePlan(NamedTuple):
    """One launch of the dense core: the arrangement, ``tile_m`` x
    ``tile_n`` outputs a block (gemv: up to 8 rows x 8 columns, a warp
    each), K cut into ``splits`` slices of its ``steps`` steps of 32 K
    units (one cluster an output tile), ``smem_bytes`` of dynamic shared
    memory."""
    arrangement: str
    tile_m: int
    tile_n: int
    splits: int
    steps: int
    smem_bytes: int

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The K units [lo, hi) of each K slice, in rank order (gemv: one
        warp's lanes stride the whole K)."""
        if self.arrangement == "gemv":
            return [(0, k)]
        return k_slices(self.steps, self.splits, TILE, k)

    @property
    def c_args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points (arrangement, tile_m,
        tile_n, splits, smem bytes)."""
        return (ARRANGEMENTS.index(self.arrangement), self.tile_m, self.tile_n,
                self.splits, self.smem_bytes)


@functools.lru_cache(maxsize=None)
def dense_launch_plan(m: int, n: int, k: int, coding: str = "int8") -> DensePlan:
    """The launch plan at (M, N, K) for a W ``coding`` (a value of
    :data:`CODING`; K in its unit): a function of the shape and the coding
    alone.
    ``gemv`` for M <= 8, else ``tiled`` with K split (``_cuda.split_k``)
    when the 32 x 32 tiles are too few to fill the card."""
    steps = max(1, -(-k // TILE))
    if m <= GEMV_MAX_M:
        return DensePlan("gemv", GEMV_MAX_M, GEMV_WARPS, 1, steps, 0)
    tiles = -(-m // TILE) * -(-n // TILE)
    smem = EPI_STAGE_BYTES + 2 * (A_STAGE_BYTES + W_STAGE_BYTES[coding])
    return DensePlan("tiled", TILE, TILE, split_k(tiles, steps), steps, smem)
