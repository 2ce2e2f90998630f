"""The launch plan of the CUDA-core dense MVU core (``csrc/dense_mvu.cuh``).

Five hand kernels run that core (six entry points), each with its own
operand coding:

    mvu_int            int32 A, int8 W rows                  acc
    mvu_binary         int32 A, int8 W rows                  2 acc - rowsum
    mvu_binary_packed  A narrowed to int8, 32-bit bitplanes  2 acc - rowsum
    mvu_int2_packed    A narrowed to int8, 2-bit lanes       acc
    mvu_xnor           packed A and W words (K unit: word)   K - 2 popc(a ^ w)
    mvu_xnor_bits      int32 A packed in-kernel, W words     K - 2 popc(a ^ w)

:func:`dense_launch_plan` picks one of the core's two arrangements from
the shape: a warp a column (``gemv``) for M <= 8, which has no tile, or
``tiled``: tiles double-buffered by ``cp.async`` with K split across a
thread-block cluster when the tiles are too few to fill the card.  The
tile is one of :data:`DENSE_TILES`, the set the kernels are compiled for:
``tile_n`` (output columns a block) and ``kstep`` (K units a step) come
from the layer's ``block_n`` / ``block_k``, rounded up onto the set (the
folding's PE and SIMD, ``core/folding.py::to_gpu_blocks``, or a tuned
entry), ``tile_m`` (output rows a block) 32, or 64 where a tuned entry's
``rows_per_tile`` pins it on the one tile compiled that tall.  Of the coding only two things
matter here: the way W is staged sets the shared memory, and the word
codings (bitplanes, packed and bit xnor) step K by 32 only.  The K of a
plan is in the coding's K unit: synapses, or words for ``mvu_xnor``'s
packed operands.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from repro_torch.kernels._cuda import (
    BLOCK_K,
    BLOCK_N,
    k_slices,
    round_up_to,
    split_k,
)

# the entry points on the core -> the coding of their W operand
CODING = {"mvu_int": "int8", "mvu_binary": "int8", "mvu_binary_packed": "bitplanes",
          "mvu_int2_packed": "int2", "mvu_xnor": "words", "mvu_xnor_bits": "bits"}
ARRANGEMENTS = ("gemv", "tiled")
GEMV_MAX_M = 8  # rows a gemv warp keeps
GEMV_WARPS = 8  # columns (warps) a gemv block
TILE = BLOCK_N  # the default tile: 32 rows x 32 columns, 32 K units a step

# The compiled tiles (tile_m, tile_n, kstep), by the index the C entry
# points dispatch on (csrc/dense_mvu.cuh with_tile): 32 rows at every
# tile_n and K step a coding has -- the folding's PE and SIMD round onto
# those axes one by one -- and one taller tile, 64 x 32 x 32.  K steps of
# 64 and 128 exist only for WIDE_K; the 32-unit tiles come first.
TILE_NS = (32, 64)
KSTEPS = (32, 64, 128)
DENSE_TILES = ((32, 32, 32), (32, 64, 32), (64, 32, 32),
               (32, 32, 64), (32, 64, 64), (32, 32, 128), (32, 64, 128))
WIDE_K = ("int8", "int2")  # codings that step K by 64 and 128 too


def ksteps(coding: str) -> tuple[int, ...]:
    """The K steps a coding's kernel is compiled for."""
    return KSTEPS if coding in WIDE_K else KSTEPS[:1]


def tiles(coding: str) -> tuple[tuple[int, int, int], ...]:
    """The (tile_m, tile_n, kstep) tiles a coding's kernel is compiled for."""
    return tuple(t for t in DENSE_TILES if t[2] in ksteps(coding))


def a_stage_bytes(tile_m: int, kstep: int) -> int:
    """A K step's staged A: tile_m int32 rows of kstep + 4 words."""
    return tile_m * (kstep + 4) * 4


def w_stage_bytes(coding: str, tile_n: int, kstep: int) -> int:
    """A K step's staged W, by coding: tile_n int8 rows of kstep + 16 bytes;
    one 32-bit word a column (bitplanes, and the xnor bit entry's W);
    kstep / 4 bytes of 2-bit lanes a column; tile_n rows of words laid out
    like A (xnor words)."""
    return {"int8": tile_n * (kstep + 16), "bitplanes": tile_n * 4, "int2": tile_n * kstep // 4,
            "words": a_stage_bytes(tile_n, kstep), "bits": tile_n * 4}[coding]


def epi_stage_bytes(tile_n: int) -> int:
    """The staged epilogue operand: tile_n columns x up to 16 thresholds,
    and 64 bytes of slack (``csrc/cluster_reduce.cuh``)."""
    return tile_n * 16 * 4 + 64


def tiled_smem_bytes(coding: str, tile_m: int, tile_n: int, kstep: int) -> int:
    """Dynamic shared memory of a tiled block: the staged epilogue operand,
    then two stages of A and W, which the (tile_m, tile_n) uint32 partial
    tile of a cluster sum reuses (``tiled_smem`` in the source)."""
    stages = 2 * (a_stage_bytes(tile_m, kstep) + w_stage_bytes(coding, tile_n, kstep))
    return epi_stage_bytes(tile_n) + max(stages, tile_m * tile_n * 4)


# a K step's staged W at the default tile, by coding
W_STAGE_BYTES = {c: w_stage_bytes(c, TILE, TILE) for c in set(CODING.values())}


def dense_tile(coding: str = "int8", *, block_n: int = BLOCK_N, block_k: int = BLOCK_K,
               rows_per_tile: int | None = None) -> tuple[int, int, int]:
    """The compiled tile (tile_m, tile_n, kstep) a tiled launch takes:
    ``block_n`` and ``block_k`` rounded up onto the coding's ``tile_n``
    and K steps (the largest where they exceed them), then 32 rows, or
    ``rows_per_tile`` rounded up onto the rows compiled for that
    (tile_n, kstep) where a tuned entry pins it."""
    tile_n = round_up_to(block_n, TILE_NS)
    kstep = round_up_to(block_k, ksteps(coding))
    rows = tuple(t[0] for t in tiles(coding) if t[1:] == (tile_n, kstep))
    tile_m = rows[0] if rows_per_tile is None else round_up_to(rows_per_tile, rows)
    return tile_m, tile_n, kstep


class DensePlan(NamedTuple):
    """One launch of the dense core: the arrangement, ``tile_m`` x
    ``tile_n`` outputs a block (gemv: up to 8 rows x 8 columns, a warp
    each), K cut into ``splits`` slices of its ``steps`` steps of
    ``kstep`` K units (one cluster an output tile), ``smem_bytes`` of
    dynamic shared memory, ``tile`` the index of the compiled tile in
    :data:`DENSE_TILES` (-1: gemv, which has no tile and strides K in
    32-unit steps)."""
    arrangement: str
    tile_m: int
    tile_n: int
    splits: int
    steps: int
    smem_bytes: int
    kstep: int = TILE
    tile: int = 0

    def k_slices(self, k: int) -> list[tuple[int, int]]:
        """The K units [lo, hi) of each K slice, in rank order (gemv: one
        warp's lanes stride the whole K)."""
        if self.arrangement == "gemv":
            return [(0, k)]
        return k_slices(self.steps, self.splits, self.kstep, k)

    @property
    def c_args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points (arrangement, tile
        index, tile_m, tile_n, kstep, splits, smem bytes)."""
        return (ARRANGEMENTS.index(self.arrangement), self.tile, self.tile_m, self.tile_n,
                self.kstep, self.splits, self.smem_bytes)


@functools.lru_cache(maxsize=None)
def dense_launch_plan(m: int, n: int, k: int, coding: str = "int8", *,
                      block_n: int = BLOCK_N, block_k: int = BLOCK_K,
                      rows_per_tile: int | None = None) -> DensePlan:
    """The launch plan at (M, N, K) for a W ``coding`` (a value of
    :data:`CODING`; K in its unit) and a layer's tile blocks: ``gemv``
    for M <= 8 (the blocks do not act), else ``tiled`` on
    :func:`dense_tile`'s tile with K split (``_cuda.split_k``) when the
    tiles are too few to fill the card."""
    if m <= GEMV_MAX_M:
        return DensePlan("gemv", GEMV_MAX_M, GEMV_WARPS, 1, max(1, -(-k // TILE)), 0, TILE, -1)
    tm, tn, tk = dense_tile(coding, block_n=block_n, block_k=block_k,
                            rows_per_tile=rows_per_tile)
    steps = max(1, -(-k // tk))
    tiles_ = -(-m // tm) * -(-n // tn)
    return DensePlan("tiled", tm, tn, split_k(tiles_, steps), steps,
                     tiled_smem_bytes(coding, tm, tn, tk), tk, DENSE_TILES.index((tm, tn, tk)))
