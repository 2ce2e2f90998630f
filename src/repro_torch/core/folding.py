"""FINN's folding pass: the PE x SIMD cycle model and pipeline balancing.

FINN time-multiplexes the weight matrix (N = O_c rows, K = Kd^2*I_c cols)
onto a PE x SIMD array:

    neuron fold   NF = N / PE        (PE must divide N)
    synapse fold  SF = K / SIMD      (SIMD must divide K)
    cycles per output pixel = NF * SF   at II = 1
    total cycles = n_pixels * NF * SF

The cycle model is the paper's FPGA schedule and gives the JAX reference's
numbers exactly.  What runs on the GPU follows the folding too:
:func:`to_gpu_blocks` maps (PE, SIMD) onto the CUDA kernels' compiled
tiles, as the JAX package's ``to_tpu_blocks`` maps it onto Pallas blocks.

The pipeline balancer reproduces FINN's *Folding and Resource Estimation*
pass: given a cycle target, assign each layer the smallest PE*SIMD product
that meets it, which rate-matches the streaming pipeline (the slowest layer
sets the initiation interval of the whole dataflow graph).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.kernels.packing import WORD_BITS


@dataclasses.dataclass(frozen=True)
class Folding:
    pe: int
    simd: int

    def cycles(self, n: int, k: int, n_pixels: int = 1) -> int:
        nf = -(-n // self.pe)
        sf = -(-k // self.simd)
        return n_pixels * nf * sf

    def conv_cycles(self, n: int, k: int, oh: int, ow: int) -> int:
        """Paper Eq. 1 over the pixel dimension: the SWU feeds one K-window
        per output pixel, so a conv layer costs OH*OW * NF * SF cycles."""
        return self.cycles(n, k, n_pixels=oh * ow)

    def validate(self, n: int, k: int) -> None:
        if n % self.pe:
            raise ValueError(f"PE={self.pe} must divide N={n}")
        if k % self.simd:
            raise ValueError(f"SIMD={self.simd} must divide K={k}")


def divisors(x: int) -> list[int]:
    out = [d for d in range(1, int(math.isqrt(x)) + 1) if x % d == 0]
    return sorted(set(out + [x // d for d in out]))


def weight_mem_depth(n: int, k: int, fold: Folding) -> int:
    """Paper Eq. (2): D_mem = K*N / (SIMD*PE), per-PE weight memory depth."""
    return (k * n) // (fold.simd * fold.pe)


def input_buffer_depth(k: int, fold: Folding) -> int:
    """Input buffer depth K/SIMD (reused across the NF row groups)."""
    return -(-k // fold.simd)


def choose_folding(
    n: int,
    k: int,
    *,
    target_cycles: int | None = None,
    max_pe: int = 128,
    max_simd: int = 128,
    n_pixels: int = 1,
) -> Folding:
    """Smallest PE*SIMD meeting ``target_cycles`` (FINN folding objective).

    With no target, returns the largest legal array (fully-parallel bound).
    Ties break toward larger SIMD (deeper dot products amortize the
    accumulator, mirroring FINN's preference for SIMD before PE).
    """
    pes = [d for d in divisors(n) if d <= max_pe]
    simds = [d for d in divisors(k) if d <= max_simd]
    if target_cycles is None:
        return Folding(max(pes), max(simds))
    best: Folding | None = None
    best_cost = None
    for pe in pes:
        for simd in simds:
            f = Folding(pe, simd)
            if f.cycles(n, k, n_pixels) <= target_cycles:
                cost = (pe * simd, -simd)
                if best_cost is None or cost < best_cost:
                    best, best_cost = f, cost
    if best is None:
        best = Folding(max(pes), max(simds))  # can't meet target: go maximal
    return best


def balance_pipeline(
    layer_shapes: Sequence[tuple[int, int, int]],  # (N, K, n_pixels)
    *,
    slowest_cycles: int | None = None,
    max_pe: int = 128,
    max_simd: int = 128,
) -> list[Folding]:
    """Rate-match a chain of MVU layers (FINN balanced-pipeline condition).

    Every layer gets the cheapest folding whose cycle count does not exceed
    the pipeline target; the default target is the cycle count of the
    heaviest layer at full parallelism (nothing can beat that anyway).
    """
    if slowest_cycles is None:
        slowest_cycles = max(
            Folding(min(max_pe, n), min(max_simd, k)).cycles(n, k, px)
            for n, k, px in layer_shapes
        )
    return [
        choose_folding(n, k, target_cycles=slowest_cycles,
                       max_pe=max_pe, max_simd=max_simd, n_pixels=px)
        for n, k, px in layer_shapes
    ]


def to_gpu_blocks(fold: Folding, mode: str, m: int = 128, *,
                  packed: bool = False) -> dict[str, int]:
    """Map (PE, SIMD) onto the CUDA kernels' tiles: the counterpart of the
    JAX package's ``to_tpu_blocks``.

    ``block_n`` is PE (output columns in parallel) rounded up to the next
    compiled ``tile_n`` (``kernels/dense_mvu.py`` TILE_NS: 32, 64), and
    ``block_k`` SIMD (synapses a step) rounded up to the next compiled K
    step (KSTEPS: 32, 64, 128), each the largest where the folding
    exceeds the set: the minimum is 32, where the TPU's is 8.  The xnor
    and packed binary datapaths step K in 32-bit words and take
    ``block_kw``: their kernels stage one word a column (32 words a row
    for packed xnor operands) a step, whatever SIMD, so it is 32.
    ``block_m`` is the node's burst ``m`` (the engine's microbatch), not
    a kernel tile: the dense kernels' output rows a block and a conv's
    pixels are 32 unless a tuned entry pins ``rows_per_tile``.  The conv kernel takes ``block_n`` and steps K
    by 32 taps, whatever ``block_k``, as the JAX conv kernel ignores it.
    """
    from repro_torch.kernels._cuda import round_up_to
    from repro_torch.kernels.dense_mvu import KSTEPS, TILE_NS

    block_n = round_up_to(fold.pe, TILE_NS)
    if mode == "xnor" or (packed and mode == "binary"):
        return {"block_m": m, "block_n": block_n, "block_kw": KSTEPS[0]}
    return {"block_m": m, "block_n": block_n, "block_k": round_up_to(fold.simd, KSTEPS)}


def block_candidates(
    n: int,
    k: int,
    mode: str,
    *,
    block_ms: Sequence[int] = (32, 128, 256),
    max_block: int = 512,
    packed: bool = False,
) -> list[dict[str, int]]:
    """Enumerate the JAX package's legal tile schedules for an (N, K) layer.

    The same set as the JAX package's ``folding.block_candidates``: the
    layer's folding divisors clamped to block_n / block_k >= 8, plus the
    full-tile defaults; ``block_kw`` (xnor and the packed binary datapath)
    over divisors of the packed word count; packed 2-bit block_k held to
    whole bytes.  Unique dicts; ordering and pruning are the caller's job
    (``repro_torch.core.autotune``, which maps each onto the compiled tile
    it launches and times one candidate a tile).
    """
    bns = sorted({max(8, d) for d in divisors(n)} | {128})
    bns = [b for b in bns if b <= max(max_block, 8)]
    out: list[dict[str, int]] = []
    if mode == "xnor" or (packed and mode == "binary"):
        n_words = -(-k // WORD_BITS)
        bkws = sorted({d for d in divisors(n_words)} | {min(8, n_words)})
        for bm in block_ms:
            for bn in bns:
                for bkw in bkws:
                    out.append({"block_m": bm, "block_n": bn, "block_kw": bkw})
    else:
        bks = sorted({max(8, d) for d in divisors(k)} | {128, min(512, max(8, k))})
        bks = [b for b in bks if b <= max(max_block, 8)]
        if packed:  # 2-bit lane storage: whole bytes per K step
            bks = sorted({-(-b // 4) * 4 for b in bks})
        for bm in block_ms:
            for bn in bns:
                for bk in bks:
                    out.append({"block_m": bm, "block_n": bn, "block_k": bk})
    seen: set[tuple] = set()
    uniq = []
    for c in out:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return uniq
