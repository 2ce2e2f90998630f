"""Analytical resource model -- the paper's LUT/FF/BRAM counts (Section 6.2)
and cycle analysis (6.3) for one MVU layer as the port runs it.

The RTL implementation's virtue in the paper is that its costs are
*predictable by construction*.  This module keeps that closed form:

    LUT analog   -> shared-memory bytes of one CUDA block (A and W tiles)
    FF analog    -> the block's int32 accumulators, held in registers
    BRAM analog  -> buffered memories: weight store + input buffer bytes
    exec cycles  -> folding cycle model (II = 1), the FPGA schedule

Cycles convert to time through the paper's nominal 200 MHz FPGA clock
(``NOMINAL_CLOCK_HZ``); no GPU rate is modelled here.  Times on the H100
are measured by ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.folding import (
    Folding,
    input_buffer_depth,
    to_gpu_blocks,
    weight_mem_depth,
)
from repro_torch.kernels._cuda import BLOCK_M
from repro_torch.kernels.packing import num_int2_bytes, num_words

# The paper's RTL targets a 200 MHz FPGA clock (section 6).
NOMINAL_CLOCK_HZ = 200e6


@dataclasses.dataclass(frozen=True)
class MVUResources:
    lut_bytes: int  # shared memory of one CUDA block
    ff_bytes: int  # int32 accumulators of one CUDA block
    bram_bytes: int  # weight memory + input buffer
    weight_mem_depth: int
    input_buffer_depth: int
    cycles: int
    macs: int
    ns_per_inference: float  # cycles at the nominal FPGA clock
    weight_bytes: int = 0  # device-resident weight bytes as stored
    canonical_weight_bytes: int = 0  # same weights without packing

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def weight_resident_bytes(n: int, k: int, mode: str, packed: bool) -> int:
    """Device-resident bytes of one (N, K) weight matrix as actually stored.

    Canonical storage is int8 rows for binary/standard; the xnor coding is
    always bit-packed (its canonical form IS uint32 words).  Packed binary
    stores uint32 bitplanes (8x smaller than int8 rows); packed standard
    stores 4x 2-bit lanes per byte.
    """
    if mode == "xnor" or (packed and mode == "binary"):
        return n * num_words(k) * 4
    if packed:
        return n * num_int2_bytes(k)
    return n * k  # canonical int8 rows


def mvu_resources(
    n: int,
    k: int,
    fold: Folding,
    *,
    mode: str = "standard",
    weight_bits: int = 4,
    n_pixels: int = 1,
    packed: bool = False,
) -> MVUResources:
    """Closed-form resource estimate for one MVU layer instance.

    ``lut_bytes`` is the CUDA kernel's shared memory for the tile the
    folding picks (:func:`to_gpu_blocks`; the default 32 output rows a
    block): a (block_k, rows) int32 A tile and a (block_k, block_n) int32
    W tile, each row padded by one word against bank conflicts.
    ``ff_bytes`` is the block's rows x block_n int32 accumulators.
    BRAM/cycle terms stay on the folding abstraction (paper Eq. 1/2) and
    equal the JAX reference's.
    """
    blocks = to_gpu_blocks(fold, mode, packed=packed)
    bm, bn = BLOCK_M, blocks["block_n"]
    bk = blocks.get("block_k", blocks.get("block_kw"))
    lut = bk * (bm + 1) * 4 + bk * (bn + 1) * 4
    ff = bm * bn * 4
    weight_store = int(n * k * weight_bits / 8.0)
    in_buf = k // 8 if mode == "xnor" else k  # packed bits / int8 lanes
    cycles = fold.cycles(n, k, n_pixels)
    return MVUResources(
        lut_bytes=lut,
        ff_bytes=ff,
        bram_bytes=weight_store + in_buf,
        weight_mem_depth=weight_mem_depth(n, k, fold),
        input_buffer_depth=input_buffer_depth(k, fold),
        cycles=cycles,
        macs=n * k * n_pixels,
        ns_per_inference=cycles / NOMINAL_CLOCK_HZ * 1e9,
        weight_bytes=weight_resident_bytes(n, k, mode, packed),
        canonical_weight_bytes=weight_resident_bytes(n, k, mode, False),
    )


# ---------------------------------------------------------- calibration
def fit_cycle_time(cycles, seconds) -> float:
    """Least-squares seconds-per-cycle over paired (cycles, measured s).

    The analytic model predicts *cycles*; turning them into wall-clock
    needs a realized cycle time.  Fitting one scalar across a whole sweep
    (every node of every design point) is the calibration the paper does
    implicitly when it reads its RTL cycle counts against a known clock:
    ``argmin_s sum_i (c_i * s - m_i)^2  =  sum(c*m) / sum(c^2)``.
    """
    c = [float(v) for v in cycles]
    m = [float(v) for v in seconds]
    if len(c) != len(m) or not c:
        raise ValueError("fit_cycle_time needs equal, non-empty sequences")
    denom = sum(v * v for v in c)
    if denom <= 0:
        raise ValueError("fit_cycle_time needs at least one non-zero cycle count")
    return sum(cv * mv for cv, mv in zip(c, m)) / denom


def cycle_model_errors(cycles, seconds, s_per_cycle: float | None = None
                       ) -> list[float]:
    """Signed relative error of the calibrated cycle model per sample:
    ``(predicted - measured) / measured`` with ``predicted = c * s``."""
    if s_per_cycle is None:
        s_per_cycle = fit_cycle_time(cycles, seconds)
    out = []
    for c, m in zip(cycles, seconds):
        m = float(m)
        if m <= 0:
            raise ValueError("measured seconds must be positive")
        out.append((float(c) * s_per_cycle - m) / m)
    return out


def error_summary(errors) -> dict:
    """Distribution summary of signed relative errors (JSON-safe).

    ``p50/p90/max`` are over |error|: the claim is "the calibrated model
    lands within X% of the measurement for 90% of (node, design) pairs",
    not a statement about bias direction.
    """
    errs = [float(e) for e in errors]
    if not errs:
        return {"n": 0}
    mags = sorted(abs(e) for e in errs)

    def pct(q: float) -> float:
        idx = min(len(mags) - 1, max(0, int(round(q * (len(mags) - 1)))))
        return mags[idx]

    return {
        "n": len(errs),
        "mean_abs": sum(mags) / len(mags),
        "p50_abs": pct(0.50),
        "p90_abs": pct(0.90),
        "max_abs": mags[-1],
        "mean_signed": sum(errs) / len(errs),
    }
