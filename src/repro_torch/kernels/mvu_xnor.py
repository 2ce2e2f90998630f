"""XNOR-popcount MVU (paper Fig. 4a) on the H100: the hand CUDA kernel.

``mvu_xnor`` takes 1-bit activations and weights packed 32 synapses to a
word (int32 bit patterns, ``packing.pack_bits``) and computes

    out[M, N] = epilogue(2 * sum_w popcount(~(a ^ w)) - pad_correction(K))

the bipolar dot product over the true K = ``k_bits`` synapses.  It
replaces ``src/repro/kernels/mvu_xnor.py::mvu_xnor_pallas`` (``pallas_call``
at line 121); the source is ``csrc/mvu_xnor.cu``.  Like every wrapper: a
CUDA tensor launches the kernel or raises, a CPU tensor takes the plain
version :func:`mvu_xnor_plain`, and ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import packing
from repro_torch.kernels import _common
from repro_torch.kernels._common import check_operands, epilogue_value
from repro_torch.kernels._cuda import ARGTYPES, Library

LIB = Library("mvu_xnor.cu", {"repro_mvu_xnor": ARGTYPES})

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def _check_k(k_bits: int, wd: int) -> None:
    if k_bits < 0:
        raise ValueError(f"bit count must be non-negative, got {k_bits}")
    if wd >= 2**25:
        raise ValueError(f"{wd} words exceed the kernel's int32 popcount sum")
    packing.pad_correction(k_bits, wd * packing.WORD_BITS)  # raises if K > Wd*32


def mvu_xnor(a_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
             thresholds: torch.Tensor | None = None,
             out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Bipolar out[M, N] from a (M, Wd) and w (N, Wd), both int32 words.

    thresholds: optional (N, T) int32 -> int32 levels; out_scale: optional
    (N,) float32 -> float32; neither -> the raw int32 dot.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_xnor", a_packed, w_packed, thresholds, out_scale,
                            w_dtype=torch.int32, words=True)
    _check_k(k_bits, a.shape[1])
    if a.device.type == "cpu":
        return mvu_xnor_plain(a, w_packed, k_bits, thresholds, out_scale)
    out = LIB.launch("repro_mvu_xnor", a, w_packed, thresholds, out_scale, epi,
                     n=w_packed.shape[0], k=k_bits)
    if out.numel():  # an empty output launches nothing
        LAUNCHES += 1
    return out


def mvu_xnor_plain(a_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
                   thresholds: torch.Tensor | None = None,
                   out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the packed domain: XNOR,
    popcount and the pad correction, on CPU or CUDA tensors.  It is also the
    port of the JAX package's ``mvu_packed.mvu_xnor_popcount_xla`` (no
    unpack), chunked over M so the (rows, N, Wd) int64 popcount stays under
    ``PLAIN_CHUNK_BYTES``."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    m, wd = a_packed.shape
    n = w_packed.shape[0]
    rows = max(1, _common.PLAIN_CHUNK_BYTES // max(1, 8 * n * wd))
    pcs = [packing.popcount(~(a_packed[i:i + rows, None, :] ^ w_packed[None]))
           .sum(-1, dtype=torch.int32) for i in range(0, m, rows)]
    pc = torch.cat(pcs) if pcs else torch.zeros((0, n), dtype=torch.int32,
                                                device=a_packed.device)
    dot = 2 * pc - packing.pad_correction(k_bits, wd * packing.WORD_BITS)
    return epilogue_value(dot.to(torch.int32), thresholds, out_scale)
