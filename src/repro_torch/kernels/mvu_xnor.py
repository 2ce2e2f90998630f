"""XNOR-popcount MVU (paper Fig. 4a) on the H100: the hand CUDA kernel.

``mvu_xnor`` takes 1-bit activations and weights packed 32 synapses to a
word (int32 bit patterns, ``packing.pack_bits``) and computes

    out[M, N] = epilogue(2 * sum_w popcount(~(a ^ w)) - pad_correction(K))

the bipolar dot product over the true K = ``k_bits`` synapses.  It
replaces ``src/repro/kernels/mvu_xnor.py::mvu_xnor_pallas`` (``pallas_call``
at line 121); the source is ``csrc/mvu_xnor.cu``, the dense core of
``csrc/dense_mvu.cuh`` in the arrangement that
:func:`~repro_torch.kernels.dense_mvu.dense_launch_plan` picks.  Two entry
points, one kernel and one launch counter:

* :func:`mvu_xnor`, on packed (M, Wd) activation words, the counterpart of
  ``mvu_xnor_pallas`` (coding ``"words"``, K counted in words);
* :func:`mvu_xnor_bits`, on the (M, K) int32 activations as they stream
  between the engine's nodes: the kernel packs their LSBs where it reads
  them, so it computes ``mvu_xnor(pack_bits(a), w, K)`` with no pack on
  the host (coding ``"bits"``).  The engine's xnor stages call it on the
  card (``core/dataflow.py``).

Like every wrapper: a CUDA tensor launches the kernel or raises, a CPU
tensor takes the plain version (:func:`mvu_xnor_plain`,
:func:`mvu_xnor_bits_plain`), and ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import packing
from repro_torch.kernels import _common
from repro_torch.kernels._common import check_operands, epilogue_value
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N, PLAN_ARGTYPES, Library
from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan

LIB = Library("mvu_xnor.cu", {"repro_mvu_xnor": PLAN_ARGTYPES,
                              "repro_mvu_xnor_bits": PLAN_ARGTYPES})

# Kernel launches since import (or since a caller reset it to 0), both entries.
LAUNCHES = 0


def _check_k(k_bits: int, wd: int) -> None:
    if k_bits < 0:
        raise ValueError(f"bit count must be non-negative, got {k_bits}")
    if wd >= 2**25:
        raise ValueError(f"{wd} words exceed the kernel's int32 popcount sum")
    packing.pad_correction(k_bits, wd * packing.WORD_BITS)  # raises if K > Wd*32


def mvu_xnor(a_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
             thresholds: torch.Tensor | None = None,
             out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
             block_kw: int = BLOCK_K, rows_per_tile: int | None = None) -> torch.Tensor:
    """Bipolar out[M, N] from a (M, Wd) and w (N, Wd), both int32 words.

    thresholds: optional (N, T) int32 -> int32 levels; out_scale: optional
    (N,) float32 -> float32; neither -> the raw int32 dot.  block_n /
    block_kw / rows_per_tile pick the kernel's compiled tile
    (``dense_mvu.dense_tile``; the word codings step K by 32 whatever
    block_kw); the plain version takes none.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_xnor", a_packed, w_packed, thresholds, out_scale,
                            w_dtype=torch.int32, words=True)
    (m, wd), n = a.shape, w_packed.shape[0]
    _check_k(k_bits, wd)
    if a.device.type == "cpu":
        return mvu_xnor_plain(a, w_packed, k_bits, thresholds, out_scale)
    out = LIB.launch("repro_mvu_xnor", a, w_packed, thresholds, out_scale, epi, n=n,
                     k=k_bits, plan=dense_launch_plan(
                         m, n, wd, CODING["mvu_xnor"], block_n=block_n, block_k=block_kw,
                         rows_per_tile=rows_per_tile).c_args)
    if out.numel():  # an empty output launches nothing
        LAUNCHES += 1
    return out


def mvu_xnor_bits(a: torch.Tensor, w_packed: torch.Tensor,
                  thresholds: torch.Tensor | None = None,
                  out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
                  block_kw: int = BLOCK_K, rows_per_tile: int | None = None) -> torch.Tensor:
    """``mvu_xnor(pack_bits(a), w_packed, K)`` with the pack made in the
    kernel: a (M, K) integer activations, of which only the LSB counts
    (int8/uint8/int16 are widened); w_packed (N, ceil(K/32)) int32 words.
    The tile blocks act as for :func:`mvu_xnor`.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_xnor_bits", a, w_packed, thresholds, out_scale,
                            w_dtype=torch.int32, lanes_per_col=packing.WORD_BITS)
    (m, k), (n, wd) = a.shape, w_packed.shape
    if wd != packing.num_words(k):
        raise ValueError(f"mvu_xnor_bits: w {tuple(w_packed.shape)} must hold "
                         f"ceil(K/32) = {packing.num_words(k)} words a row for K = {k}")
    _check_k(k, wd)
    if a.device.type == "cpu":
        return mvu_xnor_bits_plain(a, w_packed, thresholds, out_scale)
    out = LIB.launch("repro_mvu_xnor_bits", a, w_packed, thresholds, out_scale, epi, n=n,
                     k=k, plan=dense_launch_plan(
                         m, n, k, CODING["mvu_xnor_bits"], block_n=block_n, block_k=block_kw,
                         rows_per_tile=rows_per_tile).c_args)
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


def mvu_xnor_bits_plain(a: torch.Tensor, w_packed: torch.Tensor,
                        thresholds: torch.Tensor | None = None,
                        out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The bit entry's function in plain PyTorch: pack the LSBs of a, then
    :func:`mvu_xnor_plain` over its K = a.shape[1] synapses."""
    return mvu_xnor_plain(packing.pack_bits(a), w_packed, a.shape[1], thresholds, out_scale)
