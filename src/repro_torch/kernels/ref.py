"""Plain PyTorch oracles for the MVU kernels (the "golden model").

The standard and binary oracles are the hand kernels' plain versions
(:func:`repro_torch.kernels.mvu_int.mvu_int_plain`,
:func:`repro_torch.kernels.mvu_binary.mvu_binary_plain`), kept in one place
so the two cannot drift apart: the integer product summed in int64 and
truncated to int32 (the int32 dot with wraparound the JAX reference
computes), then the epilogue :func:`repro_torch.kernels._common.
epilogue_value`.  The xnor oracle unpacks first, like the JAX package's.
The conv oracle materialises the sliding windows (``core/swu.py``) and runs
the mode's MVU oracle on them.  The tests hold each to the JAX package's
oracle and Pallas kernel on the same inputs.

Shapes follow the paper's GEMM view (Fig. 1):
  activations A: (M, K); weights W: (N, K); output: (M, N)
"""

from __future__ import annotations

import torch

from repro_torch.core import swu
from repro_torch.kernels import packing
from repro_torch.kernels.mvu_binary import mvu_binary_plain
from repro_torch.kernels.mvu_int import mvu_int_plain

# Standard (arbitrary-precision) MVU oracle: int x int -> int32 acc -> epilogue.
mvu_int_ref = mvu_int_plain

# Binary-weight MVU oracle: a (M, K) int, w_bits (N, K) in {0,1} ~ {-1,+1}.
mvu_binary_ref = mvu_binary_plain


def mvu_xnor_ref(a_packed: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
                 thresholds: torch.Tensor | None = None,
                 out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """XNOR-popcount MVU oracle on packed operands (int32 words, zero pad
    bits): unpack over the true K = ``k_bits`` synapses to +/-1, then the
    integer dot."""
    a = packing.bits_to_bipolar(packing.unpack_bits(a_packed, k_bits))
    w = packing.bits_to_bipolar(packing.unpack_bits(w_packed, k_bits))
    return mvu_int_plain(a, w, thresholds, out_scale)


def conv_mvu_ref(x: torch.Tensor, w: torch.Tensor, *, kernel: int, stride: int = 1,
                 pad: int = 0, mode: str = "standard",
                 thresholds: torch.Tensor | None = None,
                 out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Fused-conv oracle: materialised SWU + the mode's MVU oracle.

    x: (B, H, W, C) integers, taken as they are (int32, no narrowing);
    w: (N, Kd^2*C) in (ky, kx, c) order -- integer rows (standard) or
    {0,1}-coded +/-1 rows (binary, xnor).  Returns (B, OH*OW, N).  This is
    the "HLS" path: it pays the im2col blow-up the fused kernel avoids.
    """
    cols = swu.sliding_window(x.to(torch.int32), kernel, stride, pad)  # (B, P, K)
    a = cols.reshape(-1, cols.shape[-1])
    if mode == "xnor":
        # a pad tap is stored-bit 0, bipolar -1, like every other 0 bit
        out = mvu_int_plain(packing.bits_to_bipolar(a), packing.bits_to_bipolar(w),
                            thresholds, out_scale)
    elif mode == "binary":
        out = mvu_binary_ref(a, w, thresholds, out_scale)
    else:
        out = mvu_int_ref(a, w, thresholds, out_scale)
    return out.reshape(x.shape[0], cols.shape[1], -1)
