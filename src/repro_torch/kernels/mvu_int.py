"""Standard-SIMD MVU (paper Fig. 4c) on the H100: the hand CUDA kernel.

``mvu_int`` computes ``out[M, N] = epilogue(A[M, K] . W[N, K]^T)`` with an
int32 accumulator.  It replaces ``src/repro/kernels/mvu_int.py::
mvu_int_pallas`` (``pallas_call`` at line 110).  The kernel source,
``csrc/mvu_int.cu``, runs the dense core of ``csrc/dense_mvu.cuh`` with
int8 weight rows and the activations as they are; it says what bounds it
on the card at the main path's shapes (latency) and what the two
arrangements of :func:`~repro_torch.kernels.dense_mvu.dense_launch_plan`
(a warp a column at M <= 8; ``cp.async`` tiles with cluster split K
above) do about that.

* A CUDA tensor launches the kernel, or the wrapper raises.  There is no
  fallback: only a tensor the caller put on the CPU takes the plain
  version, :func:`mvu_int_plain`.
* The kernel is built with ``nvcc`` from ``csrc/`` at first use and loaded
  with ``ctypes`` (``kernels/_cuda.py``, shared by every wrapper).
  Importing this module builds nothing and imports nothing CUDA-only.
* ``LAUNCHES`` counts kernel launches (and nothing else), so a run can
  show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import check_operands, epilogue_value, int_dot
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N, PLAN_ARGTYPES, Library
from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan

LIB = Library("mvu_int.cu", {"repro_mvu_int": PLAN_ARGTYPES})

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def mvu_int(a: torch.Tensor, w: torch.Tensor,
            thresholds: torch.Tensor | None = None,
            out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
            block_k: int = BLOCK_K, rows_per_tile: int | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A[M,K] . W[N,K]^T); integer datapath.

    a: (M, K) int32 (int8/uint8/int16 are widened; float raises)
    w: (N, K) int8
    thresholds: optional (N, T) int32, ascending -> int32 levels in [0, T]
    out_scale: optional (N,) float32 -> float32 ``float(acc) * s``
    Neither -> the raw int32 accumulator; both -> ValueError.
    block_n / block_k / rows_per_tile: the layer's tile blocks, which pick
    the kernel's compiled tile (``dense_mvu.dense_tile``); the plain
    version takes none.
    """
    global LAUNCHES
    a, epi = check_operands("mvu_int", a, w, thresholds, out_scale, w_dtype=torch.int8)
    if a.device.type == "cpu":
        return mvu_int_plain(a, w, thresholds, out_scale)
    (m, k), n = a.shape, w.shape[0]
    out = LIB.launch("repro_mvu_int", a, w, thresholds, out_scale, epi, n=n, k=k,
                     plan=dense_launch_plan(m, n, k, CODING["mvu_int"], block_n=block_n,
                                            block_k=block_k, rows_per_tile=rows_per_tile).c_args)
    if out.numel():  # an empty output launches nothing
        LAUNCHES += 1
    return out


def mvu_int_plain(a: torch.Tensor, w: torch.Tensor,
                  thresholds: torch.Tensor | None = None,
                  out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on CPU or CUDA tensors; also
    the port's oracle (``ref.mvu_int_ref``) and its ``backend="torch"``:
    :func:`~repro_torch.kernels._common.int_dot`, then the epilogue."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    return epilogue_value(int_dot(a, w), thresholds, out_scale)
