"""Plain PyTorch oracle for the standard MVU (the "golden model").

The oracle is the hand kernel's plain version,
:func:`repro_torch.kernels.mvu_int.mvu_int_plain`, kept in one place so the
two cannot drift apart: the integer product summed in int64 and truncated
to int32 (the int32 dot with wraparound the JAX reference computes), then
the epilogue :func:`repro_torch.kernels._common.epilogue_value`.  The tests
hold it to the JAX package's oracle and Pallas kernel on the same inputs.

Shapes follow the paper's GEMM view (Fig. 1):
  activations A: (M, K); weights W: (N, K); output: (M, N)
"""

from __future__ import annotations

from repro_torch.kernels.mvu_int import mvu_int_plain

# Standard (arbitrary-precision) MVU oracle: int x int -> int32 acc -> epilogue.
mvu_int_ref = mvu_int_plain
