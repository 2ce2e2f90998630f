"""Shared pieces of the MVU kernels' plain versions.

The hand kernel (``csrc/mvu_int.cu``) fuses the same epilogue after its
int32 accumulator; :func:`epilogue_value` is that epilogue written once in
PyTorch, in the same priority: thresholds > scale > raw accumulator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.thresholds import apply_thresholds


def epilogue_value(acc: torch.Tensor, thresholds: torch.Tensor | None,
                   out_scale: torch.Tensor | None) -> torch.Tensor:
    """MVTU epilogue of an (M, N) int32 accumulator."""
    if thresholds is not None:
        # act = sum_t (acc >= T[n, t]) -- the multi-threshold unit.
        return apply_thresholds(acc, thresholds)
    if out_scale is not None:
        return acc.to(torch.float32) * out_scale.reshape(1, -1)
    return acc


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0) -> torch.Tensor:
    """Pad ``axis`` at its end up to a whole multiple of ``multiple``."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs starting from the LAST axis
    pad[2 * (x.ndim - 1 - axis) + 1] = rem
    return F.pad(x, pad, value=value)
