"""Post-training weight quantization onto the integer grid the MVU consumes.

Conventions
-----------
* ``signed`` integer grids are symmetric: ``[-2^{b-1}+1, 2^{b-1}-1]`` (FINN
  uses symmetric weight quantization so that weight*scale factorizes out).
* ``unsigned`` grids are ``[0, 2^b - 1]`` (post-threshold activations).
* 1-bit weights are bipolar {-1, +1} (paper Fig. 4a/4b).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the integer
weights equal the JAX reference's.  Fake-quantizers and straight-through
estimators come with the QAT slice (ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def int_bounds(bits: int, signed: bool) -> tuple[int, int]:
    if bits == 1 and signed:
        return -1, 1  # bipolar
    if signed:
        return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


class QTensor(NamedTuple):
    """An integer tensor plus the scale taking it back to real values."""

    values: torch.Tensor  # integer grid (int8)
    scale: torch.Tensor  # per-channel or scalar: real = values * scale
    bits: int
    signed: bool


def quantize_weights(w: torch.Tensor, bits: int, axis: int | None = 0) -> QTensor:
    """Post-training symmetric weight quantization (per-output-channel).

    ``axis`` is the output-channel axis kept un-reduced for the scale; pass
    ``None`` for a single tensor-wide scale.
    """
    lo, hi = int_bounds(bits, signed=True)
    reduce_axes = (tuple(i for i in range(w.ndim) if i != axis)
                   if axis is not None else tuple(range(w.ndim)))
    if bits == 1:
        # bipolar: scale = mean |w| per channel (XNOR-Net style)
        scale = w.abs().mean(dim=reduce_axes, keepdim=True)
        q = torch.where(w >= 0, 1, -1).to(torch.int8)
        return QTensor(q, scale, bits, True)
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / hi
    q = torch.clamp(torch.round(w / scale), lo, hi).to(torch.int8)
    return QTensor(q, scale, bits, True)
