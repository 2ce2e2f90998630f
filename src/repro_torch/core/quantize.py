"""Post-training quantization onto the integer grid the MVU consumes.

Conventions
-----------
* ``signed`` integer grids are symmetric: ``[-2^{b-1}+1, 2^{b-1}-1]`` (FINN
  uses symmetric weight quantization so that weight*scale factorizes out).
* ``unsigned`` grids are ``[0, 2^b - 1]`` (post-threshold activations).
* 1-bit weights are bipolar {-1, +1} (paper Fig. 4a/4b).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the integer
weights and activations equal the JAX reference's.  The Section 6.5 flow
trains with the straight-through trick inline
(``repro_torch.launch.nid_qat``, as the reference's
``benchmarks/nid_mlp.py`` does).  The training side of the reference's
module -- ``fake_quant_weights``, ``fake_quant_activations``, ``_ste`` and
``binarize_bipolar`` -- waits for the LM training step (ROADMAP queue A
item 7, step 3), with the N-D mean in XLA's order that ``fake_quant_weights``
takes down a weight's columns at one bit.
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


# XLA:CPU's tree-reduction rewrite splits a reduction longer than this into
# windows of this many elements (each padded evenly at both ends)
_XLA_WINDOW = 32


def xla_cpu_row_mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean of each row of a 2-D tensor, (N, K) -> (N, 1), summed in
    the order the JAX package's ``jnp.mean(..., axis=1)`` sums on the CPU,
    so the 1-bit weight scale equals the reference's to the last bit.

    XLA:CPU rewrites a reduction over more than 32 elements into sums over
    windows of 32 (the row zero-padded to a whole number of windows, the
    padding split between both ends), then reduces the window sums the
    same way; each window and the last <= 32 values are summed in order.
    The mean is that sum times float32(1 / K), XLA's rewrite of the
    division by a constant.  ``torch.mean`` sums in another order and can
    differ in the last bit.
    """
    count = x.shape[-1]
    rows = x
    while rows.shape[-1] > _XLA_WINDOW:
        pad = -rows.shape[-1] % _XLA_WINDOW
        rows = torch.nn.functional.pad(rows, (pad // 2, pad - pad // 2))
        rows = _in_order_sum(rows.reshape(rows.shape[0], -1, _XLA_WINDOW))
    inv = torch.tensor(1.0, dtype=torch.float32) / count
    return (_in_order_sum(rows) * inv)[:, None]


def _in_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis left to right, rounding to float32 at each add."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def quantize_weights(w: torch.Tensor, bits: int, axis: int | None = 0) -> QTensor:
    """Post-training symmetric weight quantization (per-output-channel).

    ``axis`` is the output-channel axis kept un-reduced for the scale; pass
    ``None`` for a single tensor-wide scale.
    """
    lo, hi = int_bounds(bits, signed=True)
    reduce_axes = (tuple(i for i in range(w.ndim) if i != axis)
                   if axis is not None else tuple(range(w.ndim)))
    if bits == 1:
        # bipolar: scale = mean |w| per channel (XNOR-Net style); an (N, K)
        # weight's rows are summed in the JAX reference's order.  Conv
        # weights arrive here as (N, Kd^2*C) rows too (lowering packs them
        # first); a tensor-wide or N-D mean still uses torch.mean.
        if w.ndim == 2 and axis == 0:
            scale = xla_cpu_row_mean(w.abs())
        else:
            scale = w.abs().mean(dim=reduce_axes, keepdim=True)
        q = torch.where(w >= 0, 1, -1).to(torch.int8)
        return QTensor(q, scale, bits, True)
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / hi
    q = torch.clamp(torch.round(w / scale), lo, hi).to(torch.int8)
    return QTensor(q, scale, bits, True)


def quantize_activations(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """Real -> unsigned integer activation grid (what thresholds produce)."""
    lo, hi = int_bounds(bits, signed=False)
    return torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)
