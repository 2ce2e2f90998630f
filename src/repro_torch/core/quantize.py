"""Quantizers: the integer grid the MVU consumes, and the fake-quantizers
with straight-through estimators (STE) that train onto it; the port of the
JAX package's ``repro/core/quantize.py``.

Conventions
-----------
* ``signed`` integer grids are symmetric: ``[-2^{b-1}+1, 2^{b-1}-1]`` (FINN
  uses symmetric weight quantization so that weight*scale factorizes out).
* ``unsigned`` grids are ``[0, 2^b - 1]`` (post-threshold activations).
* 1-bit weights are bipolar {-1, +1} (paper Fig. 4a/4b).

Each op runs in the operand's dtype with the reference's op order, so the
values and gradients equal the JAX package's op by op, bfloat16 included:
``torch.round`` rounds half to even, as ``jnp.round`` does; constants are
tensors of the operand's dtype on its device (a Python scalar would make
torch multiply in float32, and CUDA divide by its reciprocal); clips are
``min(max(x, lo), hi)``, whose gradient at a bound is 0.5, as
``jnp.clip``'s (``torch.clamp`` gives 1).  :func:`weight_grid` is the grid
both the post-training :func:`quantize_weights` and the QAT
:func:`fake_quant_weights` take, each in its operand's dtype: a float32
weight deploys onto the grid it was trained on, while a bfloat16 weight
trains on its bfloat16 grid and deploys (``quantize_linear_params`` casts
to float32, as the reference's does) onto the float32 grid of the same
values, which can differ by a step where the two scales round apart.
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


def xla_cpu_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 mean of ``x`` over ``dim`` (kept, of size 1), summed in the
    order the JAX package's ``jnp.mean(..., axis=dim)`` sums on the CPU, so
    the 1-bit weight scale equals the reference's to the last bit.

    XLA:CPU rewrites a reduction over more than 32 elements into sums over
    windows of 32 (the axis zero-padded to a whole number of windows, the
    padding split between both ends), then reduces the window sums the
    same way; each window and the last <= 32 values are summed in order.
    The mean is that sum times float32(1 / K), XLA's rewrite of the
    division by a constant.  Every other axis is a batch of independent
    means, each summed in that order.  ``torch.mean`` sums in another order
    and can differ in the last bit.
    """
    dim = dim % x.ndim
    count = x.shape[dim]
    part = x
    while part.shape[dim] > _XLA_WINDOW:
        pad = -part.shape[dim] % _XLA_WINDOW
        spec = (0, 0) * (x.ndim - 1 - dim) + (pad // 2, pad - pad // 2)
        part = torch.nn.functional.pad(part, spec)
        part = _in_order_sum(part.unflatten(dim, (-1, _XLA_WINDOW)), dim + 1)
    inv = torch.tensor(1.0, dtype=torch.float32) / count
    return (_in_order_sum(part, dim) * inv).unsqueeze(dim)


def _in_order_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` first to last, rounding to float32 at each add."""
    acc = torch.zeros(x.shape[:dim] + x.shape[dim + 1:], dtype=torch.float32,
                      device=x.device)
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d constant of ``like``'s dtype on its device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``min(max(x, lo), hi)``, gradient 0.5 at a tie."""
    return torch.minimum(torch.maximum(x, _full(lo, x)), _full(hi, x))


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward ``x + (q - x)`` (which can differ from ``q``
    in the last bit, as the reference's does), gradient of identity in ``x``."""
    return x + (q - x).detach()


def weight_grid(w: torch.Tensor, bits: int, axis: int | None = 0, scale=None):
    """The symmetric weight grid of ``w`` with its scale, in ``w``'s dtype and
    without gradient: ``(grid, scale)``, ``grid * scale`` the quantized weight.

    ``axis`` is the output-channel axis kept un-reduced for the scale; pass
    ``None`` for a single tensor-wide scale.  bits > 1: ``scale =
    max(amax|w|, 1e-8) / hi`` and ``grid = clip(round(w / scale), lo, hi)``.
    bits = 1 (bipolar): ``scale = mean|w|`` per channel (XNOR-Net style) and
    ``grid = sign(w)`` with sign(0) = 1; ``scale``, if given, is that mean,
    computed beforehand (:func:`column_scale`).  The mean of a 2-D weight
    over its other axis -- an (N, K) weight's rows (``axis=0``: deployment,
    the conv weights as (N, Kd^2*C) rows too) or a (d_in, d_out) weight's
    columns (``axis=1``: the LM's fake-quant arm) -- is summed in float32 in
    the order ``jnp.mean`` sums on the CPU (:func:`xla_cpu_mean`;
    ``jnp.mean`` of bfloat16 sums in float32 too), then cast to ``w``'s
    dtype.  A tensor-wide or N-D mean keeps ``torch.mean``, which can
    differ from the reference's in the last bit.
    """
    w = w.detach()
    axes = tuple(i for i in range(w.ndim) if i != axis)
    if bits == 1:
        if scale is not None:
            scale = scale.detach()
        elif w.ndim == 2 and axis in (0, 1):
            scale = xla_cpu_mean(w.abs(), dim=1 - axis).to(w.dtype)
        else:
            scale = w.abs().mean(dim=axes, keepdim=True)
        return torch.where(w >= 0, _full(1, w), _full(-1, w)), scale
    lo, hi = int_bounds(bits, signed=True)
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.maximum(amax, _full(1e-8, amax)) / _full(hi, amax)
    return _clip(torch.round(w / scale), lo, hi), scale


def column_scale(w: torch.Tensor) -> torch.Tensor:
    """The 1-bit scale of (..., d_in, d_out) weights, (..., 1, d_out) in
    ``w``'s dtype, without gradient: for each 2-D weight of the stack what
    ``weight_grid(w_i, 1, axis=1)`` computes, all in one batch of
    :func:`xla_cpu_mean` down the columns."""
    w = w.detach()
    return xla_cpu_mean(w.abs(), dim=-2).to(w.dtype)


def quantize_weights(w: torch.Tensor, bits: int, axis: int | None = 0) -> QTensor:
    """Post-training symmetric weight quantization (per-output-channel) onto
    :func:`weight_grid`, the values in int8."""
    grid, scale = weight_grid(w, bits, axis)
    return QTensor(grid.to(torch.int8), scale, bits, True)


def fake_quant_weights(w: torch.Tensor, bits: int, axis: int | None = 0,
                       scale=None) -> torch.Tensor:
    """QAT fake-quantization of weights with STE (returns the real-valued
    grid ``grid * scale`` of :func:`weight_grid`; bits >= 16: ``w``).  At 1
    bit, ``scale`` may carry the mean computed beforehand (the LM's stack
    computes :func:`column_scale` once a step, outside its remat'd blocks)."""
    if bits >= 16:
        return w
    grid, scale = weight_grid(w, bits, axis, scale)
    return _ste(w, grid * scale)


def quantize_activations(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """Real -> unsigned integer activation grid (what thresholds produce)."""
    lo, hi = int_bounds(bits, signed=False)
    return torch.clamp(torch.round(x / scale), lo, hi).to(torch.int32)


def fake_quant_activations(x: torch.Tensor, bits: int, max_val: float = 1.0) -> torch.Tensor:
    """QAT activation fake-quant: clipped ReLU onto a 2^bits-level grid, STE
    (bits = 1: the step ``x >= 0``; bits >= 16: ``x``)."""
    if bits >= 16:
        return x
    if bits == 1:
        return _ste(x, (x >= 0).to(x.dtype))
    n = 2**bits - 1
    xc = _clip(x, 0.0, max_val)
    q = torch.round(xc * _full(n / max_val, xc)) * _full(max_val / n, xc)
    return _ste(xc, q)


def binarize_bipolar(x: torch.Tensor) -> torch.Tensor:
    """Sign binarization with the BNN clipped-identity STE."""
    q = torch.where(x >= 0, _full(1, x), _full(-1, x))
    return _ste(_clip(x, -1.0, 1.0), q)
