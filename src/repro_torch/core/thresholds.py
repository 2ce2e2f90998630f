"""Multi-threshold activation: FINN's fused BatchNorm + quantized activation.

FINN's MVU is really an MV*T*U: after the integer dot product it compares the
accumulator against a sorted per-channel threshold vector and emits

    act[c] = sum_t  (acc[c] >= T[c, t])        in  [0, 2^bits - 1]

which is exactly ``quantize(BN(acc))`` once BN and the activation quantizer
are folded into integer thresholds (the FINN "streamlining" pass).  This
module computes those thresholds and provides the reference epilogue; the
MVU kernel fuses the same comparison loop after its accumulator.

Negative BN gamma flips the comparison direction.  As in FINN streamlining we
normalize that offline: rows with gamma < 0 have their weights (and
thresholds) negated so the kernel only ever implements ``>=``.

The float32 operations below run one at a time in the same order as the
JAX reference, so the integer thresholds equal its thresholds exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ThresholdSpec(NamedTuple):
    thresholds: torch.Tensor  # (out_channels, n_levels - 1), ascending per row
    bits: int  # output activation bits; n_levels = 2**bits


def apply_thresholds(acc: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Reference epilogue: acc (..., C), thresholds (C, T) -> (..., C) int32."""
    return (acc[..., None] >= thresholds).sum(-1).to(torch.int32)


def bn_quant_thresholds(
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    *,
    bits: int,
    acc_scale: float | torch.Tensor = 1.0,
    act_scale: float | torch.Tensor = 1.0,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold ``quant(BN(acc * acc_scale))`` into real accumulator thresholds.

    The quantizer maps real y to level j when  y >= (j - 0.5) * act_scale
    for j = 1..2^bits - 1.  Solving  BN(acc*acc_scale) >= y_j  for acc gives

        T[c, j] = ((y_j - beta[c]) * sqrt(var[c] + eps) / gamma[c] + mean[c])
                  / acc_scale

    Returns ``(thresholds, flip)`` where ``flip[c]`` is True for channels with
    gamma < 0; callers negate those weight rows (the returned rows are
    already negated and re-sorted) -- see :func:`streamline_signs`.  Take
    ``ceil`` for integer accumulators (:func:`integerize_thresholds`).
    """
    n_levels = 2**bits
    j = torch.arange(1, n_levels, dtype=torch.float32, device=gamma.device)
    y = (j - 0.5) * torch.as_tensor(act_scale, dtype=torch.float32,
                                    device=gamma.device)
    std = torch.sqrt(var + eps)
    g = torch.where(gamma == 0, 1e-12, gamma)
    t = ((y[None, :] - beta[:, None]) * (std / g)[:, None] + mean[:, None]) / acc_scale
    flip = gamma < 0
    # for flipped rows the weight negation maps acc -> -acc, so T -> -T and
    # the per-row threshold order reverses; re-sort ascending.
    t = torch.where(flip[:, None], -t.flip(1), t)
    return t, flip


def streamline_signs(w: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Negate the weight rows whose BN gamma was negative (w: (out, in))."""
    return torch.where(flip[:, None], -w, w)


def integerize_thresholds(t: torch.Tensor) -> torch.Tensor:
    """Real thresholds -> smallest integers giving identical >= decisions.

    Out-of-range values saturate to the int32 limits and NaN maps to 0, as
    in XLA's float -> int32 conversion; a plain ``.to(torch.int32)`` on the
    CPU turns them into INT32_MIN (a channel with gamma == 0 has
    thresholds of order 1e12).
    """
    c = torch.ceil(t).nan_to_num(nan=0.0).clamp(-2.0**31, 2.0**31)
    return c.to(torch.int64).clamp(-2**31, 2**31 - 1).to(torch.int32)
