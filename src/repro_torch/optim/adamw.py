"""AdamW with warmup-cosine schedule and global-norm clipping; the port of
the JAX package's ``repro/optim/adamw.py``.

Functional, as the reference: ``update`` returns new trees and never
writes into its arguments.  A tree is the port's nested dict of tensors;
the optimizer state is ``{"mu": tree, "nu": tree, "step": 0-d int32}``
with float32 moments beside each parameter on its device.

Every number stays a device tensor (``schedule`` never syncs the host),
and the arithmetic keeps the reference's float32 order: constants are 0-d
float32 tensors on the operand's device (JAX treats a Python scalar as a
weakly typed float32, while torch may compute with it in another
precision, and CUDA divides by a Python scalar's reciprocal), ``b1 **
step`` is a float32 ``pow`` of the float32 step, ``sqrt`` is correctly
rounded (:func:`_sqrt`), and ``global_norm`` adds the per-leaf float32
sums in the reference's leaf order (dict keys sorted at every level, as
``jax.tree.flatten`` gives them).  ``cos`` and ``pow`` are the device's
float32 functions, which may round differently from XLA's by an ulp.
Per leaf, the step equals the reference's op-by-op arithmetic bit for
bit; the reference compiled under ``jax.jit`` fuses it into FMAs, which
round differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device (a fill: no host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as XLA's: CUDA's float32 sqrt is,
    while torch's vectorised one on the CPU can miss by an ulp, so there
    it is taken in float64 and rounded once (exact for a float32 input)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor): linear warmup
    to ``cfg.lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; float32, on the step's device."""
    step = step.to(torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1), step)
    t = (step - _f32(cfg.warmup_steps, step)) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step)
    t = torch.clamp(t, 0.0, 1.0)
    cos = _f32(cfg.min_lr_frac, step) + _f32((1 - cfg.min_lr_frac) * 0.5, step) * (
        _f32(1.0, step) + torch.cos(_f32(math.pi, step) * t))
    return _f32(cfg.lr, step) * torch.where(step < _f32(cfg.warmup_steps, step), warm, cos)


def init(params) -> dict[str, Any]:
    """Zero float32 moments beside each parameter and a 0-d int32 step on
    the first leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in the reference's order, of each
    leaf's float32 sum of squares."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return _sqrt(total)


def leaf_update(cfg: AdamWConfig, p, g, mu, nu, clip, lr, bc1, bc2):
    """One parameter's AdamW step (the reference's ``upd``): the clipped
    float32 gradient, the moments, ``mhat / (sqrt(vhat) + eps) + wd * p``,
    then ``p - lr * delta`` in float32, cast back to ``p``'s dtype.
    ``clip``, ``lr`` and the bias corrections ``bc1``, ``bc2`` are 0-d
    float32 tensors on ``p``'s device.  Returns (p, mu, nu)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.to(torch.float32) * clip
    mu = _f32(b1, p) * mu + _f32(1 - b1, p) * g
    nu = _f32(b2, p) * nu + _f32(1 - b2, p) * torch.square(g)
    mhat = mu / bc1
    vhat = nu / bc2
    delta = mhat / (_sqrt(vhat) + _f32(cfg.eps, p)) + _f32(
        cfg.weight_decay, p) * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu


def update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, {"grad_norm", "lr"}); the arguments
    are left as they were."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.minimum(_f32(1.0, gnorm),
                         _f32(cfg.grad_clip, gnorm) / (gnorm + _f32(1e-9, gnorm)))
    lr = schedule(cfg, step)
    fstep = step.to(torch.float32)
    bc1 = _f32(1.0, fstep) - torch.pow(_f32(cfg.beta1, fstep), fstep)
    bc2 = _f32(1.0, fstep) - torch.pow(_f32(cfg.beta2, fstep), fstep)
    out = tree_map(lambda p, g, m, n: leaf_update(cfg, p, g, m, n, clip, lr, bc1, bc2),
                   params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}, {
        "grad_norm": gnorm, "lr": lr}
