"""Mixture-of-Experts FFN: top-k routing with capacity-grouped one-hot
dispatch (GShard/Switch style); the port of the JAX package's
``repro/models/moe.py``.

Tokens are processed in groups of ``group_size``; each expert owns
``capacity = group_size * top_k * capacity_factor / num_experts`` slots per
group.  Overflow tokens are dropped (their residual stream passes through),
the standard dropping-MoE training formulation.

The expert products are the reference's einsums, here ``torch.einsum``
over every expert's slots (the reference leaves them to XLA outside any
Pallas kernel, so no hand kernel stands behind them).  The reference's
dtypes are kept: the router in float32 even in a bfloat16 model, the
tokens and the dispatch tensor in bfloat16, each product in the type
``jnp.result_type`` gives its operands (``torch.einsum`` takes no mixed
operands, so each is cast to that type first), and the combine weights
in the expert outputs' type.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Params, _normal, activation, is_gated


def moe_init(generator, cfg, dtype=torch.bfloat16, device="cpu", *,
             n: int | None = None) -> Params:
    """One MoE FFN's params: the router float32, the experts in ``dtype``.
    With ``n``, ``n`` of them stacked on a leading axis, drawn as ``n``
    calls draw them: each leaf is allocated once and each FFN's draws are
    cast into its slice, so one float32 draw lies beside the stack and no
    second copy of it (one full-width Jamba MoE layer is 19.3 GB)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    # leaf -> (shape, scale), in the order of the draws
    draws = {"w_up": ((e, d, f), 1.0 / math.sqrt(d)), "w_down": ((e, f, d), 1.0 / math.sqrt(f))}
    if is_gated(cfg.activation):
        draws["w_gate"] = ((e, d, f), 1.0 / math.sqrt(d))
    lead = () if n is None else (n,)
    p = {"router": {"w": torch.empty((*lead, d, e), dtype=torch.float32, device=device)},
         **{k: torch.empty((*lead, *shape), dtype=dtype, device=device)
            for k, (shape, _) in draws.items()}}
    for i in range(n or 1):
        at = (lambda t: t) if n is None else (lambda t: t[i])
        _normal(generator, (d, e), 1.0 / math.sqrt(d), torch.float32, device,
                out=at(p["router"]["w"]))
        for k, (shape, scale) in draws.items():
            _normal(generator, shape, scale, dtype, device, out=at(p[k]))
    return p


def _capacity(group: int, e: int, k: int, factor: float) -> int:
    return max(4, int(group * k * factor / e))


def route_topk(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> (weights (T, k), idx (T, k)); weights renormalized softmax.

    ``jax.lax.top_k``'s order: descending in IEEE total order (+0 above
    -0), the lower index first on ties: a stable descending sort of each
    float32's bits mapped onto integers of that order (``torch.topk``
    promises no order on ties, ``torch.sort`` of the floats none between
    the zeros).  The order of the k slots decides which assignment keeps
    capacity."""
    lf = logits.to(torch.float32)
    bits = lf.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    vals = torch.gather(lf, -1, idx)
    w = torch.exp(vals - vals.amax(dim=-1, keepdim=True).detach())
    return w / w.sum(dim=-1, keepdim=True), idx


def dispatch_combine(
    idx: torch.Tensor,  # (..., G, k) expert ids per token in group
    weights: torch.Tensor,  # (..., G, k)
    e: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build one-hot dispatch (..., G, E, C) bfloat16 and combine (..., G,
    E, C) float32, for each group of the leading axes (the reference's
    ``vmap``).  Assignment j of every token claims its expert's next slot
    before assignment j + 1 of any token; one past the capacity is dropped.
    A slot row is ``pos == arange(C)``: all zero where ``pos`` is -1 or
    >= C, as ``jax.nn.one_hot`` gives (``F.one_hot`` raises there)."""
    k = idx.shape[-1]
    slots = torch.arange(capacity, device=idx.device)
    experts = torch.arange(e, device=idx.device)
    dispatch = torch.zeros((*idx.shape[:-1], e, capacity), dtype=torch.bfloat16,
                           device=idx.device)
    combine = torch.zeros(dispatch.shape, dtype=torch.float32, device=idx.device)
    counts = torch.zeros((*idx.shape[:-2], 1, e), dtype=torch.int32, device=idx.device)
    for j in range(k):  # k is small and static
        onehot = (idx[..., j, None] == experts).to(torch.int32)  # (..., G, E)
        pos = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - 1 + counts
        keep = (pos < capacity) & (onehot > 0)
        sel = ((pos[..., None] == slots) & keep[..., None]).to(torch.bfloat16)  # (..., G, E, C)
        dispatch = dispatch + sel
        combine = combine + sel.to(torch.float32) * weights[..., j, None, None]
        counts = counts + torch.sum(onehot * keep, dim=-2, keepdim=True, dtype=torch.int32)
    return dispatch, combine


def load_balancing_loss(logits: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e (fraction routed) * (mean prob); the
    fraction is of the top-1 assignments, with no gradient through it."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)  # (T, E)
    frac = torch.mean((idx[..., 0, None] == torch.arange(e, device=idx.device))
                      .to(torch.float32), dim=0)  # top-1 routed fraction
    return e * torch.sum(frac * torch.mean(probs, dim=0))


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of mixed operands: both in their promoted type."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def moe_ffn(
    p: Params,
    cfg,
    x: torch.Tensor,  # (B, S, d)
    *,
    group_size: int = 512,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), aux_loss scalar float32).  The experts are
    float weights under every linear backend, as in the reference: only
    ``linear``'s projections quantize.

    The tokens are cut into ``B * S // g`` groups of ``g = min(group_size,
    B * S)``; a ``g`` that does not divide ``B * S`` raises, as the
    reference's reshape does (no padding, no truncation)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    g = min(group_size, t)
    if t % g:
        raise ValueError(f"moe_ffn: {t} tokens do not split into groups of {g} "
                         f"(group_size {group_size})")
    n_groups = t // g
    xt = x.reshape(n_groups, g, d)

    logits = xt.to(torch.float32) @ p["router"]["w"]  # (n, G, E)
    weights, idx = route_topk(logits.reshape(-1, e), k)
    aux = load_balancing_loss(logits.reshape(-1, e), idx, e)
    weights = weights.reshape(n_groups, g, k)
    idx = idx.reshape(n_groups, g, k)

    cap = _capacity(g, e, k, capacity_factor)
    dispatch, combine = dispatch_combine(idx, weights, e, cap)  # (n, G, E, C) each

    xe = torch.einsum("ngec,ngd->necd", dispatch, xt.to(torch.bfloat16))  # (n, E, C, d)
    up = _einsum("necd,edf->necf", xe, p["w_up"])
    if is_gated(cfg.activation):
        gate = _einsum("necd,edf->necf", xe, p["w_gate"])
        h = activation(cfg.activation, gate, up)
    else:
        h = activation(cfg.activation, up)
    ye = _einsum("necf,efd->necd", h, p["w_down"])
    out = torch.einsum("ngec,necd->ngd", combine.to(ye.dtype), ye)
    return out.reshape(b, s, d).to(x.dtype), aux.to(torch.float32)
