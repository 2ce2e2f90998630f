"""Transformer assembly, dense, MoE and SSM families: the uniform decoder
stack (its training forward, with ``remat``), its serving prefill and its
cached decode; the port of the JAX package's
``repro/models/transformer.py``.

Per-layer params are stacked on a leading layer axis, as the reference's
scanned stacks are; the port walks that axis in a Python loop.  With
``cfg.remat`` the training forward runs each block under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``): the same values, only a block's input kept for the
backward.  The KV caches are stacked the same way, once, and each layer
writes its slice in place.  A MoE block (``cfg.is_moe``) holds ``"moe"``
(``models/moe.py``) in place of ``"ffn"``: the training forward and the
prefill route with ``cfg.capacity_factor``, the decode step with 2.0, as
the reference does, and each block's load-balancing loss is summed in
float32.  An SSM block (``cfg.family == "ssm"``, Mamba-2) holds ``ln1``
and ``"ssm"`` (``models/ssm.py``) and no ``ln2``; its cache is the conv
tails and the float32 state (``max_len`` is ignored), written in place as
the KV caches are.  The other families -- the hybrid interleave (Jamba),
the VLM backbone (M-RoPE) and encoder-decoder (Whisper) -- raise
``NotImplementedError`` (ROADMAP queue A item 7, step 4).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.attention import (
    attention,
    attention_decode,
    attention_prefill,
    attn_init,
    init_kv_cache,
)
from repro_torch.models.layers import (
    Params,
    activation,
    is_gated,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    quantize_model_params,
    rmsnorm,
    rmsnorm_init,
    with_column_scales,
)
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.models.ssm import (
    init_ssm_cache,
    ssm_decode_step,
    ssm_forward,
    ssm_init,
    ssm_prefill,
)


def require_ported(cfg) -> None:
    """Raise for a config of a family the port does not run yet."""
    if cfg.family not in ("dense", "moe", "ssm") or cfg.is_hybrid:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port runs the "
            "dense, MoE and SSM decoders (hybrid, VLM and encoder-decoder wait for "
            "ROADMAP queue A item 7, step 4)")


def _norm_init(cfg, dtype, device):
    return (layernorm_init(cfg.d_model, dtype, device) if cfg.norm == "layernorm"
            else rmsnorm_init(cfg.d_model, dtype, device))


def _norm(cfg, p, x):
    return layernorm(p, x, cfg.norm_eps) if cfg.norm == "layernorm" else rmsnorm(p, x, cfg.norm_eps)


def layer(params: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in params.items()}


def unbind_layers(params: Params) -> list[Params]:
    """Every layer's tree of a stacked tree, as ``torch.unbind`` views: the
    backward stacks a leaf's layer gradients once, where a
    ``layer(params, i)`` view would add each into a zero tensor of the
    whole stack."""
    leaves = {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in params.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(len(next(iter(leaves.values()))))]


def stack_layers(trees: list[Params]) -> Params:
    """Per-layer trees -> one tree with a leading layer axis."""
    return {k: stack_layers([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


# ------------------------------------------------------------------- FFN
def ffn_init(generator, cfg, dtype, device) -> Params:
    ff = cfg.d_ff
    p = {
        "w_up": linear_init(generator, cfg.d_model, ff, dtype, device),
        "w_down": linear_init(generator, ff, cfg.d_model, dtype, device),
    }
    if is_gated(cfg.activation):
        p["w_gate"] = linear_init(generator, cfg.d_model, ff, dtype, device)
    return p


def ffn(p: Params, cfg, x: torch.Tensor, *, backend: str = "dense") -> torch.Tensor:
    up = linear(p["w_up"], x, backend=backend)
    if is_gated(cfg.activation):
        gate = linear(p["w_gate"], x, backend=backend)
        h = activation(cfg.activation, gate, up)
    else:
        h = activation(cfg.activation, up)
    return linear(p["w_down"], h, backend=backend)


# ------------------------------------------------------------ uniform block
def block_init(generator, cfg, dtype, device) -> Params:
    require_ported(cfg)
    if cfg.family == "ssm":
        return {"ln1": _norm_init(cfg, dtype, device),
                "ssm": ssm_init(generator, cfg, dtype, device)}
    p = {"ln1": _norm_init(cfg, dtype, device), "ln2": _norm_init(cfg, dtype, device),
         "attn": attn_init(generator, cfg, dtype, device)}
    if cfg.is_moe:
        p["moe"] = moe_init(generator, cfg, dtype, device)
    else:
        p["ffn"] = ffn_init(generator, cfg, dtype, device)
    return p


def _block_ffn(p, cfg, x, capacity_factor):
    """The block's FFN half on ``ln2(x)``: (y, aux), aux the MoE FFN's
    load-balancing loss, or None for a dense FFN."""
    h = _norm(cfg, p["ln2"], x)
    if cfg.is_moe:
        return moe_ffn(p["moe"], cfg, h, group_size=cfg.moe_group_size,
                       capacity_factor=capacity_factor)
    return ffn(p["ffn"], cfg, h, backend=cfg.linear_backend), None


def block_forward(p, cfg, x, positions, *, causal=True):
    require_ported(cfg)
    if cfg.family == "ssm":
        return (x + ssm_forward(p["ssm"], cfg, _norm(cfg, p["ln1"], x), chunk=cfg.ssd_chunk,
                                backend=cfg.linear_backend),
                torch.zeros((), dtype=torch.float32, device=x.device))
    x = x + attention(p["attn"], cfg, _norm(cfg, p["ln1"], x), positions,
                      causal=causal, backend=cfg.linear_backend)
    y, aux = _block_ffn(p, cfg, x, cfg.capacity_factor)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


# --------------------------------------------------------------- stacks
def stack_init(generator, cfg, dtype, device, *, quantize: str | None = None) -> Params:
    """Stacked per-layer params: leading axis = the layer axis.  With
    ``quantize`` (an ``mvu_*`` backend) each layer's projections are
    quantized as soon as that layer is drawn, so the float stack never
    lies whole on ``device``."""
    def one():
        p = block_init(generator, cfg, dtype, device)
        return p if quantize is None else quantize_model_params(p, quantize)
    return stack_layers([one() for _ in range(cfg.num_layers)])


def stack_forward(params, cfg, x, positions, *, causal=True):
    """The uncached forward through every layer (the training forward);
    returns (x, the summed aux loss).  With ``cfg.remat`` each block is
    recomputed from its input in the backward (non-reentrant
    ``torch.utils.checkpoint``).  Under a 1-bit backend every layer's
    projection scales are computed once, before the blocks
    (:func:`with_column_scales`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unbind_layers(with_column_scales(params, cfg.linear_backend)):
        if cfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(block_forward, p, cfg, x, positions,
                                                     causal=causal, use_reentrant=False)
        else:
            x, a = block_forward(p, cfg, x, positions, causal=causal)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------- decode path
def init_block_cache(cfg, batch: int, max_len: int, dtype, device):
    require_ported(cfg)
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


def init_stack_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    return stack_layers([init_block_cache(cfg, batch, max_len, dtype, device)
                         for _ in range(cfg.num_layers)])


def _write(cache: dict, new: dict) -> None:
    """Each of ``new``'s tensors copied into ``cache``'s view of that name."""
    for k, v in new.items():
        cache[k].copy_(v)


def _block_decode(p, cfg, x, pos, cache):
    require_ported(cfg)
    be = cfg.linear_backend
    if cfg.family == "ssm":
        y, new = ssm_decode_step(p["ssm"], cfg, _norm(cfg, p["ln1"], x), cache, backend=be)
        _write(cache, new)
        return x + y, cache
    y, cache = attention_decode(p["attn"], cfg, _norm(cfg, p["ln1"], x), pos, cache,
                                backend=be)
    x = x + y
    return x + _block_ffn(p, cfg, x, 2.0)[0], cache


def stack_decode(params, cfg, x, pos, caches):
    """One decode step through every layer; ``caches`` is written in place
    and returned."""
    for i in range(cfg.num_layers):
        x, _ = _block_decode(layer(params, i), cfg, x, pos, layer(caches, i))
    return x, caches


def _block_prefill(p, cfg, x, positions, cache):
    """Full-seq pass that fills caches (serving prefill).  An SSM prompt
    shorter than the conv tail (``ssm_conv - 1`` tokens) raises: the
    reference has no valid path there (its cache changes shape, and its
    next decode step fails)."""
    require_ported(cfg)
    be = cfg.linear_backend
    if cfg.family == "ssm":
        if x.shape[1] < cfg.ssm_conv - 1:
            raise ValueError(f"{cfg.name}: a prompt of {x.shape[1]} tokens is shorter than "
                             f"the conv tail of {cfg.ssm_conv - 1} the decode cache holds")
        y, new = ssm_prefill(p["ssm"], cfg, _norm(cfg, p["ln1"], x), chunk=cfg.ssd_chunk,
                             backend=be)
        _write(cache, new)
        return x + y, cache
    y, cache = attention_prefill(p["attn"], cfg, _norm(cfg, p["ln1"], x), positions, cache,
                                 backend=be)
    x = x + y
    return x + _block_ffn(p, cfg, x, cfg.capacity_factor)[0], cache


def stack_prefill(params, cfg, x, positions, caches):
    """The prompt through every layer; ``caches`` is filled in place and
    returned."""
    for i in range(cfg.num_layers):
        x, _ = _block_prefill(layer(params, i), cfg, x, positions, layer(caches, i))
    return x, caches
