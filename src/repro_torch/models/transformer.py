"""Transformer assembly, dense, MoE, SSM and hybrid families: the uniform
decoder stack and the hybrid interleave (Jamba), each with its training
forward (with ``remat``), its serving prefill and its cached decode; the
port of the JAX package's ``repro/models/transformer.py``.

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
the KV caches are.

A hybrid stack (``cfg.is_hybrid``, Jamba) is ``num_layers // attn_period``
groups of ``per = attn_period`` layers, stacked on the leading axis: one
attention layer at ``j == per // 2``, an SSM layer at every other ``j``,
and after each a MoE FFN at odd ``j``, a dense one at even ``j``; the
group's SSM, FFN and MoE sub-layers and its ``ln_mix`` / ``ln_ffn`` norms
are sub-stacked on a second axis.  Its cache is a KV cache a group and
``(per - 1)`` SSM caches a group, every SSM leaf float32 (the conv tails
too, as the reference's ``init_stack_caches`` makes them).  A group is
drawn sub-layer by sub-layer into stacks allocated once
(:func:`stack_layers`, ``moe_init(n=...)``), so a full-width group never
lies twice on the card.  The VLM backbone (Qwen2-VL, ``cfg.family ==
"vlm"``) is the uniform dense stack, as the reference's ``stack_init``
dispatches it (neither hybrid nor SSM nor MoE): ``block_init`` /
``block_forward`` / ``_block_prefill`` / ``_block_decode``, its M-RoPE in
``attention._qkv``.

The encoder-decoder (Whisper, ``cfg.encdec``) is two stacks under
``params["encdec"]``: ``enc`` (``enc_layers`` layers of ``ln1``, ``attn``,
``ln2``, ``ffn``: non-causal self-attention, RoPE over frame ids 0..T-1)
closed by ``ln_enc``, and ``dec`` (``num_layers`` layers of ``ln1``,
``attn``, ``lnx``, ``xattn``, ``ln2``, ``ffn``: causal self-attention,
then cross attention over the encoder's output).  ``encoder_forward`` and
``decoder_forward`` are the training forward (each layer under
``torch.utils.checkpoint`` with ``cfg.remat``), ``decoder_prefill`` the
teacher-forced pass that fills the decoder's KV caches (no remat: the
reference's inline scan in ``model.prefill``), ``decoder_decode`` one step,
writing each layer's KV cache in place and projecting the encoder memory
again in every layer (no cross K/V cache, as in the reference).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.attention import (
    attention,
    attention_decode,
    attention_prefill,
    attn_init,
    cross_attention,
    cross_attn_init,
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
from repro_torch.tree import tree_map


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def require_ported(cfg) -> None:
    """Raise for a config of a family the port does not know."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the port runs the "
            f"families {PORTED_FAMILIES}")


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


def stack_layers(trees, n: int) -> Params:
    """``n`` per-layer trees (any iterable, e.g. a generator that draws
    each when asked) -> one tree with a leading layer axis.  Each leaf's
    stack is allocated once, at the first tree, and each tree is copied
    into its slice as soon as it comes, so one tree lies beside the stack
    and never every tree with it; a lone tree is its own stack, as views."""
    trees = iter(trees)
    first = next(trees)
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i, tree in enumerate(trees, 1):
        tree_map(lambda o, t: o[i].copy_(t), out, tree)
        del tree  # freed before the next one is drawn
    return out


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


# ------------------------------------------------------------ hybrid (Jamba)
def group_init(generator, cfg, dtype, device) -> Params:
    """One Jamba group = ``per = attn_period`` layers: the per-layer norms
    ``ln_mix`` / ``ln_ffn`` (per, d), one attention, ``per - 1`` SSM
    layers, ``per - per // 2`` dense FFNs and ``per // 2`` MoE FFNs, each
    kind sub-stacked on a leading axis.  Each kind's sub-layers go into a
    stack allocated once, one drawn sub-layer beside it
    (:func:`stack_layers`); the MoE experts are drawn straight into theirs
    (``moe_init(n=...)``), as one full-width MoE layer is 19.3 GB."""
    per = cfg.attn_period
    n_moe = per // 2
    n_dense = per - n_moe
    each = lambda n, init: stack_layers((init() for _ in range(n)), n)
    return {
        "ln_mix": each(per, lambda: _norm_init(cfg, dtype, device)),
        "ln_ffn": each(per, lambda: _norm_init(cfg, dtype, device)),
        "attn": attn_init(generator, cfg, dtype, device),
        "ssm": each(per - 1, lambda: ssm_init(generator, cfg, dtype, device)),
        "ffn": each(n_dense, lambda: ffn_init(generator, cfg, dtype, device)),
        "moe": moe_init(generator, cfg, dtype, device, n=n_moe),
    }


def _group_layers(cfg) -> list[tuple[int, int | None, str, int]]:
    """A group's layers in order, as the reference's counters ``si``,
    ``di``, ``mi`` walk them: (j, si, ffn, fi) with ``si`` the SSM
    sub-layer at j (None at the attention, ``j == per // 2``), ``ffn``
    "moe" at odd j and "ffn" at even j, and ``fi`` its index among its
    kind."""
    per = cfg.attn_period
    si, count, out = 0, {"moe": 0, "ffn": 0}, []
    for j in range(per):
        kind = "moe" if j % 2 == 1 else "ffn"
        out.append((j, None if j == per // 2 else si, kind, count[kind]))
        si += j != per // 2
        count[kind] += 1
    return out


def _sub_layers(p: Params) -> dict[str, list[Params]]:
    """A group's sub-stacks as lists of per-sub-layer views (see
    :func:`unbind_layers`)."""
    return {k: unbind_layers(p[k]) for k in ("ln_mix", "ln_ffn", "ssm", "ffn", "moe")}


def _group_ffn(subs, cfg, x, j: int, kind: str, fi: int, capacity_factor: float):
    """Layer j's FFN half on ``ln_ffn[j](x)``: (y, aux), aux the MoE FFN's
    load-balancing loss, or None for a dense FFN."""
    h = _norm(cfg, subs["ln_ffn"][j], x)
    if kind == "moe":
        return moe_ffn(subs["moe"][fi], cfg, h, group_size=cfg.moe_group_size,
                       capacity_factor=capacity_factor)
    return ffn(subs["ffn"][fi], cfg, h, backend=cfg.linear_backend), None


def group_forward(p, cfg, x, positions):
    """One group's training forward: (x, the group's MoE aux losses summed
    in float32, in the reference's order)."""
    be = cfg.linear_backend
    subs = _sub_layers(p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, si, kind, fi in _group_layers(cfg):
        h = _norm(cfg, subs["ln_mix"][j], x)
        if si is None:
            x = x + attention(p["attn"], cfg, h, positions, backend=be)
        else:
            x = x + ssm_forward(subs["ssm"][si], cfg, h, chunk=cfg.ssd_chunk, backend=be)
        y, a = _group_ffn(subs, cfg, x, j, kind, fi, cfg.capacity_factor)
        x = x + y
        if a is not None:
            aux = aux + a
    return x, aux


def _group_decode(p, cfg, x, pos, cache):
    """One decode step through a group; the attention's KV cache and each
    SSM layer's cache are written in place (the MoE routes with capacity
    2.0, as the reference's decode does)."""
    be = cfg.linear_backend
    subs, ssm_caches = _sub_layers(p), unbind_layers(cache["ssm"])
    for j, si, kind, fi in _group_layers(cfg):
        h = _norm(cfg, subs["ln_mix"][j], x)
        if si is None:
            y, _ = attention_decode(p["attn"], cfg, h, pos, cache["attn"], backend=be)
        else:
            y, new = ssm_decode_step(subs["ssm"][si], cfg, h, ssm_caches[si], backend=be)
            _write(ssm_caches[si], new)
        x = x + y
        x = x + _group_ffn(subs, cfg, x, j, kind, fi, 2.0)[0]
    return x, cache


def _group_prefill(p, cfg, x, positions, cache):
    """The prompt through a group, filling its caches in place: the SSM
    layers' bf16 conv tails are ``copy_``'d into the float32 cache (exact),
    the state as it is; the MoE routes with ``cfg.capacity_factor``."""
    _check_conv_tail(cfg, x)
    be = cfg.linear_backend
    subs, ssm_caches = _sub_layers(p), unbind_layers(cache["ssm"])
    for j, si, kind, fi in _group_layers(cfg):
        h = _norm(cfg, subs["ln_mix"][j], x)
        if si is None:
            y, _ = attention_prefill(p["attn"], cfg, h, positions, cache["attn"], backend=be)
        else:
            y, new = ssm_prefill(subs["ssm"][si], cfg, h, chunk=cfg.ssd_chunk, backend=be)
            _write(ssm_caches[si], new)
        x = x + y
        x = x + _group_ffn(subs, cfg, x, j, kind, fi, cfg.capacity_factor)[0]
    return x, cache


# --------------------------------------------------------------- stacks
def _n_stacked(cfg) -> int:
    """The stack's leading axis: layers, or a hybrid's groups."""
    return cfg.num_layers // cfg.attn_period if cfg.is_hybrid else cfg.num_layers


def stack_init(generator, cfg, dtype, device, *, quantize: str | None = None) -> Params:
    """Stacked per-layer params (a hybrid's per-group params): leading axis
    = the layer (group) axis.  With ``quantize`` (an ``mvu_*`` backend)
    each layer's (group's) projections are quantized as soon as it is
    drawn, so the float stack never lies whole on ``device``."""
    init = group_init if cfg.is_hybrid else block_init

    def one():
        p = init(generator, cfg, dtype, device)
        return p if quantize is None else quantize_model_params(p, quantize)
    n = _n_stacked(cfg)
    return stack_layers((one() for _ in range(n)), n)


def stack_forward(params, cfg, x, positions, *, causal=True):
    """The uncached forward through every layer (the training forward);
    returns (x, the summed aux loss).  With ``cfg.remat`` each block (a
    hybrid's group, as one scan step is in the reference) is recomputed
    from its input in the backward (non-reentrant
    ``torch.utils.checkpoint``).  Under a 1-bit backend every layer's
    projection scales are computed once, before the blocks
    (:func:`with_column_scales`)."""
    fwd = group_forward if cfg.is_hybrid else block_forward
    kw = {} if cfg.is_hybrid else {"causal": causal}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unbind_layers(with_column_scales(params, cfg.linear_backend)):
        if cfg.remat:
            x, a = torch.utils.checkpoint.checkpoint(fwd, p, cfg, x, positions,
                                                     use_reentrant=False, **kw)
        else:
            x, a = fwd(p, cfg, x, positions, **kw)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------- decode path
def init_block_cache(cfg, batch: int, max_len: int, dtype, device):
    require_ported(cfg)
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, dtype, device)
    return init_kv_cache(cfg, batch, max_len, dtype, device)


def init_stack_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    """The caches stacked as the params are.  A hybrid group's: its KV
    cache in ``dtype`` and its ``per - 1`` SSM caches with every leaf
    float32, as the reference makes them."""
    if cfg.is_hybrid:
        n_ssm = cfg.attn_period - 1

        def one():
            return {"attn": init_kv_cache(cfg, batch, max_len, dtype, device),
                    "ssm": stack_layers((init_ssm_cache(cfg, batch, torch.float32, device)
                                         for _ in range(n_ssm)), n_ssm)}
    else:
        def one():
            return init_block_cache(cfg, batch, max_len, dtype, device)
    n = _n_stacked(cfg)
    return stack_layers((one() for _ in range(n)), n)


def _write(cache: dict, new: dict) -> None:
    """Each of ``new``'s tensors copied into ``cache``'s view of that name."""
    for k, v in new.items():
        cache[k].copy_(v)


def _check_conv_tail(cfg, x) -> None:
    """An SSM prompt shorter than the conv tail (``ssm_conv - 1`` tokens)
    raises: the reference has no valid path there (its cache changes
    shape, and its next decode step fails)."""
    if x.shape[1] < cfg.ssm_conv - 1:
        raise ValueError(f"{cfg.name}: a prompt of {x.shape[1]} tokens is shorter than "
                         f"the conv tail of {cfg.ssm_conv - 1} the decode cache holds")


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
    """One decode step through every layer (group); ``caches`` is written
    in place and returned."""
    dec = _group_decode if cfg.is_hybrid else _block_decode
    for i in range(_n_stacked(cfg)):
        x, _ = dec(layer(params, i), cfg, x, pos, layer(caches, i))
    return x, caches


def _block_prefill(p, cfg, x, positions, cache):
    """Full-seq pass that fills caches (serving prefill); an SSM prompt
    shorter than the conv tail raises (:func:`_check_conv_tail`)."""
    require_ported(cfg)
    be = cfg.linear_backend
    if cfg.family == "ssm":
        _check_conv_tail(cfg, x)
        y, new = ssm_prefill(p["ssm"], cfg, _norm(cfg, p["ln1"], x), chunk=cfg.ssd_chunk,
                             backend=be)
        _write(cache, new)
        return x + y, cache
    y, cache = attention_prefill(p["attn"], cfg, _norm(cfg, p["ln1"], x), positions, cache,
                                 backend=be)
    x = x + y
    return x + _block_ffn(p, cfg, x, cfg.capacity_factor)[0], cache


def stack_prefill(params, cfg, x, positions, caches):
    """The prompt through every layer (group); ``caches`` is filled in
    place and returned."""
    pre = _group_prefill if cfg.is_hybrid else _block_prefill
    for i in range(_n_stacked(cfg)):
        x, _ = pre(layer(params, i), cfg, x, positions, layer(caches, i))
    return x, caches


# --------------------------------------------------------- encoder-decoder
def _enc_layer_init(generator, cfg, dtype, device) -> Params:
    return {"ln1": _norm_init(cfg, dtype, device), "attn": attn_init(generator, cfg, dtype, device),
            "ln2": _norm_init(cfg, dtype, device), "ffn": ffn_init(generator, cfg, dtype, device)}


def _dec_layer_init(generator, cfg, dtype, device) -> Params:
    return {"ln1": _norm_init(cfg, dtype, device), "attn": attn_init(generator, cfg, dtype, device),
            "lnx": _norm_init(cfg, dtype, device),
            "xattn": cross_attn_init(generator, cfg, dtype, device),
            "ln2": _norm_init(cfg, dtype, device), "ffn": ffn_init(generator, cfg, dtype, device)}


def encdec_init(generator, cfg, dtype, device, *, quantize: str | None = None) -> Params:
    """The encoder's and the decoder's layers, each stacked on a leading
    axis (:func:`stack_layers`), and the encoder's closing norm
    ``ln_enc``.  With ``quantize`` (an ``mvu_*`` backend) each layer's
    projections, the cross attention's included, are quantized as soon as
    it is drawn."""
    require_ported(cfg)

    def stack(init, n):
        def one():
            p = init(generator, cfg, dtype, device)
            return p if quantize is None else quantize_model_params(p, quantize)
        return stack_layers((one() for _ in range(n)), n)

    return {"enc": stack(_enc_layer_init, cfg.enc_layers),
            "dec": stack(_dec_layer_init, cfg.num_layers),
            "ln_enc": _norm_init(cfg, dtype, device)}


def _enc_layer(p, cfg, h, positions):
    be = cfg.linear_backend
    h = h + attention(p["attn"], cfg, _norm(cfg, p["ln1"], h), positions, causal=False,
                      backend=be)
    return h + ffn(p["ffn"], cfg, _norm(cfg, p["ln2"], h), backend=be)


def _dec_layer(p, cfg, h, positions, enc_out):
    be = cfg.linear_backend
    h = h + attention(p["attn"], cfg, _norm(cfg, p["ln1"], h), positions, causal=True,
                      backend=be)
    h = h + cross_attention(p["xattn"], cfg, _norm(cfg, p["lnx"], h), enc_out, backend=be)
    return h + ffn(p["ffn"], cfg, _norm(cfg, p["ln2"], h), backend=be)


def _run_layers(fn, stacked, cfg, x, *args):
    """``x`` through ``fn`` once a layer of ``stacked``, each layer under
    ``torch.utils.checkpoint`` with ``cfg.remat``; a 1-bit backend's
    projection scales computed once, before the layers
    (:func:`with_column_scales`), as :func:`stack_forward` computes them."""
    for p in unbind_layers(with_column_scales(stacked, cfg.linear_backend)):
        if cfg.remat:
            x = torch.utils.checkpoint.checkpoint(fn, p, cfg, x, *args, use_reentrant=False)
        else:
            x = fn(p, cfg, x, *args)
    return x


def encoder_forward(params, cfg, x, positions):
    """The encoder over frame embeddings x (B, T, d), positions (B, T):
    non-causal self-attention and the FFN in every layer, then ``ln_enc``."""
    x = _run_layers(_enc_layer, params["enc"], cfg, x, positions)
    return _norm(cfg, params["ln_enc"], x)


def decoder_forward(params, cfg, x, positions, enc_out):
    """The decoder's uncached forward (the training forward) over token
    embeddings x (B, S, d) against the encoder's output (B, T, d)."""
    return _run_layers(_dec_layer, params["dec"], cfg, x, positions, enc_out)


def decoder_prefill(params, cfg, x, positions, caches, enc_out):
    """The teacher-forced pass over the prompt that fills each decoder
    layer's KV cache in place (no remat, as the reference's inline scan in
    ``model.prefill``); returns (x, ``caches``)."""
    be = cfg.linear_backend
    for i in range(cfg.num_layers):
        p = layer(params["dec"], i)
        y, _ = attention_prefill(p["attn"], cfg, _norm(cfg, p["ln1"], x), positions,
                                 layer(caches, i), backend=be)
        x = x + y
        x = x + cross_attention(p["xattn"], cfg, _norm(cfg, p["lnx"], x), enc_out, backend=be)
        x = x + ffn(p["ffn"], cfg, _norm(cfg, p["ln2"], x), backend=be)
    return x, caches


def decoder_decode(params, cfg, x, pos, caches, enc_out):
    """One decode step through the decoder: x (B, 1, d), pos (B, 1); each
    layer's KV cache written in place, and the encoder memory projected
    again by every layer's cross attention; returns (x, ``caches``)."""
    be = cfg.linear_backend
    for i in range(cfg.num_layers):
        p = layer(params["dec"], i)
        y, _ = attention_decode(p["attn"], cfg, _norm(cfg, p["ln1"], x), pos,
                                layer(caches, i), backend=be)
        x = x + y
        x = x + cross_attention(p["xattn"], cfg, _norm(cfg, p["lnx"], x), enc_out, backend=be)
        x = x + ffn(p["ffn"], cfg, _norm(cfg, p["ln2"], x), backend=be)
    return x, caches
