"""Attention: MHA/GQA/MQA, causal + sliding-window masks, RoPE / M-RoPE,
prefill and single-token decode with a KV cache (float or int8), and the
encoder-decoder's cross attention; the port of the JAX package's
``repro/models/attention.py``.

The same einsums, float32 scores, ``-1e30`` mask and softmax as the
reference (not ``scaled_dot_product_attention``), so the port computes
what JAX computes.  Under ``cfg.mrope`` (the VLM family) positions are
(3, B, S) t/h/w ids, or (B, S) ids broadcast to all three (the decode
step's and a text-only prefill's); nothing reads the positions' leading
axis as the batch.  ``attention(..., causal=False)`` (Whisper's encoder)
applies no mask on the plain path, and an all-true one on the chunked
path, as the reference's ``_sdpa_auto`` does.  ``cross_attention``
(Whisper's decoder over the encoder memory) takes q from the decoder and
k, v from the memory, with no RoPE and no mask, through ``_sdpa`` itself;
it caches nothing, so a decode step projects the memory again, as the
reference's does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (
    Params,
    apply_mrope,
    apply_rope,
    linear,
    linear_init,
    rmsnorm,
    rmsnorm_init,
)


def attn_init(generator, cfg, dtype=torch.bfloat16, device="cpu") -> Params:
    hd = cfg.head_dim
    p = {
        "wq": linear_init(generator, cfg.d_model, cfg.num_heads * hd, dtype, device),
        "wk": linear_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wv": linear_init(generator, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wo": linear_init(generator, cfg.num_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd, dtype, device)
        p["knorm"] = rmsnorm_init(hd, dtype, device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(p, cfg, x, positions, backend):
    hd = cfg.head_dim
    q = _split_heads(linear(p["wq"], x, backend=backend), cfg.num_heads, hd)
    k = _split_heads(linear(p["wk"], x, backend=backend), cfg.num_kv_heads, hd)
    v = _split_heads(linear(p["wv"], x, backend=backend), cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q)
        k = rmsnorm(p["knorm"], k)
    if cfg.mrope:
        if positions.ndim == 2:  # text-only fallback: identical t/h/w ids
            positions = positions[None].expand(3, *positions.shape)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(sq: int, skv: int, *, causal: bool, window: int | None,
          q_offset: int = 0, device="cpu") -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


def _sdpa(q, k, v, mask=None):
    """q (B,Sq,H,hd); k,v (B,Skv,G,hd) with H = G*rep (GQA)."""
    b, sq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    q = q.reshape(b, sq, g, rep, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, *, causal, window, q_chunk):
    """Exact attention over query chunks of ``q_chunk``: peak score memory
    O(q_chunk * S) instead of O(S^2); K/V stay resident."""
    s = q.shape[1]
    outs = []
    for idx in range(s // q_chunk):
        mask = _mask(q_chunk, s, causal=causal, window=window, q_offset=idx * q_chunk,
                     device=q.device)
        outs.append(_sdpa(q[:, idx * q_chunk:(idx + 1) * q_chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def _sdpa_auto(q, k, v, *, causal, window, q_chunk):
    s = q.shape[1]
    if q_chunk and s > q_chunk and s % q_chunk == 0 and q.shape[1] == k.shape[1]:
        return _sdpa_chunked(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    mask = _mask(s, k.shape[1], causal=causal, window=window, device=q.device)
    return _sdpa(q, k, v, mask if (causal or window) else None)


def attention(
    p: Params,
    cfg,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S) or (3, B, S) for M-RoPE
    *,
    causal: bool = True,
    backend: str = "dense",
) -> torch.Tensor:
    q, k, v = _qkv(p, cfg, x, positions, backend)
    window = cfg.window if cfg.attn_type == "swa" else None
    out = _sdpa_auto(q, k, v, causal=causal, window=window, q_chunk=cfg.attn_q_chunk)
    return linear(p["wo"], out.reshape(*x.shape[:-1], -1), backend=backend)


# ------------------------------------------------------------------ decode
def _quant_kv(x):
    """(.., hd) -> int8 values + per-(token,head) f32 scale (KIVI-style)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cpu"):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _update(buf: torch.Tensor, upd: torch.Tensor, idx) -> None:
    """``jax.lax.dynamic_update_slice(buf, upd, (0, idx, 0, 0))`` in place:
    ``upd`` written into ``buf`` along axis 1 from ``idx`` (an int or a
    0-dim tensor on ``buf``'s device), the start clamped so that it fits,
    as XLA clamps it."""
    t, s = buf.shape[1], upd.shape[1]
    start = torch.clamp(torch.as_tensor(idx, device=buf.device), 0, t - s)
    rows = start.to(torch.int64) + torch.arange(s, device=buf.device)
    buf.index_copy_(1, rows, upd.to(buf.dtype))


def _cache_write(cfg, cache, k, v, idx) -> None:
    """Write the new K/V into ``cache`` in place (the reference returns a
    new cache; serving never reads the old one)."""
    if cfg.kv_quant:
        (k, k_scale), (v, v_scale) = _quant_kv(k), _quant_kv(v)
        _update(cache["k_scale"], k_scale, idx)
        _update(cache["v_scale"], v_scale, idx)
    _update(cache["k"], k, idx)
    _update(cache["v"], v, idx)


def _cache_read(cfg, cache, dtype):
    if cfg.kv_quant:
        return (_dequant_kv(cache["k"], cache["k_scale"], dtype),
                _dequant_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def attention_prefill(
    p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, cache, *,
    backend: str = "dense",
):
    """Full-sequence pass that also fills the KV cache in place (serving
    prefill); returns the output and ``cache``."""
    q, k, v = _qkv(p, cfg, x, positions, backend)
    _cache_write(cfg, cache, k, v, 0)
    window = cfg.window if cfg.attn_type == "swa" else None
    out = _sdpa_auto(q, k, v, causal=True, window=window, q_chunk=cfg.attn_q_chunk)
    return linear(p["wo"], out.reshape(*x.shape[:-1], -1), backend=backend), cache


def attention_decode(
    p: Params, cfg, x: torch.Tensor, pos: torch.Tensor, cache, *,
    backend: str = "dense",
):
    """One-token decode: x (B, 1, d), pos (B, 1); cache (B, T, G, hd),
    written in place; returns the output and ``cache``.

    As in the reference, the new K/V go to position ``pos[0, 0]`` for every
    batch row (lockstep serving), and the position stays on the device."""
    q, k, v = _qkv(p, cfg, x, pos, backend)
    b, t = cache["k"].shape[:2]
    idx = pos[0, 0]
    _cache_write(cfg, cache, k, v, idx)
    kk, vv = _cache_read(cfg, cache, q.dtype)
    ar = torch.arange(t, device=x.device)[None, :]
    valid = ar <= idx  # (1, T)
    if cfg.attn_type == "swa" and cfg.window is not None:
        valid &= ar > idx - cfg.window
    g = kk.shape[2]
    h = cfg.num_heads
    rep = h // g
    qh = q.reshape(b, 1, g, rep, cfg.head_dim)
    scores = torch.einsum("bsgrh,btgh->bgrst", qh, kk).to(torch.float32)
    scores = scores / math.sqrt(cfg.head_dim)
    scores = torch.where(valid[:, None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, vv).reshape(b, 1, h * cfg.head_dim)
    return linear(p["wo"], out, backend=backend), cache


# ------------------------------------------------------------------ cross
def cross_attn_init(generator, cfg, dtype=torch.bfloat16, device="cpu") -> Params:
    return attn_init(generator, cfg, dtype, device)


def cross_attention(
    p: Params, cfg, x: torch.Tensor, kv_src: torch.Tensor, *, backend: str = "dense"
) -> torch.Tensor:
    """Decoder query over encoder memory (Whisper); no mask, no rope.
    x (B, Sq, d), kv_src (B, Skv, d): the memory is projected at every
    call (no cross K/V cache, as in the reference)."""
    hd = cfg.head_dim
    q = _split_heads(linear(p["wq"], x, backend=backend), cfg.num_heads, hd)
    k = _split_heads(linear(p["wk"], kv_src, backend=backend), cfg.num_kv_heads, hd)
    v = _split_heads(linear(p["wv"], kv_src, backend=backend), cfg.num_kv_heads, hd)
    out = _sdpa(q, k, v, None)
    return linear(p["wo"], out.reshape(*x.shape[:-1], -1), backend=backend)
