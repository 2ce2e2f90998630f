"""Shared model layers: norms, linears (dense | MVU-quantized), rotary
embeddings, activations; the port of the JAX package's
``repro/models/layers.py``.

Everything is functional: params are plain dicts of tensors, layers are
pure functions.  ``linear`` is the integration point for the paper's
technique: with ``backend="mvu_*"`` the projection runs through the
quantized MVU datapath -- fake-quant STE during training, the integer
MVU datapath on the hand kernels with integer-deployed params
(``quantize_model_params``) at serving.

Not ported here (ROADMAP queue A item 7): ``seq_shard`` (a no-op without
a mesh) waits for the training loop's sharding (step 3c).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.mvu import quantized_linear
from repro_torch.core.quantize import (
    QTensor,
    column_scale,
    fake_quant_weights,
    quantize_weights,
)

Params = dict[str, Any]


# ---------------------------------------------------------------- init utils
def _normal(generator: torch.Generator, shape, scale: float, dtype, device,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """``normal(shape) * scale`` in float32, drawn on ``generator``'s device
    and scaled in place, then cast to ``dtype`` and placed on ``device``, or
    cast into ``out`` (a slice of a stack: no second copy of the draw)."""
    x = torch.randn(shape, generator=generator, device=generator.device).mul_(scale)
    if out is not None:
        return out.copy_(x)
    return x.to(device=device, dtype=dtype)


def linear_init(generator, d_in: int, d_out: int, dtype=torch.bfloat16, device="cpu") -> Params:
    return {"w": _normal(generator, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)}


# ---------------------------------------------------------------- linear
MVU_BACKENDS = {
    "mvu_w8a8": (8, 8),
    "mvu_w4a8": (4, 8),
    "mvu_w4a4": (4, 4),
    "mvu_binary": (1, 8),
}


def linear(p: Params, x: torch.Tensor, *, backend: str = "dense") -> torch.Tensor:
    """y = x @ w  (+ quantized datapaths).

    dense:  w stored (d_in, d_out), plain matmul.
    mvu_* fake-quant (training): float params; the weights STE-quantized
    per output column (``fake_quant_weights(w, w_bits, axis=1)``, in ``w``'s
    dtype: in float32 the grid ``quantize_linear_params`` deploys), then a
    float ``x @ w`` (outside any kernel, as in the reference; activations
    stay float).  A 1-bit weight's scale is taken from p["bipolar_scale"]
    where :func:`with_column_scales` put it, else computed here.
    mvu_* integer (serving): p holds {"values" (out, in) int8, "scale"}
    and the MVU kernel runs the dot (``quantized_linear`` with
    ``backend="cuda"``: the hand kernel on the card, its plain version on a
    CPU tensor).  As in the reference, integer params under a backend that
    is not ``mvu_*`` run at 8 bits.
    """
    if "values" in p:  # integer-deployed MVU weights
        w_bits, a_bits = MVU_BACKENDS[backend] if backend in MVU_BACKENDS else (8, 8)
        qt = QTensor(p["values"], p["scale"], w_bits, True)
        return quantized_linear(x, qt, act_bits=a_bits, backend="cuda")
    w = p["w"]
    if backend in MVU_BACKENDS:
        w = fake_quant_weights(w, MVU_BACKENDS[backend][0], axis=1,
                               scale=p.get("bipolar_scale"))
    return x @ w


def with_column_scales(params: Params, backend: str) -> Params:
    """Under a 1-bit ``backend``, ``params`` with each float projection's
    1-bit scale (:func:`column_scale`, one batch for a whole layer stack)
    beside its ``w`` as ``"bipolar_scale"``, which :func:`linear` takes:
    the scale does not depend on the block's input, so the forward and a
    remat'd block's recompute reuse it.  Other backends: ``params``."""
    if MVU_BACKENDS.get(backend, (None,))[0] != 1:
        return params

    def walk(node, name):
        if isinstance(node, dict):
            if name in PROJ_NAMES and set(node) == {"w"} and node["w"].is_floating_point():
                return {**node, "bipolar_scale": column_scale(node["w"])}
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params, "")


def quantize_linear_params(p: Params, backend: str) -> Params:
    """dense params -> integer MVU deployment params (out, in int8 + scale).

    The reference stores 4-bit and 1-bit values as ``int4``, which its
    ``linear`` widens to int8 before the kernel.  Torch has no int4, so the
    port carries every width in int8: the same values, in the dtype the
    kernels take."""
    w_bits, _ = MVU_BACKENDS[backend]
    qt = quantize_weights(p["w"].T.to(torch.float32), w_bits, axis=0)
    return {"values": qt.values.contiguous(), "scale": qt.scale.reshape(-1)}


PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


def quantize_model_params(params: Params, backend: str) -> Params:
    """Post-training quantization of every projection in a model tree onto
    the MVU integer grid (handles layer-stacked (L, in, out) weights)."""

    def one(node):
        w = node["w"]
        if w.ndim == 2:
            return quantize_linear_params(node, backend)
        flat = w.reshape(-1, *w.shape[-2:])
        outs = [quantize_linear_params({"w": flat[i]}, backend) for i in range(flat.shape[0])]
        vals = torch.stack([o["values"] for o in outs]).reshape(
            *w.shape[:-2], w.shape[-1], w.shape[-2])
        scales = torch.stack([o["scale"] for o in outs]).reshape(*w.shape[:-2], w.shape[-1])
        return {"values": vals, "scale": scales}

    def walk(node, name):
        if isinstance(node, dict):
            if name in PROJ_NAMES and set(node) == {"w"} and node["w"].ndim >= 2:
                return one(node)
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params, "")


# ---------------------------------------------------------------- norms
def rmsnorm_init(d: int, dtype=torch.bfloat16, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.bfloat16, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------- activations
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * 1 / (1 + exp(-x)), each op rounded to x's dtype
    as XLA expands the logistic (``F.silu`` rounds once, and differs in
    bfloat16)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default): x * (0.5 * (1 +
    tanh(sqrt(2 / pi) * (x + 0.044715 * x^3)))), both constants rounded to
    x's dtype and each op rounded to it, as JAX computes it; bit for bit in
    bfloat16 (``F.gelu(approximate="tanh")`` rounds once, and differs there
    on about half the values)."""
    c, k = (torch.tensor(v, dtype=torch.float32).to(x.dtype)
            for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def activation(name: str, gate: torch.Tensor, up: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        assert up is not None
        return silu(gate) * up
    if name == "geglu":
        assert up is not None
        return gelu(gate) * up
    if name == "squared_relu":  # Nemotron-4 (Primer)
        return torch.square(F.relu(gate))
    if name == "gelu":
        return gelu(gate)
    raise ValueError(f"unknown activation {name!r}")


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ---------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, rot_dim: int | None = None,
               device="cpu") -> torch.Tensor:
    rd = rot_dim or head_dim
    return 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))


def apply_rope(
    x: torch.Tensor,  # (B, S, H, hd)
    positions: torch.Tensor,  # (B, S)
    theta: float = 1e4,
    rot_dim: int | None = None,
) -> torch.Tensor:
    hd = x.shape[-1]
    rd = rot_dim or hd
    freqs = rope_freqs(hd, theta, rd, device=x.device)  # (rd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, rd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def apply_mrope(
    x: torch.Tensor,  # (B, S, H, hd)
    positions: torch.Tensor,  # (3, B, S): temporal, height, width ids
    theta: float = 1e6,
    sections: tuple[int, int, int] = (16, 24, 24),  # half-dims per axis
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary half-dims are split into
    (temporal, height, width) sections, each rotated by its own position id.
    Text tokens carry identical t/h/w ids, which degenerates to 1-D RoPE.
    As in ``apply_rope``, a bfloat16 ``x`` times the float32 ``cos`` /
    ``sin`` promotes to float32, and the result is cast back to x's dtype.
    """
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    # per-frequency position id chosen by section
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                        for i, s in enumerate(sections)])  # (half,)
    pos = positions.to(torch.float32)  # (3, B, S)
    ang = torch.movedim(pos[sec_id], 0, -1) * inv  # (half, B, S) -> (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embeddings
def embed_init(generator, vocab: int, d: int, dtype=torch.bfloat16, device="cpu") -> Params:
    return {"table": _normal(generator, (vocab, d), 0.02, dtype, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T
