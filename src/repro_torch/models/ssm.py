"""Mamba-2: the SSD (state-space duality) layer [arXiv:2405.21060]; the port
of the JAX package's ``repro/models/ssm.py``.

Chunked SSD for training and prefill (a quadratic, attention-like term
inside chunks, a linear recurrence across chunk states) and the
O(1)-per-token recurrent form for decode.

Projections are stored unfused (``w_z`` / ``w_x`` / ``w_B`` / ``w_C`` /
``w_dt``, each segment with its own depthwise causal conv), as in the
reference.  None of their names is in ``layers.PROJ_NAMES``, so
``quantize_model_params`` leaves them float and under an ``mvu_*`` backend
each runs ``linear``'s fake-quant arm: no hand kernel stands behind this
module, as no Pallas kernel stands behind the reference's, whose SSD, convs
and projections are plain ``jnp`` ops.  The port computes them with plain
torch ops, in the reference's dtypes: the convs, the SSD and the state in
float32, ``A_log`` / ``D`` / ``dt_bias`` float32 in a model of any dtype,
and the reference's casts back to the activations' dtype.

The SSD's four-operand einsum is contracted in steps (``C Bᵀ`` per chunk
and head, times the decay matrix, times ``X``), and the reference's
associative scan over chunk states is a loop over chunks: the same math,
rounded in another order.

Shapes (mamba2-780m): d_model 1536, expand 2 -> d_inner 3072, headdim 64 ->
48 heads, ngroups 1, dstate 128, conv kernel 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ssm_dims
from repro_torch.models.layers import Params, _normal, linear, linear_init, rmsnorm, silu

NEG_INF = -1e30
# the conv segments: each conv's name (also its decode-cache key) -> the
# projection that feeds it
_CONVS = {"conv_x": "w_x", "conv_B": "w_B", "conv_C": "w_C"}


def ssm_init(generator, cfg, dtype=torch.bfloat16, device="cpu") -> Params:
    """One SSM block's params, the reference's leaves and dtypes.  The
    reference draws ``conv_B`` and ``conv_C`` from one key, so the two are
    equal at init; the port keeps that quirk (one draw, copied)."""
    d_inner, nheads, _ = ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    d = cfg.d_model
    lin = lambda d_in, d_out: linear_init(generator, d_in, d_out, dtype, device)
    conv = lambda c: _normal(generator, (cfg.ssm_conv, c), 0.2, dtype, device)
    zeros = lambda c: torch.zeros((c,), dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    conv_bc = conv(gn)
    return {
        "w_z": lin(d, d_inner),
        "w_x": lin(d, d_inner),
        "w_B": lin(d, gn),
        "w_C": lin(d, gn),
        "w_dt": lin(d, nheads),
        "conv_x": {"w": conv(d_inner), "b": zeros(d_inner)},
        "conv_B": {"w": conv_bc, "b": zeros(gn)},
        "conv_C": {"w": conv_bc.clone(), "b": zeros(gn)},
        "A_log": torch.log(torch.arange(1, nheads + 1, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nheads,), 0.01, **f32))),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=device)},
        "out_proj": lin(d_inner, d),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q): s[i,j] = sum_{j<t<=i} a[t], NEG_INF above
    the diagonal.  The reference's form, a difference of cumulative sums,
    masked before any ``exp``: above the diagonal the difference is > 0
    and would overflow it, and ``inf * 0`` is NaN in the backward."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, d, NEG_INF)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU: x (B, S, C), w (K, C).  K shifted
    multiply-adds in float32 (no cuDNN, so no TF32 on the card), then the
    SiLU, cast back to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    wf = w.to(torch.float32)
    out = xp[:, 0:s] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * wf[i]
    return silu(out + b.to(torch.float32)).to(x.dtype)


def _conv_step(win: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-token conv: win (B, K, C) -> (B, C), float32."""
    out = torch.einsum("bkc,kc->bc", win.to(torch.float32), w.to(torch.float32))
    return silu(out + b.to(torch.float32))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) softplus'd
    a_log: torch.Tensor,  # (H,)
    b_mat: torch.Tensor,  # (B, S, G, N)
    c_mat: torch.Tensor,  # (B, S, G, N)
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) float32, final_state (B, H, P, N) float32).
    The sequence is zero-padded to a multiple of ``chunk``: a padded step
    has dt = 0, so it neither decays nor feeds the state."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    rep = h // g  # heads per B/C group
    f32 = torch.float32

    a = -torch.exp(a_log)  # (H,) negative
    da = dt * a  # (B, S, H) log-decay per step
    xdt = x * dt[..., None]  # (B, S, H, P) dt-scaled input

    chv = lambda t: t.reshape(bsz, nc, chunk, *t.shape[2:])
    xc = chv(xdt).to(f32)
    bh = chv(b_mat).to(f32).repeat_interleave(rep, dim=3)  # (B, nc, q, H, N)
    ch = chv(c_mat).to(f32).repeat_interleave(rep, dim=3)
    dac_h = chv(da).movedim(-1, 2)  # (B, nc, H, q)

    # 1) intra-chunk (diagonal) term: (C Bᵀ) * L, then times X
    lmat = torch.exp(_segsum(dac_h))  # (B, nc, H, q, k)
    scores = torch.einsum("bcqhn,bckhn->bchqk", ch, bh) * lmat
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # 2) chunk-final states
    a_cum = torch.cumsum(dac_h, dim=-1)  # (B, nc, H, q)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, nc, H, k)
    states = torch.einsum("bckhn,bckhp->bchpn", bh,
                          xc * decay_states.movedim(2, 3)[..., None])  # (B, nc, H, P, N)

    # 3) inter-chunk recurrence over chunk states: the state entering each
    # chunk, then the one leaving the last
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, nc, H)
    st = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if init_state is None
          else init_state.to(f32))
    st_in = []
    for c in range(nc):
        st_in.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    st_in = torch.stack(st_in, dim=1)  # (B, nc, H, P, N)

    # 4) inter-chunk (off-diagonal) output term
    state_decay_out = torch.exp(a_cum)  # (B, nc, H, q)
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", ch, st_in)
             * state_decay_out.movedim(2, 3)[..., None])

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y, st


def _project(p, cfg, x, be):
    """x (B, S, d) -> (z, xs, B, C, dt_raw, pre), the convs causal per
    segment; ``pre`` holds each conv's input (the projection before it) by
    conv name, the prefill's cache tails."""
    _, nheads, _ = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    bsz, s, _ = x.shape
    z = linear(p["w_z"], x, backend=be)
    pre = {c: linear(p[w], x, backend=be) for c, w in _CONVS.items()}
    xs, bm, cm = (_causal_conv(pre[c], p[c]["w"], p[c]["b"]) for c in _CONVS)
    dt_raw = linear(p["w_dt"], x, backend=be)
    return (z, xs.reshape(bsz, s, nheads, cfg.ssm_headdim), bm.reshape(bsz, s, g, n),
            cm.reshape(bsz, s, g, n), dt_raw, pre)


def _finish(p, cfg, y, xs, z, be, bsz, s):
    """The skip term, the gated norm (``rmsnorm``'s default eps, as in the
    reference, not ``cfg.norm_eps``) and the output projection."""
    d_inner, _, _ = ssm_dims(cfg)
    y = y + xs.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(z.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    return linear(p["out_proj"], y, backend=be)


def _forward(p, cfg, x, chunk, backend):
    """(output, final state, conv inputs) of the full-sequence block."""
    bsz, s, _ = x.shape
    z, xs, bm, cm, dt_raw, pre = _project(p, cfg, x, backend)
    dt = softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    y, state = ssd_chunked(xs, dt, p["A_log"], bm, cm, chunk=chunk)
    return _finish(p, cfg, y, xs, z, backend, bsz, s), state, pre


def ssm_forward(p: Params, cfg, x: torch.Tensor, *, chunk: int = 128,
                backend: str = "dense") -> torch.Tensor:
    """Full-sequence Mamba-2 block: x (B, S, d_model) -> (B, S, d_model)."""
    return _forward(p, cfg, x, chunk, backend)[0]


def ssm_prefill(p: Params, cfg, x: torch.Tensor, *, chunk: int = 128,
                backend: str = "dense"):
    """Full-sequence pass returning the decode cache: the last
    ``ssm_conv - 1`` inputs of each conv and the final state."""
    out, state, pre = _forward(p, cfg, x, chunk, backend)
    kc = cfg.ssm_conv - 1
    return out, {**{c: t[:, -kc:, :] for c, t in pre.items()}, "state": state}


# ------------------------------------------------------------------ decode
def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """The conv tails in ``dtype``, the state (B, H, P, N) in float32."""
    d_inner, nheads, _ = ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    kc = cfg.ssm_conv - 1
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv_x": zeros(batch, kc, d_inner),
        "conv_B": zeros(batch, kc, gn),
        "conv_C": zeros(batch, kc, gn),
        "state": zeros(batch, nheads, cfg.ssm_headdim, cfg.ssm_state, dt=torch.float32),
    }


def ssm_decode_step(p: Params, cfg, x: torch.Tensor, cache, *, backend: str = "dense"):
    """x (B, 1, d_model) -> (y (B, 1, d_model), new cache).  ``cache`` is
    read, not written: each new conv window is a fresh tensor, so the
    caller may copy the new cache into ``cache`` in place."""
    d_inner, nheads, _ = ssm_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    f32 = torch.float32
    bsz = x.shape[0]
    xt = x[:, 0]
    z = linear(p["w_z"], xt, backend=backend)
    win = {c: torch.cat([cache[c], linear(p[w], xt, backend=backend)[:, None]
                         .to(cache[c].dtype)], dim=1) for c, w in _CONVS.items()}
    dt_raw = linear(p["w_dt"], xt, backend=backend)
    xs, bm, cm = (_conv_step(win[c], p[c]["w"], p[c]["b"]).to(x.dtype) for c in _CONVS)

    xs = xs.reshape(bsz, nheads, cfg.ssm_headdim)
    bm = bm.reshape(bsz, g, n)
    cm = cm.reshape(bsz, g, n)
    dt = softplus(dt_raw.to(f32) + p["dt_bias"])  # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))  # (B, H)

    rep = nheads // g
    bh = bm.repeat_interleave(rep, dim=1)  # (B, H, N)
    ch = cm.repeat_interleave(rep, dim=1)
    state = cache["state"] * da[..., None, None] + (
        dt[..., None, None] * xs.to(f32)[..., None] * bh.to(f32)[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, ch.to(f32))
    y = y + xs.to(f32) * p["D"][None, :, None]
    y = y.reshape(bsz, d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    out = linear(p["out_proj"], y, backend=backend)
    return out[:, None, :], {**{c: w[:, 1:] for c, w in win.items()}, "state": state}
