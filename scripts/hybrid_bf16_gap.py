"""Where the hybrid group of 8's gradient gap to the JAX package comes from.

Usage (from the repo root, JAX on the CPU, ~2 min):
    PYTHONPATH=src python scripts/hybrid_bf16_gap.py
    PYTHONPATH=src python scripts/hybrid_bf16_gap.py --fma-silu   # + the trial below

The reduced Jamba at one group of 8 layers (four MoE layers), W8A8, float32,
remat on, ``lm_numpy_params(cfg, 0)``, one row of 41 tokens: the port's
``Model.loss`` gradients lie up to 4.4e-3 of a leaf's largest from
``jax.value_and_grad``'s (``layers/ssm/D``), past the MoE family's 2^-8.
With both packages' bf16 token cast before the experts done in float32
they lie within 6.0e-6.  This prints, in order:

1. one MoE layer (the group's first MoE weights) on one seeded input and
   one seeded cotangent, the same in both packages, the backward taken
   operation by operation, each package chaining its own cotangents: each
   tensor's float32 distance between the packages (largest ulps, share of
   elements more than 1 ulp apart), ``d_gate`` again with silu's backward
   in XLA's order (below), how many elements of the bf16 rounded ``d_xe``
   (the cotangent of the experts' bf16 input) differ, and the whole
   layer's ``d_x`` (``jax.vjp`` against ``torch.autograd.grad``);
2. ``jax.nn.silu``'s VJP as XLA compiles it on the CPU against
   ``fma(g, t, (x g) (t (1 - t)))`` and against the plain two-rounding
   sum, from XLA's own ``t = logistic(x)``, on 100,000 seeded values;
3. the group of 8's training forward: each MoE layer's input (the tokens
   the bf16 cast rounds) in both packages, how far apart in float32 ulps,
   and the elements whose bf16 roundings differ, the first three with
   their values;
4. the three gradient leaves farthest from the compiled reference, as a
   share of the leaf's largest: the port, and the JAX package run op by op
   (``jax.disable_jit()``), each against the compiled JAX package; with
   ``--fma-silu`` also the port with silu's backward in XLA's order (a
   trial: the port does not ship it).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _f32(a) -> np.ndarray:
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(np.asarray(a).astype(np.float32))


def ulp_gap(a, b) -> tuple[float, float]:
    """(largest |a - b| in float32 ulps of the larger magnitude, share of
    elements more than one ulp apart)."""
    a, b = _f32(a), _f32(b)
    u = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(u.max()), float((u > 1).mean())


def bf16(a) -> np.ndarray:
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(_f32(a)).astype(jnp.bfloat16).astype(jnp.float32))


def fma_silu():
    """silu with XLA's CPU VJP, ``fma(g, t, (x g)(t(1 - t)))`` (the fused
    multiply-add taken in float64, exact for float32 operands but for a
    double rounding), as an autograd function: a trial, not the port's."""
    import torch

    class FmaSilu(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            t = 1 / (1 + torch.exp(-x))
            ctx.save_for_backward(x, t)
            return x * t

        @staticmethod
        def backward(ctx, g):
            x, t = ctx.saved_tensors
            m8 = (x * g) * (t * (1 - t))
            return torch.addcmul(m8.double(), g.double(), t.double()).to(x.dtype)

    return FmaSilu.apply


def group_of_8(backend: str = "mvu_w8a8"):
    """(JAX config, port config, numpy tree, tokens) of the case."""
    from repro.configs import get_reduced as jax_reduced
    from repro_torch.configs import get_reduced
    from repro_torch.convert import lm_numpy_params

    kw = dict(dtype="float32", remat=True, linear_backend=backend, num_layers=8, attn_period=8)
    jcfg = jax_reduced("jamba-1.5-large-398b").replace(**kw)
    tcfg = get_reduced("jamba-1.5-large-398b").replace(**kw)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 41)).astype(np.int32)
    return jcfg, tcfg, lm_numpy_params(tcfg, 0), toks


def one_moe_layer() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import repro.models.moe as JM
    from repro_torch.models import moe as TM
    from repro_torch.models.layers import silu

    _, cfg, tree, _ = group_of_8()
    p = {k: ({"w": v["w"][0, 0]} if isinstance(v, dict) else v[0, 0])
         for k, v in tree["layers"]["moe"].items()}
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 40, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((1, 40, cfg.d_model)).astype(np.float32)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = JM._capacity(40, e, k, cfg.capacity_factor)
    # the routing from the JAX package's float32 logits, the same in both
    w, idx = JM.route_topk(jnp.asarray(x[0]) @ jp["router"]["w"], k)
    dsp, cmb = JM.dispatch_combine(idx, w, e, cap)
    dsp, cmb = dsp[None], cmb[None]
    tdsp, tcmb = torch.from_numpy(_f32(dsp)).to(torch.bfloat16), torch.from_numpy(_f32(cmb))
    rows = []
    # forward
    xe = jnp.einsum("ngec,ngd->necd", dsp, jnp.asarray(x).astype(jnp.bfloat16))
    txe = torch.einsum("ngec,ngd->necd", tdsp, torch.from_numpy(x).to(torch.bfloat16))
    up, gate = (jnp.einsum("necd,edf->necf", xe, jp[n]) for n in ("w_up", "w_gate"))
    tup, tgate = (TM._einsum("necd,edf->necf", txe, tp[n]) for n in ("w_up", "w_gate"))
    t, tt = jax.nn.sigmoid(gate), 1 / (1 + torch.exp(-tgate))
    h, th = jax.nn.silu(gate) * up, silu(tgate) * tup
    ye = jnp.einsum("necf,efd->necd", h, jp["w_down"])
    tye = TM._einsum("necf,efd->necd", th, tp["w_down"])
    rows += [("forward xe (bf16)", txe, xe), ("up", tup, up), ("gate", tgate, gate),
             ("t = logistic(gate)", tt, t), ("h = silu(gate) * up", th, h), ("ye", tye, ye)]
    # backward, each package chaining its own cotangents
    d = jnp.asarray(dout)
    j_dye = jax.vjp(lambda y: jnp.einsum("ngec,necd->ngd", cmb, y), ye)[1](d)[0]
    t_dye = torch.einsum("ngec,ngd->necd", tcmb, torch.from_numpy(dout))
    j_dh = jax.vjp(lambda a: jnp.einsum("necf,efd->necd", a, jp["w_down"]), h)[1](j_dye)[0]
    t_dh = torch.einsum("necd,efd->necf", t_dye, tp["w_down"])
    j_dg, j_du = jax.vjp(lambda g_, u_: jax.nn.silu(g_) * u_, gate, up)[1](j_dh)
    g_, u_ = tgate.detach().requires_grad_(True), tup.detach().requires_grad_(True)
    t_dg, t_du = torch.autograd.grad(silu(g_) * u_, [g_, u_], t_dh)
    t_dg_fma, _ = torch.autograd.grad(fma_silu()(g_) * u_, [g_, u_], t_dh)
    x32 = xe.astype(jnp.float32)
    j_dxe = sum(jax.vjp(lambda a, n=n: jnp.einsum("necd,edf->necf", a, jp[n]), x32)[1](c)[0]
                for n, c in (("w_up", j_du), ("w_gate", j_dg)))
    t_dxe = (torch.einsum("necf,edf->necd", t_du, tp["w_up"])
             + torch.einsum("necf,edf->necd", t_dg, tp["w_gate"]))
    rows += [("backward d_ye", t_dye, j_dye), ("d_h", t_dh, j_dh), ("d_up", t_du, j_du),
             ("d_gate", t_dg, j_dg), ("d_gate, silu's backward in XLA's order", t_dg_fma, j_dg),
             ("d_xe (float32, before the bf16 round)", t_dxe, j_dxe)]
    print("1. one MoE layer, the same input and cotangent in both packages "
          "(largest ulps apart, share > 1 ulp):")
    for name, a, b in rows:
        mx, share = ulp_gap(a, b)
        print(f"   {name}: {mx:.0f} ulp, {share:.4f}")
    n = int((bf16(t_dxe) != bf16(j_dxe)).sum())
    print(f"   d_xe rounded to bf16: {n} of {t_dxe.numel()} elements differ")
    kw = dict(group_size=cfg.moe_group_size, capacity_factor=cfg.capacity_factor)
    jdx = jax.vjp(lambda a: JM.moe_ffn(jp, cfg, a, **kw)[0], jnp.asarray(x))[1](d)[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    tdx = torch.autograd.grad(TM.moe_ffn(tp, cfg, tx, **kw)[0], tx, torch.from_numpy(dout))[0]
    print(f"   the layer's d_x: max |difference| "
          f"{float(np.abs(_f32(tdx) - _f32(jdx)).max() / np.abs(_f32(jdx)).max()):.2e} of "
          f"its largest")


def silu_vjp() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.models.layers import silu

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 3).astype(np.float32)
    g = rng.standard_normal(100_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, c: jax.vjp(jax.nn.silu, a)[1](c)[0])(x, g))
    t = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    m8 = (x * g) * (t * (np.float32(1) - t))
    fma = (g.astype(np.float64) * t + m8).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    port = torch.autograd.grad(silu(tx), tx, torch.from_numpy(g))[0].numpy()
    print("2. silu's VJP as XLA compiles it, from XLA's t: "
          f"fma(g, t, (x g)(t(1 - t))) differs at {int((fma != want).sum())}, "
          f"g t + (x g)(t(1 - t)) at {int(((g * t + m8) != want).sum())}, the port's autograd "
          f"at {int((port != want).sum())} of {x.size}")


def moe_inputs() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import repro.models.transformer as JT
    from repro.models.model import build as jax_build
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer as TT
    from repro_torch.models.model import build

    jcfg, tcfg, tree, toks = group_of_8()
    jx, tx = [], []
    jinner, tinner = JT.moe_ffn, TT.moe_ffn

    def jmoe(p, cfg, x, **kw):
        jax.debug.callback(lambda a: jx.append(np.asarray(a)), x)
        return jinner(p, cfg, x, **kw)

    def tmoe(p, cfg, x, **kw):
        tx.append(x.detach().numpy().copy())
        return tinner(p, cfg, x, **kw)

    JT.moe_ffn, TT.moe_ffn = jmoe, tmoe
    try:
        jax.jit(jax_build(jcfg).loss)(jax.tree.map(jnp.asarray, tree),
                                      {"tokens": jnp.asarray(toks)})
        jax.effects_barrier()
        with torch.no_grad():
            build(tcfg, device="cpu").loss(lm_params_from_numpy(tree), {"tokens": toks})
    finally:
        JT.moe_ffn, TT.moe_ffn = jinner, tinner
    print("3. the group of 8's forward: each MoE layer's input (JAX, port), float32, "
          "and its bf16 rounding:")
    for i, (a, b) in enumerate(zip(jx, tx)):
        mx, share = ulp_gap(b, a)
        rel = float(np.abs(a - b).max() / np.abs(a).max())
        flips = np.argwhere(bf16(a) != bf16(b))
        print(f"   MoE layer {i} (j = {2 * i + 1}): {mx:.0f} ulp apart at most, {share:.4f} of "
              f"elements > 1 ulp, max |difference| {rel:.2e} of the largest; the bf16 cast "
              f"differs at {len(flips)} of {a.size}")
        for f in map(tuple, flips[:3]):
            print(f"      token {f[1]} channel {f[2]}: JAX {float(a[f])!r} port "
                  f"{float(b[f])!r} ({ulp_gap(b[f], a[f])[0]:.0f} ulp) -> bf16 "
                  f"{float(bf16(a)[f])!r} / {float(bf16(b)[f])!r}")


def gradient_gaps(fma: bool) -> None:
    import contextlib

    import jax
    import jax.numpy as jnp
    import torch

    from repro.models.model import build as jax_build
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import layers as TL, ssm as TS
    from repro_torch.models.model import build
    from repro_torch.tree import flat_leaves

    jcfg, tcfg, tree, toks = group_of_8()
    f = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)
    jp, batch = jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)}
    ref = {k: np.asarray(v) for k, v in flat_leaves(f(jp, batch)[1]).items()}
    with jax.disable_jit():
        op_by_op = {k: np.asarray(v) for k, v in flat_leaves(f(jp, batch)[1]).items()}

    def port() -> dict:
        tp = lm_params_from_numpy(tree)
        leaves = flat_leaves(tp)
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = build(tcfg, device="cpu").loss(tp, {"tokens": toks})
        return {k: g.numpy() for k, g in zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))}

    def worst(got: dict) -> str:
        gaps = sorted(((float(np.abs(got[k] - v).max() / np.abs(v).max()), k)
                       for k, v in ref.items()), reverse=True)[:3]
        return ", ".join(f"{k} {g:.2e}" for g, k in gaps)

    runs = {"the port": port, "the JAX package op by op": lambda: op_by_op}
    if fma:
        @contextlib.contextmanager
        def patched():
            saved = TL.silu, TS.silu
            TL.silu = TS.silu = fma_silu()
            try:
                yield
            finally:
                TL.silu, TS.silu = saved

        def port_fma():
            with patched():
                return port()

        runs["the port, silu's backward in XLA's FMA order"] = port_fma
    print("4. the gradient leaves farthest from the compiled JAX package (max |difference| "
          "over the leaf's largest):")
    for name, run in runs.items():
        print(f"   {name}: {worst(run())}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fma-silu", action="store_true",
                    help="also run the port with silu's backward in XLA's FMA order")
    args = ap.parse_args(argv)
    one_moe_layer()
    silu_vjp()
    moe_inputs()
    gradient_gaps(args.fma_silu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
