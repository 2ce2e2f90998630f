"""The port's MoE decoder (the MoE arms of ``models/transformer.py``,
``models/model.py``'s ``build`` / ``loss``, ``convert.py``'s MoE trees and
``launch/serve.py::serve_loop``) against the JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced Granite-MoE and Qwen3-MoE (2 layers, d = 64, 8
experts top-2, routing groups of 64).  The contract, fixed before the
port was written:

* a float32 ``prefill`` and three greedy ``decode_step``s under dense and
  every ``mvu_*`` backend (the attention projections quantized, the
  experts and the router float, as in the reference): logits within 1e-3
  of the largest reference logit, greedy tokens equal; ``serve_loop`` on
  padded prompts returns the same token lists; the committed goldens
  (``configs/*_lm_golden.json``, with each call's dropped assignments)
  hold on the CPU;
* prefill of a prompt and decode steps give the logits of one prefill of
  the whole sequence when no assignment drops (``capacity_factor`` 8.0,
  the reference's ``test_prefill_decode_matches_forward`` and its
  tolerance, rtol = atol = 2e-2, argmax equal), and that prefill the JAX
  package's within 1e-3 of the largest logit;
* ``Model.loss`` under dense and ``mvu_w8a8`` (the fake-quant arm) in
  float32: loss and its load-balancing part within 1e-5 of the reference;
  every gradient leaf within 2^-8 (one bfloat16 ulp) of its largest
  ``jax.value_and_grad`` magnitude.  The reference casts the tokens to bfloat16 before the
  experts, so the backward rounds each token's gradient to bfloat16 there;
  float32 sums in another order can land that rounding one bfloat16 ulp
  apart (up to 2e-3 of a leaf's largest seen, ``ln2/scale`` and
  ``attn/wo/w``), where the dense family meets 1e-4;
* in bfloat16, prefill and decode logits correlation >= 0.999 and max
  |delta| <= 2e-2 of the largest logit against the JAX package run op by
  op (``jax.disable_jit()``), the router float32;
* ``quantize_model_params`` leaves the expert stacks and the router as they
  are (the reference's walk touches only ``{"w"}`` projection nodes), as
  do ``with_column_scales`` and ``init(quantize=...)``;
* ``lm_numpy_params`` draws the reference's MoE layout and
  ``lm_params_from_numpy`` carries a router kept float32 in a bfloat16
  tree across as it is.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_reduced as jax_reduced
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models.model import build as jax_build
from repro_torch.configs import get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import (
    cast_numpy_params,
    lm_numpy_params,
    lm_params_from_numpy,
    numpy_tree,
)
from repro_torch.launch.serve import Request, serve_loop
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import build
from repro_torch.tree import flat_leaves

MOE_ARCHS = G.MOE_ARCHS
MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, backend="dense", dtype="float32", **kw):
    """(JAX config, port config) of a reduced MoE arch."""
    kw = dict(dtype=dtype, remat=False, linear_backend=backend, **kw)
    return jax_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (integers as they are)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.to(torch.float32) if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _jax_cast(tree, dtype):
    """The JAX tree of numpy ``tree`` in ``dtype``, the router float32 (the
    reference's ``moe_init``; ``convert.cast_numpy_params``)."""
    return jax.tree.map(jnp.asarray, cast_numpy_params(tree, jnp.dtype(dtype)))


def _trees(cfg, backend="dense", dtype="float32", seed=0):
    """The JAX and the port's trees of ``lm_numpy_params(cfg, seed)`` in
    ``dtype`` (the router float32), quantized by each package under an
    ``mvu_*`` backend."""
    tree = lm_numpy_params(cfg, seed)
    jp = _jax_cast(tree, dtype)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    if backend in MVU:
        jp, tp = JL.quantize_model_params(jp, backend), TL.quantize_model_params(tp, backend)
    return jp, tp


def _runs(arch, backend, dtype, *, steps=3, op_by_op=False, seed=0, **cfg_kw):
    """Logits of prefill + ``steps`` greedy decode steps on each package,
    both fed the JAX package's greedy tokens: (jax logits, port logits,
    jax tokens, port tokens), logits stacked (1 + steps, B, V) in float32."""
    jcfg, tcfg = _cfg(arch, backend, dtype, **cfg_kw)
    jp, tp = _trees(tcfg, backend, dtype, seed)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    out = {"j": [], "t": [], "jt": [], "tt": []}
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        js, ts = jm.init_decode_state(2, 32), tm.init_decode_state(2, 32)
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, js)
        tl, ts = tm.prefill(tp, {"tokens": toks}, ts)
        for step in range(steps + 1):
            out["j"].append(_np(jl))
            out["t"].append(_np(tl))
            jn, tn = jnp.argmax(jl, -1), torch.argmax(tl, -1)
            out["jt"].append(np.asarray(jn))
            out["tt"].append(tn.numpy())
            if step < steps:
                jl, js = jm.decode_step(jp, js, jn)
                tl, ts = tm.decode_step(tp, ts, torch.from_numpy(np.array(jn)))
    return (np.stack(out["j"]), np.stack(out["t"]), np.stack(out["jt"]), np.stack(out["tt"]))


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("backend", ["dense", *MVU])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_float32_equal_jax(arch, backend):
    jl, tl, jt, tt = _runs(arch, backend, "float32")
    bound = G.LOGIT_ATOL * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound, (np.abs(tl - jl).max(), bound)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_bfloat16_within_bounds_of_jax_op_by_op(arch, backend):
    jl, tl, _, _ = _runs(arch, backend, "bfloat16", op_by_op=True)
    corr = np.corrcoef(jl.ravel(), tl.ravel())[0, 1]
    assert corr >= 0.999, corr
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max(), np.abs(tl - jl).max()


@pytest.mark.parametrize("backend", G.VARIANTS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_golden_run_on_the_cpu(arch, backend):
    """The committed JAX golden run, its dropped assignments included."""
    want = G.load_golden(arch)["variants"][backend]
    assert want["dropped"][0] > 0 and want["dropped"][1:] == [0] * G.DECODE_STEPS
    cfg = G.golden_config(backend, arch)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = TL.quantize_model_params(params, backend)
    got = G.greedy_run(build(cfg, device="cpu"), params)
    assert G.mismatch(want, got) is None, G.mismatch(want, got)
    assert G.mismatch(want, {**got, "dropped": [d + 1 for d in got["dropped"]]}) is not None


@pytest.mark.parametrize("s_prompt", [8, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_equals_the_full_prefill(arch, s_prompt):
    """The reference's ``test_prefill_decode_matches_forward`` for the MoE
    archs (dense, float32): at ``capacity_factor`` 8.0 no assignment drops,
    so a prompt prefilled and the rest of 12 tokens decoded give the full
    12-token prefill's logits, which equal the JAX package's."""
    jcfg, tcfg = _cfg(arch, capacity_factor=8.0)
    jp, tp = _trees(tcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    m = build(tcfg, device="cpu")
    full, _ = m.prefill(tp, {"tokens": toks}, m.init_decode_state(2, 32))
    logits, state = m.prefill(tp, {"tokens": toks[:, :s_prompt]}, m.init_decode_state(2, 32))
    for t in range(s_prompt, 12):
        logits, state = m.decode_step(tp, state, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(full.numpy(), -1))
    jm = jax_build(jcfg)
    jfull, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_decode_state(2, 32))
    ref = np.asarray(jfull)
    assert np.abs(full.numpy() - ref).max() <= G.LOGIT_ATOL * np.abs(ref).max()


@pytest.mark.parametrize("max_new", [(4, 4, 4), (4, 2, 3)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_loop_equal_jax(arch, max_new):
    """Padded prompts of three lengths in groups of 2 (the last padded with a
    copy): the padded positions route and take capacity in both packages."""
    jcfg, tcfg = _cfg(arch, "mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (9, 5, 12)]
    jdone = jax_serve_loop(jax_build(jcfg), jp, [JRequest(i, p, n) for i, (p, n) in
                                                 enumerate(zip(prompts, max_new))],
                           batch=2, max_len=32)
    tdone = serve_loop(build(tcfg, device="cpu"), tp,
                       [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))],
                       batch=2, max_len=32)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [[int(t) for t in r.out] for r in jdone]


# ------------------------------------------------------------ Model.loss
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_float32_equal_jax(arch, backend, seed):
    """``ce + aux_loss_weight * aux`` and every gradient, remat on, the
    attention projections on the fake-quant arm under W8A8."""
    jcfg, tcfg = _cfg(arch, backend)
    jcfg, tcfg = jcfg.replace(remat=True), tcfg.replace(remat=True)
    tree = lm_numpy_params(tcfg, seed)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    leaves = flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, taux = build(tcfg, device="cpu").loss(tp, {"tokens": toks})
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl)), (tl.item(), float(jl))
    assert float(jaux["aux"]) > 0
    assert abs(taux["aux"].item() - float(jaux["aux"])) <= 1e-5 * float(jaux["aux"])
    assert tl.item() == pytest.approx(taux["ce"].item() + tcfg.aux_loss_weight
                                      * taux["aux"].item(), rel=1e-6)
    jg = flat_leaves(jg)
    assert grads.keys() == jg.keys()
    assert "layers/moe/router/w" in grads and "layers/moe/w_gate" in grads
    for path, g in jg.items():
        want = _np(g)
        assert grads[path].dtype == torch.float32 and tuple(grads[path].shape) == want.shape
        err = np.abs(_np(grads[path]) - want).max()
        assert err <= 2.0 ** -8 * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_build_runs_prefill_decode_and_loss_at_the_reduced_config(arch):
    """``build(get_reduced(arch), device="cpu")`` as configured (bfloat16,
    remat on): params from ``init``, a prefill, a decode step and the loss
    with its gradients, all finite."""
    cfg = get_reduced(arch)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    assert params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert "ffn" not in params["layers"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, state = m.prefill(params, {"tokens": toks[:, :8]}, m.init_decode_state(2, 16))
    logits, state = m.decode_step(params, state, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = m.loss(params, {"tokens": toks})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert bool(torch.isfinite(loss)) and aux["aux"].item() > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------------------------ params
@pytest.mark.parametrize("backend", MVU)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_quantize_model_params_leaves_experts_and_router(arch, backend):
    """Every leaf equals the JAX package's quantized tree; only the four
    attention projections are integer-deployed."""
    _, tcfg = _cfg(arch, backend)
    jp, tp = _trees(tcfg, backend)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert flat_leaves(tp).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        g = flat_leaves(tp)[path]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), path
    moe = tp["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32 and moe["w_up"].dtype == torch.float32
    assert {k for k, v in tp["layers"]["attn"].items() if "values" in v} == {"wq", "wk", "wv",
                                                                              "wo"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_with_column_scales_leaves_experts_and_router(arch):
    _, tcfg = _cfg(arch, "mvu_binary")
    tp = lm_params_from_numpy(lm_numpy_params(tcfg, 0))
    scaled = TL.with_column_scales(tp["layers"], "mvu_binary")
    assert scaled["moe"] is not tp["layers"]["moe"]  # walked, and left as it was
    assert set(scaled["moe"]["router"]) == {"w"}
    for k in ("w_up", "w_gate", "w_down"):
        assert scaled["moe"][k] is tp["layers"]["moe"][k]
    assert "bipolar_scale" in scaled["attn"]["wq"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_quantized_as_drawn_equals_quantizing_the_float_init(arch):
    cfg = get_reduced(arch).replace(linear_backend="mvu_w8a8")
    m = build(cfg, device="cpu")
    drawn = m.init(torch.Generator().manual_seed(3), quantize="mvu_w8a8")
    want = TL.quantize_model_params(m.init(torch.Generator().manual_seed(3)), "mvu_w8a8")
    assert flat_leaves(drawn).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        assert torch.equal(flat_leaves(drawn)[path], w), path
    assert drawn["layers"]["moe"]["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tree_round_trips_with_the_router_float32(arch, dtype):
    """``lm_numpy_params`` draws the reference's layout (the shapes of the
    JAX package's own ``init``); cast to ``dtype`` but the router (as the
    reference's ``moe_init``), ``lm_params_from_numpy`` carries each leaf's
    dtype across; ``numpy_tree`` brings it back."""
    jcfg, tcfg = _cfg(arch)
    tree = lm_numpy_params(tcfg, 0)
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(lambda a: a.shape, shapes)
    e, d, f, n = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff, tcfg.num_layers
    moe = tree["layers"]["moe"]
    assert moe["router"]["w"].shape == (n, d, e) and moe["w_down"].shape == (n, e, f, d)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray,
                                           _jax_cast(tree, str(dtype).removeprefix("torch."))))
    for path, t in flat_leaves(tp).items():
        assert t.dtype == (torch.float32 if "router" in path else dtype), path
    back = numpy_tree(tp)
    for path, a in flat_leaves(tree).items():
        want = a if dtype == torch.float32 or "router" in path else _np(jnp.asarray(a).astype(
            "bfloat16"))
        np.testing.assert_array_equal(flat_leaves(back)[path], want, err_msg=path)


def test_only_the_dense_and_moe_families_build():
    """The dense, MoE, SSM, hybrid, VLM and audio families build; Jamba,
    which holds MoE and SSM layers, dispatches on ``is_hybrid`` before
    ``is_moe``; the encoder-decoder holds ``encdec`` in place of
    ``layers``."""
    cfg = get_reduced("jamba-1.5-large-398b")
    assert cfg.family == "hybrid" and cfg.is_hybrid and cfg.is_moe
    TT.require_ported(cfg)
    assert set(build(cfg, device="cpu").init(torch.Generator().manual_seed(0))["layers"]) == {
        "ln_mix", "ln_ffn", "attn", "ssm", "ffn", "moe"}
    whisper = get_reduced("whisper-tiny")
    TT.require_ported(whisper)
    assert set(build(whisper, device="cpu").init(torch.Generator().manual_seed(0))) == {
        "embed", "encdec", "ln_f", "unembed"}
    assert get_reduced("mamba2-780m").family == "ssm"
    for arch in ("yi-9b", *MOE_ARCHS, "mamba2-780m", "qwen2-vl-7b"):
        TT.require_ported(get_reduced(arch))
