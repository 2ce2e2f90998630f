"""The port's VLM backbone (Qwen2-VL: the dense stack with M-RoPE;
``models/model.py``'s ``build`` / ``loss`` with a vision prefix /
``prefill`` / ``decode_step``, ``convert.py``'s tree,
``launch/serve.py::serve_loop``) against the JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced Qwen2-VL (2 layers, d = 64, 4 / 2 heads of 32,
sections (4, 6, 6)).  The contract, fixed before the port was written:

* a float32 ``prefill`` and three greedy ``decode_step``s under dense and
  every ``mvu_*`` backend (int8 KV cache too): logits within 1e-3 of the
  largest reference logit, greedy tokens equal; ``serve_loop`` returns the
  same token lists; the committed golden
  (``configs/qwen2_vl_7b_lm_golden.json``) holds on the CPU;
* in bfloat16, logits correlation >= 0.999 and max |delta| <= 2e-2 of the
  largest logit against the JAX package run op by op
  (``jax.disable_jit()``), ``tests/test_torch_lm.py``'s bounds;
* a prompt prefilled and the rest decoded give one prefill's logits
  within float32 rtol = atol = 1e-5;
* serving reads only tokens, as the reference's does: a prefill batch
  that carries ``prefix_embeds`` gives the logits of one without, and the
  JAX package's;
* ``Model.loss`` with a 40-patch vision prefix (t, h and w ids all
  distinct) and without one, under dense, W8A8 and binary, remat on: the
  loss within 1e-5 of the reference's and every gradient leaf within
  1e-4 of its largest ``jax.value_and_grad`` magnitude (the dense
  family's bounds: the VLM has no MoE cast); the committed prefix-loss
  golden (``configs/qwen2_vl_7b_qat_golden.json``) holds on the CPU;
* ``lm_numpy_params`` draws the reference's layout (``jax.eval_shape`` of
  its ``init``) in float32 and bfloat16; ``init(quantize=...)`` equals
  quantizing the float init; the full config builds, and so does
  whisper-tiny (its tests: ``tests/test_torch_lm_encdec.py``).
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
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import cast_numpy_params, lm_numpy_params, lm_params_from_numpy
from repro_torch.launch.serve import Request, serve_loop
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import build
from repro_torch.models.vlm import patch_embed_stub
from repro_torch.tree import flat_leaves

ARCH = G.VLM_ARCH
MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(backend="dense", dtype="float32", **kw):
    """(JAX config, port config) of the reduced Qwen2-VL (remat off unless
    ``kw`` says otherwise)."""
    kw = {"dtype": dtype, "remat": False, "linear_backend": backend, **kw}
    return jax_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (integers as they are)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.to(torch.float32) if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _trees(cfg, backend="dense", dtype="float32", seed=0):
    """The JAX and the port's trees of ``lm_numpy_params(cfg, seed)`` in
    ``dtype``, quantized by each package under an ``mvu_*`` backend."""
    tree = cast_numpy_params(lm_numpy_params(cfg, seed), jnp.dtype(dtype))
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    if backend in MVU:
        jp, tp = JL.quantize_model_params(jp, backend), TL.quantize_model_params(tp, backend)
    return jp, tp


def _runs(backend, dtype, *, steps=3, op_by_op=False, seed=0, **cfg_kw):
    """Logits of prefill + ``steps`` greedy decode steps on each package,
    both fed the JAX package's greedy tokens: (jax logits, port logits,
    jax tokens, port tokens), logits stacked (1 + steps, B, V) in float32."""
    jcfg, tcfg = _cfg(backend, dtype, **cfg_kw)
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
def _within_float32_contract(jl, tl, jt, tt):
    bound = G.LOGIT_ATOL * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound, (np.abs(tl - jl).max(), bound)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("backend", ["dense", *MVU])
def test_prefill_decode_float32_equal_jax(backend):
    _within_float32_contract(*_runs(backend, "float32"))


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_kv_quant_decode_equal_jax(backend):
    _within_float32_contract(*_runs(backend, "float32", kv_quant=True))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_prefill_decode_bfloat16_within_bounds_of_jax_op_by_op(backend, seed):
    jl, tl, _, _ = _runs(backend, "bfloat16", op_by_op=True, seed=seed)
    corr = np.corrcoef(jl.ravel(), tl.ravel())[0, 1]
    assert corr >= 0.999, corr
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max(), np.abs(tl - jl).max()


@pytest.mark.parametrize("backend", G.VARIANTS)
def test_golden_run_on_the_cpu(backend):
    """The committed JAX golden run (``scripts/lm_golden.py --arch
    qwen2-vl-7b``), as ``chip_smoke.py`` holds it on the card."""
    want = G.load_golden(ARCH)["variants"][backend]
    cfg = G.golden_config(backend, ARCH)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = TL.quantize_model_params(params, backend)
    got = G.greedy_run(build(cfg, device="cpu"), params)
    assert "dropped" not in got and G.mismatch(want, got) is None, G.mismatch(want, got)


@pytest.mark.parametrize("b,s_prompt,s_total", [(2, 8, 12), (1, 3, 12)])
def test_prefill_then_decode_equals_the_full_prefill(b, s_prompt, s_total):
    """Dense float32 (an ``mvu_*`` backend quantizes each call's activations
    on their own scale, so only the dense model can agree): a prompt
    prefilled and the rest decoded, each decode step's (B, 1) position
    broadcast to the three M-RoPE axes, give one prefill's logits within
    float32 rtol = atol = 1e-5, argmax equal."""
    _, tcfg = _cfg()
    _, tp = _trees(tcfg)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (b, s_total)).astype(np.int32)
    m = build(tcfg, device="cpu")
    full, _ = m.prefill(tp, {"tokens": toks}, m.init_decode_state(b, 32))
    logits, state = m.prefill(tp, {"tokens": toks[:, :s_prompt]}, m.init_decode_state(b, 32))
    for t in range(s_prompt, s_total):
        logits, state = m.decode_step(tp, state, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(full.numpy(), -1))
    assert int(state["pos"][0, 0]) == s_total


@pytest.mark.parametrize("max_new", [(4, 4, 4), (4, 2, 3)])
def test_serve_loop_equal_jax(max_new):
    jcfg, tcfg = _cfg("mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (5, 9, 7)]
    want = jax_serve_loop(jax_build(jcfg), jp,
                          [JRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))],
                          batch=2, max_len=32)
    got = serve_loop(build(tcfg, device="cpu"), tp,
                     [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))],
                     batch=2, max_len=32)
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2]
    assert [r.out for r in got] == [[int(t) for t in r.out] for r in want]


def test_prefill_ignores_prefix_embeds_as_the_reference_does():
    """A prefill batch that carries a vision prefix gives the logits and
    cache of one without it (the prompt's ids start at 0 on all three
    axes), and the JAX package's prefill of the same batch."""
    jcfg, tcfg = _cfg("mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32)
    prefix = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    m = build(tcfg, device="cpu")
    plain, s0 = m.prefill(tp, {"tokens": toks}, m.init_decode_state(2, 32))
    with_prefix, s1 = m.prefill(tp, {"tokens": toks, "prefix_embeds": prefix},
                                m.init_decode_state(2, 32))
    assert torch.equal(plain, with_prefix)
    assert torch.equal(s0["caches"]["k"], s1["caches"]["k"]) and int(s1["pos"][0, 0]) == 10
    jm = jax_build(jcfg)
    want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(prefix)},
                         jm.init_decode_state(2, 32))
    ref = np.asarray(want)
    assert np.abs(with_prefix.numpy() - ref).max() <= G.LOGIT_ATOL * np.abs(ref).max()


# ------------------------------------------------------------ Model.loss
def _loss_and_grads(backend, seed, prefix: bool):
    """``Model.loss`` (remat on) and every gradient on each package over
    (2, 17) tokens, behind a (2, 40, d) prefix (normal x 0.1) or none."""
    jcfg, tcfg = _cfg(backend, remat=True)
    tree = lm_numpy_params(tcfg, seed)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)}
    if prefix:
        batch["prefix_embeds"] = (rng.standard_normal((2, 40, tcfg.d_model)) * 0.1).astype(
            np.float32)
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, taux = build(tcfg, device="cpu").loss(tp, batch)
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    return float(jl), flat_leaves(jg), tl, taux, grads


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_loss_and_gradients_float32_equal_jax(backend, seed, prefix):
    jl, jg, tl, taux, grads = _loss_and_grads(backend, seed, prefix)
    assert abs(tl.item() - jl) <= G.LOSS_RTOL * abs(jl), (tl.item(), jl)
    assert taux["aux"].item() == 0.0 and tl.item() == taux["ce"].item()
    assert grads.keys() == jg.keys()
    for path, g in jg.items():
        want = _np(g)
        assert grads[path].dtype == torch.float32 and tuple(grads[path].shape) == want.shape
        err = np.abs(_np(grads[path]) - want).max()
        assert err <= G.GRAD_ATOL * np.abs(want).max(), (path, err, np.abs(want).max())


def test_the_prefix_moves_the_text_positions():
    """The vision prefix's rows are dropped before the logits, yet a prefix
    of zeros (``patch_embed_stub``) changes the loss: the text attends to
    it and starts at id 16, not 0.  The JAX package agrees on both."""
    jcfg, tcfg = _cfg()
    jp, tp = _trees(tcfg)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    zeros = patch_embed_stub(2, 256, tcfg.d_model, torch.float32)
    m, jm = build(tcfg, device="cpu"), jax_build(jcfg)
    with_prefix, _ = m.loss(tp, {"tokens": toks, "prefix_embeds": zeros})
    plain, _ = m.loss(tp, {"tokens": toks})
    assert with_prefix.item() != plain.item()
    for got, batch in ((with_prefix, {"tokens": toks, "prefix_embeds": zeros.numpy()}),
                       (plain, {"tokens": toks})):
        want, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        assert abs(got.item() - float(want)) <= G.LOSS_RTOL * abs(float(want))


@pytest.mark.parametrize("backend", G.QAT_VARIANTS)
def test_prefix_loss_golden_on_the_cpu(backend):
    """The committed prefix-loss golden (``scripts/lm_qat_golden.py --arch
    qwen2-vl-7b``): the loss and every gradient leaf's digest, as
    ``chip_smoke.py`` holds it on the card."""
    golden = G.load_qat_golden(ARCH)
    assert golden["prefix"] == G.VLM_PREFIX and golden["variants"].keys() == set(G.QAT_VARIANTS)
    cfg = G.qat_config(backend, ARCH)
    assert G.qat_batch(cfg)["prefix_embeds"].shape == (G.BATCH, G.VLM_PREFIX, cfg.d_model)
    got = G.qat_run(build(cfg, device="cpu"), lm_params_from_numpy(lm_numpy_params(cfg, G.SEED)))
    assert G.qat_mismatch(golden["variants"][backend], got) is None, backend


# ------------------------------------------------------------ params and builds
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_tree_is_the_reference_layout(dtype):
    """``lm_numpy_params`` draws the dense tree the JAX package's ``init``
    gives the VLM: names, shapes and dtypes of ``jax.eval_shape``."""
    jcfg, tcfg = _cfg(dtype=dtype)
    tree = cast_numpy_params(lm_numpy_params(tcfg, 0), jnp.dtype(dtype))
    ref = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)
    assert set(tree["layers"]) == {"ln1", "ln2", "attn", "ffn"} and "unembed" in tree
    for t in flat_leaves(lm_params_from_numpy(tree)).values():
        assert t.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_binary"])
def test_init_quantized_as_drawn_equals_quantizing_the_float_init(backend):
    _, cfg = _cfg(backend, dtype="bfloat16")
    m = build(cfg, device="cpu")
    drawn = m.init(torch.Generator().manual_seed(3), quantize=backend)
    want = TL.quantize_model_params(m.init(torch.Generator().manual_seed(3)), backend)
    assert flat_leaves(drawn).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        assert torch.equal(flat_leaves(drawn)[path], w), path
    lay = drawn["layers"]
    assert {k for k, v in (lay["attn"] | lay["ffn"]).items() if "values" in v} == set(
        TL.PROJ_NAMES)


def test_the_vlm_builds_and_whisper_still_raises():
    """The full config and the reduced one build on the CPU (the uniform
    dense stack, as the reference's ``stack_init`` dispatches a VLM:
    neither hybrid, SSM nor MoE); the encoder-decoder builds too, its
    stacks under ``encdec`` (``tests/test_torch_lm_encdec.py``)."""
    full = get_config(ARCH)
    assert full.family == "vlm" and full.mrope and not (full.is_hybrid or full.is_moe)
    TT.require_ported(full)
    assert build(full, device="cpu").cfg is full and TT._n_stacked(full) == 28
    build(get_reduced(ARCH), device="cpu")
    lm_numpy_params(get_reduced(ARCH), 0)
    whisper = get_reduced("whisper-tiny")
    TT.require_ported(whisper)
    assert build(whisper, device="cpu").cfg is whisper
    assert set(lm_numpy_params(whisper, 0)["encdec"]) == {"enc", "dec", "ln_enc"}


def test_build_runs_prefill_decode_and_the_prefix_loss_at_the_reduced_config():
    """``build(get_reduced("qwen2-vl-7b"), device="cpu")`` as configured
    (bfloat16, remat on): params from ``init``, a prefill, a decode step
    and the loss behind a bf16 patch prefix with its gradients, all
    finite."""
    cfg = get_reduced(ARCH)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, state = m.prefill(params, {"tokens": toks[:, :8]}, m.init_decode_state(2, 16))
    logits, state = m.decode_step(params, state, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    prefix = torch.randn((2, 20, cfg.d_model), generator=torch.Generator().manual_seed(1))
    loss, aux = m.loss(params, {"tokens": toks, "prefix_embeds": prefix})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert bool(torch.isfinite(loss)) and aux["aux"].item() == 0.0
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.bfloat16 for g in grads)
