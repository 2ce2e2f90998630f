"""The port's encoder-decoder (the Whisper backbone: ``models/model.py``'s
``build`` / ``init`` / ``loss`` / ``init_decode_state`` / ``prefill`` /
``decode_step`` on ``params["encdec"]``, ``convert.py``'s tree,
``layers.quantize_model_params`` through the cross attention) against the
JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced whisper-tiny (2 encoder and 2 decoder layers,
d = 64, 4 heads of 16, GELU d_ff 128, LayerNorm, vocab 256).  The
contract, fixed before the port was written:

* a float32 ``prefill`` (with ``enc_embeds``) and three greedy
  ``decode_step``s under dense and every ``mvu_*`` backend, and with an
  int8 KV cache: logits within 1e-3 of the largest reference logit,
  greedy tokens equal (``tests/test_torch_lm.py``'s contract); the
  committed golden (``configs/whisper_tiny_lm_golden.json``) holds on the
  CPU;
* in bfloat16, logits correlation >= 0.999 and max |delta| <= 2e-2 of the
  largest logit against the JAX package run op by op
  (``jax.disable_jit()``), ``tests/test_torch_lm.py``'s bounds;
* a prompt prefilled and the rest decoded give one prefill's logits
  within float32 rtol = atol = 1e-5 (the port's twin of the reference's
  ``test_prefill_decode_matches_forward[whisper-tiny]``);
* the reference's two serving properties: a W8A8 prefill makes 32
  projection calls (2 encoder layers x 6 + 2 decoder layers x 10) and each
  decode step 20, in both packages (every step projects the encoder memory
  again: no cross K/V cache); ``serve_loop`` raises ``KeyError:
  'enc_embeds'`` in both packages;
* ``Model.loss`` on tokens behind frame embeddings under dense, W8A8 and
  binary, remat on, seeds 0 and 1: the loss within 1e-5 of the reference's
  and every gradient leaf within 1e-4 of its largest
  ``jax.value_and_grad`` magnitude; ``aux`` a float32 zero; the committed
  QAT golden (``configs/whisper_tiny_qat_golden.json``) holds on the CPU;
* ``lm_numpy_params`` draws the reference's layout (``jax.eval_shape`` of
  its ``init``) in float32 and bfloat16, the full config's 56,364,288
  parameters; ``quantize_model_params`` on it equals the reference's leaf
  for leaf, ``xattn`` quantized; ``init_decode_state`` has the reference's
  layout, the (B, 1, d) ``enc_out`` placeholder included;
  ``init(quantize=...)`` equals quantizing the float init; ``build``
  without a device raises on a host with no CUDA.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as JO
import repro.models.layers as JL
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models.model import build as jax_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import cast_numpy_params, lm_numpy_params, lm_params_from_numpy
from repro_torch.kernels import ops as TO
from repro_torch.launch.serve import Request, serve_loop
from repro_torch.models import layers as TL
from repro_torch.models.model import build
from repro_torch.tree import flat_leaves

ARCH = G.ENCDEC_ARCH
MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")
FRAMES = 20  # encoder positions of the tests' frame embeddings


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(backend="dense", dtype="float32", **kw):
    """(JAX config, port config) of the reduced whisper-tiny (remat off
    unless ``kw`` says otherwise)."""
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


def _enc(d, seed, b=2, frames=FRAMES) -> np.ndarray:
    """(b, frames, d) float32 frame embeddings, normal x 0.1 (the scale of
    the reference's ``tests/test_models.py``)."""
    return (np.random.default_rng(100 + seed).standard_normal((b, frames, d)) * 0.1).astype(
        np.float32)


def _runs(backend, dtype, *, steps=3, op_by_op=False, seed=0, **cfg_kw):
    """Logits of prefill + ``steps`` greedy decode steps on each package,
    both fed the JAX package's greedy tokens: (jax logits, port logits,
    jax tokens, port tokens), logits stacked (1 + steps, B, V) in float32."""
    jcfg, tcfg = _cfg(backend, dtype, **cfg_kw)
    jp, tp = _trees(tcfg, backend, dtype, seed)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    enc = _enc(tcfg.d_model, seed)
    out = {"j": [], "t": [], "jt": [], "tt": []}
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        js, ts = jm.init_decode_state(2, 32), tm.init_decode_state(2, 32)
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}, js)
        tl, ts = tm.prefill(tp, {"tokens": toks, "enc_embeds": enc}, ts)
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
    whisper-tiny``): its prefill reads ``G.enc_embeds`` (2 x 20 frames: 40
    encoder rows a projection, not a multiple of a 32-row tile), as
    ``chip_smoke.py`` holds it on the card."""
    golden = G.load_golden(ARCH)
    assert (golden["enc_frames"], golden["enc_seed"], golden["enc_scale"]) == (
        G.ENC_FRAMES, G.ENC_SEED, G.ENC_SCALE)
    cfg = G.golden_config(backend, ARCH)
    assert G.golden_batch(cfg)["enc_embeds"].shape == (G.BATCH, G.ENC_FRAMES, cfg.d_model)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = TL.quantize_model_params(params, backend)
    got = G.greedy_run(build(cfg, device="cpu"), params)
    assert "dropped" not in got and G.mismatch(golden["variants"][backend], got) is None, \
        G.mismatch(golden["variants"][backend], got)


@pytest.mark.parametrize("b,s_prompt,s_total", [(2, 8, 12), (1, 3, 12)])
def test_prefill_then_decode_equals_the_full_prefill(b, s_prompt, s_total):
    """Dense float32 (the reference's test builds the same way: remat off,
    float32): a prompt prefilled behind the frames and the rest decoded
    against ``state["enc_out"]`` give one prefill's logits within float32
    rtol = atol = 1e-5, argmax equal."""
    _, tcfg = _cfg()
    _, tp = _trees(tcfg)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (b, s_total)).astype(np.int32)
    enc = _enc(tcfg.d_model, 3, b=b, frames=12)
    m = build(tcfg, device="cpu")
    full, _ = m.prefill(tp, {"tokens": toks, "enc_embeds": enc}, m.init_decode_state(b, 32))
    logits, state = m.prefill(tp, {"tokens": toks[:, :s_prompt], "enc_embeds": enc},
                              m.init_decode_state(b, 32))
    for t in range(s_prompt, s_total):
        logits, state = m.decode_step(tp, state, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(full.numpy(), -1))
    assert int(state["pos"][0, 0]) == s_total and tuple(state["enc_out"].shape) == (
        b, 12, tcfg.d_model)


@contextlib.contextmanager
def _counting_mvu(module):
    """Count ``module.mvu`` calls (the JAX package's or the port's
    ``kernels/ops.py``) while open."""
    inner, calls = module.mvu, []

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return inner(*args, **kw)

    module.mvu = counted
    try:
        yield calls
    finally:
        module.mvu = inner


def test_prefill_makes_32_projection_calls_and_each_step_20_in_both_packages():
    """At the reduced W8A8 model, op by op in the reference (its layer scans
    run as Python loops there): the prefill projects 2 encoder layers x 6 +
    2 decoder layers x 10 times, and every decode step 2 x 10, the cross
    attention's ``wk`` / ``wv`` on the whole encoder memory again (no cross
    K/V cache in either package)."""
    jcfg, tcfg = _cfg("mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    enc = _enc(tcfg.d_model, 5)
    runs = {"jax": (JO, jax_build(jcfg), jp, {"tokens": jnp.asarray(toks),
                                              "enc_embeds": jnp.asarray(enc)}, jnp.asarray),
            "port": (TO, build(tcfg, device="cpu"), tp, {"tokens": toks, "enc_embeds": enc},
                     torch.from_numpy)}
    for name, (module, model, params, batch, to_array) in runs.items():
        with jax.disable_jit(), _counting_mvu(module) as calls:
            marks = [0]
            logits, state = model.prefill(params, batch, model.init_decode_state(2, 16))
            marks.append(len(calls))
            for _ in range(2):
                nxt = to_array(np.argmax(_np(logits), -1).astype(np.int32))
                logits, state = model.decode_step(params, state, nxt)
                marks.append(len(calls))
        assert np.diff(marks).tolist() == [32, 20, 20], (name, marks)


def test_serve_loop_raises_key_error_in_both_packages():
    """``serve_loop`` hands ``prefill`` tokens alone, and the encoder reads
    ``batch["enc_embeds"]``: the reference raises ``KeyError`` on
    whisper-tiny, and so does the port (the model is served through
    ``prefill`` with ``enc_embeds`` and ``decode_step``, as the
    reference's dry run drives it)."""
    jcfg, tcfg = _cfg("mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(KeyError, match="enc_embeds"):
        jax_serve_loop(jax_build(jcfg), jp, [JRequest(0, prompt, 2)], batch=2, max_len=16)
    with pytest.raises(KeyError, match="enc_embeds"):
        serve_loop(build(tcfg, device="cpu"), tp, [Request(0, prompt, 2)], batch=2, max_len=16)


# ------------------------------------------------------------ Model.loss
def _loss_and_grads(backend, seed):
    """``Model.loss`` (remat on) and every gradient on each package over
    (2, 17) tokens behind (2, 20, d) frame embeddings."""
    jcfg, tcfg = _cfg(backend, remat=True)
    tree = lm_numpy_params(tcfg, seed)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    batch = {"tokens": np.random.default_rng(seed + 1).integers(
        0, tcfg.vocab_size, (2, 17)).astype(np.int32), "enc_embeds": _enc(tcfg.d_model, seed)}
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, taux = build(tcfg, device="cpu").loss(tp, batch)
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    return float(jl), jaux, flat_leaves(jg), tl, taux, grads


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_loss_and_gradients_float32_equal_jax(backend, seed):
    jl, jaux, jg, tl, taux, grads = _loss_and_grads(backend, seed)
    assert abs(tl.item() - jl) <= G.LOSS_RTOL * abs(jl), (tl.item(), jl)
    assert taux["aux"].dtype == torch.float32 and taux["aux"].item() == 0.0 == float(
        jaux["aux"])
    assert tl.item() == taux["ce"].item()
    assert grads.keys() == jg.keys()
    assert any(p.startswith("encdec/dec/xattn/") for p in grads)
    for path, g in jg.items():
        want = _np(g)
        assert grads[path].dtype == torch.float32 and tuple(grads[path].shape) == want.shape
        err = np.abs(_np(grads[path]) - want).max()
        assert err <= G.GRAD_ATOL * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("backend", G.QAT_VARIANTS)
def test_qat_golden_on_the_cpu(backend):
    """The committed QAT golden (``scripts/lm_qat_golden.py --arch
    whisper-tiny``): the loss and every gradient leaf's digest, each
    stacked leaf of both stacks a layer at a time, as ``chip_smoke.py``
    holds it on the card."""
    golden = G.load_qat_golden(ARCH)
    assert golden["enc_frames"] == G.ENC_FRAMES and golden["variants"].keys() == set(
        G.QAT_VARIANTS)
    want = golden["variants"][backend]
    assert len(want["grads"]["encdec/dec/xattn/wk/w"]["dot"]) == get_reduced(ARCH).num_layers
    cfg = G.qat_config(backend, ARCH)
    got = G.qat_run(build(cfg, device="cpu"), lm_params_from_numpy(lm_numpy_params(cfg, G.SEED)))
    assert G.qat_mismatch(want, got) is None, G.qat_mismatch(want, got)


# ------------------------------------------------------------ params and builds
def _layout(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_tree_is_the_reference_layout(dtype):
    """``lm_numpy_params`` draws the tree the JAX package's ``init`` gives
    whisper-tiny: paths, shapes and dtypes of ``jax.eval_shape``."""
    jcfg, tcfg = _cfg(dtype=dtype)
    tree = cast_numpy_params(lm_numpy_params(tcfg, 0), jnp.dtype(dtype))
    ref = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    assert _layout(tree) == _layout(ref)
    assert set(tree) == {"embed", "encdec", "ln_f", "unembed"}
    assert set(tree["encdec"]) == {"enc", "dec", "ln_enc"}
    assert set(tree["encdec"]["enc"]) == {"ln1", "attn", "ln2", "ffn"}
    assert set(tree["encdec"]["dec"]) == {"ln1", "attn", "lnx", "xattn", "ln2", "ffn"}
    for t in flat_leaves(lm_params_from_numpy(tree)).values():
        assert t.dtype == getattr(torch, dtype)


def test_the_full_config_counts_the_reference_parameters():
    """Full width and depth: 56,364,288 parameters, the count of
    ``jax.eval_shape`` on the reference's ``init``, in its layout; the
    port's own ``init`` draws the same layout (at the reduced config)."""
    ref = jax.eval_shape(jax_build(jax_config(ARCH)).init, jax.random.PRNGKey(0))
    tree = lm_numpy_params(get_config(ARCH), 0)
    n = sum(a.size for a in jax.tree.leaves(tree))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref)) == 56_364_288
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == jax.tree.map(
        lambda a: tuple(a.shape), ref)
    del tree
    cfg = get_reduced(ARCH)
    got = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _layout(got) == _layout(cast_numpy_params(lm_numpy_params(cfg, 0),
                                                     jnp.dtype(cfg.dtype)))


@pytest.mark.parametrize("backend", MVU)
def test_quantize_model_params_equal_jax(backend):
    """Every leaf of the quantized tree equals the reference's, the cross
    attention's projections integer-deployed with the rest."""
    _, tcfg = _cfg(backend)
    jp, tp = _trees(tcfg, backend)
    want = flat_leaves(lm_params_from_numpy(jax.tree.map(np.asarray, jp)))
    got = flat_leaves(tp)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path
    for stack, nodes in (("enc", ("attn", "ffn")), ("dec", ("attn", "xattn", "ffn"))):
        for node in nodes:
            for name, leaf in tp["encdec"][stack][node].items():
                assert set(leaf) == {"values", "scale"}, (stack, node, name)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_decode_state_is_the_reference_layout(kv_quant):
    jcfg, tcfg = _cfg(kv_quant=kv_quant)
    ref = jax.eval_shape(lambda: jax_build(jcfg).init_decode_state(3, 16))
    state = build(tcfg, device="cpu").init_decode_state(3, 16)
    assert _layout(state) == _layout(ref)
    assert tuple(state["enc_out"].shape) == (3, 1, tcfg.d_model) and not bool(
        state["enc_out"].any())
    assert state["caches"]["k"].shape[0] == tcfg.num_layers


@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_binary"])
def test_init_quantized_as_drawn_equals_quantizing_the_float_init(backend):
    _, cfg = _cfg(backend, dtype="bfloat16")
    m = build(cfg, device="cpu")
    drawn = m.init(torch.Generator().manual_seed(3), quantize=backend)
    want = TL.quantize_model_params(m.init(torch.Generator().manual_seed(3)), backend)
    assert flat_leaves(drawn).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        assert torch.equal(flat_leaves(drawn)[path], w), path
    dec = drawn["encdec"]["dec"]
    assert {k for k, v in (dec["attn"] | dec["ffn"]).items() if "values" in v} == {
        n for n in TL.PROJ_NAMES if n != "w_gate"}
    assert all("values" in v for v in dec["xattn"].values())


def test_build_without_a_device_raises_without_cuda():
    full = get_config(ARCH)
    assert full.encdec and full.family == "audio" and build(full, device="cpu").cfg is full
    if torch.cuda.is_available():
        assert build(full).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(full)


def test_build_runs_prefill_decode_and_the_loss_at_the_reduced_config():
    """``build(get_reduced("whisper-tiny"), device="cpu")`` as configured
    (bfloat16, remat on): params from ``init``, a prefill behind bf16 frame
    embeddings, a decode step, and the loss with its gradients: finite, the
    loss within (0.5, 2.5) x ln(vocab) as the reference's smoke test
    bounds it."""
    cfg = get_reduced(ARCH)
    assert cfg.remat and cfg.dtype == "bfloat16"
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    enc = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.1
    logits, state = m.prefill(params, {"tokens": toks[:, :8], "enc_embeds": enc},
                              m.init_decode_state(2, 16))
    assert state["enc_out"].dtype == torch.bfloat16
    logits, state = m.decode_step(params, state, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = m.loss(params, {"tokens": toks, "enc_embeds": enc})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert 0.5 * np.log(cfg.vocab_size) < loss.item() < 2.5 * np.log(cfg.vocab_size)
    assert aux["aux"].item() == 0.0
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.bfloat16 for g in grads)
