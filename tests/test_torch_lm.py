"""The port's integer-deployed dense LM (``repro_torch.models``,
``core/mvu.py::quantized_linear``, ``launch/serve.py::serve_loop``) against
the JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced Yi-9B (2 layers, d = 64).  The contract, fixed
before the port was written:

* ``quantize_activations``, ``quantize_linear_params``,
  ``quantize_model_params`` and ``quantized_linear`` (both arms, every
  ``mvu_*`` backend) equal JAX's bit for bit;
* ``rmsnorm``, ``layernorm``, ``apply_rope``, the activations,
  ``attention``, ``ffn`` and ``_quant_kv`` within float32 rtol = atol = 1e-5;
* a float32 ``prefill`` and three greedy ``decode_step``s, dense and under
  every ``mvu_*`` backend (int8 KV cache too): logits within 1e-3 of the
  largest reference logit, greedy tokens equal; ``serve_loop`` returns the
  same token lists;
* in bfloat16, logits correlation >= 0.999 and max |delta| <= 2e-2 of the
  largest logit against the JAX package run op by op
  (``jax.disable_jit()``), dense, W8A8 and binary; the dense model meets
  them against the compiled one too.  Compiled, XLA keeps float32 between
  some ops of ``quantized_linear`` (the scale ``a_scale`` unrounded in the
  epilogue multiply, ``/ 127`` as ``* (1 / 127)``, the norm's output fused
  into the activation quantizer), so the JAX package's own compiled W8A8
  and binary models differ from their op-by-op runs by more than 2e-2 in
  bfloat16 (``scripts/lm_golden.py --bf16-gap``); the port follows the
  op-by-op semantics, each op in the reference's dtype;
* the reference's own claims (``tests/test_quantized_serving.py``) hold on
  the port; the committed golden run (``configs/yi_9b_lm_golden.json``)
  holds on the CPU.

The port runs on CPU tensors: ``linear`` passes ``backend="cuda"``, whose
wrappers take the kernels' plain versions on a CPU tensor.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs import get_reduced as jax_reduced
from repro.core.mvu import quantized_linear as jax_quantized_linear
from repro.core.quantize import QTensor as JQTensor
from repro.core.quantize import quantize_activations as jax_quantize_activations
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models.model import build as jax_build
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
from repro_torch.core.mvu import quantized_linear
from repro_torch.core.quantize import QTensor, quantize_activations
from repro_torch.launch.serve import Request, prompt_batch, serve_loop
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import build

MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(backend="dense", dtype="float32", **kw):
    """(JAX config, port config) of the reduced Yi-9B."""
    kw = dict(dtype=dtype, remat=False, linear_backend=backend, **kw)
    return jax_reduced("yi-9b").replace(**kw), get_reduced("yi-9b").replace(**kw)


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (integers as they are)."""
    if isinstance(a, torch.Tensor):
        a = a.to(torch.float32) if a.is_floating_point() else a
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _pair(arr: np.ndarray, dtype="float32"):
    """One numpy array as a JAX array and a tensor of the same values in
    ``dtype``."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


def _trees(cfg, backend="dense", dtype="float32", seed=0):
    """The JAX and the port's parameter trees of ``lm_numpy_params(cfg,
    seed)`` in ``dtype``, quantized by each package under an ``mvu_*``
    backend."""
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), lm_numpy_params(cfg, seed))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    if backend in MVU:
        jp, tp = JL.quantize_model_params(jp, backend), TL.quantize_model_params(tp, backend)
    return jp, tp


def _runs(backend, dtype, *, steps=3, max_len=32, op_by_op=False, seed=0, **cfg_kw):
    """Logits of prefill + ``steps`` greedy decode steps on each package
    (the JAX package compiled, or op by op), both fed the JAX package's
    greedy tokens; returns (jax logits, port logits, jax tokens, port
    tokens), logits stacked (1 + steps, B, V) in float32, each side's
    tokens its own argmax."""
    jcfg, tcfg = _cfg(backend, dtype, **cfg_kw)
    jp, tp = _trees(tcfg, backend, dtype, seed)
    jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    out = {"j": [], "t": [], "jt": [], "tt": []}
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        js, ts = jm.init_decode_state(2, max_len), tm.init_decode_state(2, max_len)
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


def _within_float32_contract(jl, tl, jt, tt):
    bound = G.LOGIT_ATOL * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound, (np.abs(tl - jl).max(), bound)
    np.testing.assert_array_equal(tt, jt)


def _within_bf16_bounds(jl, tl):
    corr = np.corrcoef(jl.ravel(), tl.ravel())[0, 1]
    assert corr >= 0.999, corr
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max(), np.abs(tl - jl).max()


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("bits", [8, 4, 1])
def test_quantize_activations_equal_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(0.3, 1.0, (6, 40)).astype(np.float32)
    for scale in (np.float32(0.05), rng.uniform(0.01, 0.2, (40,)).astype(np.float32)):
        want = np.asarray(jax_quantize_activations(jnp.asarray(x), bits, jnp.asarray(scale)))
        got = quantize_activations(torch.from_numpy(x), bits, torch.from_numpy(np.array(scale)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", MVU)
def test_quantize_linear_params_equal_jax(backend, dtype):
    jw, tw = _pair(np.random.default_rng(3).normal(0, 0.2, (48, 40)), dtype)
    want = JL.quantize_linear_params({"w": jw}, backend)
    got = TL.quantize_linear_params({"w": tw}, backend)
    assert got["values"].dtype == torch.int8 and got["values"].is_contiguous()
    np.testing.assert_array_equal(got["values"].numpy(),
                                  np.asarray(want["values"]).astype(np.int8))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", MVU)
def test_quantize_model_params_equal_jax(backend, dtype):
    """Every leaf of the quantized reduced tree (layer-stacked projections,
    untouched norms and embeddings) equals JAX's; the JAX package's int4
    values arrive as int8 through ``lm_params_from_numpy``."""
    _, tcfg = _cfg(backend, dtype)
    jp, tp = _trees(tcfg, backend, dtype)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert set(tp["layers"]["attn"]["wq"]) == {"values", "scale"}
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(tp)[0]):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


# ------------------------------------------------------------ quantized_linear
@pytest.mark.parametrize("lead", [(24,), (2, 3, 5)])
@pytest.mark.parametrize("w_bits,a_bits", [(8, 8), (4, 8), (4, 4), (1, 8)])
def test_quantized_linear_equal_jax(w_bits, a_bits, lead):
    """Both arms (standard on ``mvu_int``, 1-bit on ``mvu_binary``) on
    random float32 inputs: equal to JAX's ``backend="xla"`` bit for bit."""
    rng = np.random.default_rng(10 * w_bits + a_bits)
    x = rng.normal(0, 1.5, (*lead, 72)).astype(np.float32)
    w = rng.normal(0, 0.3, (72, 40)).astype(np.float32)
    backend = {(8, 8): "mvu_w8a8", (4, 8): "mvu_w4a8", (4, 4): "mvu_w4a4",
               (1, 8): "mvu_binary"}[(w_bits, a_bits)]
    jq = JL.quantize_linear_params({"w": jnp.asarray(w)}, backend)
    tq = TL.quantize_linear_params({"w": torch.from_numpy(w)}, backend)
    want = jax_quantized_linear(jnp.asarray(x), JQTensor(jq["values"].astype(jnp.int8),
                                                         jq["scale"], w_bits, True),
                                act_bits=a_bits, backend="xla")
    got = quantized_linear(torch.from_numpy(x), QTensor(tq["values"], tq["scale"], w_bits, True),
                           act_bits=a_bits)
    assert got.dtype == torch.float32 and got.shape == (*lead, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same through linear's integer arm
    np.testing.assert_array_equal(TL.linear(tq, torch.from_numpy(x), backend=backend).numpy(),
                                  np.asarray(JL.linear(jq, jnp.asarray(x), backend=backend)))


def test_linear_dense_and_the_training_arm():
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.normal(size=(3, 7, 32)))
    jw, tw = _pair(rng.normal(size=(32, 24)))
    np.testing.assert_allclose(TL.linear({"w": tw}, tx).numpy(),
                               np.asarray(JL.linear({"w": jw}, jx)), rtol=ATOL, atol=ATOL)
    # integer params under a backend that is not mvu_* run at 8 bits, as in JAX
    jq, tq = JL.quantize_linear_params({"w": jw}, "mvu_w8a8"), TL.quantize_linear_params(
        {"w": tw}, "mvu_w8a8")
    np.testing.assert_array_equal(TL.linear(tq, tx).numpy(), np.asarray(JL.linear(jq, jx)))
    # float params under an mvu_* backend: the fake-quant training arm, as in JAX
    for backend in MVU:
        np.testing.assert_allclose(TL.linear({"w": tw}, tx, backend=backend).numpy(),
                                   np.asarray(JL.linear({"w": jw}, jx, backend=backend)),
                                   rtol=ATOL, atol=ATOL)


# ------------------------------------------------------------ layers
def test_norms_equal_jax():
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.normal(1.0, 2.0, (2, 5, 64)))
    js, ts = _pair(rng.normal(1.0, 0.3, (64,)))
    jb, tb = _pair(rng.normal(0.0, 0.3, (64,)))
    np.testing.assert_allclose(TL.rmsnorm({"scale": ts}, tx).numpy(),
                               np.asarray(JL.rmsnorm({"scale": js}, jx)), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(TL.layernorm({"scale": ts, "bias": tb}, tx, 1e-6).numpy(),
                               np.asarray(JL.layernorm({"scale": js, "bias": jb}, jx, 1e-6)),
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("theta,rot_dim", [(5e6, None), (1e4, None), (1e4, 8)])
def test_apply_rope_equal_jax(theta, rot_dim):
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.normal(size=(2, 9, 4, 16)))
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_rope(tx, torch.from_numpy(pos), theta, rot_dim).numpy(),
        np.asarray(JL.apply_rope(jx, jnp.asarray(pos), theta, rot_dim)), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_activation_equal_jax(name):
    rng = np.random.default_rng(8)
    jg, tg = _pair(rng.normal(0, 2, (3, 50)))
    ju, tu = _pair(rng.normal(0, 2, (3, 50)))
    gated = TL.is_gated(name)
    assert gated == JL.is_gated(name)
    np.testing.assert_allclose(
        TL.activation(name, tg, tu if gated else None).numpy(),
        np.asarray(JL.activation(name, jg, ju if gated else None)), rtol=ATOL, atol=ATOL)


def test_swiglu_equals_jax_in_bfloat16():
    """``jax.nn.silu`` rounds each op of its logistic to bfloat16; so does
    the port's ``silu``, bit for bit."""
    jg, tg = _pair(np.random.default_rng(9).normal(0, 3, (64, 128)), "bfloat16")
    ju, tu = _pair(np.random.default_rng(10).normal(0, 3, (64, 128)), "bfloat16")
    np.testing.assert_array_equal(_np(TL.activation("swiglu", tg, tu)),
                                  _np(JL.activation("swiglu", jg, ju)))


def _attn_params(tcfg, seed):
    """The same float32 attention params on both sides (wq wk wv wo, and
    random qk-norm scales)."""
    layer = lm_numpy_params(tcfg, seed)["layers"]["attn"]
    rng = np.random.default_rng(seed)
    if tcfg.qk_norm:
        for n in ("qnorm", "knorm"):
            layer[n] = {"scale": rng.normal(1, 0.2, (1, tcfg.head_dim)).astype(np.float32)}
    one = jax.tree.map(lambda a: a[0], layer)
    return jax.tree.map(jnp.asarray, one), lm_params_from_numpy(one)


@pytest.mark.parametrize("case", ["causal", "window", "chunked", "qk_norm", "bidirectional"])
def test_attention_equal_jax(case):
    kw = {"window": {"attn_type": "swa", "window": 5}, "chunked": {"attn_q_chunk": 4},
          "qk_norm": {"qk_norm": True}}.get(case, {})
    jcfg, tcfg = _cfg(**kw)
    jp, tp = _attn_params(tcfg, 11)
    jx, tx = _pair(np.random.default_rng(12).normal(size=(2, 12, tcfg.d_model)))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    causal = case != "bidirectional"
    np.testing.assert_allclose(
        TA.attention(tp, tcfg, tx, torch.from_numpy(pos), causal=causal).numpy(),
        np.asarray(JA.attention(jp, jcfg, jx, jnp.asarray(pos), causal=causal)),
        rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_ffn_equal_jax(backend):
    jcfg, tcfg = _cfg(backend)
    jl, tl = _trees(tcfg, backend)
    jf = jax.tree.map(lambda a: a[0], jl["layers"]["ffn"])
    tf = TT.layer(tl["layers"]["ffn"], 0)
    jx, tx = _pair(np.random.default_rng(13).normal(size=(2, 7, tcfg.d_model)))
    np.testing.assert_allclose(TT.ffn(tf, tcfg, tx, backend=backend).numpy(),
                               np.asarray(JT.ffn(jf, jcfg, jx, backend=backend)),
                               rtol=ATOL, atol=ATOL)


def test_quant_kv_equal_jax():
    jx, tx = _pair(np.random.default_rng(14).normal(0, 2, (2, 12, 2, 16)))
    jq, js = JA._quant_kv(jx)
    tq, ts = TA._quant_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(TA._dequant_kv(tq, ts, torch.float32).numpy(),
                               np.asarray(JA._dequant_kv(jq, js, jnp.float32)),
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_stack_forward_equal_jax(backend):
    """The uncached forward of the stacked layers (the reference's training
    forward; serving takes the prefill below)."""
    jcfg, tcfg = _cfg(backend)
    jp, tp = _trees(tcfg, backend)
    jx, tx = _pair(np.random.default_rng(16).normal(size=(2, 12, tcfg.d_model)))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jy, jaux = JT.stack_forward(jp["layers"], jcfg, jx, jnp.asarray(pos))
    ty, taux = TT.stack_forward(tp["layers"], tcfg, tx, torch.from_numpy(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ATOL, atol=ATOL)
    assert float(taux) == float(jaux) == 0.0


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("backend", ["dense", *MVU])
def test_prefill_decode_float32_equal_jax(backend):
    _within_float32_contract(*_runs(backend, "float32"))


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_kv_quant_decode_equal_jax(backend):
    _within_float32_contract(*_runs(backend, "float32", kv_quant=True))


def test_decode_past_max_len_clamps_the_cache_write_like_jax():
    """Decoding past ``max_len`` writes the last cache slot, as XLA clamps a
    ``dynamic_update_slice`` start."""
    _within_float32_contract(*_runs("mvu_w8a8", "float32", steps=4, max_len=14))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_prefill_decode_bfloat16_within_bounds_of_jax_op_by_op(backend, seed):
    _within_bf16_bounds(*_runs(backend, "bfloat16", op_by_op=True, seed=seed)[:2])


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_kv_quant_decode_bfloat16_within_bounds_of_jax_op_by_op(backend):
    _within_bf16_bounds(*_runs(backend, "bfloat16", op_by_op=True, kv_quant=True)[:2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_decode_bfloat16_dense_within_bounds_of_compiled_jax(seed):
    _within_bf16_bounds(*_runs("dense", "bfloat16", seed=seed)[:2])


def test_golden_run_on_the_cpu():
    """The committed golden run (the JAX package's, ``scripts/lm_golden.py``)
    holds for the port on the CPU, as ``chip_smoke.py`` holds it on the card."""
    golden = G.load_golden()
    assert golden["variants"].keys() == set(G.VARIANTS)
    for backend in G.VARIANTS:
        cfg = G.golden_config(backend)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
        if backend != "dense":
            params = TL.quantize_model_params(params, backend)
        got = G.greedy_run(build(cfg, device="cpu"), params)
        assert G.mismatch(golden["variants"][backend], got) is None, backend


# ------------------------------------------------------------ serve_loop
@pytest.mark.parametrize("max_new", [(4, 4, 4), (4, 2, 3)])
def test_serve_loop_equal_jax(max_new):
    """Three requests at batch 2 (the second group padded), max_len 32: the
    same token lists, rids and order as the JAX package's ``serve_loop``."""
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
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(max_new)
    assert all(r.t_done > 0 for r in got)
    np.testing.assert_array_equal(prompt_batch(got[:2]), np.stack(
        [np.pad(prompts[0], (0, 4)), prompts[1]]))


# ------------------------------------------------------------ the reference's claims
def _port_model(backend="dense", **kw):
    cfg = get_reduced("yi-9b").replace(dtype="float32", remat=False, linear_backend=backend, **kw)
    return build(cfg, device="cpu")


def test_w8a8_serving_matches_dense_argmax_on_the_port():
    """``tests/test_quantized_serving.py::test_w8a8_serving_matches_dense_argmax``
    on the port, from the port's own ``init``."""
    md, mq = _port_model(), _port_model("mvu_w8a8")
    params = md.init(torch.Generator().manual_seed(0))
    qparams = TL.quantize_model_params(params, "mvu_w8a8")
    toks = torch.randint(0, md.cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    ld, _ = md.prefill(params, {"tokens": toks}, md.init_decode_state(2, 32))
    lq, sq = mq.prefill(qparams, {"tokens": toks}, mq.init_decode_state(2, 32))
    assert bool(torch.isfinite(lq).all())
    corr = np.corrcoef(ld.numpy().ravel(), lq.numpy().ravel())[0, 1]
    assert corr > 0.98, corr
    for _ in range(3):
        lq, sq = mq.decode_step(qparams, sq, torch.argmax(lq, -1))
    assert lq.shape == (2, md.cfg.vocab_size)


def test_quantized_weight_bytes_shrink_on_the_port():
    m = build(get_reduced("yi-9b"), device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    q = TL.quantize_model_params(params, "mvu_w8a8")

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in jax.tree.leaves(t))

    dense = nbytes(params["layers"]["attn"]) + nbytes(params["layers"]["ffn"])
    assert nbytes(q["layers"]["attn"]) + nbytes(q["layers"]["ffn"]) < 0.6 * dense


def test_int8_kv_cache_decode_consistency_on_the_port():
    m, mq = _port_model(), _port_model(kv_quant=True)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, m.cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    s1, s2 = m.init_decode_state(2, 32), mq.init_decode_state(2, 32)
    assert s2["caches"]["k"].dtype == torch.int8
    l1, s1 = m.prefill(params, {"tokens": toks}, s1)
    l2, s2 = mq.prefill(params, {"tokens": toks}, s2)
    for _ in range(4):
        l1, s1 = m.decode_step(params, s1, torch.argmax(l1, -1))
        l2, s2 = mq.decode_step(params, s2, torch.argmax(l2, -1))
    corr = np.corrcoef(l1.numpy().ravel(), l2.numpy().ravel())[0, 1]
    assert corr > 0.99, corr
    assert torch.equal(torch.argmax(l1, -1), torch.argmax(l2, -1))


# ------------------------------------------------------------ the port's boundaries
def test_init_follows_the_reference_layout():
    """``init`` draws the tree ``lm_numpy_params`` describes: the same keys,
    shapes and dtype; projections scaled by 1 / sqrt(fan_in)."""
    cfg = get_reduced("yi-9b").replace(dtype="bfloat16")
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    want = lm_numpy_params(cfg, 0)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat] == [p for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for (path, t), w in zip(flat, jax.tree.leaves(want)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape, path
    w_down = params["layers"]["ffn"]["w_down"]["w"].float()
    assert abs(float(w_down.std()) * np.sqrt(cfg.d_ff) - 1) < 0.05


@pytest.mark.parametrize("arch,tied", [("yi-9b", False), ("command-r-plus-104b", True)])
@pytest.mark.parametrize("backend", MVU)
def test_init_quantized_as_drawn_equals_quantizing_the_float_init(backend, arch, tied):
    """``init(g, quantize=backend)`` quantizes each layer as it is drawn and
    gives ``quantize_model_params(init(g), backend)`` leaf for leaf, the
    final norm and the embeddings included (Command R+: LayerNorm; here
    with tied embeddings)."""
    cfg = get_reduced(arch).replace(dtype="bfloat16", tie_embeddings=tied)
    m = build(cfg, device="cpu")
    got = m.init(torch.Generator().manual_seed(3), quantize=backend)
    want = TL.quantize_model_params(m.init(torch.Generator().manual_seed(3)), backend)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat] == [p for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for (path, g), w in zip(flat, jax.tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), path


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_writes_the_stacked_cache_in_place(kv_quant):
    """Prefill and decode write each layer's slice of the one stacked cache
    that ``init_decode_state`` allocated, and copy it nowhere."""
    cfg = get_reduced("yi-9b").replace(dtype="float32", kv_quant=kv_quant,
                                       linear_backend="mvu_w8a8")
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0), quantize="mvu_w8a8")
    state = m.init_decode_state(2, 16)
    bufs = {k: v.data_ptr() for k, v in state["caches"].items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5)))
    logits, s1 = m.prefill(params, {"tokens": toks}, state)
    logits, s2 = m.decode_step(params, s1, torch.argmax(logits, -1))
    for s in (s1, s2):
        assert s["caches"] is state["caches"]
    caches = state["caches"]
    assert {k: v.data_ptr() for k, v in caches.items()} == bufs
    k = caches["k"]
    assert k.shape[:3] == (cfg.num_layers, 2, 16)
    written = k.abs().sum(dim=(1, 3, 4)) > 0  # (L, T): rows 0..5 written, the rest zero
    assert written[:, :6].all() and not written[:, 6:].any()


@pytest.mark.parametrize("arch", [*ARCH_IDS, "unknown-family"])
def test_non_dense_families_raise(arch):
    """Every family of the ten architectures is ported: ``build`` and
    ``lm_numpy_params`` succeed for each reduced config (their losses:
    ``tests/test_torch_lm_qat.py``).  A config of a family the port does
    not know still raises in both, naming the families it runs."""
    if arch == "unknown-family":
        cfg = get_reduced("yi-9b").replace(name="unknown", family="speech")
        for fn in (lambda: build(cfg, device="cpu"), lambda: lm_numpy_params(cfg, 0),
                   lambda: TT.require_ported(cfg)):
            with pytest.raises(NotImplementedError, match="'speech' family is not ported"):
                fn()
        return
    cfg = get_reduced(arch)
    TT.require_ported(cfg)
    assert build(cfg, device="cpu").cfg is cfg
    tree = lm_numpy_params(cfg, 0)
    assert ("encdec" in tree) == cfg.encdec and ("layers" in tree) != cfg.encdec


def test_loss_and_the_device_default():
    m = build(get_reduced("yi-9b"), device="cpu")
    assert m.device == torch.device("cpu")
    # the training loss of the float32 reduced model, as JAX's
    jcfg, tcfg = _cfg()
    jp, tp = _trees(tcfg)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    (jl, jaux), (tl, taux) = (jax_build(jcfg).loss(jp, {"tokens": jnp.asarray(toks)}),
                              build(tcfg, device="cpu").loss(tp, {"tokens": toks}))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(taux["ce"]) == float(tl) and float(taux["aux"]) == float(jaux["aux"]) == 0.0
    if torch.cuda.is_available():
        assert build(get_reduced("yi-9b")).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(get_reduced("yi-9b"))


def test_every_dense_config_serves_like_jax():
    """The other dense architectures (LayerNorm, squared ReLU, sliding
    window) through prefill and decode under W8A8, float32, against JAX."""
    for arch in ("command-r-plus-104b", "nemotron-4-15b", "h2o-danube-1.8b"):
        kw = dict(dtype="float32", remat=False, linear_backend="mvu_w8a8", window=6)
        jcfg, tcfg = jax_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)
        jp, tp = _trees(tcfg, "mvu_w8a8")
        toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32)
        jm, tm = jax_build(jcfg), build(tcfg, device="cpu")
        jl, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_decode_state(2, 16))
        tl, ts = tm.prefill(tp, {"tokens": toks}, tm.init_decode_state(2, 16))
        jls, tls = [_np(jl)], [_np(tl)]
        for _ in range(2):
            nxt = torch.argmax(tl, -1)
            jl, js = jm.decode_step(jp, js, jnp.asarray(nxt.numpy()))
            tl, ts = tm.decode_step(tp, ts, nxt)
            jls.append(_np(jl))
            tls.append(_np(tl))
        jl, tl = np.stack(jls), np.stack(tls)
        assert np.abs(tl - jl).max() <= G.LOGIT_ATOL * np.abs(jl).max(), arch
