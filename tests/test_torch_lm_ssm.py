"""The port's SSM decoder (the SSM arms of ``models/transformer.py``,
``models/model.py``'s ``build`` / ``loss``, ``convert.py``'s SSM tree and
``launch/serve.py::serve_loop``) against the JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced mamba2-780m (2 layers, d = 64, 8 heads of 16,
state 16, chunk 16, vocab 256).  The contract, fixed before the port was
written:

* a float32 ``prefill`` and three greedy ``decode_step``s under dense and
  every ``mvu_*`` backend (every SSM projection on ``linear``'s fake-quant
  arm, as in the reference: none is in ``PROJ_NAMES``): logits within
  1e-3 of the largest reference logit, greedy tokens equal; ``serve_loop``
  on right-padded prompts returns the same token lists; the committed
  golden (``configs/mamba2_780m_lm_golden.json``) holds on the CPU;
* a prompt prefilled and the rest decoded give the logits of one prefill
  of the whole sequence (the reference's
  ``test_prefill_decode_matches_forward`` and its tolerance, rtol = atol =
  2e-2, argmax equal), across a chunk edge too, and that prefill the JAX
  package's within 1e-3 of the largest logit;
* ``Model.loss`` (aux 0) under dense, W8A8 and binary in float32, remat
  on, over three chunks: loss within 1e-5 of the reference, every
  gradient leaf within 1e-4 of its largest ``jax.value_and_grad``
  magnitude (1.4e-6 seen), the dense family's bounds;
* in bfloat16, prefill and decode logits correlation >= 0.999 and max
  |delta| <= 2e-2 of the largest logit against the JAX package run op by
  op (``jax.disable_jit()``), ``A_log`` / ``D`` / ``dt_bias`` float32;
* ``quantize_model_params``, ``with_column_scales`` and
  ``init(quantize=...)`` leave every SSM leaf float;
* ``lm_numpy_params`` draws the reference's layout leaf for leaf and
  ``cast_numpy_params`` keeps the reference's float32 leaves;
* a prompt shorter than the conv tail raises ``ValueError``.
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
    keeps_float32,
    lm_numpy_params,
    lm_params_from_numpy,
    numpy_tree,
)
from repro_torch.launch.serve import Request, serve_loop
from repro_torch.models import layers as TL
from repro_torch.models.model import build
from repro_torch.tree import flat_leaves

ARCH = G.SSM_ARCH
MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")
SSM_FLOAT32 = ("A_log", "D", "dt_bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(backend="dense", dtype="float32", **kw):
    """(JAX config, port config) of the reduced mamba2."""
    kw = dict(dtype=dtype, remat=False, linear_backend=backend, **kw)
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
    ``dtype`` (``A_log`` / ``D`` / ``dt_bias`` float32), quantized by each
    package under an ``mvu_*`` backend."""
    tree = cast_numpy_params(lm_numpy_params(cfg, seed), jnp.dtype(dtype))
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    if backend in MVU:
        jp, tp = JL.quantize_model_params(jp, backend), TL.quantize_model_params(tp, backend)
    return jp, tp


def _runs(backend, dtype, *, steps=3, op_by_op=False, seed=0):
    """Logits of prefill + ``steps`` greedy decode steps on each package,
    both fed the JAX package's greedy tokens: (jax logits, port logits,
    jax tokens, port tokens), logits stacked (1 + steps, B, V) in float32."""
    jcfg, tcfg = _cfg(backend, dtype)
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
def test_prefill_decode_float32_equal_jax(backend):
    jl, tl, jt, tt = _runs(backend, "float32")
    bound = G.LOGIT_ATOL * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound, (np.abs(tl - jl).max(), bound)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_prefill_decode_bfloat16_within_bounds_of_jax_op_by_op(backend, seed):
    jl, tl, _, _ = _runs(backend, "bfloat16", op_by_op=True, seed=seed)
    corr = np.corrcoef(jl.ravel(), tl.ravel())[0, 1]
    assert corr >= 0.999, corr
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max(), np.abs(tl - jl).max()


@pytest.mark.parametrize("backend", G.VARIANTS)
def test_golden_run_on_the_cpu(backend):
    """The committed JAX golden run; it records no dropped assignments (no
    MoE block), and a changed token fails it."""
    want = G.load_golden(ARCH)["variants"][backend]
    assert "dropped" not in want
    cfg = G.golden_config(backend, ARCH)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = TL.quantize_model_params(params, backend)
    got = G.greedy_run(build(cfg, device="cpu"), params)
    assert G.mismatch(want, got) is None, G.mismatch(want, got)
    bad = np.array(got["tokens"])
    bad[0, -1] += 1
    assert "greedy tokens" in G.mismatch(want, {**got, "tokens": bad})


@pytest.mark.parametrize("s_prompt,s_total", [(8, 12), (3, 12), (20, 36)])
def test_prefill_then_decode_equals_the_full_prefill(s_prompt, s_total):
    """The reference's ``test_prefill_decode_matches_forward`` for mamba2
    (dense, float32): a prompt prefilled (the shortest the conv tail
    allows, and one past the first chunk) and the rest decoded give the
    full prefill's logits, which equal the JAX package's."""
    jcfg, tcfg = _cfg()
    jp, tp = _trees(tcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, s_total)).astype(np.int32)
    m = build(tcfg, device="cpu")
    full, _ = m.prefill(tp, {"tokens": toks}, m.init_decode_state(2, 64))
    logits, state = m.prefill(tp, {"tokens": toks[:, :s_prompt]}, m.init_decode_state(2, 64))
    for t in range(s_prompt, s_total):
        logits, state = m.decode_step(tp, state, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(full.numpy(), -1))
    assert int(state["pos"][0, 0]) == s_total
    jm = jax_build(jcfg)
    jfull, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_decode_state(2, 64))
    ref = np.asarray(jfull)
    assert np.abs(full.numpy() - ref).max() <= G.LOGIT_ATOL * np.abs(ref).max()


@pytest.mark.parametrize("max_new", [(4, 4, 4), (4, 2, 3)])
def test_serve_loop_equal_jax(max_new):
    """Right-padded prompts of three lengths in groups of 2 (the last padded
    with a copy): the pad tokens run through the SSM state in both
    packages."""
    jcfg, tcfg = _cfg("mvu_w8a8")
    jp, tp = _trees(tcfg, "mvu_w8a8")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (9, 5, 20)]
    jdone = jax_serve_loop(jax_build(jcfg), jp, [JRequest(i, p, n) for i, (p, n) in
                                                 enumerate(zip(prompts, max_new))],
                           batch=2, max_len=32)
    tdone = serve_loop(build(tcfg, device="cpu"), tp,
                       [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))],
                       batch=2, max_len=32)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [[int(t) for t in r.out] for r in jdone]


def test_prefill_and_decode_write_the_caches_in_place():
    """``init_decode_state``'s stacked caches: conv tails in the model's
    dtype, the state float32 (L, B, H, P, N); prefill and decode write the
    same buffers, and each layer's tails are its conv inputs' last rows."""
    cfg = get_reduced(ARCH).replace(dtype="float32", remat=False)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    state = m.init_decode_state(2, 16)
    caches = state["caches"]
    assert caches["state"].shape == (cfg.num_layers, 2, 8, 16, 16)
    assert caches["state"].dtype == torch.float32 and caches["conv_x"].shape == (2, 2, 3, 128)
    bufs = {k: v.data_ptr() for k, v in caches.items()}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    logits, s1 = m.prefill(params, {"tokens": toks}, state)
    after_prefill = {k: v.clone() for k, v in caches.items()}
    assert all(bool(v.abs().sum() > 0) for v in after_prefill.values())
    logits, s2 = m.decode_step(params, s1, torch.argmax(logits, -1))
    for s in (s1, s2):
        assert s["caches"] is caches
    assert {k: v.data_ptr() for k, v in caches.items()} == bufs
    # the window slid by one: the prefill's last two rows are now the first two
    assert torch.equal(caches["conv_B"][:, :, :2], after_prefill["conv_B"][:, :, 1:])
    assert not torch.equal(caches["state"], after_prefill["state"])


def test_a_prompt_shorter_than_the_conv_tail_raises():
    cfg = get_reduced(ARCH).replace(dtype="float32")
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shorter than the conv tail of 3"):
        m.prefill(params, {"tokens": np.zeros((2, 2), np.int32)}, m.init_decode_state(2, 16))
    m.prefill(params, {"tokens": np.zeros((2, 3), np.int32)}, m.init_decode_state(2, 16))


# ------------------------------------------------------------ Model.loss
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_loss_and_gradients_float32_equal_jax(backend, seed):
    """``ce`` (aux 0) and every gradient, remat on, over 40 tokens (three
    chunks of 16), every projection on the fake-quant arm under an
    ``mvu_*`` backend."""
    jcfg, tcfg = _cfg(backend)
    jcfg, tcfg = jcfg.replace(remat=True), tcfg.replace(remat=True)
    tree = lm_numpy_params(tcfg, seed)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (2, 41)).astype(np.int32)
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    leaves = flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, taux = build(tcfg, device="cpu").loss(tp, {"tokens": toks})
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    assert abs(tl.item() - float(jl)) <= G.LOSS_RTOL * abs(float(jl)), (tl.item(), float(jl))
    assert taux["aux"].item() == float(jaux["aux"]) == 0.0 and taux["ce"].item() == tl.item()
    jg = flat_leaves(jg)
    assert grads.keys() == jg.keys()
    for path, g in jg.items():
        want = _np(g)
        assert grads[path].dtype == torch.float32 and tuple(grads[path].shape) == want.shape
        err = np.abs(_np(grads[path]) - want).max()
        assert err <= G.GRAD_ATOL * np.abs(want).max(), (path, err, np.abs(want).max())


def test_build_runs_prefill_decode_and_loss_at_the_reduced_config():
    """``build(get_reduced("mamba2-780m"), device="cpu")`` as configured
    (bfloat16, remat on): params from ``init``, a prefill, a decode step
    and the loss with its gradients, all finite."""
    cfg = get_reduced(ARCH)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    ssm = params["layers"]["ssm"]
    assert all(ssm[k].dtype == torch.float32 for k in SSM_FLOAT32)
    assert ssm["w_x"]["w"].dtype == torch.bfloat16 and set(params["layers"]) == {"ln1", "ssm"}
    assert torch.equal(ssm["conv_B"]["w"], ssm["conv_C"]["w"])
    assert "unembed" not in params
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    logits, state = m.prefill(params, {"tokens": toks[:, :8]}, m.init_decode_state(2, 16))
    logits, state = m.decode_step(params, state, torch.argmax(logits, -1))
    assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = m.loss(params, {"tokens": toks})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert bool(torch.isfinite(loss)) and aux["aux"].item() == 0.0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------------------------ params
@pytest.mark.parametrize("backend", MVU)
def test_quantize_model_params_leaves_every_ssm_leaf_float(backend):
    """The reference's walk quantizes only ``PROJ_NAMES``: every leaf of the
    quantized tree equals the JAX package's, and equals the float tree."""
    _, tcfg = _cfg(backend)
    jp, tp = _trees(tcfg, backend)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    _, float_tree = _trees(tcfg)
    assert flat_leaves(tp).keys() == flat_leaves(want).keys() == flat_leaves(float_tree).keys()
    for path, w in flat_leaves(want).items():
        g = flat_leaves(tp)[path]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), path
        assert torch.equal(g, flat_leaves(float_tree)[path]), path
    assert not any(p.endswith("/values") for p in flat_leaves(tp))


def test_with_column_scales_and_init_quantize_leave_the_ssm_float():
    cfg = get_reduced(ARCH).replace(linear_backend="mvu_w8a8")
    m = build(cfg, device="cpu")
    drawn = m.init(torch.Generator().manual_seed(3), quantize="mvu_w8a8")
    want = m.init(torch.Generator().manual_seed(3))
    assert flat_leaves(drawn).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        assert torch.equal(flat_leaves(drawn)[path], w), path
    scaled = TL.with_column_scales(want["layers"], "mvu_binary")
    assert flat_leaves(scaled).keys() == flat_leaves(want["layers"]).keys()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_tree_is_the_reference_layout(dtype):
    """``lm_numpy_params`` draws the shapes of the JAX package's own
    ``init`` (no ``ln2``, no ``unembed``), ``conv_C`` equal to ``conv_B``
    and ``A_log`` / ``D`` / ``dt_bias`` at the reference's init values;
    ``cast_numpy_params`` gives each leaf the dtype of the JAX init's in
    ``dtype``; ``lm_params_from_numpy`` carries the dtypes across and
    ``numpy_tree`` brings the tree back."""
    jcfg, tcfg = _cfg(dtype=dtype)
    tree = lm_numpy_params(tcfg, 0)
    ref = jax_build(jcfg).init(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        cast_numpy_params(tree, jnp.dtype(dtype))) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)
    assert set(tree["layers"]) == {"ln1", "ssm"} and "unembed" not in tree
    ssm, jssm = tree["layers"]["ssm"], ref["layers"]["ssm"]
    for k in ("w", "b"):
        np.testing.assert_array_equal(ssm["conv_B"][k], ssm["conv_C"][k])
    for k in SSM_FLOAT32:
        np.testing.assert_allclose(ssm[k], np.asarray(jssm[k]), rtol=2.0 ** -23, atol=0)
    assert ssm["w_z"]["w"].shape == (tcfg.num_layers, tcfg.d_model, 128)
    tp = lm_params_from_numpy(cast_numpy_params(tree, jnp.dtype(dtype)))
    for path, t in flat_leaves(tp).items():
        assert t.dtype == (torch.float32 if keeps_float32(path) else getattr(torch, dtype)), path
    back = numpy_tree(tp)
    for path, a in flat_leaves(tree).items():
        want = a if dtype == "float32" or keeps_float32(path) else _np(
            jnp.asarray(a).astype("bfloat16"))
        np.testing.assert_array_equal(flat_leaves(back)[path], want, err_msg=path)


def test_the_float32_leaves_are_the_reference_ones():
    assert keeps_float32("layers/ssm/A_log") and keeps_float32("layers/moe/router/w")
    assert not keeps_float32("layers/ssm/w_dt/w") and not keeps_float32("layers/ssm/norm/scale")
