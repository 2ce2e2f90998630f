"""The port's QAT forward and backward of the dense LM (``core/quantize.py``'s
fake quantizers, the fake-quant arm of ``models/layers.py::linear``,
``transformer.stack_forward`` with remat and ``Model.loss``) against the JAX
package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) and the same numpy-seeded
tokens go through ``jax.value_and_grad(model.loss, has_aux=True)`` and the
port's ``loss`` with ``torch.autograd``, at the reduced Yi-9B (2 layers,
d = 64).  The contract, fixed before the port was written:

* ``fake_quant_weights`` (bits 1, 2, 4, 8, 16), ``fake_quant_activations``
  (bits 1, 2, 4) and ``binarize_bipolar``: values and the gradient of a
  weighted sum ``np.array_equal`` to JAX's in float32 and in bfloat16, the
  inputs holding exact ties (0, ``max_val``, +-1, ``w / scale`` at .5); the
  1-bit column mean at d_in = 4096 and 11008, eager and under a compiled
  ``value_and_grad`` of a remat'd scan, and computed for a layer stack at
  once (``column_scale``) as a layer at a time;
* the fake-quant ``linear``: outputs and the gradients of x and w within
  float32 rtol = atol = 1e-5;
* ``Model.loss`` under ``dense``, ``mvu_w8a8``, ``mvu_w4a4`` and
  ``mvu_binary``: float32 loss within 1e-5 of |loss| and every gradient
  leaf within 1e-4 of its largest JAX magnitude; bfloat16 loss within
  1e-2 of |loss| and every leaf's cosine >= 0.99;
* remat on and off give ``torch.equal`` gradients (and remat keeps fewer
  tensors for the backward);
* in float32 the QAT grid is the deployment grid: ``weight_grid(w, bits,
  axis=1)`` and
  its scale equal ``quantize_linear_params``'s ``values.T`` and ``scale``
  (the port's and JAX's) exactly at 8, 4 and 1 bits;
* the fake-quant prefill against the deployed one: the port's logit
  correlation within 1e-3 of JAX's, and >= 0.99 under W8A8 and binary;
* the committed QAT golden (``configs/yi_9b_qat_golden.json``) holds on the
  CPU, as ``chip_smoke.py`` holds it on the card; the unported families raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quantize as JQ
import repro.models.layers as JL
from repro.configs import get_reduced as jax_reduced
from repro.models.model import build as jax_build
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
from repro_torch.core import quantize as TQ
from repro_torch.models import layers as TL
from repro_torch.models.model import build
from repro_torch.tree import flat_leaves

QAT = ("dense", "mvu_w8a8", "mvu_w4a4", "mvu_binary")
DTYPES = ("float32", "bfloat16")
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pair(arr: np.ndarray, dtype="float32"):
    """One numpy array as a JAX array and a tensor of the same values in
    ``dtype``."""
    j = jnp.asarray(arr).astype(dtype)
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


def _same_values_and_grads(jax_fn, port_fn, x: np.ndarray, dtype: str):
    """``fn(x)`` and the gradient of ``sum(fn(x) * c)`` for a seeded ``c``,
    JAX against the port, both ``np.array_equal``."""
    jx, tx = _pair(x, dtype)
    jc, tc = _pair(np.random.default_rng(99).normal(size=x.shape), dtype)
    jy, jg = jax.value_and_grad(lambda v: jnp.sum(jax_fn(v) * jc))(jx)
    tx.requires_grad_(True)
    ty = port_fn(tx)
    (tg,) = torch.autograd.grad((ty * tc).sum(), tx)
    assert ty.dtype == tx.dtype and tg.dtype == tx.dtype
    np.testing.assert_array_equal(_np(ty), _np(jax_fn(jx)))
    np.testing.assert_array_equal(_np(tg), _np(jg))


def _tied_weight(shape, bits: int, seed: int) -> np.ndarray:
    """A (d_in, d_out) weight with exact ties: zeros in column 0 and, for
    bits > 1, columns whose largest magnitude is ``hi / 16`` (scale 1/16,
    exact in bfloat16) holding values at ``(m + .5) / 16``, so ``w / scale``
    lies on .5."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
    w[:3, 0] = 0.0
    if bits > 1:
        hi = 2 ** (bits - 1) - 1
        m = rng.integers(-hi, hi, (shape[0], 2))
        w[:, 1:3] = (m + 0.5) / 16
        w[0, 1:3] = hi / 16
    return w


# ------------------------------------------------------------ fake quantizers
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_fake_quant_weights_equal_jax(bits, dtype):
    """Per output column (``axis=1``, the LM's arm), per row (``axis=0``) and,
    above one bit, tensor-wide (``axis=None``)."""
    w = _tied_weight((48, 40), bits, bits)
    for axis in (1, 0) if bits == 1 else (1, 0, None):
        _same_values_and_grads(lambda v: JQ.fake_quant_weights(v, bits, axis=axis),
                               lambda v: TQ.fake_quant_weights(v, bits, axis=axis), w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d_in", [4096, 11008])
def test_one_bit_column_mean_equals_jax_at_yi_widths(d_in, dtype):
    """The bipolar scale ``mean|w|`` down a (d_in, d_out) weight's columns,
    at Yi-9B's d_model and d_ff: summed in XLA's order (ROADMAP queue C),
    where ``torch.mean`` differs in the last bit."""
    w = _tied_weight((d_in, 8), 1, d_in)
    _same_values_and_grads(lambda v: JQ.fake_quant_weights(v, 1, axis=1),
                           lambda v: TQ.fake_quant_weights(v, 1, axis=1), w, dtype)
    jw, tw = _pair(w, dtype)
    want = np.asarray(jnp.mean(jnp.abs(jw), axis=0, keepdims=True).astype(jnp.float32))
    np.testing.assert_array_equal(_np(TQ.weight_grid(tw, 1, axis=1)[1]), want)
    if dtype == "float32":
        assert not np.array_equal(_np(tw.abs().mean(dim=0, keepdim=True)), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d_in", [64, 4096])
def test_column_scale_of_a_stack_equals_each_layers(d_in, dtype):
    """``column_scale`` of a (L, d_in, d_out) stack, one batch, equals each
    layer's ``weight_grid(w_i, 1, axis=1)`` scale and JAX's ``jnp.mean``
    bit for bit, and ``linear`` given it (``with_column_scales``) computes
    what it computes alone; it is added only under a 1-bit backend."""
    w = np.stack([_tied_weight((d_in, 12), 1, d_in + i) for i in range(3)])
    jw, tw = _pair(w, dtype)
    scales = TQ.column_scale(tw)
    assert scales.shape == (3, 1, 12) and scales.dtype == tw.dtype
    for i in range(3):
        assert torch.equal(scales[i], TQ.weight_grid(tw[i], 1, axis=1)[1])
        want = jnp.mean(jnp.abs(jw[i]), axis=0, keepdims=True).astype(jnp.float32)
        np.testing.assert_array_equal(_np(scales[i]), np.asarray(want))
    tree = {"layers": {"ffn": {"w_up": {"w": tw}}, "ln1": {"scale": tw[:, 0]}}}
    given = TL.with_column_scales(tree, "mvu_binary")
    assert torch.equal(given["layers"]["ffn"]["w_up"]["bipolar_scale"], scales)
    assert given["layers"]["ln1"].keys() == {"scale"}
    assert TL.with_column_scales(tree, "mvu_w8a8") is tree
    x = _pair(np.random.default_rng(4).normal(size=(5, d_in)).astype(np.float32), dtype)[1]
    one = {"w": tw[1], "bipolar_scale": scales[1]}
    assert torch.equal(TL.linear(one, x, backend="mvu_binary"),
                       TL.linear({"w": tw[1]}, x, backend="mvu_binary"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d_in", [64, 4096, 11008])
def test_one_bit_scale_under_compiled_value_and_grad_equals_jax(d_in, dtype):
    """The 1-bit fake-quant weights that a compiled ``value_and_grad`` of a
    remat'd layer scan computes (as ``Model.loss`` runs them) equal the
    port's: XLA keeps its reduction order inside the compiled loss."""
    w = np.stack([_tied_weight((d_in, 16), 1, d_in + i) for i in range(2)])
    x = np.random.default_rng(1).normal(size=(3, d_in)).astype(np.float32)
    jw, tw = _pair(w, dtype)
    jx, _ = _pair(x, dtype)

    def scan_loss(ws):
        def body(h, wl):
            fq = JQ.fake_quant_weights(wl, 1, axis=1)
            return h + jnp.sum(jnp.square((jx @ fq).astype(jnp.float32))), fq
        body = jax.checkpoint(body, policy=jax.checkpoint_policies.nothing_saveable)
        return jax.lax.scan(body, jnp.zeros((), jnp.float32), ws)

    (_, fqs), _ = jax.jit(jax.value_and_grad(scan_loss, has_aux=True))(jw)
    port = torch.stack([TQ.fake_quant_weights(tw[i], 1, axis=1) for i in range(2)])
    np.testing.assert_array_equal(_np(port), _np(fqs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_val", [1.0, 3.0, 0.7])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_fake_quant_activations_equal_jax(bits, max_val, dtype):
    n = 2**bits - 1
    x = np.random.default_rng(bits).normal(0.5, 1.0, (24, 33)).astype(np.float32)
    step = max_val / n
    x[0, :8] = [0.0, max_val, -0.0, 0.5 * step, 1.5 * step, 2 * max_val, -1.0, max_val - step]
    _same_values_and_grads(lambda v: JQ.fake_quant_activations(v, bits, max_val),
                           lambda v: TQ.fake_quant_activations(v, bits, max_val), x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_binarize_bipolar_equals_jax(dtype):
    x = np.random.default_rng(5).normal(0, 1.2, (24, 33)).astype(np.float32)
    x[0, :6] = [1.0, -1.0, 0.0, -0.0, 2.0, -2.0]
    _same_values_and_grads(JQ.binarize_bipolar, TQ.binarize_bipolar, x, dtype)


def test_clip_gradient_at_a_bound_is_half_as_in_jax():
    """``jnp.clip``'s gradient at a tie is 0.5 (``torch.clamp``'s is 1): the
    port's clipped STEs give JAX's at 0, ``max_val`` and +-1."""
    x = np.array([0.0, 1.0, -1.0, 0.5, 2.0], np.float32)
    for jf, tf in ((lambda v: JQ.fake_quant_activations(v, 2, 1.0),
                    lambda v: TQ.fake_quant_activations(v, 2, 1.0)),
                   (JQ.binarize_bipolar, TQ.binarize_bipolar)):
        jg = jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        (tg,) = torch.autograd.grad(tf(tx).sum(), tx)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(TQ.fake_quant_activations(tx, 2, 1.0).sum(), tx)
    assert tg.tolist() == [0.5, 0.5, 0.0, 1.0, 0.0]


def test_ste_forward_is_x_plus_q_minus_x_as_in_jax():
    """``_ste(x, q)`` returns ``x + (q - x)``, which differs from ``q`` when
    ``q - x`` rounds: the reference's forward value, not ``q``."""
    x, q = np.float32([1.0, 3.0, 0.25]), np.float32([1e-9, 2.9999998, 0.5])
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TQ._ste(tx, torch.from_numpy(q))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(JQ._ste(jnp.asarray(x), jnp.asarray(q))))
    assert got[0].item() == 0.0 != q[0]
    (g,) = torch.autograd.grad(got.sum(), tx)
    assert g.tolist() == [1.0, 1.0, 1.0]


# ------------------------------------------------------------ linear
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary"])
def test_fake_quant_linear_equal_jax(backend):
    """Outputs and the gradients of x and w of ``linear`` on float params."""
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.normal(size=(2, 7, 64)))
    jw, tw = _pair(_tied_weight((64, 48), TL.MVU_BACKENDS.get(backend, (8, 8))[0], 6))
    jc, tc = _pair(rng.normal(size=(2, 7, 48)))
    jy, (gx, gw) = jax.value_and_grad(
        lambda x, w: jnp.sum(JL.linear({"w": w}, x, backend=backend) * jc), argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    ty = TL.linear({"w": tw}, tx, backend=backend)
    tgx, tgw = torch.autograd.grad((ty * tc).sum(), (tx, tw))
    np.testing.assert_allclose(ty.detach().numpy(),
                               np.asarray(JL.linear({"w": jw}, jx, backend=backend)),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(gx), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(gw), rtol=ATOL, atol=ATOL)


# ------------------------------------------------------------ Model.loss
def _cfg(backend="dense", dtype="float32", remat=True):
    """(JAX config, port config) of the reduced Yi-9B."""
    kw = dict(dtype=dtype, remat=remat, linear_backend=backend)
    return jax_reduced("yi-9b").replace(**kw), get_reduced("yi-9b").replace(**kw)


def _tokens(cfg, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)


def _port_loss(tcfg, tree, toks):
    """The port's (loss, aux, gradients by path) of ``loss`` on float params."""
    leaves = flat_leaves(tree)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = build(tcfg, device="cpu").loss(tree, {"tokens": toks})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, aux, dict(zip(leaves, grads))


def _losses(backend, dtype, seed=0):
    """JAX's and the port's loss, aux and gradients by path from one tree."""
    jcfg, tcfg = _cfg(backend, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), lm_numpy_params(tcfg, seed))
    tp = lm_params_from_numpy(jax.tree.map(_np, jp))
    tp = jax.tree.map(lambda t: t.to(getattr(torch, dtype)), tp)
    toks = _tokens(tcfg, seed + 1)
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    tl, taux, tg = _port_loss(tcfg, tp, toks)
    return (jl, jaux, flat_leaves(jg)), (tl, taux, tg)


@pytest.mark.parametrize("backend", QAT)
def test_loss_and_gradients_float32_equal_jax(backend):
    (jl, jaux, jg), (tl, taux, tg) = _losses(backend, "float32")
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl)), (tl.item(), float(jl))
    assert abs(taux["ce"].item() - float(jaux["ce"])) <= 1e-5 * abs(float(jaux["ce"]))
    assert taux["aux"].item() == float(jaux["aux"]) == 0.0
    assert tg.keys() == jg.keys()
    for path, g in jg.items():
        want = _np(g)
        assert tg[path].dtype == torch.float32 and tuple(tg[path].shape) == want.shape, path
        err = np.abs(_np(tg[path]) - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("backend", QAT)
def test_loss_and_gradients_bfloat16_within_bounds_of_jax(backend):
    """bfloat16 against the compiled JAX package (``value_and_grad`` runs the
    layer scan compiled, where XLA keeps float32 between some ops)."""
    (jl, _, jg), (tl, _, tg) = _losses(backend, "bfloat16")
    assert abs(tl.item() - float(jl)) <= 1e-2 * abs(float(jl)), (tl.item(), float(jl))
    for path, g in jg.items():
        want, got = _np(g).ravel(), _np(tg[path]).ravel()
        assert tg[path].dtype == torch.bfloat16, path
        cos = float(want @ got / np.linalg.norm(want) / np.linalg.norm(got))
        assert cos >= 0.99, (path, cos)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_remat_gives_equal_gradients_and_keeps_less(backend):
    """``cfg.remat`` changes what the backward keeps, not the values: the
    gradients are ``torch.equal`` on the CPU, and the forward saves fewer
    bytes for the backward (each block recomputed from its input)."""
    out = {}
    for remat in (True, False):
        _, tcfg = _cfg(backend, remat=remat)
        tree = lm_params_from_numpy(lm_numpy_params(tcfg, 0))
        leaves = flat_leaves(tree)
        for t in leaves.values():
            t.requires_grad_(True)
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = build(tcfg, device="cpu").loss(tree, {"tokens": _tokens(tcfg)})
        out[remat] = (loss, torch.autograd.grad(loss, list(leaves.values())), sum(saved))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    assert out[True][2] < out[False][2], (out[True][2], out[False][2])


# ------------------------------------------------------------ QAT -> deployment
@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_w4a4", "mvu_binary"])
def test_qat_grid_is_the_deployment_grid(backend):
    """Every projection of the float32 reduced tree: the fake-quant arm's
    grid and scale (``weight_grid(w, bits, axis=1)``) equal the deployed
    ``values.T`` and ``scale`` of ``quantize_linear_params``, the port's and
    JAX's, exactly; ``fake_quant_weights`` is ``grid * scale`` there."""
    bits = TL.MVU_BACKENDS[backend][0]
    _, tcfg = _cfg(backend)
    tree = lm_numpy_params(tcfg, 0)
    projections = {p: w for p, w in flat_leaves(tree).items()
                   if p.split("/")[-2] in TL.PROJ_NAMES}
    assert len(projections) == len(TL.PROJ_NAMES)
    for path, stack in projections.items():
        for w in stack:
            tw = torch.from_numpy(w)
            grid, scale = TQ.weight_grid(tw, bits, axis=1)
            assert grid.dtype == scale.dtype == torch.float32 and scale.shape == (1, w.shape[1])
            got = {"values": grid.T.to(torch.int8), "scale": scale.reshape(-1)}
            port = TL.quantize_linear_params({"w": tw}, backend)
            jax_q = JL.quantize_linear_params({"w": jnp.asarray(w)}, backend)
            for k in ("values", "scale"):
                assert torch.equal(got[k], port[k]), (path, k)
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(jax_q[k]).astype(got[k].numpy().dtype))
            want = TQ._ste(tw, grid * scale)
            assert torch.equal(TQ.fake_quant_weights(tw, bits, axis=1), want), path


def _prefill_corr(model, float_tree, deployed, toks) -> float:
    """Correlation of the last-token logits of the fake-quant prefill (float
    params) and of the deployed one (integer params)."""
    outs = []
    for params in (float_tree, deployed):
        logits, _ = model.prefill(params, {"tokens": toks}, model.init_decode_state(2, 32))
        outs.append(_np(logits).ravel())
    return float(np.corrcoef(*outs)[0, 1])


@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_w4a4", "mvu_binary"])
def test_fake_quant_prefill_against_deployed_matches_jax(backend):
    jcfg, tcfg = _cfg(backend)
    tree = lm_numpy_params(tcfg, 0)
    toks = _tokens(tcfg)[:, :16]
    jtree = jax.tree.map(jnp.asarray, tree)
    tp = lm_params_from_numpy(tree)
    jcorr = _prefill_corr(jax_build(jcfg), jtree, JL.quantize_model_params(jtree, backend),
                          jnp.asarray(toks))
    with torch.no_grad():
        tcorr = _prefill_corr(build(tcfg, device="cpu"), tp,
                              TL.quantize_model_params(tp, backend), toks)
    assert abs(tcorr - jcorr) <= 1e-3, (tcorr, jcorr)
    if backend != "mvu_w4a4":
        assert tcorr >= 0.99, tcorr


# ------------------------------------------------------------ golden, boundaries
def test_qat_golden_on_the_cpu():
    """The committed QAT golden (the JAX package's, ``scripts/lm_qat_golden.py``)
    holds for the port on the CPU, as ``chip_smoke.py`` holds it on the card."""
    golden = G.load_qat_golden()
    assert golden["variants"].keys() == set(G.QAT_VARIANTS)
    for backend in G.QAT_VARIANTS:
        cfg = G.qat_config(backend)
        got = G.qat_run(build(cfg, device="cpu"),
                        lm_params_from_numpy(lm_numpy_params(cfg, G.SEED)))
        assert G.qat_mismatch(golden["variants"][backend], got) is None, backend


def test_qat_mismatch_names_what_differs():
    want = G.load_qat_golden()["variants"]["mvu_w8a8"]
    assert G.qat_mismatch(want, want) is None
    off = {**want, "loss": want["loss"] * (1 + 1e-4)}
    assert "loss" in G.qat_mismatch(want, off)
    path = "layers/ffn/w_up/w"
    leaf = want["grads"][path]
    grads = {**want["grads"], path: {**leaf, "head": [leaf["head"][0], [
        v + 2e-4 * leaf["max_abs"] for v in leaf["head"][1]]]}}
    assert path in G.qat_mismatch(want, {**want, "grads": grads})


def test_qat_digest_catches_a_fault_in_one_layer():
    """A square projection's gradient transposed in layer 1 alone keeps the
    leaf's sum, norm, largest magnitude and layer 0's values, and is caught
    by layer 1's probe product (the sound bound: sqrt(row size) x eps)."""
    g = np.random.default_rng(3).normal(size=(2, 64, 64)).astype(np.float32)
    bad = g.copy()
    bad[1] = g[1].T
    path = "layers/attn/wq/w"
    want, got = G.grad_digest(1.0, {path: g}), G.grad_digest(1.0, {path: bad})
    for k in ("size", "max_abs"):
        assert got["grads"][path][k] == want["grads"][path][k]
    assert got["grads"][path]["head"][0] == want["grads"][path]["head"][0]
    assert "dot" in G.qat_mismatch(want, got) and path in G.qat_mismatch(want, got)
    assert G.qat_mismatch(want, G.grad_digest(1.0, {path: g.copy()})) is None


@pytest.mark.parametrize("arch", [*ARCH_IDS, "unknown-family"])
def test_loss_of_non_dense_families_raises(arch):
    """Every family's loss runs: float32, W8A8 fake-quant, the reduced
    config of each of the ten architectures, on seeded tokens (and the
    encoder-decoder's frame embeddings, the VLM's patch prefix), finite
    (each family's loss against the reference: ``tests/test_torch_lm.py``,
    ``test_torch_lm_moe.py``, ``test_torch_lm_ssm.py``,
    ``test_torch_lm_hybrid.py``, ``test_torch_lm_vlm.py`` and
    ``test_torch_lm_encdec.py``).  A family the port does not know raises
    at ``build``, before a loss exists."""
    if arch == "unknown-family":
        cfg = get_reduced("yi-9b").replace(name="unknown", family="speech")
        with pytest.raises(NotImplementedError, match="'speech' family is not ported"):
            build(cfg, device="cpu").loss({}, {"tokens": np.zeros((1, 3), np.int32)})
        return
    cfg = get_reduced(arch).replace(dtype="float32", linear_backend="mvu_w8a8")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)}
    if cfg.encdec:
        batch["enc_embeds"] = (rng.standard_normal((2, 12, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = (rng.standard_normal((2, 8, cfg.d_model)) * 0.1).astype(
            np.float32)
    loss, aux = build(cfg, device="cpu").loss(lm_params_from_numpy(lm_numpy_params(cfg, 0)),
                                              batch)
    assert bool(torch.isfinite(loss)) and loss.shape == () and aux["aux"].dtype == torch.float32
