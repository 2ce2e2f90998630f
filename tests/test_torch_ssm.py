"""The port's Mamba-2 SSD layer (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py``, on the CPU.

Inputs are drawn from a seed with numpy and go through both packages; a
block's params are the JAX package's ``ssm_init`` carried across by
``convert.lm_params_from_numpy``.  The contract, fixed before the port
was written:

* ``ssd_chunked`` equals the JAX package's and a float64 step recurrence
  (the port of ``tests/test_ssm.py::_naive_recurrence``) at rtol = atol =
  1e-4, the bound ``tests/test_ssm.py`` holds JAX to its own recurrence:
  the chunked form sums in another order than the steps, and the port's
  loop over chunk states in another order than XLA's associative scan;
  ``init_state`` continues a split sequence, the padded tail and S an
  exact multiple of the chunk included;
* its gradients equal ``jax.grad``'s within 1e-4 of each one's largest,
  and have no NaN at a chunk of 128 with large ``dt``, where ``exp`` of
  the unmasked upper triangle of ``_segsum`` would overflow;
* ``_segsum``, ``_causal_conv`` and ``_conv_step`` equal JAX's within 4
  float32 ulp of the largest value (1.25 ulp seen: XLA sums the cumsum
  and the conv in another order), ``softplus`` within 2 ulp of each value
  (XLA's CPU ``exp`` and ``log1p`` are 1 ulp off in some values), a
  bfloat16 conv within one bfloat16 ulp; the conv is causal;
* ``ssm_forward``, ``ssm_prefill`` (output and cache) and
  ``ssm_decode_step`` in float32 under dense and the fake-quant W8A8 arm
  within 1e-5 of the largest reference value; in bfloat16 against the JAX
  package run op by op (``jax.disable_jit()``) at correlation >= 0.999
  and max |delta| <= 2e-2 of the largest value, as the dense and MoE
  families are held;
* ``ssm_init`` draws the reference's leaves, shapes and dtypes: ``A_log``,
  ``D`` and ``dt_bias`` float32 in a bfloat16 block, ``conv_C`` equal to
  ``conv_B`` (the reference draws both from one key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import ssm as J
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ssm as T
from repro_torch.tree import flat_leaves

F32_ULP = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    """max |got - want| <= rel x max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top, (err, rel * top)


def _naive_recurrence(x, dt, a_log, b_mat, c_mat, state=None):
    """The SSD as its step recurrence in float64 (``tests/test_ssm.py``'s,
    with an initial state)."""
    a = -np.exp(np.asarray(a_log, np.float64))
    xn, dtn, bn, cn = (np.asarray(v, np.float64) for v in (x, dt, b_mat, c_mat))
    B, S, H, P = xn.shape
    G, N = bn.shape[2], bn.shape[3]
    rep = H // G
    state = np.zeros((B, H, P, N)) if state is None else np.asarray(state, np.float64)
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        da = np.exp(dtn[:, t] * a[None])
        bh = np.repeat(bn[:, t], rep, axis=1)
        ch = np.repeat(cn[:, t], rep, axis=1)
        state = state * da[..., None, None] + (
            dtn[:, t][..., None, None] * xn[:, t][..., None] * bh[:, :, None, :])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, ch)
    return ys, state


def _ssd_inputs(seed, s, groups, B=2, H=4, P=8, N=8, dt_scale=1.0):
    """numpy (x, dt softplus'd, a_log, B, C) in float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, s, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(B, s, H)).astype(np.float32) * dt_scale))
    a_log = rng.uniform(0, 1, H).astype(np.float32)
    bm = rng.normal(size=(B, s, groups, N)).astype(np.float32)
    cm = rng.normal(size=(B, s, groups, N)).astype(np.float32)
    return x, dt, a_log, bm, cm


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------ ssd_chunked
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s", [5, 16, 23, 40])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_equals_jax_and_the_recurrence(chunk, s, groups):
    """S = 16 and 40 are exact multiples of some chunks; the rest pad."""
    args = _ssd_inputs(1000 * chunk + 10 * s + groups, s, groups)
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(*args)
    y, fs = T.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk)
    jy, jfs = J.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk)
    y_ref, s_ref = _naive_recurrence(*args)
    assert y.dtype == fs.dtype == torch.float32
    for got, want in ((y, jy), (fs, jfs), (y, y_ref), (fs, s_ref)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [10, 16])
def test_ssd_init_state_continuation(split):
    """A sequence split in two (inside a chunk, and at a chunk's edge), the
    second part starting from the first's final state: the full run's
    outputs and state, and JAX's with the same ``init_state``."""
    x, dt, a_log, bm, cm = _ssd_inputs(0, 24, 1, B=1, H=2, P=4, N=8)
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(x, dt, a_log, bm, cm)
    y_full, s_full = T.ssd_chunked(tx, tdt, ta, tb, tc, chunk=8)
    cut = lambda t, sl: t[:, sl]
    y1, s1 = T.ssd_chunked(*(cut(t, slice(None, split)) for t in (tx, tdt)), ta,
                           *(cut(t, slice(None, split)) for t in (tb, tc)), chunk=8)
    rest = slice(split, None)
    y2, s2 = T.ssd_chunked(cut(tx, rest), cut(tdt, rest), ta, cut(tb, rest), cut(tc, rest),
                           chunk=8, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-4, atol=1e-4)
    jy2, js2 = J.ssd_chunked(jx[:, rest], jdt[:, rest], ja, jb[:, rest], jc[:, rest], chunk=8,
                             init_state=jnp.asarray(s1.numpy()))
    y_ref, s_ref = _naive_recurrence(x[:, rest], dt[:, rest], a_log, bm[:, rest], cm[:, rest],
                                     state=s1.numpy())
    for got, want in ((y2, jy2), (s2, js2), (y2, y_ref), (s2, s_ref)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ssd_chunked_gradients_equal_jax():
    """Gradients of a fixed projection of (y, final state) with respect to
    every input, over a padded tail and an initial state."""
    x, dt, a_log, bm, cm = _ssd_inputs(7, 21, 2)
    init = np.random.default_rng(8).normal(size=(2, 4, 8, 8)).astype(np.float32)
    wy = np.random.default_rng(9).normal(size=(2, 21, 4, 8)).astype(np.float32)
    ws = np.random.default_rng(10).normal(size=init.shape).astype(np.float32)
    args = (x, dt, a_log, bm, cm, init)

    def jloss(x, dt, a_log, bm, cm, init):
        y, st = J.ssd_chunked(x, dt, a_log, bm, cm, chunk=8, init_state=init)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    tt = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y, st = T.ssd_chunked(*tt[:5], chunk=8, init_state=tt[5])
    loss = (y * torch.from_numpy(wy)).sum() + (st * torch.from_numpy(ws)).sum()
    for got, want in zip(torch.autograd.grad(loss, tt), jg):
        _close(got, want, 1e-4)


def test_ssd_chunked_backward_has_no_nan_at_chunk_128_with_large_dt():
    """At a chunk of 128 with dt up to ~20, the cumulative log-decays span
    hundreds, so exp of _segsum's upper triangle would overflow: it is
    masked before the exp, and every gradient is finite."""
    x, dt, a_log, bm, cm = _ssd_inputs(3, 128, 1, B=1, H=2, P=4, N=4, dt_scale=20.0)
    assert dt.max() > 15
    tt = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, dt, a_log, bm, cm)]
    y, st = T.ssd_chunked(*tt, chunk=128)
    grads = torch.autograd.grad(y.sum() + st.sum(), tt)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    cs = torch.cumsum(torch.tensor(dt[0, :, 0]) * -float(np.exp(a_log[0])), 0)
    assert float((cs[0] - cs[-1]).exp()) == float("inf")  # unmasked, the exp overflows


# ------------------------------------------------------------ the parts
def test_segsum_equals_jax_and_is_masked():
    a = np.random.default_rng(4).normal(size=(2, 3, 16)).astype(np.float32)
    got, want = T._segsum(torch.from_numpy(a)), np.asarray(J._segsum(jnp.asarray(a)))
    assert got.shape == (2, 3, 16, 16)
    upper = np.triu(np.ones((16, 16), bool), k=1)
    assert (got.numpy()[..., upper] == T.NEG_INF).all() and (want[..., upper] == J.NEG_INF).all()
    _close(got, want, 4 * F32_ULP)


def test_softplus_is_logaddexp_as_jax():
    """``jax.nn.softplus`` above ``F.softplus``'s threshold of 20 too."""
    x = np.concatenate([np.linspace(-40, 40, 801), [-1e30, 1e30, 0.0]]).astype(np.float32)
    got, want = T.softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(x))
    np.testing.assert_allclose(got, want, rtol=2 * F32_ULP, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_jax(dtype):
    rng = np.random.default_rng(5)
    x, w = rng.normal(size=(2, 11, 24)), rng.normal(size=(4, 24)) * 0.5
    b = rng.normal(size=(24,)) * 0.1
    jx, jw, jb = (jnp.asarray(v, jnp.float32).astype(dtype) for v in (x, w, b))
    tx, tw, tb = (torch.from_numpy(np.asarray(v, np.float32)).to(getattr(torch, dtype))
                  for v in (x, w, b))
    got, want = T._causal_conv(tx, tw, tb), J._causal_conv(jx, jw, jb)
    assert str(got.dtype) == f"torch.{dtype}"
    # float32: sums of 4 products; bfloat16: both round one float32 value
    _close(got, want, 4 * F32_ULP if dtype == "float32" else 2.0 ** -8)


def test_causal_conv_is_causal():
    """``tests/test_ssm.py``'s check: the future does not reach the past."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 10, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    b = torch.zeros(3)
    y1 = T._causal_conv(x, w, b)
    x2 = x.clone()
    x2[:, 7:] = 99.0
    y2 = T._causal_conv(x2, w, b)
    np.testing.assert_allclose(y1[:, :7].numpy(), y2[:, :7].numpy(), rtol=1e-5)
    assert not torch.allclose(y1[:, 7:], y2[:, 7:])


def test_conv_step_equals_jax_and_the_convs_last_row():
    rng = np.random.default_rng(6)
    win, w, b = rng.normal(size=(3, 4, 20)), rng.normal(size=(4, 20)), rng.normal(size=(20,))
    args = [np.asarray(v, np.float32) for v in (win, w, b)]
    got = T._conv_step(*(torch.from_numpy(a) for a in args))
    _close(got, J._conv_step(*(jnp.asarray(a) for a in args)), 4 * F32_ULP)
    full = T._causal_conv(*(torch.from_numpy(a) for a in args))  # win as a 4-token sequence
    _close(got, full[:, -1], 4 * F32_ULP)


# ------------------------------------------------------------ the block
def _block(dtype="float32", backend="dense", seed=0):
    """(cfg, JAX params, port params) of one reduced mamba2 SSM block from
    the JAX package's ``ssm_init``, and a seeded input (B=2, S=12)."""
    cfg = get_reduced("mamba2-780m").replace(dtype=dtype, linear_backend=backend)
    jp = J.ssm_init(jax.random.PRNGKey(seed), jax_reduced("mamba2-780m"), jnp.dtype(dtype))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    x = (np.random.default_rng(seed + 1).normal(size=(2, 12, cfg.d_model)) * 0.5)
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    return cfg, jp, tp, jx, torch.from_numpy(_np(jx).copy()).to(getattr(torch, dtype))


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_ssm_forward_equals_jax(backend, chunk):
    cfg, jp, tp, jx, tx = _block(backend=backend)
    got = T.ssm_forward(tp, cfg, tx, chunk=chunk, backend=backend)
    _close(got, J.ssm_forward(jp, cfg, jx, chunk=chunk, backend=backend), 1e-5)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_ssm_prefill_and_decode_steps_equal_jax(backend):
    """The prefill's output and cache (conv tails, state), then four decode
    steps each fed that step's input: outputs and caches."""
    cfg, jp, tp, jx, tx = _block(backend=backend, seed=2)
    jy, jc = J.ssm_prefill(jp, cfg, jx[:, :8], chunk=4, backend=backend)
    ty, tc = T.ssm_prefill(tp, cfg, tx[:, :8], chunk=4, backend=backend)
    _close(ty, jy, 1e-5)
    assert tc.keys() == jc.keys() == {"conv_x", "conv_B", "conv_C", "state"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k], 1e-5)
    for t in range(8, 12):
        jy, jc = J.ssm_decode_step(jp, cfg, jx[:, t:t + 1], jc, backend=backend)
        ty, tc = T.ssm_decode_step(tp, cfg, tx[:, t:t + 1], tc, backend=backend)
        assert ty.shape == (2, 1, cfg.d_model)
        _close(ty, jy, 1e-5)
        for k in jc:
            _close(tc[k], jc[k], 1e-5)


def test_ssm_forward_vs_decode_steps():
    """``tests/test_ssm.py``'s check on the port: the full-sequence block
    equals its decode steps from an empty cache, at the reference's
    tolerance."""
    cfg, _, tp, _, tx = _block(seed=3)
    y_full = T.ssm_forward(tp, cfg, tx, chunk=4)
    cache = T.init_ssm_cache(cfg, 2, torch.float32)
    ys = []
    for t in range(tx.shape[1]):
        y, cache = T.ssm_decode_step(tp, cfg, tx[:, t:t + 1], cache)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=5e-3, atol=5e-3)


def test_ssm_bfloat16_within_bounds_of_jax_op_by_op():
    """bfloat16 params and input: prefill, its cache's conv tails (bfloat16)
    and state (float32), and two decode steps."""
    cfg, jp, tp, jx, tx = _block("bfloat16", seed=4)
    with jax.disable_jit():
        jy, jc = J.ssm_prefill(jp, cfg, jx[:, :10], chunk=4)
        jys = [jy]
        for t in (10, 11):
            jy, jc = J.ssm_decode_step(jp, cfg, jx[:, t:t + 1], jc)
            jys.append(jy)
    ty, tc = T.ssm_prefill(tp, cfg, tx[:, :10], chunk=4)
    tys = [ty]
    for t in (10, 11):
        ty, tc = T.ssm_decode_step(tp, cfg, tx[:, t:t + 1], tc)
        tys.append(ty)
    assert tc["conv_x"].dtype == torch.bfloat16 and tc["state"].dtype == torch.float32
    assert ty.dtype == torch.bfloat16
    for got, want in [*zip(tys, jys), *((tc[k], jc[k]) for k in jc)]:
        got, want = _np(got).ravel(), _np(want).ravel()
        assert np.corrcoef(got, want)[0, 1] >= 0.999
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_draws_the_reference_leaves(dtype):
    cfg = get_reduced("mamba2-780m")
    tdt = getattr(torch, dtype)
    got = T.ssm_init(torch.Generator().manual_seed(0), cfg, tdt)
    want = jax.eval_shape(lambda k: J.ssm_init(k, jax_reduced("mamba2-780m"), jnp.dtype(dtype)),
                          jax.random.PRNGKey(0))
    g, w = flat_leaves(got), flat_leaves(want)
    assert g.keys() == w.keys()
    for path, leaf in w.items():
        assert tuple(g[path].shape) == leaf.shape, path
        assert str(g[path].dtype).removeprefix("torch.") == str(leaf.dtype), path
    for k in ("A_log", "D", "dt_bias"):
        assert got[k].dtype == torch.float32
    assert torch.equal(got["conv_B"]["w"], got["conv_C"]["w"])
    assert got["conv_B"]["w"] is not got["conv_C"]["w"]
    ref = J.ssm_init(jax.random.PRNGKey(0), jax_reduced("mamba2-780m"), jnp.dtype(dtype))
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2 * F32_ULP)
    assert float(got["conv_x"]["w"].float().std()) == pytest.approx(0.2, rel=0.1)
