"""The port's Mixture-of-Experts FFN (``repro_torch/models/moe.py``) against
the JAX package's (``repro/models/moe.py``), on the CPU.

The same numpy-seeded inputs go through both packages at the reduced
Granite-MoE and Qwen3-MoE widths (d = 64, 8 experts, top-2, d_ff 64).
The contract, fixed before the port was written:

* ``dispatch_combine``: dispatch and combine ``np.array_equal`` to JAX's,
  with drops (capacity below the load), rows whose slot position is -1 or
  past the capacity, tied routing and several groups at once;
* ``route_topk``: the expert ids equal JAX's, ties and signed zeros
  included (``jax.lax.top_k``'s order); the weights within 2 ulp of
  float32 (max relative error 2.4e-7): XLA's CPU ``exp`` is 1 ulp off the
  correctly rounded value for ~9% of inputs, torch's is not; and XLA
  flushes subnormal results to zero, so a weight below float32's smallest
  normal (1.2e-38) may be 0 there;
* ``load_balancing_loss`` and ``_capacity`` equal JAX's;
* ``moe_ffn`` in float32: the routing's expert ids equal first, then the
  output within 1e-5 of its largest JAX magnitude and the aux loss within
  1e-6 of it, at one and at several groups; in bfloat16 within 2e-2 of the
  largest magnitude, correlation >= 0.999;
* the gradients of ``sum(out ** 2) + 0.01 * aux`` for the router and every
  expert weight within 1e-4 of their largest ``jax.grad`` magnitude (the
  reference's ``test_moe_router_gradients_flow``, by value);
* a single expert with room for every token equals the dense SwiGLU FFN on
  the bfloat16-rounded tokens (float32 rtol = atol = 1e-5);
* a group size that does not divide the tokens raises, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.configs import get_reduced as jax_reduced
from repro_torch.configs import get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
ULP_RTOL = 2.4e-7  # 2 ulp of float32
TINY = float(np.finfo(np.float32).tiny)  # XLA's CPU flushes subnormals to zero


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (integers as they are)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.to(torch.float32) if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _cfg(arch, dtype="float32", **kw):
    """(JAX config, port config) of a reduced MoE arch."""
    kw = dict(dtype=dtype, **kw)
    return jax_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)


def _params(cfg, seed, dtype="float32"):
    """One MoE layer's params in the reference layout (numpy float32, the
    router float32 always) as a JAX tree and a port tree, the experts in
    ``dtype``."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    tree = {"router": {"w": rng.standard_normal((d, e), dtype=np.float32) / np.float32(np.sqrt(d))},
            "w_up": rng.standard_normal((e, d, f), dtype=np.float32) / np.float32(np.sqrt(d)),
            "w_gate": rng.standard_normal((e, d, f), dtype=np.float32) / np.float32(np.sqrt(d)),
            "w_down": rng.standard_normal((e, f, d), dtype=np.float32) / np.float32(np.sqrt(f))}
    jp = {k: ({"w": jnp.asarray(v["w"])} if k == "router" else jnp.asarray(v).astype(dtype))
          for k, v in tree.items()}
    tp = {k: ({"w": torch.from_numpy(v["w"].copy())} if k == "router"
              else torch.from_numpy(_np(jp[k]).copy()).to(getattr(torch, dtype)))
          for k, v in tree.items()}
    return jp, tp


def _x(shape, seed, dtype="float32"):
    j = jnp.asarray(np.random.default_rng(seed).normal(0, 0.5, shape).astype(np.float32))
    j = j.astype(dtype)
    return j, torch.from_numpy(_np(j).copy()).to(getattr(torch, dtype))


# ------------------------------------------------------------ route_topk
def _logits(case: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((48, 8)).astype(np.float32) * 3
    if case == "ties":
        x = np.round(x)  # many exact ties, and -0.0 beside 0.0
    elif case == "signed_zeros":
        x[:, :4] = 0.0
        x[::2, 1] = -0.0
        x[1::3, 5] = -0.0
        x[:, 6:] = -1.0
    elif case == "all_equal":
        x[:] = 0.25
    elif case == "large":
        x *= 1e3
    return x


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("case", ["random", "ties", "signed_zeros", "all_equal", "large"])
def test_route_topk_equals_jax(case, k):
    x = _logits(case, k)
    jw, ji = JM.route_topk(jnp.asarray(x), k)
    tw, ti = TM.route_topk(torch.from_numpy(x), k)
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ULP_RTOL, atol=TINY)


def test_route_topk_orders_positive_zero_above_negative_zero():
    """``jax.lax.top_k`` sorts in IEEE total order: +0 above -0, the lower
    index first among equal bits; ``torch.sort`` of the floats would keep
    index order between the zeros."""
    x = np.float32([[-0.0, 0.0, -1.0, -0.0, 0.0, -2.0]])
    ji = np.asarray(JM.route_topk(jnp.asarray(x), 4)[1])
    ti = TM.route_topk(torch.from_numpy(x), 4)[1].numpy()
    np.testing.assert_array_equal(ti, ji)
    assert ti.tolist() == [[1, 4, 0, 3]]


def test_route_topk_bfloat16_logits_equal_jax():
    x = jnp.asarray(_logits("random", 5)).astype("bfloat16")
    jw, ji = JM.route_topk(x, 2)
    tw, ti = TM.route_topk(torch.from_numpy(_np(x)).to(torch.bfloat16), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ULP_RTOL, atol=TINY)


# ------------------------------------------------------------ dispatch_combine
def test_dispatch_combine_capacity_and_weights():
    """The reference's ``test_dispatch_combine_capacity_and_weights`` on the
    port, and equal to JAX's."""
    idx = np.asarray([[0, 1], [0, 1], [0, 2], [1, 2]])  # (G=4, k=2)
    w = np.full((4, 2), 0.5, np.float32)
    e, cap = 3, 2
    dispatch, combine = TM.dispatch_combine(torch.from_numpy(idx), torch.from_numpy(w), e, cap)
    assert dispatch.dtype == torch.bfloat16 and combine.dtype == torch.float32
    d = _np(dispatch)
    # expert 0 receives tokens 0,1 (cap 2); token 2's expert-0 slot dropped
    assert d[:, 0].sum() == 2
    assert d[2, 0].sum() == 0  # dropped
    # every kept slot holds exactly one token
    assert (d.sum(0) <= 1.0 + 1e-6).all()
    c = combine.numpy()
    np.testing.assert_allclose(c[d > 0], 0.5)
    jd, jc = JM.dispatch_combine(jnp.asarray(idx), jnp.asarray(w), e, cap)
    np.testing.assert_array_equal(d, _np(jd))
    np.testing.assert_array_equal(c, np.asarray(jc))


def _routing(case: str, seed: int, g=24, k=2, e=8):
    """(idx (G, k), weights (G, k)) of a routing case."""
    rng = np.random.default_rng(seed)
    if case == "tied_logits":  # route_topk of logits full of ties
        w, idx = JM.route_topk(jnp.asarray(np.round(rng.standard_normal((g, e)))
                                           .astype(np.float32)), k)
        return np.array(idx), np.array(w)
    logits = rng.standard_normal((g, e)).astype(np.float32)
    if case == "skewed":  # most tokens want experts 0 and 1: drops
        logits[:, :2] += 3.0
    elif case == "late_expert":  # expert 7 only from the last rows: pos = -1 above
        logits[:, 7] = -9.0
        logits[-3:, 7] = 9.0
    w, idx = JM.route_topk(jnp.asarray(logits), k)
    return np.array(idx), np.array(w)


@pytest.mark.parametrize("capacity", [1, 4, 7, 48])
@pytest.mark.parametrize("case", ["random", "skewed", "late_expert", "tied_logits"])
def test_dispatch_combine_equals_jax(case, capacity):
    idx, w = _routing(case, capacity)
    jd, jc = JM.dispatch_combine(jnp.asarray(idx), jnp.asarray(w), 8, capacity)
    td, tc = TM.dispatch_combine(torch.from_numpy(idx), torch.from_numpy(w), 8, capacity)
    assert td.shape == (24, 8, capacity) and td.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    kept = int(_np(td).sum())
    if case == "skewed" and capacity < 7:
        assert kept < idx.size  # this case drops
    if capacity == 48:
        assert kept == idx.size  # room for every assignment


def test_dispatch_combine_of_several_groups_equals_jax_vmap():
    """Leading group axes: each group routed on its own, as the reference's
    ``vmap`` over groups."""
    groups = [_routing(c, s) for c, s in (("skewed", 1), ("random", 2), ("late_expert", 3))]
    idx = np.stack([i for i, _ in groups])
    w = np.stack([x for _, x in groups])
    jd, jc = jax.vmap(lambda i, x: JM.dispatch_combine(i, x, 8, 5))(jnp.asarray(idx),
                                                                    jnp.asarray(w))
    td, tc = TM.dispatch_combine(torch.from_numpy(idx), torch.from_numpy(w), 8, 5)
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ------------------------------------------------------------ aux loss, capacity
@pytest.mark.parametrize("case", ["random", "skewed", "tied_logits"])
def test_load_balancing_loss_equals_jax(case):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((24, 8)).astype(np.float32)
    idx, _ = _routing(case, 4)
    want = float(JM.load_balancing_loss(jnp.asarray(logits), jnp.asarray(idx), 8))
    got = TM.load_balancing_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) <= ULP_RTOL * abs(want), (got.item(), want)


def test_capacity_equals_jax():
    for group in (1, 4, 24, 64, 456, 512):
        for e, k in ((8, 2), (40, 8), (128, 8), (1, 1)):
            for factor in (1.0, 1.25, 2.0, 8.0):
                assert TM._capacity(group, e, k, factor) == JM._capacity(group, e, k, factor)


# ------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("shape,group", [((2, 12), 64), ((2, 16), 8), ((4, 1), 512)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_float32_equals_jax(arch, shape, group):
    """One group (a prefill), four groups of 8 and a decode step's 4 tokens:
    the expert ids first, then the output and the aux loss."""
    jcfg, tcfg = _cfg(arch)
    jp, tp = _params(tcfg, 0)
    jx, tx = _x((*shape, tcfg.d_model), 1)
    g = min(group, shape[0] * shape[1])
    jlog = jnp.asarray(jx).reshape(-1, g, tcfg.d_model) @ jp["router"]["w"]
    tlog = tx.reshape(-1, g, tcfg.d_model) @ tp["router"]["w"]
    ji = np.asarray(JM.route_topk(jlog.reshape(-1, tcfg.num_experts), 2)[1])
    ti = TM.route_topk(tlog.reshape(-1, tcfg.num_experts), 2)[1].numpy()
    np.testing.assert_array_equal(ti, ji)
    jy, jaux = JM.moe_ffn(jp, jcfg, jx, group_size=group)
    ty, taux = TM.moe_ffn(tp, tcfg, tx, group_size=group)
    assert ty.dtype == torch.float32 and ty.shape == tx.shape and taux.dtype == torch.float32
    want = np.asarray(jy)
    err = np.abs(ty.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    assert abs(taux.item() - float(jaux)) <= 1e-6 * abs(float(jaux)), (taux.item(), float(jaux))


@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_capacity_factors_equal_jax(arch, factor):
    """Tight and loose capacity on skewed tokens: the drops change the
    output, equally in both packages."""
    jcfg, tcfg = _cfg(arch)
    jp, tp = _params(tcfg, 2)
    jx, tx = _x((3, 16, tcfg.d_model), 3)
    jx, tx = jx + 0.4, tx + 0.4  # a shared offset skews the routing
    jy, jaux = JM.moe_ffn(jp, jcfg, jx, group_size=48, capacity_factor=factor)
    ty, taux = TM.moe_ffn(tp, tcfg, tx, group_size=48, capacity_factor=factor)
    want = np.asarray(jy)
    assert np.abs(ty.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(taux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_bfloat16_within_bounds_of_jax(arch):
    """bfloat16 experts and tokens (the router float32): the combine
    weights rounded to bfloat16 as in the reference."""
    jcfg, tcfg = _cfg(arch, "bfloat16")
    jp, tp = _params(tcfg, 5, "bfloat16")
    jx, tx = _x((2, 12, tcfg.d_model), 6, "bfloat16")
    assert tp["router"]["w"].dtype == torch.float32 and tp["w_up"].dtype == torch.bfloat16
    jy, jaux = JM.moe_ffn(jp, jcfg, jx, group_size=64)
    ty, taux = TM.moe_ffn(tp, tcfg, tx, group_size=64)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    want, got = _np(jy).ravel(), _np(ty).ravel()
    assert np.corrcoef(want, got)[0, 1] >= 0.999
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert abs(taux.item() - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_gradients_equal_jax(arch):
    """The reference's ``test_moe_router_gradients_flow`` (one group of 64),
    by value: router and expert gradients of ``sum(out**2) + 0.01 * aux``."""
    jcfg, tcfg = _cfg(arch)
    jp, tp = _params(tcfg, 7)
    jx, tx = _x((1, 64, tcfg.d_model), 8)

    def f(p):
        out, aux = JM.moe_ffn(p, jcfg, jx, group_size=64)
        return jnp.sum(out ** 2) + 0.01 * aux

    jg = jax.grad(f)(jp)
    leaves = [tp["router"]["w"], tp["w_up"], tp["w_gate"], tp["w_down"]]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = TM.moe_ffn(tp, tcfg, tx, group_size=64)
    grads = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux, leaves)
    wants = [jg["router"]["w"], jg["w_up"], jg["w_gate"], jg["w_down"]]
    for name, got, want in zip(("router", "w_up", "w_gate", "w_down"), grads, wants):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_moe_ffn_single_expert_equals_dense_ffn():
    """E=1 top-1 MoE (cap >= tokens) == plain FFN with that expert on the
    bfloat16-rounded tokens (the reference's test, at float32 tolerance)."""
    _, tcfg = _cfg("granite-moe-3b-a800m", num_experts=1, num_experts_per_tok=1,
                   capacity_factor=4.0, moe_group_size=16)
    p = TM.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 0.3, (2, 16, tcfg.d_model))
                         .astype(np.float32))
    out, aux = TM.moe_ffn(p, tcfg, x, group_size=16, capacity_factor=4.0)
    xb = x.to(torch.bfloat16).to(torch.float32)
    want = TL.activation("swiglu", xb @ p["w_gate"][0], xb @ p["w_up"][0]) @ p["w_down"][0]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert aux.item() == pytest.approx(1.0)  # one expert takes everything


@pytest.mark.parametrize("tokens,group", [((2, 12), 16), ((3, 10), 8)])
def test_group_that_does_not_divide_the_tokens_raises(tokens, group):
    jcfg, tcfg = _cfg("granite-moe-3b-a800m")
    jp, tp = _params(tcfg, 0)
    jx, tx = _x((*tokens, tcfg.d_model), 1)
    with pytest.raises(Exception):
        JM.moe_ffn(jp, jcfg, jx, group_size=group)
    with pytest.raises(ValueError, match="do not split into groups"):
        TM.moe_ffn(tp, tcfg, tx, group_size=group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_follows_the_reference_layout(arch, dtype):
    """Shapes, dtypes (the router float32 in every model) and scales:
    ``1/sqrt(d)`` for the router, up and gate, ``1/sqrt(f)`` for down."""
    _, tcfg = _cfg(arch)
    p = TM.moe_init(torch.Generator().manual_seed(0), tcfg, dtype)
    jp = JM.moe_init(jax.random.PRNGKey(0), tcfg, jnp.dtype(str(dtype).split(".")[1]))
    e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff
    assert set(p) == set(jp) == {"router", "w_up", "w_gate", "w_down"}
    assert p["router"]["w"].dtype == torch.float32 and p["router"]["w"].shape == (d, e)
    assert str(jp["router"]["w"].dtype) == "float32"
    for k, shape, fan_in in (("w_up", (e, d, f), d), ("w_gate", (e, d, f), d),
                             ("w_down", (e, f, d), f)):
        assert p[k].dtype == dtype and tuple(p[k].shape) == shape == jp[k].shape, k
        assert abs(p[k].float().std().item() * np.sqrt(fan_in) - 1) < 0.1, k
