"""The port's hybrid decoder (the Jamba interleave of ``models/transformer.py``:
``group_init`` / ``group_forward`` / ``_group_prefill`` / ``_group_decode``
and the hybrid caches; ``models/model.py``'s ``build`` / ``loss``;
``convert.py``'s hybrid tree; ``launch/serve.py::serve_loop``) against the
JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``) goes through both
packages at the reduced Jamba-1.5-Large (one group of 4 layers, d = 64, 4
experts top-2, SSM state 16 in heads of 16, chunk 16, routing groups of
64), and at a variant of it with one group of 8 layers (``attn_period``
8: attention at j = 4, MoE at j = 1, 3, 5, 7), where an off-by-one in the
sub-layer counters that a group of 4 hides shows.  The contract, fixed
before the port was written:

* a float32 ``prefill`` and three greedy ``decode_step``s under dense and
  every ``mvu_*`` backend (the attention and dense-FFN projections
  integer-deployed, the SSM projections on ``linear``'s fake-quant arm,
  the experts and the router float, as in the reference): logits within
  1e-3 of the largest reference logit, greedy tokens equal; one group's
  ``group_forward`` within 1e-3 of its largest output and its aux loss
  within 1e-5; ``serve_loop`` on
  right-padded prompts returns the same token lists; the committed golden
  (``configs/jamba_1_5_large_398b_lm_golden.json``, with each call's
  dropped assignments) holds on the CPU;
* a prompt prefilled and the rest decoded give the logits of one prefill
  of the whole sequence at ``capacity_factor`` 8.0 (the reference's
  ``test_prefill_decode_matches_forward`` and its tolerance, rtol = atol
  = 2e-2, argmax equal), across an SSD chunk edge too;
* ``Model.loss`` under dense, W8A8 and binary in float32, remat on (one
  group one checkpointed body): loss and its aux part within 1e-5 of
  the reference, every gradient leaf within 2^-8 of its largest
  ``jax.value_and_grad`` magnitude (the MoE family's bound: the
  reference's bf16 token cast before the experts rounds the backward);
  the group of 8 with that cast in float32 in both packages within 1e-4,
  the dense family's bound;
* in bfloat16, prefill and decode logits correlation >= 0.999 and max
  |delta| <= 2e-2 of the largest logit against the JAX package run op by
  op (``jax.disable_jit()``);
* the hybrid caches: the KV cache in the model's dtype, every SSM leaf
  float32 (conv tails too), written in place by prefill and decode;
* ``lm_numpy_params`` draws the reference's layout leaf for leaf and
  ``cast_numpy_params`` keeps its float32 leaves at the hybrid's deeper
  paths; ``init(quantize=...)`` equals quantizing the float init and
  leaves the SSM, expert, router and SSM-scalar leaves float;
* a prompt shorter than the conv tail raises ``ValueError``; ``_normal``
  draws the same values as before it scaled in place.
"""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.moe as JM
import repro.models.ssm as JS
import repro.models.transformer as JT
from repro.configs import get_reduced as jax_reduced
from repro.launch.serve import Request as JRequest
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.models.model import build as jax_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs import lm_golden as G
from repro_torch.convert import (
    cast_numpy_params,
    keeps_float32,
    lm_numpy_params,
    lm_params_from_numpy,
)
from repro_torch.launch.serve import Request, serve_loop
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import build
from repro_torch.tree import flat_leaves

ARCH = G.HYBRID_ARCH
MVU = ("mvu_w8a8", "mvu_w4a8", "mvu_w4a4", "mvu_binary")
# the reduced Jamba (one group of 4 layers), one group of 8, two groups of 4
SHAPES = {"per4": {}, "per8": {"num_layers": 8, "attn_period": 8},
          "g2": {"num_layers": 8, "attn_period": 4}}
FLOAT_NODES = ("ssm", "moe")  # no leaf below these is integer-deployed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(backend="dense", dtype="float32", shape="per4", **kw):
    """(JAX config, port config) of the reduced Jamba at ``shape``."""
    kw = dict(dtype=dtype, remat=False, linear_backend=backend, **SHAPES[shape], **kw)
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
    ``dtype`` (the router and ``A_log`` / ``D`` / ``dt_bias`` float32),
    quantized by each package under an ``mvu_*`` backend."""
    tree = cast_numpy_params(lm_numpy_params(cfg, seed), jnp.dtype(dtype))
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    if backend in MVU:
        jp, tp = JL.quantize_model_params(jp, backend), TL.quantize_model_params(tp, backend)
    return jp, tp


def _runs(backend, dtype, *, shape="per4", steps=3, op_by_op=False, seed=0):
    """Logits of prefill + ``steps`` greedy decode steps on each package,
    both fed the JAX package's greedy tokens: (jax logits, port logits,
    jax tokens, port tokens), logits stacked (1 + steps, B, V) in float32."""
    jcfg, tcfg = _cfg(backend, dtype, shape)
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


def _group_input(cfg):
    """A (2, 32, d) float32 input and its positions, seeded."""
    x = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()


# ------------------------------------------------------------ the group
def test_the_group_layout_walks_the_reference_counters():
    """Attention at j = per // 2, an SSM layer at every other j, MoE at
    odd j and a dense FFN at even j, each kind counted in order."""
    want = {4: [(0, 0, "ffn", 0), (1, 1, "moe", 0), (2, None, "ffn", 1), (3, 2, "moe", 1)],
            8: [(0, 0, "ffn", 0), (1, 1, "moe", 0), (2, 2, "ffn", 1), (3, 3, "moe", 1),
                (4, None, "ffn", 2), (5, 4, "moe", 2), (6, 5, "ffn", 3), (7, 6, "moe", 3)]}
    for per, layers in want.items():
        assert TT._group_layers(get_reduced(ARCH).replace(num_layers=per,
                                                         attn_period=per)) == layers


@pytest.mark.parametrize("backend,shape", [("dense", "per4"), ("dense", "per8"),
                                           ("mvu_w8a8", "per4")])
def test_group_forward_and_its_aux_equal_jax(backend, shape):
    """One group's training forward on the JAX package's ``group_forward``,
    the MoE layers routing with ``cfg.capacity_factor`` over groups of 32
    tokens of 64: the output within 1e-3 of its largest magnitude (each
    sub-layer alone meets 1e-6, but a later MoE layer's bf16 token cast
    can round a float32 input one bf16 ulp apart: 2.4e-4 of 9.1 seen), the
    aux loss within 1e-5.  The W8A8 group of 8 is the next test's."""
    jcfg, tcfg = _cfg(backend, shape=shape, moe_group_size=32)
    jp, tp = _trees(tcfg, backend)
    x, pos = _group_input(tcfg)
    jy, jaux = JT.group_forward(jax.tree.map(lambda a: a[0], jp["layers"]), jcfg,
                                jnp.asarray(x), jnp.asarray(pos))
    ty, taux = TT.group_forward(TT.layer(tp["layers"], 0), tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    ref = np.asarray(jy)
    assert np.abs(ty.numpy() - ref).max() <= G.LOGIT_ATOL * np.abs(ref).max()
    assert taux.dtype == torch.float32 and float(jaux) > 0
    assert abs(taux.item() - float(jaux)) <= 1e-5 * float(jaux)


def test_the_w8a8_group_of_8_equals_jax_sub_layer_by_sub_layer():
    """The W8A8 group of 8 walked in the reference's order (its ``si`` /
    ``di`` / ``mi`` counters, written out here): each of the port's
    sub-layers, on the reference's running input, within 1e-5 of the
    reference's output.  The whole group is not compared at 1e-3: a
    quantized projection's per-tensor int8 activation rounds a 1e-6
    float32 difference one level apart (1 of 4,096 at j = 0's FFN on this
    input, 0.025 at its output), and the SSM state and the attention carry
    that step to every later token; ``group_forward`` runs these same
    sub-layers (the prefill and decode tests hold the whole stack at
    1e-3 of the largest logit)."""
    be = "mvu_w8a8"
    jcfg, tcfg = _cfg(be, shape="per8", moe_group_size=32)
    jp, tp = _trees(tcfg, be)
    jg = jax.tree.map(lambda a: a[0], jp["layers"])
    subs = TT._sub_layers(TT.layer(tp["layers"], 0))
    x, pos = _group_input(tcfg)
    xj, per = jnp.asarray(x), tcfg.attn_period
    at = lambda t, i: jax.tree.map(lambda a: a[i], t)
    port = torch.from_numpy
    si = di = mi = 0
    for j, (tj, tsi, kind, fi) in zip(range(per), TT._group_layers(tcfg)):
        h = JT._norm(jcfg, at(jg["ln_mix"], j), xj)
        t_in = port(np.asarray(xj).copy())
        th = TT._norm(tcfg, subs["ln_mix"][j], t_in)
        if j == per // 2:
            assert tsi is None
            want = JA.attention(jg["attn"], jcfg, h, jnp.asarray(pos), backend=be)
            got = TA.attention(TT.layer(tp["layers"], 0)["attn"], tcfg, th, port(pos),
                               backend=be)
        else:
            assert tsi == si
            want = JS.ssm_forward(at(jg["ssm"], si), jcfg, h, chunk=jcfg.ssd_chunk, backend=be)
            got = TS.ssm_forward(subs["ssm"][tsi], tcfg, th, chunk=tcfg.ssd_chunk, backend=be)
            si += 1
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max(), j
        xj = xj + want
        h = JT._norm(jcfg, at(jg["ln_ffn"], j), xj)
        if j % 2 == 1:
            want, _ = JM.moe_ffn(at(jg["moe"], mi), jcfg, h, group_size=32,
                                 capacity_factor=jcfg.capacity_factor, backend=be)
            assert (kind, fi) == ("moe", mi)
            mi += 1
        else:
            want = JT.ffn(at(jg["ffn"], di), jcfg, h, backend=be)
            assert (kind, fi) == ("ffn", di)
            di += 1
        got, _ = TT._group_ffn(subs, tcfg, port(np.asarray(xj).copy()), tj, kind, fi,
                               tcfg.capacity_factor)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max(), j
        xj = xj + want


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("backend", ["dense", *MVU])
@pytest.mark.parametrize("shape", ["per4", "per8"])
def test_prefill_decode_float32_equal_jax(shape, backend):
    jl, tl, jt, tt = _runs(backend, "float32", shape=shape)
    bound = G.LOGIT_ATOL * np.abs(jl).max()
    assert np.abs(tl - jl).max() <= bound, (np.abs(tl - jl).max(), bound)
    np.testing.assert_array_equal(tt, jt)


def test_two_groups_prefill_decode_equal_jax():
    jl, tl, jt, tt = _runs("mvu_w8a8", "float32", shape="g2")
    assert np.abs(tl - jl).max() <= G.LOGIT_ATOL * np.abs(jl).max()
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
    """The committed JAX golden run, its dropped assignments included."""
    want = G.load_golden(ARCH)["variants"][backend]
    assert want["dropped"][0] > 0 and want["dropped"][1:] == [0] * G.DECODE_STEPS
    cfg = G.golden_config(backend, ARCH)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = TL.quantize_model_params(params, backend)
    got = G.greedy_run(build(cfg, device="cpu"), params)
    assert G.mismatch(want, got) is None, G.mismatch(want, got)
    assert G.mismatch(want, {**got, "dropped": [d + 1 for d in got["dropped"]]}) is not None
    bad = np.array(got["tokens"])
    bad[0, -1] += 1
    assert "greedy tokens" in G.mismatch(want, {**got, "tokens": bad})


@pytest.mark.parametrize("b,s_prompt,s_total", [(2, 8, 12), (2, 3, 12), (1, 36, 40)])
def test_prefill_then_decode_equals_the_full_prefill(b, s_prompt, s_total):
    """The reference's ``test_prefill_decode_matches_forward`` for Jamba
    (dense, float32, capacity 8.0 so that no assignment drops): a prompt
    prefilled (the reference's 8 of 12, the shortest the conv tail allows,
    and 36 of 40: three chunks of 16) and the rest decoded give the full
    prefill's logits, which equal the JAX package's."""
    jcfg, tcfg = _cfg(capacity_factor=8.0)
    jp, tp = _trees(tcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (b, s_total)).astype(np.int32)
    m = build(tcfg, device="cpu")
    full, _ = m.prefill(tp, {"tokens": toks}, m.init_decode_state(b, 64))
    logits, state = m.prefill(tp, {"tokens": toks[:, :s_prompt]}, m.init_decode_state(b, 64))
    for t in range(s_prompt, s_total):
        logits, state = m.decode_step(tp, state, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(full.numpy(), -1))
    assert int(state["pos"][0, 0]) == s_total
    jm = jax_build(jcfg)
    jfull, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_decode_state(b, 64))
    ref = np.asarray(jfull)
    assert np.abs(full.numpy() - ref).max() <= G.LOGIT_ATOL * np.abs(ref).max()


@pytest.mark.parametrize("max_new", [(4, 4, 4), (4, 2, 3)])
def test_serve_loop_equal_jax(max_new):
    """Right-padded prompts of three lengths in groups of 2 (the last padded
    with a copy): the pad tokens run through the SSM state and take MoE
    capacity in both packages."""
    jcfg, tcfg = _cfg("mvu_w8a8")
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


def test_the_caches_are_float32_ssm_and_written_in_place():
    """``init_decode_state``'s hybrid caches: a KV cache a group in the
    model's dtype and (per - 1) SSM caches a group, every SSM leaf float32;
    in a bfloat16 model prefill and decode write the same buffers, and the
    conv tails hold the bf16 values the reference's prefill hands back."""
    cfg = get_reduced(ARCH).replace(remat=False)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    state = m.init_decode_state(2, 16)
    caches = state["caches"]
    assert set(caches) == {"attn", "ssm"}
    assert caches["attn"]["k"].shape == (1, 2, 16, 2, 16)
    assert caches["attn"]["k"].dtype == torch.bfloat16
    assert caches["ssm"]["state"].shape == (1, 3, 2, 8, 16, 16)
    assert caches["ssm"]["conv_x"].shape == (1, 3, 2, 3, 128)
    assert all(t.dtype == torch.float32 for t in caches["ssm"].values())
    bufs = {k: v.data_ptr() for k, v in flat_leaves(caches).items()}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    logits, s1 = m.prefill(params, {"tokens": toks}, state)
    after_prefill = {k: v.clone() for k, v in flat_leaves(caches).items()}
    assert all(bool(v.abs().sum() > 0) for v in after_prefill.values())
    tails = caches["ssm"]["conv_x"]
    assert torch.equal(tails, tails.to(torch.bfloat16).to(torch.float32))
    logits, s2 = m.decode_step(params, s1, torch.argmax(logits, -1))
    for s in (s1, s2):
        assert s["caches"] is caches
    assert {k: v.data_ptr() for k, v in flat_leaves(caches).items()} == bufs
    # each SSM layer's window slid by one, and its state moved
    assert torch.equal(caches["ssm"]["conv_B"][:, :, :, :2],
                       after_prefill["ssm/conv_B"][:, :, :, 1:])
    assert all(not torch.equal(caches["ssm"]["state"][0, i], after_prefill["ssm/state"][0, i])
               for i in range(3))
    written = caches["attn"]["k"][0].abs().sum(dim=(0, 2, 3)) > 0  # (T,): rows 0..6
    assert written[:7].all() and not written[7:].any()


def test_a_prompt_shorter_than_the_conv_tail_raises():
    cfg = get_reduced(ARCH).replace(dtype="float32")
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shorter than the conv tail of 3"):
        m.prefill(params, {"tokens": np.zeros((2, 2), np.int32)}, m.init_decode_state(2, 16))
    m.prefill(params, {"tokens": np.zeros((2, 3), np.int32)}, m.init_decode_state(2, 16))


# ------------------------------------------------------------ Model.loss
def _loss_and_grads(backend, shape, seed):
    """``Model.loss`` (remat on, one group one checkpointed body) and every
    gradient on each package over 40 tokens (three SSD chunks): (JAX loss,
    JAX aux, JAX grads by path, port loss, port aux dict, port grads by
    path, port config)."""
    jcfg, tcfg = _cfg(backend, shape=shape)
    jcfg, tcfg = jcfg.replace(remat=True), tcfg.replace(remat=True)
    tree = lm_numpy_params(tcfg, seed)
    jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
    toks = np.random.default_rng(seed + 1).integers(0, tcfg.vocab_size, (1, 41)).astype(np.int32)
    (jl, jaux), jg = jax.value_and_grad(jax_build(jcfg).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    leaves = flat_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, taux = build(tcfg, device="cpu").loss(tp, {"tokens": toks})
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    return float(jl), float(jaux["aux"]), flat_leaves(jg), tl, taux, grads, tcfg


def _hold_loss(backend, shape, seed, grad_atol):
    jl, jaux, jg, tl, taux, grads, tcfg = _loss_and_grads(backend, shape, seed)
    assert abs(tl.item() - jl) <= G.LOSS_RTOL * abs(jl), (tl.item(), jl)
    assert jaux > 0 and abs(taux["aux"].item() - jaux) <= 1e-5 * jaux
    assert tl.item() == pytest.approx(taux["ce"].item() + tcfg.aux_loss_weight
                                      * taux["aux"].item(), rel=1e-6)
    assert grads.keys() == jg.keys()
    assert {"layers/moe/router/w", "layers/ssm/A_log", "layers/ffn/w_gate/w",
            "layers/ln_mix/scale"} <= grads.keys()
    for path, g in jg.items():
        want = _np(g)
        assert grads[path].dtype == torch.float32 and tuple(grads[path].shape) == want.shape
        err = np.abs(_np(grads[path]) - want).max()
        assert err <= grad_atol * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_loss_and_gradients_float32_equal_jax(backend, seed):
    """The reduced Jamba's ``ce + aux_loss_weight * aux`` and every
    gradient, the attention, dense-FFN and SSM projections on the
    fake-quant arm under an ``mvu_*`` backend (1-bit scales computed once
    over the sub-stacks under binary): every leaf within 2^-8 of its
    largest, the MoE family's bound (the reference's bf16 token cast rounds
    the backward at each of the group's two MoE layers)."""
    _hold_loss(backend, "per4", seed, 2.0 ** -8)


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_loss_and_gradients_of_the_group_of_8_equal_jax(backend, monkeypatch):
    """The group of 8 (four MoE layers) with both packages' bf16 token cast
    before the experts, and their bf16 dispatch, in float32 instead: every
    gradient leaf within 1e-4 of its largest, the dense family's bound
    (6.0e-6 seen).  With the cast, the four MoE layers' bf16 roundings of
    the backward add up past 2^-8 (``layers/ssm/D`` 4.43e-3 of its
    largest under W8A8, seed 0), a gap ROADMAP queue C logs."""
    monkeypatch.setattr(JM, "jnp", types.SimpleNamespace(**{**vars(jnp),
                                                            "bfloat16": jnp.float32}))
    monkeypatch.setattr(TM, "torch", types.SimpleNamespace(**{**vars(torch),
                                                              "bfloat16": torch.float32}))
    _hold_loss(backend, "per8", 0, G.GRAD_ATOL)


def test_the_group_of_8_gap_starts_at_a_bf16_cast_of_float32_rounding(monkeypatch):
    """Why the group of 8 with the bf16 token cast lies past 2^-8 (ROADMAP
    queue C, deviations by design; ``scripts/hybrid_bf16_gap.py``): one MoE
    layer on the same input and cotangent in both packages gives d_x within
    1e-6 of its largest (its bf16 casts round equal values), but the group's
    first MoE layer gets float32 inputs apart by float32 rounding alone
    (within 1e-6 of the largest; the SSM layer before it runs XLA's CPU
    ``exp`` against torch's), and where two of them straddle a bf16
    midpoint the cast rounds them one bf16 ulp apart: token 2, channel 57,
    JAX -0.16552706 and the port -0.16552794 about -0.16552734375.  No
    operation order removes that; four MoE layers add such flips up."""
    jcfg, tcfg = _cfg("mvu_w8a8", shape="per8")
    jcfg, tcfg = jcfg.replace(remat=True), tcfg.replace(remat=True)
    tree = lm_numpy_params(tcfg, 0)
    # one MoE layer, the same input and cotangent
    p = {k: ({"w": v["w"][0, 0]} if isinstance(v, dict) else v[0, 0])
         for k, v in tree["layers"]["moe"].items()}
    rng = np.random.default_rng(0)
    x, dout = (rng.standard_normal((1, 40, tcfg.d_model)).astype(np.float32) for _ in range(2))
    kw = dict(group_size=tcfg.moe_group_size, capacity_factor=tcfg.capacity_factor)
    _, vjp = jax.vjp(lambda a: JM.moe_ffn(jax.tree.map(jnp.asarray, p), jcfg, a, **kw)[0],
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    got = torch.autograd.grad(TM.moe_ffn(jax.tree.map(torch.from_numpy, p), tcfg, tx, **kw)[0],
                              tx, torch.from_numpy(dout))[0].numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the group of 8's forward: the first MoE layer's input in both packages
    seen = {"j": [], "t": []}
    jin, tin = JT.moe_ffn, TT.moe_ffn

    def jmoe(p, cfg, x, **kw):
        jax.debug.callback(lambda a: seen["j"].append(np.asarray(a)), x)
        return jin(p, cfg, x, **kw)

    def tmoe(p, cfg, x, **kw):
        seen["t"].append(x.detach().numpy().copy())
        return tin(p, cfg, x, **kw)

    monkeypatch.setattr(JT, "moe_ffn", jmoe)
    monkeypatch.setattr(TT, "moe_ffn", tmoe)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 41)).astype(np.int32)
    jax.jit(jax_build(jcfg).loss)(jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    with torch.no_grad():
        build(tcfg, device="cpu").loss(lm_params_from_numpy(tree), {"tokens": toks})
    assert len(seen["j"]) == len(seen["t"]) == 4
    a, b = seen["j"][0], seen["t"][0]
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    to_bf16 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    flips = np.argwhere(to_bf16(a) != to_bf16(b))
    assert [0, 2, 57] in flips.tolist()
    bits = lambda v: int(np.asarray(jnp.asarray(v, jnp.bfloat16)).view(np.uint16))
    for i in map(tuple, flips):  # bf16 neighbours, the two inputs astride their midpoint
        lo, hi = to_bf16(a)[i], to_bf16(b)[i]
        assert abs(bits(lo) - bits(hi)) == 1 and np.sign(lo) == np.sign(hi)
        mid = (np.float64(lo) + np.float64(hi)) / 2
        assert min(a[i], b[i]) <= mid <= max(a[i], b[i])
    assert to_bf16(a)[0, 2, 57] == np.float32(-0.1650390625)
    assert to_bf16(b)[0, 2, 57] == np.float32(-0.166015625)


def test_with_column_scales_reaches_the_sub_stacks():
    """Under binary the scales of the (G, n, d_in, d_out) dense-FFN
    sub-stack and the (G, d_in, d_out) attention are each 2-D weight's
    ``column_scale``; the SSM projections, the experts and the router are
    left as they are."""
    _, tcfg = _cfg("mvu_binary", shape="g2")
    tp = lm_params_from_numpy(lm_numpy_params(tcfg, 0))
    scaled = TL.with_column_scales(tp["layers"], "mvu_binary")
    w = tp["layers"]["ffn"]["w_up"]["w"]
    assert w.shape[:2] == (2, 2) and scaled["ffn"]["w_up"]["bipolar_scale"].shape == (
        2, 2, 1, tcfg.d_ff)
    for g in range(2):
        for i in range(2):
            assert torch.equal(scaled["ffn"]["w_up"]["bipolar_scale"][g, i],
                               TL.column_scale(w[g, i]))
        assert torch.equal(scaled["attn"]["wq"]["bipolar_scale"][g],
                           TL.column_scale(tp["layers"]["attn"]["wq"]["w"][g]))
    assert set(scaled["ssm"]["w_z"]) == {"w"} and set(scaled["moe"]["router"]) == {"w"}
    for k in ("w_up", "w_gate", "w_down"):
        assert scaled["moe"][k] is tp["layers"]["moe"][k]


def test_build_runs_prefill_decode_and_loss_at_the_reduced_config():
    """``build(get_reduced("jamba-1.5-large-398b"), device="cpu")`` as
    configured (bfloat16, remat on): params from ``init``, a prefill, a
    decode step and the loss with its gradients, all finite."""
    cfg = get_reduced(ARCH)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    lay = params["layers"]
    assert set(lay) == {"ln_mix", "ln_ffn", "attn", "ssm", "ffn", "moe"}
    assert lay["moe"]["router"]["w"].dtype == torch.float32
    assert lay["moe"]["w_up"].dtype == torch.bfloat16 and lay["moe"]["w_up"].shape[:2] == (1, 2)
    assert all(lay["ssm"][k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    assert torch.equal(lay["ssm"]["conv_B"]["w"], lay["ssm"]["conv_C"]["w"])
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["per4", "per8", "g2"])
def test_hybrid_tree_is_the_reference_layout(shape, dtype):
    """``lm_numpy_params`` draws the names and shapes of the JAX package's
    own ``init`` (``jax.eval_shape``), and ``cast_numpy_params`` gives each
    leaf its dtype there: the router and ``A_log`` / ``D`` / ``dt_bias``
    float32 at the hybrid's deeper paths; each SSM sub-layer's ``conv_C``
    equals its ``conv_B``; ``lm_params_from_numpy`` carries the dtypes
    across."""
    jcfg, tcfg = _cfg(dtype=dtype, shape=shape)
    tree = cast_numpy_params(lm_numpy_params(tcfg, 0), jnp.dtype(dtype))
    ref = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)
    n, per = tcfg.num_layers // tcfg.attn_period, tcfg.attn_period
    lay = tree["layers"]
    assert lay["ln_mix"]["scale"].shape == (n, per, tcfg.d_model)
    assert lay["ssm"]["w_z"]["w"].shape[:2] == (n, per - 1)
    assert lay["ffn"]["w_up"]["w"].shape[:2] == (n, per - per // 2)
    assert lay["moe"]["w_down"].shape == (n, per // 2, tcfg.num_experts, tcfg.moe_d_ff,
                                          tcfg.d_model)
    np.testing.assert_array_equal(lay["ssm"]["conv_B"]["w"], lay["ssm"]["conv_C"]["w"])
    assert not np.array_equal(lay["ssm"]["conv_B"]["w"][0, 0], lay["ssm"]["conv_B"]["w"][0, 1])
    tp = lm_params_from_numpy(tree)
    for path, t in flat_leaves(tp).items():
        assert t.dtype == (torch.float32 if keeps_float32(path) else getattr(torch, dtype)), path


def test_the_float32_leaves_at_the_hybrid_paths():
    assert keeps_float32("layers/moe/router/w") and keeps_float32("layers/ssm/dt_bias")
    assert keeps_float32("layers/ssm/A_log") and keeps_float32("layers/ssm/D")
    assert not keeps_float32("layers/ffn/w_down/w") and not keeps_float32("layers/ln_mix/scale")
    assert not keeps_float32("layers/moe/w_gate") and not keeps_float32("layers/attn/wo/w")


@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_binary"])
@pytest.mark.parametrize("shape", ["per4", "g2"])
def test_init_quantized_as_drawn_equals_quantizing_the_float_init(shape, backend):
    """``init(g, quantize=...)`` draws each group and quantizes it at once:
    the tree ``quantize_model_params`` gives the float init, the attention
    and dense-FFN projections integer-deployed, every leaf under ``ssm``
    and ``moe`` float (the router, ``A_log`` / ``D`` / ``dt_bias`` float32)."""
    _, cfg = _cfg(backend, dtype="bfloat16", shape=shape)
    m = build(cfg, device="cpu")
    drawn = m.init(torch.Generator().manual_seed(3), quantize=backend)
    want = TL.quantize_model_params(m.init(torch.Generator().manual_seed(3)), backend)
    assert flat_leaves(drawn).keys() == flat_leaves(want).keys()
    for path, w in flat_leaves(want).items():
        assert torch.equal(flat_leaves(drawn)[path], w), path
    lay = drawn["layers"]
    assert {k for k, v in lay["attn"].items() if "values" in v} == {"wq", "wk", "wv", "wo"}
    assert {k for k, v in lay["ffn"].items() if "values" in v} == {"w_up", "w_gate", "w_down"}
    assert all(p["values"].dtype == torch.int8 for p in (*lay["attn"].values(),
                                                         *lay["ffn"].values()))
    for node in FLOAT_NODES:
        for path, t in flat_leaves(lay[node]).items():
            want_dt = torch.float32 if keeps_float32(f"{node}/{path}") else torch.bfloat16
            assert t.dtype == want_dt, (node, path)


def test_stacked_moe_init_equals_one_draw_each():
    """``moe_init(n=2)`` draws the values two ``moe_init`` calls draw, each
    leaf allocated once."""
    cfg = get_reduced(ARCH)
    stacked = TM.moe_init(torch.Generator().manual_seed(4), cfg, torch.bfloat16, n=2)
    g = torch.Generator().manual_seed(4)
    each = [TM.moe_init(g, cfg, torch.bfloat16) for _ in range(2)]
    assert flat_leaves(stacked).keys() == flat_leaves(each[0]).keys()
    for path, t in flat_leaves(stacked).items():
        assert t.shape[0] == 2 and t.dtype == flat_leaves(each[0])[path].dtype, path
        for i in range(2):
            assert torch.equal(t[i], flat_leaves(each[i])[path]), (path, i)


def test_stack_layers_fills_a_stack_and_a_lone_tree_is_its_own():
    trees = [{"a": torch.full((2,), float(i)), "n": {"b": torch.ones(3) * i}} for i in range(3)]
    out = TT.stack_layers(iter(trees), 3)
    assert torch.equal(out["a"], torch.stack([t["a"] for t in trees]))
    assert torch.equal(out["n"]["b"], torch.stack([t["n"]["b"] for t in trees]))
    one = TT.stack_layers([trees[1]], 1)
    assert one["a"].shape == (1, 2) and one["a"].data_ptr() == trees[1]["a"].data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_draws_the_values_it_drew_before_scaling_in_place(dtype):
    """``_normal`` scales its float32 draw in place and casts it into
    ``out`` where one is given: the values of ``(randn * scale).to(dtype)``
    bit for bit."""
    shape, scale = (64, 33), 1.0 / math.sqrt(64)
    want = (torch.randn(shape, generator=torch.Generator().manual_seed(7)) * scale).to(dtype)
    got = TL._normal(torch.Generator().manual_seed(7), shape, scale, dtype, "cpu")
    out = torch.empty((2, *shape), dtype=dtype)
    into = TL._normal(torch.Generator().manual_seed(7), shape, scale, dtype, "cpu", out=out[1])
    for t in (got, into, out[1]):
        assert t.dtype == dtype and torch.equal(t, want)
    assert into.data_ptr() == out[1].data_ptr()


def test_the_full_config_dispatches_on_is_hybrid():
    """Jamba-1.5-Large holds 16 experts, so ``is_moe`` is true for it too:
    the stack walks its 9 groups of 8 (one group of 4 when cut), not 72
    uniform MoE blocks."""
    cfg = get_config(ARCH)
    assert cfg.is_hybrid and cfg.is_moe and cfg.rope is False
    TT.require_ported(cfg)
    assert TT._n_stacked(cfg) == 9
    assert TT._n_stacked(cfg.replace(num_layers=4, attn_period=4)) == 1
