"""The port's training step of the dense LM (``optim/adamw.py``,
``launch/train.py::make_train_step``, ``data/pipeline.py::SyntheticLM``)
against the JAX package, on the CPU.

The same numpy tree (``convert.lm_numpy_params``), optimizer state
(``convert.opt_state_from_numpy`` / ``numpy_tree``) and batches go through
the JAX package's functions and the port's, at the reduced Yi-9B (2
layers, d = 64) in float32.  The contract, fixed before the port was
written:

* ``schedule`` over steps 0-12 within 1 float32 ulp of JAX's op-by-op
  (eager) run (XLA's cos may round differently from torch's; where
  ``1 + cos`` cancels, one cos ulp times ``lr (1 - min_lr_frac) / 2``), and within
  the golden's lr rtol 1e-6 of the jitted one (XLA fuses the cosine leg:
  3 ulp off its own eager value at step 7, where ``1 + cos`` cancels);
* ``init`` equal: float32 zero moments of each parameter's shape, a 0-d
  int32 step 0;
* ``global_norm`` within rtol 1e-6 (the per-leaf sums add in another
  order);
* the per-leaf step (``leaf_update``) equal to the reference's op-by-op
  (eager) ``update`` of a one-leaf tree bit for bit, given its clip, lr
  and bias corrections, in float32 and bfloat16, the clip active and
  not; compiled JAX fuses it into FMAs;
* ``update`` on the reduced Yi-9B tree: lr and the step equal, grad_norm
  within rtol 1e-6, params, ``mu`` and ``nu`` within 1e-5 of each leaf's
  largest magnitude of the jitted reference (the moments' FMA
  cancellation; the port's reaches 3e-6); with bf16 params and the clip
  inactive, the op-by-op reference's bit for bit;
* ``make_train_step`` from the same state, under ``dense`` and
  ``mvu_w8a8``, remat off as in the reference's ``_tiny_model``: 4 steps,
  each taken by both packages from the state the reference reached,
  within the train golden's bounds (loss rtol 1e-4 atol 1e-5, grad_norm
  rtol 1e-4, lr rtol 1e-6) and the trees within ``TRAIN_ATOL`` of each
  leaf's largest magnitude;
* the committed train golden (``configs/yi_9b_train_golden.json``) holds
  on the CPU, as ``chip_smoke.py`` holds it on the card;
* ``SyntheticLM`` batches equal JAX's bit for bit; the ported
  ``test_synthetic_lm_structure_learnable``;
* a crash at step 4 and a resume from its checkpoint (``CheckpointManager``)
  give steps 5-8 the losses of the uninterrupted run within the reference's
  rtol 1e-4, atol 1e-5 (its own ``train_loop`` test fails on this jax).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models.model import build as jax_build
from repro.optim import adamw as JA
from repro_torch.configs import lm_golden as G
from repro_torch.convert import (lm_numpy_params, lm_params_from_numpy, numpy_tree,
                                 opt_state_from_numpy)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import adamw as TA
from repro_torch.tree import flat_leaves, tree_leaves, tree_map, unflatten

OPTS = [G.TRAIN_OPT, {}, {"lr": 2e-4, "warmup_steps": 0, "total_steps": 5, "min_lr_frac": 0.0}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(a, b) -> int:
    a, b = np.atleast_1d(_f32(a)), np.atleast_1d(_f32(b))
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _jax_tree(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype),
                        tree)


def _close(want_tree, got_tree, atol):
    """Each leaf of ``got_tree`` (port) within ``atol`` times the largest
    magnitude of ``want_tree``'s (JAX) leaf; the worst such ratio."""
    want = flat_leaves(jax.tree.map(lambda a: _f32(a), want_tree))
    got = flat_leaves(got_tree)
    assert want.keys() == got.keys()
    worst = 0.0
    for path, w in want.items():
        err = float(np.abs(_f32(got[path]) - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= atol, (path, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("opt", OPTS, ids=["golden", "default", "no_warmup"])
def test_schedule_within_one_ulp_of_jax(opt):
    """1 ulp where the cosine leg does not cancel; the no-warmup case
    (min_lr_frac 0, so ``1 + cos`` falls to 0.19 at step 4) widens one
    cos ulp by ``lr * (1 - min_lr_frac) / 2`` over the result, which is
    the bound there."""
    jcfg, tcfg = JA.AdamWConfig(**opt), TA.AdamWConfig(**opt)
    jitted = jax.jit(lambda s: JA.schedule(jcfg, s))
    for step in range(13):
        got = TA.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        s = jnp.asarray(step, jnp.int32)
        want = float(JA.schedule(jcfg, s))
        t = min(max((step - jcfg.warmup_steps) / max(jcfg.total_steps - jcfg.warmup_steps, 1),
                    0.0), 1.0)
        cos_ulp = float(np.spacing(np.float32(abs(np.cos(np.pi * t)))))
        bound = float(np.spacing(np.float32(want))) + (
            jcfg.lr * (1 - jcfg.min_lr_frac) * 0.5 * cos_ulp if step >= jcfg.warmup_steps else 0)
        assert abs(got.item() - want) <= bound, step
        if opt is not OPTS[2]:
            assert _ulps(want, got) <= 1, step
        assert got.item() == pytest.approx(float(jitted(s)), rel=G.TRAIN_LR_RTOL, abs=0), step


def test_init_equals_jax():
    cfg = G.golden_config()
    tree = lm_numpy_params(cfg, 1)
    want, got = JA.init(_jax_tree(tree)), TA.init(lm_params_from_numpy(tree))
    assert got["step"].dtype == torch.int32 and got["step"].shape == () and got["step"].item() == 0
    assert int(want["step"]) == 0
    for m in ("mu", "nu"):
        w, g = flat_leaves(want[m]), flat_leaves(got[m])
        assert w.keys() == g.keys()
        for p in w:
            assert g[p].dtype == torch.float32 and np.array_equal(np.asarray(w[p]), g[p].numpy())


def test_init_keeps_each_parameter_device():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2, 2)}}
    state = TA.init(params)
    assert state["mu"]["a"].dtype == torch.float32 and state["nu"]["b"]["c"].shape == (2, 2)
    assert all(t.device == torch.device("cpu") for t in flat_leaves(state).values())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 30.0])
def test_global_norm_equals_jax(scale):
    tree = jax.tree.map(lambda a: (a * np.float32(scale)).astype(np.float32),
                        lm_numpy_params(G.golden_config(), 2))
    want = float(JA.global_norm(_jax_tree(tree)))
    got = TA.global_norm(lm_params_from_numpy(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.item() == pytest.approx(want, rel=1e-6)


def test_tree_leaves_follow_jax_order():
    tree = {"b": {"z": 1, "a-b": 2, "a": {"y": 3}}, "a": 4, "a_b": {"c": 5}}
    assert tree_leaves(tree) == jax.tree.leaves(tree)


def test_flat_leaves_unflatten_and_tree_map():
    """``flat_leaves`` keeps insertion order and names paths as JAX's
    ``tree_flatten_with_path`` joins them; ``unflatten`` inverts it;
    ``tree_map`` walks several trees of one structure."""
    tree = {"b": {"z": 1, "a": {"y": 3}}, "a": 4}
    flat = flat_leaves(tree)
    assert list(flat.items()) == [("b/z", 1), ("b/a/y", 3), ("a", 4)]
    want = ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert sorted(flat) == sorted(want)
    assert unflatten(tree, flat) == tree
    assert unflatten(tree, {k: v * 10 for k, v in flat.items()}) == {
        "b": {"z": 10, "a": {"y": 30}}, "a": 40}
    assert tree_map(lambda x, y: x - y, tree, tree_map(lambda x: 1, tree)) == {
        "b": {"z": 0, "a": {"y": 2}}, "a": 3}
    assert tree_map(lambda x: -x, 5) == -5


def _leaf_case(dtype, clip_active, step, seed):
    rng = np.random.default_rng(seed)
    scale = 1.0 if clip_active else 1e-3
    p = rng.standard_normal((48, 80)).astype(np.float32)
    g = (rng.standard_normal((48, 80)) * scale).astype(np.float32)
    mu = (rng.standard_normal((48, 80)) * 0.01).astype(np.float32)
    nu = (np.abs(rng.standard_normal((48, 80))) * 1e-4).astype(np.float32)
    jp, jg = jnp.asarray(p).astype(dtype), jnp.asarray(g).astype(dtype)
    state = {"mu": {"w": jnp.asarray(mu)}, "nu": {"w": jnp.asarray(nu)},
             "step": jnp.asarray(step, jnp.int32)}
    return jp, jg, mu, nu, state


@pytest.mark.parametrize("step", [0, 3, 9])
@pytest.mark.parametrize("clip_active", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_update_equals_jax_bit_for_bit(dtype, clip_active, step):
    cfg = JA.AdamWConfig(**G.TRAIN_OPT)
    jp, jg, mu, nu, state = _leaf_case(dtype, clip_active, step, seed=step + 10 * clip_active)
    new_p, new_state, _ = JA.update(cfg, {"w": jp}, {"w": jg}, state)  # op by op
    # the reference's clip, lr and bias corrections, as its update takes them
    gnorm = JA.global_norm({"w": jg})
    clip = jnp.minimum(1.0, cfg.grad_clip / (gnorm + 1e-9))
    assert (float(clip) < 1.0) == clip_active
    s = jnp.asarray(step + 1, jnp.int32)
    consts = (clip, JA.schedule(cfg, s), 1 - cfg.beta1 ** s.astype(jnp.float32),
              1 - cfg.beta2 ** s.astype(jnp.float32))
    consts = [torch.from_numpy(np.array(c, np.float32)) for c in consts]
    tdt = getattr(torch, dtype)
    p, mu_out, nu_out = TA.leaf_update(
        TA.AdamWConfig(**G.TRAIN_OPT), torch.from_numpy(_f32(jp).copy()).to(tdt),
        torch.from_numpy(_f32(jg).copy()).to(tdt), torch.from_numpy(mu), torch.from_numpy(nu),
        *consts)
    assert p.dtype == tdt and mu_out.dtype == nu_out.dtype == torch.float32
    assert np.array_equal(_f32(new_p["w"]), _f32(p))
    assert np.array_equal(np.asarray(new_state["mu"]["w"]), mu_out.numpy())
    assert np.array_equal(np.asarray(new_state["nu"]["w"]), nu_out.numpy())


def _random_state(tree, seed):
    """An AdamW state over ``tree`` (numpy) some steps in: moments of a
    gradient's scale, step 5."""
    rng = np.random.default_rng(seed)
    moment = lambda s: jax.tree.map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) if s == "nu"
                   else rng.standard_normal(a.shape)).astype(np.float32) * np.float32(
            1e-4 if s == "nu" else 1e-2), tree)
    return {"mu": moment("mu"), "nu": moment("nu"), "step": np.array(5, np.int32)}


@pytest.mark.parametrize("clip_active", [True, False], ids=["clip", "no_clip"])
def test_update_on_the_reduced_tree_within_bounds(clip_active):
    cfg = G.golden_config()
    params = lm_numpy_params(cfg, 3)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * (
        0.1 if clip_active else 1e-4)).astype(np.float32), params)
    state = _random_state(params, 5)
    opt = JA.AdamWConfig(**G.TRAIN_OPT)
    want_p, want_s, want_m = jax.jit(lambda p, g, s: JA.update(opt, p, g, s))(
        _jax_tree(params), _jax_tree(grads), _jax_tree(state))
    t_state = opt_state_from_numpy(state)
    t_params, t_grads = lm_params_from_numpy(params), lm_params_from_numpy(grads)
    before = numpy_tree({"p": t_params, "g": t_grads, "s": t_state})
    got_p, got_s, got_m = TA.update(TA.AdamWConfig(**G.TRAIN_OPT), t_params, t_grads, t_state)
    # the arguments are left as they were
    after = flat_leaves(numpy_tree({"p": t_params, "g": t_grads, "s": t_state}))
    assert all(np.array_equal(v, after[k]) for k, v in flat_leaves(before).items())
    assert got_s["step"].dtype == torch.int32 and got_s["step"].item() == int(want_s["step"]) == 6
    assert got_m["lr"].item() == float(want_m["lr"])
    assert got_m["grad_norm"].item() == pytest.approx(float(want_m["grad_norm"]), rel=1e-6)
    assert (float(want_m["grad_norm"]) > opt.grad_clip) == clip_active
    _close(want_p, got_p, 1e-5)
    _close(want_s["mu"], got_s["mu"], 1e-5)
    _close(want_s["nu"], got_s["nu"], 1e-5)


def test_update_with_bfloat16_params_equals_jax_op_by_op():
    """bf16 params and gradients, the clip inactive (so the global norm's
    summation order cannot reach the step): the reference's op-by-op
    ``update`` bit for bit, the params kept in bf16."""
    cfg = G.golden_config()
    params = lm_numpy_params(cfg, 6)
    grads = jax.tree.map(lambda a: a * np.float32(0.01), params)
    opt = JA.AdamWConfig(**G.TRAIN_OPT)
    jp, jg = _jax_tree(params, jnp.bfloat16), _jax_tree(grads, jnp.bfloat16)
    want_p, want_s, want_m = JA.update(opt, jp, jg, JA.init(jp))
    assert float(want_m["grad_norm"]) < opt.grad_clip
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    tg = lm_params_from_numpy(jax.tree.map(np.asarray, jg))
    got_p, got_s, _ = TA.update(TA.AdamWConfig(**G.TRAIN_OPT), tp, tg, TA.init(tp))
    assert all(t.dtype == torch.bfloat16 for t in flat_leaves(got_p).values())
    _close(want_p, got_p, 0.0)
    _close(want_s["mu"], got_s["mu"], 0.0)
    _close(want_s["nu"], got_s["nu"], 0.0)


def _bounds_hold(want: dict, got: dict):
    """``got`` (port metrics) against ``want`` (JAX metrics) at the train
    golden's bounds."""
    w = {k: float(want[k]) for k in G.TRAIN_METRICS}
    g = {k: got[k].item() for k in G.TRAIN_METRICS}
    assert abs(g["loss"] - w["loss"]) <= G.TRAIN_LOSS_RTOL * abs(w["loss"]) + G.TRAIN_LOSS_ATOL
    assert abs(g["grad_norm"] - w["grad_norm"]) <= G.TRAIN_GNORM_RTOL * abs(w["grad_norm"])
    assert abs(g["lr"] - w["lr"]) <= G.TRAIN_LR_RTOL * abs(w["lr"])
    for k in ("ce", "aux"):
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("backend", G.TRAIN_VARIANTS)
def test_make_train_step_from_one_carried_state_equals_jax(backend):
    """Each of 4 steps taken by both packages from the state the JAX
    package reached (carried across by convert), on the golden's batches."""
    cfg = G.golden_config(backend)
    jcfg = jax_reduced(G.ARCH).replace(dtype="float32", remat=False, linear_backend=backend)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg), JA.AdamWConfig(**G.TRAIN_OPT)))
    tstep = make_train_step(build(cfg, device="cpu"), G.train_opt_config())
    params = _jax_tree(lm_numpy_params(cfg, G.SEED))
    opt = JA.init(params)
    for batch in G.train_batches():
        t_params = lm_params_from_numpy(jax.tree.map(np.asarray, params))
        t_opt = opt_state_from_numpy(jax.tree.map(np.asarray, opt))
        params, opt, want = jstep(params, opt, {"tokens": jnp.asarray(batch["tokens"])})
        got_p, got_o, got = tstep(t_params, t_opt, batch)
        _bounds_hold(want, got)
        assert got_o["step"].item() == int(opt["step"])
        for want_tree, got_tree in ((params, got_p), (opt["mu"], got_o["mu"]),
                                    (opt["nu"], got_o["nu"])):
            _close(want_tree, got_tree, G.TRAIN_ATOL)


def test_make_train_step_leaves_its_arguments_and_returns_device_tensors():
    cfg = G.golden_config()
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    opt = TA.init(params)
    before = numpy_tree({"p": params, "o": opt})
    step = make_train_step(build(cfg, device="cpu"), G.train_opt_config())
    new_p, new_o, metrics = step(params, opt, G.train_batches()[0])
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(isinstance(v, torch.Tensor) and v.shape == () and not v.requires_grad
               for v in metrics.values())
    assert not any(t.requires_grad for t in flat_leaves(params).values())
    assert not any(t.requires_grad for t in flat_leaves(new_p).values())
    after = flat_leaves(numpy_tree({"p": params, "o": opt}))
    assert all(np.array_equal(v, after[k]) for k, v in flat_leaves(before).items())
    assert new_o["step"].item() == 1 and opt["step"].item() == 0
    assert not torch.equal(new_p["layers"]["attn"]["wq"]["w"], params["layers"]["attn"]["wq"]["w"])


@pytest.mark.parametrize("backend", G.TRAIN_VARIANTS)
def test_train_golden_on_the_cpu(backend):
    cfg = G.golden_config(backend)
    got = G.train_run(build(cfg, device="cpu"), lm_params_from_numpy(lm_numpy_params(cfg, G.SEED)))
    want = G.load_train_golden()["variants"][backend]
    assert G.train_mismatch(want, got) is None


def test_train_golden_records_its_run():
    golden = G.load_train_golden()
    assert golden["steps"] == G.TRAIN_STEPS and golden["opt"] == G.TRAIN_OPT
    assert tuple(golden["data"]) == G.TRAIN_DATA and golden["remat"] is False
    for v in golden["variants"].values():
        assert all(len(v[k]) == G.TRAIN_STEPS for k in G.TRAIN_METRICS)
        # the warmup leg, the peak and the cosine leg all ran; the clip acted
        assert v["lr"][0] < v["lr"][1] == pytest.approx(G.TRAIN_OPT["lr"])
        assert v["lr"][3] < v["lr"][1]
        assert max(v["grad_norm"]) > 1.0
        assert v["loss"][-1] < v["loss"][0]


def test_train_mismatch_names_what_differs():
    want = G.load_train_golden()["variants"]["dense"]
    assert G.train_mismatch(want, want) is None
    off = {**want, "loss": [*want["loss"][:2], want["loss"][2] * (1 + 3e-4), want["loss"][3]]}
    assert "step 3 loss" in G.train_mismatch(want, off)
    off = {**want, "lr": [x * (1 + 1e-5) for x in want["lr"]]}
    assert "lr" in G.train_mismatch(want, off)
    path = "layers/attn/wq/w"
    leaf = want["params"][path]
    head = [row[:] for row in leaf["head"]]
    head[1][3] += 2 * G.TRAIN_ATOL * leaf["max_abs"]
    off = {**want, "params": {**want["params"], path: {**leaf, "head": head}}}
    assert path in G.train_mismatch(want, off) and "params" in G.train_mismatch(want, off)


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "jump_prob": 0.0},
                                {"seed": 1, "process_index": 1, "process_count": 2},
                                {"seed": 7, "jump_prob": 0.5, "prefetch": 1}])
def test_synthetic_lm_batches_equal_jax(kw):
    args = (97, 16, 4)
    ours, ref = SyntheticLM(*args, **kw), JaxSyntheticLM(*args, **kw)
    try:
        assert np.array_equal(ours.perm, ref.perm)
        for _ in range(5):
            a, b = next(ours), next(ref)
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            assert np.array_equal(a["tokens"], b["tokens"])
    finally:
        ours.close()
        ref.close()


def test_synthetic_lm_structure_learnable():
    data = SyntheticLM(64, 32, 8, seed=3, jump_prob=0.0)
    b = next(iter(data))
    data.close()
    assert b["tokens"].shape == (8, 33)
    # with jump_prob=0 the stream is exactly tok[t+1] = perm[tok[t]]
    toks = b["tokens"]
    assert (data.perm[toks[:, :-1]] == toks[:, 1:]).all()


def test_synthetic_lm_close_stops_the_worker():
    data = SyntheticLM(32, 8, 2, prefetch=1)
    next(data)
    data.close()
    assert not data._thread.is_alive()


def test_synthetic_lm_rejects_an_uneven_split():
    with pytest.raises(ValueError, match="process_count"):
        SyntheticLM(32, 8, 3, process_count=2)


def _run(step, params, opt, batches, steps, mgr=None, start=0):
    losses = []
    for i, batch in zip(range(start + 1, steps + 1), batches):
        params, opt, metrics = step(params, opt, batch)
        losses.append(metrics["loss"].item())
        if mgr is not None:
            mgr.maybe_save(i, {"params": params, "opt": opt})
    if mgr is not None:
        mgr.wait()
    return params, opt, losses


def test_crash_and_resume_equals_the_uninterrupted_run(tmp_path):
    """The reference's test_train_crash_resume_equivalence on the port's
    make_train_step and CheckpointManager: training interrupted at step 4
    and resumed from its checkpoint reaches the loss trajectory of the
    uninterrupted run."""
    cfg = G.golden_config()
    step = make_train_step(build(cfg, device="cpu"), TA.AdamWConfig(**G.TRAIN_OPT))
    init = lambda: lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
    rng = np.random.default_rng(0)
    data = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)}
            for _ in range(20)]

    params = init()
    _, _, full = _run(step, params, TA.init(params), itertools.cycle(data), 8,
                      CheckpointManager(str(tmp_path / "full"), every=100))

    mgr = CheckpointManager(str(tmp_path / "crash"), every=2)
    params = init()
    _run(step, params, TA.init(params), itertools.cycle(data), 4, mgr)  # then "crash"
    like = {"params": init(), "opt": TA.init(init())}
    start, restored = CheckpointManager(str(tmp_path / "crash"), every=100).resume_latest(
        like, device="cpu")
    assert start == 4
    batches = itertools.cycle(data)
    for _ in range(start):  # advance the stream to where the crash happened
        next(batches)
    _, _, resumed = _run(step, restored["params"], restored["opt"], batches, 8, start=start)
    np.testing.assert_allclose(resumed, full[4:], rtol=1e-4, atol=1e-5)
    assert restored["opt"]["step"].item() == 4
