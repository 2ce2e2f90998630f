"""The GPipe pipeline executor and ``as_pipeline`` against the JAX package.

The port's ``distributed/pipeline.py`` runs the JAX package's GPipe
schedule with one CUDA stream a stage; on the CPU the same ticks run in
order.  These tests hold it to the JAX package on the same numpy inputs:
the accounting helpers exactly, the float schedule and its gradients to
JAX's ``sequential_reference`` (and to JAX's ``pipeline_apply`` on a
one-device mesh), ``FusedEngine.as_pipeline`` of the JAX test's 2-bit
chain bit for bit to the JAX engine's ``eng(x)`` at 1, 2 and 4 stages
(and to JAX's own ``as_pipeline`` at one stage, the mesh this host's jax
can run), the rejections with the JAX package's messages, and the traced
run's lanes.  The card's streams are checked in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.pipeline as jpipe
from repro.build import default_steps as jdefault_steps
from repro.core import lowering as jlowering
from repro.core.engine import FusedEngine as JFusedEngine
from repro.core.ir import Node as JNode
from repro.telemetry import Tracer as JTracer
from repro_torch.build import build, default_steps
from repro_torch.configs import mvu_chain
from repro_torch.core import lowering
from repro_torch.core.engine import FusedEngine
from repro_torch.core.ir import Graph, Node
from repro_torch.distributed import pipeline as pipe
from repro_torch.kernels import ops
from repro_torch.telemetry import Tracer

SMALL = mvu_chain.SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return jax.make_mesh((1,), ("stage",))


# ------------------------------------------------------------ accounting
def test_stage_params_split_equals_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(8, 3, 5)).astype(np.float32),
              "t": rng.integers(-9, 9, (8, 5, 3)).astype(np.int32)}
    for s in (1, 2, 4, 8):
        got = pipe.stage_params_split({k: torch.from_numpy(v) for k, v in params.items()}, s)
        want = jpipe.stage_params_split({k: jnp.asarray(v) for k, v in params.items()}, s)
        for k in params:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(AssertionError):
        pipe.stage_params_split({"w": torch.zeros(6, 2)}, 4)
    with pytest.raises(AssertionError):
        jpipe.stage_params_split({"w": jnp.zeros((6, 2))}, 4)


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (1, 8), (2, 8), (3, 4), (4, 8),
                                              (8, 32), (4, 4)])
def test_pipeline_occupancy_equals_jax(n_stages, n_micro):
    assert pipe.pipeline_occupancy(n_stages, n_micro) == jpipe.pipeline_occupancy(
        n_stages, n_micro)


@pytest.mark.parametrize("n_stages,n_micro", [(3, 4), (4, 8), (1, 2)])
def test_emit_schedule_spans_equals_jax(n_stages, n_micro):
    tr, jtr = Tracer(), JTracer()
    occ = pipe.emit_schedule_spans(tr, n_stages, n_micro, 0.5, 6.5)
    jocc = jpipe.emit_schedule_spans(jtr, n_stages, n_micro, 0.5, 6.5)
    assert occ == jocc

    def view(t):
        return [(s["name"], s["cat"], s["tid"], s["t0"], s["t1"], s["args"])
                for s in t.spans(cat="pipeline")]

    assert view(tr) == view(jtr)
    assert len(view(tr)) == n_stages * occ["ticks"]


# -------------------------------------------------------- float schedule
L, D = 8, 16


def _float_case():
    rng = np.random.default_rng(0)
    w = (rng.normal(0, 1, (L, D, D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(0, 0.1, (L, D)).astype(np.float32)
    x = rng.normal(0, 1, (8, 4, D)).astype(np.float32)
    return w, b, x


def _torch_layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _jax_layer(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_float_pipeline_matches_jax(n_stages):
    w, b, x = _float_case()
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = pipe.pipeline_apply(_torch_layer, pipe.stage_params_split(params, n_stages),
                              torch.from_numpy(x), ["cpu"] * n_stages)
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = np.asarray(jpipe.sequential_reference(_jax_layer, jparams, jnp.asarray(x)))
    assert got.shape == (8, 4, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pipe.sequential_reference(_torch_layer, params, torch.from_numpy(x)).numpy(),
        want, rtol=1e-5, atol=1e-5)
    if n_stages == 1:  # the mesh this host's jax runs the reference's schedule on
        jgot = np.asarray(jpipe.pipeline_apply(
            _jax_layer, jpipe.stage_params_split(jparams, 1), jnp.asarray(x), _mesh()))
        np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_float_pipeline_gradients_match_jax(n_stages):
    w, b, x = _float_case()
    params = {"w": torch.from_numpy(w).requires_grad_(),
              "b": torch.from_numpy(b).requires_grad_()}
    y = pipe.pipeline_apply(_torch_layer, pipe.stage_params_split(params, n_stages),
                            torch.from_numpy(x), ["cpu"] * n_stages)
    gw, gb = torch.autograd.grad((y ** 2).sum(), (params["w"], params["b"]))

    def loss_ref(p):
        return jnp.sum(jpipe.sequential_reference(_jax_layer, p, jnp.asarray(x)) ** 2)

    g_ref = jax.grad(loss_ref)({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    np.testing.assert_allclose(gw.numpy(), np.asarray(g_ref["w"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(g_ref["b"]), rtol=1e-4, atol=1e-4)


def test_pipeline_apply_rejects_a_short_stream_and_a_stage_mismatch():
    params = pipe.stage_params_split({"w": torch.zeros(4, D, D), "b": torch.zeros(4, D)}, 4)
    with pytest.raises(ValueError, match="need >= n_stages microbatches"):
        pipe.pipeline_apply(_torch_layer, params, torch.zeros(3, 2, D), ["cpu"] * 4)
    with pytest.raises(ValueError, match="hold 4 stages, but 2 devices"):
        pipe.pipeline_apply(_torch_layer, params, torch.zeros(8, 2, D), ["cpu"] * 2)


def test_run_stages_takes_placed_stages_once_for_many_runs():
    """``place_stages`` puts each stage's layers on its device once; every
    ``run_stages`` over them equals ``pipeline_apply``, with or without
    stage streams, and a stage count that is not the devices' raises."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.normal(0, 1, (8, D, D)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(0, 1, (8, D)).astype(np.float32))}
    x = torch.from_numpy(rng.normal(0, 1, (6, 2, D)).astype(np.float32))
    split = pipe.stage_params_split(params, 4)
    stages = pipe.place_stages(split, ["cpu"] * 4)
    assert [len(layers) for layers in stages] == [2] * 4
    assert all(a.is_contiguous() for layers in stages for p in layers for a in p.values())
    want = pipe.pipeline_apply(_torch_layer, split, x, ["cpu"] * 4)
    for streams in (True, False):
        got = pipe.run_stages(_torch_layer, stages, x, ["cpu"] * 4, stage_streams=streams)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="4 stages, but 2 devices"):
        pipe.run_stages(_torch_layer, stages, x, ["cpu"] * 2)


def test_pipeline_apply_launches_nothing_in_a_bubble():
    calls = []

    def layer(p, h):
        calls.append(int(p["i"]))
        return h + p["i"]

    params = pipe.stage_params_split({"i": torch.arange(8)}, 4)
    x = torch.zeros(5, 2, dtype=torch.int64)
    y = pipe.pipeline_apply(layer, params, x, ["cpu"] * 4)
    assert len(calls) == 5 * 8  # n_micro x L layer calls: none in the 3 + 3 bubble ticks
    assert torch.equal(y, torch.full((5, 2), 28))
    # tick 0 runs stage 0 alone (layers 0, 1); tick 1 stage 1, then stage 0
    assert calls[:6] == [0, 1, 2, 3, 0, 1]


# --------------------------------------------------- the 2-bit MVU chain
def _chain(seed: int = 0, bn: bool = True):
    """The JAX test's chain (d = 32, four layers, 2 bits) in both packages
    from one draw, and its (8, 4, d) input."""
    rng = np.random.default_rng(seed)
    d, layers, bits = SMALL["d"], SMALL["layers"], SMALL["bits"]
    g = mvu_chain.build_graph(rng, d, layers, bits)
    x = rng.integers(0, 2 ** bits, (SMALL["n_micro"], SMALL["microbatch"], d)).astype(np.int32)
    jg = [JNode("input", "in", {"shape": (d,), "bits": bits})]
    for node in g[1:]:
        jg.append(JNode(node.op, node.name, dict(node.attrs),
                        {k: jnp.asarray(v.numpy()) for k, v in node.params.items()}))
    if not bn:
        g = Graph([n for n in g if n.op != "batchnorm"])
        jg = [n for n in jg if n.op != "batchnorm"]
    return g, jg, x


@functools.lru_cache(maxsize=None)
def _engines(mode: str, bn: bool = True):
    """The port's ``target="pipeline"`` build and the JAX engine of one chain."""
    g, jg, x = _chain(bn=bn)
    kw = dict(mode=mode, weight_bits=4, act_bits=SMALL["bits"])
    acc = build(g, target="pipeline", device="cpu", **kw)
    jeng = JFusedEngine(jlowering.finalize(jlowering.lower_to_mvu(jg, **kw)))
    return acc, jeng, x


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("mode", ["standard", "binary"])
def test_as_pipeline_equals_the_jax_engine(mode, n_stages):
    acc, jeng, x = _engines(mode)
    n_micro, mb, d = x.shape
    want = np.asarray(jeng(jnp.asarray(x.reshape(n_micro * mb, d)))).reshape(n_micro, mb, -1)
    ops.reset_launch_counts()
    got = acc.as_pipeline(["cpu"] * n_stages)(torch.from_numpy(x))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)  # CPU: the plain versions
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, acc(torch.from_numpy(x).reshape(n_micro * mb, d)).reshape(got.shape))
    if n_stages == 1:
        jgot = np.asarray(jeng.as_pipeline(_mesh())(jnp.asarray(x)))
        assert np.array_equal(got.numpy(), jgot)


def test_as_pipeline_runs_the_first_nodes_tile(monkeypatch):
    """Every stage launches the tile the first node's schedule maps to."""
    acc, _, _ = _engines("standard")
    seen = []
    real = ops.mvu_layer_fn

    def spy(mode, **kw):
        seen.append((mode, kw))
        return real(mode, **kw)

    cfg = [n for n in acc.engine.graph if n.op == "mvu"][0].attrs["config"]
    monkeypatch.setattr(ops, "mvu_layer_fn", spy)
    acc.as_pipeline(["cpu"])
    assert seen == [("standard", {"backend": "cuda", **cfg.kernel_blocks()})]


def test_as_pipeline_traced_occupancy():
    """Traced as_pipeline at four stages: equal to the untraced run, one
    ``pipeline.run`` span, one lane a stage, the static occupancy."""
    acc, _, x = _engines("standard", bn=False)
    tr = Tracer()
    got = acc.as_pipeline(["cpu"] * 4, tracer=tr)(torch.from_numpy(x))
    assert torch.equal(got, acc.as_pipeline(["cpu"] * 4)(torch.from_numpy(x)))
    runs = tr.spans(name="pipeline.run")
    assert len(runs) == 1
    assert runs[0]["args"]["n_stages"] == 4 and runs[0]["args"]["n_micro"] == 8
    assert abs(runs[0]["args"]["occupancy"] - 8 / 11) < 1e-9
    assert runs[0]["args"]["bubble_ticks"] == 3
    lanes = {sp["tid"] for sp in tr.spans(cat="pipeline") if isinstance(sp["tid"], str)}
    assert lanes == {f"stage{s}" for s in range(4)}
    names = [e["args"]["name"] for e in tr.to_chrome()["traceEvents"] if e["ph"] == "M"]
    assert sorted(names) == [f"stage{s}" for s in range(4)]


def test_as_pipeline_rejects_a_short_stream():
    acc, _, x = _engines("standard")
    with pytest.raises(ValueError, match="need >= n_stages microbatches"):
        acc.as_pipeline(["cpu"] * 4)(torch.from_numpy(x[:3]))


def test_pipeline_target_runs_the_engine_steps():
    assert default_steps("pipeline") == default_steps("engine") == jdefault_steps("pipeline")


def test_a_cuda_stage_without_a_card_raises():
    """A CUDA stage launches the hand kernel or raises: no CPU retreat."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    acc, _, _ = _engines("standard")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        acc.as_pipeline(["cuda"])


# ------------------------------------------------------------ rejections
def _mlp(pkg, rng, dims, bits, with_bn=True):
    node, arr = (Node, torch.from_numpy) if pkg == "torch" else (JNode, jnp.asarray)
    g = [node("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(node("linear", f"fc{i}", {}, {"w": arr(w)}))
        if with_bn and i < len(dims) - 2:
            g.append(node("batchnorm", f"bn{i}", {}, {
                "gamma": arr(rng.uniform(0.5, 1.5, n).astype(np.float32)),
                "beta": arr(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
                "mean": arr(rng.normal(0, 1, n).astype(np.float32)),
                "var": arr(rng.uniform(0.5, 2, n).astype(np.float32)),
            }))
            g.append(node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def _rejected(pkg, what):
    """The engine of one unstackable graph of the JAX package's test
    (``tests/test_distributed.py``), in package ``pkg``."""
    low, eng, node, arr = ((lowering, FusedEngine, Node, torch.from_numpy) if pkg == "torch"
                           else (jlowering, JFusedEngine, JNode, jnp.asarray))
    rng = np.random.default_rng(31)
    if what == "conv":
        g = [node("input", "in", {"shape": (6, 6, 3), "bits": 2}),
             node("conv", "c0", {"kernel": 3, "stride": 1, "pad": 0},
                  {"w": arr(rng.normal(0, 0.5, (3, 3, 3, 4)).astype(np.float32))})]
        return eng(low.finalize(low.lower_to_mvu(g, mode="standard", weight_bits=4,
                                                 act_bits=2)))
    dims, mode, bits = {"shapes": ([24, 16, 8], "standard", 2),
                        "xnor": ([32, 32, 32], "xnor", 1),
                        "epilogue": ([16, 16, 16], "standard", 2)}[what]
    g = _mlp(pkg, rng, dims, bits)
    return eng(low.finalize(low.lower_to_mvu(g, mode=mode, weight_bits=4, act_bits=bits)))


@pytest.mark.parametrize("what,match", [("conv", "pure MVU chain"), ("shapes", "homogeneous"),
                                        ("xnor", "xnor"), ("epilogue", "epilogue")])
def test_as_pipeline_rejects_unstackable_graphs_as_jax_does(what, match):
    with pytest.raises(ValueError, match=match) as got:
        _rejected("torch", what).as_pipeline(["cpu"])
    with pytest.raises(ValueError) as want:
        _rejected("jax", what).as_pipeline(_mesh())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["standard", "binary"])
def test_as_pipeline_rejects_packed_storage(mode):
    """The JAX package's ``as_pipeline`` hands a packed chain's storage to the
    canonical kernel, whose shape assertion fails; the port says why."""
    g, _, _ = _chain()
    acc = build(g, target="pipeline", device="cpu", mode=mode, weight_bits=2,
                act_bits=SMALL["bits"], pack="always")
    assert all(n.attrs["config"].packed for n in acc.engine.graph if n.op == "mvu")
    with pytest.raises(ValueError, match="packed weight storage"):
        acc.as_pipeline(["cpu"])
