"""Branched (fan-out/fan-in) graphs through the port, against the JAX package.

Mirrors ``tests/test_dag_build.py`` on the CPU (the kernels' plain
versions; JAX's Pallas kernels in interpret mode): the residual MLP builds
bit-exact with JAX for the ``interpret`` and ``engine`` targets, its
BuildReport records the same topology, branches and join schedule, a
corrupted arm fails verification naming the node and its branch, random
legal DAGs give JAX's ``dataflow.execute`` output through the port's
engine and interpreter in every mode, and the residual engine equals the
JAX golden digest at batch 4096.  Every comparison is exact.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_dag_build as jdag  # tests/ is on sys.path under pytest
import torch_random_dag as tdag
from repro.build import build as jbuild
from repro.configs import residual_mlp as jres
from repro.core import dataflow as jdf, ir as jir, lowering as jlow
from repro.data import nid
from repro_torch.build import BuildReport, VerificationError, build as tbuild, default_steps
from repro_torch.configs import golden as golden_mod, residual_mlp as tres
from repro_torch.core import dataflow as tdf, ir as tir
from repro_torch.core.engine import FusedEngine
from repro_torch.core.ir import Node

KW = dict(mode="standard", weight_bits=2, act_bits=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(batch=16, k=600, bits=2, seed=0):
    return np.random.default_rng(seed).integers(0, 2**bits, (batch, k)).astype(np.int32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _build_both(target, **kw):
    kw = {**KW, **kw}
    jacc = jbuild(jres.build_graph(), target=target, folding=jres.foldings(),
                  name="residual_mlp", **kw)
    tacc = tbuild(tres.build_graph(), target=target, folding=tres.foldings(),
                  name="residual_mlp", device="cpu", **kw)
    return jacc, tacc


@pytest.fixture(scope="module")
def engines():
    return _build_both("engine")


# ------------------------------------------------------------------ config
def test_residual_config_equals_jax():
    assert tres.LAYERS == jres.LAYERS
    assert (tres.WEIGHT_BITS, tres.INPUT_BITS) == (jres.WEIGHT_BITS, jres.INPUT_BITS)
    assert [(f.pe, f.simd) for f in tres.foldings()] == \
        [(f.pe, f.simd) for f in jres.foldings()]
    for seed in (0, 5):
        jg, tg = jres.build_graph(seed), tres.build_graph(seed)
        assert [(n.op, n.name, n.attrs, n.inputs) for n in tg] == \
            [(n.op, n.name, n.attrs, n.inputs) for n in jg]
        for jn, tn in zip(jg, tg):
            assert sorted(tn.params) == sorted(jn.params)
            for k, v in jn.params.items():
                _same(tn.params[k], v)


def test_toposort_and_branches_equal_jax(engines):
    jacc, tacc = engines
    assert [n.name for n in tir.toposort(tres.build_graph())] == \
        [n.name for n in jir.toposort(jres.build_graph())]
    assert [n.name for n in tir.toposort(tacc.engine.graph)] == \
        [n.name for n in jir.toposort(jacc.engine.graph)]
    assert tir.branch_labels(tacc.graph) == jir.branch_labels(jacc.graph)


# ------------------------------------------------------------ build targets
@pytest.mark.parametrize("target", ["interpret", "engine"])
def test_residual_mlp_builds_bit_exact(target):
    jacc, tacc = _build_both(target)
    assert all(s.verified in (True, None) for s in tacc.report.steps)
    assert any(s.verified for s in tacc.report.steps)
    assert tacc.report.step_names == jacc.report.step_names
    x = _x()
    y = tacc(torch.from_numpy(x))
    _same(y, jacc(jnp.asarray(x)))
    _same(y, tacc.interpret(torch.from_numpy(x)))
    assert tuple(y.shape) == (16, 1)


def test_join_sum_leaves_the_two_bit_range_on_both_arms():
    """The ``add`` join sums two 2-bit streams: its int32 levels reach 6,
    beyond what fc2's input had in the NID chain.  The unpacked kernels
    keep int32 A, so no narrowing applies: the reference's xla arm, its
    Pallas arm and both port arms agree."""
    x = nid.make_dataset(512, seed=1)[0]
    outs = []
    for jb, tb in (("pallas", "cuda"), ("xla", "torch")):
        jacc = jbuild(jres.build_graph(), target="engine", folding=jres.foldings(),
                      backend=jb, **KW)
        tacc = tbuild(tres.build_graph(), target="engine", folding=tres.foldings(),
                      backend=tb, device="cpu", **KW)
        res = tdf.trace(tacc.ref_graph, torch.from_numpy(x))["res"]
        jres_env = jdf.trace(jacc.ref_graph, jnp.asarray(x))["res"]
        _same(res, jres_env)
        assert int(res.max()) == 6 and res.dtype == torch.int32
        y = tacc(torch.from_numpy(x))
        _same(y, jacc(jnp.asarray(x)))
        outs.append(y)
    assert torch.equal(outs[0], outs[1])


def test_report_records_topology_and_branches(engines):
    jacc, tacc = engines
    rep, jrep = tacc.report, jacc.report
    assert ["fc0.mvu", "fc1.mvu"] in rep.edges
    assert ["fc0.mvu", "res"] in rep.edges
    assert ["fc1.mvu", "res"] in rep.edges
    assert rep.edges == jrep.edges
    nodes = {n.name: n for n in rep.nodes}
    assert nodes["fc1.mvu"].branch == "fc0.mvu/fc1.mvu"
    assert nodes["fc0.mvu"].branch == "main"
    assert nodes["fc2.mvu"].branch == "main"
    assert nodes["fc1.mvu"].inputs == ["fc0.mvu"]
    assert nodes["fc2.mvu"].inputs == ["res"]
    assert {n.name: (n.branch, n.inputs) for n in rep.nodes} == \
        {n.name: (n.branch, n.inputs) for n in jrep.nodes}
    joins = rep.schedule["joins"]
    assert joins[0]["name"] == "res" and joins[0]["fifo_depth"] >= 2
    assert joins == json.loads(json.dumps(jrep.schedule["joins"]))
    rep2 = BuildReport.from_json(rep.to_json())
    assert rep2.edges == rep.edges
    assert rep2.schedule["joins"] == joins
    assert {n.name: n.branch for n in rep2.nodes} == {n.name: n.branch for n in rep.nodes}


def test_verification_error_names_node_and_branch():
    """Corrupting ONE arm of the fork fails the build with the node id and
    its branch path in the message, as in the JAX package."""

    def corrupt_branch(state):
        g = []
        for n in state.graph:
            if n.name == "fc1.mvu" and "mvu" in n.params:
                p = n.params["mvu"]
                bad = dataclasses.replace(p, weights=p.weights + 1)
                g.append(Node(n.op, n.name, dict(n.attrs), {"mvu": bad},
                              inputs=n.inputs))
            else:
                g.append(n)
        return g

    steps = default_steps("engine")
    steps.insert(steps.index("dataflow"), corrupt_branch)
    with pytest.raises(VerificationError,
                       match=r"first divergent node: 'fc1\.mvu' on branch "
                             r"'fc0\.mvu/fc1\.mvu'") as ei:
        tbuild(tres.build_graph(), folding=tres.foldings(), steps=steps,
               device="cpu", **KW)
    assert ei.value.step == "corrupt_branch"
    assert ei.value.node == "fc1.mvu"
    assert ei.value.branch == "fc0.mvu/fc1.mvu"


def test_residual_golden_digest_on_the_cpu():
    gd = tres.load_golden()
    assert gd["build"] == KW and gd["batch"] == 4096
    acc = tbuild(tres.build_graph(gd["seed"]), target="engine", tune="off",
                 folding=tres.foldings(), device="cpu", **gd["build"])
    x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0])
    y = acc(x)
    assert acc.plan(gd["batch"]).n_micro == 32
    assert golden_mod.digest_like(gd, y.numpy(), acc.graph) == gd


# ------------------------------------------------- random legal DAG sweep
def _assert_dag_equals_jax(seed: int, depth: int, mode: str, bits: int):
    jg = jdag._random_dag(seed, depth, bits=bits)
    jlow_g = jlow.finalize(jlow.streamline(jlow.lower_to_mvu(
        jg, mode=mode, weight_bits=bits, act_bits=bits)))
    low, x = tdag.dag_case(seed, depth, mode, bits)
    assert [(n.op, n.name, n.inputs) for n in low] == \
        [(n.op, n.name, n.inputs) for n in jlow_g]
    want = np.asarray(jdf.execute(jlow_g, jnp.asarray(x)))
    _same(FusedEngine(low)(torch.from_numpy(x)), want)
    _same(tdf.execute(low, torch.from_numpy(x)), want)


@pytest.mark.parametrize("mode,bits", tdag.MODES)
def test_random_dags_engine_and_interpreter_equal_jax(mode, bits):
    for seed, depth in tdag.SWEEP:
        _assert_dag_equals_jax(seed, depth, mode, bits)


def test_random_dags_property():
    """Hypothesis-widened version of the deterministic sweep (skipped when
    hypothesis is absent, as the reference's is)."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hypothesis.settings(max_examples=10, deadline=None, database=None)
    @hypothesis.given(seed=st.integers(0, 10_000), depth=st.integers(1, 6),
                      mode=st.sampled_from(["standard", "binary", "xnor"]))
    def run(seed, depth, mode):
        _assert_dag_equals_jax(seed, depth, mode, 1 if mode == "xnor" else 2)

    run()
