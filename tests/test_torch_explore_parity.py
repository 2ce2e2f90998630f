"""The port's design-space explorer against the JAX package's, on the CPU.

For the same seed and a reduced grid (PE (1, 64) x SIMD (8, 600) x both
packings, no cache phase), the NID-MLP, the QUICK CNV and the two tiny
MLPs of ``tests/test_explore.py`` give equal layer shapes and grids (the
reduced, the quick and the default axes) and equal analytic point
records, field by field with ``==``; both sides are bit-exact.  The
port's frontier on the JAX record's points is the JAX frontier, and the
port's ``paper_sweeps`` copy equals the JAX package's.

``lut_bytes`` and ``ff_bytes`` are the one exception: the JAX package's
are a TPU VMEM working set, the port's the CUDA tile's shared memory and
int32 accumulators (``resource_model.mvu_resources``), so they are held to
the port's model.  The port builds with ``device="cpu"`` (the kernels'
plain versions); the JAX side runs its ``backend="xla"`` reference arm,
which builds the same design as its Pallas kernels in interpret mode.  No
record is written.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnv_bnn as jcnv, nid_mlp as jnid, paper_sweeps as jsweeps
from repro.core.ir import Node as JNode
from repro.explore import (
    ExploreConfig as JExploreConfig,
    LayerShape as JLayerShape,
    explore as jexplore,
    sweep_grid as jsweep_grid,
)
from repro_torch.configs import paper_sweeps
from repro_torch.core import resource_model
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node
from repro_torch.explore import (
    PARETO_MAXIMIZE,
    PARETO_MINIMIZE,
    ExploreConfig,
    LayerShape,
    explore,
    pareto_front,
    sweep_grid,
)
from repro_torch.explore import explorer

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, (n, k)).astype(np.float32)
            for k, n in zip(dims[:-1], dims[1:])]


def _mlp_graph(dims=(24, 16, 8), bits=2, seed=3) -> Graph:
    """The reference test's tiny MLP, on the port's IR."""
    g = Graph([Node("input", "in", {"shape": (dims[0],), "bits": bits})])
    for i, w in enumerate(_weights(dims, seed)):
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(w)}))
        if i < len(dims) - 2:
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def _jax_mlp_graph(dims=(24, 16, 8), bits=2, seed=3) -> list:
    """The same MLP on the JAX package's IR (the same numpy draws)."""
    g = [JNode("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, w in enumerate(_weights(dims, seed)):
        g.append(JNode("linear", f"fc{i}", {}, {"w": jnp.asarray(w)}))
        if i < len(dims) - 2:
            g.append(JNode("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


REDUCED = dict(pe_targets=(1, 64), simd_targets=(8, 600), packings=(False, True),
               reps=1, out_dir=None, cache_phase=False)
# the JAX side checks no build step (the port's side does): a record's
# analytic fields and its bit_exact do not depend on it
JAX_REDUCED = {**REDUCED, "verify": "off"}
# the analytic fields of a point and of each of its nodes that mean the
# same on both sides: the same build gives the same numbers.  lut_bytes and
# ff_bytes do not: the JAX package's are a TPU VMEM working set, the port's
# the CUDA tile's shared memory and accumulators (resource_model)
POINT_KEYS = ("point_id", "pe_target", "simd_target", "foldings", "packed",
              "interval_cycles", "latency_cycles", "bottleneck", "bram_bytes",
              "weight_bytes", "pe_simd_product")
NODE_KEYS = ("name", "op", "n", "k", "pe", "simd", "n_pixels", "cycles", "bram_bytes",
             "packed", "weight_bytes", "canonical_weight_bytes")
# (mode, weight_bits) of each workload
WORKLOADS = {"nid_mlp": ("standard", 2), "cnv_quick": ("xnor", 1),
             "tiny": ("standard", 4), "tiny_packed": ("binary", 1)}


def _configs(workload: str) -> tuple:
    """(JAX config, port config) of one workload on the reduced grid."""
    if workload == "nid_mlp":
        return (JExploreConfig(config="nid_mlp", batch=16, build_overrides={"backend": "xla"},
                               **JAX_REDUCED),
                ExploreConfig(config="nid_mlp", batch=16, build_overrides=CPU, **REDUCED))
    if workload == "cnv_quick":
        # the JAX package's config="cnv_quick" passes the seed positionally
        # to its keyword-only cnv_bnn.build_graph (a TypeError), so its side
        # gets the same graph and build kwargs explicitly
        jkw = dict(mode="xnor", weight_bits=1, act_bits=1, backend="xla")
        return (JExploreConfig(graph=jcnv.build_graph(jcnv.QUICK, seed=0), name="cnv_quick",
                               batch=4, build_overrides=jkw, **JAX_REDUCED),
                ExploreConfig(config="cnv_quick", batch=4, build_overrides=CPU, **REDUCED))
    mode, weight_bits = WORKLOADS[workload]
    kw = dict(mode=mode, weight_bits=weight_bits, act_bits=2)
    return (JExploreConfig(graph=_jax_mlp_graph(), name=workload, batch=16,
                           build_overrides={**kw, "backend": "xla"}, **JAX_REDUCED),
            ExploreConfig(graph=_mlp_graph(), name=workload, batch=16,
                          build_overrides={**kw, **CPU}, **REDUCED))


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def records(request):
    """(JAX record, port record, workload) on the reduced grid."""
    jcfg, tcfg = _configs(request.param)
    return jexplore(jcfg), explore(tcfg), request.param


def test_layer_shapes_and_grids_equal_jax(records):
    jrec, trec, _ = records
    assert trec["grid"] == jrec["grid"] and trec["n_points"] == jrec["n_points"]
    jshapes = [JLayerShape(**d) for d in jrec["grid"]["layers"]]
    tshapes = [LayerShape(**d) for d in trec["grid"]["layers"]]
    # the reduced grid, the quick grid and the default power-of-4 axes
    for axes in ((REDUCED["pe_targets"], REDUCED["simd_targets"]),
                 (explorer.QUICK_GRID["pe_targets"], explorer.QUICK_GRID["simd_targets"]),
                 (None, None)):
        assert ([p.as_dict() for p in sweep_grid(tshapes, *axes, packings=(False, True))]
                == [p.as_dict() for p in jsweep_grid(jshapes, *axes, packings=(False, True))])


def test_point_records_equal_jax(records):
    jrec, trec, workload = records
    mode, weight_bits = WORKLOADS[workload]
    assert jrec["bit_exact"] is True and trec["bit_exact"] is True
    assert trec["packed_points"] == jrec["packed_points"]
    for jp, tp in zip(jrec["points"], trec["points"], strict=True):
        assert {k: tp[k] for k in POINT_KEYS} == {k: jp[k] for k in POINT_KEYS}
        assert ([{k: n[k] for k in NODE_KEYS} for n in tp["nodes"]]
                == [{k: n[k] for k in NODE_KEYS} for n in jp["nodes"]])
        assert tp["bit_exact"] is True and tp["samples_per_s"] > 0
        for n in tp["nodes"]:
            res = resource_model.mvu_resources(
                n["n"], n["k"], Folding(n["pe"], n["simd"]), mode=mode,
                weight_bits=weight_bits, n_pixels=n["n_pixels"], packed=n["packed"])
            assert (n["lut_bytes"], n["ff_bytes"]) == (res.lut_bytes, res.ff_bytes)
            assert n["measured_s"] > 0
        for key in ("lut_bytes", "ff_bytes"):
            assert tp[key] == sum(n[key] for n in tp["nodes"])


def test_pareto_front_on_jax_points_equals_jax(records):
    jrec, trec, _ = records
    front = pareto_front(jrec["points"], maximize=PARETO_MAXIMIZE, minimize=PARETO_MINIMIZE)
    assert [jrec["points"][i]["point_id"] for i in front] == jrec["pareto_front"]
    assert [p["point_id"] for p in trec["points"] if p["pareto"]] == trec["pareto_front"]
    assert trec["packed_pareto_points"] == sum(p["pareto"] and p["packed"] for p in trec["points"])
    # a point of the least weight bytes is never dominated by one of more:
    # where only packed points store that little, one of them survives (an
    # xnor point's weights are words either way, so its twins tie)
    least = min(p["weight_bytes"] for p in trec["points"])
    if all(p["packed"] for p in trec["points"] if p["weight_bytes"] == least):
        assert trec["packed_pareto_points"] >= 1


def test_paper_sweeps_equal_jax():
    assert paper_sweeps.CONFIGURATIONS == jsweeps.CONFIGURATIONS
    assert paper_sweeps.LARGE_CONFIGS == jsweeps.LARGE_CONFIGS
    assert paper_sweeps.SIMD_TYPES == jsweeps.SIMD_TYPES
    for cfg_id in jsweeps.CONFIGURATIONS:
        rows = list(paper_sweeps.expand(cfg_id))
        assert rows == list(jsweeps.expand(cfg_id)) and rows
        for row, _ in rows:
            assert paper_sweeps.mvu_shape(row) == jsweeps.mvu_shape(row)
    for row in jsweeps.LARGE_CONFIGS:
        assert paper_sweeps.mvu_shape(row) == jsweeps.mvu_shape(row)


def test_nid_quick_grid_equals_jax():
    """The grid the card sweeps: NID at PE (1, 8, 64) x SIMD (8, 64, 600) x
    both packings, the same points as the JAX package's."""
    jshapes = [JLayerShape(f"fc{i}.mvu", n, k, 1) for i, (k, n, _, _) in enumerate(jnid.LAYERS)]
    tshapes = [LayerShape(s.name, s.n, s.k, s.n_pixels) for s in jshapes]
    axes = (explorer.QUICK_GRID["pe_targets"], explorer.QUICK_GRID["simd_targets"])
    tgrid = sweep_grid(tshapes, *axes, packings=(False, True))
    assert [p.as_dict() for p in tgrid] == [
        p.as_dict() for p in jsweep_grid(jshapes, *axes, packings=(False, True))]
    assert len(tgrid) == 18
    assert {p.foldings[0] for p in tgrid} == {
        Folding(pe, simd) for pe in (1, 8, 64) for simd in (8, 60, 600)}
