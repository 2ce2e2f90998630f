"""The port's lowering passes, schedule and stream plan against the JAX package.

Both packages lower ``nid_mlp.build_graph(0)`` (the same numpy draws) with
the same passes; after each pass every node's integer weights, thresholds,
``out_scale``, folding and MVUConfig fields (the kernel blocks aside) must
be equal, and so must the dataflow schedule and ``FusedEngine.plan``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import nid_mlp as jnid
from repro.core import dataflow as jdf, engine as jeng, lowering as jlow
from repro.core.autotune import ScheduleCache
from repro.core.mvu import MVUConfig as JConfig
from repro_torch.configs import nid_mlp as tnid
from repro_torch.core import dataflow as tdf, engine as teng, lowering as tlow
from repro_torch.core.mvu import MVUConfig as TConfig

BACKENDS = {"pallas": "cuda", "xla": "torch"}


def _fold(graph, folds, config_cls):
    """Explicit Table 6 foldings, as the build's ``fold`` step applies them."""
    mvus = [n for n in graph if n.op == "mvu"]
    for node, f in zip(mvus, folds):
        node.attrs["config"] = config_cls(**{**node.attrs["config"].__dict__, "folding": f})
    return graph


def _passes(low, nid, config_cls, mode, weight_bits):
    g = low.lower_to_mvu(nid.build_graph(0), mode=mode,
                         weight_bits=weight_bits, act_bits=2)
    out = {"lower": g}
    out["finalize"] = g = low.finalize(g)
    out["fold"] = g = _fold(g, nid.foldings(), config_cls)
    out["fuse_epilogues"] = low.fuse_epilogues(g)
    out["streamline"] = low.streamline(out["lower"])
    return out


@pytest.fixture(scope="module", params=[("standard", 2), ("standard", 8), ("xnor", 1),
                                        ("binary", 1)], ids=["w2", "w8", "xnor", "binary"])
def graphs(request):
    mode, wb = request.param
    return (_passes(jlow, jnid, JConfig, mode, wb), _passes(tlow, tnid, TConfig, mode, wb))


def _arr(x):
    if x is None:
        return None
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    # the JAX package's packed uint32 words are the port's int32 bit patterns
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same_array(got, want):
    got, want = _arr(got), _arr(want)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _config_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("blocks", None)  # the kernel tile is the device's own (JAX's field)
    d["backend"] = BACKENDS.get(d["backend"], d["backend"])
    return d


@pytest.mark.parametrize("stage", ["lower", "finalize", "fold", "fuse_epilogues",
                                   "streamline"])
def test_pass_outputs_equal_jax(graphs, stage):
    jg, tg = graphs[0][stage], graphs[1][stage]
    assert [(n.op, n.name, n.inputs) for n in tg] == [(n.op, n.name, n.inputs) for n in jg]
    for jn, tn in zip(jg, tg):
        assert tn.attrs.get("fused") == jn.attrs.get("fused")
        if jn.op != "mvu":
            for k, v in jn.params.items():
                _same_array(tn.params[k], v)
            continue
        assert _config_fields(tn.attrs["config"]) == _config_fields(jn.attrs["config"])
        if "w_float" in jn.params:
            _same_array(tn.params["w_float"], jn.params["w_float"])
        else:
            jp, tp = jn.params["mvu"], tn.params["mvu"]
            for field in ("weights", "thresholds", "out_scale"):
                _same_array(getattr(tp, field), getattr(jp, field))


def test_balanced_folding_equals_jax(graphs):
    jg = jlow.apply_folding(jlow.finalize(graphs[0]["lower"]))
    tg = tlow.apply_folding(tlow.finalize(graphs[1]["lower"]))
    def folds(g):
        return [dataclasses.astuple(n.attrs["config"].folding) for n in g if n.op == "mvu"]

    assert folds(tg) == folds(jg)


@pytest.mark.parametrize("stage", ["fold", "fuse_epilogues"])
def test_schedule_equals_jax(graphs, stage):
    js, ts = jdf.schedule(graphs[0][stage]), tdf.schedule(graphs[1][stage])
    keys = ("name", "cycles", "fifo_depth", "n_pixels", "block_m", "branch")
    assert ([tuple(getattr(s, k) for k in keys) for s in ts.stages]
            == [tuple(getattr(s, k) for k in keys) for s in js.stages])
    # the FPGA model terms; lut/ff describe each device's own kernel tile
    res = ("cycles", "macs", "weight_mem_depth", "input_buffer_depth", "bram_bytes",
           "weight_bytes", "canonical_weight_bytes")
    for j, t in zip(js.stages, ts.stages):
        assert [getattr(t.resources, k) for k in res] == [getattr(j.resources, k) for k in res]
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("total_lut_bytes"), tsum.pop("total_lut_bytes")
    assert tsum == jsum
    assert tdf.interval_seconds(ts) == jdf.interval_seconds(js, cache=ScheduleCache())


@pytest.mark.parametrize("batch", [1, 3, 128, 257, 4096])
def test_stream_plan_equals_jax(graphs, batch):
    je = jeng.FusedEngine(graphs[0]["fold"])
    te = teng.FusedEngine(graphs[1]["fold"])
    assert dataclasses.asdict(te.plan(batch)) == dataclasses.asdict(je.plan(batch))


def test_engine_buffers_follow_module_moves(graphs):
    te = teng.FusedEngine(graphs[1]["fold"])
    names = {n for n, _ in te.named_buffers()}
    assert "stage_params.1.weights" in names and "stage_params.2.gamma" not in names
    assert te.device == torch.device("cpu")
    moved = te.to(torch.float64)  # dtype-only move keeps the integer buffers
    words = graphs[1]["fold"][1].attrs["config"].mode == "xnor"  # packed int32 words
    assert moved.stage_params[1].weights.dtype == (torch.int32 if words else torch.int8)
