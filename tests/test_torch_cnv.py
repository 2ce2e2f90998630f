"""The CNV slice (``configs/cnv_bnn.py`` through ``build``) against the JAX package.

Both packages build the same CNV graphs (the same numpy draws) in the
three datapaths of the fused conv kernel -- ``xnor`` (W1A1), ``binary``
(+/-1 weights, 2-bit activations) and ``standard`` (2-bit weights and
activations) -- and must agree exactly:

* every lowering pass on a small CNV (conv -> swu + mvu, finalize, fold,
  fuse_epilogues, fuse_swu): node lists, each layer's integer weights or
  packed words, thresholds and scale; the schedule and the stream plan;
* ``build(target="engine", device="cpu")`` of the small CNV (whose 7x7
  map meets an odd-size max-pool) and of ``QUICK``: ``acc(x)`` equals the
  JAX package's ``acc(x)`` and the port's own ``acc.interpret(x)``;
* the FULL CNV's stream plan (one image per microbatch) and, on the CPU,
  the golden digests ``scripts/cnv_golden.py`` made with the JAX package.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.build import build as jbuild
from repro.configs import cnv_bnn as jcnv
from repro.core import dataflow as jdf, engine as jeng, lowering as jlow
from repro.core.ir import Node as JNode
from repro_torch import convert
from repro_torch.build import build as tbuild
from repro_torch.configs import cnv_bnn as tcnv, golden
from repro_torch.core import dataflow as tdf, engine as teng, lowering as tlow
from repro_torch.core.ir import Graph as TGraph, Node as TNode
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# mode -> (weight_bits, act_bits)
MODES = {"xnor": (1, 1), "binary": (1, 2), "standard": (2, 2)}
# 11x11 -> conv 9x9 -> conv 7x7 -> 2x2 pool 3x3 (the odd row and column dropped)
SMALL = dict(image=11, channels=(4, 4), pool_after=(1,), fc=(8, 3))
BACKENDS = {"pallas": "cuda", "xla": "torch"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(mode: str, shape: dict | None = None):
    wb, ab = MODES[mode]
    if shape is None:
        return (dataclasses.replace(jcnv.QUICK, weight_bits=wb, act_bits=ab),
                dataclasses.replace(tcnv.QUICK, weight_bits=wb, act_bits=ab))
    return (jcnv.CNVSpec(**shape, weight_bits=wb, act_bits=ab),
            tcnv.CNVSpec(**shape, weight_bits=wb, act_bits=ab))


def _arr(x):
    if x is None:
        return None
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    # the JAX package's packed uint32 words are the port's int32 bit patterns
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(got, want):
    got, want = _arr(got), _arr(want)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _passes(low, graph, mode):
    wb, ab = MODES[mode]
    out = {"lower": low.lower_to_mvu(graph, mode=mode, weight_bits=wb, act_bits=ab)}
    out["finalize"] = low.finalize(out["lower"])
    out["fold"] = low.apply_folding(out["finalize"])
    out["fuse_epilogues"] = low.fuse_epilogues(out["fold"])
    out["fuse_swu"] = low.fuse_swu(out["fuse_epilogues"])
    return out


@pytest.fixture(scope="module", params=list(MODES))
def lowered(request):
    js, ts = _specs(request.param, SMALL)
    return (_passes(jlow, jcnv.build_graph(js, seed=2), request.param),
            _passes(tlow, tcnv.build_graph(ts, seed=2), request.param))


def _config_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("blocks", None)  # the kernel tile is the device's own (JAX's field)
    d["backend"] = BACKENDS.get(d["backend"], d["backend"])
    return d


@pytest.mark.parametrize("stage", ["lower", "finalize", "fold", "fuse_epilogues",
                                   "fuse_swu"])
def test_pass_outputs_equal_jax(lowered, stage):
    jg, tg = lowered[0][stage], lowered[1][stage]
    assert [(n.op, n.name, n.inputs) for n in tg] == [(n.op, n.name, n.inputs) for n in jg]
    ops_ = [n.op for n in tg]
    if stage == "fuse_swu":
        assert ops_.count("conv_mvu") == 2 and "swu" not in ops_
    else:
        assert ops_.count("swu") == 2 and "conv_mvu" not in ops_
    for jn, tn in zip(jg, tg):
        assert tn.attrs.get("fused") == jn.attrs.get("fused")
        for key in ("kernel", "stride", "pad", "size"):
            assert tn.attrs.get(key) == jn.attrs.get(key)
        if jn.op not in ("mvu", "conv_mvu"):
            for k, v in jn.params.items():
                _same(tn.params[k], v)
            continue
        assert _config_fields(tn.attrs["config"]) == _config_fields(jn.attrs["config"])
        if "w_float" in jn.params:
            _same(tn.params["w_float"], jn.params["w_float"])
        else:
            jp, tp = jn.params["mvu"], tn.params["mvu"]
            for field in ("weights", "thresholds", "out_scale"):
                _same(getattr(tp, field), getattr(jp, field))


@pytest.mark.parametrize("stage", ["fold", "fuse_swu"])
def test_schedule_equals_jax(lowered, stage):
    js, ts = jdf.schedule(lowered[0][stage]), tdf.schedule(lowered[1][stage])
    keys = ("name", "cycles", "fifo_depth", "n_pixels", "block_m", "branch")
    assert ([tuple(getattr(s, k) for k in keys) for s in ts.stages]
            == [tuple(getattr(s, k) for k in keys) for s in js.stages])
    res = ("cycles", "macs", "weight_mem_depth", "input_buffer_depth", "bram_bytes",
           "weight_bytes", "canonical_weight_bytes")
    for j, t in zip(js.stages, ts.stages):
        assert [getattr(t.resources, k) for k in res] == [getattr(j.resources, k) for k in res]
    jsum, tsum = js.summary(), ts.summary()
    jsum.pop("total_lut_bytes"), tsum.pop("total_lut_bytes")
    assert tsum == jsum


@pytest.mark.parametrize("batch", [1, 2, 3, 7, 64])
def test_stream_plan_equals_jax(lowered, batch):
    je, te = jeng.FusedEngine(lowered[0]["fold"]), teng.FusedEngine(lowered[1]["fold"])
    assert [n.op for n in te.graph] == [n.op for n in je.graph]
    assert dataclasses.asdict(te.plan(batch)) == dataclasses.asdict(je.plan(batch))


def test_full_cnv_stream_plan_equals_jax():
    """conv0's 900 output pixels exceed block_m = 128, so both packages
    stream one image per microbatch: B x (6 conv + 3 dense) launches."""
    # FULL is the FINN CNV's own W1A1: the xnor datapath
    je = jeng.FusedEngine(jlow.apply_folding(jlow.finalize(jlow.lower_to_mvu(
        jcnv.build_graph(jcnv.FULL), mode="xnor", weight_bits=1, act_bits=1))))
    te = teng.FusedEngine(tlow.apply_folding(tlow.finalize(tlow.lower_to_mvu(
        tcnv.build_graph(tcnv.FULL), mode="xnor", weight_bits=1, act_bits=1))))
    assert [n.op for n in te.graph].count("conv_mvu") == 6
    for batch in (1, 2, 64, 256):
        tp = te.plan(batch)
        assert dataclasses.asdict(tp) == dataclasses.asdict(je.plan(batch))
        assert (tp.n_micro, tp.microbatch) == (batch, 1)


def _x(spec, batch, seed):
    return tcnv.images(batch, spec.act_bits, seed, image=spec.image)


@pytest.fixture(scope="module", params=[(s, m) for s in ("small", "quick") for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def builds(request):
    shape, mode = request.param
    js, ts = _specs(mode, SMALL if shape == "small" else None)
    wb, ab = MODES[mode]
    kw = dict(target="engine", mode=mode, weight_bits=wb, act_bits=ab)
    # the JAX package verifies its own build in its own tests
    jacc = jbuild(jcnv.build_graph(js, seed=2), tune="off", verify="off", **kw)
    tacc = tbuild(tcnv.build_graph(ts, seed=2), device="cpu", **kw)
    return jacc, tacc, ts


def test_build_equals_jax_and_interpreter(builds):
    jacc, tacc, spec = builds
    x = _x(spec, 5, seed=5)
    launches = ops.launch_counts()
    y = tacc(torch.from_numpy(x))
    assert ops.launch_counts() == launches  # CPU tensors never launch a kernel
    want = np.asarray(jacc(jnp.asarray(x)))
    assert y.dtype == torch.float32 and tuple(y.shape) == (5, spec.fc[-1])
    _same(y, want)
    _same(tacc.interpret(torch.from_numpy(x)), want)
    ops_ = [n.op for n in tacc.graph]
    assert ops_.count("conv_mvu") == len(spec.channels) and "swu" not in ops_
    assert [n.op for n in tacc.engine.graph] == [n.op for n in jacc.engine.graph]


def test_build_report_equals_jax(builds):
    jacc, tacc, _ = builds
    assert tacc.report.step_names == jacc.report.step_names
    keys = ("name", "op", "mode", "n", "k", "pe", "simd", "n_pixels", "cycles",
            "bram_bytes", "inputs", "branch", "packed", "weight_bytes")
    assert ([[getattr(n, k) for k in keys] for n in tacc.report.nodes]
            == [[getattr(n, k) for k in keys] for n in jacc.report.nodes])
    assert [n.op for n in tacc.report.nodes][:2] == ["conv_mvu", "conv_mvu"]
    assert tacc.report.predicted_interval_s == jacc.report.predicted_interval_s
    # every graph rewrite after the first executable one was verified
    assert [s.name for s in tacc.report.steps if s.verified] == [
        "finalize", "fold", "fuse_epilogues", "fuse_swu", "pack_weights", "engine"]


def _plain_nodes(graph):
    """The framework-free description ``convert.graph_from_numpy`` takes,
    made from a JAX graph with ``np.asarray`` on every param."""
    out = []
    for n in graph:
        attrs = dict(n.attrs)
        params = {}
        for k, v in n.params.items():
            if k == "mvu":
                params[k] = {f: None if getattr(v, f) is None else np.asarray(getattr(v, f))
                             for f in ("weights", "thresholds", "out_scale")}
            else:
                params[k] = np.asarray(v)
        if "config" in attrs:
            attrs["config"] = dataclasses.asdict(attrs["config"])
        out.append({"op": n.op, "name": n.name, "attrs": attrs, "inputs": n.inputs,
                    "params": params})
    return out


def test_conv_graphs_carried_across_give_the_same_output(builds):
    """The raw float CNV (conv weights (Kd, Kd, Cin, Cout), maxpool and
    flatten attrs) and the JAX build's fused graph (conv_mvu nodes),
    carried across with ``convert.graph_from_numpy``."""
    jacc, tacc, spec = builds
    x = _x(spec, 3, seed=9)
    want = np.asarray(jacc(jnp.asarray(x)))
    raw = convert.graph_from_numpy(_plain_nodes(jcnv.build_graph(
        jcnv.CNVSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}),
        seed=2)))
    cfg = tacc.config
    acc = tbuild(raw, target="engine", mode=cfg.mode, weight_bits=cfg.weight_bits,
                 act_bits=cfg.act_bits, device="cpu")
    _same(acc(torch.from_numpy(x)), want)
    fused = convert.graph_from_numpy(_plain_nodes(jacc.graph))
    assert [n.op for n in fused].count("conv_mvu") == len(spec.channels)
    _same(teng.FusedEngine(fused)(torch.from_numpy(x)), want)


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2), (2, 1)])
def test_maxpool_equals_jax_on_odd_maps(size, stride):
    """VALID windows over a 7x9 integer map with negatives: the ragged edge
    is dropped, and no init value leaks into an integer stream."""
    x = np.random.default_rng(size * 10 + stride).integers(-9, 9, (2, 7, 9, 3))
    x = x.astype(np.int32)
    attrs = {"size": size, "stride": stride}
    jg = [JNode("input", "in", {"shape": (7, 9, 3)}), JNode("maxpool", "p", attrs)]
    tg = TGraph([TNode("input", "in", {"shape": (7, 9, 3)}), TNode("maxpool", "p", attrs)])
    _same(tdf.execute(tg, torch.from_numpy(x)), jdf.execute(jg, jnp.asarray(x)))


# --------------------------------------------------------------- golden
@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "cnv_golden", os.path.join(ROOT, "scripts", "cnv_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_golden_file_holds_the_script_variants(script):
    golden_ = tcnv.load_golden()
    assert sorted(golden_) == sorted(script.VARIANTS) == sorted(MODES)
    for v, d in golden_.items():
        assert d["build"] == script.VARIANTS[v]
        assert (d["seed"], d["data_seed"], d["batch"]) == (script.SEED, script.DATA_SEED,
                                                           script.BATCH)
        assert d["output_shape"] == [script.BATCH, 10] and len(d["layers"]) == 9


@pytest.mark.parametrize("variant", list(MODES))
def test_port_reproduces_the_golden_digest(variant):
    """The FULL CNV at its published widths, built by the port on the CPU,
    gives the JAX package's digest on the golden batch."""
    g = tcnv.load_golden()[variant]
    kw = g["build"]
    acc = tbuild(tcnv.build_graph(tcnv.spec_for(kw), seed=g["seed"]), target="engine",
                 device="cpu", **kw)
    x = torch.from_numpy(tcnv.images(g["batch"], kw["act_bits"], g["data_seed"]))
    y = acc(x)
    assert golden.digest_like(g, y.numpy(), acc.graph) == g
