"""The slice end to end at full NID width (600->64->64->64->1), on the CPU.

``repro_torch.build.build(..., device="cpu")`` runs every kernel's plain
version; its ``acc(x)`` must equal its own ``acc.interpret(x)`` and the
JAX package's ``acc(x)`` (Pallas in interpret mode) bit for bit, at the
paper's 2-bit weights and at 8-bit weights.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.build import build as jbuild
from repro.configs import nid_mlp as jnid
from repro.core import autotune as jautotune
from repro.data import nid
from repro_torch import convert
from repro_torch.build import BuildError, VerificationError, build as tbuild
from repro_torch.configs import nid_mlp as tnid
from repro_torch.core import dataflow as tdf
from repro_torch.core.engine import FusedEngine
from repro_torch.core.mvu import KernelBlocks
from repro_torch.kernels import mvu_int as K

BATCHES = ["nid512", 1, 3, 257]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_both(weight_bits):
    kw = dict(target="engine", mode="standard", weight_bits=weight_bits, act_bits=2)
    jacc = jbuild(jnid.build_graph(0), folding=jnid.foldings(), **kw)
    tacc = tbuild(tnid.build_graph(0), folding=tnid.foldings(), device="cpu", **kw)
    return jacc, tacc


@pytest.fixture(scope="module", params=[2, 8], ids=["w2", "w8"])
def accs(request):
    return _build_both(request.param)


def _x(batch):
    if batch == "nid512":
        return nid.make_dataset(512, seed=1)[0]
    return nid.make_dataset(batch, seed=batch)[0]


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", BATCHES)
def test_engine_equals_interpreter_and_jax(accs, batch):
    jacc, tacc = accs
    x = _x(batch)
    launches = K.LAUNCHES
    y = tacc(torch.from_numpy(x))
    assert K.LAUNCHES == launches  # CPU tensors never launch the kernel
    want = jacc(x)
    _same(y, want)
    _same(tacc.interpret(torch.from_numpy(x)), want)
    assert tuple(y.shape) == (x.shape[0], 1)


def test_step_names_and_reports_equal_jax(accs):
    jacc, tacc = accs
    assert tacc.report.step_names == jacc.report.step_names
    assert [s.verified for s in tacc.report.steps] == [s.verified for s in jacc.report.steps]
    keys = ("name", "op", "mode", "n", "k", "pe", "simd", "n_pixels", "cycles",
            "bram_bytes", "inputs", "branch", "packed", "weight_bytes")
    assert ([[getattr(n, k) for k in keys] for n in tacc.report.nodes]
            == [[getattr(n, k) for k in keys] for n in jacc.report.nodes])
    assert tacc.report.predicted_interval_s == jacc.report.predicted_interval_s


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


def test_graphs_carried_across_give_the_same_output(accs):
    jacc, _ = accs
    wb = jacc.config.weight_bits
    x = _x("nid512")
    want = jacc(x)
    # the raw float graph, built by the port
    raw = convert.graph_from_numpy(_plain_nodes(jnid.build_graph(0)), device="cpu")
    tacc = tbuild(raw, target="engine", mode="standard", weight_bits=wb, act_bits=2,
                  folding=tnid.foldings(), device="cpu")
    _same(tacc(torch.from_numpy(x)), want)
    # the JAX build's fused, lowered graph, run by the port's engine and interpreter
    fused = convert.graph_from_numpy(_plain_nodes(jacc.graph), device="cpu")
    assert {n.attrs["config"].backend for n in fused if n.op == "mvu"} == {"cuda"}
    _same(FusedEngine(fused)(torch.from_numpy(x)), want)
    _same(tdf.execute(fused, torch.from_numpy(x)), want)


def test_convert_rejects_a_tuned_kernel_tile(accs):
    """A tuned tile carries across as a KernelBlocks; one with a field the
    port does not know is rejected."""
    jacc, _ = accs
    nodes = _plain_nodes(jacc.graph)
    convert.graph_from_numpy(nodes)  # blocks=None carries across
    mvu = next(n for n in nodes if n["op"] == "mvu")
    mvu["attrs"]["config"]["blocks"] = {"block_m": 8, "block_n": 128, "block_k": 128}
    fused = convert.graph_from_numpy(nodes)
    assert fused[1].attrs["config"].blocks == KernelBlocks(block_m=8, block_n=128,
                                                           block_k=128)
    mvu["attrs"]["config"]["blocks"]["block_q"] = 4
    with pytest.raises(TypeError, match="block_q"):
        convert.graph_from_numpy(nodes)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_tuned_jax_graph_carried_across_gives_the_same_output(accs, packed):
    """A JAX build whose nodes carry tuned schedules (``tune="cache"`` from
    hand-written entries: other bursts, the packed datapath on fc0 where
    the weights pack) converts through ``graph_from_numpy``; the port's
    engine over it plans and computes as the JAX engine does."""
    jacc0, _ = accs
    wb = jacc0.config.weight_bits
    keys = list(dict.fromkeys(jautotune.graph_node_keys(jacc0.graph)))  # fc1, fc2: one key
    entries = {key: {"backend": "pallas", "block_m": bm, "block_n": 16, "block_k": 32,
                     "block_kw": 8}
               for key, bm in zip(keys, (64, 32, 256))}
    if packed and wb == 2:
        entries[keys[0]]["packed"] = True
    jacc = jbuild(jnid.build_graph(0), folding=jnid.foldings(), target="engine",
                  mode="standard", weight_bits=wb, act_bits=2, tune="cache",
                  cache=jautotune.ScheduleCache(entries))
    fused = convert.graph_from_numpy(_plain_nodes(jacc.graph), device="cpu")
    cfgs = [n.attrs["config"] for n in fused if n.op == "mvu"]
    assert [c.blocks.block_m for c in cfgs] == [64, 32, 32, 256]
    assert [c.packed for c in cfgs] == [packed and wb == 2, False, False, False]
    engine = FusedEngine(fused)
    for b in (1, 100, 512):
        assert dataclasses.astuple(engine.plan(b)) == dataclasses.astuple(jacc.plan(b))
    x = _x("nid512")
    _same(engine(torch.from_numpy(x)), jacc(x))


def test_report_json_only_with_output_dir(tmp_path):
    g = tnid.build_graph(0)
    acc = tbuild(g, target="interpret", weight_bits=2, act_bits=2, device="cpu")
    assert acc.report.path is None
    acc = tbuild(g, target="engine", weight_bits=2, act_bits=2, device="cpu",
                 name="nid", output_dir=str(tmp_path))
    assert acc.report.path == os.path.join(str(tmp_path), "nid_build_report.json")
    assert os.listdir(tmp_path) == ["nid_build_report.json"]


def test_verification_names_the_step_that_broke_the_graph():
    def corrupt(state):  # returns a new graph whose first MVU has negated weights
        out, done = [], False
        for n in state.graph:
            if n.op == "mvu" and not done:
                p = n.params["mvu"]
                n = dataclasses.replace(n, params={"mvu": dataclasses.replace(
                    p, weights=-p.weights)})
                done = True
            out.append(n)
        return out

    with pytest.raises(VerificationError, match="'corrupt'") as err:
        tbuild(tnid.build_graph(0), weight_bits=2, act_bits=2, device="cpu",
               steps=["validate", "lower", "finalize", corrupt])
    assert err.value.node == "fc0.mvu"


def test_explicit_folding_must_cover_every_stage():
    with pytest.raises(BuildError, match="3 entries"):
        tbuild(tnid.build_graph(0), folding=tnid.foldings()[:3], device="cpu")
