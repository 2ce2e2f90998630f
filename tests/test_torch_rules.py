"""The port's ground rules: torch alone, no fallback, later slices refuse.

* ``repro_torch`` and every submodule import with no ``jax``, ``jaxlib`` or
  ``repro`` module loaded (checked in a fresh interpreter), and no file of
  the port nor ``chip_smoke.py`` imports one (checked on the source).
* A tensor that is neither on the CPU nor on a CUDA device makes the kernel
  wrapper raise instead of returning the plain version's result.
* ``build()`` without a device raises when CUDA is absent.
* What belongs to a later slice raises NotImplementedError; what an
  earlier one refused and a later one ported runs.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.build import BuildError, build
from repro_torch.configs import nid_mlp
from repro_torch.core import engine, lowering
from repro_torch.core.ir import Graph, Node
from repro_torch.core.mvu import MVUConfig, MVULayer
from repro_torch.kernels import mvu_int as K, ops
from repro_torch.telemetry import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_port_imports_with_torch_alone():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_meta_tensor_raises_instead_of_falling_back():
    a = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((8, 16), dtype=torch.int8, device="meta")
    launches = K.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.mvu(a, w)
    assert K.LAUNCHES == launches


def test_mixed_devices_raise():
    a = torch.zeros((4, 16), dtype=torch.int32)
    w = torch.empty((8, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        ops.mvu(a, w)


def test_build_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BuildError, match="device='cpu'"):
        build(nid_mlp.build_graph(0), weight_bits=2, act_bits=2)


def _conv_graph():
    rng = np.random.default_rng(0)
    return Graph([
        Node("input", "in", {"shape": (6, 6, 2), "bits": 2}),
        Node("conv", "c0", {"kernel": 3, "stride": 1, "pad": 0},
             {"w": torch.from_numpy(rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32))}),
    ])


@pytest.mark.parametrize("what", [
    "tune_cache", "target_pipeline", "engine_as_pipeline", "engine_tune"])
def test_later_slices_raise_not_implemented(what):
    g = nid_mlp.build_graph(0)
    overrides = {"tune_cache": {"tune": "cache"}, "target_pipeline": {"target": "pipeline"}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what in overrides:
            build(g, device="cpu", **overrides[what])
        elif what == "engine_tune":
            engine.FusedEngine(g, tune="cache")
        else:
            acc = build(g, weight_bits=2, act_bits=2, device="cpu")
            getattr(acc, what.split("_", 1)[1])()


@pytest.mark.parametrize("what", ["mode_binary", "mode_xnor", "pack_always",
                                  "ops_packed", "ops_xnor", "layer_xnor", "conv_node",
                                  "engine_profile", "target_serving", "acc_serve",
                                  "drift_monitor_engine", "drift_monitor_serving"])
def test_binarized_and_packed_paths_run(what):
    """What the later-slices test refused before the binarized, packed and
    conv kernels, the telemetry and serving were ported now runs (on the
    CPU: the kernels' plain versions); ``drift_monitor`` still refuses a
    build that did not calibrate."""
    g = nid_mlp.build_graph(0)
    x = torch.randint(0, 4, (5, 600), dtype=torch.int32)
    a = torch.randint(0, 4, (2, 8), dtype=torch.int32)
    if what == "conv_node":
        lowered = lowering.lower_to_mvu(_conv_graph())
        assert [n.op for n in lowered] == ["input", "swu", "mvu"]
        acc = build(_conv_graph(), weight_bits=2, act_bits=2, device="cpu")
        assert [n.op for n in acc.graph] == ["input", "conv_mvu"]
        xc = torch.randint(0, 4, (3, 6, 6, 2), dtype=torch.int32)
        assert torch.equal(acc(xc), acc.interpret(xc)) and tuple(acc(xc).shape) == (3, 4, 4, 4)
    elif what.startswith(("mode_", "pack_")):
        kw = {"mode_binary": {"mode": "binary", "act_bits": 4},
              "mode_xnor": {"mode": "xnor", "weight_bits": 1, "act_bits": 1},
              "pack_always": {"pack": "always", "weight_bits": 2, "act_bits": 2}}[what]
        acc = build(g, device="cpu", **kw)
        assert torch.equal(acc(x), acc.interpret(x)) and tuple(acc(x).shape) == (5, 1)
        assert all(n.packed == (what == "pack_always") for n in acc.report.nodes)
    elif what in ("target_serving", "acc_serve"):
        acc = build(g, target="serving", weight_bits=2, act_bits=2, device="cpu")
        assert acc.report.step_names[-1] == "calibrate"
        assert acc.calibration["s_per_cycle"] > 0 and acc.report.cycle_time_source == "measured"
        assert list(acc.cache.entries) == ["cycletime|cpu"]
        if what == "acc_serve":
            batcher = acc.serve(batch_buckets=(1, 8))
            rids = batcher.submit_batch(x.numpy())
            batcher.drain(timeout=60)
            got = torch.from_numpy(np.stack([batcher.results[r].out for r in rids]))
            assert torch.equal(got, acc(x))
    elif what.startswith("drift_monitor"):
        target = what.rsplit("_", 1)[1]
        acc = build(g, target=target, weight_bits=2, act_bits=2, device="cpu")
        if target == "engine":
            with pytest.raises(BuildError, match="calibrated cycle time"):
                acc.drift_monitor()
        else:
            drift = acc.drift_monitor()
            assert set(drift.predictions) == {st.name for st in acc.schedule.stages}
    elif what == "engine_profile":
        acc = build(g, weight_bits=2, act_bits=2, device="cpu")
        y, plan = acc.profile(x, Tracer())
        assert torch.equal(y, acc(x)) and plan == acc.plan(5)
    elif what == "ops_packed":
        w = torch.zeros((4, 2), dtype=torch.uint8)  # 8 zero 2-bit lanes a row
        assert torch.equal(ops.mvu(a, w, packed=True, k_bits=8), torch.zeros((2, 4), dtype=torch.int32))
    elif what == "ops_xnor":
        # all-zero words: every bit agrees, so the bipolar dot is +K
        words = torch.zeros((2, 1), dtype=torch.int32)
        out = ops.mvu(words, torch.zeros((4, 1), dtype=torch.int32), "xnor", k_bits=8)
        assert torch.equal(out, torch.full((2, 4), 8, dtype=torch.int32))
    else:
        p = MVULayer(MVUConfig(8, 4, mode="xnor")).init_params(torch.Generator())
        assert p.weights.dtype == torch.int32 and tuple(p.weights.shape) == (4, 1)


def test_init_params_and_device_moves():
    layer = MVULayer(MVUConfig(64, 8, weight_bits=2))
    p = layer.init_params(torch.Generator().manual_seed(0))
    assert p.weights.dtype == torch.int8 and int(p.weights.abs().max()) <= 1
    q = p.to("meta")
    assert q.weights.device.type == "meta" and q.thresholds is None
    x = torch.randint(0, 4, (3, 5, 64), dtype=torch.int32)
    assert tuple(layer(p, x).shape) == (3, 5, 8)
