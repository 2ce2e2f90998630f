"""The port's ground rules: torch alone, no fallback, later slices refuse.

* ``repro_torch`` and every submodule import with no ``jax``, ``jaxlib`` or
  ``repro`` module loaded (checked in a fresh interpreter), and no file of
  the port, nor ``chip_smoke.py``, nor an ``examples/torch_*.py`` imports
  one (checked on the source).
* A tensor that is neither on the CPU nor on a CUDA device makes the kernel
  wrapper raise instead of returning the plain version's result.
* ``build()`` without a device raises when CUDA is absent.
* What belongs to a later slice raises NotImplementedError; what an
  earlier one refused and a later one ported runs.
* The autotuner's candidates run the hand kernels (``backend="cuda"``),
  never the plain reference, and no ``try`` guards a candidate's build or
  launch.
* No ``try`` encloses the engine's CUDA-graph capture or replay, and no
  switch turns capture off; no module on the launch path reads a device
  value on the host (``.item()``, ``.cpu()``, ``.tolist()``), which a
  capture forbids.
"""

import ast
import glob
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.build import BuildError, build
from repro_torch.configs import nid_mlp
from repro_torch.core import autotune, engine, lowering
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
    yield from glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))


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


@pytest.mark.parametrize("what", ["target_pipeline", "engine_as_pipeline"])
def test_later_slices_raise_not_implemented(what):
    """What this test once refused as a later slice, the pipeline, now runs:
    a ``target="pipeline"`` build on the CPU gives an engine whose
    ``as_pipeline`` equals ``acc(x)``; the NID, whose layers differ in
    shape, is refused with the JAX package's "homogeneous" error, and no
    path raises ``NotImplementedError``."""
    g = nid_mlp.build_graph(0)
    if what == "target_pipeline":
        from repro_torch.configs import mvu_chain

        rng = np.random.default_rng(0)
        acc = build(mvu_chain.build_graph(rng, 16, 4, 2), device="cpu", target="pipeline",
                    weight_bits=2, act_bits=2)
        x = torch.from_numpy(rng.integers(0, 4, (4, 3, 16)).astype(np.int32))
        assert torch.equal(acc.as_pipeline(["cpu"] * 2)(x),
                           acc(x.reshape(12, 16)).reshape(4, 3, -1))
    else:
        acc = build(g, weight_bits=2, act_bits=2, device="cpu")
        with pytest.raises(ValueError, match="homogeneous"):
            acc.as_pipeline(["cpu"])


@pytest.mark.parametrize("what", ["mode_binary", "mode_xnor", "pack_always",
                                  "ops_packed", "ops_xnor", "layer_xnor", "conv_node",
                                  "engine_profile", "target_serving", "acc_serve",
                                  "drift_monitor_engine", "drift_monitor_serving",
                                  "tune_cache", "engine_tune"])
def test_binarized_and_packed_paths_run(what, tmp_path, monkeypatch):
    """What the later-slices test refused before the binarized, packed and
    conv kernels, the telemetry, serving and the autotuner were ported now
    runs (on the CPU: the kernels' plain versions); ``drift_monitor`` still
    refuses a build that did not calibrate."""
    g = nid_mlp.build_graph(0)
    x = torch.randint(0, 4, (5, 600), dtype=torch.int32)
    a = torch.randint(0, 4, (2, 8), dtype=torch.int32)
    if what in ("tune_cache", "engine_tune"):
        # a tuned CPU build runs: tune="auto" fills the cache, tune="cache"
        # (the build, or an engine over its graph) replays it unmeasured
        monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))
        cache = autotune.ScheduleCache()
        kw = dict(weight_bits=2, act_bits=2, device="cpu")
        tuned = build(g, tune="auto", cache=cache, tune_kwargs={"reps": 1, "sample_m": 8}, **kw)
        assert len(cache) == 3 and torch.equal(tuned(x), tuned.interpret(x))
        monkeypatch.setattr(autotune, "paired_timer", None)  # a timer call would raise
        if what == "tune_cache":
            acc = build(g, tune="cache", cache=cache, **kw)
            assert acc.report.tune["cache_hits"] == 4 and all(n.tuned for n in acc.report.nodes)
            assert torch.equal(acc(x), tuned(x))
        else:
            eng = engine.FusedEngine(tuned.graph, tune="cache", cache=cache)
            assert all(n.attrs["config"].blocks is not None for n in eng.graph if n.op == "mvu")
            assert torch.equal(eng(x), tuned(x))
    elif what == "conv_node":
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


def test_no_candidate_runs_the_plain_reference(monkeypatch):
    """Every candidate the search enumerates, and every launch it makes, is
    ``backend="cuda"``: on a card that is the hand kernel (a CUDA tensor
    launches it or raises), never the plain reference of ``backend="torch"``.
    Here the launches take the CPU's plain versions of the same wrappers."""
    from repro_torch.configs import cnv_bnn

    for cfg, conv, shape in [
            (MVUConfig(600, 64, weight_bits=2), None, None),
            (MVUConfig(64, 1, mode="binary"), None, None),
            (MVUConfig(96, 24, mode="xnor"), None, None),
            (MVUConfig(27, 8), {"kernel": 3, "stride": 1, "pad": 0}, (8, 8, 3))]:
        cands = autotune.enumerate_candidates(cfg, in_shape=shape, conv=conv)
        assert cands and {c.backend for c in cands} == {"cuda"}
    backends = []
    for name in ("mvu", "conv_mvu"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, **kw: backends.append(
            kw["backend"]) or _fn(*a, **kw))
    timed = []
    timer = (lambda fa, fb, *a, **kw: timed.append(1) or (1.0, 0.5, 2.0))
    for mode, bits in (("standard", 2), ("binary", 2), ("xnor", 1)):
        acc = build(nid_mlp.build_graph(0), weight_bits=bits, act_bits=bits, mode=mode,
                    device="cpu")
        autotune.tune_graph(acc.graph, cache=autotune.ScheduleCache(), mode="auto",
                            timer=timer, sample_m=8, reps=1)
    spec = cnv_bnn.spec_for({"act_bits": 2, "weight_bits": 2}, cnv_bnn.QUICK)
    acc = build(cnv_bnn.build_graph(spec, seed=0), weight_bits=2, act_bits=2, device="cpu")
    autotune.tune_graph(acc.graph, cache=autotune.ScheduleCache(), mode="auto",
                        timer=timer, sample_m=8, reps=1)
    assert timed and backends and set(backends) == {"cuda"}


def test_no_try_guards_a_candidate():
    """A kernel that fails to build or launch fails the tune: the search
    module holds no ``try`` at all."""
    path = os.path.join(PORT, "core", "autotune.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_no_try_encloses_the_capture_or_the_replay():
    """A CUDA engine whose capture or replay fails raises: the engine module
    holds no ``try`` at all, so nothing reruns the stream eagerly, and the
    engine takes no argument that turns capture off."""
    path = os.path.join(PORT, "core", "engine.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert list(inspect.signature(engine.FusedEngine).parameters) == [
        "graph", "fuse", "microbatches", "tune", "cache", "tune_kwargs"]


LAUNCH_PATH = sorted([os.path.join(PORT, "core", f) for f in ("engine.py", "dataflow.py",
                                                              "mvu.py")]
                     + glob.glob(os.path.join(PORT, "kernels", "*.py")))


@pytest.mark.parametrize("path", LAUNCH_PATH, ids=lambda p: os.path.relpath(p, ROOT))
def test_launch_path_reads_no_device_value(path):
    """A host read of a device value synchronises, which a CUDA-graph
    capture forbids: the launch path calls no ``.item()``, ``.cpu()`` or
    ``.tolist()``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    reads = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr in ("item", "cpu", "tolist")]
    assert not reads, f"{path}: host reads at lines {reads}"
