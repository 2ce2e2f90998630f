"""The port's design-space explorer (``repro_torch.explore``) on the CPU.

Twins of ``tests/test_explore.py``: sweep-grid construction (divisor
clamping, dedup, stable point ids), Pareto dominance and frontier
properties, the calibration math on synthetic measurements (the helpers'
equality with the JAX package and their errors are in
``tests/test_torch_telemetry.py``), and an end-to-end sweep on a tiny MLP
with cache-hit accounting and the record's round trip.  Then what the port
adds: a point's accelerator is freed before the next is built, no timed
engine call captures a CUDA graph, the records never go to the JAX
package's ``experiments/explore``, the package imports with torch alone,
and the CLI raises without a card.  Parity with the JAX package's
records is in ``tests/test_torch_explore_parity.py``.

Every build passes ``device="cpu"`` (the kernels' plain versions); every
record goes to ``tmp_path`` or nowhere.
"""

import itertools
import json
import math
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro.explore import ExploreConfig as JExploreConfig
from repro_torch.core import engine as engine_mod, resource_model
from repro_torch.core.engine import _GraphCache
from repro_torch.core.folding import Folding, divisors
from repro_torch.core.ir import Graph, Node
from repro_torch.explore import (
    ExploreConfig,
    LayerShape,
    PARETO_MAXIMIZE,
    PARETO_MINIMIZE,
    clamp_folding,
    dominates,
    explore,
    load_record,
    pareto_front,
    sweep_grid,
)
from repro_torch.explore import __main__ as cli, explorer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp_graph(dims=(24, 16, 8), bits=2, seed=3) -> Graph:
    """The reference test's tiny MLP, on the port's IR."""
    rng = np.random.default_rng(seed)
    g = Graph([Node("input", "in", {"shape": (dims[0],), "bits": bits})])
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(w)}))
        if i < len(dims) - 2:
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


SHAPES = [LayerShape("fc0.mvu", 16, 24, 1), LayerShape("fc1.mvu", 8, 16, 1)]
TINY_TUNE = {"reps": 1, "max_measure": 1, "sample_m": 16}


# ------------------------------------------------------------------- grid
def test_clamp_folding_largest_divisor_at_or_under_target():
    f = clamp_folding(16, 24, 5, 9)
    assert f == Folding(4, 8)  # divisors(16) <= 5 -> 4; divisors(24) <= 9 -> 8
    assert clamp_folding(16, 24, 1, 1) == Folding(1, 1)
    # targets beyond the layer cap at the full dimension
    assert clamp_folding(16, 24, 999, 999) == Folding(16, 24)


def test_sweep_grid_points_are_legal_and_deduplicated():
    pts = sweep_grid(SHAPES, (1, 4, 16), (1, 8, 24))
    assert pts, "grid must not be empty"
    seen = set()
    for pt in pts:
        assert len(pt.foldings) == len(SHAPES)
        for shape, fold in zip(SHAPES, pt.foldings):
            assert shape.n % fold.pe == 0
            assert shape.k % fold.simd == 0
            assert fold.pe in divisors(shape.n)
        key = tuple((f.pe, f.simd) for f in pt.foldings)
        assert key not in seen, "duplicate realized design survived dedup"
        seen.add(key)


def test_sweep_grid_dedup_keeps_first_coordinate_id():
    # both 16 and 999 clamp to the same full-size folding on every layer:
    # the first grid coordinate must own the merged point
    pts = sweep_grid(SHAPES, (16, 999), (24, 999))
    ids = [p.point_id for p in pts]
    assert "pe16_simd24" in ids
    assert not any("999" in i for i in ids)


def test_sweep_grid_default_axes_cover_small_and_full_designs():
    pts = sweep_grid(SHAPES)
    folds = {tuple((f.pe, f.simd) for f in p.foldings) for p in pts}
    assert ((1, 1), (1, 1)) in folds  # fully folded corner
    assert ((16, 24), (8, 16)) in folds  # fully unfolded corner


def test_sweep_grid_empty_shapes_raises():
    with pytest.raises(ValueError):
        sweep_grid([])


# ----------------------------------------------------------------- pareto
def test_dominates_requires_strict_improvement():
    a = {"samples_per_s": 10.0, "lut_bytes": 5}
    assert not dominates(a, dict(a), maximize=("samples_per_s",),
                         minimize=("lut_bytes",))
    b = {"samples_per_s": 10.0, "lut_bytes": 6}
    assert dominates(a, b, maximize=("samples_per_s",), minimize=("lut_bytes",))
    assert not dominates(b, a, maximize=("samples_per_s",),
                         minimize=("lut_bytes",))


def test_pareto_front_drops_dominated_keeps_duplicates():
    pts = [
        {"samples_per_s": 10.0, "lut_bytes": 5},   # frontier
        {"samples_per_s": 10.0, "lut_bytes": 5},   # exact duplicate: kept
        {"samples_per_s": 9.0, "lut_bytes": 6},    # dominated by both
        {"samples_per_s": 20.0, "lut_bytes": 50},  # frontier (fast, big)
    ]
    front = pareto_front(pts, maximize=("samples_per_s",),
                         minimize=("lut_bytes",))
    assert front == [0, 1, 3]


def test_pareto_missing_key_is_worst_case():
    good = {"samples_per_s": 1.0, "lut_bytes": 1}
    hole = {"lut_bytes": 1}
    assert dominates(good, hole, maximize=("samples_per_s",),
                     minimize=("lut_bytes",))
    front = pareto_front([good, hole], maximize=("samples_per_s",),
                         minimize=("lut_bytes",))
    assert front == [0]


def _assert_frontier(pts, front, maximize, minimize):
    """No member is dominated; every non-member is dominated by a member."""
    for i in front:
        assert not any(dominates(pts[j], pts[i], maximize=maximize, minimize=minimize)
                       for j in range(len(pts)))
    for i, p in enumerate(pts):
        if i not in front:
            assert any(dominates(pts[j], p, maximize=maximize, minimize=minimize)
                       for j in front)


def test_pareto_front_property_no_member_dominated():
    # deterministic pseudo-random clouds; hypothesis variant below
    rng = np.random.default_rng(7)
    for _ in range(20):
        pts = [{"samples_per_s": float(rng.integers(1, 50)),
                "lut_bytes": float(rng.integers(1, 50)),
                "ff_bytes": float(rng.integers(1, 50))}
               for _ in range(rng.integers(1, 30))]
        front = pareto_front(pts, maximize=("samples_per_s",),
                             minimize=("lut_bytes", "ff_bytes"))
        assert front  # non-empty input -> non-empty frontier
        _assert_frontier(pts, front, ("samples_per_s",), ("lut_bytes", "ff_bytes"))


def test_pareto_front_hypothesis_property():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    point = st.fixed_dictionaries({
        "samples_per_s": st.integers(0, 8).map(float),
        "lut_bytes": st.integers(0, 8).map(float),
    })

    @hyp.given(st.lists(point, min_size=1, max_size=24))
    @hyp.settings(deadline=None, max_examples=80, database=None)
    def prop(pts):
        front = pareto_front(pts, maximize=("samples_per_s",),
                             minimize=("lut_bytes",))
        assert front == sorted(front)
        assert front
        _assert_frontier(pts, front, ("samples_per_s",), ("lut_bytes",))

    prop()


# ------------------------------------------------------------ calibration
def test_fit_cycle_time_recovers_exact_linear_data():
    cycles = [1, 10, 100, 1000]
    s = 2.5e-7
    seconds = [c * s for c in cycles]
    fit = resource_model.fit_cycle_time(cycles, seconds)
    assert math.isclose(fit, s, rel_tol=1e-12)
    errors = resource_model.cycle_model_errors(cycles, seconds)
    assert all(abs(e) < 1e-9 for e in errors)
    summary = resource_model.error_summary(errors)
    assert summary["n"] == 4
    assert summary["p90_abs"] < 1e-9


def test_fit_cycle_time_is_least_squares_not_mean_of_ratios():
    # one large-cycle point with slope 2, one tiny point with slope 1000:
    # least squares must follow the large point (sum(c*m)/sum(c^2)),
    # not average the per-point ratios
    cycles = [1000, 1]
    seconds = [2000.0, 1000.0]
    fit = resource_model.fit_cycle_time(cycles, seconds)
    expected = (1000 * 2000.0 + 1 * 1000.0) / (1000**2 + 1)
    assert math.isclose(fit, expected, rel_tol=1e-12)
    assert abs(fit - 2.0) < 0.01  # dominated by the big point


def test_cycle_model_errors_signed_and_summary_percentiles():
    # predicted = c * 1.0; measured chosen for exact signed errors
    cycles = [1, 1, 1, 1]
    seconds = [0.5, 1.0, 2.0, 4.0]  # errors: +1.0, 0.0, -0.5, -0.75
    errors = resource_model.cycle_model_errors(cycles, seconds, s_per_cycle=1.0)
    assert errors == pytest.approx([1.0, 0.0, -0.5, -0.75])
    summary = resource_model.error_summary(errors)
    assert summary["max_abs"] == pytest.approx(1.0)
    assert summary["mean_signed"] == pytest.approx((1.0 - 0.5 - 0.75) / 4)
    assert 0.0 < summary["p50_abs"] <= 1.0


# ------------------------------------------------------------- end-to-end
@pytest.fixture(scope="module")
def small_sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("explore")
    cfg = ExploreConfig(
        graph=_mlp_graph(), name="tiny",
        build_overrides=dict(mode="standard", weight_bits=4, act_bits=2, **CPU),
        pe_targets=(1, 8), simd_targets=(1, 16),
        packings=(False,),  # folding-only sweep: the legacy record shape
        batch=16, reps=1, out_dir=str(out), tune_kwargs=TINY_TUNE,
    )
    return explore(cfg)


def test_explore_sweep_points_bit_exact_and_pareto(small_sweep):
    rec = small_sweep
    assert rec["n_points"] == len(rec["points"]) == 4  # 2x2, no collapses
    assert rec["bit_exact"] is True
    ids = {p["point_id"] for p in rec["points"]}
    assert ids == {"pe1_simd1", "pe1_simd16", "pe8_simd1", "pe8_simd16"}
    front = set(rec["pareto_front"])
    assert front <= ids and front
    for p in rec["points"]:
        assert p["pareto"] == (p["point_id"] in front)
        assert p["interval_cycles"] >= 1
        assert p["samples_per_s"] > 0
        for key in PARETO_MAXIMIZE + PARETO_MINIMIZE:
            assert key in p
    # the folding axis survived the sweep: the fully-folded point runs more
    # cycles than the unfolded one (tune="off" keeps foldings distinct)
    by_id = {p["point_id"]: p for p in rec["points"]}
    assert (by_id["pe1_simd1"]["interval_cycles"]
            > by_id["pe8_simd16"]["interval_cycles"])
    assert by_id["pe1_simd1"]["lut_bytes"] <= by_id["pe8_simd16"]["lut_bytes"]


def test_explore_calibration_attached_and_gated(small_sweep):
    rec = small_sweep
    cal = rec["calibration"]
    assert cal["s_per_cycle"] > 0
    assert cal["samples"] == sum(len(p["nodes"]) for p in rec["points"])
    assert set(cal["per_node"]) == {"fc0.mvu", "fc1.mvu"}
    for p in rec["points"]:
        for node in p["nodes"]:
            assert node["predicted_s"] == pytest.approx(
                node["cycles"] * cal["s_per_cycle"])
            assert node["model_error"] is not None
    # gate contract: ceiling committed alongside the measured value
    assert rec["ceiling_only"] == ["model_error_p90"]
    assert rec["model_error_p90"] == pytest.approx(cal["summary"]["p90_abs"])
    assert rec["max_model_error_p90"] >= rec["model_error_p90"] + 0.5


def test_explore_cache_phase_hit_accounting(small_sweep):
    cache = small_sweep["cache"]
    n_mvu = 2  # fc0.mvu, fc1.mvu
    assert cache["cold_misses"] == n_mvu  # empty cache: every node measured
    assert cache["warm_hits"] == n_mvu  # warm replay: pure lookup
    assert cache["warm_misses"] == 0
    assert cache["cold_wall_s"] > 0 and cache["warm_wall_s"] > 0
    assert small_sweep["floor_only"] == ["cache_speedup"]
    assert small_sweep["cache_speedup"] == pytest.approx(
        cache["cold_wall_s"] / cache["warm_wall_s"])


def test_explore_packing_axis_doubles_grid_and_is_gated():
    """The default packings=(False, True) crosses the weight-storage axis
    into the grid: packed twins carry smaller weight bytes at equal
    folding, land on the frontier, and the record gains the floor gate."""
    cfg = ExploreConfig(
        graph=_mlp_graph(), name="tiny_packed",
        build_overrides=dict(mode="binary", weight_bits=1, act_bits=2, **CPU),
        pe_targets=(1,), simd_targets=(1, 16),
        batch=16, reps=1, out_dir=None, tune_kwargs=TINY_TUNE,
    )
    rec = explore(cfg)
    assert "path" not in rec  # out_dir=None writes nothing
    assert rec["n_points"] == len(rec["points"]) == 4  # 1x2 x {unpacked, packed}
    assert rec["bit_exact"] is True
    assert rec["grid"]["packings"] == [False, True]
    by_id = {p["point_id"]: p for p in rec["points"]}
    assert set(by_id) == {"pe1_simd1", "pe1_simd16",
                          "pe1_simd1_packed", "pe1_simd16_packed"}
    for pid in ("pe1_simd1", "pe1_simd16"):
        plain, packed = by_id[pid], by_id[pid + "_packed"]
        assert not plain["packed"] and packed["packed"]
        assert packed["weight_bytes"] < plain["weight_bytes"]
        assert all(n["packed"] for n in packed["nodes"])
    assert rec["packed_points"] == 2
    # a packed point always survives: only another packed point can match
    # the strictly-smaller weight_bytes objective, and dominance among the
    # packed twins leaves the dominator on the frontier
    assert rec["packed_pareto_points"] >= 1
    assert "packed_pareto_points" in rec["floor_only"]
    assert rec["min_packed_pareto_points"] == 1
    assert "weight_bytes" in PARETO_MINIMIZE


def test_explore_record_round_trips_and_is_json_clean(small_sweep, tmp_path_factory):
    path = small_sweep["path"]
    assert path.startswith(str(tmp_path_factory.getbasetemp()))
    loaded = load_record(path)
    assert "path" not in loaded  # runtime-only key stays out of the file
    drop = {k: v for k, v in small_sweep.items() if k != "path"}
    assert loaded == json.loads(json.dumps(drop))  # JSON-clean, lossless
    assert loaded["grid"]["layers"][0]["name"] == "fc0.mvu"
    assert loaded["points"][0]["foldings"]  # [[pe, simd], ...] survived


# --------------------------------------------------------- the port's own
def test_each_point_is_freed_before_the_next_is_built(monkeypatch):
    """A sweep holds one point's accelerator at a time: its engine (and on
    the card the engine's CUDA graphs and their pool) is gone when the
    next point's build starts."""
    built = []
    real = explorer.build

    def tracking_build(graph, **kw):
        if kw.get("target") == "engine" and kw.get("tune") == "off":
            assert all(ref() is None for ref in built), "an earlier point is still alive"
        acc = real(graph, **kw)
        if kw.get("target") == "engine" and kw.get("tune") == "off":
            built.append(weakref.ref(acc))
        return acc

    monkeypatch.setattr(explorer, "build", tracking_build)
    rec = explore(ExploreConfig(
        graph=_mlp_graph(), name="tiny", pe_targets=(1, 8), simd_targets=(1,),
        build_overrides=dict(mode="standard", weight_bits=4, act_bits=2, **CPU),
        batch=16, reps=1, out_dir=None, cache_phase=False))
    assert len(built) == rec["n_points"] == 4
    assert all(ref() is None for ref in built)


class _Capturer:
    """A fake CUDA-graph capture for the CPU: runs ``fn`` once to record
    it, and replays by rewriting the same output (as a graph does)."""

    def __init__(self):
        self.captures = 0

    def __call__(self, fn, x, pool, stream):
        self.captures += 1
        out = fn(x)
        return (lambda: out.copy_(fn(x))), out


def test_no_timed_engine_call_captures(monkeypatch):
    """With the graph cache let through on the CPU, each point captures
    once, on its first ``engine(x)`` (the bit-exact check), before the
    engine timer starts; the timed calls replay."""
    cap = _Capturer()
    monkeypatch.setattr(engine_mod, "capture_cuda_graph", cap)
    monkeypatch.setattr(_GraphCache, "applies", staticmethod(lambda device: True))
    per_point = []
    real = explorer._time_median

    def timer(fn, *args, **kw):
        before = cap.captures
        t = real(fn, *args, **kw)
        if isinstance(fn, engine_mod.FusedEngine):
            per_point.append((before, cap.captures, fn.captured_graphs))
        return t

    monkeypatch.setattr(explorer, "_time_median", timer)
    rec = explore(ExploreConfig(
        graph=_mlp_graph(), name="tiny", pe_targets=(1, 8), simd_targets=(16,),
        packings=(False,), batch=16, reps=2, out_dir=None, cache_phase=False,
        build_overrides=dict(mode="standard", weight_bits=4, act_bits=2, **CPU)))
    assert rec["bit_exact"] is True and len(per_point) == rec["n_points"] == 2
    assert all(before == after and graphs >= 1 for before, after, graphs in per_point)


def test_a_timed_capture_raises(monkeypatch):
    """A timed engine call that captured (a key the first call did not
    capture) fails the point: no time is recorded for it."""
    counts = itertools.count(1)  # every read of the count finds one graph more
    monkeypatch.setattr(engine_mod.FusedEngine, "captured_graphs",
                        property(lambda self: next(counts)))
    acc = explorer.build(_mlp_graph(), target="engine", device="cpu", mode="standard",
                         weight_bits=4, act_bits=2)
    x = torch.zeros((4, 24), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="captured a CUDA graph"):
        explorer._measure_point(acc, x, reps=1)


def test_port_default_out_dir_is_not_the_jax_packages(monkeypatch, capsys):
    assert ExploreConfig().out_dir == "experiments/explore_torch"
    assert JExploreConfig().out_dir == "experiments/explore"
    seen = []

    def fake_explore(cfg):
        seen.append(cfg)
        return {"name": "nid_mlp_quick", "n_points": 0, "pareto_front": [], "points": [],
                "bit_exact": True, "calibration": {}}

    monkeypatch.setattr(cli, "explore", fake_explore)
    cli.main(["--config", "nid_mlp", "--quick"])
    assert seen[0].out_dir == "experiments/explore_torch" and seen[0].quick
    assert seen[0].batch == 256 and seen[0].cache_phase
    assert json.loads(capsys.readouterr().out)["name"] == "nid_mlp_quick"


def test_explore_imports_with_torch_alone():
    code = ("import sys\n"
            "import repro_torch.explore, repro_torch.explore.__main__\n"
            "import repro_torch.configs.paper_sweeps\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_without_a_card_raises(monkeypatch):
    """``python -m repro_torch.explore`` builds for the card; on a host
    without one the build raises, and nothing runs on the CPU instead."""
    from repro_torch.build import BuildError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BuildError, match="no CUDA device"):
        cli.main(["--config", "nid_mlp", "--quick", "--no-cache-phase", "--out-dir", ""])
