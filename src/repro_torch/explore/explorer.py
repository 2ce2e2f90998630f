"""Cached design-space explorer over the ``repro_torch.build`` pipeline.

The paper's method is a sweep: synthesize every folding of every
configuration, read resources and timing off the reports, and lean on
out-of-context synthesis caching to make re-sweeps cheap.  ``explore``
is that loop for the port, the counterpart of the JAX package's
``explore/explorer.py`` with the same record, key for key:

1. **Sweep** -- one build per grid point (``grid.sweep_grid``), each with
   ``tune="off"`` so the *folding* stays the design axis (autotuned
   schedules would overwrite the very dimension being swept) and
   ``verify`` on, so every point is bit-exact against the reference
   interpreter by construction.  On the card a point's foldings also pick
   the kernel tile each layer launches (``folding.to_gpu_blocks``); the
   engine's microbatch stays the bottleneck stage's burst (``block_m``),
   which the folding does not set.  Each point's
   :class:`~repro_torch.build.Accelerator`, its engine and the CUDA graphs
   the engine captured are freed before the next point is built.
2. **Measure** -- per point the fused engine is timed end to end (host
   clock to its last result on the card) and every MVU or conv stage is
   timed stand-alone, on the card's clock for a CUDA build, giving
   measured seconds next to the resource model's analytic cycle counts.
3. **Pareto** -- the throughput-vs-LUT/FF/BRAM-analog frontier
   (``pareto.pareto_front``), the paper's Figs 8-15 trade-off curve.
4. **Calibrate** -- one least-squares cycle time over *all* (point, node)
   pairs (``resource_model.fit_cycle_time``) and the per-node model-error
   distribution, i.e. how well the analytic model predicts measured time
   across the whole design space, not just the bottleneck.
5. **Cache** -- a cold ``tune="auto"`` build against an empty
   :class:`~repro_torch.core.autotune.ScheduleCache` vs a warm
   ``tune="cache"`` rebuild from the filled one; the wall-clock ratio is
   the software analog of the paper's ~10x synthesis-time saving from
   caching.

Every build runs on the build's device: ``device`` in
``build_overrides`` (``"cpu"`` runs the kernels' plain versions), else the
card, where the sweep launches the hand kernels or raises.  The record
round-trips through JSON under ``out_dir`` (default
``experiments/explore_torch``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from repro_torch.build import build
from repro_torch.core import autotune, resource_model
from repro_torch.core.dataflow import node_runner
from repro_torch.core.ir import Graph
from repro_torch.explore.grid import SweepPoint, layer_shapes, sweep_grid
from repro_torch.explore.pareto import pareto_front
from repro_torch.kernels import _cuda, ops

# Frontier objectives: throughput up, every paper resource analog down --
# including the device-resident weight bytes, the axis the packing
# coordinate trades (bit-packed storage shrinks it 4-8x at equal folding).
PARETO_MAXIMIZE = ("samples_per_s",)
PARETO_MINIMIZE = ("lut_bytes", "ff_bytes", "bram_bytes", "weight_bytes")


@dataclasses.dataclass
class ExploreConfig:
    """One sweep recipe.  ``config`` names a packaged workload
    (``nid_mlp`` / ``cnv_quick``); tests pass an explicit ``graph`` +
    ``build_overrides`` instead (``{"device": "cpu", ...}`` on a host
    without a card)."""

    config: str = "nid_mlp"
    quick: bool = False
    pe_targets: tuple[int, ...] | None = None
    simd_targets: tuple[int, ...] | None = None
    batch: int = 1024
    reps: int = 3
    seed: int = 0
    # the JAX package writes experiments/explore; the port's records go
    # beside them, never over them
    out_dir: str | None = "experiments/explore_torch"
    name: str | None = None
    # weight-storage axis crossed into the grid: default sweeps both the
    # canonical and the bit-packed storage form of every folding point
    packings: tuple[bool, ...] = (False, True)
    # explicit workload (overrides ``config``)
    graph: Graph | None = None
    build_overrides: dict = dataclasses.field(default_factory=dict)
    baseline_folding: object = "balance"
    # cold/warm autotune phase (the synthesis-time-cache analog)
    cache_phase: bool = True
    tune_kwargs: dict | None = None
    verify: str = "all"


QUICK_GRID = {
    # quick axes still span the small/medium/wide corners so the frontier
    # and the calibration fit see a real spread, at ~9 builds
    "pe_targets": (1, 8, 64),
    "simd_targets": (8, 64, 600),
}
QUICK_TUNE_KWARGS = {"reps": 1, "max_measure": 2, "sample_m": 128}


def _workload(cfg: ExploreConfig):
    """Resolve (graph, build kwargs, name, baseline folding)."""
    if cfg.graph is not None:
        return (cfg.graph, dict(cfg.build_overrides), cfg.name or "custom",
                cfg.baseline_folding)
    if cfg.config == "nid_mlp":
        from repro_torch.configs import nid_mlp

        # the paper's Table 6 NID config is 2-bit weights -- which also
        # makes every stage packable (int2 lanes), so the packing axis of
        # the sweep is exercised on the packaged workload
        kw = dict(mode="standard", weight_bits=nid_mlp.WEIGHT_BITS,
                  act_bits=nid_mlp.INPUT_BITS)
        kw.update(cfg.build_overrides)
        return (nid_mlp.build_graph(cfg.seed), kw,
                cfg.name or "nid_mlp", nid_mlp.foldings())
    if cfg.config == "cnv_quick":
        from repro_torch.configs import cnv_bnn

        kw = dict(mode="xnor", weight_bits=1, act_bits=1)
        kw.update(cfg.build_overrides)
        return (cnv_bnn.build_graph(cnv_bnn.QUICK, seed=cfg.seed), kw,
                cfg.name or "cnv_quick", "balance")
    raise ValueError(f"unknown explore config {cfg.config!r} "
                     "(expected nid_mlp or cnv_quick, or pass graph=)")


def _probe_input(graph: Graph, batch: int, seed: int, device) -> torch.Tensor:
    """A deterministic integer batch shaped for the chain's input node,
    on ``device``."""
    return autotune.synth_input(graph, batch, seed=seed, device=device)


def _time_median(fn, *args, reps: int, warmup: int = 1) -> float:
    """Median host seconds of ``fn(*args)`` to its last result on the card
    (``torch.cuda.synchronize`` for a CUDA output)."""
    for _ in range(warmup):
        autotune._wait(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        autotune._wait(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _node_seconds(fn, params, x: torch.Tensor, *, reps: int) -> float:
    """Median seconds of one stage's launch on ``x``: on the card's clock
    for a CUDA input (``autotune._device_seconds``: CUDA events behind a
    spin kernel, so the host's launch cost stays out of the time), else the
    host's clock.  A warm-up call comes first."""
    if not x.is_cuda:
        return _time_median(fn, params, x, reps=reps)
    autotune._wait(fn(params, x))
    return float(np.median([autotune._device_seconds(fn, (params, x), x.device)
                            for _ in range(reps)]))


def _measure_point(acc, x: torch.Tensor, *, reps: int) -> dict:
    """Engine throughput + per-MVU-stage stand-alone timings for one build.

    ``engine_s`` is host time: the median ``acc(x)`` to its last result.
    ``node_seconds`` is each MVU / conv stage's launch alone on its input
    in the chain, divided by the batch: device time on the card (the
    host's launch cost left out, so it does not enter the cycle fit), host
    time on the CPU.  On the card the first ``engine(x)`` (the bit-exact
    check) runs the stream eagerly and captures it as a CUDA graph; the
    warm-up and every timed call replay it, and a timed call that captured
    raises."""
    engine = acc.engine
    batch = int(x.shape[0])
    want = acc.interpret(x).cpu().numpy()
    got = engine(x).cpu().numpy()
    bit_exact = bool(np.array_equal(got, want))
    captured = engine.captured_graphs
    engine_s = _time_median(engine, x, reps=reps)
    if engine.captured_graphs != captured:
        raise RuntimeError(
            f"{acc.report.name}: a timed engine call captured a CUDA graph "
            f"({captured} -> {engine.captured_graphs}); the first call must")

    node_times: dict[str, float] = {}
    cur = x
    for node in acc.graph:
        params, fn = node_runner(node)
        if node.op in ("mvu", "conv_mvu"):
            node_times[node.name] = _node_seconds(fn, params, cur, reps=reps) / batch
        cur = fn(params, cur)
    return {
        "bit_exact": bit_exact,
        "engine_s": engine_s,
        "samples_per_s": batch / engine_s,
        "node_seconds": node_times,  # measured seconds per sample, per stage
    }


def _point_record(pt: SweepPoint, acc, measured: dict) -> dict:
    rep = acc.report
    nodes = []
    for nr in rep.nodes:
        sec = measured["node_seconds"].get(nr.name)
        nodes.append({
            "name": nr.name, "op": nr.op, "n": nr.n, "k": nr.k,
            "pe": nr.pe, "simd": nr.simd, "n_pixels": nr.n_pixels,
            "cycles": nr.cycles, "lut_bytes": nr.lut_bytes,
            "ff_bytes": nr.ff_bytes, "bram_bytes": nr.bram_bytes,
            "packed": nr.packed, "weight_bytes": nr.weight_bytes,
            "canonical_weight_bytes": nr.canonical_weight_bytes,
            "measured_s": sec,
        })
    return {
        **pt.as_dict(),
        "interval_cycles": rep.schedule.get("interval_cycles"),
        "latency_cycles": rep.schedule.get("latency_cycles"),
        "bottleneck": rep.schedule.get("bottleneck"),
        "lut_bytes": sum(n["lut_bytes"] for n in nodes),
        "ff_bytes": sum(n["ff_bytes"] for n in nodes),
        "bram_bytes": sum(n["bram_bytes"] for n in nodes),
        "weight_bytes": sum(n["weight_bytes"] for n in nodes),
        "pe_simd_product": sum(f[0] * f[1] for f in pt.as_dict()["foldings"]),
        "samples_per_s": measured["samples_per_s"],
        "engine_us": measured["engine_s"] * 1e6,
        "bit_exact": measured["bit_exact"],
        "build_wall_s": rep.total_wall_s,
        "nodes": nodes,
    }


def _release(device: torch.device) -> None:
    """Free what the dropped point's build held: its engine's CUDA graphs
    and their memory pool go back to the card, so a sweep's device memory
    does not grow with its points."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _calibrate(points: list[dict]) -> dict:
    """Fit one cycle time across every (point, node) pair and attribute the
    per-node model errors back into the point records (mutates ``points``)."""
    cycles, seconds, owners = [], [], []
    for rec in points:
        for node in rec["nodes"]:
            if node["measured_s"] is None:
                continue
            cycles.append(node["cycles"])
            seconds.append(node["measured_s"])
            owners.append(node)
    if not cycles:
        return {}
    s_per_cycle = resource_model.fit_cycle_time(cycles, seconds)
    errors = resource_model.cycle_model_errors(
        cycles, seconds, s_per_cycle=s_per_cycle)
    per_node: dict[str, list[float]] = {}
    for node, err in zip(owners, errors):
        node["predicted_s"] = node["cycles"] * s_per_cycle
        node["model_error"] = err
        per_node.setdefault(node["name"], []).append(err)
    for rec in points:
        if rec.get("interval_cycles"):
            rec["predicted_interval_s"] = rec["interval_cycles"] * s_per_cycle
    return {
        "s_per_cycle": s_per_cycle,
        "clock_mhz_analog": 1e-6 / s_per_cycle if s_per_cycle else None,
        "samples": len(cycles),
        "summary": resource_model.error_summary(errors),
        "per_node": {name: resource_model.error_summary(errs)
                     for name, errs in sorted(per_node.items())},
    }


def _load_kernels(device: torch.device) -> None:
    """Build and load every kernel library for a CUDA build (one nvcc per
    source, all at once), so no library's compile lands in a timed wall."""
    if device.type == "cuda":
        _cuda.build_all(ops.LIBRARIES)
        for lib in ops.LIBRARIES:
            lib.load()


def _cache_phase(graph: Graph, build_kw: dict, baseline_folding, name: str,
                 verify: str, tune_kwargs: dict | None,
                 device: torch.device) -> dict:
    """Cold autotune vs warm cache rebuild: the synthesis-time-cache analog.

    The cold build measures candidate schedules into a fresh cache (on the
    card: each node's compiled tiles and packed datapath raced on the
    card's clock); the warm build replays the same recipe with
    ``tune="cache"`` (pure lookup, nothing measured).  The kernel libraries
    are loaded before either wall starts.  Wall-clock ratio + hit
    accounting come back for the report; FINN's paper reports the same
    effect as ~10x faster synthesis when out-of-context checkpoints are
    reused.
    """
    cache = autotune.ScheduleCache()
    kw = dict(build_kw, target="engine", folding=baseline_folding,
              verify=verify, name=name, cache=cache,
              tune_kwargs=dict(tune_kwargs or {}))
    _load_kernels(device)

    t0 = time.perf_counter()
    cold = build(list(graph), tune="auto", **kw)
    cold_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    warm = build(list(graph), tune="cache", **kw)
    warm_wall = time.perf_counter() - t1

    def tune_wall(rep):
        return next((s.wall_s for s in rep.steps if s.name == "tune"), 0.0)

    return {
        "cold_wall_s": cold_wall,
        "warm_wall_s": warm_wall,
        "cold_tune_wall_s": tune_wall(cold.report),
        "warm_tune_wall_s": tune_wall(warm.report),
        "cache_speedup": cold_wall / warm_wall if warm_wall else None,
        "warm_hits": warm.report.tune.get("cache_hits"),
        "warm_misses": warm.report.tune.get("cache_misses"),
        "cold_hits": cold.report.tune.get("cache_hits"),
        "cold_misses": cold.report.tune.get("cache_misses"),
        "entries": len(cache),
    }


def explore(cfg: ExploreConfig) -> dict:
    """Run the sweep; returns (and optionally saves) the explore record."""
    graph, build_kw, name, baseline_folding = _workload(cfg)
    shaped = _shapes_build(graph, build_kw)
    shapes, device = layer_shapes(shaped.graph), shaped.device
    del shaped
    pe_targets = cfg.pe_targets
    simd_targets = cfg.simd_targets
    if cfg.quick and pe_targets is None and simd_targets is None:
        pe_targets = QUICK_GRID["pe_targets"]
        simd_targets = QUICK_GRID["simd_targets"]
    grid = sweep_grid(shapes, pe_targets, simd_targets,
                      packings=cfg.packings)

    x = _probe_input(graph, cfg.batch, cfg.seed, device)
    points: list[dict] = []
    report = None
    for pt in grid:
        acc = build(list(graph), target="engine", tune="off",
                    folding=list(pt.foldings), verify=cfg.verify,
                    pack="always" if pt.packed else "never",
                    name=f"{name}_{pt.point_id}", **build_kw)
        acc.report.sweep = pt.as_dict()
        measured = _measure_point(acc, x, reps=cfg.reps)
        points.append(_point_record(pt, acc, measured))
        report = acc.report
        del acc
        _release(device)

    front = pareto_front(points, maximize=PARETO_MAXIMIZE,
                         minimize=PARETO_MINIMIZE)
    for i, rec in enumerate(points):
        rec["pareto"] = i in front

    calibration = _calibrate(points)
    if calibration:
        # attach the fitted record to the last build's report so the
        # report's calibration schema is exercised end to end
        report.calibration = {
            "s_per_cycle": calibration["s_per_cycle"],
            "summary": calibration["summary"],
        }

    tune_kwargs = cfg.tune_kwargs
    if tune_kwargs is None and cfg.quick:
        tune_kwargs = QUICK_TUNE_KWARGS
    cache = (_cache_phase(graph, build_kw, baseline_folding, name,
                          cfg.verify, tune_kwargs, device)
             if cfg.cache_phase else {})

    record = {
        "name": f"{name}_quick" if cfg.quick else name,
        "config": cfg.config if cfg.graph is None else "custom",
        "quick": cfg.quick,
        "batch": cfg.batch,
        "reps": cfg.reps,
        "seed": cfg.seed,
        "grid": {
            "pe_targets": list(pe_targets) if pe_targets else None,
            "simd_targets": list(simd_targets) if simd_targets else None,
            "packings": [bool(p) for p in cfg.packings],
            "layers": [dataclasses.asdict(s) for s in shapes],
        },
        "n_points": len(points),
        "points": points,
        "pareto_front": [points[i]["point_id"] for i in front],
        "calibration": calibration,
        "cache": cache,
        # joint folding x packing space accounting: how many swept points
        # used packed storage, and how many of those made the frontier (a
        # packed point strictly dominates its unpacked twin on weight
        # bytes, so a sweep that crosses the packing axis must land >= 1)
        "packed_points": sum(1 for p in points if p["packed"]),
        "packed_pareto_points": sum(
            1 for i in front if points[i]["packed"]),
        # gate keys: bit-exactness is binary, the cache speedup holds a
        # floor, the model error a ceiling
        "bit_exact": all(p["bit_exact"] for p in points),
        **({"cache_speedup": cache["cache_speedup"],
            "min_cache_speedup": 1.2} if cache.get("cache_speedup") else {}),
        **({"min_packed_pareto_points": 1} if any(cfg.packings) else {}),
        **({"floor_only":
            (["cache_speedup"] if cache.get("cache_speedup") else [])
            + (["packed_pareto_points"] if any(cfg.packings) else [])}
           if cache.get("cache_speedup") or any(cfg.packings) else {}),
        **({"model_error_p90": calibration["summary"]["p90_abs"],
            "ceiling_only": ["model_error_p90"],
            "max_model_error_p90": _error_ceiling(
                calibration["summary"]["p90_abs"])} if calibration else {}),
    }
    if cfg.out_dir:
        record["path"] = save_record(record, cfg.out_dir)
    return record


def _error_ceiling(p90: float) -> float:
    """Regression ceiling for a committed baseline: generous headroom over
    the measured p90 so timer jitter never trips the gate, but a model that
    *stops predicting* (errors blowing past ~2x the committed level) does."""
    return round(max(2.0 * p90, p90 + 0.5), 3)


def _shapes_build(graph: Graph, build_kw: dict):
    """Lower once (no tuning, no engine) just to read the MVU shapes and
    the build's device."""
    return build(list(graph), target="interpret", tune="off", folding="none",
                 verify="off", name="shapes", **build_kw)


def save_record(record: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{record['name']}_explore.json")
    clean = {k: v for k, v in record.items() if k != "path"}
    with open(path, "w") as f:
        json.dump(clean, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_record(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
