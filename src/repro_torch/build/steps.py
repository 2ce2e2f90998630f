"""The step pipeline: named build steps over the lowering passes.

FINN's ``build_dataflow`` runs a list of named transformation steps over
the model, with verification after each; this module is that machinery
for the port's IR.  A *step* is any callable ``step(state: BuildState)``
that mutates/returns the state (it may also return a plain graph, which
replaces ``state.graph``).  The built-in steps, in the JAX package's names
and order:

    validate        ir.validate_graph
    lower           lowering.lower_to_mvu
    streamline      lowering.streamline      (opt-in by name)
    finalize        lowering.finalize
    fold            lowering.apply_folding / explicit per-node Foldings
    fuse_epilogues  lowering.fuse_epilogues
    fuse_swu        lowering.fuse_swu
    tune            autotune.tune_graph      (cache hits/misses reported)
    pack_weights    lowering.pack_weights
    dataflow        dataflow.schedule -> report tables
    engine          core.engine.FusedEngine on the build's device
    calibrate       serving.calibrate_cycle_time (serving target)

Every step before ``engine`` runs on CPU tensors, so quantized weights and
folded thresholds never depend on the device; the ``tune`` step alone
measures on the build's device (on a copy of the graph there).  After
every step that changed the graph, the verification hook re-runs a probe
batch through the reference interpreter (``dataflow.execute``, on the
CPU) and demands bit-exactness with the output captured at the first
executable graph; the engine, on the build's device, is held to the same
output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.build.config import (
    FOLD_BALANCE,
    FOLD_NONE,
    BuildConfig,
    BuildError,
    VerificationError,
)
from repro_torch.build.report import BuildReport, NodeReport
from repro_torch.core import autotune, dataflow, ir, lowering
from repro_torch.core.ir import Graph
from repro_torch.core.mvu import MVUConfig, MVULayer
from repro_torch.telemetry import Tracer


# ------------------------------------------------------------------- state
@dataclasses.dataclass
class BuildState:
    """Everything a step may read or advance.

    ``graph`` is the working graph; ``ref_graph``/``probe_out`` pin the
    reference semantics the verification hook holds every later transform
    to.  Steps signal a graph rewrite via :meth:`mark_dirty`.
    """

    graph: Graph
    cfg: BuildConfig
    report: BuildReport
    device: torch.device
    cache: Any = None  # autotune.ScheduleCache once tune/calibrate need one
    engine: Any = None  # FusedEngine after the "engine" step
    calibration: dict | None = None  # cycle-time entry (serving target)
    tracer: Any = None  # the build-step Tracer when cfg.telemetry is set
    ref_graph: Graph | None = None
    probe: torch.Tensor | None = None
    probe_out: np.ndarray | None = None
    _dirty: bool = False
    _engine_verified: bool = False

    def mark_dirty(self) -> None:
        self._dirty = True

    def require_cache(self):
        if self.cache is None:
            self.cache = autotune.ScheduleCache()
        return self.cache


# ---------------------------------------------------------------- registry
STEP_REGISTRY: dict[str, Callable[[BuildState], Any]] = {}


def register_step(name: str):
    """Register ``fn`` under ``name`` so step lists can name it."""

    def deco(fn):
        STEP_REGISTRY[name] = fn
        fn.step_name = name
        return fn

    return deco


def step_name(step) -> str:
    if isinstance(step, str):
        return step
    return getattr(step, "step_name", getattr(step, "__name__", repr(step)))


def resolve_step(step) -> Callable[[BuildState], Any]:
    if callable(step):
        return step
    try:
        return STEP_REGISTRY[step]
    except KeyError:
        raise BuildError(
            f"unknown build step {step!r}; registered steps: "
            f"{sorted(STEP_REGISTRY)}") from None


_ENGINE_STEPS = ("validate", "lower", "finalize", "fold", "fuse_epilogues",
                 "fuse_swu", "tune", "pack_weights", "dataflow", "engine")
DEFAULT_STEPS: dict[str, tuple[str, ...]] = {
    "interpret": ("validate", "lower", "finalize", "fold", "pack_weights",
                  "dataflow"),
    "engine": _ENGINE_STEPS,
    "pipeline": _ENGINE_STEPS,
    "serving": _ENGINE_STEPS + ("calibrate",),
}


def default_steps(target: str) -> list[str]:
    """The default step-name list for one build target (copy; splice away)."""
    try:
        return list(DEFAULT_STEPS[target])
    except KeyError:
        raise BuildError(
            f"no default steps for target {target!r}; targets: "
            f"{sorted(DEFAULT_STEPS)}") from None


# ------------------------------------------------------------- built-ins
@register_step("validate")
def step_validate(state: BuildState) -> None:
    ir.validate_graph(state.graph)


@register_step("lower")
def step_lower(state: BuildState) -> None:
    cfg = state.cfg
    state.graph = lowering.lower_to_mvu(
        state.graph, mode=cfg.mode, weight_bits=cfg.weight_bits,
        act_bits=cfg.act_bits, backend=cfg.backend)
    state.mark_dirty()


@register_step("streamline")
def step_streamline(state: BuildState) -> None:
    state.graph = lowering.streamline(state.graph)
    state.mark_dirty()


@register_step("finalize")
def step_finalize(state: BuildState) -> None:
    state.graph = lowering.finalize(state.graph)
    state.mark_dirty()


@register_step("fold")
def step_fold(state: BuildState) -> None:
    cfg = state.cfg
    if isinstance(cfg.folding, str):
        if cfg.folding == FOLD_NONE:
            return
        assert cfg.folding == FOLD_BALANCE
        state.graph = lowering.apply_folding(
            state.graph, target_cycles=cfg.target_cycles,
            max_pe=cfg.max_pe, max_simd=cfg.max_simd)
        state.mark_dirty()
        return
    folds = list(cfg.folding)
    # explicit foldings apply in dataflow (topological) order; toposorted
    # nodes share their attrs dicts with state.graph, so the in-place
    # config rewrite reaches it
    mvu_nodes = [n for n in ir.toposort(state.graph)
                 if n.op in ("mvu", "conv_mvu")]
    if len(folds) != len(mvu_nodes):
        raise BuildError(
            f"folding override lists {len(folds)} entries but the lowered "
            f"graph has {len(mvu_nodes)} MVU stages")
    for node, fold in zip(mvu_nodes, folds):
        mcfg: MVUConfig = node.attrs["config"]
        node.attrs["config"] = MVUConfig(**{**mcfg.__dict__, "folding": fold})
    state.mark_dirty()


@register_step("fuse_epilogues")
def step_fuse_epilogues(state: BuildState) -> None:
    state.graph = lowering.fuse_epilogues(state.graph)
    state.mark_dirty()


@register_step("fuse_swu")
def step_fuse_swu(state: BuildState) -> None:
    state.graph = lowering.fuse_swu(state.graph)
    state.mark_dirty()


@register_step("tune")
def step_tune(state: BuildState) -> None:
    """Pin autotuned schedules; report cache hits and misses.

    The cache scope is ``tune_kwargs["device"]`` or the kind of the
    build's device, so a CPU build's entries never apply on the card.
    ``tune="auto"`` measures the misses on the build's device: the graph
    is copied there for the lookup and search, and the tuned graph back to
    the CPU.
    """
    cfg = state.cfg
    state.report.tune = {"mode": cfg.tune}
    if cfg.tune == "off":
        return
    # run_pipeline seeds state.cache whenever cfg.tune != "off"
    kwargs = dict(cfg.tune_kwargs or {})
    kwargs["device"] = kwargs.get("device") or autotune.device_kind(state.device)
    keys = autotune.graph_node_keys(state.graph, device=kwargs["device"])
    hits = sum(1 for key in keys if key in state.cache)
    tuned = autotune.tune_graph(
        dataflow.graph_to(state.graph, state.device), cache=state.cache,
        mode=cfg.tune, allow_packed=cfg.pack != "never", **kwargs)
    state.graph = dataflow.graph_to(tuned, "cpu")
    state.report.tune.update(
        cache_hits=hits, cache_misses=len(keys) - hits,
        cache_entries=len(state.cache))
    state.mark_dirty()


@register_step("pack_weights")
def step_pack_weights(state: BuildState) -> None:
    """Bit-packed weight storage rewrite (``lowering.pack_weights``):
    ``pack="auto"`` packs exactly the nodes whose tuned schedule chose the
    packed datapath, ``"always"`` every packable node, ``"never"`` none."""
    if state.cfg.pack == "never":
        return
    state.graph = lowering.pack_weights(state.graph, force=state.cfg.pack == "always")
    state.mark_dirty()


@register_step("dataflow")
def step_dataflow(state: BuildState) -> None:
    """Schedule + per-node resource tables into the report (no rewrite)."""
    sched = dataflow.schedule(state.graph)
    state.report.schedule = sched.summary() if sched.stages else {"stages": 0}
    state.report.edges = ir.edge_list(state.graph)
    branches = ir.branch_labels(state.graph)
    nodes: list[NodeReport] = []
    for node, _, out_shape in ir.io_shapes(state.graph):
        if node.op not in ("mvu", "conv_mvu"):
            continue
        mcfg: MVUConfig = node.attrs["config"]
        px = ir.n_pixels(out_shape)
        fold = mcfg.resolved_folding()
        res = MVULayer(mcfg).resources(n_pixels=px)
        nodes.append(NodeReport(
            name=node.name, op=node.op, mode=mcfg.mode,
            n=mcfg.out_features, k=mcfg.in_features,
            pe=fold.pe, simd=fold.simd, n_pixels=px, cycles=res.cycles,
            lut_bytes=res.lut_bytes, ff_bytes=res.ff_bytes,
            bram_bytes=res.bram_bytes, backend=mcfg.backend,
            tuned=mcfg.blocks is not None,
            inputs=list(node.inputs),
            branch=branches.get(node.name, "main"),
            packed=mcfg.packed,
            weight_bytes=res.weight_bytes,
            canonical_weight_bytes=res.canonical_weight_bytes))
    state.report.nodes = nodes
    if sched.stages:
        state.report.predicted_interval_s = (
            sched.steady_state_interval / dataflow.DEFAULT_CLOCK_HZ)
        measured = _measured_interval(state, sched)
        if measured is not None:
            state.report.measured_interval_s = measured
            state.report.cycle_time_source = "measured"


def _measured_interval(state: BuildState, sched) -> float | None:
    """Measured-cycle-time interval when the cache holds a calibration
    for the build's device.

    The conversion itself stays in :func:`dataflow.interval_seconds` (the
    single owner of the cycles-to-seconds rule); this helper only decides
    whether a measurement exists at all.
    """
    if state.cache is None:
        return None
    ent = state.cache.get(autotune.cycle_time_key(state.device))
    if ent is None or not ent.get("s_per_cycle"):
        return None
    return dataflow.interval_seconds(sched, cache=state.cache, device=state.device)


@register_step("engine")
def step_engine(state: BuildState) -> None:
    """Move the graph's integer params to the build's device and build the
    fused streaming engine over them (the tuned microbatch tile applies
    through the shared cache)."""
    from repro_torch.core.engine import FusedEngine

    cfg = state.cfg
    state.graph = dataflow.graph_to(state.graph, state.device)
    # the engine's lookups keep the build's pack policy (a packed entry is
    # not applied under pack="never", as in the tune step)
    state.engine = FusedEngine(
        state.graph, microbatches=cfg.microbatches, tune=cfg.tune,
        cache=state.cache,
        tune_kwargs={**(cfg.tune_kwargs or {}), "allow_packed": cfg.pack != "never"})
    if cfg.tune != "off":
        state.report.tune["engine_tile"] = state.engine._tile


@register_step("calibrate")
def step_calibrate(state: BuildState) -> None:
    """Measure the realized seconds-per-cycle of the engine on the build's
    device (the serving warm-up path): recorded under
    ``autotune.cycle_time_key(device)`` in the build's cache so every
    batcher constructed from this Accelerator budgets flushes in measured
    wall-clock units, not the nominal clock."""
    from repro_torch.serving import calibrate_cycle_time

    if state.engine is None:
        raise BuildError("the 'calibrate' step needs the 'engine' step first")
    cfg = state.cfg
    state.calibration = calibrate_cycle_time(
        state.engine, batch=cfg.calibrate_batch, reps=cfg.calibrate_reps,
        cache=state.require_cache(), device=state.engine.device)
    sched = state.engine.schedule
    if sched.stages:
        state.report.measured_interval_s = dataflow.interval_seconds(
            sched, cache=state.cache, device=state.engine.device)
        state.report.cycle_time_source = "measured"


# ------------------------------------------------------------ verification
def _localize_divergence(state: BuildState, graph: Graph) -> tuple:
    """Pin a probe-batch divergence to its first bad node and branch path.

    Re-traces ``graph`` and the pinned reference graph node-by-node
    (``dataflow.trace``, on the graph's device) and walks the current graph
    in dataflow order comparing each node's stream against the reference
    activation it must reproduce -- fused nodes against the last epilogue
    node they absorbed (``attrs["fused"]``), conv_mvu nodes against their
    pre-``fuse_swu`` MVU.  Returns ``(detail_suffix, node_name, branch)``;
    all empty when localization itself fails (the step-level error still
    raises).
    """
    try:
        ref_env = dataflow.trace(state.ref_graph, state.probe)
        got_env = dataflow.trace(
            graph, state.probe.to(dataflow.graph_device(graph)))
        branches = ir.branch_labels(graph)
    except Exception:
        return "", None, None
    for node in ir.toposort(graph):
        if node.op == "input":
            continue
        cands = []
        fused = node.attrs.get("fused")
        if fused:
            cands.append(fused[-1])
        cands.append(node.name)
        if ".conv_mvu" in node.name:
            cands.append(node.name.replace(".conv_mvu", ".mvu"))
        want = next((ref_env[c] for c in cands if c in ref_env), None)
        got = got_env.get(node.name)
        if want is None or got is None:
            continue
        want, got = want.cpu().numpy(), got.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            br = branches.get(node.name, "main")
            return (f"; first divergent node: {node.name!r} on branch "
                    f"{br!r}", node.name, br)
    return "", None, None


def _executable(graph: Graph) -> bool:
    """Can ``dataflow.execute`` run this graph? (no float conv/linear left,
    every MVU finalized)."""
    for n in graph:
        if n.op in ("conv", "linear"):
            return False
        if n.op in ("mvu", "conv_mvu") and "mvu" not in n.params:
            return False
    return True


def _op_histogram(graph: Graph) -> dict[str, int]:
    return dict(Counter(n.op for n in graph))


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.cpu().numpy()
    return got.dtype == want.dtype and got.shape == want.shape \
        and np.array_equal(got, want)


def verify_after(state: BuildState, name: str) -> bool | None:
    """The per-step verification hook (FINN's verification steps).

    Captures the reference interpreter output at the first executable
    graph; every later graph rewrite must reproduce it bit-exactly on the
    probe batch, and the engine (on the build's device) is held to the same
    reference.  Returns True (verified) or None (nothing new to verify); a
    mismatch raises :class:`VerificationError` naming the step.
    """
    verified = None
    if state._dirty and _executable(state.graph):
        state._dirty = False
        if state.probe is None:
            state.probe = autotune.synth_input(state.graph, state.cfg.probe_batch,
                                               seed=state.cfg.seed)
        if state.probe_out is None:
            # first executable graph: pin the reference semantics (and keep
            # this graph as the Accelerator's interpreter facing)
            state.ref_graph = state.graph
            state.probe_out = dataflow.execute(state.graph, state.probe).numpy()
            verified = True
        else:
            got = dataflow.execute(
                state.graph, state.probe.to(dataflow.graph_device(state.graph)))
            if not _same(got, state.probe_out):
                suffix, bad_node, branch = _localize_divergence(state, state.graph)
                raise VerificationError(
                    name, "graph output diverged from the reference "
                    f"interpreter on a {state.cfg.probe_batch}-sample probe "
                    f"batch{suffix}", node=bad_node, branch=branch)
            verified = True
    if state.engine is not None and not state._engine_verified \
            and state.probe_out is not None:
        state._engine_verified = True
        if not _same(state.engine(state.probe), state.probe_out):
            # the engine shares the fused graph's params, so an eager
            # re-trace of engine.graph localizes the divergent stage
            suffix, bad_node, branch = _localize_divergence(
                state, state.engine.graph)
            raise VerificationError(
                name, "compiled engine diverged from the reference "
                f"interpreter on the probe batch{suffix}",
                node=bad_node, branch=branch)
        verified = True
    return verified


# ---------------------------------------------------------------- pipeline
def run_pipeline(graph: Graph, cfg: BuildConfig) -> BuildState:
    """Execute the config's step list over ``graph``; returns the final
    state (the :class:`~repro_torch.build.accelerator.Accelerator` wraps it).
    The graph's tensors are copied to the CPU first."""
    device = cfg.resolved_device()
    report = BuildReport(name=cfg.name, target=cfg.target,
                         config=cfg.snapshot())
    state = BuildState(graph=dataflow.graph_to(graph, "cpu"), cfg=cfg,
                       report=report, device=device)
    if cfg.tune != "off":
        state.cache = cfg.cache if cfg.cache is not None else autotune.default_cache()
    elif cfg.cache is not None:
        state.cache = cfg.cache
    tracer = None
    if cfg.telemetry:
        tracer = Tracer(meta={"build": cfg.name, "target": cfg.target})
    steps = cfg.steps if cfg.steps is not None else DEFAULT_STEPS[cfg.target]
    t_build = time.perf_counter()
    for step in steps:
        fn = resolve_step(step)
        name = step_name(step)
        # the span covers the step alone: the verification hook runs after it
        span = (tracer.span(f"step.{name}", cat="build") if tracer is not None
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            out = fn(state)
        if isinstance(out, BuildState):
            state = out
        elif isinstance(out, list):  # a custom step returned a graph
            state.graph = out
            state.mark_dirty()
        wall = time.perf_counter() - t0
        verified = (verify_after(state, name)
                    if cfg.verify != "off" else None)
        report.record_step(name, wall, verified, _op_histogram(state.graph))
    report.total_wall_s = time.perf_counter() - t_build
    if tracer is not None:
        report.telemetry = tracer.summary()
        state.tracer = tracer
    if state.ref_graph is None and _executable(state.graph):
        state.ref_graph = state.graph
    return state
