"""Build configuration + error types for the step-pipeline compiler.

``BuildConfig`` is the declarative knob set for
:func:`repro_torch.build.build` -- the FINN ``DataflowBuildConfig`` analog.
One config names a *target* (which default step list runs), the lowering
parameters every step shares, the folding policy, the verification +
report policy, and the device the built design runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.folding import Folding

TARGETS = ("interpret", "engine", "pipeline", "serving")
TUNE_MODES = ("off", "cache", "auto")
VERIFY_MODES = ("all", "off")
# weight-packing policies (the pack_weights step)
PACK_MODES = ("auto", "never", "always")

# folding policies (the ``folding`` field also accepts an explicit
# per-MVU-node list of Folding objects, applied in chain order)
FOLD_BALANCE = "balance"  # rate-balance all stages (lowering.apply_folding)
FOLD_NONE = "none"  # keep the per-layer heuristic defaults


class BuildError(ValueError):
    """A build step could not run (bad config, malformed graph, ...)."""


class VerificationError(BuildError):
    """A step's output diverged from the reference interpreter.

    The message always names the offending step.  When the hook can
    localize the divergence by re-tracing the graph node-by-node, ``node``
    holds the first divergent node's id and ``branch`` its branch path, and
    the message names both.
    """

    def __init__(self, step: str, detail: str, *,
                 node: str | None = None, branch: str | None = None):
        self.step = step
        self.node = node
        self.branch = branch
        super().__init__(f"verification failed after step {step!r}: {detail}")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Declarative build recipe consumed by :func:`repro_torch.build.build`.

    target: ``interpret`` (eager reference only), ``engine``
        (FusedEngine), ``pipeline`` (the engine's steps, for
        :meth:`Accelerator.as_pipeline`) or ``serving`` (the engine plus
        the ``calibrate`` step, for :meth:`Accelerator.serve`).
    mode / weight_bits / act_bits / backend: lowering parameters
        (``lowering.lower_to_mvu``); mode is ``"standard"``, ``"binary"``
        or ``"xnor"`` (paper Fig. 4); backend is ``"cuda"`` (the hand
        kernels) or ``"torch"`` (the plain oracles).
    folding: ``"balance"`` rate-balances every stage, ``"none"`` keeps
        heuristic per-layer defaults, or an explicit sequence of
        :class:`Folding`, one per MVU node in chain order (the paper's
        Table 6 PE/SIMD choices).
    tune: ``"off"``; ``"cache"`` pins the schedules recorded in
        ``cache`` (no measurement); ``"auto"`` measures the misses on the
        build's device first (``autotune.tune_graph``), through the hand
        kernels on the card.  The engine's microbatch tile comes from the
        cache's ``engine_key`` entry (``autotune.tune_engine``).
    cache: the :class:`~repro_torch.core.autotune.ScheduleCache` the tune
        and calibrate steps read and fill (default with tune on:
        ``autotune.default_cache()``).
    tune_kwargs: forwarded to ``autotune.tune_graph`` / ``tune_node``
        (``sample_m``, ``reps``, ``max_measure``, ``margin``, ...);
        ``"device"`` there is the cache scope, a device-kind string
        (default: the kind of the build's device).
    pack: ``"auto"`` packs the nodes whose tuned schedule chose the
        packed datapath, ``"never"`` keeps canonical storage (and keeps
        the tuner off the packed datapath), ``"always"`` packs every
        packable node (``lowering.packable``).
    calibrate_batch / calibrate_reps: batch size and timed repetitions of
        the ``calibrate`` step (``serving`` target): the minimum over the
        repetitions sets the measured seconds per cycle.
    verify: ``"all"`` re-runs a probe batch through the reference
        interpreter after every graph transform and checks bit-exactness,
        the engine included; ``"off"`` skips.
    steps: override the target's default step list with names from the
        step registry and/or custom callables ``step(state) -> state``.
    name / output_dir: report identity; the BuildReport is written to
        ``<output_dir>/<name>_build_report.json`` only when ``output_dir``
        is set.
    telemetry: trace every build step with a
        :class:`repro_torch.telemetry.Tracer` (one ``step.<name>`` span
        each, ``cat="build"``) and embed the span summary in
        ``BuildReport.telemetry`` (zero cost when False).
    device: where the built design runs.  None means ``"cuda"``, and the
        build raises when CUDA is absent (pass ``device="cpu"`` to run the
        kernels' plain versions on the CPU).
    graph: optional -- lets ``build(config)`` be called with the config
        alone (``build(graph, config)`` wins when both are given).
    """

    target: str = "engine"
    # lowering
    mode: str = "standard"
    weight_bits: int = 4
    act_bits: int = 4
    backend: str = "cuda"
    # folding
    folding: Sequence[Folding] | str = FOLD_BALANCE
    target_cycles: int | None = None
    max_pe: int = 128
    max_simd: int = 128
    # autotune
    tune: str = "off"
    cache: Any = None  # ScheduleCache | None
    tune_kwargs: dict | None = None
    pack: str = "auto"
    # engine
    microbatches: int | None = None
    # serving calibration (target="serving")
    calibrate_batch: int = 32
    calibrate_reps: int = 3
    # verification + report
    verify: str = "all"
    probe_batch: int = 8
    seed: int = 0
    steps: Sequence[Any] | None = None
    name: str = "build"
    output_dir: str | None = None
    telemetry: bool = False
    device: str | torch.device | None = None
    graph: Any = None

    def __post_init__(self):
        if self.target not in TARGETS:
            raise BuildError(f"target must be one of {TARGETS}, got {self.target!r}")
        if self.tune not in TUNE_MODES:
            raise BuildError(f"tune must be one of {TUNE_MODES}, got {self.tune!r}")
        if self.verify not in VERIFY_MODES:
            raise BuildError(
                f"verify must be one of {VERIFY_MODES}, got {self.verify!r}")
        if self.pack not in PACK_MODES:
            raise BuildError(
                f"pack must be one of {PACK_MODES}, got {self.pack!r}")
        if isinstance(self.folding, str) and self.folding not in (
                FOLD_BALANCE, FOLD_NONE):
            raise BuildError(
                f"folding must be {FOLD_BALANCE!r}, {FOLD_NONE!r} or a "
                f"sequence of Folding, got {self.folding!r}")

    def resolved_device(self) -> torch.device:
        """The device the built design runs on (see the ``device`` field)."""
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise BuildError(
                "no CUDA device is available and no device was given: pass "
                "device='cpu' to build for the CPU (the kernels' plain versions)")
        return torch.device("cuda")

    def snapshot(self) -> dict:
        """JSON-safe view of the config for the BuildReport (graph, cache
        and callables are identified, not serialized)."""
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in ("graph", "cache"):
                d[f.name] = None if v is None else type(v).__name__
            elif f.name == "steps":
                d[f.name] = None if v is None else [
                    s if isinstance(s, str) else getattr(s, "__name__", repr(s))
                    for s in v]
            elif f.name == "folding" and not isinstance(v, str):
                d[f.name] = [[fold.pe, fold.simd] for fold in v]
            elif f.name == "device":
                d[f.name] = None if v is None else str(v)
            else:
                d[f.name] = v
        return d
