"""The Accelerator facade: one object per built dataflow design.

    acc = repro_torch.build.build(graph, target="serving", device="cuda", ...)
    y   = acc.interpret(x)     # eager reference (bit-exact contract)
    y   = acc(x)               # fused streaming engine
    y, plan = acc.profile(x, Tracer())   # per-node spans, bit-exact with acc(x)
    b   = acc.serve(batch_buckets=(1, 8, 32, 128))   # continuous batcher
    acc.report                  # the BuildReport (JSON-serializable)

Both facings run on the build's device: the constructor moves the
reference graph's integer params there.
"""

from __future__ import annotations

import os

import torch

from repro_torch.build.config import BuildError
from repro_torch.build.report import BuildReport
from repro_torch.build.steps import BuildState
from repro_torch.core import dataflow


class Accelerator:
    """A built dataflow design: interpreter + engine, one handle.

    Constructed by :func:`repro_torch.build.build`; never directly.
    ``graph`` is the final (fused) graph, ``ref_graph`` the first
    executable snapshot the verification hooks pinned -- the unfused
    reference the engine is held to.
    """

    def __init__(self, state: BuildState):
        self.config = state.cfg
        self.device: torch.device = state.device
        self.graph = dataflow.graph_to(state.graph, self.device)
        ref = state.ref_graph if state.ref_graph is not None else state.graph
        self.ref_graph = dataflow.graph_to(ref, self.device)
        self.report: BuildReport = state.report
        self.cache = state.cache
        self.calibration = state.calibration
        # build-step Tracer when cfg.telemetry was set (None otherwise);
        # its summary is already embedded in report.telemetry
        self.tracer = state.tracer
        self._engine = state.engine
        if self.config.output_dir:
            self.save_report()

    # -------------------------------------------------------------- compute
    @property
    def engine(self):
        """The :class:`~repro_torch.core.engine.FusedEngine`."""
        if self._engine is None:
            raise BuildError(
                f"this build (target={self.config.target!r}) ran no 'engine' "
                "step; rebuild with target='engine'/'serving' or a step "
                "list containing 'engine'")
        return self._engine

    def interpret(self, x) -> torch.Tensor:
        """Eager reference semantics (``dataflow.execute``) on the unfused
        graph, on the build's device."""
        return dataflow.execute(self.ref_graph, torch.as_tensor(x, device=self.device))

    def __call__(self, x) -> torch.Tensor:
        return self.engine(x) if self._engine is not None else self.interpret(x)

    def dispatch(self, x, *, params=None, tracer=None):
        """Non-blocking engine submit (see ``FusedEngine.dispatch``)."""
        return self.engine.dispatch(x, params=params, tracer=tracer)

    def profile(self, x, tracer, *, drift=None):
        """Traced per-node eager re-execution (``FusedEngine.profile``):
        bit-exact with ``acc(x)``, one span per node, optionally feeding a
        :class:`~repro_torch.telemetry.DriftMonitor`."""
        return self.engine.profile(x, tracer, drift=drift)

    def drift_monitor(self, **kwargs):
        """A :class:`~repro_torch.telemetry.DriftMonitor` primed with this
        build's per-stage predicted intervals (stage cycles x the
        *calibrated* cycle time).  Requires a ``target="serving"`` build
        (or any step list that ran ``calibrate``): against the nominal
        clock the measured/predicted ratios are meaningless."""
        from repro_torch.telemetry import DriftMonitor

        s_per_cycle = (self.calibration or {}).get("s_per_cycle")
        if not s_per_cycle:
            raise BuildError(
                "drift_monitor() needs a calibrated cycle time; rebuild "
                "with target='serving' (the 'calibrate' step) so per-stage "
                "predictions reflect measured seconds, not the nominal clock")
        return DriftMonitor.from_schedule(
            self.schedule, float(s_per_cycle), **kwargs)

    @property
    def schedule(self):
        return (self._engine.schedule if self._engine is not None
                else dataflow.schedule(self.graph))

    def plan(self, batch: int):
        return self.engine.plan(batch)

    # -------------------------------------------------------------- serving
    def serve(self, *, warmup: bool = True, cache=None,
              fault_policy=None, faults=None, **kwargs):
        """A :class:`~repro_torch.serving.batcher.ContinuousBatcher` over
        the engine.  The build's cache (holding the calibrated cycle time
        when the ``serving`` target ran) feeds the flush budgets unless an
        explicit ``cache`` overrides it; ``warmup`` runs every bucket shape
        on every replica (and the golden canary) before traffic arrives.

        ``fault_policy`` (a :class:`~repro_torch.serving.health.FaultPolicy`)
        tunes the failure handling -- retries, dispatch timeouts, hedging,
        the integrity guard and brownout; the default policy is enabled.
        ``faults`` injects a deterministic
        :class:`~repro_torch.serving.faults.FaultPlan` (chaos testing only).
        ``tracer=``/``drift=`` (forwarded to the batcher) wire telemetry:
        pair with :meth:`drift_monitor` for calibrated predictions."""
        from repro_torch.serving import ContinuousBatcher

        batcher = ContinuousBatcher(
            self.engine, cache=cache if cache is not None else self.cache,
            fault_policy=fault_policy, faults=faults, **kwargs)
        return batcher.warmup() if warmup else batcher

    # ------------------------------------------------------------- pipeline
    def as_pipeline(self, devices, *, tracer=None):
        """Map the stage chain onto GPipe stages, one a device of
        ``devices`` (``FusedEngine.as_pipeline``)."""
        return self.engine.as_pipeline(devices, tracer=tracer)

    # --------------------------------------------------------------- report
    def report_path(self) -> str:
        out_dir = self.config.output_dir or "."
        return os.path.join(out_dir, f"{self.config.name}_build_report.json")

    def save_report(self, path: str | None = None) -> str:
        """Serialize the BuildReport (default: ``<output_dir>/<name>_
        build_report.json``)."""
        return self.report.save(path if path is not None else self.report_path())
