"""The Accelerator facade: one object per built dataflow design.

    acc = repro_torch.build.build(graph, target="engine", device="cuda", ...)
    y   = acc.interpret(x)     # eager reference (bit-exact contract)
    y   = acc(x)               # fused streaming engine
    y, plan = acc.profile(x, Tracer())   # per-node spans, bit-exact with acc(x)
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
                "step; rebuild with target='engine' or a step list "
                "containing 'engine'")
        return self._engine

    def interpret(self, x) -> torch.Tensor:
        """Eager reference semantics (``dataflow.execute``) on the unfused
        graph, on the build's device."""
        return dataflow.execute(self.ref_graph, torch.as_tensor(x, device=self.device))

    def __call__(self, x) -> torch.Tensor:
        return self.engine(x) if self._engine is not None else self.interpret(x)

    def dispatch(self, x, *, tracer=None):
        """Non-blocking engine submit (see ``FusedEngine.dispatch``)."""
        return self.engine.dispatch(x, tracer=tracer)

    def profile(self, x, tracer, *, drift=None):
        """Traced per-node eager re-execution (``FusedEngine.profile``):
        bit-exact with ``acc(x)``, one span per node, optionally feeding a
        :class:`~repro_torch.telemetry.DriftMonitor`."""
        return self.engine.profile(x, tracer, drift=drift)

    def drift_monitor(self, **kwargs):
        """A :class:`~repro_torch.telemetry.DriftMonitor` primed with the
        build's per-stage predicted intervals needs a *calibrated* cycle
        time (the serving target's ``calibrate`` step, ROADMAP queue A item
        4): against the nominal clock the measured/predicted ratios are
        meaningless.  No step of the port calibrates yet, so this raises."""
        raise BuildError(
            "drift_monitor() needs a calibrated cycle time; rebuild with "
            "target='serving' (the 'calibrate' step, ROADMAP queue A item 4) so "
            "per-stage predictions reflect measured seconds, not the nominal clock")

    @property
    def schedule(self):
        return (self._engine.schedule if self._engine is not None
                else dataflow.schedule(self.graph))

    def plan(self, batch: int):
        return self.engine.plan(batch)

    def serve(self, *args, **kwargs):
        raise NotImplementedError("serving is ROADMAP queue A item 4")

    def as_pipeline(self, *args, **kwargs):
        return self.engine.as_pipeline(*args, **kwargs)

    # --------------------------------------------------------------- report
    def report_path(self) -> str:
        out_dir = self.config.output_dir or "."
        return os.path.join(out_dir, f"{self.config.name}_build_report.json")

    def save_report(self, path: str | None = None) -> str:
        """Serialize the BuildReport (default: ``<output_dir>/<name>_
        build_report.json``)."""
        return self.report.save(path if path is not None else self.report_path())
