"""BuildReport: the software analog of the paper's resource/synthesis tables.

The paper reports LUT/FF/BRAM counts, cycle counts, and synthesis time per
design point (Tables 3-7); FINN's ``build_dataflow`` writes per-step
reports next to the build output.  ``BuildReport`` carries the same story
for one :func:`repro_torch.build.build` run:

* per-step wall-clock + verification outcome + op histogram (the
  "synthesis time" table: where the build spends its time),
* per-node folding and resource-model estimates (the LUT/FF/BRAM-analog
  table: ``resource_model.mvu_resources`` per MVU/conv stage),
* the dataflow schedule summary with the predicted steady-state interval
  (nominal clock) next to the measured one when a calibrated cycle time is
  available (predicted vs measured, the paper's RTL-vs-HLS split),
* autotune accounting (cache hits / misses / engine microbatch tile).

Everything round-trips through JSON (``to_json`` / ``from_json`` /
``save`` / ``load``) so reports diff cleanly and can be committed next to
the autotune cache under ``experiments/``.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class StepRecord:
    """One executed build step."""

    name: str
    wall_s: float
    verified: bool | None  # None: nothing to verify after this step
    ops: dict[str, int]  # op histogram of the graph after the step
    note: str = ""


@dataclasses.dataclass
class NodeReport:
    """Per-MVU-stage folding + resource estimate (paper Tables 3/6/7)."""

    name: str
    op: str
    mode: str
    n: int
    k: int
    pe: int
    simd: int
    n_pixels: int
    cycles: int
    lut_bytes: int
    ff_bytes: int
    bram_bytes: int
    backend: str
    tuned: bool
    # DAG topology: the stage's input streams and which branch path of a
    # fan-out it sits on ("main" for the trunk).  Defaults keep reports
    # serialized before the DAG IR loadable.
    inputs: list = dataclasses.field(default_factory=list)
    branch: str = "main"
    # packed-datapath decision + HBM-resident weight bytes as stored vs
    # the canonical (unpacked) form.  Defaults (0 = unrecorded) keep
    # reports serialized before the packed datapath loadable.
    packed: bool = False
    weight_bytes: int = 0
    canonical_weight_bytes: int = 0


@dataclasses.dataclass
class BuildReport:
    """Everything one build run learned, JSON-serializable."""

    name: str
    target: str
    config: dict = dataclasses.field(default_factory=dict)
    steps: list[StepRecord] = dataclasses.field(default_factory=list)
    nodes: list[NodeReport] = dataclasses.field(default_factory=list)
    # serialized topology: every [producer, consumer] stream edge of the
    # final graph (chains serialize to the obvious path; fan-out/fan-in
    # graphs make the branch structure diffable)
    edges: list = dataclasses.field(default_factory=list)
    schedule: dict = dataclasses.field(default_factory=dict)
    tune: dict = dataclasses.field(default_factory=dict)
    # design-space exploration (``repro_torch.explore``): when this build is one point
    # of a sweep, ``sweep`` identifies the point (grid coordinates + the
    # realized per-node foldings) and ``calibration`` carries the fitted
    # cycle time + per-node model-error records the explorer attributed to
    # this design.  Empty dicts for standalone builds.
    sweep: dict = dataclasses.field(default_factory=dict)
    calibration: dict = dataclasses.field(default_factory=dict)
    # build-step trace summary (``Tracer.summary()``) when the config ran
    # with ``telemetry=True``; empty otherwise (old reports load fine)
    telemetry: dict = dataclasses.field(default_factory=dict)
    predicted_interval_s: float | None = None
    measured_interval_s: float | None = None
    cycle_time_source: str = "nominal"  # "nominal" | "measured"
    total_wall_s: float = 0.0
    path: str | None = None

    # ------------------------------------------------------------- recording
    def record_step(self, name: str, wall_s: float, verified: bool | None,
                    ops: dict[str, int], note: str = "") -> StepRecord:
        rec = StepRecord(name, float(wall_s), verified, dict(ops), note)
        self.steps.append(rec)
        return rec

    @property
    def step_names(self) -> list[str]:
        return [s.name for s in self.steps]

    def summary(self) -> dict:
        """The one-line view examples print."""
        return {
            "name": self.name,
            "target": self.target,
            "steps": self.step_names,
            "verified_steps": sum(1 for s in self.steps if s.verified),
            "nodes": len(self.nodes),
            "interval_cycles": self.schedule.get("interval_cycles"),
            "bottleneck": self.schedule.get("bottleneck"),
            "predicted_interval_s": self.predicted_interval_s,
            "measured_interval_s": self.measured_interval_s,
            "tune": dict(self.tune),
            "total_wall_s": round(self.total_wall_s, 4),
            **({"sweep_point": self.sweep.get("point_id")} if self.sweep else {}),
        }

    # ----------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("path")
        return d

    @classmethod
    def from_json(cls, d: dict) -> "BuildReport":
        d = dict(d)
        steps = [StepRecord(**s) for s in d.pop("steps", [])]
        nodes = [NodeReport(**n) for n in d.pop("nodes", [])]
        d.pop("path", None)
        rep = cls(**d)
        rep.steps = steps
        rep.nodes = nodes
        return rep

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "BuildReport":
        with open(path) as f:
            rep = cls.from_json(json.load(f))
        rep.path = path
        return rep
