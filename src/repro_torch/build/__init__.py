"""``repro_torch.build``: the FINN-style step-pipeline compiler front-end.

    import repro_torch.build as build

    acc = build.build(
        graph,                      # raw chain: input/linear/bn/quant
        target="engine",            # interpret | engine | pipeline | serving
        mode="standard", weight_bits=2, act_bits=2,
        folding="balance",          # or "none", or explicit [Folding, ...]
        device="cuda",              # default; "cpu" runs the plain versions
    )
    y = acc(x)                      # fused streaming engine on the device
    assert torch.equal(y, acc.interpret(x))   # verified per-step anyway

Every transform is verified bit-exact against the reference interpreter
on a probe batch; a divergence raises :class:`VerificationError` naming
the offending step.
"""

from __future__ import annotations

import dataclasses

from repro_torch.build.accelerator import Accelerator
from repro_torch.build.config import (
    BuildConfig,
    BuildError,
    VerificationError,
)
from repro_torch.build.report import BuildReport, NodeReport, StepRecord
from repro_torch.build.steps import (
    DEFAULT_STEPS,
    STEP_REGISTRY,
    BuildState,
    default_steps,
    register_step,
    run_pipeline,
)

__all__ = [
    "Accelerator",
    "BuildConfig",
    "BuildError",
    "BuildReport",
    "BuildState",
    "DEFAULT_STEPS",
    "NodeReport",
    "STEP_REGISTRY",
    "StepRecord",
    "VerificationError",
    "build",
    "default_steps",
    "register_step",
]


def build(graph_or_config, config: BuildConfig | None = None,
          **overrides) -> Accelerator:
    """Run the step pipeline and return the :class:`Accelerator`.

    ``graph_or_config`` is either a raw IR graph (then ``config`` /
    keyword overrides supply the recipe) or a :class:`BuildConfig` whose
    ``graph`` field carries it.  Keyword overrides apply on top of the
    config in both forms: ``build(graph, target="engine", device="cpu")``.
    """
    if isinstance(graph_or_config, BuildConfig):
        cfg = graph_or_config
        graph = cfg.graph
        if graph is None:
            raise BuildError(
                "build(config) needs config.graph; or call build(graph, config)")
    else:
        graph = graph_or_config
        cfg = config if config is not None else BuildConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return Accelerator(run_pipeline(graph, cfg))
