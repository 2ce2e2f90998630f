"""``repro_torch.explore``: cached design-space exploration over the port's
build, the counterpart of the JAX package's ``repro.explore``.

The paper sweeps every Table 2 configuration across PE/SIMD foldings and
reads resource, timing, and synthesis-time curves off the reports; this
package is that experimental loop over the ``repro_torch.build`` pipeline
-- sweep grid, Pareto frontier, whole-sweep resource-model calibration,
and the cold/warm autotune-cache phase (the synthesis-time-cache analog).
On the card each point launches the hand kernels at the tiles its
foldings map to.

    python -m repro_torch.explore --config nid_mlp --quick

runs on the card and writes
``experiments/explore_torch/nid_mlp_quick_explore.json``; on a host
without one, pass ``build_overrides={"device": "cpu"}`` to
:class:`ExploreConfig`.
"""

from repro_torch.explore.explorer import (
    PARETO_MAXIMIZE,
    PARETO_MINIMIZE,
    ExploreConfig,
    explore,
    load_record,
    save_record,
)
from repro_torch.explore.grid import (
    LayerShape,
    SweepPoint,
    clamp_folding,
    layer_shapes,
    sweep_grid,
)
from repro_torch.explore.pareto import dominates, pareto_front

__all__ = [
    "ExploreConfig",
    "LayerShape",
    "PARETO_MAXIMIZE",
    "PARETO_MINIMIZE",
    "SweepPoint",
    "clamp_folding",
    "dominates",
    "explore",
    "layer_shapes",
    "load_record",
    "pareto_front",
    "save_record",
    "sweep_grid",
]
