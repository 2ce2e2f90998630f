"""Sweep-grid construction: the PE x SIMD design space as build points.

The paper's experimental core is a grid: every configuration of Table 2 is
re-synthesized across PE and SIMD values and the resource/timing curves are
read off the sweep.  Our design dimension is the same folding algebra
(``core.folding``), so a sweep point is simply *one legal folding per MVU
stage* -- which :func:`repro_torch.build.build` accepts verbatim as its
``folding=[Folding, ...]`` override.  This module turns (pe_target,
simd_target) grid coordinates into those per-stage folding lists:

* targets are clamped per layer to the largest legal divisor (PE | N,
  SIMD | K -- the paper keeps divisibility by construction, we enforce it),
* points whose *realized* foldings coincide are deduplicated (a 64-wide
  target and a 128-wide target collapse onto the same design when every
  layer tops out at 64),
* the default target axes are powers of two up to the largest layer
  dimension, so small and large designs both appear (the paper's Figs 8-15
  x-axes).

The JAX package's ``explore/grid.py`` on the port's ``ir`` and
``folding``: the same grid, point for point.  On the card a point's
foldings also pick each layer's compiled kernel tile
(``folding.to_gpu_blocks``: PE rounded up to the tile's output columns,
SIMD to its K step), so the folding axis reaches the launches.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ir
from repro_torch.core.folding import Folding, divisors
from repro_torch.core.ir import Graph


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One MVU stage of the lowered chain, as the grid sees it."""

    name: str
    n: int
    k: int
    n_pixels: int


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One design point: grid coordinates + the realized per-stage foldings.

    ``packed`` is the weight-storage coordinate of the joint folding x
    packing space: True builds the point with ``pack="always"`` (bit-packed
    weights + packed datapath on every packable stage), False with
    ``pack="never"`` (canonical storage).
    """

    point_id: str
    pe_target: int
    simd_target: int
    foldings: tuple[Folding, ...]
    packed: bool = False

    def as_dict(self) -> dict:
        return {
            "point_id": self.point_id,
            "pe_target": self.pe_target,
            "simd_target": self.simd_target,
            "foldings": [[f.pe, f.simd] for f in self.foldings],
            "packed": self.packed,
        }


def layer_shapes(graph: Graph) -> list[LayerShape]:
    """The (N, K, n_pixels) of every MVU stage of a *lowered* graph, in
    dataflow (topological) order."""
    shapes: list[LayerShape] = []
    for node, _, out_shape in ir.io_shapes(graph):
        if node.op not in ("mvu", "conv_mvu"):
            continue
        cfg = node.attrs["config"]
        shapes.append(LayerShape(node.name, cfg.out_features,
                                 cfg.in_features, ir.n_pixels(out_shape)))
    return shapes


def clamp_folding(n: int, k: int, pe_target: int, simd_target: int) -> Folding:
    """Largest legal folding at or under the targets (PE | N, SIMD | K)."""
    pe = max(d for d in divisors(n) if d <= max(pe_target, 1))
    simd = max(d for d in divisors(k) if d <= max(simd_target, 1))
    return Folding(pe, simd)


def _pow2_axis(limit: int) -> tuple[int, ...]:
    vals = [1]
    while vals[-1] < limit:
        vals.append(vals[-1] * 4)
    return tuple(vals)


def sweep_grid(
    shapes: list[LayerShape],
    pe_targets: tuple[int, ...] | None = None,
    simd_targets: tuple[int, ...] | None = None,
    packings: tuple[bool, ...] = (False,),
) -> list[SweepPoint]:
    """The deduplicated design grid for one workload.

    Every (pe_target, simd_target) pair becomes a point whose per-stage
    foldings are the targets clamped to each layer's divisors; pairs that
    realize identical folding lists are merged (the first grid coordinate
    wins, so point ids stay stable as axes grow).  ``packings`` crosses the
    weight-storage axis into the grid: each realized folding appears once
    per packing, so ``(False, True)`` sweeps the joint folding x packing
    space (packed point ids carry a ``_packed`` suffix).
    """
    if not shapes:
        raise ValueError("sweep_grid needs at least one MVU layer shape")
    if pe_targets is None:
        pe_targets = _pow2_axis(max(s.n for s in shapes))
    if simd_targets is None:
        simd_targets = _pow2_axis(max(s.k for s in shapes))
    points: list[SweepPoint] = []
    seen: set[tuple] = set()
    for pe_t in pe_targets:
        for simd_t in simd_targets:
            folds = tuple(clamp_folding(s.n, s.k, pe_t, simd_t)
                          for s in shapes)
            for packed in packings:
                key = (tuple((f.pe, f.simd) for f in folds), bool(packed))
                if key in seen:
                    continue
                seen.add(key)
                suffix = "_packed" if packed else ""
                points.append(SweepPoint(f"pe{pe_t}_simd{simd_t}{suffix}",
                                         int(pe_t), int(simd_t), folds,
                                         packed=bool(packed)))
    return points
