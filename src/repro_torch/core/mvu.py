"""The MVU layer: FINN's Matrix-Vector-Threshold Unit on PyTorch tensors.

:class:`MVULayer` is the faithful FINN unit: integer tensors in, integer
activations out through the fused multi-threshold epilogue (or a float32
dequant scale on the last layer).  ``quantized_linear``, the LM facing,
comes with the LM slice (ROADMAP queue A item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.folding import Folding, choose_folding
from repro_torch.core.quantize import QTensor, int_bounds, quantize_weights
from repro_torch.core.resource_model import MVUResources, mvu_resources
from repro_torch.core.thresholds import integerize_thresholds
from repro_torch.kernels import ops


def _standard_only(cfg: "MVUConfig") -> None:
    if cfg.mode != "standard" or cfg.packed:
        raise NotImplementedError(
            f"mode={cfg.mode!r}, packed={cfg.packed}: only the standard "
            "unpacked datapath is ported; binary/xnor and packed weights are "
            "ROADMAP queue B rows 2-6")


@dataclasses.dataclass(frozen=True)
class MVUConfig:
    in_features: int  # K = Kd^2 * I_c
    out_features: int  # N = O_c
    mode: str = "standard"  # xnor | binary | standard
    weight_bits: int = 4
    act_bits: int = 4  # output activation precision when thresholds are used
    folding: Folding | None = None  # None = fully parallel
    backend: str = "cuda"
    packed: bool = False  # bit-packed weight storage + packed datapath
    block_m: int = 128  # samples per stream burst (the engine's microbatch)

    def resolved_folding(self) -> Folding:
        if self.folding is not None:
            # An explicit folding is a schedule claim: PE | N and SIMD | K
            # (FINN's legality condition), rejected here at config time.
            self.folding.validate(self.out_features, self.in_features)
            return self.folding
        return choose_folding(self.out_features, self.in_features)


@dataclasses.dataclass
class MVUParams:
    """Deployed (post-streamlining) parameters of one MVU instance."""

    weights: torch.Tensor  # (N, K) int8
    thresholds: torch.Tensor | None  # (N, T) int32, ascending
    out_scale: torch.Tensor | None  # (N,) float32 dequant scale

    def to(self, device) -> "MVUParams":
        def mv(t):
            return None if t is None else t.to(device)

        return MVUParams(mv(self.weights), mv(self.thresholds), mv(self.out_scale))


class MVULayer:
    def __init__(self, config: MVUConfig):
        self.config = config

    def init_params(self, generator: torch.Generator, device=None) -> MVUParams:
        """Random integer weights on the mode's grid (tests/benchmarks)."""
        cfg = self.config
        _standard_only(cfg)
        lo, hi = int_bounds(cfg.weight_bits, signed=True)
        w = torch.randint(lo, hi + 1, (cfg.out_features, cfg.in_features),
                          generator=generator, dtype=torch.int8)
        return MVUParams(weights=w.to(device), thresholds=None, out_scale=None)

    @staticmethod
    def from_float(
        config: MVUConfig,
        w_float: torch.Tensor,
        thresholds: torch.Tensor | None = None,
    ) -> tuple[MVUParams, QTensor]:
        """Quantize trained float weights (N, K) onto the MVU grid."""
        _standard_only(config)
        qt = quantize_weights(w_float, config.weight_bits)
        t = None if thresholds is None else integerize_thresholds(thresholds)
        scale = None if t is not None else qt.scale.reshape(-1).to(torch.float32)
        return MVUParams(weights=qt.values, thresholds=t, out_scale=scale), qt

    def __call__(self, params: MVUParams, x: torch.Tensor) -> torch.Tensor:
        """x: (..., K) integers -> (..., N)."""
        cfg = self.config
        _standard_only(cfg)
        lead = x.shape[:-1]
        out = ops.mvu(
            x.reshape(-1, x.shape[-1]), params.weights, cfg.mode,
            thresholds=params.thresholds, out_scale=params.out_scale,
            backend=cfg.backend,
        )
        return out.reshape(*lead, cfg.out_features)

    def resources(self, n_pixels: int = 1) -> MVUResources:
        cfg = self.config
        return mvu_resources(
            cfg.out_features, cfg.in_features, cfg.resolved_folding(),
            mode=cfg.mode, weight_bits=cfg.weight_bits, n_pixels=n_pixels,
            packed=cfg.packed,
        )
