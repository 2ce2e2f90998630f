"""The MVU layer: FINN's Matrix-Vector-Threshold Unit on PyTorch tensors.

:class:`MVULayer` is the faithful FINN unit: integer tensors in, integer
activations out through the fused multi-threshold epilogue (or a float32
dequant scale on the last layer).

:func:`quantized_linear` is the LM facing: float activations are
dynamically quantized, pushed through the integer MVU datapath (the hand
``mvu_int`` / ``mvu_binary`` kernels), and dequantized.  It is the
projection of ``models/layers.py::linear`` for the integer-deployed
``mvu_*`` backends.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.folding import Folding, choose_folding, to_gpu_blocks
from repro_torch.core.quantize import QTensor, int_bounds, quantize_weights
from repro_torch.core.resource_model import MVUResources, mvu_resources
from repro_torch.core.thresholds import integerize_thresholds
from repro_torch.kernels import ops, packing
from repro_torch.kernels.mvu_packed import pack_mvu_weights


def coded_weights(mode: str, values: torch.Tensor) -> torch.Tensor:
    """Integer weight values (N, K) in the mode's canonical storage: xnor
    packs the bipolar rows into 32-bit words, binary keeps them as {0,1}
    int8 rows, standard as they are."""
    if mode == "xnor":
        return packing.pack_bits(packing.bipolar_to_bits(values))
    if mode == "binary":
        return packing.bipolar_to_bits(values).to(torch.int8)
    return values


@dataclasses.dataclass(frozen=True)
class KernelBlocks:
    """An explicit tile schedule for one MVU instance, in the JAX package's
    fields.

    ``folding.to_gpu_blocks`` derives one from a (PE, SIMD) folding; the
    autotuner (``repro_torch.core.autotune``) instead races the compiled
    tiles and pins the winner here.  ``block_m`` is the node's burst
    (``MVUConfig.block_m``, the engine's microbatch); ``block_n`` and
    ``block_k`` (``block_kw`` on the word datapaths) pick the kernel's
    output columns a block and K step, and ``rows_per_tile`` its output
    rows a block (dense rows; a conv's rows of pixels), each rounded up
    onto the compiled set (``kernels/dense_mvu.py::dense_tile``,
    ``kernels/swu_mvu.py::conv_tile``).  Hashable so tuned configs stay
    usable as set and dict members like untuned ones.
    """

    block_m: int = 128
    block_n: int = 128
    block_k: int = 128
    block_kw: int = 8  # packed-word K step (xnor and packed binary)
    rows_per_tile: int | None = None  # conv line-buffer rows per grid step

    def as_kwargs(self, mode: str, packed: bool = False) -> dict[str, int]:
        """The tile kwargs the kernel entry points take (the conv path
        ignores the K blocks; both paths accept the full set).  The packed
        binary datapath steps K in 32-bit words like xnor, so it takes
        ``block_kw``."""
        if mode == "xnor" or (packed and mode == "binary"):
            out = {"block_m": self.block_m, "block_n": self.block_n,
                   "block_kw": self.block_kw}
        else:
            out = {"block_m": self.block_m, "block_n": self.block_n,
                   "block_k": self.block_k}
        if self.rows_per_tile is not None:
            out["rows_per_tile"] = self.rows_per_tile
        return out

    @classmethod
    def from_blocks(cls, blocks: dict) -> "KernelBlocks":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in blocks.items()
                      if k in known and v is not None})


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
    blocks: KernelBlocks | None = None  # explicit (tuned) schedule wins

    def resolved_folding(self) -> Folding:
        if self.folding is not None:
            # An explicit folding is a schedule claim: PE | N and SIMD | K
            # (FINN's legality condition), rejected here at config time.
            self.folding.validate(self.out_features, self.in_features)
            return self.folding
        return choose_folding(self.out_features, self.in_features)

    def kernel_blocks(self) -> dict[str, int]:
        """The schedule's tile kwargs: the tuned ``blocks`` where pinned,
        else the folding's (``folding.to_gpu_blocks``) at the node's
        burst.  The untuned path resolves the folding, so an illegal
        explicit folding raises here too."""
        if self.blocks is not None:
            return self.blocks.as_kwargs(self.mode, self.packed)
        return to_gpu_blocks(self.resolved_folding(), self.mode, self.block_m,
                             packed=self.packed)


@dataclasses.dataclass
class MVUParams:
    """Deployed (post-streamlining) parameters of one MVU instance."""

    weights: torch.Tensor  # xnor: packed (N, Wd) int32 words; else (N, K) int8
    thresholds: torch.Tensor | None  # (N, T) int32, ascending
    out_scale: torch.Tensor | None  # (N,) float32 dequant scale

    def to(self, device) -> "MVUParams":
        def mv(t):
            return None if t is None else t.to(device)

        return MVUParams(mv(self.weights), mv(self.thresholds), mv(self.out_scale))


class MVULayer:
    def __init__(self, config: MVUConfig):
        self.config = config

    @functools.cached_property
    def blocks(self) -> dict[str, int]:
        """The config's tile kwargs (``MVUConfig.kernel_blocks``), resolved
        once: every call launches that tile."""
        return self.config.kernel_blocks()

    def init_params(self, generator: torch.Generator, device=None) -> MVUParams:
        """Random integer weights on the mode's grid (tests/benchmarks)."""
        cfg = self.config
        n, k = cfg.out_features, cfg.in_features
        if cfg.mode in ("xnor", "binary"):
            w = torch.randint(0, 2, (n, k), generator=generator, dtype=torch.int8)
            if cfg.mode == "xnor":
                w = packing.pack_bits(w)
        else:
            lo, hi = int_bounds(cfg.weight_bits, signed=True)
            w = torch.randint(lo, hi + 1, (n, k), generator=generator, dtype=torch.int8)
        if cfg.packed:
            w = pack_mvu_weights(w, cfg.mode)
        return MVUParams(weights=w.to(device), thresholds=None, out_scale=None)

    @staticmethod
    def from_float(
        config: MVUConfig,
        w_float: torch.Tensor,
        thresholds: torch.Tensor | None = None,
    ) -> tuple[MVUParams, QTensor]:
        """Quantize trained float weights (N, K) onto the MVU grid: 1-bit
        bipolar for xnor (packed words) and binary ({0,1} int8 rows)."""
        binarized = config.mode in ("xnor", "binary")
        qt = quantize_weights(w_float, 1 if binarized else config.weight_bits)
        w = coded_weights(config.mode, qt.values)
        if config.packed:
            w = pack_mvu_weights(w, config.mode)
        t = None if thresholds is None else integerize_thresholds(thresholds)
        scale = None if t is not None else qt.scale.reshape(-1).to(torch.float32)
        return MVUParams(weights=w, thresholds=t, out_scale=scale), qt

    def __call__(self, params: MVUParams, x: torch.Tensor) -> torch.Tensor:
        """x: (..., K) integers (standard/binary) or (..., Wd) int32 words (xnor)."""
        cfg = self.config
        w = params.weights
        if cfg.packed and cfg.mode != "xnor" and w.dtype == torch.int8:
            # packed datapath selected but storage not yet rewritten (before
            # the pack_weights step): pack on the fly so the graph runs
            w = pack_mvu_weights(w, cfg.mode)
        lead = x.shape[:-1]
        out = ops.mvu(
            x.reshape(-1, x.shape[-1]), w, cfg.mode,
            k_bits=cfg.in_features if cfg.mode == "xnor" or cfg.packed else None,
            thresholds=params.thresholds, out_scale=params.out_scale,
            backend=cfg.backend, packed=cfg.packed, **self.blocks,
        )
        return out.reshape(*lead, cfg.out_features)

    def resources(self, n_pixels: int = 1) -> MVUResources:
        cfg = self.config
        return mvu_resources(
            cfg.out_features, cfg.in_features, cfg.resolved_folding(),
            mode=cfg.mode, weight_bits=cfg.weight_bits, n_pixels=n_pixels,
            packed=cfg.packed,
        )


# quantized_linear's blocks: the reference's Pallas blocks, which pick the
# kernel's compiled tile (ops.tile_kwargs): 32 x 64 x 128 of DENSE_TILES
# where a launch is tiled (M > 8); a decode step's M <= 8 takes the gemv
# arrangement, which has no tile
LINEAR_BLOCKS = {"block_n": 128, "block_k": 512}


def quantized_linear(x: torch.Tensor, w_q: QTensor, *, act_bits: int = 8,
                     backend: str = "cuda") -> torch.Tensor:
    """Float-facing MVU linear: y = x @ W_q^T with dynamic act quantization.

    x: (..., K) float; w_q: symmetric-int QTensor (N, K) with per-channel
    scale (1-bit: bipolar values, run on the binary datapath).  Activations
    get one dynamic per-tensor scale (abs-max), the integer MVU kernel runs
    the dot product with the scale epilogue, and the result is dequantized.
    Every op runs in ``x``'s dtype, as the reference's ops do one by one
    (under bf16 the scale and ``x / a_scale`` are bf16; compiled, XLA keeps
    some of them in float32, ROADMAP queue C).

    ``backend="cuda"`` (what ``models/layers.py::linear`` passes) launches
    the hand kernel on a CUDA tensor and takes the kernel's plain version
    on a CPU tensor.  The reference's ``linear`` passes ``backend="xla"``,
    whose port name, ``"torch"``, is the plain version wherever the
    tensor lies.  The kernel's tile comes from :data:`LINEAR_BLOCKS`.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    xm = x.reshape(-1, k)
    lo, hi = int_bounds(act_bits, signed=True)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar,
    # which can differ from the reference's division in the last bit
    a_scale = torch.clamp_min(xm.abs().amax(), 1e-6) / torch.full((), hi, dtype=x.dtype,
                                                                  device=x.device)
    a_int = torch.clamp(torch.round(xm / a_scale), lo, hi).to(torch.int8)
    mode, w = (("binary", packing.bipolar_to_bits(w_q.values).to(torch.int8))
               if w_q.bits == 1 else ("standard", w_q.values))
    out = ops.mvu(a_int, w, mode, out_scale=w_q.scale.reshape(-1).to(torch.float32),
                  backend=backend, **LINEAR_BLOCKS)
    y = out * a_scale
    return y.reshape(*lead, -1).to(x.dtype)
