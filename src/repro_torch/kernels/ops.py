"""Entry points for the MVU kernels.

``mvu(...)`` dispatches on the SIMD-lane datapath (paper Fig. 4):

    mode="xnor"     1-bit x 1-bit, bit-packed XNOR+popcount   (Fig. 4a)
    mode="binary"   {+-1} weights x n-bit inputs               (Fig. 4b)
    mode="standard" arbitrary-precision integer lanes          (Fig. 4c)

and, with ``packed=True``, onto the packed-weight kernels
(``kernels/mvu_packed.py``); ``conv_mvu(...)`` is the fused SWU+MVU
convolution (``kernels/swu_mvu.py``) in the same three datapaths.  Two
backends, the port's names for the JAX
package's ``("pallas", "xla")``:

    backend="cuda"   the hand-written CUDA kernels (the paper's RTL analog);
                     a CPU tensor takes the kernel's plain version, any
                     other device launches the kernel or raises
    backend="torch"  the plain oracles in ``ref`` / ``mvu_packed`` (the HLS
                     analog; for conv, the materialised sliding windows)

Packed words are int32 bit patterns (``kernels/packing.py``).  The JAX
package's tile kwargs act as they do there: ``block_n`` (output columns a
block), ``block_k`` (K units a step; ``block_kw`` on the word datapaths,
xnor and packed binary) and ``rows_per_tile`` (output rows a block: dense
rows, or a conv's rows of pixels) pick the compiled tile each hand kernel
launches (:func:`tile_kwargs`; ``dense_mvu.dense_tile``,
``swu_mvu.conv_tile``), rounded up onto the kernel's small fixed set.
``block_m`` is the node's burst (the engine's microbatch), not a kernel
tile, and is taken and left alone here.  The plain oracles ignore the
tile: integer sums do not depend on the order, so every tile gives the
same result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import mvu_binary, mvu_int, mvu_packed, mvu_xnor, packing, ref, swu_mvu
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N
from repro_torch.kernels.dense_mvu import CODING

MODES = ("xnor", "binary", "standard")
BACKENDS = ("cuda", "torch")
# the JAX package's backend names -> the port's (a carried graph or a cache
# entry may carry either)
BACKEND_NAMES = {"pallas": "cuda", "xla": "torch", "cuda": "cuda", "torch": "torch"}

# every hand kernel: name -> (its wrapper's module, that module's launch counter)
KERNELS = {
    "mvu_int": (mvu_int, "LAUNCHES"),
    "mvu_xnor": (mvu_xnor, "LAUNCHES"),
    "mvu_binary": (mvu_binary, "LAUNCHES"),
    "mvu_binary_packed": (mvu_packed, "BINARY_LAUNCHES"),
    "mvu_int2_packed": (mvu_packed, "INT2_LAUNCHES"),
    "conv_mvu": (swu_mvu, "LAUNCHES"),
}
# the kernel libraries, one per source in csrc/ (kernels/_cuda.py)
LIBRARIES = (mvu_int.LIB, mvu_xnor.LIB, mvu_binary.LIB, mvu_packed.LIB, swu_mvu.LIB)


def kernel_name(mode: str, packed: bool = False) -> str:
    """The hand kernel ``mvu(..., mode, packed=packed)`` launches."""
    if mode == "xnor":
        return "mvu_xnor"  # natively packed: the packed path runs it too
    if packed:
        return "mvu_binary_packed" if mode == "binary" else "mvu_int2_packed"
    return "mvu_binary" if mode == "binary" else "mvu_int"


def tile_kwargs(kernel: str, *, block_m: int | None = None, block_n: int = BLOCK_N,
                block_k: int = BLOCK_K, block_kw: int = BLOCK_K,
                rows_per_tile: int | None = None) -> dict:
    """The tile kwargs the wrapper of dense kernel ``kernel`` takes, from a
    schedule's (``MVUConfig.kernel_blocks``): its K step is ``block_kw`` on
    the word codings (bitplanes, packed and bit xnor), else ``block_k``;
    ``block_m``, the burst, is not a kernel tile."""
    del block_m
    words = CODING[kernel] in ("bitplanes", "words", "bits")
    return {"block_n": block_n, "rows_per_tile": rows_per_tile,
            **({"block_kw": block_kw} if words else {"block_k": block_k})}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the launch counters: a
    replayed CUDA graph's launches, which no wrapper sees
    (``core/engine.py``)."""
    for name, n in counts.items():
        mod, attr = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def mvu_layer_fn(mode: str = "standard", *, backend: str = "cuda", **blocks):
    """Stage callable for the streaming executors: ``fn(params, x) -> y``.

    ``params`` is a dict with ``"w"`` (N, K) plus optionally ``"t"``
    (thresholds) or ``"s"`` (out_scale).
    """

    def fn(params, x):
        return mvu(x, params["w"], mode, thresholds=params.get("t"),
                   out_scale=params.get("s"), backend=backend, **blocks)

    return fn


def mvu(
    a: torch.Tensor,
    w: torch.Tensor,
    mode: str = "standard",
    *,
    k_bits: int | None = None,
    thresholds: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
    backend: str = "cuda",
    packed: bool = False,
    block_m: int = 128,
    block_n: int = BLOCK_N,
    block_k: int = BLOCK_K,
    block_kw: int = BLOCK_K,
    rows_per_tile: int | None = None,
) -> torch.Tensor:
    """Matrix-vector(-batch) compute: epilogue(A . W^T).

    Shapes: standard/binary: a (M, K), w (N, K).  xnor: packed a (M, Wd)
    and w (N, Wd) int32 words with ``k_bits`` true synapses.
    ``packed=True``: ``w`` is the mode's packed storage (int32 bitplanes
    for binary, uint8 2-bit lanes for standard, the usual words for xnor)
    and ``k_bits`` carries the true K for every mode.  The tile kwargs
    pick the kernel's compiled tile (see the module doc; ``block_m`` is
    the burst and does not).
    """
    del block_m  # the node's burst: the engine's microbatch, not a kernel tile
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if (packed or mode == "xnor") and k_bits is None:
        raise ValueError(f"mode={mode!r}, packed={packed} needs k_bits")
    tile = tile_kwargs(kernel_name(mode, packed), block_n=block_n, block_k=block_k,
                       block_kw=block_kw, rows_per_tile=rows_per_tile)
    if packed:
        return mvu_packed.mvu_packed(a, w, mode, k_bits, thresholds, out_scale,
                                     backend=backend, **tile)
    if backend == "torch":
        if mode == "xnor":
            return ref.mvu_xnor_ref(a, w, k_bits, thresholds, out_scale)
        if mode == "binary":
            return ref.mvu_binary_ref(a, w, thresholds, out_scale)
        return ref.mvu_int_ref(a, w, thresholds, out_scale)
    if mode == "xnor":
        return mvu_xnor.mvu_xnor(a, w, k_bits, thresholds, out_scale, **tile)
    if mode == "binary":
        return mvu_binary.mvu_binary(a, w, thresholds, out_scale, **tile)
    return mvu_int.mvu_int(a, w, thresholds, out_scale, **tile)


def conv_mvu(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    kernel: int,
    stride: int = 1,
    pad: int = 0,
    mode: str = "standard",
    k_bits: int | None = None,
    thresholds: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
    backend: str = "cuda",
    block_m: int = 128,
    block_n: int = BLOCK_N,
    block_k: int = BLOCK_K,
    block_kw: int = BLOCK_K,
    rows_per_tile: int | None = None,
) -> torch.Tensor:
    """Fused SWU+MVU convolution: epilogue(SWU(x) . W^T) -> (B, OH*OW, N).

    x: (B, H, W, C) integer activations ({0,1} bits for xnor); w: (N, Kd^2*C)
    in (ky, kx, c) order -- ``standard`` integer rows, ``binary`` {0,1}-coded
    +/-1 rows, ``xnor`` packed (N, Wd) int32 words with ``k_bits`` = Kd^2*C.
    ``backend="cuda"`` runs the line-buffer kernel (a CPU tensor: its plain
    version), which narrows x to int8 like the JAX package's Pallas kernel;
    ``backend="torch"`` is the materialising oracle, which does not.
    ``block_n`` and ``rows_per_tile`` pick the kernel's compiled tile; the
    K blocks do not act (the kernel steps K by one mma k, 32 taps, as the
    JAX kernel keeps the full K resident), nor does the burst ``block_m``.
    """
    del block_m, block_k, block_kw
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if mode == "xnor" and k_bits != kernel * kernel * x.shape[-1]:
        raise ValueError(f"xnor conv needs k_bits = Kd^2*C = "
                         f"{kernel * kernel * x.shape[-1]}, got {k_bits}")
    if backend == "torch":
        if mode == "xnor":
            w = packing.unpack_bits(w, k_bits)
        return ref.conv_mvu_ref(x, w, kernel=kernel, stride=stride, pad=pad, mode=mode,
                                thresholds=thresholds, out_scale=out_scale)
    return swu_mvu.conv_mvu(x, w, thresholds, out_scale, kernel=kernel, stride=stride,
                            pad=pad, mode=mode, block_n=block_n, rows_per_tile=rows_per_tile)
