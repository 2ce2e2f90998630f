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
package's tile kwargs (``block_m``/``block_n``/``block_k``/``block_kw``)
are accepted for a like signature and ignored: the CUDA kernels are
compiled for one tile (``conv_mvu`` and the five kernels on the dense
core pick their arrangement and K splits from the shape).  The autotuner
(``core/autotune.py``) races the packed datapath and the engine's
microbatch; only per-layer kernel tiles wait for ROADMAP queue A item 3,
step 3.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import mvu_binary, mvu_int, mvu_packed, mvu_xnor, packing, ref, swu_mvu

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
    **blocks,
) -> torch.Tensor:
    """Matrix-vector(-batch) compute: epilogue(A . W^T).

    Shapes: standard/binary: a (M, K), w (N, K).  xnor: packed a (M, Wd)
    and w (N, Wd) int32 words with ``k_bits`` true synapses.
    ``packed=True``: ``w`` is the mode's packed storage (int32 bitplanes
    for binary, uint8 2-bit lanes for standard, the usual words for xnor)
    and ``k_bits`` carries the true K for every mode.  ``blocks`` are
    ignored (see the module doc).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if (packed or mode == "xnor") and k_bits is None:
        raise ValueError(f"mode={mode!r}, packed={packed} needs k_bits")
    if packed:
        return mvu_packed.mvu_packed(a, w, mode, k_bits, thresholds, out_scale,
                                     backend=backend)
    if backend == "torch":
        if mode == "xnor":
            return ref.mvu_xnor_ref(a, w, k_bits, thresholds, out_scale)
        if mode == "binary":
            return ref.mvu_binary_ref(a, w, thresholds, out_scale)
        return ref.mvu_int_ref(a, w, thresholds, out_scale)
    if mode == "xnor":
        return mvu_xnor.mvu_xnor(a, w, k_bits, thresholds, out_scale)
    if mode == "binary":
        return mvu_binary.mvu_binary(a, w, thresholds, out_scale)
    return mvu_int.mvu_int(a, w, thresholds, out_scale)


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
    **blocks,
) -> torch.Tensor:
    """Fused SWU+MVU convolution: epilogue(SWU(x) . W^T) -> (B, OH*OW, N).

    x: (B, H, W, C) integer activations ({0,1} bits for xnor); w: (N, Kd^2*C)
    in (ky, kx, c) order -- ``standard`` integer rows, ``binary`` {0,1}-coded
    +/-1 rows, ``xnor`` packed (N, Wd) int32 words with ``k_bits`` = Kd^2*C.
    ``backend="cuda"`` runs the line-buffer kernel (a CPU tensor: its plain
    version), which narrows x to int8 like the JAX package's Pallas kernel;
    ``backend="torch"`` is the materialising oracle, which does not.
    ``blocks`` are ignored (see the module doc).
    """
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
                            pad=pad, mode=mode)
