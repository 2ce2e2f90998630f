"""Entry points for the MVU kernels.

``mvu(...)`` dispatches on the SIMD-lane datapath (paper Fig. 4).  This
slice of the port carries ``mode="standard"`` (Fig. 4c, arbitrary-precision
integer lanes); ``"binary"`` and ``"xnor"`` come with their kernels
(ROADMAP queue B rows 2-3).  Two backends, the port's names for the JAX
package's ``("pallas", "xla")``:

    backend="cuda"   the hand-written CUDA kernel (the paper's RTL analog);
                     a CPU tensor takes its plain version, any other
                     device launches the kernel or raises
    backend="torch"  the plain oracle ``ref.mvu_int_ref`` (the HLS analog)

The JAX package's tile kwargs (``block_m``/``block_n``/``block_k``) are
accepted for a like signature and ignored: the CUDA kernel is compiled for
one tile, and per-layer tiles come with the autotuner (ROADMAP queue A
item 6).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.mvu_int import mvu_int

MODES = ("xnor", "binary", "standard")
BACKENDS = ("cuda", "torch")


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
    thresholds: torch.Tensor | None = None,
    out_scale: torch.Tensor | None = None,
    backend: str = "cuda",
    packed: bool = False,
    **blocks,
) -> torch.Tensor:
    """Matrix-vector(-batch) compute: epilogue(A . W^T), a (M, K), w (N, K).

    ``blocks`` are ignored (see the module doc).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if mode != "standard":
        raise NotImplementedError(
            f"mode={mode!r} needs its kernel: ROADMAP queue B row "
            f"{2 if mode == 'xnor' else 3}")
    if packed:
        raise NotImplementedError(
            "packed=True needs the packed-weight kernels: ROADMAP queue B rows 5-6")
    if backend == "torch":
        return ref.mvu_int_ref(a, w, thresholds, out_scale)
    return mvu_int(a, w, thresholds, out_scale)
