"""Packed-weight MVUs on the H100: two hand CUDA kernels and their dispatch.

The weights stay in their packed storage -- 32-bit bitplanes of the {0,1}
coding (``packing.pack_bits``, int32 bit patterns) or four signed 2-bit
lanes per uint8 byte (``packing.pack_int2``) -- and are never unpacked
into device memory (``csrc/mvu_packed.cu``).  Both run the dense core of
``csrc/dense_mvu.cuh``, in the arrangement that
:func:`~repro_torch.kernels.dense_mvu.dense_launch_plan` picks for their
W coding (``"bitplanes"``, ``"int2"``), and read a W lane where they
multiply it:

    mvu_binary_packed   2 * (A8 . W01^T) - rowsum(A8)   replaces
                        mvu_packed.py::mvu_binary_packed_pallas (:124, pallas_call :177)
    mvu_int2_packed     A8 . sign_extend(W2)^T           replaces
                        mvu_packed.py::mvu_int2_packed_pallas (:250, pallas_call :305)

A8 is the activations narrowed to int8 by a wrapping cast, as the JAX
kernels do (mvu_packed.py:152, :280): on the packed datapath an
activation >= 128 wraps.  The JAX package's unpacked references
(``*_xla``) do not narrow; their ports here (``*_ref``) are
``backend="torch"``, as ``xla`` is the JAX package's.  Packed xnor runs the
Fig. 4a kernel (``mvu_xnor``), which is natively packed.

Like every wrapper: a CUDA tensor launches the kernel or raises, a CPU
tensor takes the kernel's plain version (``*_plain``), and each kernel has
its own launch counter (``BINARY_LAUNCHES``, ``INT2_LAUNCHES``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import packing, ref
from repro_torch.kernels._common import (
    check_operands,
    epilogue_value,
    int_dot,
    narrow_int8,
)
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N, PLAN_ARGTYPES, Library
from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan
from repro_torch.kernels.mvu_xnor import mvu_xnor, mvu_xnor_plain

LIB = Library("mvu_packed.cu", {"repro_mvu_binary_packed": PLAN_ARGTYPES,
                                "repro_mvu_int2_packed": PLAN_ARGTYPES})

# Kernel launches since import (or since a caller reset them to 0).
BINARY_LAUNCHES = 0
INT2_LAUNCHES = 0


def _check_k(name: str, a: torch.Tensor, k_bits: int) -> None:
    if k_bits != a.shape[1]:
        raise ValueError(f"{name}: k_bits={k_bits} but a has K={a.shape[1]}")


# ------------------------------------------------------- binary bitplanes
def mvu_binary_packed(a: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
                      thresholds: torch.Tensor | None = None,
                      out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
                      block_kw: int = BLOCK_K,
                      rows_per_tile: int | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A8[M,K] . (2*W01[N,K]-1)^T) from bitplane weights.

    a: (M, K) integer activations (narrowed to int8 by a wrapping cast);
    w_packed: (N, Wd >= ceil(K/32)) int32 bitplanes of the {0,1} coding.
    block_n / block_kw / rows_per_tile pick the kernel's compiled tile
    (``dense_mvu.dense_tile``; bitplanes step K by 32 whatever block_kw).
    """
    global BINARY_LAUNCHES
    a, epi = check_operands("mvu_binary_packed", a, w_packed, thresholds, out_scale,
                            w_dtype=torch.int32, lanes_per_col=packing.WORD_BITS)
    _check_k("mvu_binary_packed", a, k_bits)
    if a.device.type == "cpu":
        return mvu_binary_packed_plain(a, w_packed, k_bits, thresholds, out_scale)
    (m, k), n = a.shape, w_packed.shape[0]
    out = LIB.launch("repro_mvu_binary_packed", a, w_packed, thresholds, out_scale, epi,
                     n=n, k=k, plan=dense_launch_plan(
                         m, n, k, CODING["mvu_binary_packed"], block_n=block_n, block_k=block_kw,
                         rows_per_tile=rows_per_tile).c_args)
    if out.numel():  # an empty output launches nothing
        BINARY_LAUNCHES += 1
    return out


def mvu_binary_packed_plain(a, w_packed, k_bits, thresholds=None, out_scale=None):
    """The kernel's function in plain PyTorch: narrow, unpack, then
    ``2 * (a8 . w01) - rowsum(a8)`` and the epilogue."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    a8 = narrow_int8(a)
    bipolar = 2 * packing.unpack_bits(w_packed, k_bits).to(torch.int64) - 1
    return epilogue_value(int_dot(a8, bipolar), thresholds, out_scale)


def mvu_binary_packed_ref(a, w_packed, k_bits, thresholds=None, out_scale=None):
    """Port of ``mvu_packed.mvu_binary_packed_xla``: unpack the bitplanes
    once, then the Fig. 4b oracle on ``a`` as it is (no narrowing)."""
    return ref.mvu_binary_ref(a, packing.unpack_bits(w_packed, k_bits),
                              thresholds, out_scale)


# ------------------------------------------------------------ 2-bit lanes
def mvu_int2_packed(a: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
                    thresholds: torch.Tensor | None = None,
                    out_scale: torch.Tensor | None = None, *, block_n: int = BLOCK_N,
                    block_k: int = BLOCK_K,
                    rows_per_tile: int | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A8[M,K] . W2[N,K]^T) from 2-bit lane weights.

    a: (M, K) integer activations (narrowed to int8 by a wrapping cast);
    w_packed: (N, Bd >= ceil(K/4)) uint8, four signed 2-bit lanes a byte.
    block_n / block_k / rows_per_tile pick the kernel's compiled tile.
    """
    global INT2_LAUNCHES
    a, epi = check_operands("mvu_int2_packed", a, w_packed, thresholds, out_scale,
                            w_dtype=torch.uint8, lanes_per_col=packing.INT2_PER_BYTE)
    _check_k("mvu_int2_packed", a, k_bits)
    if a.device.type == "cpu":
        return mvu_int2_packed_plain(a, w_packed, k_bits, thresholds, out_scale)
    (m, k), n = a.shape, w_packed.shape[0]
    out = LIB.launch("repro_mvu_int2_packed", a, w_packed, thresholds, out_scale, epi,
                     n=n, k=k, plan=dense_launch_plan(
                         m, n, k, CODING["mvu_int2_packed"], block_n=block_n, block_k=block_k,
                         rows_per_tile=rows_per_tile).c_args)
    if out.numel():  # an empty output launches nothing
        INT2_LAUNCHES += 1
    return out


def mvu_int2_packed_plain(a, w_packed, k_bits, thresholds=None, out_scale=None):
    """The kernel's function in plain PyTorch: narrow, sign-extend the
    lanes, then the integer dot and the epilogue."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    w2 = packing.unpack_int2(w_packed, k_bits)
    return epilogue_value(int_dot(narrow_int8(a), w2), thresholds, out_scale)


def mvu_int2_packed_ref(a, w_packed, k_bits, thresholds=None, out_scale=None):
    """Port of ``mvu_packed.mvu_int2_packed_xla``: sign-extend the lanes,
    then the int oracle on ``a`` as it is (no narrowing)."""
    return ref.mvu_int_ref(a, packing.unpack_int2(w_packed, k_bits),
                           thresholds, out_scale)


# ------------------------------------------------------ storage and dispatch
def pack_mvu_weights(w: torch.Tensor, mode: str) -> torch.Tensor:
    """Canonical (N, K) weights -> the mode's packed storage form.

    xnor weights arrive already packed (a no-op); binary {0,1} rows become
    int32 bitplanes; standard rows (signed 2-bit, in [-2, 1]) become uint8
    2-bit lanes.
    """
    if mode == "xnor":
        return w
    if mode == "binary":
        return packing.pack_bits(w)
    lo, hi = int(w.min()), int(w.max())
    if lo < -2 or hi > 1:
        raise ValueError(
            f"standard-mode packing needs signed 2-bit weights in [-2, 1]; "
            f"got range [{lo}, {hi}]")
    return packing.pack_int2(w)


def unpack_mvu_weights(w_packed: torch.Tensor, mode: str, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_mvu_weights`: the canonical (N, k) int8 rows
    (xnor words stay words)."""
    if mode == "xnor":
        return w_packed
    unpack = packing.unpack_bits if mode == "binary" else packing.unpack_int2
    return unpack(w_packed, k).to(torch.int8)


def packed_weight_bytes(n: int, k: int, mode: str, weight_bits: int) -> int:
    """Device-resident bytes of the packed (N, K) weight matrix for ``mode``."""
    if mode in ("xnor", "binary"):
        return n * packing.num_words(k) * 4
    del weight_bits  # standard packing is the 2-bit lane format
    return n * packing.num_int2_bytes(k)


def mvu_packed(a: torch.Tensor, w_packed: torch.Tensor, mode: str, k_bits: int,
               thresholds: torch.Tensor | None = None,
               out_scale: torch.Tensor | None = None, *,
               backend: str = "cuda", **tile) -> torch.Tensor:
    """Dispatch over the packed kernel family (mirror of ``ops.mvu``):
    ``backend="cuda"`` the hand kernels, with the tile kwargs ``tile`` of
    that kernel's wrapper; ``"torch"`` the plain references, which take no
    tile."""
    if backend == "torch":
        fn = {"xnor": mvu_xnor_plain, "binary": mvu_binary_packed_ref}.get(
            mode, mvu_int2_packed_ref)
        return fn(a, w_packed, k_bits, thresholds, out_scale)
    # xnor: the Fig. 4a kernel is natively packed -- the same datapath
    fn = {"xnor": mvu_xnor, "binary": mvu_binary_packed}.get(mode, mvu_int2_packed)
    return fn(a, w_packed, k_bits, thresholds, out_scale, **tile)
