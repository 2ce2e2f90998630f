"""Standard-SIMD MVU (paper Fig. 4c) on the H100: the hand CUDA kernel.

``mvu_int`` computes ``out[M, N] = epilogue(A[M, K] . W[N, K]^T)`` with an
int32 accumulator.  It replaces ``src/repro/kernels/mvu_int.py::
mvu_int_pallas`` (``pallas_call`` at line 110).  The kernel source,
``csrc/mvu_int.cu``, says what bounds it on the card at the NID path's
shapes (the latency of its serial K loop on a small grid) and what a later
design does about that.

* A CUDA tensor launches the kernel, or the wrapper raises.  There is no
  fallback: only a tensor the caller put on the CPU takes the plain
  version, :func:`mvu_int_plain`.
* The kernel is built with ``nvcc`` from ``csrc/`` at first use, into
  ``_build/`` beside this file, and loaded with ``ctypes``.  Importing this
  module builds nothing and imports nothing CUDA-only.
* ``LAUNCHES`` counts kernel launches (and nothing else), so a run can
  show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from repro_torch.kernels._common import epilogue_value

# The one tile the kernel is compiled for (passed to nvcc as -D flags);
# per-layer tiles come with the autotuner (ROADMAP queue A item 6).
BLOCK_M = 32
BLOCK_N = 32
BLOCK_K = 32
THREADS = 256

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("mvu_int.cu", "binding.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_EPILOGUE = {"raw": 0, "thresholds": 1, "scale": 2}
# the broadcast product of the plain version stays under this many bytes
_PLAIN_CHUNK_BYTES = 1 << 28

_lib = None
_lib_lock = threading.Lock()


# ------------------------------------------------------------------ build
def _nvcc_flags() -> list[str]:
    return ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC",
            f"-DMVU_BM={BLOCK_M}", f"-DMVU_BN={BLOCK_N}",
            f"-DMVU_BK={BLOCK_K}", f"-DMVU_THREADS={THREADS}"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the MVU kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> str:
    """Compile ``csrc/`` into a shared library (once per source content) and
    return its path.  The name carries a hash of the sources and flags, so
    an edited source never loads a stale build."""
    flags = _nvcc_flags()
    h = hashlib.sha256(" ".join(flags).encode())
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libmvu_int_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *srcs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build the MVU kernel:\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder never loads half a file
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.repro_mvu_int.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            lib.repro_mvu_int.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


# ------------------------------------------------------------ the wrapper
_WIDEN = (torch.int8, torch.uint8, torch.int16)


def _check(a, w, thresholds, out_scale):
    """Validate the operands; returns ``a`` as int32 and the epilogue name."""
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"need a (M, K) and w (N, K), got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    if a.dtype.is_floating_point or a.dtype.is_complex:
        raise TypeError(f"a must be an integer tensor, got {a.dtype}")
    if a.dtype != torch.int32 and a.dtype not in _WIDEN:
        raise TypeError(f"a must be int32 (int8/uint8/int16 are widened), got {a.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"w must be int8, got {w.dtype}")
    n = w.shape[0]
    operands = [("a", a), ("w", w)]
    if thresholds is not None:
        if thresholds.dtype != torch.int32 or thresholds.ndim != 2 \
                or thresholds.shape[0] != n or thresholds.shape[1] < 1:
            raise ValueError(f"thresholds must be (N={n}, T>=1) int32, got "
                             f"{tuple(thresholds.shape)} {thresholds.dtype}")
        operands.append(("thresholds", thresholds))
        epi = "thresholds"
    elif out_scale is not None:
        if out_scale.dtype != torch.float32 or tuple(out_scale.shape) != (n,):
            raise ValueError(f"out_scale must be (N={n},) float32, got "
                             f"{tuple(out_scale.shape)} {out_scale.dtype}")
        operands.append(("out_scale", out_scale))
        epi = "scale"
    else:
        epi = "raw"
    for name, t in operands:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device} but a is on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.int32:
        a = a.to(torch.int32)
    return a, epi


def mvu_int(a: torch.Tensor, w: torch.Tensor,
            thresholds: torch.Tensor | None = None,
            out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """out[M,N] = epilogue(A[M,K] . W[N,K]^T); integer datapath.

    a: (M, K) int32 (int8/uint8/int16 are widened; float raises)
    w: (N, K) int8
    thresholds: optional (N, T) int32, ascending -> int32 levels in [0, T]
    out_scale: optional (N,) float32 -> float32 ``float(acc) * s``
    Neither -> the raw int32 accumulator; both -> ValueError.
    """
    global LAUNCHES
    a, epi = _check(a, w, thresholds, out_scale)
    if a.device.type == "cpu":
        return mvu_int_plain(a, w, thresholds, out_scale)
    if not a.is_cuda:
        raise ValueError(f"mvu_int runs on CUDA or CPU tensors, got {a.device}")
    m, k = a.shape
    n = w.shape[0]
    if max(m, k) >= 2**31 or n > 65535 * BLOCK_N:
        raise ValueError(f"shape (M={m}, N={n}, K={k}) exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32 if epi == "scale" else torch.int32,
                      device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _load()
    n_thr = thresholds.shape[1] if thresholds is not None else 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_mvu_int(
            a.data_ptr(), w.data_ptr(),
            thresholds.data_ptr() if thresholds is not None else None,
            out_scale.data_ptr() if out_scale is not None else None,
            out.data_ptr(), m, n, k, n_thr, _EPILOGUE[epi], stream)
    if err != 0:
        raise RuntimeError("mvu_int launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out


def mvu_int_plain(a: torch.Tensor, w: torch.Tensor,
                  thresholds: torch.Tensor | None = None,
                  out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on CPU or CUDA tensors; also
    the port's oracle (``ref.mvu_int_ref``) and its ``backend="torch"``.

    Products are summed in int64 and truncated to int32 (the wraparound of
    the kernel's and XLA's int32 sum).  CUDA has no integer matmul, so the
    sum is a broadcast product, chunked over M to stay under
    ``_PLAIN_CHUNK_BYTES``; the epilogue is :func:`epilogue_value`.
    """
    if thresholds is not None and out_scale is not None:
        raise ValueError("thresholds and out_scale are mutually exclusive")
    m, k = a.shape
    n = w.shape[0]
    w64 = w.to(torch.int64)
    rows = max(1, _PLAIN_CHUNK_BYTES // max(1, 8 * n * k))
    acc = torch.cat([
        (a[i:i + rows].to(torch.int64)[:, None, :] * w64[None]).sum(-1)
        for i in range(0, m, rows)
    ]) if m else torch.zeros((0, n), dtype=torch.int64, device=a.device)
    return epilogue_value(acc.to(torch.int32), thresholds, out_scale)
