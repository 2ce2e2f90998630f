"""Build, load and launch the hand kernels: the plumbing every wrapper shares.

Each kernel source in ``csrc/`` (``mvu_int.cu``, ``mvu_xnor.cu``, ...) is
compiled with ``nvcc`` into a shared library of its own, at first use,
into ``_build/`` beside this file, and loaded with ``ctypes``.  A library
is ``<source>.cu`` plus ``binding.cpp`` (the error-string helper); the
sources include ``cluster_reduce.cuh`` (cp.async, the cluster split K and
the epilogue of one output, on ``epilogue.cuh``'s codes) and, for the five
dense MVU kernels, ``dense_mvu.cuh`` (their CUDA-core dense core, on
``cluster_reduce.cuh``).  The library's name carries a hash of those files
and the flags, so an edited source never loads a stale build.
:func:`build_all` starts one ``nvcc`` per source at once.

Every dense MVU entry point has one C signature::

    int repro_<kernel>(const void* a, const void* w, const void* thr,
                       const void* scale, void* out, int m, int n, int k,
                       int w_cols, int n_thr, int epilogue, int arrangement,
                       int tile, int tile_m, int tile_n, int kstep,
                       int splits, int smem, void* stream)

(:meth:`Library.launch`, ``PLAN_ARGTYPES``; the seven ints after the
epilogue are the launch plan of ``kernels/dense_mvu.py``, ``tile`` the
index of its compiled tile), and the conv kernel's takes the image
geometry and its plan (``kernels/swu_mvu.py``, through
:meth:`Library.run`).  Each returns the launch's CUDA error code, and a
tile index outside the kernel's set is an error, never another tile.
Importing this module builds nothing and imports nothing CUDA-only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

# The default tile of the kernels' tiled arrangements: output rows (dense
# rows, conv pixels) and columns a block, and K units a step (synapses;
# 32-bit words for packed xnor operands).  Each kernel is compiled for a
# small set of tiles around it (kernels/dense_mvu.py DENSE_TILES,
# kernels/swu_mvu.py CONV_TILES); a layer's folding or a tuned entry picks
# one (core/folding.py::to_gpu_blocks), and this is the smallest.
BLOCK_M = 32
BLOCK_N = 32
BLOCK_K = 32

# The Hopper-designed kernels' launch plans (kernels/swu_mvu.py,
# kernels/dense_mvu.py; csrc/cluster_reduce.cuh): shared memory a block
# can opt into on the H100, the portable cluster size, and the blocks that
# fill the card (two on each of its 132 SMs).
SMEM_BYTES = 232448
MAX_SPLITS = 8
FILL_BLOCKS = 2 * 132

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_SHARED = ("binding.cpp", "epilogue.cuh", "cluster_reduce.cuh", "dense_mvu.cuh")
EPILOGUE = {"raw": 0, "thresholds": 1, "scale": 2}
# a dense MVU entry point's arguments: five pointers, six ints, the launch
# plan's seven ints and the stream
PLAN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def round_up_to(value: int, choices) -> int:
    """The smallest of ``choices`` (ascending) at least ``value``, else the
    largest: how a folding or a tuned block maps onto a compiled tile."""
    return next((c for c in choices if c >= value), choices[-1])


def split_k(tiles: int, steps: int) -> int:
    """K slices for an output of ``tiles`` tiles of ``steps`` K steps each:
    1 when the tiles fill the card, else enough slices (at most
    ``MAX_SPLITS``, one cluster) to fill it, none empty.  Slice r runs
    steps [r * steps // splits, (r + 1) * steps // splits) (``k_slice`` in
    ``csrc/cluster_reduce.cuh``)."""
    if tiles >= FILL_BLOCKS:
        return 1
    return min(MAX_SPLITS, steps, -(-FILL_BLOCKS // tiles))


def k_slices(steps: int, splits: int, step: int, k: int) -> list[tuple[int, int]]:
    """The synapses [lo, hi) of each of ``splits`` K slices, in rank order,
    of ``steps`` steps of ``step`` synapses over a reduction of length k."""
    return [(min(k, r * steps // splits * step), min(k, (r + 1) * steps // splits * step))
            for r in range(splits)]


def nvcc_flags() -> list[str]:
    # -Xptxas -v: ptxas reports each kernel's registers, shared memory and
    # spills, which the build keeps beside the library (Library.report)
    return ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the MVU kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class Library:
    """One kernel source's shared library: its path, build and C functions
    (``functions`` maps each function's name to its ctypes argtypes)."""

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = source
        self.functions = functions
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        h = hashlib.sha256(" ".join(nvcc_flags()).encode())
        for name in (self.source, *_SHARED):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")

    def _start(self):
        """Start nvcc unless the library exists; returns (process, tmp, path)."""
        path = self.path
        if os.path.exists(path):
            return None, None, path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        srcs = [os.path.join(CSRC, s) for s in (self.source, "binding.cpp")]
        proc = subprocess.Popen([_nvcc(), *nvcc_flags(), "-o", tmp, *srcs],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        return proc, tmp, path

    @staticmethod
    def _finish(proc, tmp, path, err: str | None = None) -> str:
        if proc is not None:
            if err is None:
                _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {os.path.basename(path)}:\n{err}")
            with open(f"{tmp}.ptxas", "w") as f:
                f.write(err)
            os.replace(f"{tmp}.ptxas", _report_path(path))  # before the library appears
            os.replace(tmp, path)  # atomic: a concurrent builder never loads half a file
        return path

    def build(self) -> str:
        """Compile the library (once per content) and return its path."""
        return self._finish(*self._start())

    def report(self) -> str:
        """What ``nvcc -Xptxas -v`` said of the library's kernels when it was
        built (registers, shared memory, spills); builds it if need be."""
        with open(_report_path(self.build())) as f:
            return f.read()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def launch(self, fn: str, a: torch.Tensor, w: torch.Tensor,
               thresholds: torch.Tensor | None, out_scale: torch.Tensor | None,
               epi: str, *, n: int, k: int, plan: tuple[int, ...]) -> torch.Tensor:
        """Launch ``fn`` on ``a``'s device and current stream; returns the
        (M, N) output (int32, float32 for the scale epilogue).  ``k`` is the
        kernel's reduction length argument, ``n`` the output width, ``plan``
        the launch plan's int arguments (``DensePlan.c_args``).  Raises
        for a device that is not CUDA, and when the launch fails."""
        if not a.is_cuda:
            raise ValueError(f"{fn.removeprefix('repro_')} runs on CUDA or CPU "
                             f"tensors, got {a.device}")
        m = a.shape[0]
        if max(m, a.shape[1], w.shape[1], k) >= 2**31 or n > 65535 * BLOCK_N:
            raise ValueError(f"shape (M={m}, N={n}, K={k}) exceeds the kernel's grid")
        out = torch.empty((m, n), dtype=torch.float32 if epi == "scale" else torch.int32,
                          device=a.device)
        if m == 0 or n == 0:
            return out
        n_thr = thresholds.shape[1] if thresholds is not None else 0
        self.run(fn, a.device, a.data_ptr(), w.data_ptr(), device_ptr(thresholds),
                 device_ptr(out_scale), out.data_ptr(), m, n, k, w.shape[1], n_thr,
                 EPILOGUE[epi], *plan)
        return out

    def run(self, fn: str, device: torch.device, *args) -> None:
        """Call the C function ``fn`` with ``args`` and ``device``'s current
        stream (its last argument); raises when the launch fails."""
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: "
                               + lib.repro_cuda_error_string(err).decode())


def _report_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".ptxas.txt"


def device_ptr(t: torch.Tensor | None):
    """A tensor's device address for ctypes (None for an absent operand)."""
    return None if t is None else t.data_ptr()


def ptxas_report(source: str) -> str:
    """What ``nvcc -Xptxas -v`` says of ``source``'s kernels (registers,
    shared memory, spills), compiled to a throwaway cubin."""
    import tempfile

    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        flags = [f for f in nvcc_flags() if f not in ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run([_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
                               os.path.join(tmp, "k.cubin"), os.path.join(CSRC, source)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return proc.stderr


def build_all(libraries) -> list[str]:
    """Build several libraries at once: one nvcc per source, all started
    together.  Returns their paths in order."""
    started = [lib._start() for lib in libraries]
    # wait for every nvcc before reporting the first failure: none is left running
    errs = [proc.communicate()[1] if proc is not None else None
            for proc, _, _ in started]
    return [Library._finish(*s, err) for s, err in zip(started, errs)]
