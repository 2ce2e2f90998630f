// What the Hopper-designed kernels (conv_mvu.cu, and the dense core
// dense_mvu.cuh of mvu_int.cu, mvu_binary.cu, mvu_packed.cu and
// mvu_xnor.cu) share:
// asynchronous copies into shared memory, the K slices of split K, the
// sum of those slices through a thread-block cluster's distributed shared
// memory, and the epilogue of one output at a time (epilogue.cuh's
// arithmetic, its operand staged in shared memory).
//
// Split K in one launch.  The grid's z dimension holds the K slices of
// one output tile, and they form one cluster (1 x 1 x splits blocks, at
// most 8, the portable size).  Each block accumulates its slice of K into
// a (tile_m x tile_n) uint32 tile in its own shared memory; after
// cluster.sync() every block of the cluster sums, for a share of the
// tile's outputs, the tiles of all its ranks (map_shared_rank) and runs
// the epilogue on them; a second cluster.sync() keeps each block's shared
// memory alive until the others have read it.  No scratch in device
// memory, no memset, no second kernel.  Sums are uint32, where wraparound
// is defined, so any order of the slices gives the same int32 result mod
// 2^32.  A launch without split K is a plain launch: its blocks store
// their tiles themselves and never call cluster_reduce_store.
//
// The plan (tile, splits, dynamic shared memory) comes from the Python
// wrapper; launch_cluster checks nothing of it beyond what the runtime
// refuses.

#pragma once

#include <cooperative_groups.h>

#include "epilogue.cuh"

namespace repro {

constexpr int MAX_SPLITS = 8;            // the portable cluster size
constexpr int MAX_SMEM_BYTES = 232448;   // the H100's opt-in shared memory a block

// cp.async of `bytes` (4, 8 or 16) from global to shared memory, zero-filling
// the destination past `src_bytes` (0 copies nothing and writes zeros).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  } else if (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The K steps [lo, hi) of slice `slice` when `steps` are cut into
// `splits` slices as even as whole steps allow (kernels/_cuda.py k_slices).
__device__ __forceinline__ void k_slice(int steps, int splits, int slice, int& lo, int& hi) {
  lo = slice * steps / splits;
  hi = (slice + 1) * steps / splits;
}

// Write one output through the epilogue: v is the int32 accumulator of
// the output at offset o, t its column's n_thr thresholds, s its scale
// (epilogue.cuh's three forms).
template <int EPI>
__device__ __forceinline__ void store_value(int32_t v, size_t o, const int32_t* t, int n_thr,
                                            float s, void* __restrict__ out) {
  if (EPI == kThresholds) {
    // the multi-threshold unit: act = sum_t (acc >= T[n, t])
    int32_t level = 0;
    for (int q = 0; q < n_thr; ++q) level += (v >= t[q]) ? 1 : 0;
    static_cast<int32_t*>(out)[o] = level;
  } else if (EPI == kScale) {
    // one rounding to float32, one rounded multiply: no contraction
    static_cast<float*>(out)[o] = __fmul_rn(__int2float_rn(v), s);
  } else {
    static_cast<int32_t*>(out)[o] = v;
  }
}

// The same for output (gm, gn) of the (m, n) result (row-major, n
// columns), its epilogue operand read from device memory.
template <int EPI>
__device__ __forceinline__ void store_one(int32_t v, int gm, int gn, int n,
                                          const int32_t* __restrict__ thr, int n_thr,
                                          const float* __restrict__ scale,
                                          void* __restrict__ out) {
  store_value<EPI>(v, static_cast<size_t>(gm) * n + gn,
                   EPI == kThresholds ? thr + static_cast<size_t>(gn) * n_thr : nullptr, n_thr,
                   EPI == kScale ? scale[gn] : 0.0f, out);
}

// The epilogue operand of a block's tile_n columns, staged in shared
// memory by cp.async while the K loop runs, so that the epilogue does not
// wait on device memory: the threshold rows when a column has at most
// EPI_STAGE_THR of them (else they are read where they lie), or the
// scales; epi_stage_bytes(tile_n) bytes.  The caller commits the copies
// with its first cp.async group.
constexpr int EPI_STAGE_THR = 16;
__host__ __device__ constexpr int epi_stage_bytes(int tile_n) {
  return tile_n * EPI_STAGE_THR * 4 + 64;  // + the overread of a row
}

template <int EPI>
__device__ __forceinline__ void stage_epilogue(unsigned char* stage, int n0, int tile_n, int n,
                                               const int32_t* thr, int n_thr,
                                               const float* scale) {
  if (EPI == kThresholds && n_thr <= EPI_STAGE_THR) {
    int32_t* dst = reinterpret_cast<int32_t*>(stage);
    const int32_t* src = thr + static_cast<size_t>(n0) * n_thr;
    for (int i = threadIdx.x; i < tile_n * n_thr; i += blockDim.x) {
      const bool ok = n0 + i / n_thr < n;
      cp_async<4>(dst + i, ok ? src + i : thr, ok ? 4 : 0);
    }
  } else if (EPI == kScale) {
    float* dst = reinterpret_cast<float*>(stage);
    for (int c = threadIdx.x; c < tile_n; c += blockDim.x) {
      const bool ok = n0 + c < n;
      cp_async<4>(dst + c, ok ? scale + n0 + c : scale, ok ? 4 : 0);
    }
  }
}

// Write output (gm, n0 + c) of the (m, n) result through the epilogue,
// with the operand that stage_epilogue staged (its copies complete).
template <int EPI>
__device__ __forceinline__ void store_staged(int32_t v, int gm, int c, int n0, int n,
                                             const unsigned char* stage,
                                             const int32_t* thr, int n_thr, void* out) {
  const int gn = n0 + c;
  const size_t o = static_cast<size_t>(gm) * n + gn;
  if (EPI == kThresholds && n_thr <= EPI_STAGE_THR) {
    // the staged row, four thresholds a round, loaded together (a round
    // may read past the row: still shared memory, and not counted)
    const int32_t* row = reinterpret_cast<const int32_t*>(stage) + c * n_thr;
    int32_t level = 0;
    for (int q0 = 0; q0 < n_thr; q0 += 4) {
      int32_t t[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) t[u] = row[q0 + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) level += (q0 + u < n_thr && v >= t[u]) ? 1 : 0;
    }
    static_cast<int32_t*>(out)[o] = level;
    return;
  }
  const int32_t* row = EPI == kThresholds ? thr + static_cast<size_t>(gn) * n_thr : nullptr;
  const float s = EPI == kScale ? reinterpret_cast<const float*>(stage)[c] : 0.0f;
  store_value<EPI>(v, o, row, n_thr, s, out);
}

// Up to T thresholds of one column, read from the staged rows into
// registers once for all the outputs of that column a thread stores (a
// read past the row stays in the stage's slack and is not counted).
template <int T>
struct Thresholds {
  int32_t t[T];
};

template <int T>
__device__ __forceinline__ Thresholds<T> staged_thresholds(const unsigned char* stage, int c,
                                                           int n_thr) {
  const int32_t* row = reinterpret_cast<const int32_t*>(stage) + c * n_thr;
  Thresholds<T> th;
#pragma unroll
  for (int u = 0; u < T; ++u) th.t[u] = row[u];
  return th;
}

// The multi-threshold unit on registers: sum_t (v >= T[t]), n_thr <= T.
template <int T>
__device__ __forceinline__ int32_t level_of(int32_t v, const Thresholds<T>& th, int n_thr) {
  int32_t level = 0;
#pragma unroll
  for (int u = 0; u < T; ++u) level += (u < n_thr && v >= th.t[u]) ? 1 : 0;
  return level;
}

// Sum the cluster's partial tiles (`part`, row-major tile_m x tile_n
// uint32 in each block's shared memory, complete in this block) and hand
// each summed output to store(r, c, v) (tile row r, tile column c).  The
// blocks of the cluster share the tile's outputs.  Every thread of every
// block of the cluster must call it.
template <typename Store>
__device__ __forceinline__ void cluster_reduce_store(uint32_t* part, int tile_m, int tile_n,
                                                     Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial tile is written
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cells = tile_m * tile_n;
  for (int idx = rank * blockDim.x + threadIdx.x; idx < cells; idx += ranks * blockDim.x) {
    uint32_t v = 0u;
    for (int q = 0; q < ranks; ++q) v += cluster.map_shared_rank(part, q)[idx];
    store(idx / tile_n, idx % tile_n, v);
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

// Launch `kernel` on a grid whose z dimension is `splits` clusters of K
// slices, with `smem` bytes of dynamic shared memory; returns the error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                           int splits, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one slice: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Run `launch(std::integral_constant<int, EPI>{})`, which returns the
// launch's error, for the runtime epilogue code.
template <typename Launch>
cudaError_t with_epilogue(int epilogue, Launch&& launch) {
  switch (epilogue) {
    case kRaw:
      return launch(std::integral_constant<int, kRaw>{});
    case kThresholds:
      return launch(std::integral_constant<int, kThresholds>{});
    case kScale:
      return launch(std::integral_constant<int, kScale>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
