// The CUDA-core dense MVU of three kernels (mvu_int.cu, mvu_binary.cu and
// mvu_packed.cu's mvu_binary_packed), for Hopper (sm_90a):
//
//   out[M, N] = epilogue(finish(sum_k a(A[m, k]) * w(W[n, k])))
//
// An operand policy (Coding below) says three things:
// * how an A element is read: int32 as it is, or narrowed to int8 by the
//   wrapping cast of the JAX packed kernels (mvu_packed.py:152);
// * how W is stored and staged: int8 rows (N, K), or 32-bit bitplanes
//   (N, w_cols >= ceil(K/32)) of the {0,1} coding, one word a column a
//   32-synapse step;
// * how the sum is finished: acc (the integer datapath), or
//   2 * acc - rowsum(A) for {0,1}-coded +/-1 weights (the gemv
//   arrangement multiplies by 2w - 1 instead).
// The activations are int32 and the products of full width, so the kernels
// stay on the CUDA cores; sums are uint32 and wrap mod 2^32 like XLA's
// int32 dot.
//
// Two arrangements, chosen by the Python plan (kernels/dense_mvu.py::
// dense_launch_plan) and checked by dense::launch:
//
// * gemv, M <= 8 (the CNV's dense layers at one image a microbatch).  A
//   warp owns one output column n for all M rows; its lanes stride K four
//   synapses at a time with 16-byte loads of A and one 4-byte load of W
//   (four int8, or the word whose four bits they are), sum in uint32 and
//   reduce with __shfl_xor_sync; lane i runs the epilogue of row i.
// * tiled, M > 8 (the NID path's M = 128 and larger).  32 x 32 output
//   tiles, 256 threads of a 2 x 2 register tile each, A and W staged 32
//   synapses a step through two cp.async buffers, so the next step loads
//   while this one multiplies.  When the output has too few tiles to fill
//   the card, K is split across a thread-block cluster and the slices are
//   summed through distributed shared memory in the same launch
//   (cluster_reduce.cuh): fc0 of the NID path at M = 128 (8 tiles of 19
//   steps) becomes 64 blocks.
//
// A lane past K reads A as 0 (masked loads, zero-filled copies), so it
// adds nothing to either term whatever its W lane holds: pad bits of a
// bitplane word never count.  The epilogue operand is staged in shared
// memory by cp.async while K runs, and up to 16 thresholds a column are
// held in registers for the outputs a thread stores (tiled without split
// K).

#pragma once

#include "cluster_reduce.cuh"

namespace repro {
namespace dense {

enum Arrangement : int { kGemv = 0, kTiled = 1 };

constexpr int GEMV_MAX_M = 8;  // rows a gemv warp keeps
constexpr int GEMV_WARPS = 8;  // columns a gemv block
constexpr int TILE = 32;       // tiled: output tile, and synapses a step
constexpr int THREADS = 256;
constexpr int TX = 16;              // tiled: threads along N (2 x 2 outputs each)
constexpr int A_PITCH = TILE + 4;   // int32 words a staged A row (16-byte rows)
constexpr int W_PITCH = TILE + 16;  // bytes a staged int8 W row
constexpr int A_STAGE = TILE * A_PITCH * 4;

template <bool NARROW_A, bool BITPLANES, bool BINARY>
struct Coding {
  static constexpr bool bitplanes = BITPLANES;
  using W = typename std::conditional<BITPLANES, uint32_t, int8_t>::type;
  // a step's W: 32 int8 rows of W_PITCH bytes, or one word a column
  static constexpr int W_STAGE = BITPLANES ? TILE * 4 : TILE * W_PITCH;
  static constexpr int TILED_SMEM = EPI_STAGE_BYTES + 2 * (A_STAGE + W_STAGE);

  // an activation as the datapath multiplies it
  __device__ static __forceinline__ uint32_t a(int32_t x) {
    return NARROW_A ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(x)))
                    : static_cast<uint32_t>(x);
  }
  // W lane e of a staged 4-byte chunk: int8 e (sign-extended), or bit e
  __device__ static __forceinline__ uint32_t w(uint32_t chunk, int e) {
    return BITPLANES ? (chunk >> e) & 1u
                     : static_cast<uint32_t>(static_cast<int32_t>(
                           static_cast<int8_t>(chunk >> (8 * e))));
  }
  // the gemv factor of a weight value (binary: the +/-1 it codes)
  __device__ static __forceinline__ uint32_t factor(int32_t v) {
    return static_cast<uint32_t>(BINARY ? 2 * v - 1 : v);
  }
  // the tiled arrangement's sum of a (slice of) dot and its A row sum
  __device__ static __forceinline__ uint32_t finish(uint32_t acc, uint32_t rowsum) {
    return BINARY ? 2u * acc - rowsum : acc;
  }
};

using IntRows = Coding<false, false, false>;        // mvu_int
using BinaryRows = Coding<false, false, true>;      // mvu_binary
using BinaryBitplanes = Coding<true, true, true>;   // mvu_binary_packed

// w_cols: bitplane words a W row (int8 rows: unused, the row is k bytes)
template <typename C, int EPI>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv(const int32_t* __restrict__ a, const typename C::W* __restrict__ w,
     const int32_t* __restrict__ thr, const float* __restrict__ scale,
     void* __restrict__ out, int m, int n, int k, int n_thr, int vec, int w_cols) {
  const int lane = threadIdx.x & 31;
  const int col = static_cast<int>(blockIdx.x) * GEMV_WARPS + (threadIdx.x >> 5);
  if (col >= n) return;  // the whole warp
  const typename C::W* wr = w + static_cast<size_t>(col) * (C::bitplanes ? w_cols : k);
  uint32_t acc[GEMV_MAX_M];
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i) acc[i] = 0u;
  if (vec) {  // K % 4 == 0, A 16-byte and W 4-byte aligned
    for (int kk = lane * 4; kk < k; kk += 128) {
      // four synapses: four int8, or four bits of one word
      const uint32_t wq = C::bitplanes
                              ? __ldg(reinterpret_cast<const uint32_t*>(wr) + kk / 32) >> (kk & 31)
                              : __ldg(reinterpret_cast<const uint32_t*>(wr + kk));
      uint32_t f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = C::factor(static_cast<int32_t>(C::w(wq, e)));
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        const int4 av = __ldg(reinterpret_cast<const int4*>(a + static_cast<size_t>(i) * k + kk));
        acc[i] += C::a(av.x) * f[0] + C::a(av.y) * f[1] + C::a(av.z) * f[2] + C::a(av.w) * f[3];
      }
    }
  } else {
    for (int kk = lane; kk < k; kk += 32) {
      const uint32_t f = C::factor(
          C::bitplanes
              ? static_cast<int32_t>(C::w(reinterpret_cast<const uint32_t*>(wr)[kk / 32], kk & 31))
              : static_cast<int32_t>(wr[kk]));
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        acc[i] += C::a(__ldg(a + static_cast<size_t>(i) * k + kk)) * f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i)
    if (i < m && lane == i)
      store_one<EPI>(static_cast<int32_t>(acc[i]), i, col, n, thr, n_thr, scale, out);
}

template <typename C, int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS)
tiled(const int32_t* __restrict__ a, const typename C::W* __restrict__ w,
      const int32_t* __restrict__ thr, const float* __restrict__ scale,
      void* __restrict__ out, int m, int n, int k, int n_thr, int splits, int w_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // the epilogue operand
  unsigned char* stages = smem + EPI_STAGE_BYTES;
  uint32_t* part = reinterpret_cast<uint32_t*>(stages);  // after the K loop
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = static_cast<int>(blockIdx.x) * TILE, n0 = static_cast<int>(blockIdx.y) * TILE;
  const int steps = (k + TILE - 1) / TILE;
  int s_lo, s_hi;
  k_slice(steps, splits, static_cast<int>(blockIdx.z), s_lo, s_hi);

  auto a_stage = [&](int q) { return reinterpret_cast<int32_t*>(stages + q * A_STAGE); };
  auto w_stage = [&](int q) { return stages + 2 * A_STAGE + q * C::W_STAGE; };
  auto load = [&](int s, int q) {
    const int k0 = s * TILE;
    int32_t* as = a_stage(q);
    unsigned char* ws = w_stage(q);
    // ok_w and v[] stay outside the `if constexpr (!C::bitplanes)` blocks, unused by
    // BinaryBitplanes, so that mvu_binary's register allocation is the parent's
    if (VEC) {  // K % 4 == 0: one 16-byte A chunk (and one 4-byte W chunk) a thread
      const int r = tid >> 3, c = (tid & 7) * 4, gk = k0 + c;
      const bool ok_a = m0 + r < m && gk < k, ok_w = n0 + r < n && gk < k;
      cp_async<16>(as + r * A_PITCH + c, ok_a ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                   ok_a ? 16 : 0);
      if constexpr (!C::bitplanes) {
        cp_async<4>(ws + r * W_PITCH + c, ok_w ? w + static_cast<size_t>(n0 + r) * k + gk : w,
                    ok_w ? 4 : 0);
      }
    } else {
      unsigned char v[TILE * TILE / THREADS];  // the W loads all in flight at once
#pragma unroll
      for (int j = 0; j < TILE * TILE / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / TILE, c = i % TILE, gk = k0 + c;
        const bool ok_a = m0 + r < m && gk < k, ok_w = n0 + r < n && gk < k;
        cp_async<4>(as + r * A_PITCH + c, ok_a ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                    ok_a ? 4 : 0);
        if constexpr (!C::bitplanes) {
          v[j] = ok_w ? static_cast<unsigned char>(
                            __ldg(reinterpret_cast<const int8_t*>(w) +
                                  static_cast<size_t>(n0 + r) * k + gk))
                      : 0;
        }
      }
      if constexpr (!C::bitplanes) {
#pragma unroll
        for (int j = 0; j < TILE * TILE / THREADS; ++j) {
          const int i = tid + j * THREADS;
          ws[(i / TILE) * W_PITCH + i % TILE] = v[j];
        }
      }
    }
    if constexpr (C::bitplanes) {
      if (tid < TILE) {  // step s is word s of each row (s < steps <= w_cols)
        const bool ok_w = n0 + tid < n;
        cp_async<4>(ws + tid * 4, ok_w ? w + static_cast<size_t>(n0 + tid) * w_cols + s : w,
                    ok_w ? 4 : 0);
      }
    }
  };

  uint32_t acc[2][2] = {{0u, 0u}, {0u, 0u}}, rowsum[2] = {0u, 0u};
  stage_epilogue<EPI>(stage, n0, TILE, n, thr, n_thr, scale);
  if (s_lo < s_hi) load(s_lo, 0);
  cp_async_commit();
  for (int s = s_lo; s < s_hi; ++s) {
    const int i = s - s_lo;
    if (s + 1 < s_hi) load(s + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int32_t* as = a_stage(i & 1);
    const unsigned char* ws = w_stage(i & 1);
    uint32_t words[2];  // bitplanes: this step's word of each of the thread's columns
    if constexpr (C::bitplanes) {
#pragma unroll
      for (int c = 0; c < 2; ++c) words[c] = reinterpret_cast<const uint32_t*>(ws)[tx + c * 16];
    }
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 4) {
      int4 av[2];
      uint32_t wv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        av[r] = *reinterpret_cast<const int4*>(as + (ty + r * 16) * A_PITCH + kk);
        rowsum[r] += C::a(av[r].x) + C::a(av[r].y) + C::a(av[r].z) + C::a(av[r].w);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if constexpr (C::bitplanes)
          wv[c] = words[c] >> kk;
        else
          wv[c] = *reinterpret_cast<const uint32_t*>(ws + (tx + c * 16) * W_PITCH + kk);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t x[4] = {C::a(av[r].x), C::a(av[r].y), C::a(av[r].z), C::a(av[r].w)};
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][c] += x[e] * C::w(wv[c], e);
        }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (splits == 1) {  // no cluster: straight to the epilogue
    __syncthreads();  // the staged epilogue operand is in place
    // up to 16 thresholds (the NID's 4-bit activations): this thread's two
    // columns' rows into registers first
    const bool in_regs = EPI == kThresholds && n_thr <= EPI_STAGE_THR;
    Thresholds<EPI_STAGE_THR> th[2];
    if (in_regs) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        th[c] = staged_thresholds<EPI_STAGE_THR>(stage, tx + c * 16, n_thr);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gm = m0 + ty + r * 16, gn = n0 + tx + c * 16;
        if (gm >= m || gn >= n) continue;
        const int32_t v = static_cast<int32_t>(C::finish(acc[r][c], rowsum[r]));
        if (in_regs)
          static_cast<int32_t*>(out)[static_cast<size_t>(gm) * n + gn] = level_of(v, th[c], n_thr);
        else
          store_staged<EPI>(v, gm, tx + c * 16, n0, n, stage, thr, n_thr, out);
      }
    return;
  }
  __syncthreads();  // the stages are free: the partial tile reuses them
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      part[(ty + r * 16) * TILE + tx + c * 16] = C::finish(acc[r][c], rowsum[r]);
  cluster_reduce_store(part, TILE, TILE, [&](int r, int c, uint32_t v) {
    if (m0 + r < m && n0 + c < n)
      store_staged<EPI>(static_cast<int32_t>(v), m0 + r, c, n0, n, stage, thr, n_thr, out);
  });
}

// Launch coding C's kernel on the plan (arrangement, tile_m x tile_n
// outputs a block, splits K slices, smem bytes) of kernels/dense_mvu.py::
// dense_launch_plan; a plan it cannot run, or W of the wrong width (int8
// rows: w_cols == k; bitplanes: w_cols >= ceil(k/32)), returns
// cudaErrorInvalidValue.
template <typename C>
int launch(const void* a, const void* w, const void* thr, const void* scale, void* out,
           int m, int n, int k, int w_cols, int n_thr, int epilogue, int arrangement,
           int tile_m, int tile_n, int splits, int smem, void* stream) {
  const int steps = (k + TILE - 1) / TILE;
  if (C::bitplanes ? w_cols < steps : w_cols != k) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a32 = static_cast<const int32_t*>(a);
  const auto wc = static_cast<const typename C::W*>(w);
  const auto t32 = static_cast<const int32_t*>(thr);
  const auto sc = static_cast<const float*>(scale);
  // 16-byte A rows and, for int8 rows, 4-byte W chunks (a word is aligned)
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   (C::bitplanes || reinterpret_cast<uintptr_t>(w) % 4 == 0);
  if (arrangement == kGemv) {
    if (m > GEMV_MAX_M || tile_m != GEMV_MAX_M || tile_n != GEMV_WARPS || splits != 1 ||
        smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + GEMV_WARPS - 1) / GEMV_WARPS);
    return static_cast<int>(with_epilogue(epilogue, [&](auto e) {
      gemv<C, decltype(e)::value><<<grid, GEMV_WARPS * 32, 0, s>>>(
          a32, wc, t32, sc, out, m, n, k, n_thr, vec ? 1 : 0, w_cols);
      return cudaGetLastError();
    }));
  }
  if (arrangement != kTiled || tile_m != TILE || tile_n != TILE || splits < 1 ||
      splits > MAX_SPLITS || splits > (steps > 0 ? steps : 1) || smem != C::TILED_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE, splits);
  return static_cast<int>(with_epilogue(epilogue, [&](auto e) {
    return vec ? launch_cluster(tiled<C, decltype(e)::value, true>, grid, THREADS, smem, splits,
                                s, a32, wc, t32, sc, out, m, n, k, n_thr, splits, w_cols)
               : launch_cluster(tiled<C, decltype(e)::value, false>, grid, THREADS, smem,
                                splits, s, a32, wc, t32, sc, out, m, n, k, n_thr, splits,
                                w_cols);
  }));
}

}  // namespace dense
}  // namespace repro
