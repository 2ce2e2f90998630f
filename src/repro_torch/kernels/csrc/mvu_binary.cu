// Binary-weight MVU (paper Fig. 4b) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . (2 * W01[N, K] - 1)^T)
//
// Replaces src/repro/kernels/mvu_binary.py::mvu_binary_pallas (the
// pallas_call at mvu_binary.py:108).  The weights are {0,1}-coded +/-1
// rows stored as int8; the activations are int32 taken as they come (the
// JAX kernel does not narrow them, mvu_binary.py:81), so an int8 tensor
// core product would change the function: this kernel stays on the CUDA
// cores, with uint32 sums that wrap mod 2^32 like XLA's int32 dot.
//
// Two arrangements behind the one entry point, chosen by the Python plan
// (kernels/mvu_binary.py::binary_launch_plan) and checked here:
//
// * gemv, M <= 8 (the CNV's dense layers at one image a microbatch).  A
//   warp owns one output column n for all M rows; its lanes stride K with
//   16-byte loads of A (4 int32) and 4-byte loads of W (4 int8), sum
//   a * (2w - 1) in uint32 and reduce with __shfl_xor_sync; lane i runs
//   the epilogue of row i.  fc2 (10 x 512) is 10 warps of 16 taps a lane
//   instead of one 32 x 32 tile stepping K 16 times.
// * tiled, M > 8 (the NID path's M = 128 and larger).  32 x 32 output
//   tiles, 256 threads of a 2 x 2 register tile each, A and W staged 32
//   synapses a step through two cp.async buffers, so the next step loads
//   while this one multiplies; acc = 2 * (A . W^T) - rowsum(A).  When the
//   output has too few tiles to fill the card, K is split across a
//   thread-block cluster and the slices are summed through distributed
//   shared memory in the same launch (cluster_reduce.cuh): fc0 of the NID
//   path at M = 128 (8 tiles of 19 steps) becomes 64 blocks.
//
// The epilogue operand is staged in shared memory by cp.async while K
// runs, and up to 16 thresholds a column are held in registers for the
// outputs a thread stores (tiled without split K).
//
// What bounds it on the H100 at these shapes: latency.  A launch moves
// < 1 MB and does < 0.1 G MAC; the arrangements cut the serial K loop of
// a block to a few steps on many blocks: 3.3-4.0 us a CNV dense layer at
// M = 1 and 4.7-5.9 us a NID layer at M = 128 (scripts/torch_kernel_ab.py,
// H100 80GB HBM3 at 700 W), near a launch's own latency.

#include "cluster_reduce.cuh"

namespace {

using namespace repro;

enum Arrangement : int { kGemv = 0, kTiled = 1 };

constexpr int GEMV_MAX_M = 8;  // rows a gemv warp keeps
constexpr int GEMV_WARPS = 8;  // columns a gemv block
constexpr int TILE = 32;       // tiled: output tile, and synapses a step
constexpr int TILED_THREADS = 256;
constexpr int TILED_TX = 16;        // tiled: threads along N (2 x 2 outputs each)
constexpr int A_PITCH = TILE + 4;   // int32 words a staged A row (16-byte rows)
constexpr int W_PITCH = TILE + 16;  // bytes a staged W row
constexpr int A_STAGE = TILE * A_PITCH * 4;
constexpr int W_STAGE = TILE * W_PITCH;
constexpr int TILED_SMEM = EPI_STAGE_BYTES + 2 * (A_STAGE + W_STAGE);

template <int EPI>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
mvu_binary_gemv(const int32_t* __restrict__ a, const int8_t* __restrict__ w,
                const int32_t* __restrict__ thr, const float* __restrict__ scale,
                void* __restrict__ out, int m, int n, int k, int n_thr, int vec) {
  const int lane = threadIdx.x & 31;
  const int col = static_cast<int>(blockIdx.x) * GEMV_WARPS + (threadIdx.x >> 5);
  if (col >= n) return;  // the whole warp
  const int8_t* wr = w + static_cast<size_t>(col) * k;
  uint32_t acc[GEMV_MAX_M];
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i) acc[i] = 0u;
  if (vec) {  // K % 4 == 0, A 16-byte and W 4-byte aligned
    for (int kk = lane * 4; kk < k; kk += 128) {
      const uint32_t wq = __ldg(reinterpret_cast<const uint32_t*>(wr + kk));
      uint32_t f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = static_cast<uint32_t>(
            2 * static_cast<int32_t>(static_cast<int8_t>(wq >> (8 * e))) - 1);
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        const int4 av = __ldg(reinterpret_cast<const int4*>(a + static_cast<size_t>(i) * k + kk));
        acc[i] += static_cast<uint32_t>(av.x) * f[0] + static_cast<uint32_t>(av.y) * f[1] +
                  static_cast<uint32_t>(av.z) * f[2] + static_cast<uint32_t>(av.w) * f[3];
      }
    }
  } else {
    for (int kk = lane; kk < k; kk += 32) {
      const uint32_t f = static_cast<uint32_t>(2 * static_cast<int32_t>(wr[kk]) - 1);
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        acc[i] += static_cast<uint32_t>(__ldg(a + static_cast<size_t>(i) * k + kk)) * f;
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

template <int EPI, bool VEC>
__global__ void __launch_bounds__(TILED_THREADS)
mvu_binary_tiled(const int32_t* __restrict__ a, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ thr, const float* __restrict__ scale,
                 void* __restrict__ out, int m, int n, int k, int n_thr, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // the epilogue operand
  unsigned char* stages = smem + EPI_STAGE_BYTES;
  uint32_t* part = reinterpret_cast<uint32_t*>(stages);  // after the K loop
  const int tid = threadIdx.x, tx = tid % TILED_TX, ty = tid / TILED_TX;
  const int m0 = static_cast<int>(blockIdx.x) * TILE, n0 = static_cast<int>(blockIdx.y) * TILE;
  const int steps = (k + TILE - 1) / TILE;
  int s_lo, s_hi;
  k_slice(steps, splits, static_cast<int>(blockIdx.z), s_lo, s_hi);

  auto a_stage = [&](int q) { return reinterpret_cast<int32_t*>(stages + q * A_STAGE); };
  auto w_stage = [&](int q) { return stages + 2 * A_STAGE + q * W_STAGE; };
  auto load = [&](int s, int q) {
    const int k0 = s * TILE;
    int32_t* as = a_stage(q);
    unsigned char* ws = w_stage(q);
    if (VEC) {  // K % 4 == 0: one 16-byte A chunk and one 4-byte W chunk a thread
      const int r = tid >> 3, c = (tid & 7) * 4, gk = k0 + c;
      const bool ok_a = m0 + r < m && gk < k, ok_w = n0 + r < n && gk < k;
      cp_async<16>(as + r * A_PITCH + c, ok_a ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                   ok_a ? 16 : 0);
      cp_async<4>(ws + r * W_PITCH + c, ok_w ? w + static_cast<size_t>(n0 + r) * k + gk : w,
                  ok_w ? 4 : 0);
    } else {
      unsigned char v[TILE * TILE / TILED_THREADS];  // the W loads all in flight at once
#pragma unroll
      for (int j = 0; j < TILE * TILE / TILED_THREADS; ++j) {
        const int i = tid + j * TILED_THREADS, r = i / TILE, c = i % TILE, gk = k0 + c;
        const bool ok_a = m0 + r < m && gk < k, ok_w = n0 + r < n && gk < k;
        cp_async<4>(as + r * A_PITCH + c, ok_a ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                    ok_a ? 4 : 0);
        v[j] = ok_w ? static_cast<unsigned char>(__ldg(w + static_cast<size_t>(n0 + r) * k + gk))
                    : 0;
      }
#pragma unroll
      for (int j = 0; j < TILE * TILE / TILED_THREADS; ++j) {
        const int i = tid + j * TILED_THREADS;
        ws[(i / TILE) * W_PITCH + i % TILE] = v[j];
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
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 4) {
      int4 av[2];
      uint32_t wv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        av[r] = *reinterpret_cast<const int4*>(as + (ty + r * 16) * A_PITCH + kk);
        rowsum[r] += static_cast<uint32_t>(av[r].x) + static_cast<uint32_t>(av[r].y) +
                     static_cast<uint32_t>(av[r].z) + static_cast<uint32_t>(av[r].w);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        wv[c] = *reinterpret_cast<const uint32_t*>(ws + (tx + c * 16) * W_PITCH + kk);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t x[4] = {static_cast<uint32_t>(av[r].x), static_cast<uint32_t>(av[r].y),
                                 static_cast<uint32_t>(av[r].z), static_cast<uint32_t>(av[r].w)};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][c] += x[e] * static_cast<uint32_t>(static_cast<int32_t>(
                                    static_cast<int8_t>(wv[c] >> (8 * e))));
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
        const int32_t v = static_cast<int32_t>(2u * acc[r][c] - rowsum[r]);
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
      part[(ty + r * 16) * TILE + tx + c * 16] = 2u * acc[r][c] - rowsum[r];
  cluster_reduce_store(part, TILE, TILE, [&](int r, int c, uint32_t v) {
    if (m0 + r < m && n0 + c < n)
      store_staged<EPI>(static_cast<int32_t>(v), m0 + r, c, n0, n, stage, thr, n_thr, out);
  });
}

}  // namespace

// w (N, K) int8 in {0,1}: w_cols == k.  The plan (arrangement, tile_m x
// tile_n outputs a block, splits K slices, smem bytes) is
// mvu_binary.py::binary_launch_plan's; a plan this kernel cannot run
// returns cudaErrorInvalidValue.
extern "C" int repro_mvu_binary(const void* a, const void* w, const void* thr,
                                const void* scale, void* out, int m, int n, int k,
                                int w_cols, int n_thr, int epilogue, int arrangement,
                                int tile_m, int tile_n, int splits, int smem, void* stream) {
  if (w_cols != k) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a32 = static_cast<const int32_t*>(a);
  const auto w8 = static_cast<const int8_t*>(w);
  const auto t32 = static_cast<const int32_t*>(thr);
  const auto sc = static_cast<const float*>(scale);
  if (arrangement == kGemv) {
    if (m > GEMV_MAX_M || tile_m != GEMV_MAX_M || tile_n != GEMV_WARPS || splits != 1 ||
        smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const int vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 4 == 0;
    const dim3 grid((n + GEMV_WARPS - 1) / GEMV_WARPS);
    return static_cast<int>(with_epilogue(epilogue, [&](auto e) {
      mvu_binary_gemv<decltype(e)::value><<<grid, GEMV_WARPS * 32, 0, s>>>(
          a32, w8, t32, sc, out, m, n, k, n_thr, vec);
      return cudaGetLastError();
    }));
  }
  const int steps = (k + TILE - 1) / TILE;
  if (arrangement != kTiled || tile_m != TILE || tile_n != TILE || splits < 1 ||
      splits > MAX_SPLITS || splits > steps || smem != TILED_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE, splits);
  return static_cast<int>(with_epilogue(epilogue, [&](auto e) {
    return vec ? launch_cluster(mvu_binary_tiled<decltype(e)::value, true>, grid,
                                TILED_THREADS, smem, splits, s, a32, w8, t32, sc, out, m, n,
                                k, n_thr, splits)
               : launch_cluster(mvu_binary_tiled<decltype(e)::value, false>, grid,
                                TILED_THREADS, smem, splits, s, a32, w8, t32, sc, out, m, n,
                                k, n_thr, splits);
  }));
}
