// Standard-SIMD MVU (paper Fig. 4c) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . W[N, K]^T),   int32 accumulator
//
// Replaces src/repro/kernels/mvu_int.py::mvu_int_pallas (the pallas_call
// at mvu_int.py:110).  The TPU kernel walks K as a sequential grid axis
// and carries the sum in VMEM scratch; blocks here run in parallel and in
// no order, so K is a loop inside the block instead.
//
// What bounds it on the H100 at the NID path's shapes (M <= 128 per
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}): latency.  A launch
// moves 0.03-0.4 MB and does at most 10 MOP, so its byte bound is at most
// ~0.1 us and its int8 tensor-core bound ~0.005 us.  Measured (chip_smoke.py
// on an H100 80GB HBM3 at 700 W), fc0 (K = 600) takes ~40 us per launch at
// M = 128, ~350x its byte bound and far above launch latency, nearly the
// same at M = 1: its time is the serial K loop -- 19 steps of a global
// load, a barrier and 32 multiply-add rounds, with no overlap -- on a grid
// of only 8 blocks (4 x 2 at M = 128) on a card of 132 SMs.  The K = 64
// layers take 4-7 us, near launch latency.
//
// This first kernel is simple and right: a 2-D grid of BM x BN output
// tiles, the A and W tiles staged through shared memory BK synapses at a
// time, a small register tile of outputs per thread, int32 multiply-adds
// on the CUDA cores and the epilogue fused at the end.  Ragged M, N and K
// edges are masked, never padded.  The answer to fc0's latency bound is
// later work: split-K (more blocks, each a slice of K, summed at the end)
// or a smaller tile with double-buffered loads that overlap the next
// K step with this one's multiply-adds.  Int8 tensor cores (mma.sync /
// wgmma .s8) need the int32 activations narrowed to int8 with a range
// proof.
//
// The sum wraps mod 2^32 like XLA's int32 dot: it is taken in uint32,
// where wraparound is defined, and reinterpreted as int32 at the end.
//
// Tile sizes come from the Python wrapper as -D flags (kernels/mvu_int.py
// is their one definition).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#if !defined(MVU_BM) || !defined(MVU_BN) || !defined(MVU_BK) || !defined(MVU_THREADS)
#error "build through repro_torch.kernels.mvu_int, which passes the tile sizes"
#endif

namespace {

constexpr int BM = MVU_BM;
constexpr int BN = MVU_BN;
constexpr int BK = MVU_BK;
constexpr int THREADS = MVU_THREADS;
constexpr int TX = 16;            // threads along N
constexpr int TY = THREADS / TX;  // threads along M
constexpr int RM = BM / TY;       // outputs per thread along M
constexpr int RN = BN / TX;       // outputs per thread along N
static_assert(THREADS % TX == 0 && BM % TY == 0 && BN % TX == 0,
              "the block's threads must tile the BM x BN output tile");

enum Epilogue : int { kRaw = 0, kThresholds = 1, kScale = 2 };

template <int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_int_kernel(const int32_t* __restrict__ a, const int8_t* __restrict__ w,
               const int32_t* __restrict__ thr, const float* __restrict__ scale,
               void* __restrict__ out, int m, int n, int k, int n_thr) {
  // K-major tiles, each row padded by one word: the fill (consecutive
  // threads on consecutive k) and the reads (consecutive threads on
  // consecutive n) both avoid bank conflicts.
  __shared__ int32_t as[BK][BM + 1];
  __shared__ int32_t ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  uint32_t acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < m && gk < k) ? a[static_cast<size_t>(gm) * k + gk] : 0;
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gn = n0 + r, gk = k0 + c;
      ws[c][r] = (gn < n && gk < k)
                     ? static_cast<int32_t>(w[static_cast<size_t>(gn) * k + gk])
                     : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t av[RM], wv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = static_cast<uint32_t>(as[kk][ty + i * TY]);
#pragma unroll
      for (int j = 0; j < RN; ++j) wv[j] = static_cast<uint32_t>(ws[kk][tx + j * TX]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= n) continue;
      const int32_t v = static_cast<int32_t>(acc[i][j]);
      const size_t o = static_cast<size_t>(gm) * n + gn;
      if (EPI == kThresholds) {
        // the multi-threshold unit: act = sum_t (acc >= T[n, t])
        const int32_t* t = thr + static_cast<size_t>(gn) * n_thr;
        int32_t level = 0;
        for (int q = 0; q < n_thr; ++q) level += (v >= t[q]) ? 1 : 0;
        static_cast<int32_t*>(out)[o] = level;
      } else if (EPI == kScale) {
        // one rounding to float32, one rounded multiply: no contraction
        static_cast<float*>(out)[o] = __fmul_rn(__int2float_rn(v), scale[gn]);
      } else {
        static_cast<int32_t*>(out)[o] = v;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the launch's error code (cudaSuccess = 0).
cudaError_t mvu_int_launch(const int32_t* a, const int8_t* w, const int32_t* thr,
                           const float* scale, void* out, int m, int n, int k,
                           int n_thr, int epilogue, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  switch (epilogue) {
    case kRaw:
      mvu_int_kernel<kRaw><<<grid, THREADS, 0, stream>>>(a, w, thr, scale, out, m, n, k, n_thr);
      break;
    case kThresholds:
      mvu_int_kernel<kThresholds><<<grid, THREADS, 0, stream>>>(a, w, thr, scale, out, m, n, k, n_thr);
      break;
    case kScale:
      mvu_int_kernel<kScale><<<grid, THREADS, 0, stream>>>(a, w, thr, scale, out, m, n, k, n_thr);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
