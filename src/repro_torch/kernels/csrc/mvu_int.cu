// Standard-SIMD MVU (paper Fig. 4c) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . W[N, K]^T),   int32 accumulator
//
// Replaces src/repro/kernels/mvu_int.py::mvu_int_pallas (the pallas_call
// at mvu_int.py:110).  The TPU kernel walks K as a sequential grid axis
// and carries the sum in VMEM scratch; blocks here run in parallel and in
// no order, so K is a loop inside the block instead (mvu_tile.cuh).
//
// What bounds it on the H100 at the NID path's shapes (M <= 128 per
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}): latency.  A launch
// moves 0.03-0.4 MB and does at most 10 MOP, so its byte bound is at most
// ~0.1 us and its int8 tensor-core bound ~0.005 us.  Measured (chip_smoke.py
// on an H100 80GB HBM3 at 700 W), fc0 (K = 600) takes 28-40 us per launch
// at M = 128, ~250-350x its byte bound and far above launch latency, nearly
// the same at M = 1: its time is the serial K loop -- 19 steps of a global
// load, a barrier and 32 multiply-add rounds, with no overlap -- on a grid
// of only 8 blocks (4 x 2 at M = 128) on a card of 132 SMs.  The K = 64
// layers take 4-7 us, near launch latency.
//
// This first kernel is simple and right: a 2-D grid of BM x BN output
// tiles, the A and W tiles staged through shared memory BK synapses at a
// time, a small register tile of outputs per thread, int32 multiply-adds
// on the CUDA cores and the epilogue (epilogue.cuh) fused at the end.
// Ragged M, N and K edges are masked, never padded.  The answer to fc0's
// latency bound is later work: split-K (more blocks, each a slice of K,
// summed at the end) or a smaller tile with double-buffered loads that
// overlap the next K step with this one's multiply-adds.  Int8 tensor
// cores (mma.sync / wgmma .s8) need the int32 activations narrowed to int8
// with a range proof.
//
// The sum wraps mod 2^32 like XLA's int32 dot: it is taken in uint32,
// where wraparound is defined, and reinterpreted as int32 at the end.

#include "mvu_tile.cuh"

namespace {

using namespace repro;

template <int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_int_kernel(const int32_t* __restrict__ a, const int8_t* __restrict__ w,
               const int32_t* __restrict__ thr, const float* __restrict__ scale,
               void* __restrict__ out, int m, int n, int k, int n_thr) {
  uint32_t acc[RM][RN], rowsum[RM];
  mvu_tile<false>(
      m, n, k, [&](int gm, int gk) { return a[static_cast<size_t>(gm) * k + gk]; },
      [&](int gn, int gk) { return static_cast<int32_t>(w[static_cast<size_t>(gn) * k + gk]); },
      0u, Mac{}, acc, rowsum);
  store_tile<EPI>([&](int i, int j) { return static_cast<int32_t>(acc[i][j]); }, m, n,
                  thr, n_thr, scale, out);
}

}  // namespace

// w (N, K) int8: w_cols == k.
extern "C" int repro_mvu_int(const void* a, const void* w, const void* thr,
                             const void* scale, void* out, int m, int n, int k,
                             int w_cols, int n_thr, int epilogue, void* stream) {
  if (w_cols != k) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_epilogue(epilogue, [&](auto e) {
    mvu_int_kernel<decltype(e)::value>
        <<<grid_for(m, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(a), static_cast<const int8_t*>(w),
            static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m,
            n, k, n_thr);
  }));
}
