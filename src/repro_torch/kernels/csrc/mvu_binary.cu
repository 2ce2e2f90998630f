// Binary-weight MVU (paper Fig. 4b) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . (2 * W01[N, K] - 1)^T)
//             = epilogue(2 * (A . W01^T) - rowsum(A))
//
// Replaces src/repro/kernels/mvu_binary.py::mvu_binary_pallas (the
// pallas_call at mvu_binary.py:108).  The weights are {0,1}-coded +/-1
// rows stored as int8; the activations are integers taken as they come
// (the JAX kernel does not narrow them either, mvu_binary.py:81).  The
// FPGA datapath selects +x or -x per synapse; the JAX kernel turns that
// into one 0/1 matmul plus a per-row correction, and so does this one:
// the int32 multiply-adds of A against the 0/1 rows and rowsum(A) are
// accumulated in the same K loop (mvu_tile.cuh), and 2 * dot - rowsum is
// taken before the epilogue (epilogue.cuh).
//
// What bounds it on the H100 at the NID path's shapes (M <= 128 per
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}): latency, as for
// mvu_int (csrc/mvu_int.cu), whose design it keeps -- BM x BN output
// tiles, A and W staged through shared memory BK synapses at a time, an
// RM x RN register tile per thread, ragged edges masked.
//
// Sums wrap mod 2^32 like XLA's int32 arithmetic: they are taken in
// uint32, where wraparound is defined, and reinterpreted as int32.

#include "mvu_tile.cuh"

namespace {

using namespace repro;

template <int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_binary_kernel(const int32_t* __restrict__ a, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ thr, const float* __restrict__ scale,
                  void* __restrict__ out, int m, int n, int k, int n_thr) {
  uint32_t acc[RM][RN], rowsum[RM];
  mvu_tile<true>(
      m, n, k, [&](int gm, int gk) { return a[static_cast<size_t>(gm) * k + gk]; },
      [&](int gn, int gk) { return static_cast<int32_t>(w[static_cast<size_t>(gn) * k + gk]); },
      0u, Mac{}, acc, rowsum);
  store_tile<EPI>(
      [&](int i, int j) { return static_cast<int32_t>(2u * acc[i][j] - rowsum[i]); }, m, n,
      thr, n_thr, scale, out);
}

}  // namespace

// w (N, K) int8 in {0,1}: w_cols == k.
extern "C" int repro_mvu_binary(const void* a, const void* w, const void* thr,
                                const void* scale, void* out, int m, int n, int k,
                                int w_cols, int n_thr, int epilogue, void* stream) {
  if (w_cols != k) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_epilogue(epilogue, [&](auto e) {
    mvu_binary_kernel<decltype(e)::value>
        <<<grid_for(m, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(a), static_cast<const int8_t*>(w),
            static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m,
            n, k, n_thr);
  }));
}
