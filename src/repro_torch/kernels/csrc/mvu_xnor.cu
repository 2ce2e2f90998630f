// XNOR-popcount MVU (paper Fig. 4a) for Hopper (sm_90a), CUDA cores.
//
//   acc[m, n] = sum_w popcount(~(a[m, w] ^ w[n, w]))       (a, w: 32-bit words)
//   out[m, n] = epilogue(2 * acc - pad_correction(K, Wd * 32))
//
// Replaces src/repro/kernels/mvu_xnor.py::mvu_xnor_pallas (the pallas_call
// at mvu_xnor.py:121); the packed-xnor path of the JAX package
// (mvu_packed.py:388-393) runs the same kernel.  Both operands hold 32
// bipolar synapses per word, LSB-first, with zero pad bits past K
// (repro_torch.kernels.packing.pack_bits).
//
// The pad correction.  The JAX kernel pads both operands with zero words
// up to whole blocks and subtracts the correction for its block-padded
// width.  Here words past Wd are never loaded: a missing word is read as
// a = 0 against w = ~0 (mvu_tile.cuh's pad value), whose XNOR is 0, so
// only the Wd real words count and the correction is the one for Wd * 32
// bits.  Both land on the same bipolar dot over the true K synapses.
//
// What bounds it on the H100 at the NID path's shapes (M <= 128 per
// microbatch, Wd in {19, 2}, N in {64, 1}): latency.  One launch reads at
// most ~20 KB and does ~0.16 M word operations; a whole (M, Wd) x (N, Wd)
// tile fits one K step (BK = 32 words = 1024 synapses), so each block
// loads once, waits at one barrier and runs 32 XOR/NOT/POPC/ADD rounds.
// The grid is as small as mvu_int's (4 x 2 blocks at M = 128); the kernel
// is simple and right first, and the design is the standard kernel's K
// loop (mvu_tile.cuh) with the multiply-add replaced by __popc(~(a ^ w)).
//
// The sum is an exact integer: it is at most Wd * 32 < 2^30 (the wrapper
// holds Wd < 2^25), so 2 * sum - correction fits int32.

#include "mvu_tile.cuh"

namespace {

using namespace repro;

// one word pair's share of the popcount: agreeing bits count
struct XnorPopc {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t w) const {
    return static_cast<uint32_t>(__popc(~(a ^ w)));
  }
};

template <int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_xnor_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ w,
                const int32_t* __restrict__ thr, const float* __restrict__ scale,
                void* __restrict__ out, int m, int n, int k_bits, int wd, int n_thr) {
  uint32_t acc[RM][RN];
  mvu_tile(
      m, n, wd, [&](int gm, int gw) { return a[static_cast<size_t>(gm) * wd + gw]; },
      [&](int gn, int gw) { return w[static_cast<size_t>(gn) * wd + gw]; }, ~0u, XnorPopc{},
      acc);
  // bipolar dot over the true K bits (packing.pad_correction)
  const int32_t correction = 2 * wd * 32 - k_bits;
  store_tile<EPI>(
      [&](int i, int j) { return 2 * static_cast<int32_t>(acc[i][j]) - correction; }, m, n,
      thr, n_thr, scale, out);
}

}  // namespace

// a (M, Wd) and w (N, Wd) 32-bit words: k is the true synapse count K,
// w_cols is Wd (0 <= K <= Wd * 32, checked by the wrapper).
extern "C" int repro_mvu_xnor(const void* a, const void* w, const void* thr,
                              const void* scale, void* out, int m, int n, int k,
                              int w_cols, int n_thr, int epilogue, void* stream) {
  return static_cast<int>(dispatch_epilogue(epilogue, [&](auto e) {
    mvu_xnor_kernel<decltype(e)::value>
        <<<grid_for(m, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w),
            static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m,
            n, k, w_cols, n_thr);
  }));
}
