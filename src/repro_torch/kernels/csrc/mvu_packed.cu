// Packed-weight MVUs for Hopper (sm_90a), CUDA cores: two kernels that
// read the weights in their packed storage and unpack one tile at a time
// in shared memory, never into device memory.
//
//   mvu_binary_packed_kernel   w (N, ceil(K/32)) 32-bit bitplanes of the
//                              {0,1} weight coding;
//                              out = epilogue(2 * (A8 . W01^T) - rowsum(A8))
//   mvu_int2_packed_kernel     w (N, ceil(K/4)) uint8, four signed 2-bit
//                              fields per byte (0b10 -> -2, 0b11 -> -1);
//                              out = epilogue(A8 . W2^T)
//
// Replace src/repro/kernels/mvu_packed.py::mvu_binary_packed_pallas (the
// pallas_call at mvu_packed.py:177) and ::mvu_int2_packed_pallas (at
// mvu_packed.py:305).  A8 is the activations narrowed to int8 by a
// wrapping cast, as the JAX kernels do before they pad
// (mvu_packed.py:152, :280): a value >= 128 wraps to a negative one.  The
// cast is made here, on the load into shared memory, so the wrapper
// passes the int32 activations as they are and launches nothing else.
//
// What bounds them on the H100 at the NID path's shapes (M <= 128 per
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}): latency, as for
// mvu_int (csrc/mvu_int.cu), whose tiling and K loop (mvu_tile.cuh) they
// keep.  Packing cuts the weight bytes 8x (bitplanes against int8 rows)
// or 4x (2-bit lanes), but at these shapes the weights are 2-38 KB, read
// once per block from L2: the time is the serial K loop on a small grid,
// not the bytes.  Each thread unpacks one synapse of the weight tile per
// fill (a shift and a mask, plus a sign extension for 2-bit lanes);
// consecutive threads read the same word or byte, which the load
// broadcasts.
//
// Lanes past K are read as a = 0 and w = 0 and add nothing to either
// term, so pad bits in the last word or byte are never seen.  Sums wrap
// mod 2^32 (taken in uint32, reinterpreted as int32), like XLA's int32
// arithmetic.

#include "mvu_tile.cuh"

namespace {

using namespace repro;

constexpr int kBinary = 0;  // 32 {0,1} lanes per 32-bit word
constexpr int kInt2 = 1;    // 4 signed 2-bit lanes per byte

__device__ __forceinline__ int32_t wrap_int8(int32_t x) {
  const int32_t v = x & 0xFF;
  return v >= 128 ? v - 256 : v;
}

template <int CODING>
__device__ __forceinline__ int32_t unpack_lane(const void* __restrict__ w, int gn, int gk,
                                               int w_cols) {
  const size_t row = static_cast<size_t>(gn) * w_cols;
  if (CODING == kBinary) {
    const uint32_t word = static_cast<const uint32_t*>(w)[row + gk / 32];
    return static_cast<int32_t>((word >> (gk & 31)) & 1u);
  } else {
    const uint32_t byte = static_cast<const uint8_t*>(w)[row + gk / 4];
    const int32_t f = static_cast<int32_t>((byte >> (2 * (gk & 3))) & 3u);
    return f >= 2 ? f - 4 : f;
  }
}

template <int CODING, int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_packed_kernel(const int32_t* __restrict__ a, const void* __restrict__ w,
                  const int32_t* __restrict__ thr, const float* __restrict__ scale,
                  void* __restrict__ out, int m, int n, int k, int w_cols, int n_thr) {
  uint32_t acc[RM][RN], rowsum[RM];
  mvu_tile<CODING == kBinary>(
      m, n, k, [&](int gm, int gk) { return wrap_int8(a[static_cast<size_t>(gm) * k + gk]); },
      [&](int gn, int gk) { return unpack_lane<CODING>(w, gn, gk, w_cols); }, 0u, Mac{}, acc,
      rowsum);
  store_tile<EPI>(
      [&](int i, int j) {
        return static_cast<int32_t>(CODING == kBinary ? 2u * acc[i][j] - rowsum[i]
                                                      : acc[i][j]);
      },
      m, n, thr, n_thr, scale, out);
}

template <int CODING>
int launch(const void* a, const void* w, const void* thr, const void* scale, void* out,
           int m, int n, int k, int w_cols, int n_thr, int epilogue, void* stream) {
  return static_cast<int>(dispatch_epilogue(epilogue, [&](auto e) {
    mvu_packed_kernel<CODING, decltype(e)::value>
        <<<grid_for(m, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(a), w, static_cast<const int32_t*>(thr),
            static_cast<const float*>(scale), out, m, n, k, w_cols, n_thr);
  }));
}

}  // namespace

// w (N, Wd) 32-bit bitplanes, w_cols = Wd >= ceil(K/32).
extern "C" int repro_mvu_binary_packed(const void* a, const void* w, const void* thr,
                                       const void* scale, void* out, int m, int n, int k,
                                       int w_cols, int n_thr, int epilogue, void* stream) {
  return launch<kBinary>(a, w, thr, scale, out, m, n, k, w_cols, n_thr, epilogue, stream);
}

// w (N, Bd) uint8 2-bit lanes, w_cols = Bd >= ceil(K/4).
extern "C" int repro_mvu_int2_packed(const void* a, const void* w, const void* thr,
                                     const void* scale, void* out, int m, int n, int k,
                                     int w_cols, int n_thr, int epilogue, void* stream) {
  return launch<kInt2>(a, w, thr, scale, out, m, n, k, w_cols, n_thr, epilogue, stream);
}
