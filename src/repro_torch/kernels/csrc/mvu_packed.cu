// Packed-weight MVUs for Hopper (sm_90a), CUDA cores: two kernels that
// read the weights in their packed storage, never unpacked into device
// memory.
//
//   repro_mvu_binary_packed   w (N, ceil(K/32)) 32-bit bitplanes of the
//                             {0,1} weight coding;
//                             out = epilogue(2 * (A8 . W01^T) - rowsum(A8))
//   repro_mvu_int2_packed     w (N, ceil(K/4)) uint8, four signed 2-bit
//                             fields per byte (0b10 -> -2, 0b11 -> -1);
//                             out = epilogue(A8 . W2^T)
//
// Replace src/repro/kernels/mvu_packed.py::mvu_binary_packed_pallas (def
// at mvu_packed.py:124, the pallas_call at :177) and ::mvu_int2_packed_pallas
// (def at :250, the pallas_call at :305).  A8 is the activations narrowed
// to int8 by a wrapping cast, as the JAX kernels do before they pad
// (mvu_packed.py:152, :280): a value >= 128 wraps to a negative one.  The
// cast is made here, where an activation is read, so the wrapper passes
// the int32 activations as they are and launches nothing else.  Sums wrap
// mod 2^32 (taken in uint32, reinterpreted as int32), like XLA's int32
// arithmetic.
//
// What bounds them on the H100 at the NID path's shapes (M = 128 a
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}): latency.  The
// weights are 2-38 KB and the activations at most 0.3 MB a launch, so
// what counts is how long one block's serial K loop runs and how few
// blocks share the work.
//
// * mvu_binary_packed runs dense_mvu.cuh's core with the BinaryBitplanes
//   coding: A narrowed on its read, one bitplane word a column staged by
//   cp.async a 32-synapse step (128 bytes a step against 1,536 for int8
//   rows), the binary finish 2 * acc - rowsum.  Its two arrangements are
//   a warp a column at M <= 8 (a lane takes four bits of a word with
//   shifts) and double-buffered 32 x 32 tiles with K split across a
//   cluster above.  A lane past K reads A as 0, so pad bits of the last
//   word never count, whatever they hold, and any w_cols >= ceil(K/32)
//   is taken.  A NID layer at M = 128 takes 5.0-6.4 us
//   (scripts/torch_kernel_ab.py, H100 80GB HBM3 at 700 W).
// * mvu_int2_packed still runs the shared K loop of mvu_tile.cuh: each
//   thread unpacks one 2-bit lane of the weight tile per fill (a shift, a
//   mask and a sign extension); lanes past K read as a = 0 and w = 0.

#include "dense_mvu.cuh"
#include "mvu_tile.cuh"

namespace {

using namespace repro;

__device__ __forceinline__ int32_t wrap_int8(int32_t x) {
  const int32_t v = x & 0xFF;
  return v >= 128 ? v - 256 : v;
}

// signed 2-bit lane gk of row gn: four a byte, w_cols bytes a row
__device__ __forceinline__ int32_t int2_lane(const uint8_t* __restrict__ w, int gn, int gk,
                                            int w_cols) {
  const uint32_t byte = w[static_cast<size_t>(gn) * w_cols + gk / 4];
  const int32_t f = static_cast<int32_t>((byte >> (2 * (gk & 3))) & 3u);
  return f >= 2 ? f - 4 : f;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
mvu_int2_packed_kernel(const int32_t* __restrict__ a, const uint8_t* __restrict__ w,
                       const int32_t* __restrict__ thr, const float* __restrict__ scale,
                       void* __restrict__ out, int m, int n, int k, int w_cols, int n_thr) {
  uint32_t acc[RM][RN];
  mvu_tile(
      m, n, k, [&](int gm, int gk) { return wrap_int8(a[static_cast<size_t>(gm) * k + gk]); },
      [&](int gn, int gk) { return int2_lane(w, gn, gk, w_cols); }, 0u, Mac{}, acc);
  store_tile<EPI>([&](int i, int j) { return static_cast<int32_t>(acc[i][j]); }, m, n, thr,
                  n_thr, scale, out);
}

}  // namespace

// w (N, Wd) 32-bit bitplanes, w_cols = Wd >= ceil(K/32); the plan is
// kernels/dense_mvu.py::dense_launch_plan's (coding "bitplanes"), and one
// this kernel cannot run returns cudaErrorInvalidValue.
extern "C" int repro_mvu_binary_packed(const void* a, const void* w, const void* thr,
                                       const void* scale, void* out, int m, int n, int k,
                                       int w_cols, int n_thr, int epilogue, int arrangement,
                                       int tile_m, int tile_n, int splits, int smem,
                                       void* stream) {
  return repro::dense::launch<repro::dense::BinaryBitplanes>(
      a, w, thr, scale, out, m, n, k, w_cols, n_thr, epilogue, arrangement, tile_m, tile_n,
      splits, smem, stream);
}

// w (N, Bd) uint8 2-bit lanes, w_cols = Bd >= ceil(K/4).
extern "C" int repro_mvu_int2_packed(const void* a, const void* w, const void* thr,
                                     const void* scale, void* out, int m, int n, int k,
                                     int w_cols, int n_thr, int epilogue, void* stream) {
  return static_cast<int>(dispatch_epilogue(epilogue, [&](auto e) {
    mvu_int2_packed_kernel<decltype(e)::value>
        <<<grid_for(m, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(a), static_cast<const uint8_t*>(w),
            static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m, n, k,
            w_cols, n_thr);
  }));
}
