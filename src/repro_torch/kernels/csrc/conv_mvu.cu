// Fused SWU + MVU convolution (paper Fig. 1) for Hopper (sm_90a), CUDA cores.
//
//   out[B*OH*OW, N] = epilogue(SWU(x)[B*OH*OW, K] . W[N, K]^T),  K = Kd^2 * C
//
// Replaces src/repro/kernels/swu_mvu.py::conv_mvu_pallas (the pallas_call
// at swu_mvu.py:207).  x is the (B, H, W, C) NHWC image as int32 levels;
// W is (N, K) in (ky, kx, c) order (core/swu.py::pack_conv_weights).
//
// Implicit GEMM: row m of the activation matrix is output pixel
// (b, oy, ox) and column k is tap (ky, kx, c).  The A loader of the shared
// K loop (mvu_tile.cuh) reads x[b, oy*s + ky - pad, ox*s + kx - pad, c]
// straight from the image into shared memory, one BM x BK slice at a time;
// a tap outside the image reads as 0.  So the (B*OH*OW, K) im2col matrix
// never exists in device memory -- the point of the TPU kernel, whose line
// buffer gathers the windows of a tile of output rows in VMEM.  The TPU
// kernel pads H to whole row tiles (its need_h rule, swu_mvu.py:174-180)
// and slices the extra rows off; here the ragged pixel and channel edges
// are masked and nothing is padded.  K is stepped BK taps at a time, as
// in every MVU kernel: conv5's K = 2304 would not fit shared memory whole.
//
// The three datapaths, with the TPU kernel's int8 narrowing of x
// (swu_mvu.py:112,178: a value >= 128 wraps) and one multiply-add each:
//   standard  a = int8(x),            w = W                acc = A . W^T
//   binary    a = int8(x),            w = 2*W01 - 1        acc = 2 dot - rowsum
//   xnor      a = 2*int8(x) - 1,      w = 2*bit - 1        acc = 4 dot - 2 rowsum
//                                                                - 2 colsum + K
// The xnor weights are the stored packed words (32 taps a word,
// LSB-first), unpacked as they are loaded.  A tap outside the image is
// stored-bit 0, bipolar -1, as in the TPU kernel's identity, which counts
// it through colsum and K; taps past K read 0 from both operands and add
// nothing.  sum_k (2a - 1)(2w - 1) equals that identity for every integer
// a, so no pad-bit correction is needed.
//
// What bounds it on the H100: at the CNV engine's one image per launch,
// latency.  conv1 (784 pixels x 64 channels, K = 576) is ~58 MOP and
// ~0.3 MB, under 0.1 us of either bound.  A 32 x 32 output tile steps K
// 32 taps at a time with no overlap of load and multiply-add, and the
// small late layers have few tiles: conv5 (1 pixel x 256 channels,
// K = 2304) is 8 blocks of 72 serial steps.  The index arithmetic of the
// gather (two divisions for the pixel, two for the tap) is paid per
// staged element.  Split K for outputs of few tiles, a line buffer of
// whole input rows in shared memory, overlapped loads and int8 tensor
// cores are later work.
//
// Sums wrap mod 2^32 like XLA's int32 arithmetic: they are taken in
// uint32 and reinterpreted as int32.

#include "mvu_tile.cuh"

namespace {

using namespace repro;

enum Mode : int { kStandard = 0, kBinary = 1, kXnor = 2 };

struct ConvGeom {
  int h, w, c;         // input image
  int kd, stride, pad;
  int oh, ow;          // output image
  int k;               // taps per window: kd * kd * c
  int w_cols;          // weight row length: k, or ceil(k / 32) words (xnor)
};

// One tap of the sliding window of output pixel gm (int8-narrowed; xnor
// taps as +/-1) and one weight of channel gn, both for tap gk.
template <int MODE>
struct ConvLoads {
  const int32_t* x;
  const void* w;
  ConvGeom g;

  __device__ __forceinline__ int32_t a(int gm, int gk) const {
    const int pixels = g.oh * g.ow, row_taps = g.kd * g.c;
    const int b = gm / pixels, p = gm - b * pixels;
    const int oy = p / g.ow, ox = p - oy * g.ow;
    const int ky = gk / row_taps, r = gk - ky * row_taps;
    const int kx = r / g.c, c = r - kx * g.c;
    const int iy = oy * g.stride + ky - g.pad, ix = ox * g.stride + kx - g.pad;
    int32_t v = 0;
    if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
      v = static_cast<int8_t>(x[((static_cast<size_t>(b) * g.h + iy) * g.w + ix) * g.c + c]);
    return MODE == kXnor ? 2 * v - 1 : v;
  }

  __device__ __forceinline__ int32_t wt(int gn, int gk) const {
    if (MODE == kXnor) {
      const uint32_t word = static_cast<const uint32_t*>(
          w)[static_cast<size_t>(gn) * g.w_cols + (gk >> 5)];
      return ((word >> (gk & 31)) & 1u) ? 1 : -1;
    }
    const int32_t v = static_cast<const int8_t*>(w)[static_cast<size_t>(gn) * g.w_cols + gk];
    return MODE == kBinary ? 2 * v - 1 : v;
  }
};

// One output tile: the whole K loop in one block, then the epilogue.
template <int MODE, int EPI>
__global__ void __launch_bounds__(THREADS)
conv_mvu_kernel(ConvLoads<MODE> ld, const int32_t* __restrict__ thr,
                const float* __restrict__ scale, void* __restrict__ out, int m, int n,
                int n_thr) {
  uint32_t acc[RM][RN], rowsum[RM];
  mvu_tile<false>(
      m, n, ld.g.k, [&](int gm, int gk) { return ld.a(gm, gk); },
      [&](int gn, int gk) { return ld.wt(gn, gk); }, 0u, Mac{}, acc, rowsum);
  store_tile<EPI>([&](int i, int j) { return static_cast<int32_t>(acc[i][j]); }, m, n,
                  thr, n_thr, scale, out);
}

template <int MODE>
cudaError_t launch_mode(const void* x, const void* w, const void* thr, const void* scale,
                        void* out, int m, int n, const ConvGeom& g, int n_thr,
                        int epilogue, cudaStream_t stream) {
  const ConvLoads<MODE> ld{static_cast<const int32_t*>(x), w, g};
  return dispatch_epilogue(epilogue, [&](auto e) {
    conv_mvu_kernel<MODE, decltype(e)::value><<<grid_for(m, n), THREADS, 0, stream>>>(
        ld, static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m, n,
        n_thr);
  });
}

}  // namespace

// x (B, H, W, C) int32; w (N, w_cols): int8 rows (w_cols == K) or, for
// xnor, 32-bit words (w_cols == ceil(K / 32)); out (B * OH * OW, N).
// The wrapper (kernels/swu_mvu.py) checks shapes and that every index fits.
extern "C" int repro_conv_mvu(const void* x, const void* w, const void* thr,
                              const void* scale, void* out, int b, int h, int wd, int c,
                              int n, int kd, int stride, int pad, int w_cols, int n_thr,
                              int mode, int epilogue, void* stream) {
  ConvGeom g{h, wd, c, kd, stride, pad, (h + 2 * pad - kd) / stride + 1,
             (wd + 2 * pad - kd) / stride + 1, kd * kd * c, w_cols};
  const int m = b * g.oh * g.ow;
  const int want_cols = mode == kXnor ? (g.k + 31) / 32 : g.k;
  if (w_cols != want_cols || g.oh <= 0 || g.ow <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStandard:
      return static_cast<int>(
          launch_mode<kStandard>(x, w, thr, scale, out, m, n, g, n_thr, epilogue, s));
    case kBinary:
      return static_cast<int>(
          launch_mode<kBinary>(x, w, thr, scale, out, m, n, g, n_thr, epilogue, s));
    case kXnor:
      return static_cast<int>(
          launch_mode<kXnor>(x, w, thr, scale, out, m, n, g, n_thr, epilogue, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
