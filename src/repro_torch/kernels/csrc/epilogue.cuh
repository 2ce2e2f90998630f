// The MVTU epilogue after the int32 accumulator, which every MVU kernel
// runs, and what the two kernels on the shared K loop (mvu_tile.cuh:
// mvu_xnor, mvu_int2_packed) also share: the tile they are compiled for
// and the launch dispatch over the epilogue.
//
//   thresholds (N, T) int32   out = sum_t (acc >= T[n, t])   (int32 levels)
//   scale      (N,) float32   out = float(acc) * s[n]        (float32)
//   neither                   out = acc                      (int32)
//
// This is the JAX package's shared epilogue (src/repro/kernels/_common.py::
// epilogue_value); the plain PyTorch twin is repro_torch/kernels/_common.py.
//
// Each kernel on the K loop is a 2-D grid of BM x BN output tiles (block (x, y) owns
// rows x*BM.. and columns y*BN..).  A block's THREADS threads each own an
// RM x RN register tile of outputs (rows ty + i*TY, columns tx + j*TX)
// and hand it to store_tile at the end.  Tile sizes come from the Python
// side as -D flags (kernels/_cuda.py is their one definition).

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#if !defined(MVU_BM) || !defined(MVU_BN) || !defined(MVU_BK) || !defined(MVU_THREADS)
#error "build through repro_torch.kernels._cuda, which passes the tile sizes"
#endif

namespace repro {

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

// Write one thread's register tile through the epilogue: value(i, j) is
// the int32 accumulator of its output (ty + i*TY, tx + j*TX) in the
// block's tile; rows >= m and columns >= n (the ragged edges) are skipped.
template <int EPI, typename Value>
__device__ __forceinline__ void store_tile(Value value, int m, int n,
                                           const int32_t* __restrict__ thr, int n_thr,
                                           const float* __restrict__ scale,
                                           void* __restrict__ out) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = static_cast<int>(blockIdx.x) * BM + ty + i * TY;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = static_cast<int>(blockIdx.y) * BN + tx + j * TX;
      if (gn >= n) continue;
      const int32_t v = value(i, j);
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

// Launch `launch(std::integral_constant<int, EPI>{})` for the runtime
// epilogue code; returns the launch's error (cudaSuccess = 0).
template <typename Launch>
cudaError_t dispatch_epilogue(int epilogue, Launch&& launch) {
  switch (epilogue) {
    case kRaw:
      launch(std::integral_constant<int, kRaw>{});
      break;
    case kThresholds:
      launch(std::integral_constant<int, kThresholds>{});
      break;
    case kScale:
      launch(std::integral_constant<int, kScale>{});
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

inline dim3 grid_for(int m, int n) { return dim3((m + BM - 1) / BM, (n + BN - 1) / BN); }

}  // namespace repro
