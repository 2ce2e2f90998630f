// The K loop of the two MVU kernels not yet redesigned for Hopper,
// mvu_xnor and mvu_int2_packed (the epilogue is epilogue.cuh).
//
// One block accumulates its BM x BN output tile of
//
//     acc[m, n] = sum_{k < K} op(A[m, k], W[n, k])
//
// BK synapses a step: the A and W slices are staged through shared memory
// (K-major, each row padded by one word, so the fill -- consecutive
// threads on consecutive k -- and the reads -- consecutive threads on
// consecutive n -- avoid bank conflicts), then each thread folds op over
// its RM x RN register tile.  load_a(gm, gk) and load_w(gn, gk) return one
// synapse as 32 bits and are called only in range; a synapse past K reads
// as 0 from A and as w_pad from W, and op(0, w_pad) must be 0.  Sums are
// uint32, where wraparound is defined: the int32 wrap of XLA's integer
// dot.
//
// One step's loads, barrier and BK rounds run with no overlap, on a grid
// as small as ceil(M/BM) x ceil(N/BN) blocks: at the NID shapes that
// latency, not bytes or operations, bounds every kernel built on it.

#pragma once

#include "epilogue.cuh"

namespace repro {

template <typename LoadA, typename LoadW, typename Op>
__device__ __forceinline__ void mvu_tile(int m, int n, int k, LoadA load_a, LoadW load_w,
                                         uint32_t w_pad, Op op, uint32_t (&acc)[RM][RN]) {
  __shared__ uint32_t as[BK][BM + 1];
  __shared__ uint32_t ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = static_cast<int>(blockIdx.x) * BM;
  const int n0 = static_cast<int>(blockIdx.y) * BN;

#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < m && gk < k) ? static_cast<uint32_t>(load_a(gm, gk)) : 0u;
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gn = n0 + r, gk = k0 + c;
      ws[c][r] = (gn < n && gk < k) ? static_cast<uint32_t>(load_w(gn, gk)) : w_pad;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t av[RM], wv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = as[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) wv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += op(av[i], wv[j]);
    }
    __syncthreads();
  }
}

// the multiply-add of the integer datapaths (products wrap in uint32)
struct Mac {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t w) const {
    return a * w;
  }
};

}  // namespace repro
