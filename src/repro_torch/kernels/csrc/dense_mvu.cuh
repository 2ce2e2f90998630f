// The CUDA-core dense MVU of five kernels -- mvu_int.cu, mvu_binary.cu,
// mvu_packed.cu's mvu_binary_packed and mvu_int2_packed, and mvu_xnor.cu
// (its packed-word and its bit entry) -- for Hopper (sm_90a):
//
//   out[M, N] = epilogue(finish(sum_k a(A[m, k]) op w(W[n, k])))
//
// An operand coding (the structs below) says four things:
// * how an A element is read: int32 as it is, or narrowed to int8 by the
//   wrapping cast of the JAX packed kernels (mvu_packed.py:152, :280);
// * how W is stored and staged, a K step at a time: int8 rows (N, K);
//   32-bit bitplanes (N, w_cols >= ceil(K/32)) of the {0,1} coding, one
//   word a column a 32-synapse step; uint8 rows (N, w_cols >= ceil(K/4))
//   of four signed 2-bit lanes a byte, TK/4 bytes a column a step; packed
//   xnor words (N, Wd), staged like the int32 A tile;
// * the K unit: a synapse, or for XnorWords a 32-bit word of 32 synapses
//   (A is then (M, Wd) packed words too);
// * how the sum is finished: acc (the integer datapaths), 2 * acc -
//   rowsum(A) for {0,1}-coded +/-1 weights (the gemv arrangement
//   multiplies by 2w - 1 instead), or K - 2 * acc for xnor, where acc
//   counts the disagreeing bits popc(a ^ w).  That equals the XNOR
//   identity 2 * popc(~(a ^ w)) - pad_correction(K, Wd * 32) of the JAX
//   kernel (mvu_xnor.py:63-69), and a zero pad word or bit of both
//   operands adds nothing to it.  Its constant K is applied once, after
//   the K slices are summed.
// The multiplying datapaths take int32 activations and full-width
// products, so the kernels stay on the CUDA cores; sums are uint32 and
// wrap mod 2^32 like XLA's int32 dot.
//
// Two arrangements, chosen by the Python plan (kernels/dense_mvu.py::
// dense_launch_plan) and checked by dense::launch:
//
// * gemv, M <= 8 (the CNV's dense layers at one image a microbatch).  A
//   warp owns one output column n for all M rows; its lanes stride K four
//   synapses at a time with 16-byte loads of A and one load of W (four
//   int8, the word whose four bits they are, or the byte of four 2-bit
//   lanes), sum in uint32 and reduce with __shfl_xor_sync; lane i runs
//   the epilogue of row i.  XnorWords: a lane takes a word at a time;
//   XnorBits: a lane takes one bit (or four) of A's LSBs and of W's word.
// * tiled, M > 8 (the NID path's M = 128 and larger).  TM x TN output
//   tiles, 256 threads of a (TM/16) x (TN/16) register tile each (rows
//   ty + 16 r, columns tx + 16 c), A and W staged TK units a step through
//   two cp.async buffers, so the next step loads while this one
//   multiplies.  The tile is a template (struct Tile) of a small fixed set
//   (with_tile; kernels/dense_mvu.py DENSE_TILES, by the same index):
//   TM 32, TN in {32, 64}, TK 32 for every coding and also 64 or 128 for
//   the int8-row and 2-bit codings (C::wide_k) -- the word codings stage
//   one word a column or 32 words a row a step, and keep that step -- and
//   one taller tile, 64 x 32 x 32.  The layer's PE / SIMD folding picks
//   TN / TK (core/folding.py::to_gpu_blocks), as to_tpu_blocks picks the
//   Pallas blocks; TM is 32 unless a tuned entry pins 64.  When the output has too
//   few tiles to fill the card, K is split across a thread-block cluster
//   and the slices are summed through distributed shared memory in the
//   same launch (cluster_reduce.cuh): fc0 of the NID path at M = 128 in
//   32 x 32 tiles (8 tiles of 19 steps) becomes 64 blocks.  XnorBits
//   packs a step's A words where it reads them: two __ballot_sync of the
//   staged int32 tile's LSBs give a warp the words of its two rows.
//
// A lane past K reads A as 0 (masked loads, zero-filled copies), so it
// adds nothing to a multiplying datapath whatever its W lane holds: pad
// bits of a bitplane word and pad lanes of a 2-bit byte never count.  The
// epilogue operand is staged in shared memory by cp.async while K runs,
// and up to 16 thresholds a column are held in registers for the outputs
// a thread stores (tiled without split K).

#pragma once

#include "cluster_reduce.cuh"

namespace repro {
namespace dense {

enum Arrangement : int { kGemv = 0, kTiled = 1 };
// how W is stored (kernels/dense_mvu.py CODING)
enum WCoding : int { kInt8Rows, kBitplanes, kInt2Lanes, kXnorWords, kXnorBits };

constexpr int GEMV_MAX_M = 8;  // rows a gemv warp keeps
constexpr int GEMV_WARPS = 8;  // columns a gemv block
constexpr int THREADS = 256;   // tiled: a block
constexpr int TX = 16;         // tiled: threads along N (and 16 along M)

// One tile of the tiled arrangement: TM x TN outputs a block, TK K units
// a step, and what is sized by them.
template <int TM_, int TN_, int TK_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, TK = TK_;
  static constexpr int RM = TM / 16;      // rows a thread: ty + 16 r
  static constexpr int RN = TN / TX;      // columns a thread: tx + 16 c
  static constexpr int A_PITCH = TK + 4;  // int32 words a staged A row (16-byte rows)
  static constexpr int W_PITCH = TK + 16; // bytes a staged int8 W row
  static constexpr int A_STAGE = TM * A_PITCH * 4;
  static constexpr int INT2_STEP_BYTES = TK / 4;  // a column's 2-bit lanes of one step
  static constexpr int EPI_STAGE = epi_stage_bytes(TN);
};

template <bool NARROW_A, bool BITPLANES, bool BINARY>
struct Coding {
  static constexpr WCoding coding = BITPLANES ? kBitplanes : kInt8Rows;
  static constexpr bool bitplanes = BITPLANES;
  static constexpr bool xnor = false;
  static constexpr bool wide_k = !BITPLANES;  // K steps of 64 and 128 too
  using W = typename std::conditional<BITPLANES, uint32_t, int8_t>::type;

  // an activation as the datapath multiplies it
  __device__ static __forceinline__ uint32_t a(int32_t x) {
    return NARROW_A ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(x)))
                    : static_cast<uint32_t>(x);
  }
  // W lane e of a staged 4-byte chunk: int8 e (sign-extended), or bit e
  __device__ static __forceinline__ uint32_t w(uint32_t chunk, int e) {
    return BITPLANES ? (chunk >> e) & 1u
                     : static_cast<uint32_t>(static_cast<int32_t>(
                           static_cast<int8_t>(chunk >> (8 * e))));
  }
  // the gemv factor of a weight value (binary: the +/-1 it codes)
  __device__ static __forceinline__ uint32_t factor(int32_t v) {
    return static_cast<uint32_t>(BINARY ? 2 * v - 1 : v);
  }
  // the tiled arrangement's sum of a (slice of) dot and its A row sum
  __device__ static __forceinline__ uint32_t finish(uint32_t acc, uint32_t rowsum) {
    return BINARY ? 2u * acc - rowsum : acc;
  }
};

using IntRows = Coding<false, false, false>;        // mvu_int
using BinaryRows = Coding<false, false, true>;      // mvu_binary
using BinaryBitplanes = Coding<true, true, true>;   // mvu_binary_packed

// mvu_int2_packed: A narrowed to int8, W four signed 2-bit lanes a byte
// (lane e of a byte in bits 2e..2e+1, 0b10 -> -2, 0b11 -> -1), acc
struct Int2Lanes {
  static constexpr WCoding coding = kInt2Lanes;
  static constexpr bool bitplanes = false;
  static constexpr bool xnor = false;
  static constexpr bool wide_k = true;
  using W = uint8_t;

  __device__ static __forceinline__ uint32_t a(int32_t x) {
    return static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(x)));
  }
  // lane e of the 2-bit lanes in the low bits of chunk, sign-extended
  __device__ static __forceinline__ uint32_t w(uint32_t chunk, int e) {
    return static_cast<uint32_t>(static_cast<int32_t>(chunk << (30 - 2 * e)) >> 30);
  }
  __device__ static __forceinline__ uint32_t factor(int32_t v) {
    return static_cast<uint32_t>(v);
  }
  __device__ static __forceinline__ uint32_t finish(uint32_t acc, uint32_t) { return acc; }
};

// mvu_xnor: A (M, Wd) and W (N, Wd) packed words; the K unit is a word.
// The kernels' w_cols carries the true bit count K (both rows are k words).
struct XnorWords {
  static constexpr WCoding coding = kXnorWords;
  static constexpr bool bitplanes = false;
  static constexpr bool xnor = true;
  static constexpr bool wide_k = false;
  using W = uint32_t;

  __device__ static __forceinline__ uint32_t finish(uint32_t acc, uint32_t) { return acc; }
};

// mvu_xnor's bit entry: A (M, K) int32 activations of which the LSB is the
// stored bit, packed here; W (N, ceil(K/32)) words staged as bitplanes
struct XnorBits {
  static constexpr WCoding coding = kXnorBits;
  static constexpr bool bitplanes = true;
  static constexpr bool xnor = true;
  static constexpr bool wide_k = false;
  using W = uint32_t;

  __device__ static __forceinline__ uint32_t finish(uint32_t acc, uint32_t) { return acc; }
};

// Bytes of a K step's staged W, by coding: TN int8 rows of W_PITCH bytes;
// TK / 4 bytes of 2-bit lanes a column; TN rows of words laid out like A
// (xnor words); one word a column (bitplanes and the xnor bit entry, whose
// step is 32 synapses).
template <typename C, typename T>
__host__ __device__ constexpr int w_stage_bytes() {
  return C::coding == kInt8Rows    ? T::TN * T::W_PITCH
         : C::coding == kInt2Lanes ? T::TN * T::INT2_STEP_BYTES
         : C::coding == kXnorWords ? T::TN * T::A_PITCH * 4
                                   : T::TN * 4;
}

// Dynamic shared memory of a tiled block: the staged epilogue operand, then
// two stages of A and W, which the (TM, TN) uint32 partial tile of a cluster
// sum reuses (kernels/dense_mvu.py::tiled_smem_bytes).
template <typename C, typename T>
__host__ __device__ constexpr int tiled_smem() {
  constexpr int stages = 2 * (T::A_STAGE + w_stage_bytes<C, T>());
  constexpr int part = T::TM * T::TN * 4;
  return T::EPI_STAGE + (stages > part ? stages : part);
}

// Run f(Tile<...>{}) for the tile of index `tile` (kernels/dense_mvu.py
// DENSE_TILES, in the same order); an index out of coding C's set returns
// cudaErrorInvalidValue.  The first three step K by 32 units; the rest, by
// 64 or 128, exist only for the codings of wide_k.  64 rows are compiled
// for the 32 x 32 x 32 tile alone.
template <typename C, typename F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Tile<32, 32, 32>{});
    case 1: return f(Tile<32, 64, 32>{});
    case 2: return f(Tile<64, 32, 32>{});
    default: break;
  }
  if constexpr (C::wide_k) {
    switch (tile) {
      case 3: return f(Tile<32, 32, 64>{});
      case 4: return f(Tile<32, 64, 64>{});
      case 5: return f(Tile<32, 32, 128>{});
      case 6: return f(Tile<32, 64, 128>{});
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// NW words from shared memory at p (8-byte aligned for NW == 2, else 16)
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&out)[NW]) {
  if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < NW; q += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  }
}

// the true bit count K of an xnor coding from the kernels' (k, w_cols)
template <typename C>
__device__ __forceinline__ uint32_t xnor_bits(int k, int w_cols) {
  return static_cast<uint32_t>(C::coding == kXnorWords ? w_cols : k);
}

// w_cols: W row width in its storage units (bitplane words, 2-bit bytes;
// int8 rows: unused, the row is k bytes; XnorWords: the bit count K)
template <typename C, int EPI>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
gemv(const int32_t* __restrict__ a, const typename C::W* __restrict__ w,
     const int32_t* __restrict__ thr, const float* __restrict__ scale,
     void* __restrict__ out, int m, int n, int k, int n_thr, int vec, int w_cols) {
  const int lane = threadIdx.x & 31;
  const int col = static_cast<int>(blockIdx.x) * GEMV_WARPS + (threadIdx.x >> 5);
  if (col >= n) return;  // the whole warp
  const typename C::W* wr =
      w + static_cast<size_t>(col) *
              (C::bitplanes || C::coding == kInt2Lanes ? w_cols : k);
  uint32_t acc[GEMV_MAX_M];
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i) acc[i] = 0u;
  if constexpr (C::coding == kXnorWords) {  // a word a lane: disagreeing bits
    for (int kk = lane; kk < k; kk += 32) {
      const uint32_t wq = __ldg(wr + kk);
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        acc[i] += __popc(static_cast<uint32_t>(__ldg(a + static_cast<size_t>(i) * k + kk)) ^ wq);
      }
    }
  } else if constexpr (C::coding == kXnorBits) {
    // a bit a lane (four with vec) over all w_cols words: A's LSB, read as
    // 0 past K, against W's bit there, pad bits too (as pack_bits pads A)
    const int kp = w_cols * 32;
    if (vec) {
      for (int kk = lane * 4; kk < kp; kk += 128) {
        const uint32_t wq = __ldg(wr + kk / 32) >> (kk & 31);
#pragma unroll
        for (int i = 0; i < GEMV_MAX_M; ++i) {
          if (i >= m) break;
          const int4 av = kk < k ? __ldg(reinterpret_cast<const int4*>(
                                       a + static_cast<size_t>(i) * k + kk))
                                 : make_int4(0, 0, 0, 0);
          acc[i] += ((static_cast<uint32_t>(av.x) ^ wq) & 1u) +
                    ((static_cast<uint32_t>(av.y) ^ (wq >> 1)) & 1u) +
                    ((static_cast<uint32_t>(av.z) ^ (wq >> 2)) & 1u) +
                    ((static_cast<uint32_t>(av.w) ^ (wq >> 3)) & 1u);
        }
      }
    } else {
      for (int kk = lane; kk < kp; kk += 32) {
        const uint32_t wb = __ldg(wr + kk / 32) >> (kk & 31);
#pragma unroll
        for (int i = 0; i < GEMV_MAX_M; ++i) {
          if (i >= m) break;
          const int32_t x = kk < k ? __ldg(a + static_cast<size_t>(i) * k + kk) : 0;
          acc[i] += (static_cast<uint32_t>(x) ^ wb) & 1u;
        }
      }
    }
  } else if (vec) {  // K % 4 == 0, A 16-byte and W 4-byte aligned
    for (int kk = lane * 4; kk < k; kk += 128) {
      // four synapses: four int8, four bits of one word, or one byte of lanes
      const uint32_t wq =
          C::coding == kInt2Lanes
              ? static_cast<uint32_t>(__ldg(reinterpret_cast<const uint8_t*>(wr) + kk / 4))
          : C::bitplanes ? __ldg(reinterpret_cast<const uint32_t*>(wr) + kk / 32) >> (kk & 31)
                         : __ldg(reinterpret_cast<const uint32_t*>(wr + kk));
      uint32_t f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = C::factor(static_cast<int32_t>(C::w(wq, e)));
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        const int4 av = __ldg(reinterpret_cast<const int4*>(a + static_cast<size_t>(i) * k + kk));
        acc[i] += C::a(av.x) * f[0] + C::a(av.y) * f[1] + C::a(av.z) * f[2] + C::a(av.w) * f[3];
      }
    }
  } else {
    for (int kk = lane; kk < k; kk += 32) {
      const uint32_t f = C::factor(
          C::coding == kInt2Lanes
              ? static_cast<int32_t>(
                    C::w(reinterpret_cast<const uint8_t*>(wr)[kk / 4], kk & 3))
          : C::bitplanes
              ? static_cast<int32_t>(C::w(reinterpret_cast<const uint32_t*>(wr)[kk / 32], kk & 31))
              : static_cast<int32_t>(wr[kk]));
#pragma unroll
      for (int i = 0; i < GEMV_MAX_M; ++i) {
        if (i >= m) break;
        acc[i] += C::a(__ldg(a + static_cast<size_t>(i) * k + kk)) * f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
#pragma unroll
  for (int i = 0; i < GEMV_MAX_M; ++i)
    if (i < m && lane == i) {
      if constexpr (C::xnor)
        store_one<EPI>(static_cast<int32_t>(xnor_bits<C>(k, w_cols) - 2u * acc[i]), i, col, n,
                       thr, n_thr, scale, out);
      else
        store_one<EPI>(static_cast<int32_t>(acc[i]), i, col, n, thr, n_thr, scale, out);
    }
}

template <typename C, typename T, int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS)
tiled(const int32_t* __restrict__ a, const typename C::W* __restrict__ w,
      const int32_t* __restrict__ thr, const float* __restrict__ scale,
      void* __restrict__ out, int m, int n, int k, int n_thr, int splits, int w_cols) {
  constexpr int TM = T::TM, TN = T::TN, TK = T::TK, RM = T::RM, RN = T::RN;
  constexpr int A_PITCH = T::A_PITCH, W_PITCH = T::W_PITCH, A_STAGE = T::A_STAGE;
  constexpr int W_STAGE = w_stage_bytes<C, T>();
  constexpr int STEP_BYTES = T::INT2_STEP_BYTES;
  // 2-bit lanes of unaligned rows: the bytes of a step a thread holds
  constexpr int WB = C::coding == kInt2Lanes ? TN * STEP_BYTES / THREADS : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // the epilogue operand
  unsigned char* stages = smem + T::EPI_STAGE;
  uint32_t* part = reinterpret_cast<uint32_t*>(stages);  // after the K loop
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = static_cast<int>(blockIdx.x) * TM, n0 = static_cast<int>(blockIdx.y) * TN;
  const int steps = (k + TK - 1) / TK;
  int s_lo, s_hi;
  k_slice(steps, splits, static_cast<int>(blockIdx.z), s_lo, s_hi);
  // 2-bit lanes: whole 8-byte pieces by cp.async where every row starts
  // 8-byte aligned, else WB bytes a thread through registers (w_reg),
  // stored after this step's arithmetic (put)
  const bool w8 = C::coding == kInt2Lanes &&
                  ((reinterpret_cast<uintptr_t>(w) | static_cast<uintptr_t>(w_cols)) & 7u) == 0;
  uint32_t w_reg[WB];
#pragma unroll
  for (int j = 0; j < WB; ++j) w_reg[j] = 0u;

  auto a_stage = [&](int q) { return reinterpret_cast<int32_t*>(stages + q * A_STAGE); };
  auto w_stage = [&](int q) { return stages + 2 * A_STAGE + q * W_STAGE; };
  auto load = [&](int s, int q) {
    const int k0 = s * TK;
    int32_t* as = a_stage(q);
    unsigned char* ws = w_stage(q);
    if (VEC) {  // K % 4 == 0: 16-byte A chunks (and 4-byte int8 or 16-byte word W chunks)
      constexpr int CPR = TK / 4;  // chunks a row
#pragma unroll
      for (int j = 0; j < TM * CPR / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * 4, gk = k0 + c;
        const bool ok = m0 + r < m && gk < k;
        cp_async<16>(as + r * A_PITCH + c, ok ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                     ok ? 16 : 0);
      }
      if constexpr (C::coding == kInt8Rows || C::coding == kXnorWords) {
#pragma unroll
        for (int j = 0; j < TN * CPR / THREADS; ++j) {
          const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * 4, gk = k0 + c;
          const bool ok = n0 + r < n && gk < k;
          if constexpr (C::coding == kInt8Rows)
            cp_async<4>(ws + r * W_PITCH + c, ok ? w + static_cast<size_t>(n0 + r) * k + gk : w,
                        ok ? 4 : 0);
          else
            cp_async<16>(reinterpret_cast<int32_t*>(ws) + r * A_PITCH + c,
                         ok ? w + static_cast<size_t>(n0 + r) * k + gk : w, ok ? 16 : 0);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TM * TK / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / TK, c = i % TK, gk = k0 + c;
        const bool ok = m0 + r < m && gk < k;
        cp_async<4>(as + r * A_PITCH + c, ok ? a + static_cast<size_t>(m0 + r) * k + gk : a,
                    ok ? 4 : 0);
      }
      if constexpr (C::coding == kInt8Rows) {
        unsigned char v[TN * TK / THREADS];  // the W loads all in flight at once
#pragma unroll
        for (int j = 0; j < TN * TK / THREADS; ++j) {
          const int i = tid + j * THREADS, r = i / TK, gk = k0 + i % TK;
          v[j] = n0 + r < n && gk < k
                     ? static_cast<unsigned char>(__ldg(reinterpret_cast<const int8_t*>(w) +
                                                        static_cast<size_t>(n0 + r) * k + gk))
                     : 0;
        }
#pragma unroll
        for (int j = 0; j < TN * TK / THREADS; ++j) {
          const int i = tid + j * THREADS;
          ws[(i / TK) * W_PITCH + i % TK] = v[j];
        }
      } else if constexpr (C::coding == kXnorWords) {
#pragma unroll
        for (int j = 0; j < TN * TK / THREADS; ++j) {
          const int i = tid + j * THREADS, r = i / TK, c = i % TK, gk = k0 + c;
          const bool ok = n0 + r < n && gk < k;
          cp_async<4>(reinterpret_cast<int32_t*>(ws) + r * A_PITCH + c,
                      ok ? w + static_cast<size_t>(n0 + r) * k + gk : w, ok ? 4 : 0);
        }
      }
    }
    if constexpr (C::bitplanes) {
      if (tid < TN) {  // step s is word s of each row (TK = 32, s < steps <= w_cols)
        const bool ok_w = n0 + tid < n;
        cp_async<4>(ws + tid * 4, ok_w ? w + static_cast<size_t>(n0 + tid) * w_cols + s : w,
                    ok_w ? 4 : 0);
      }
    } else if constexpr (C::coding == kInt2Lanes) {
      // step s is bytes [s * STEP_BYTES, (s + 1) * STEP_BYTES) of each row;
      // bytes past the row read 0
      if (w8) {  // 8-byte pieces, each wholly inside the row or past it (w_cols % 8 == 0)
        constexpr int P = STEP_BYTES / 8;
        if (tid < TN * P) {
          const int r = tid / P, gb = s * STEP_BYTES + (tid % P) * 8;
          const bool ok_w = n0 + r < n && gb < w_cols;
          cp_async<8>(ws + tid * 8, ok_w ? w + static_cast<size_t>(n0 + r) * w_cols + gb : w,
                      ok_w ? 8 : 0);
        }
      } else {  // byte i = tid + j * THREADS: row i / STEP_BYTES, byte i % STEP_BYTES of the step
#pragma unroll
        for (int j = 0; j < WB; ++j) {
          const int i = tid + j * THREADS, r = i / STEP_BYTES;
          const int gb = s * STEP_BYTES + i % STEP_BYTES;
          w_reg[j] = n0 + r < n && gb < w_cols
                         ? __ldg(w + static_cast<size_t>(n0 + r) * w_cols + gb)
                         : 0u;
        }
      }
    }
  };
  // the bytes a thread loaded for stage q (2-bit lanes, unaligned rows)
  auto put = [&](int q) {
    if (!w8) {
#pragma unroll
      for (int j = 0; j < WB; ++j)
        w_stage(q)[tid + j * THREADS] = static_cast<unsigned char>(w_reg[j]);
    }
  };

  uint32_t acc[RM][RN], rowsum[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    rowsum[r] = 0u;
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0u;
  }
  stage_epilogue<EPI>(stage, n0, TN, n, thr, n_thr, scale);
  if (s_lo < s_hi) {
    load(s_lo, 0);
    if constexpr (C::coding == kInt2Lanes) put(0);
  }
  cp_async_commit();
  for (int s = s_lo; s < s_hi; ++s) {
    const int i = s - s_lo;
    if (s + 1 < s_hi) load(s + 1, (i + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int32_t* as = a_stage(i & 1);
    const unsigned char* ws = w_stage(i & 1);
    uint32_t words[RN];  // bitplanes: this step's word of each of the thread's columns
    if constexpr (C::bitplanes) {
#pragma unroll
      for (int c = 0; c < RN; ++c) words[c] = reinterpret_cast<const uint32_t*>(ws)[tx + c * 16];
    }
    constexpr int LW = TK / 16;  // 2-bit lanes: words of a column a step
    uint32_t lanes[RN][LW];
    if constexpr (C::coding == kInt2Lanes) {
#pragma unroll
      for (int c = 0; c < RN; ++c)
        load_words<LW>(reinterpret_cast<const uint32_t*>(ws + (tx + c * 16) * STEP_BYTES),
                       lanes[c]);
    }
    if constexpr (C::coding == kXnorWords) {
#pragma unroll
      for (int kk = 0; kk < TK; kk += 4) {
        int4 av[RM], wv[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          av[r] = *reinterpret_cast<const int4*>(as + (ty + r * 16) * A_PITCH + kk);
#pragma unroll
        for (int c = 0; c < RN; ++c)
          wv[c] = *reinterpret_cast<const int4*>(reinterpret_cast<const int32_t*>(ws) +
                                                 (tx + c * 16) * A_PITCH + kk);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c)
            acc[r][c] += __popc(av[r].x ^ wv[c].x) + __popc(av[r].y ^ wv[c].y) +
                         __popc(av[r].z ^ wv[c].z) + __popc(av[r].w ^ wv[c].w);
      }
    } else if constexpr (C::coding == kXnorBits) {
      // lane L = tx + 16 (ty & 1) of the warp: ballot bit L is synapse tx
      // of row ty, for the warp's even row in the low half, odd in the high
      const int half = 16 * (ty & 1);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int32_t* row = as + (ty + r * 16) * A_PITCH;
        const uint32_t lo = __ballot_sync(0xffffffffu, row[tx] & 1);
        const uint32_t hi = __ballot_sync(0xffffffffu, row[tx + 16] & 1);
        const uint32_t aw = ((lo >> half) & 0xffffu) | (((hi >> half) & 0xffffu) << 16);
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] += __popc(aw ^ words[c]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < TK; kk += 4) {
        int4 av[RM];
        uint32_t wv[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          av[r] = *reinterpret_cast<const int4*>(as + (ty + r * 16) * A_PITCH + kk);
          rowsum[r] += C::a(av[r].x) + C::a(av[r].y) + C::a(av[r].z) + C::a(av[r].w);
        }
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          if constexpr (C::bitplanes)
            wv[c] = words[c] >> kk;
          else if constexpr (C::coding == kInt2Lanes)
            wv[c] = lanes[c][kk / 16] >> (2 * (kk % 16));
          else
            wv[c] = *reinterpret_cast<const uint32_t*>(ws + (tx + c * 16) * W_PITCH + kk);
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) {
            const uint32_t x[4] = {C::a(av[r].x), C::a(av[r].y), C::a(av[r].z), C::a(av[r].w)};
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][c] += x[e] * C::w(wv[c], e);
          }
      }
    }
    if constexpr (C::coding == kInt2Lanes) {
      if (s + 1 < s_hi) put((i + 1) & 1);  // that stage was last read a step ago
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (splits == 1) {  // no cluster: straight to the epilogue
    __syncthreads();  // the staged epilogue operand is in place
    // up to 16 thresholds (the NID's 4-bit activations): this thread's
    // columns' rows into registers first
    const bool in_regs = EPI == kThresholds && n_thr <= EPI_STAGE_THR;
    Thresholds<EPI_STAGE_THR> th[RN];
    if (in_regs) {
#pragma unroll
      for (int c = 0; c < RN; ++c)
        th[c] = staged_thresholds<EPI_STAGE_THR>(stage, tx + c * 16, n_thr);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int gm = m0 + ty + r * 16, gn = n0 + tx + c * 16;
        if (gm >= m || gn >= n) continue;
        uint32_t total = C::finish(acc[r][c], rowsum[r]);
        if constexpr (C::xnor) total = xnor_bits<C>(k, w_cols) - 2u * total;
        const int32_t v = static_cast<int32_t>(total);
        if (in_regs)
          static_cast<int32_t*>(out)[static_cast<size_t>(gm) * n + gn] = level_of(v, th[c], n_thr);
        else
          store_staged<EPI>(v, gm, tx + c * 16, n0, n, stage, thr, n_thr, out);
      }
    return;
  }
  __syncthreads();  // the stages are free: the partial tile reuses them
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c)
      part[(ty + r * 16) * TN + tx + c * 16] = C::finish(acc[r][c], rowsum[r]);
  cluster_reduce_store(part, TM, TN, [&](int r, int c, uint32_t v) {
    if constexpr (C::xnor) v = xnor_bits<C>(k, w_cols) - 2u * v;  // once, on the sum
    if (m0 + r < m && n0 + c < n)
      store_staged<EPI>(static_cast<int32_t>(v), m0 + r, c, n0, n, stage, thr, n_thr, out);
  });
}

// Launch coding C's kernel on the plan of kernels/dense_mvu.py::
// dense_launch_plan: the arrangement; the tile's index in DENSE_TILES
// (-1 for gemv, which has no tile) with the tile_m x tile_n outputs a
// block and kstep K units a step that the index stands for (gemv: 8 rows x
// 8 columns, kstep unused); splits K slices; smem bytes.  A plan it cannot
// run -- an index outside C's tile set, a tile that does not match its
// index, shared memory other than the tile's -- or W of the wrong width
// returns cudaErrorInvalidValue: no other tile is tried.  k is the
// synapse count K and w_cols the W row's width in its storage: int8 rows
// w_cols == K; bitplanes w_cols >= ceil(K/32); 2-bit lanes
// w_cols >= ceil(K/4); XnorBits w_cols == ceil(K/32); XnorWords (A and W
// both Wd = w_cols words, the plan's K unit a word) K <= 32 * w_cols.
template <typename C>
int launch(const void* a, const void* w, const void* thr, const void* scale, void* out,
           int m, int n, int k, int w_cols, int n_thr, int epilogue, int arrangement,
           int tile, int tile_m, int tile_n, int kstep, int splits, int smem, void* stream) {
  if (k < 0 || w_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the kernels' (k, w_cols): XnorWords runs on Wd words and carries K
  const int units = C::coding == kXnorWords ? w_cols : k;
  const int wk = C::coding == kXnorWords ? k : w_cols;
  const int words = (units + 31) / 32;  // 32-synapse words of a bitplane row
  const long long wide = w_cols;
  const bool w_ok = C::coding == kInt8Rows     ? w_cols == k
                    : C::coding == kBitplanes  ? w_cols >= words
                    : C::coding == kInt2Lanes  ? 4 * wide >= k
                    : C::coding == kXnorBits   ? w_cols == words
                                               : k <= 32 * wide;
  if (!w_ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a32 = static_cast<const int32_t*>(a);
  const auto wc = static_cast<const typename C::W*>(w);
  const auto t32 = static_cast<const int32_t*>(thr);
  const auto sc = static_cast<const float*>(scale);
  // 16-byte A rows and, for int8 rows, 4-byte W chunks (a word is aligned;
  // 2-bit rows pick their copy width in the kernel); xnor words: 16-byte
  // rows of both
  const uintptr_t w_align = C::coding == kXnorWords ? 16 : C::coding == kInt8Rows ? 4 : 1;
  const bool vec = units % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % w_align == 0;
  if (arrangement == kGemv) {
    if (m > GEMV_MAX_M || tile != -1 || tile_m != GEMV_MAX_M || tile_n != GEMV_WARPS ||
        splits != 1 || smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + GEMV_WARPS - 1) / GEMV_WARPS);
    return static_cast<int>(with_epilogue(epilogue, [&](auto e) {
      gemv<C, decltype(e)::value><<<grid, GEMV_WARPS * 32, 0, s>>>(
          a32, wc, t32, sc, out, m, n, units, n_thr, vec ? 1 : 0, wk);
      return cudaGetLastError();
    }));
  }
  if (arrangement != kTiled) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_tile<C>(tile, [&](auto t) -> cudaError_t {
    using T = decltype(t);
    const int steps = (units + T::TK - 1) / T::TK;
    if (tile_m != T::TM || tile_n != T::TN || kstep != T::TK || splits < 1 ||
        splits > MAX_SPLITS || splits > (steps > 0 ? steps : 1) || smem != tiled_smem<C, T>())
      return cudaErrorInvalidValue;
    const dim3 grid((m + T::TM - 1) / T::TM, (n + T::TN - 1) / T::TN, splits);
    return with_epilogue(epilogue, [&](auto e) {
      return vec ? launch_cluster(tiled<C, T, decltype(e)::value, true>, grid, THREADS, smem,
                                  splits, s, a32, wc, t32, sc, out, m, n, units, n_thr, splits,
                                  wk)
                 : launch_cluster(tiled<C, T, decltype(e)::value, false>, grid, THREADS, smem,
                                  splits, s, a32, wc, t32, sc, out, m, n, units, n_thr, splits,
                                  wk);
    });
  }));
}

}  // namespace dense
}  // namespace repro
