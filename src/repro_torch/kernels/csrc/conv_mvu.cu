// Fused SWU + MVU convolution (paper Fig. 1) for Hopper (sm_90a), on the
// int8 tensor cores.
//
//   out[B*OH*OW, N] = epilogue(SWU(x)[B*OH*OW, K] . W[N, K]^T),  K = Kd^2 * C
//
// Replaces src/repro/kernels/swu_mvu.py::conv_mvu_pallas (the pallas_call
// at swu_mvu.py:207).  x is the (B, H, W, C) NHWC image as int32 levels;
// W is (N, K) in (ky, kx, c) order (core/swu.py::pack_conv_weights).
//
// Design (the launch plan -- tile, K splits, shared memory -- comes from
// kernels/swu_mvu.py::conv_launch_plan and is checked here):
//
// * Tiles.  A block owns TM consecutive output pixels of one image and TN
//   output channels: a template (struct ConvTile) of a small fixed set,
//   32 x 32 and TM in {32, 64, 128} at TN 64 (with_conv_tile;
//   kernels/swu_mvu.py CONV_TILES, by the same index).  The layer's PE
//   folding picks TN (core/folding.py::to_gpu_blocks), a tuned entry's
//   rows_per_tile picks TM (about that many output rows of pixels), as
//   block_n and rows_per_tile pick the Pallas blocks; untuned, TM is 32.  K steps 32 taps, one mma k, in every tile.
// * Line buffer.  A block loads once, into shared memory, the input
//   rows that its pixels' windows touch (only the window rows (ky) of its
//   K slice), all C channels, narrowing each value to int8 as it stores
//   it -- the TPU kernel's own line buffer and wrap (swu_mvu.py:99-113:
//   the window rows, then .astype(int8)).  A pixel takes `pitch` words,
//   the least >= C/4 that is 4 mod 8, so the eight pixel rows of an mma
//   fragment fall in distinct banks.  The rows come as 16-byte loads of 4
//   channels where C % 4 == 0.  So the (B*OH*OW, K) im2col matrix never
//   exists, and the gather is no longer paid per staged element: for
//   C % 32 == 0 a 32-tap step lies inside one (ky, kx), whose offset is
//   computed once a step; other C (conv0, C = 3) decode each of a
//   thread's 8 taps a step (ALIGNED = false).  A tap outside the image
//   reads 0.
// * Gather, where those rows do not fit the block's shared memory (an
//   image row of ~1,000 pixels at C = 256, say): the same kernel reads
//   each tap of its A fragments from the image in device memory instead,
//   narrowed as it is read (the ALIGNED = false instance, arrangement
//   kGather).  Every shape the wrapper accepts launches.
// * int8 tensor cores.  mma.sync m16n8k32 s8.s8 -> s32; 2 x 2 warps (4 x 2
//   for TM >= 64), each TM / 2 (TM / 4) pixels x TN / 2 channels in
//   m16 x n8 fragments (16 x 16 of the 32 x 32 tile).  The three datapaths
//   are one int8 product each:
//     standard  a = int8(x), w = W                    acc = a . w
//     binary    a = int8(x), w = W (int8)             acc = 2 a . w - rowsum(a)
//     xnor      v = int8(x), w = 2*bit - 1 (+/-1)     acc = 2 v . w - colsum(w)
//   rowsum(a) is one more mma against an all-ones fragment; colsum(w) =
//   sum_{k<K} (2 bit - 1), once a block from the packed words.  An xnor
//   pad tap is v = 0, so it adds -w: bipolar -1 times w, as in the TPU
//   kernel's identity.  |int8 * int8| <= 2^14, so an s32 fragment cannot
//   overflow within 2^16 taps; fragments are added into uint32 totals
//   every 2048 steps (65,536 taps) and at the end, so the sum wraps mod
//   2^32 exactly like XLA's int32 arithmetic for any K.
// * Weights through a ring of NSTAGE cp.async stages (32 taps x TN
//   channels each), so the next seven steps' weights load while the
//   tensor cores work on this one; they are issued before the line buffer
//   fills, and every fill keeps eight loads in flight a thread.  Where
//   16-byte copies cannot cut the rows (K % 16 != 0: conv0, K = 27), each
//   thread reads its B fragments from device memory, a step ahead.  xnor
//   words are unpacked to +/-1 as the fragments are read.  The epilogue
//   operand of the block's TN columns is staged by cp.async too, and up to
//   4 thresholds a column are held in registers for the outputs a thread
//   stores.
// * Split K in a cluster (cluster_reduce.cuh): when the output has too
//   few tiles to fill the card, the K steps are cut into up to 8 slices,
//   one block each, summed through distributed shared memory in the same
//   launch.  conv5 at one image (1 pixel x 256 channels, K = 2304) is 8
//   column tiles x 8 slices of 9 steps instead of 8 blocks of 72.
//
// What bounds it on the H100: at the CNV engine's one image a launch,
// latency.  A layer's bytes and operations take < 0.2 us at the card's
// peaks; a launch takes 5.4-9.1 us (scripts/torch_kernel_ab.py, H100 80GB
// HBM3 at 700 W), the chain of one block: the launch, the parameter and
// index set-up, one round trip for the line buffer, a few K steps, the
// cluster sum and the epilogue (whose threshold compares, a row read at
// a time, were once the longest link).  At 32 images a launch the tensor
// cores would take ~1 us for a layer's ~1 G MAC; the line buffer fill and
// the fragment reads from shared memory are the rest of the 16-49 us.  At
// 256 images a launch the 32-pixel x 64-channel tile, which halves the
// line-buffer fills per output channel, runs the FULL CNV's six convs in
// 0.61-0.69 ms against 0.84-0.99 ms in 32 x 32, and the 128 x 64 tile
// takes 44-55% of 32 x 32's time on conv1 and conv3 (output rows of 28
// and 10 pixels) but more on the small late layers, so the tile is a
// per-layer choice (chip_smoke's tiles phase, H100 80GB HBM3 at 700 W).  The gather
// arrangement pays a dependent device-memory load per tap instead of the
// fill; no shape of the port's models takes it.

#include <algorithm>

#include "cluster_reduce.cuh"

namespace {

using namespace repro;

enum Mode : int { kStandard = 0, kBinary = 1, kXnor = 2 };

enum Arrangement : int { kLine = 0, kGather = 1 };

constexpr int KSTEP = 32;          // taps a step: one mma k
constexpr int NSTAGE = 8;          // weight ring depth: 7 steps in flight
constexpr int RING_PITCH = 48;     // bytes a weight row a stage (32 + 16: no bank conflicts)
constexpr int FLUSH_STEPS = 2048;  // 65,536 taps: an s32 fragment cannot overflow

// One block's tile: TM output pixels x TN output channels, and what is
// sized by it.  Warps: WARPS_M along the pixels x 2 along the channels,
// each MI m16 fragments of pixels x NI n8 fragments of channels.
template <int TM_, int TN_>
struct ConvTile {
  static constexpr int TM = TM_, TN = TN_;
  static constexpr int WARPS_M = TM == 32 ? 2 : 4;
  static constexpr int THREADS = WARPS_M * 2 * 32;
  static constexpr int MI = TM / (16 * WARPS_M);
  static constexpr int NI = TN / 16;
  static constexpr int RING_BYTES = NSTAGE * TN * RING_PITCH;
  static constexpr int HEAD_BYTES = (TN + 2 * KSTEP) * 4;  // xnor column sums, decoded taps
};

// Run f(ConvTile<...>{}) for the tile of index `tile` (kernels/swu_mvu.py
// CONV_TILES, in the same order); another index returns
// cudaErrorInvalidValue.
template <typename F>
cudaError_t with_conv_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(ConvTile<32, 32>{});
    case 1: return f(ConvTile<32, 64>{});
    case 2: return f(ConvTile<64, 64>{});
    case 3: return f(ConvTile<128, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

struct ConvArgs {
  const int32_t* x;
  const void* w;
  const int32_t* thr;
  const float* scale;
  void* out;
  int h, wd, c, n, kd, stride, pad, oh, ow, k, w_cols, n_thr;
  int pitch;      // words a pixel takes in the line buffer
  int tiles_img;  // pixel tiles an image
  int steps;      // K steps of KSTEP taps
  int splits;     // K slices (the cluster's size)
  int line;       // the rows sit in a line buffer (kLine), else A is read from x
  int x_vec;      // x loads as int4 (C % 4 == 0, 16-byte aligned)
  int w_vec;      // weight rows copy as 16 bytes (K % 16 == 0, aligned)
};

// words a pixel takes in the line buffer: >= ceil(C/4), and 4 mod 8
__host__ __device__ inline int lb_pitch(int c) {
  const int p = (c + 3) / 4;
  return p + ((4 - p) % 8 + 8) % 8;
}

// Dynamic shared memory a block of tile T needs: the xnor column sums and
// a step's tap offsets, the staged epilogue operand, then the weight ring
// and (for kLine) the line buffer -- TM pixels span at most `span` output
// rows, so their windows at most (span - 1) * stride + Kd input rows --
// or the partial tile of the cluster sum, which reuses them.
template <typename T>
long smem_needed(int arrangement, int h, int wd, int c, int kd, int stride, int oh, int ow) {
  long lb = 0;
  if (arrangement == kLine) {
    const int span = std::min(oh, (ow + T::TM - 2) / ow + 1);
    const long rows = std::min(static_cast<long>(h), (span - 1L) * stride + kd);
    lb = rows * wd * lb_pitch(c) * 4;
  }
  const long body = std::max(static_cast<long>(T::RING_BYTES) + lb,
                             static_cast<long>(T::TM) * T::TN * 4);
  return T::HEAD_BYTES + epi_stage_bytes(T::TN) + body;
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four {0,1} bits (LSB first) -> four int8 lanes of +/-1
__device__ __forceinline__ uint32_t bits_to_bipolar4(uint32_t nibble) {
  const uint32_t spread = (nibble * 0x00204081u) & 0x01010101u;  // bit i -> byte i
  return ~(spread * 0xFEu);  // byte 1 -> 0x01, byte 0 -> 0xFF
}

// four int32 channels -> four int8 lanes (the wrapping narrowing)
__device__ __forceinline__ uint32_t narrow4(int4 v) {
  return (static_cast<uint32_t>(v.x) & 0xFFu) | ((static_cast<uint32_t>(v.y) & 0xFFu) << 8) |
         ((static_cast<uint32_t>(v.z) & 0xFFu) << 16) | (static_cast<uint32_t>(v.w) << 24);
}

template <typename T, int MODE, int EPI, bool ALIGNED>
__global__ void __launch_bounds__(T::THREADS) conv_mvu_kernel(ConvArgs g) {
  constexpr int TM = T::TM, TN = T::TN, MI = T::MI, NI = T::NI, THREADS = T::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* colsum = reinterpret_cast<int32_t*>(smem);
  int2* taps = reinterpret_cast<int2*>(colsum + TN);  // ALIGNED = false: a step's taps
  unsigned char* stage = smem + T::HEAD_BYTES;  // the epilogue operand
  unsigned char* ring = stage + epi_stage_bytes(TN);
  uint32_t* lb = reinterpret_cast<uint32_t*>(ring + T::RING_BYTES);
  uint32_t* part = reinterpret_cast<uint32_t*>(ring);  // after the K loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment group and thread in group
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int pixels = g.oh * g.ow;
  const int img = static_cast<int>(blockIdx.x) / g.tiles_img;
  const int p0 = (static_cast<int>(blockIdx.x) - img * g.tiles_img) * TM;
  const int n0 = static_cast<int>(blockIdx.y) * TN;
  int s_lo, s_hi;
  k_slice(g.steps, g.splits, static_cast<int>(blockIdx.z), s_lo, s_hi);
  const int8_t* w8 = static_cast<const int8_t*>(g.w);
  const uint32_t* w32 = static_cast<const uint32_t*>(g.w);

  // The weights of step s: into ring slot `slot` by cp.async (16 bytes of
  // a row, or one xnor word); or, where K % 16 != 0 (the narrow path),
  // as this thread's B fragments straight from device memory, fetched a
  // step ahead.
  const bool narrow_w = MODE != kXnor && !g.w_vec;
  auto load_w = [&](int s, int slot) {
    unsigned char* dst = ring + slot * TN * RING_PITCH;
    if (MODE == kXnor) {
      if (tid < TN) {
        const int gn = n0 + tid;
        const bool ok = gn < g.n && s < g.w_cols;
        cp_async<4>(dst + tid * RING_PITCH,
                    ok ? w32 + static_cast<size_t>(gn) * g.w_cols + s : w32, ok ? 4 : 0);
      }
    } else if (tid < 2 * TN) {
      const int r = tid >> 1, gn = n0 + r, gk = s * KSTEP + (tid & 1) * 16;
      const bool ok = gn < g.n && gk < g.k;
      cp_async<16>(dst + r * RING_PITCH + (tid & 1) * 16,
                   ok ? w8 + static_cast<size_t>(gn) * g.k + gk : w8, ok ? 16 : 0);
    }
  };
  auto fetch_b = [&](int s, uint32_t (&b)[NI][2]) {
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
      const int gn = n0 + warp_n * (TN / 2) + nt * 8 + gq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // all four loads in flight: a valid address, then a select
          const int gk = s * KSTEP + h * 16 + tq * 4 + e;
          const bool ok = gn < g.n && gk < g.k;
          const uint8_t v = static_cast<uint8_t>(
              __ldg(ok ? w8 + static_cast<size_t>(gn) * g.k + gk : w8));
          word |= (ok ? static_cast<uint32_t>(v) : 0u) << (8 * e);
        }
        b[nt][h] = word;
      }
    }
  };

  // the first weight steps load while the column sums and the line buffer do
  stage_epilogue<EPI>(stage, n0, TN, g.n, g.thr, g.n_thr, g.scale);
  uint32_t b_next[NI][2];
#pragma unroll
  for (int nt = 0; nt < NI; ++nt) b_next[nt][0] = b_next[nt][1] = 0u;
  if (narrow_w && s_lo < s_hi) fetch_b(s_lo, b_next);
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (!narrow_w && s_lo + i < s_hi) load_w(s_lo + i, i);
    cp_async_commit();
  }

  if (MODE == kXnor) {  // colsum(w) = 2 * popcount - K, QC threads a column
    constexpr int QC = THREADS / TN;
    const int col = tid / QC, q = tid % QC, gn = n0 + col;
    int pop = 0;
    if (gn < g.n) {
      for (int j0 = q; j0 < g.w_cols; j0 += QC * 8) {
        uint32_t word[8];  // eight loads in flight
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + QC * u;
          word[u] = j < g.w_cols ? __ldg(w32 + static_cast<size_t>(gn) * g.w_cols + j) : 0u;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int rem = g.k - (j0 + QC * u) * 32;
          pop += __popc(rem < 32 ? word[u] & ((1u << max(rem, 0)) - 1u) : word[u]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < QC; off <<= 1) pop += __shfl_xor_sync(0xffffffffu, pop, off);
    if (q == 0) colsum[col] = 2 * pop - g.k;
  }

  // the line buffer: input rows iy_lo..iy_hi of image img, as int8
  const int row_taps = g.kd * g.c;
  const int oy_first = p0 / g.ow;
  const int oy_last = (min(p0 + TM, pixels) - 1) / g.ow;
  int iy_lo = 0;
  if (g.line && s_lo < s_hi) {
    const int ky_lo = s_lo * KSTEP / row_taps;
    const int ky_hi = (min(s_hi * KSTEP, g.k) - 1) / row_taps;
    iy_lo = max(0, oy_first * g.stride - g.pad + ky_lo);
    const int iy_hi = min(g.h - 1, oy_last * g.stride - g.pad + ky_hi);
    if (iy_lo <= iy_hi) {
      const int32_t* src = g.x + (static_cast<size_t>(img) * g.h + iy_lo) * g.wd * g.c;
      const int count = (iy_hi - iy_lo + 1) * g.wd * g.c;
      constexpr int U = 8;  // loads in flight a thread
      if (g.x_vec) {
        const int4* src4 = reinterpret_cast<const int4*>(src);
        const int c4 = g.c >> 2, n4 = count / 4;
        for (int i0 = tid; i0 < n4; i0 += U * THREADS) {
          int4 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS;
            if (i < n4) v[u] = __ldg(src4 + i);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS, pix = i / c4;
            if (i < n4) lb[pix * g.pitch + (i - pix * c4)] = narrow4(v[u]);
          }
        }
      } else {
        unsigned char* lbb = reinterpret_cast<unsigned char*>(lb);
        for (int i0 = tid; i0 < count; i0 += U * THREADS) {
          int32_t v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS;
            if (i < count) v[u] = __ldg(src + i);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS, pix = i / g.c;
            if (i < count)
              lbb[pix * g.pitch * 4 + (i - pix * g.c)] = static_cast<unsigned char>(v[u]);
          }
        }
      }
    }
  }

  // this thread's pixel rows: tile rows warp_m * MI * 16 + mi * 16 + gq
  // (+8); base is the word of the pixel's window origin in the line buffer
  // (kLine)
  int iy0[MI][2], ix0[MI][2], base[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + (warp_m * MI + mi) * 16 + hf * 8 + gq;
      if (p < pixels) {
        const int oy = p / g.ow, ox = p - oy * g.ow;
        iy0[mi][hf] = oy * g.stride - g.pad;
        ix0[mi][hf] = ox * g.stride - g.pad;
      } else {
        iy0[mi][hf] = -(1 << 28);  // no tap of a pixel past the image is in it
        ix0[mi][hf] = 0;
      }
      base[mi][hf] =
          p < pixels && g.line ? ((iy0[mi][hf] - iy_lo) * g.wd + ix0[mi][hf]) * g.pitch : 0;
    }
  const int img_row0 = img * g.h;  // kGather: the image's first row in x

  int32_t acc[MI][NI][4], rs[MI][4];
  uint32_t tot[MI][NI][4], rtot[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    rtot[mi][0] = rtot[mi][1] = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rs[mi][r] = 0;
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) acc[mi][nt][r] = 0, tot[mi][nt][r] = 0u;
    }
  }
  auto flush = [&]() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int nt = 0; nt < NI; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          tot[mi][nt][r] += static_cast<uint32_t>(acc[mi][nt][r]);
          acc[mi][nt][r] = 0;
        }
      rtot[mi][0] += static_cast<uint32_t>(rs[mi][0]);
      rtot[mi][1] += static_cast<uint32_t>(rs[mi][2]);
#pragma unroll
      for (int r = 0; r < 4; ++r) rs[mi][r] = 0;
    }
  };

  const unsigned char* lbb = reinterpret_cast<const unsigned char*>(lb);
  for (int s = s_lo; s < s_hi; ++s) {
    const int i = s - s_lo;
    if (!narrow_w && s + NSTAGE - 1 < s_hi) load_w(s + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    uint32_t b[NI][2];
    if (narrow_w) {
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) b[nt][0] = b_next[nt][0], b[nt][1] = b_next[nt][1];
      if (s + 1 < s_hi) fetch_b(s + 1, b_next);
    }
    if (!ALIGNED && tid < KSTEP) {  // decode the step's taps once, a thread a tap
      const int gk = s * KSTEP + tid;
      const int ky = gk / row_taps, rem = gk - ky * row_taps;
      const int kx = rem / g.c, ch = rem - kx * g.c;
      // the window row and column, and the byte offset in a pixel's window
      // (kLine) or the channel (kGather); past K: -1, a tap no pixel has
      taps[tid] = gk < g.k ? make_int2((ky << 16) | kx,
                                       g.line ? (ky * g.wd + kx) * g.pitch * 4 + ch : ch)
                           : make_int2(0, -1);
    }
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const unsigned char* slot = ring + (i % NSTAGE) * TN * RING_PITCH;
    const int k0 = s * KSTEP;

    // A fragments of each mi: a[mi][0..3] = rows gq / gq+8, taps tq*4.. / 16+tq*4..
    uint32_t a[MI][4];
    if (ALIGNED) {  // C % 32 == 0: the step is one (ky, kx) and channels c0..c0+31
      const int ky = k0 / row_taps, rem = k0 - ky * row_taps;
      const int kx = rem / g.c, c0 = rem - kx * g.c;
      const int off = (ky * g.wd + kx) * g.pitch + (c0 >> 2) + tq;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // loads from a valid address, then a select
          const bool in =
              static_cast<unsigned>(iy0[mi][hf] + ky) < static_cast<unsigned>(g.h) &&
              static_cast<unsigned>(ix0[mi][hf] + kx) < static_cast<unsigned>(g.wd);
          const int at = in ? base[mi][hf] + off : 0;
          const uint32_t lo = lb[at], hi = lb[at + 4];
          a[mi][hf] = in ? lo : 0u;
          a[mi][2 + hf] = in ? hi : 0u;
        }
    } else {  // this thread's 8 taps, decoded above
      int2 tap[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tap[e] = taps[e < 4 ? tq * 4 + e : 16 + tq * 4 + (e - 4)];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[mi][r] = 0u;
        // byte(e, hf, in, iy, ix): tap e of pixel row hf, read from a valid
        // address whether or not it is in the image (a select follows)
        auto gather_taps = [&](auto byte) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ky = tap[e].x >> 16, kx = tap[e].x & 0xffff;
            const int shift = (e & 3) * 8, reg = e < 4 ? 0 : 2;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int iy = iy0[mi][hf] + ky, ix = ix0[mi][hf] + kx;
              const bool in = tap[e].y >= 0 &&
                              static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                              static_cast<unsigned>(ix) < static_cast<unsigned>(g.wd);
              const uint32_t v = byte(e, hf, in, iy, ix);
              a[mi][reg + hf] |= (in ? v : 0u) << shift;
            }
          }
        };
        if (g.line) {  // one branch a step: each arrangement its own loads
          gather_taps([&](int e, int hf, bool in, int, int) -> uint32_t {
            return lbb[in ? base[mi][hf] * 4 + tap[e].y : 0];
          });
        } else {  // kGather: the int32 tap from x, its low byte (the int8 wrap)
          gather_taps([&](int e, int, bool in, int iy, int ix) -> uint32_t {
            return static_cast<uint32_t>(__ldg(
                       g.x + (in ? ((img_row0 + iy) * g.wd + ix) * g.c + tap[e].y : 0))) &
                   0xFFu;
          });
        }
      }
    }

    // B fragments: columns warp_n * TN / 2 + nt*8 + gq, taps tq*4.. and 16+tq*4..
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
      const unsigned char* row = slot + (warp_n * (TN / 2) + nt * 8 + gq) * RING_PITCH;
      if (MODE == kXnor) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(row);
        b[nt][0] = bits_to_bipolar4((word >> (tq * 4)) & 0xFu);
        b[nt][1] = bits_to_bipolar4((word >> (16 + tq * 4)) & 0xFu);
      } else if (!narrow_w) {
        b[nt][0] = *reinterpret_cast<const uint32_t*>(row + tq * 4);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(row + 16 + tq * 4);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int nt = 0; nt < NI; ++nt)
        mma_s8(acc[mi][nt], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[nt][0], b[nt][1]);
      if (MODE == kBinary)  // rowsum(a): the product with all-ones weights
        mma_s8(rs[mi], a[mi][0], a[mi][1], a[mi][2], a[mi][3], 0x01010101u, 0x01010101u);
    }
    if ((i + 1) % FLUSH_STEPS == 0) flush();
    __syncthreads();
  }
  flush();
  cp_async_wait<0>();
  const int out_row0 = img * pixels + p0;
  auto value = [&](int mi, int nt, int r) {
    uint32_t v = tot[mi][nt][r];
    if (MODE == kBinary) v = 2u * v - rtot[mi][r >> 1];
    return v;
  };
  auto final_value = [&](int c, uint32_t v) {
    return static_cast<int32_t>(MODE == kXnor ? 2u * v - static_cast<uint32_t>(colsum[c]) : v);
  };
  // fragment element (mi, nt, r) is tile row row_of(mi, r), column col_of(nt, r)
  auto row_of = [&](int mi, int r) { return (warp_m * MI + mi) * 16 + gq + (r >= 2 ? 8 : 0); };
  auto col_of = [&](int nt, int r) { return warp_n * (TN / 2) + nt * 8 + tq * 2 + (r & 1); };
  if (g.splits == 1) {  // no cluster: the fragments go straight to the epilogue
    __syncthreads();    // colsum and the staged epilogue operand are in place
    // up to 4 thresholds (the CNV's 1- and 2-bit activations): this
    // thread's columns' rows into registers first
    const bool thr4 = EPI == kThresholds && g.n_thr <= 4;
    Thresholds<4> th[NI][2];
    if (thr4) {
#pragma unroll
      for (int nt = 0; nt < NI; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) th[nt][j] = staged_thresholds<4>(stage, col_of(nt, j), g.n_thr);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nt = 0; nt < NI; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = row_of(mi, r), col = col_of(nt, r);
          if (p0 + row >= pixels || n0 + col >= g.n) continue;
          const int32_t v = final_value(col, value(mi, nt, r));
          if (thr4)
            static_cast<int32_t*>(g.out)[static_cast<size_t>(out_row0 + row) * g.n + n0 + col] =
                level_of(v, th[nt][r & 1], g.n_thr);
          else
            store_staged<EPI>(v, out_row0 + row, col, n0, g.n, stage, g.thr, g.n_thr, g.out);
        }
    return;
  }
  __syncthreads();  // the ring and line buffer are free: the partial tile reuses them

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < NI; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[row_of(mi, r) * TN + col_of(nt, r)] = value(mi, nt, r);
  cluster_reduce_store(part, TM, TN, [&](int r, int c, uint32_t v) {
    if (p0 + r < pixels && n0 + c < g.n)
      store_staged<EPI>(final_value(c, v), out_row0 + r, c, n0, g.n, stage, g.thr, g.n_thr,
                        g.out);
  });
}

template <typename T, int MODE, bool ALIGNED>
cudaError_t launch_conv(const ConvArgs& args, dim3 grid, int smem, int epilogue,
                        cudaStream_t stream) {
  return with_epilogue(epilogue, [&](auto e) {
    return launch_cluster(conv_mvu_kernel<T, MODE, decltype(e)::value, ALIGNED>, grid,
                          T::THREADS, smem, args.splits, stream, args);
  });
}

// one step a (ky, kx) needs the line buffer and C % 32 == 0
template <typename T, int MODE>
cudaError_t launch_mode(const ConvArgs& args, dim3 grid, int smem, int epilogue,
                        cudaStream_t stream) {
  return args.line && args.c % KSTEP == 0
             ? launch_conv<T, MODE, true>(args, grid, smem, epilogue, stream)
             : launch_conv<T, MODE, false>(args, grid, smem, epilogue, stream);
}

}  // namespace

// x (B, H, W, C) int32; w (N, w_cols): int8 rows (w_cols == K) or, for
// xnor, 32-bit words (w_cols == ceil(K / 32)); out (B * OH * OW, N).  The
// plan (the arrangement, kLine or kGather; the tile's index in CONV_TILES
// with the tile_m pixels x tile_n channels it stands for; splits K
// slices; smem bytes) is swu_mvu.py::conv_launch_plan's; a plan this
// kernel cannot run -- an index outside the set, a tile that does not
// match its index, too little shared memory -- returns
// cudaErrorInvalidValue, and no other tile is tried.  The wrapper checks
// shapes and that every index fits.
extern "C" int repro_conv_mvu(const void* x, const void* w, const void* thr,
                              const void* scale, void* out, int b, int h, int wd, int c,
                              int n, int kd, int stride, int pad, int w_cols, int n_thr,
                              int mode, int epilogue, int arrangement, int tile, int tile_m,
                              int tile_n, int splits, int smem, void* stream) {
  const int oh = (h + 2 * pad - kd) / stride + 1, ow = (wd + 2 * pad - kd) / stride + 1;
  const int k = kd * kd * c;
  const int want_cols = mode == kXnor ? (k + 31) / 32 : k;
  const int steps = (k + KSTEP - 1) / KSTEP;
  if (w_cols != want_cols || oh <= 0 || ow <= 0 ||
      (arrangement != kLine && arrangement != kGather) || splits < 1 || splits > MAX_SPLITS ||
      splits > steps || smem > MAX_SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_conv_tile(tile, [&](auto t) -> cudaError_t {
    using T = decltype(t);
    if (tile_m != T::TM || tile_n != T::TN ||
        smem < smem_needed<T>(arrangement, h, wd, c, kd, stride, oh, ow))
      return cudaErrorInvalidValue;
    const int tiles_img = (oh * ow + T::TM - 1) / T::TM;
    const ConvArgs args{static_cast<const int32_t*>(x),
                        w,
                        static_cast<const int32_t*>(thr),
                        static_cast<const float*>(scale),
                        out,
                        h, wd, c, n, kd, stride, pad, oh, ow, k, w_cols, n_thr,
                        lb_pitch(c),
                        tiles_img,
                        steps,
                        splits,
                        arrangement == kLine,
                        c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
                        k % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0};
    const dim3 grid(b * tiles_img, (n + T::TN - 1) / T::TN, splits);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (mode) {
      case kStandard:
        return launch_mode<T, kStandard>(args, grid, smem, epilogue, s);
      case kBinary:
        return launch_mode<T, kBinary>(args, grid, smem, epilogue, s);
      case kXnor:
        return launch_mode<T, kXnor>(args, grid, smem, epilogue, s);
      default:
        return cudaErrorInvalidValue;
    }
  }));
}
