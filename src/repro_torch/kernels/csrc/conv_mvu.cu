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
// * Line buffer.  A block owns 32 consecutive output pixels of one image
//   and 32 output channels.  It loads once, into shared memory, the input
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
// * int8 tensor cores.  mma.sync m16n8k32 s8.s8 -> s32; 4 warps, each a
//   16 x 16 tile of the block's 32 x 32.  The three datapaths are one
//   int8 product each:
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
// * Weights through a ring of NSTAGE cp.async stages (32 taps x 32
//   channels each), so the next seven steps' weights load while the
//   tensor cores work on this one; they are issued before the line buffer
//   fills, and every fill keeps eight loads in flight a thread.  Where
//   16-byte copies cannot cut the rows (K % 16 != 0: conv0, K = 27), each
//   thread reads its B fragments from device memory, a step ahead.  xnor
//   words are unpacked to +/-1 as the fragments are read.  The epilogue
//   operand of the block's 32 columns is staged by cp.async too, and up to
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
// the fragment reads from shared memory are the rest of the 16-49 us.
// The gather arrangement pays a dependent device-memory load per tap
// instead of the fill; no shape of the port's models takes it.

#include <algorithm>

#include "cluster_reduce.cuh"

namespace {

using namespace repro;

enum Mode : int { kStandard = 0, kBinary = 1, kXnor = 2 };

enum Arrangement : int { kLine = 0, kGather = 1 };

constexpr int THREADS_CONV = 128;  // 4 warps, 2 (pixels) x 2 (channels)
constexpr int TILE_M = 32;         // output pixels a block
constexpr int TILE_N = 32;         // output channels a block
constexpr int KSTEP = 32;          // taps a step: one mma k
constexpr int NSTAGE = 8;          // weight ring depth: 7 steps in flight
constexpr int RING_PITCH = 48;     // bytes a weight row a stage (32 + 16: no bank conflicts)
constexpr int RING_BYTES = NSTAGE * TILE_N * RING_PITCH;
constexpr int HEAD_BYTES = (TILE_N + 2 * KSTEP) * 4;  // xnor column sums, decoded taps
constexpr int FLUSH_STEPS = 2048;  // 65,536 taps: an s32 fragment cannot overflow

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

// Dynamic shared memory a block needs: the xnor column sums and a step's
// tap offsets, the staged epilogue operand, then the weight ring and (for
// kLine) the line buffer -- TILE_M pixels span at most `span` output
// rows, so their windows at most (span - 1) * stride + Kd input rows --
// or the partial tile of the cluster sum, which reuses them.
long smem_needed(int arrangement, int h, int wd, int c, int kd, int stride, int oh, int ow) {
  long lb = 0;
  if (arrangement == kLine) {
    const int span = std::min(oh, (ow + TILE_M - 2) / ow + 1);
    const long rows = std::min(static_cast<long>(h), (span - 1L) * stride + kd);
    lb = rows * wd * lb_pitch(c) * 4;
  }
  const long body = std::max(static_cast<long>(RING_BYTES) + lb,
                             static_cast<long>(TILE_M) * TILE_N * 4);
  return HEAD_BYTES + EPI_STAGE_BYTES + body;
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

template <int MODE, int EPI, bool ALIGNED>
__global__ void __launch_bounds__(THREADS_CONV) conv_mvu_kernel(ConvArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* colsum = reinterpret_cast<int32_t*>(smem);
  int2* taps = reinterpret_cast<int2*>(colsum + TILE_N);  // ALIGNED = false: a step's taps
  unsigned char* stage = smem + HEAD_BYTES;  // the epilogue operand
  unsigned char* ring = stage + EPI_STAGE_BYTES;
  uint32_t* lb = reinterpret_cast<uint32_t*>(ring + RING_BYTES);
  uint32_t* part = reinterpret_cast<uint32_t*>(ring);  // after the K loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment group and thread in group
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int pixels = g.oh * g.ow;
  const int img = static_cast<int>(blockIdx.x) / g.tiles_img;
  const int p0 = (static_cast<int>(blockIdx.x) - img * g.tiles_img) * TILE_M;
  const int n0 = static_cast<int>(blockIdx.y) * TILE_N;
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
    unsigned char* dst = ring + slot * TILE_N * RING_PITCH;
    if (MODE == kXnor) {
      if (tid < TILE_N) {
        const int gn = n0 + tid;
        const bool ok = gn < g.n && s < g.w_cols;
        cp_async<4>(dst + tid * RING_PITCH,
                    ok ? w32 + static_cast<size_t>(gn) * g.w_cols + s : w32, ok ? 4 : 0);
      }
    } else if (tid < 2 * TILE_N) {
      const int r = tid >> 1, gn = n0 + r, gk = s * KSTEP + (tid & 1) * 16;
      const bool ok = gn < g.n && gk < g.k;
      cp_async<16>(dst + r * RING_PITCH + (tid & 1) * 16,
                   ok ? w8 + static_cast<size_t>(gn) * g.k + gk : w8, ok ? 16 : 0);
    }
  };
  auto fetch_b = [&](int s, uint32_t (&b)[2][2]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int gn = n0 + warp_n * 16 + nt * 8 + gq;
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
  stage_epilogue<EPI>(stage, n0, TILE_N, g.n, g.thr, g.n_thr, g.scale);
  uint32_t b_next[2][2] = {{0u, 0u}, {0u, 0u}};
  if (narrow_w && s_lo < s_hi) fetch_b(s_lo, b_next);
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (!narrow_w && s_lo + i < s_hi) load_w(s_lo + i, i);
    cp_async_commit();
  }

  if (MODE == kXnor) {  // colsum(w) = 2 * popcount - K, four threads a column
    const int col = tid >> 2, q = tid & 3, gn = n0 + col;
    int pop = 0;
    if (gn < g.n) {
      for (int j0 = q; j0 < g.w_cols; j0 += 4 * 8) {
        uint32_t word[8];  // eight loads in flight
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + 4 * u;
          word[u] = j < g.w_cols ? __ldg(w32 + static_cast<size_t>(gn) * g.w_cols + j) : 0u;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int rem = g.k - (j0 + 4 * u) * 32;
          pop += __popc(rem < 32 ? word[u] & ((1u << max(rem, 0)) - 1u) : word[u]);
        }
      }
    }
    pop += __shfl_xor_sync(0xffffffffu, pop, 1);
    pop += __shfl_xor_sync(0xffffffffu, pop, 2);
    if (q == 0) colsum[col] = 2 * pop - g.k;
  }

  // the line buffer: input rows iy_lo..iy_hi of image img, as int8
  const int row_taps = g.kd * g.c;
  const int oy_first = p0 / g.ow;
  const int oy_last = (min(p0 + TILE_M, pixels) - 1) / g.ow;
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
        for (int i0 = tid; i0 < n4; i0 += U * THREADS_CONV) {
          int4 v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS_CONV;
            if (i < n4) v[u] = __ldg(src4 + i);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS_CONV, pix = i / c4;
            if (i < n4) lb[pix * g.pitch + (i - pix * c4)] = narrow4(v[u]);
          }
        }
      } else {
        unsigned char* lbb = reinterpret_cast<unsigned char*>(lb);
        for (int i0 = tid; i0 < count; i0 += U * THREADS_CONV) {
          int32_t v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS_CONV;
            if (i < count) v[u] = __ldg(src + i);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = i0 + u * THREADS_CONV, pix = i / g.c;
            if (i < count)
              lbb[pix * g.pitch * 4 + (i - pix * g.c)] = static_cast<unsigned char>(v[u]);
          }
        }
      }
    }
  }

  // this thread's pixel rows: tile rows warp_m*16 + gq (+8); base is the
  // word of the pixel's window origin in the line buffer (kLine)
  int iy0[2], ix0[2], base[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = p0 + warp_m * 16 + hf * 8 + gq;
    if (p < pixels) {
      const int oy = p / g.ow, ox = p - oy * g.ow;
      iy0[hf] = oy * g.stride - g.pad;
      ix0[hf] = ox * g.stride - g.pad;
    } else {
      iy0[hf] = -(1 << 28);  // no tap of a pixel past the image is in it
      ix0[hf] = 0;
    }
    base[hf] = p < pixels && g.line ? ((iy0[hf] - iy_lo) * g.wd + ix0[hf]) * g.pitch : 0;
  }
  const int img_row0 = img * g.h;  // kGather: the image's first row in x

  int32_t acc[2][4], rs[4];
  uint32_t tot[2][4], rtot[2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rs[r] = 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) acc[nt][r] = 0, tot[nt][r] = 0u;
  }
  rtot[0] = rtot[1] = 0u;
  auto flush = [&]() {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tot[nt][r] += static_cast<uint32_t>(acc[nt][r]);
        acc[nt][r] = 0;
      }
    rtot[0] += static_cast<uint32_t>(rs[0]);
    rtot[1] += static_cast<uint32_t>(rs[2]);
#pragma unroll
    for (int r = 0; r < 4; ++r) rs[r] = 0;
  };

  const unsigned char* lbb = reinterpret_cast<const unsigned char*>(lb);
  for (int s = s_lo; s < s_hi; ++s) {
    const int i = s - s_lo;
    if (!narrow_w && s + NSTAGE - 1 < s_hi) load_w(s + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    uint32_t b[2][2];
    if (narrow_w) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) b[nt][0] = b_next[nt][0], b[nt][1] = b_next[nt][1];
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
    const unsigned char* slot = ring + (i % NSTAGE) * TILE_N * RING_PITCH;
    const int k0 = s * KSTEP;

    // A fragments: a[0..3] = rows gq / gq+8, taps tq*4.. / 16+tq*4..
    uint32_t a[4];
    if (ALIGNED) {  // C % 32 == 0: the step is one (ky, kx) and channels c0..c0+31
      const int ky = k0 / row_taps, rem = k0 - ky * row_taps;
      const int kx = rem / g.c, c0 = rem - kx * g.c;
      const int off = (ky * g.wd + kx) * g.pitch + (c0 >> 2) + tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // loads from a valid address, then a select
        const bool in = static_cast<unsigned>(iy0[hf] + ky) < static_cast<unsigned>(g.h) &&
                        static_cast<unsigned>(ix0[hf] + kx) < static_cast<unsigned>(g.wd);
        const int at = in ? base[hf] + off : 0;
        const uint32_t lo = lb[at], hi = lb[at + 4];
        a[hf] = in ? lo : 0u;
        a[2 + hf] = in ? hi : 0u;
      }
    } else {  // this thread's 8 taps, decoded above
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = 0u;
      int2 tap[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tap[e] = taps[e < 4 ? tq * 4 + e : 16 + tq * 4 + (e - 4)];
      // byte(e, hf, in, iy, ix): tap e of pixel row hf, read from a valid
      // address whether or not it is in the image (a select follows)
      auto gather_taps = [&](auto byte) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ky = tap[e].x >> 16, kx = tap[e].x & 0xffff;
          const int shift = (e & 3) * 8, reg = e < 4 ? 0 : 2;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int iy = iy0[hf] + ky, ix = ix0[hf] + kx;
            const bool in = tap[e].y >= 0 &&
                            static_cast<unsigned>(iy) < static_cast<unsigned>(g.h) &&
                            static_cast<unsigned>(ix) < static_cast<unsigned>(g.wd);
            const uint32_t v = byte(e, hf, in, iy, ix);
            a[reg + hf] |= (in ? v : 0u) << shift;
          }
        }
      };
      if (g.line) {  // one branch a step: each arrangement its own loads
        gather_taps([&](int e, int hf, bool in, int, int) -> uint32_t {
          return lbb[in ? base[hf] * 4 + tap[e].y : 0];
        });
      } else {  // kGather: the int32 tap from x, its low byte (the int8 wrap)
        gather_taps([&](int e, int, bool in, int iy, int ix) -> uint32_t {
          return static_cast<uint32_t>(__ldg(
                     g.x + (in ? ((img_row0 + iy) * g.wd + ix) * g.c + tap[e].y : 0))) &
                 0xFFu;
        });
      }
    }

    // B fragments: columns warp_n*16 + nt*8 + gq, taps tq*4.. and 16+tq*4..
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const unsigned char* row = slot + (warp_n * 16 + nt * 8 + gq) * RING_PITCH;
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
    for (int nt = 0; nt < 2; ++nt) mma_s8(acc[nt], a[0], a[1], a[2], a[3], b[nt][0], b[nt][1]);
    if (MODE == kBinary)  // rowsum(a): the product with all-ones weights
      mma_s8(rs, a[0], a[1], a[2], a[3], 0x01010101u, 0x01010101u);
    if ((i + 1) % FLUSH_STEPS == 0) flush();
    __syncthreads();
  }
  flush();
  cp_async_wait<0>();
  const int out_row0 = img * pixels + p0;
  auto value = [&](int nt, int r) {
    uint32_t v = tot[nt][r];
    if (MODE == kBinary) v = 2u * v - rtot[r >> 1];
    return v;
  };
  auto final_value = [&](int c, uint32_t v) {
    return static_cast<int32_t>(MODE == kXnor ? 2u * v - static_cast<uint32_t>(colsum[c]) : v);
  };
  if (g.splits == 1) {  // no cluster: the fragments go straight to the epilogue
    __syncthreads();    // colsum and the staged epilogue operand are in place
    // up to 4 thresholds (the CNV's 1- and 2-bit activations): this
    // thread's four columns' rows into registers first
    const bool thr4 = EPI == kThresholds && g.n_thr <= 4;
    Thresholds<4> th[2][2];
    if (thr4) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          th[nt][j] = staged_thresholds<4>(stage, warp_n * 16 + nt * 8 + tq * 2 + j, g.n_thr);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp_m * 16 + gq + (r >= 2 ? 8 : 0);
        const int col = warp_n * 16 + nt * 8 + tq * 2 + (r & 1);
        if (p0 + row >= pixels || n0 + col >= g.n) continue;
        const int32_t v = final_value(col, value(nt, r));
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
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = warp_m * 16 + gq + (r >= 2 ? 8 : 0);
      const int col = warp_n * 16 + nt * 8 + tq * 2 + (r & 1);
      part[row * TILE_N + col] = value(nt, r);
    }
  cluster_reduce_store(part, TILE_M, TILE_N, [&](int r, int c, uint32_t v) {
    if (p0 + r < pixels && n0 + c < g.n)
      store_staged<EPI>(final_value(c, v), out_row0 + r, c, n0, g.n, stage, g.thr, g.n_thr,
                        g.out);
  });
}

template <int MODE, bool ALIGNED>
cudaError_t launch_conv(const ConvArgs& args, dim3 grid, int smem, int epilogue,
                        cudaStream_t stream) {
  return with_epilogue(epilogue, [&](auto e) {
    return launch_cluster(conv_mvu_kernel<MODE, decltype(e)::value, ALIGNED>, grid,
                          THREADS_CONV, smem, args.splits, stream, args);
  });
}

// one step a (ky, kx) needs the line buffer and C % 32 == 0
template <int MODE>
cudaError_t launch_mode(const ConvArgs& args, dim3 grid, int smem, int epilogue,
                        cudaStream_t stream) {
  return args.line && args.c % KSTEP == 0
             ? launch_conv<MODE, true>(args, grid, smem, epilogue, stream)
             : launch_conv<MODE, false>(args, grid, smem, epilogue, stream);
}

}  // namespace

// x (B, H, W, C) int32; w (N, w_cols): int8 rows (w_cols == K) or, for
// xnor, 32-bit words (w_cols == ceil(K / 32)); out (B * OH * OW, N).  The
// plan (the arrangement, kLine or kGather; splits K slices; smem bytes)
// is swu_mvu.py::conv_launch_plan's; a plan this kernel cannot run
// returns cudaErrorInvalidValue.  The wrapper checks shapes and that
// every index fits.
extern "C" int repro_conv_mvu(const void* x, const void* w, const void* thr,
                              const void* scale, void* out, int b, int h, int wd, int c,
                              int n, int kd, int stride, int pad, int w_cols, int n_thr,
                              int mode, int epilogue, int arrangement, int splits, int smem,
                              void* stream) {
  const int oh = (h + 2 * pad - kd) / stride + 1, ow = (wd + 2 * pad - kd) / stride + 1;
  const int k = kd * kd * c;
  const int want_cols = mode == kXnor ? (k + 31) / 32 : k;
  const int steps = (k + KSTEP - 1) / KSTEP;
  if (w_cols != want_cols || oh <= 0 || ow <= 0 ||
      (arrangement != kLine && arrangement != kGather) || splits < 1 || splits > MAX_SPLITS ||
      splits > steps || smem < smem_needed(arrangement, h, wd, c, kd, stride, oh, ow) ||
      smem > MAX_SMEM_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_img = (oh * ow + TILE_M - 1) / TILE_M;
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
  const dim3 grid(b * tiles_img, (n + TILE_N - 1) / TILE_N, splits);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStandard:
      return static_cast<int>(launch_mode<kStandard>(args, grid, smem, epilogue, s));
    case kBinary:
      return static_cast<int>(launch_mode<kBinary>(args, grid, smem, epilogue, s));
    case kXnor:
      return static_cast<int>(launch_mode<kXnor>(args, grid, smem, epilogue, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
