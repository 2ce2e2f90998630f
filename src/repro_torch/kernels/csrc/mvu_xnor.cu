// XNOR-popcount MVU (paper Fig. 4a) for Hopper (sm_90a), CUDA cores.
//
//   out[m, n] = epilogue(2 * sum_w popcount(~(a[m, w] ^ w[n, w]))
//                        - pad_correction(K, Wd * 32))     (a, w: 32-bit words)
//
// the bipolar dot over the true K synapses.  Replaces src/repro/kernels/
// mvu_xnor.py::mvu_xnor_pallas (def at mvu_xnor.py:74, the pallas_call at
// :121); the packed-xnor path of the JAX package (mvu_packed.py:388-393)
// runs the same kernel.  Two entry points, one kernel function:
//
//   repro_mvu_xnor        a (M, Wd) packed words, as mvu_xnor_pallas takes
//                         them (repro_torch.kernels.packing.pack_bits:
//                         LSB-first, zero pad bits past K); coding XnorWords
//   repro_mvu_xnor_bits   a (M, K) int32 activations as they stream between
//                         the engine's nodes: the kernel forms each A word
//                         from the LSBs of 32 of them where it reads them,
//                         pad bits 0, so it computes
//                         repro_mvu_xnor(pack_bits(a), w, K) and the host
//                         launches no pack; coding XnorBits
//
// w is (N, Wd) words, Wd = ceil(K/32) for the bit entry.  Both run
// dense_mvu.cuh's core on the plan of kernels/dense_mvu.py::
// dense_launch_plan: a warp a column at M <= 8, double-buffered tiles of
// dense_mvu.cuh's set (32-unit K steps) with K split across a cluster
// above.  The sum counts the
// disagreeing bits, acc = sum popc(a ^ w), and is finished once, after the
// K slices are summed, as K - 2 * acc, which equals the identity above:
// popc(~x) = 32 - popc(x) on each of Wd words.  So a word (or bit) that is
// zero in both operands adds nothing: the words past Wd that the tiled
// arrangement stages as zeros, whatever JAX's padded width (mvu_xnor.py
// pads to whole blocks and corrects for it).  For the packed entry the K
// unit is a word (32 words a step, both operands staged like the int32 A
// tile); for the bit entry a synapse (a step is one word of W a column,
// and two __ballot_sync of the staged activations' LSBs give a warp its
// two rows' words).
//
// What bounds it on the H100 at the main path's shapes (NID: M = 128 a
// microbatch, K in {600, 64}, N in {64, 1}; CNV xnor: its dense layers at
// M = 1, K in {256, 512}): latency.  A packed launch reads at most ~20 KB;
// the bit entry reads the activations as int32, 32x the bytes of packed
// words (0.3 MB at NID fc0, M = 128), which still takes < 0.1 us at the
// card's memory rate.  What counts is one block's chain of launch, K
// steps, cluster sum and epilogue, as for the other dense kernels; the
// bit entry's gain is on the host, which no longer runs pack_bits' ~10
// tensor ops before each xnor stage.
//
// The sum is an exact integer: acc <= Wd * 32 < 2^30 (the wrapper holds
// Wd < 2^25), so K - 2 * acc fits int32.

#include "dense_mvu.cuh"

// a (M, Wd) and w (N, Wd) 32-bit words: k is the true synapse count K,
// w_cols is Wd (0 <= K <= Wd * 32, checked by the wrapper); the plan is
// dense_launch_plan's for Wd units of the coding "words".  A plan this
// kernel cannot run returns cudaErrorInvalidValue.
extern "C" int repro_mvu_xnor(const void* a, const void* w, const void* thr,
                              const void* scale, void* out, int m, int n, int k,
                              int w_cols, int n_thr, int epilogue, int arrangement,
                              int tile, int tile_m, int tile_n, int kstep, int splits,
                              int smem, void* stream) {
  return repro::dense::launch<repro::dense::XnorWords>(a, w, thr, scale, out, m, n, k, w_cols,
                                                       n_thr, epilogue, arrangement, tile,
                                                       tile_m, tile_n, kstep, splits, smem, stream);
}

// a (M, K) int32 activations (their LSBs are the bits), w (N, Wd) words,
// w_cols = Wd = ceil(K/32); the plan is dense_launch_plan's for the
// coding "bits".
extern "C" int repro_mvu_xnor_bits(const void* a, const void* w, const void* thr,
                                   const void* scale, void* out, int m, int n, int k,
                                   int w_cols, int n_thr, int epilogue, int arrangement,
                                   int tile, int tile_m, int tile_n, int kstep, int splits,
                                   int smem, void* stream) {
  return repro::dense::launch<repro::dense::XnorBits>(a, w, thr, scale, out, m, n, k, w_cols,
                                                      n_thr, epilogue, arrangement, tile,
                                                      tile_m, tile_n, kstep, splits, smem, stream);
}
