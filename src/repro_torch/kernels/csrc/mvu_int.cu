// Standard-SIMD MVU (paper Fig. 4c) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . W[N, K]^T),   int32 accumulator
//
// Replaces src/repro/kernels/mvu_int.py::mvu_int_pallas (def at
// mvu_int.py:59, the pallas_call at :110).  The TPU kernel walks K as a
// sequential grid axis and carries the sum in VMEM scratch; blocks here
// run in parallel and in no order, so K is a loop inside the block, and
// where the output has too few blocks it is cut into slices that a
// thread-block cluster sums.
//
// The activations are int32 and not narrowed (mvu_int_pallas does not
// narrow them), so an int8 tensor-core product would change the function:
// the products are full-width uint32 multiply-adds on the CUDA cores, and
// the sum wraps mod 2^32 like XLA's int32 dot.
//
// What bounds it on the H100 at the main path's shapes (NID: M = 128 a
// microbatch, (N, K) in {(64, 600), (64, 64), (1, 64)}; CNV standard: its
// dense layers at M = 1): latency.  A launch moves at most 0.4 MB and does
// at most 10 MOP, a byte bound of ~0.1 us, so what counts is how long one
// block's serial K loop runs and how few blocks share the work.  This is
// dense_mvu.cuh's core with the IntRows coding (int32 A as it is, int8 W
// rows, acc as it is), in its two arrangements: a warp a column at
// M <= 8, whose lanes stride K together; cp.async double-buffered tiles
// (the layer's, of dense_mvu.cuh's set) above, with K split across a
// cluster of up to 8 blocks when the tiles are too few to fill the card
// (NID fc0 at M = 128 in 32 x 32 tiles: 8 tiles x 8 slices).  That gives 3.2-3.5 us a CNV dense layer at M = 1 and 4.9-5.9
// us a NID layer at M = 128 (scripts/torch_kernel_ab.py, H100 80GB HBM3
// at 700 W), near a launch's own latency.

#include "dense_mvu.cuh"

// w (N, K) int8: w_cols == k.  The plan is kernels/dense_mvu.py::
// dense_launch_plan's; a plan this kernel cannot run returns
// cudaErrorInvalidValue.
extern "C" int repro_mvu_int(const void* a, const void* w, const void* thr,
                             const void* scale, void* out, int m, int n, int k,
                             int w_cols, int n_thr, int epilogue, int arrangement,
                             int tile, int tile_m, int tile_n, int kstep, int splits,
                             int smem, void* stream) {
  return repro::dense::launch<repro::dense::IntRows>(a, w, thr, scale, out, m, n, k, w_cols,
                                                     n_thr, epilogue, arrangement, tile,
                                                     tile_m, tile_n, kstep, splits, smem, stream);
}
