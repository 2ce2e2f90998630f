// Binary-weight MVU (paper Fig. 4b) for Hopper (sm_90a), CUDA cores.
//
//   out[M, N] = epilogue(A[M, K] . (2 * W01[N, K] - 1)^T)
//
// Replaces src/repro/kernels/mvu_binary.py::mvu_binary_pallas (the
// pallas_call at mvu_binary.py:108).  The weights are {0,1}-coded +/-1
// rows stored as int8; the activations are int32 taken as they come (the
// JAX kernel does not narrow them, mvu_binary.py:81), so an int8 tensor
// core product would change the function: this kernel stays on the CUDA
// cores, with uint32 sums that wrap mod 2^32 like XLA's int32 dot.
//
// It is dense_mvu.cuh's core with the BinaryRows coding: int32 A read as
// it is, int8 W rows, acc = 2 * (A . W^T) - rowsum(A) (gemv: A . (2w - 1)).
// Two arrangements behind the one entry point, chosen by the Python plan
// (kernels/dense_mvu.py::dense_launch_plan): a warp a column at M <= 8
// (the CNV's dense layers at one image), cp.async double-buffered tiles
// (the layer's, of dense_mvu.cuh's set) with K split across a thread-block
// cluster above (the NID path).
//
// What bounds it on the H100 at these shapes: latency.  A launch moves
// < 1 MB and does < 0.1 G MAC; the arrangements cut the serial K loop of
// a block to a few steps on many blocks: 3.3-4.0 us a CNV dense layer at
// M = 1 and 4.7-5.9 us a NID layer at M = 128 (scripts/torch_kernel_ab.py,
// H100 80GB HBM3 at 700 W), near a launch's own latency.

#include "dense_mvu.cuh"

// w (N, K) int8 in {0,1}: w_cols == k.  A plan this kernel cannot run
// returns cudaErrorInvalidValue.
extern "C" int repro_mvu_binary(const void* a, const void* w, const void* thr,
                                const void* scale, void* out, int m, int n, int k,
                                int w_cols, int n_thr, int epilogue, int arrangement,
                                int tile, int tile_m, int tile_n, int kstep, int splits,
                                int smem, void* stream) {
  return repro::dense::launch<repro::dense::BinaryRows>(a, w, thr, scale, out, m, n, k, w_cols,
                                                        n_thr, epilogue, arrangement, tile,
                                                        tile_m, tile_n, kstep, splits, smem, stream);
}
