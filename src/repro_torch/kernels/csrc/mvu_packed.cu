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
// blocks share the work.  Both run dense_mvu.cuh's core, in its two
// arrangements (a warp a column at M <= 8; double-buffered tiles of
// dense_mvu.cuh's set with K split across a cluster above), on the plan
// of kernels/dense_mvu.py::dense_launch_plan; each only stages its W its
// own way:
//
// * mvu_binary_packed, coding BinaryBitplanes: one bitplane word a column
//   staged by cp.async a 32-synapse step (128 bytes a step against 1,536
//   for int8 rows), the binary finish 2 * acc - rowsum; a gemv lane takes
//   four bits of a word with shifts.  A lane past K reads A as 0, so pad
//   bits of the last word never count, whatever they hold, and any
//   w_cols >= ceil(K/32) is taken.  A NID layer at M = 128 takes 5.0-6.4
//   us (scripts/torch_kernel_ab.py, H100 80GB HBM3 at 700 W).
// * mvu_int2_packed, coding Int2Lanes: a step is eight bytes of a column,
//   staged by one 8-byte cp.async where every row starts 8-byte aligned,
//   else a byte a thread through a register, stored after the step's
//   arithmetic so that the load overlaps it (NID fc0's rows are 150 bytes:
//   K = 600); the lanes are sign-extended where the inner loop reads them,
//   and a gemv lane takes one byte, its four synapses.  The finish is acc.
//   Bytes past the row read 0, and lanes past K (pad lanes of the last
//   byte, and any bytes of a row beyond ceil(K/4)) meet A = 0: they never
//   count.  The storage is pack_int2's, unpadded.

#include "dense_mvu.cuh"

// w (N, Wd) 32-bit bitplanes, w_cols = Wd >= ceil(K/32); the plan is
// kernels/dense_mvu.py::dense_launch_plan's (coding "bitplanes"), and one
// this kernel cannot run returns cudaErrorInvalidValue.
extern "C" int repro_mvu_binary_packed(const void* a, const void* w, const void* thr,
                                       const void* scale, void* out, int m, int n, int k,
                                       int w_cols, int n_thr, int epilogue, int arrangement,
                                       int tile, int tile_m, int tile_n, int kstep, int splits,
                                       int smem, void* stream) {
  return repro::dense::launch<repro::dense::BinaryBitplanes>(
      a, w, thr, scale, out, m, n, k, w_cols, n_thr, epilogue, arrangement, tile, tile_m, tile_n,
      kstep, splits, smem, stream);
}

// w (N, Bd) uint8 2-bit lanes, w_cols = Bd >= ceil(K/4); the plan is
// dense_launch_plan's for the coding "int2".
extern "C" int repro_mvu_int2_packed(const void* a, const void* w, const void* thr,
                                     const void* scale, void* out, int m, int n, int k,
                                     int w_cols, int n_thr, int epilogue, int arrangement,
                                     int tile, int tile_m, int tile_n, int kstep, int splits,
                                     int smem, void* stream) {
  return repro::dense::launch<repro::dense::Int2Lanes>(a, w, thr, scale, out, m, n, k, w_cols,
                                                       n_thr, epilogue, arrangement, tile,
                                                       tile_m, tile_n, kstep, splits, smem, stream);
}
