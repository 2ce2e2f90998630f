// The MVTU epilogue after the int32 accumulator, which every MVU kernel
// runs: its three forms, by the code the wrappers pass.
//
//   thresholds (N, T) int32   out = sum_t (acc >= T[n, t])   (int32 levels)
//   scale      (N,) float32   out = float(acc) * s[n]        (float32)
//   neither                   out = acc                      (int32)
//
// This is the JAX package's shared epilogue (src/repro/kernels/_common.py::
// epilogue_value); the plain PyTorch twin is repro_torch/kernels/_common.py.
// Its arithmetic on one output is cluster_reduce.cuh's store_value.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace repro {

enum Epilogue : int { kRaw = 0, kThresholds = 1, kScale = 2 };

}  // namespace repro
