// Linked into every kernel library: the one helper the ctypes loader
// (repro_torch/kernels/_cuda.py) needs besides the kernel's own launch
// function, which each .cu file exports itself.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
