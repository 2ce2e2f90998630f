// Plain C interface of the MVU kernel library, loaded with ctypes by
// repro_torch/kernels/mvu_int.py (pointers and the stream as void*).

#include <cstdint>

#include <cuda_runtime.h>

cudaError_t mvu_int_launch(const int32_t* a, const int8_t* w, const int32_t* thr,
                           const float* scale, void* out, int m, int n, int k,
                           int n_thr, int epilogue, cudaStream_t stream);

extern "C" {

int repro_mvu_int(const void* a, const void* w, const void* thr, const void* scale,
                  void* out, int m, int n, int k, int n_thr, int epilogue,
                  void* stream) {
  return static_cast<int>(mvu_int_launch(
      static_cast<const int32_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(thr), static_cast<const float*>(scale), out, m, n,
      k, n_thr, epilogue, static_cast<cudaStream_t>(stream)));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
