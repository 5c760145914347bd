// Helpers shared by the port's CUDA kernels: element conversion, the mask
// constant of the reference, warp reductions, and the error-string export
// that the Python wrappers call when a launch returns a nonzero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // masked score, as in repro/kernels/ref.py

// dtype codes passed from Python (kernels/ops.py)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float x, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, width));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, width);
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once per
// process and size (the attribute is a property of the function).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
