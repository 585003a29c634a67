// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is reached through an extern "C" launcher that takes device
// pointers, sizes and the caller's stream, launches on that stream without
// synchronising, allocates nothing (the Python wrapper allocates outputs and
// scratch with torch.empty) and returns cudaGetLastError() so the wrapper
// can raise on a refused launch. Built by vqa_tpu_torch/ops/_build.py with
// nvcc for sm_90a into one shared library loaded with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VQA_EXPORT extern "C" __attribute__((visibility("default")))

namespace vqa {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Element conversions of the kernels' two storage types: f32, and bf16
// (computed in f32, rounded once to nearest even on the way out, as
// torch's and XLA's casts round).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Opts a kernel into more than 48 KB of dynamic shared memory; a no-op
// below that. Returns the CUDA error so the launcher can pass it on.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vqa

VQA_EXPORT const char* vqa_cuda_error_string(int code);
