// Error strings for the launchers' return codes, read by the Python wrappers.
#include "common.cuh"

VQA_EXPORT const char* vqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
