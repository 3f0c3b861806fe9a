// Shared helpers of the port's CUDA sources (plain C interface, no PyTorch
// headers).  Each source is built into its own shared library by
// ops/kernels.py; each library exports pdt_error_string for the wrapper's
// error messages.
#pragma once

#include <cuda_runtime.h>

#define PDT_FULL_MASK 0xffffffffu

extern "C" const char* pdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// butterfly sum: every lane ends with the warp total
__device__ __forceinline__ float pdt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(PDT_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int pdt_warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(PDT_FULL_MASK, v, o);
  return v;
}
