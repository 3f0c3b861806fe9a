// Shared helpers of the port's CUDA sources (plain C interface, no PyTorch
// headers).  Each source is built into its own shared library by
// ops/kernels.py; each library exports pdt_error_string for the wrapper's
// error messages.  The GEMMs share the split-K slab reduce.
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

namespace {

// C[i] = sum over z of ws[z][i], in z order: the split-K GEMMs' fixed-order
// slab reduce (deterministic, no atomics)
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     int splits, long long mn,
                                     float* __restrict__ C) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  C[i] = s;
}

inline cudaError_t pdt_splitk_reduce(const float* ws, int splits,
                                     long long mn, float* C,
                                     cudaStream_t s) {
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                         s>>>(ws, splits, mn, C);
  return cudaGetLastError();
}

}  // namespace
