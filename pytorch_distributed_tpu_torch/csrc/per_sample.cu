// Proportional PER draw: the Hopper port of the TPU kernel
// pytorch_distributed_tpu/ops/pallas_sampling.py hierarchical_sample
// (_draw_kernel).  Wrapper and plain version: ops/cuda_sampling.py.
//
// Given an (N,) fp32 priority vector cut into 1024-row superblocks:
//   1. pdt_block_sums: one thread block per superblock sums its 1024
//      priorities (float4 loads, warp shuffles, warp totals in shared
//      memory).  Rows past N count as zero priority.
//   2. (torch, in the wrapper) cumsum + searchsorted over the N/1024 block
//      sums picks each draw's superblock and its residual target, as the
//      reference leaves that small step to XLA.
//   3. pdt_draw: one thread block per draw loads its superblock (4
//      priorities per thread as one float4), forms the block-wide inclusive
//      prefix (thread-local prefix, warp shuffle scan, warp totals through
//      shared memory) and returns count(prefix <= target), clamped to 1023.
//
// What bounds it on the card: launch latency first, then memory.  A call
// reads the priority vector once in phase 1 and 4 KB per draw in phase 3:
// about N*4 + B*4 KB, 0.2 MB + 0.5 MB at N = 50,000 and B = 128, which the
// H100 moves in well under a microsecond, so two kernel launches and the
// small torch ops between them are the cost.  The design keeps the work at
// one pass over N plus one superblock per draw, and never materialises the
// N-long cumulative sum.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;          // priorities per superblock
constexpr int kThreads = kBlock / 4;  // one float4 per thread
constexpr int kWarps = kThreads / 32;

// four consecutive priorities from index ``base`` (a multiple of 4, with the
// vector 16-byte aligned), zero past ``n``
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long n, long long base) {
  if (base + 3 < n) return *reinterpret_cast<const float4*>(p + base);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (base < n) v.x = p[base];
  if (base + 1 < n) v.y = p[base + 1];
  if (base + 2 < n) v.z = p[base + 2];
  return v;
}

__global__ void __launch_bounds__(kThreads)
block_sums_kernel(const float* __restrict__ p, long long n,
                  float* __restrict__ sums) {
  __shared__ float warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base =
      static_cast<long long>(blockIdx.x) * kBlock + 4 * threadIdx.x;
  const float4 v = load4(p, n, base);
  float s = pdt_warp_sum((v.x + v.y) + (v.z + v.w));
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = pdt_warp_sum(lane < kWarps ? warp_tot[lane] : 0.f);
    if (lane == 0) sums[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
draw_kernel(const float* __restrict__ p, long long n,
            const int* __restrict__ block_ids,
            const float* __restrict__ targets, int* __restrict__ local) {
  __shared__ float warp_tot[kWarps];
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float t = targets[blockIdx.x];
  const long long base =
      static_cast<long long>(block_ids[blockIdx.x]) * kBlock + 4 * threadIdx.x;
  const float4 v = load4(p, n, base);

  // thread-local inclusive prefix of its four priorities
  const float q0 = v.x, q1 = q0 + v.y, q2 = q1 + v.z, q3 = q2 + v.w;
  // inclusive scan of the thread totals across the warp
  float incl = q3;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(PDT_FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(PDT_FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  float off = 0.f;  // total of the warps before this one, in warp order
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  off += excl;

  int cnt = (off + q0 <= t) + (off + q1 <= t) + (off + q2 <= t) +
            (off + q3 <= t);
  cnt = pdt_warp_sum(cnt);
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_cnt[w];
    local[blockIdx.x] = min(total, kBlock - 1);
  }
}

}  // namespace

// sums[b] = sum(p[b*1024 : (b+1)*1024]) for b < num_blocks
extern "C" int pdt_block_sums(const void* p, long long n, void* sums,
                              int num_blocks, void* stream) {
  block_sums_kernel<<<num_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), n, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// local[i] = min(count(prefix of superblock block_ids[i] <= targets[i]), 1023)
extern "C" int pdt_draw(const void* p, long long n, const void* block_ids,
                        const void* targets, void* local, int batch,
                        void* stream) {
  draw_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), n, static_cast<const int*>(block_ids),
      static_cast<const float*>(targets), static_cast<int*>(local));
  return static_cast<int>(cudaGetLastError());
}
