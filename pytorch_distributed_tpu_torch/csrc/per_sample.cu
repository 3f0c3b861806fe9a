// Proportional PER draw in one launch: the Hopper port of the TPU kernel
// pytorch_distributed_tpu/ops/pallas_sampling.py hierarchical_sample
// (_draw_kernel, and the XLA block sums, cumsum and searchsorted around
// it).  Wrapper and plain version: ops/cuda_sampling.py.
//
// One thread block per draw, 1,024 threads, over an (N,) fp32 priority
// vector cut into nb = ceil(N / 1024) superblocks (rows past N count as
// zero priority):
//   1. Block sums.  Warp w sums superblocks w, w + 32, ... (eight float4
//      loads a lane, then a warp shuffle sum), in one fixed order, so every
//      block of the grid holds bit-identical sums without talking to the
//      others: no grid-wide sync, no counters to reset between CUDA graph
//      replays.  32 warps keep up to 32 superblocks' loads in flight.
//   2. Warp 0 scans the nb sums into the superblock CDF in shared memory,
//      takes target = u * total, the superblock bid = count(cdf <= target)
//      clamped to nb - 1, and the residual target - cdf[bid - 1].
//   3. The in-block search: 256 threads load superblock bid (one float4
//      each), form its inclusive prefix (thread-local prefix, warp
//      shuffle scan, warp totals through shared memory) and count
//      prefix <= residual, clamped to 1023; the row is then clamped to N-1.
//   4. A draw that lands on a zero row (the block's upper CDF edge, where
//      the two sums are taken in another order) is remapped to the first
//      row of largest priority, as jnp.argmax / torch.argmax: only that
//      block runs the argmax pass over p, so the pass is rare and
//      data-dependent but deterministic.  probs = p[idx] / max(total,
//      1e-12).
//
// What bounds it on the card: launch latency and L2.  The function must
// read the priority vector once and the uniforms, and write 12 bytes per
// draw: 0.2 MB at N = 50,000 and B = 128, well under a microsecond at HBM
// rate.  The design spends one launch and no torch op, and buys that with
// redundant reads: each of the B blocks reads all N priorities for step 1,
// B * N * 4 bytes (25.6 MB at config 12), which the 50 MB L2 serves, as the
// 200 KB vector stays resident there between updates.  The redundant read
// grows with B * N: a ring of millions of rows would want the block sums
// shared across a thread-block cluster (distributed shared memory) or a
// separate pass.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;              // priorities per superblock
constexpr int kThreads = 1024;            // a warp per superblock in step 1
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = kBlock / 4;  // one float4 each in step 3
constexpr int kScanWarps = kScanThreads / 32;

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

// (value, index) of the larger priority, the lower index on a tie
__device__ __forceinline__ void keep_max(float& v, long long& i, float v2,
                                         long long i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// the first index of the largest priority, over the whole block
__device__ long long argmax_first(const float* __restrict__ p, long long n,
                                  float* warp_val, long long* warp_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float best = -INFINITY;
  long long at = n;
  for (long long base = 4 * threadIdx.x; base < n; base += 4 * kThreads) {
    const float4 v = load4(p, n, base);
    const float q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n && q[j] > best) {  // strict: the first of a tie
        best = q[j];
        at = base + j;
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    keep_max(best, at, __shfl_xor_sync(PDT_FULL_MASK, best, o),
             __shfl_xor_sync(PDT_FULL_MASK, at, o));
  if (lane == 0) {
    warp_val[warp] = best;
    warp_idx[warp] = at;
  }
  __syncthreads();
  best = warp_val[0];
  at = warp_idx[0];
  for (int w = 1; w < kWarps; ++w) keep_max(best, at, warp_val[w], warp_idx[w]);
  return at;
}

// grid (B,): block i draws idx[i], probs[i] from u[i]; dynamic shared
// memory holds the nb-long superblock CDF
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ p, long long n, int nb,
              const float* __restrict__ u, long long* __restrict__ idx,
              float* __restrict__ probs) {
  extern __shared__ float cdf[];
  __shared__ float warp_tot[kScanWarps], warp_val[kWarps];
  __shared__ int warp_cnt[kScanWarps];
  __shared__ long long warp_idx[kWarps];
  __shared__ int s_bid;
  __shared__ float s_res, s_total;
  __shared__ long long s_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. superblock sums, one warp per superblock, in a fixed order
  for (int b = warp; b < nb; b += kWarps) {
    const long long base = static_cast<long long>(b) * kBlock;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kBlock / 128; ++j) {
      const float4 v = load4(p, n, base + 4 * (lane + 32 * j));
      s += (v.x + v.y) + (v.z + v.w);
    }
    s = pdt_warp_sum(s);
    if (lane == 0) cdf[b] = s;
  }
  __syncthreads();

  // 2. the superblock CDF, the draw's superblock and its residual target
  if (warp == 0) {
    float carry = 0.f;
    for (int c = 0; c < nb; c += 32) {  // inclusive scan, 32 at a time
      float v = c + lane < nb ? cdf[c + lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(PDT_FULL_MASK, v, o);
        if (lane >= o) v += y;
      }
      v += carry;
      if (c + lane < nb) cdf[c + lane] = v;
      carry = __shfl_sync(PDT_FULL_MASK, v, 31);
    }
    __syncwarp();
    const float total = cdf[nb - 1];
    // rounded before the subtraction below, as the plain version rounds it
    // (no fused multiply-add)
    const float target = __fmul_rn(u[blockIdx.x], total);
    int cnt = 0;
    for (int c = lane; c < nb; c += 32) cnt += cdf[c] <= target;
    const int bid = min(pdt_warp_sum(cnt), nb - 1);
    if (lane == 0) {
      s_bid = bid;
      s_res = target - (bid > 0 ? cdf[bid - 1] : 0.f);
      s_total = total;
    }
  }
  __syncthreads();

  // 3. count(prefix <= residual) inside superblock bid, by the first
  // kScanThreads threads, one float4 each
  const bool scans = threadIdx.x < kScanThreads;  // whole warps
  const float t = s_res;
  const float4 v =
      scans ? load4(p, n, static_cast<long long>(s_bid) * kBlock +
                              4 * threadIdx.x)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  const float q0 = v.x, q1 = q0 + v.y, q2 = q1 + v.z, q3 = q2 + v.w;
  float incl = q3;  // inclusive scan of the thread totals across the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(PDT_FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(PDT_FULL_MASK, incl, 1);
  if (lane == 0) excl = 0.f;
  if (scans && lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (scans) {
    float off = 0.f;  // total of the warps before this one, in warp order
    for (int w = 0; w < warp; ++w) off += warp_tot[w];
    off += excl;
    int cnt = (off + q0 <= t) + (off + q1 <= t) + (off + q2 <= t) +
              (off + q3 <= t);
    cnt = pdt_warp_sum(cnt);
    if (lane == 0) warp_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int local = 0;
    for (int w = 0; w < kScanWarps; ++w) local += warp_cnt[w];
    local = min(local, kBlock - 1);
    s_row = min(static_cast<long long>(s_bid) * kBlock + local, n - 1);
  }
  __syncthreads();

  // 4. a zero row is remapped to the first largest priority
  long long row = s_row;
  if (!(p[row] > 0.f)) row = argmax_first(p, n, warp_val, warp_idx);
  if (threadIdx.x == 0) {
    idx[blockIdx.x] = row;
    probs[blockIdx.x] = p[row] / fmaxf(s_total, 1e-12f);
  }
}

}  // namespace

// idx[i], probs[i] for i < batch: the proportional draw of u[i] from the
// (n,) priorities p (16-byte aligned), in one launch; nb = ceil(n / 1024)
// floats of dynamic shared memory
extern "C" int pdt_sample(const void* p, long long n, const void* u,
                          int batch, void* idx, void* probs, void* stream) {
  const int nb = static_cast<int>((n + kBlock - 1) / kBlock);
  sample_kernel<<<batch, kThreads, nb * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), n, nb, static_cast<const float*>(u),
      static_cast<long long*>(idx), static_cast<float*>(probs));
  return static_cast<int>(cudaGetLastError());
}
