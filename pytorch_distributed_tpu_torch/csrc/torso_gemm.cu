// Torso GEMM on fp32 operands: the Hopper port of the TPU kernel
// pytorch_distributed_tpu/ops/pallas_torso.py _mm / _mm_kernel for the
// torso with compute_dtype float32 (a config option), forward and the
// backward of make_mxu_matmul's custom VJP.  Wrapper, autograd Function
// and plain version: ops/cuda_torso.py (gemm_f32).  Every GEMM of the
// bf16 torso, forward and backward, is csrc/torso_gemm_sm90.cu.
//
// Contract: C (M, N) fp32 = A (M, K) @ B (K, N) with fp32 operands and
// fp32 accumulation (dx = g w^T, dw = x^T g, as the reference's custom
// VJP).  A and B are addressed through element strides, so a transposed
// operand is a stride swap and the backward materialises no transpose.  C
// is written row-major and contiguous.
//
// Design (a simple, correct first kernel): one 128-thread block computes a
// 64x64 output tile, walking K in 32-deep tiles staged through shared
// memory.  The tile loaders read along whichever operand dimension has
// stride 1, so neighbouring threads read neighbouring addresses, and fill
// out-of-range rows/columns/depth with zeros: the ragged edges of N = 6
// (Q head) and N = 32 (Conv_0) are masked here and in the store.  Each
// thread accumulates an 8x4 register tile with FMA.
// Split K: a GEMM with few output tiles and a long contraction (the dw of
// Conv_0 contracts 51,200 rows into 256x32 — 4 tiles for 132 SMs) runs
// ``splits`` blocks per tile over disjoint K chunks, each writing its own
// fp32 partial slab; common.cuh's reduce sums the slabs in a fixed order,
// so the result is deterministic (no atomics).
//
// What bounds it on the card: at the main path's shapes most of these
// GEMMs are small or skinny (N of 6, 32 or 64), so memory traffic and
// launch latency dominate, and it runs on the FMA units, not the tensor
// cores.  PERF.md holds the measured times beside the bound.  Not yet
// used: TMA, wgmma, multi-stage pipelining.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128, PAD = 8;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// As[r][c] = A[m0 + r, k0 + c] (zero outside M x [.., k_end))
template <typename T>
__device__ __forceinline__ void load_a(T (*As)[BK + PAD],
                                       const T* __restrict__ A, long long sam,
                                       long long sak, int m0, int k0, int M,
                                       int k_end) {
  const T zero = from_float<T>(0.f);
  if (sak == 1) {  // k-contiguous: consecutive threads walk k
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, m = m0 + r, k = k0 + c;
      As[r][c] = (m < M && k < k_end) ? A[m * sam + k] : zero;
    }
  } else {  // m-contiguous (a transposed operand): consecutive threads walk m
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int c = i / BM, r = i % BM, m = m0 + r, k = k0 + c;
      As[r][c] = (m < M && k < k_end) ? A[m * sam + k * sak] : zero;
    }
  }
}

// Bs[r][c] = B[k0 + r, n0 + c] (zero outside [.., k_end) x N)
template <typename T>
__device__ __forceinline__ void load_b(T (*Bs)[BN + PAD],
                                       const T* __restrict__ B, long long sbk,
                                       long long sbn, int k0, int n0,
                                       int k_end, int N) {
  const T zero = from_float<T>(0.f);
  if (sbn == 1) {  // n-contiguous
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < k_end && n < N) ? B[k * sbk + n] : zero;
    }
  } else {  // k-contiguous (a transposed operand)
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int c = i / BK, r = i % BK, k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < k_end && n < N) ? B[k * sbk + n * sbn] : zero;
    }
  }
}

// the per-type inner product over one staged K tile, and the tile store
template <typename T>
struct TileMma;

template <>
struct TileMma<float> {
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*8..+8, cols tx*4..+4
  __device__ void step(float (*As)[BK + PAD], float (*Bs)[BN + PAD]) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[ty * 8 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* __restrict__ C, int m0, int n0, int M,
                        int N) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) C[static_cast<long long>(m) * N + n] = acc[i][j];
      }
    }
  }
};

// grid (ceil(N/BN), ceil(M/BM), splits); block z sums K range
// [z*k_chunk, min(K, (z+1)*k_chunk)) into slab z of ``out``
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, long long sam, long long sak,
            const T* __restrict__ B, long long sbk, long long sbn,
            float* __restrict__ out, int M, int N, int K, int k_chunk) {
  __shared__ __align__(32) T As[BM][BK + PAD];
  __shared__ __align__(32) T Bs[BK][BN + PAD];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  float* slab = out + static_cast<long long>(blockIdx.z) * M * N;
  TileMma<T> mma;
  mma.zero();
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_a<T>(As, A, sam, sak, m0, k0, M, k_end);
    load_b<T>(Bs, B, sbk, sbn, k0, n0, k_end, N);
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(slab, m0, n0, M, N);
}

template <typename T>
int launch(const void* A, long long sam, long long sak, const void* B,
           long long sbk, long long sbn, void* C, void* ws, int M, int N,
           int K, int k_chunk, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  float* out = static_cast<float*>(splits > 1 ? ws : C);
  gemm_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(A), sam, sak, static_cast<const T*>(B), sbk, sbn,
      out, M, N, K, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pdt_splitk_reduce(
      static_cast<const float*>(ws), splits, static_cast<long long>(M) * N,
      static_cast<float*>(C), s));
}

}  // namespace

// C = A @ B with fp32 operands (FMA)
extern "C" int pdt_gemm_f32(const void* A, long long sam, long long sak,
                            const void* B, long long sbk, long long sbn,
                            void* C, void* ws, int M, int N, int K,
                            int k_chunk, int splits, void* stream) {
  return launch<float>(A, sam, sak, B, sbk, sbn, C, ws, M, N, K, k_chunk,
                       splits, stream);
}
