// Torso GEMM on fp32 operands, forward and backward: the Hopper port of the
// TPU kernel pytorch_distributed_tpu/ops/pallas_torso.py _mm (the
// pl.pallas_call at :104) for the torso with compute_dtype float32 (a
// config option), as the forward of make_mxu_matmul and as its custom
// VJP's bwd (dx = g w^T, dw = x^T g, :132-137).  Wrapper, tile plan and
// plain version: ops/cuda_torso.py (gemm_f32, plan_f32).  The bf16 torso
// runs csrc/torso_gemm_sm90.cu.
//
// Contract: C (M, N) fp32 = A (M, K) fp32 @ B (K, N) fp32 with fp32
// accumulation.  Each operand has one unit-stride dimension, and a layout
// flag says which, as in the bf16 kernel:
//   - A K-major (row-major, row stride lda) or M-major (a transposed view:
//     column stride lda), the latter for dw = x^T g;
//   - B K-major (the transpose of a row-major (N, K) matrix, as the
//     forward's weights are stored) or N-major (row-major (K, N), row
//     stride ldb), the latter for dx = g w^T and dw = x^T g.
// Base addresses and the non-unit strides are 16-byte aligned (the wrapper
// checks, and raises otherwise).  M, N and K may be ragged.
//
// What bounds it on the card: the fp32 operations, at 67 TFLOP/s on the
// CUDA cores, for every config-12 GEMM but Conv_0's forward and dw (52 MB
// of patches: bytes) and the Q head's (launch).  The tensor cores take fp32
// only rounded to TF32, which is another product than the reference's, so
// the kernel runs FFMA, and its design keeps the FMA pipes fed:
//   - TMA: one producer thread copies whole K tiles of 32 floats of A and
//     B into a ring of STAGES stages with the 128-byte swizzle, a full and
//     an empty mbarrier per stage (the machinery of the bf16 kernel,
//     tma.cuh); the hardware zero-fills past the ragged edges of M, N and
//     K, so the inner loop has no masks.  A K-major tile is one box of 32
//     K values (128-byte rows) by the tile's rows; an MN-major tile is
//     boxes of 32 M or N values by the 32 K rows of the tile.
//   - Register tiles: each consumer thread accumulates TM x TN outputs
//     (8x8, or 8x4 / 4x8 / 4x4 for the narrow tiles) and reads its
//     operands with 128-bit shared loads: 4 K values of one of its rows
//     from a K-major tile, 4 neighbouring rows at one K from an MN-major
//     tile.  Per 4 K steps that is TM + TN loads for 4*TM*TN FMA (16 FMA a
//     load at 8x8).  Rows and columns are dealt to the threads so that the
//     8 lanes of each quarter-warp read 8 distinct 16-byte chunks (B) or
//     one chunk (A, a broadcast): the swizzle keeps every load free of
//     bank conflicts.
//   - Tile widths follow N (BN 32, 64 or 128; BM 64 or 128), so a narrow N
//     (6, 32) does not pay for a wide tile; 128 or 256 consumer threads a
//     block.  At config 12's shapes the blocks are few for 132 SMs, so the
//     plan favours 64-row tiles and about two blocks a SM.
//   - Split K: when the output has few tiles and a long contraction (every
//     conv layer's dw, Dense_0's forward and dx, the Q head's forward),
//     ``splits`` blocks per tile sum disjoint K chunks into their own fp32
//     slabs, and common.cuh's reduce sums the slabs in a fixed order:
//     deterministic, no atomics.
//   - Masked stores straight from the registers (float4 where the columns
//     of a thread are neighbours and N allows it).
// TMA descriptors are built on the host per call and passed by value as
// __grid_constant__ parameters, so a captured CUDA graph replays them with
// the addresses it captured.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int BK = 32;      // K tile: 32 floats, one 128-byte swizzled row
constexpr int STAGES = 4;   // tiles in flight
constexpr int BOX = 32;     // M or N values in one box of an MN-major tile
constexpr int BOX_FLOATS = BOX * BK;  // an MN-major box, 4 KB

// 16 thread rows of TM rows each; TX thread columns of TN columns each
template <int BM, int BN>
struct Tile {
  static constexpr int kTM = BM / 16;
  static constexpr int kTX = BN == 128 ? 16 : 8;
  static constexpr int kTN = BN / kTX;
  static constexpr int kWarps = 16 * kTX / 32;      // consumer warps
  static constexpr int kThreads = 16 * kTX + 32;    // + producer warp
  static constexpr int kAFloats = BM * BK;
  static constexpr int kStageFloats = (BM + BN) * BK;
  static constexpr int kStageBytes = kStageFloats * 4;
  // the ring, 2 * STAGES mbarriers, and slack to align the ring to 1024
  static constexpr int kSmemBytes =
      STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
};

// The operand rows (of A) or columns (of B) of thread ``t`` (of ``S``
// threads along that side), f = 0 .. C-1: for a K-major tile t + S*f;
// for an MN-major tile groups of 4 neighbours, 4t + 4S*(f/4) + f%4.
template <bool kMn, int S>
__device__ __forceinline__ int owned(int t, int f) {
  return kMn ? 4 * t + 4 * S * (f / 4) + f % 4 : t + S * f;
}

// frag[f][kk] = the operand at row/column owned(t, f), K = 4*kc + kk, of a
// stage's tile (swizzled 128-byte rows; see the source note)
template <bool kMn, int S, int C>
__device__ __forceinline__ void load_frag(float (&frag)[C][4],
                                          const float* __restrict__ tile,
                                          int t, int kc) {
  if (kMn) {  // rows along K, 32-wide boxes along M or N
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * kc + kk;
#pragma unroll
      for (int g = 0; g < C / 4; ++g) {
        const int r = owned<true, S>(t, 4 * g);
        const float4 v = *reinterpret_cast<const float4*>(
            tile + (r / BOX) * BOX_FLOATS + k * BOX +
            (((r % BOX / 4) ^ (k & 7)) << 2));
        frag[4 * g][kk] = v.x;
        frag[4 * g + 1][kk] = v.y;
        frag[4 * g + 2][kk] = v.z;
        frag[4 * g + 3][kk] = v.w;
      }
    }
  } else {  // rows along M or N, 32 K values each
#pragma unroll
    for (int f = 0; f < C; ++f) {
      const int r = owned<false, S>(t, f);
      const float4 v = *reinterpret_cast<const float4*>(
          tile + r * BK + ((kc ^ (r & 7)) << 2));
      frag[f][0] = v.x;
      frag[f][1] = v.y;
      frag[f][2] = v.z;
      frag[f][3] = v.w;
    }
  }
}

// grid (ceil(N/BN), ceil(M/BM), splits); block z sums K range
// [z*k_chunk, min(K, (z+1)*k_chunk)) into slab z of ``out`` (M x N).
// kAMn / kBMn: A is M-major / B is N-major.
template <int BM, int BN, bool kAMn, bool kBMn>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
    gemm_f32_sm90(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  float* __restrict__ out, int M, int N, int K,
                  int k_chunk) {
  using T = Tile<BM, BN>;
  constexpr int TM = T::kTM, TN = T::kTN, TX = T::kTX;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the 128-byte swizzle pattern repeats every 1024 bytes of the shared
  // window, and load_frag's addressing assumes a ring aligned to it
  const uint32_t raw = smem_u32(smem_raw);
  float* ring =
      reinterpret_cast<float*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t bars = ring_s + STAGES * T::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = (k_end - k_begin + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);           // the producer
      mbar_init(empty(s), T::kWarps);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == T::kWarps) {  // the producer warp: one thread
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        // round r reuses stage s after the consumers released round r-1;
        // round 0 passes at once (parity 1 of a fresh barrier)
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), T::kStageBytes);
        const uint32_t a = ring_s + s * T::kStageBytes;
        const uint32_t b = a + T::kAFloats * 4;
        const int k0 = k_begin + kt * BK;
        if (kAMn) {
          for (int i = 0; i < BM / BOX; ++i)
            tma_load(a + i * BOX_FLOATS * 4, &map_a, full(s), m0 + i * BOX,
                     k0);
        } else {
          tma_load(a, &map_a, full(s), k0, m0);
        }
        if (kBMn) {
          for (int i = 0; i < BN / BOX; ++i)
            tma_load(b + i * BOX_FLOATS * 4, &map_b, full(s), n0 + i * BOX,
                     k0);
        } else {
          tma_load(b, &map_b, full(s), k0, n0);
        }
      }
    }
    return;
  }

  // a quarter-warp (8 lanes) shares ty and takes 8 neighbouring tx
  const int tx = (warp % (TX / 8)) * 8 + lane % 8;
  const int ty = (warp / (TX / 8)) * 4 + lane / 8;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const float* As = ring + s * T::kStageFloats;
    const float* Bs = As + T::kAFloats;
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      float a[TM][4], b[TN][4];
      load_frag<kAMn, 16, TM>(a, As, ty, kc);
      load_frag<kBMn, TX, TN>(b, Bs, tx, kc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  float* slab = out + static_cast<long long>(blockIdx.z) * M * N;
  const bool vec4 = kBMn && N % 4 == 0;  // float4 stores stay aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + owned<kAMn, 16>(ty, i);
    if (r >= M) continue;
    float* row = slab + static_cast<long long>(r) * N;
    if (vec4) {  // owned columns 4g .. 4g+3 are neighbours; N % 4 == 0
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int c = n0 + owned<true, TX>(tx, 4 * g);
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + owned<kBMn, TX>(tx, j);
        if (c < N) row[c] = acc[i][j];
      }
    }
  }
}

// an fp32 matrix of ``outer`` lines of ``inner`` unit-stride values, ``ld``
// elements apart, in boxes of box_inner (32: 128 bytes) x box_outer
cudaError_t encode(CUtensorMap* map, const void* base, long long inner,
                   long long outer, long long ld, int box_inner,
                   int box_outer) {
  return pdt_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, inner,
                    outer, ld, box_inner, box_outer);
}

template <int BM, int BN, bool kAMn, bool kBMn>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_f32_sm90<BM, BN, kAMn, kBMn>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<BM, BN>::kSmemBytes);
}

template <int BM, int BN>
cudaError_t allow_smem_all_layouts() {
  const cudaError_t errs[] = {
      allow_smem<BM, BN, false, false>(), allow_smem<BM, BN, false, true>(),
      allow_smem<BM, BN, true, false>(), allow_smem<BM, BN, true, true>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <int BM, int BN, bool kAMn, bool kBMn>
cudaError_t launch(const void* A, long long lda, const void* B, long long ldb,
                   float* out, int M, int N, int K, int k_chunk, int splits,
                   cudaStream_t s) {
  using T = Tile<BM, BN>;
  CUtensorMap map_a, map_b;
  cudaError_t err = kAMn ? encode(&map_a, A, M, K, lda, BOX, BK)
                         : encode(&map_a, A, K, M, lda, BK, BM);
  if (err == cudaSuccess)
    err = kBMn ? encode(&map_b, B, N, K, ldb, BOX, BK)
               : encode(&map_b, B, K, N, ldb, BK, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_f32_sm90<BM, BN, kAMn, kBMn><<<grid, T::kThreads, T::kSmemBytes, s>>>(
      map_a, map_b, out, M, N, K, k_chunk);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_layout(bool a_mn, bool b_mn, const void* A, long long lda,
                          const void* B, long long ldb, float* out, int M,
                          int N, int K, int k_chunk, int splits,
                          cudaStream_t s) {
  if (a_mn && b_mn)
    return launch<BM, BN, true, true>(A, lda, B, ldb, out, M, N, K, k_chunk,
                                      splits, s);
  if (a_mn)
    return launch<BM, BN, true, false>(A, lda, B, ldb, out, M, N, K, k_chunk,
                                       splits, s);
  if (b_mn)
    return launch<BM, BN, false, true>(A, lda, B, ldb, out, M, N, K, k_chunk,
                                       splits, s);
  return launch<BM, BN, false, false>(A, lda, B, ldb, out, M, N, K, k_chunk,
                                      splits, s);
}

}  // namespace

// Once per process, before the first launch and before any CUDA graph
// capture: finds cuTensorMapEncodeTiled and lets every tile shape and
// layout use its dynamic shared memory (above the 48 KB default).
extern "C" int pdt_gemm_f32_init() {
  const cudaError_t found = pdt_find_encode();
  if (found != cudaSuccess) return static_cast<int>(found);
  const cudaError_t errs[] = {
      allow_smem_all_layouts<64, 32>(),  allow_smem_all_layouts<64, 64>(),
      allow_smem_all_layouts<64, 128>(), allow_smem_all_layouts<128, 32>(),
      allow_smem_all_layouts<128, 64>(), allow_smem_all_layouts<128, 128>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return static_cast<int>(e);
  return 0;
}

// C = A @ B, A (M, K) fp32 and B (K, N) fp32, with the layout flags of
// pdt_gemm_bf16: A K-major (a_mn = 0: row m starts at A + m*lda) or
// M-major (a_mn = 1: column k starts at A + k*lda); B K-major (b_mn = 0:
// column n starts at B + n*ldb) or N-major (b_mn = 1: row k starts at
// B + k*ldb).  Tile bm x bn (bm in {64, 128}, bn in {32, 64, 128}); ``ws``
// holds splits*M*N floats when splits > 1.
extern "C" int pdt_gemm_f32(const void* A, long long lda, int a_mn,
                            const void* B, long long ldb, int b_mn, void* C,
                            void* ws, int M, int N, int K, int bm, int bn,
                            int k_chunk, int splits, void* stream) {
  if (g_encode == nullptr) return static_cast<int>(cudaErrorInitializationError);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? ws : C);
  cudaError_t err = cudaErrorInvalidValue;
#define PDT_TILE(TM, TN)                                                  \
  if (bm == TM && bn == TN)                                               \
    err = launch_layout<TM, TN>(a_mn != 0, b_mn != 0, A, lda, B, ldb, out, \
                                M, N, K, k_chunk, splits, s);
  PDT_TILE(64, 32) PDT_TILE(64, 64) PDT_TILE(64, 128)
  PDT_TILE(128, 32) PDT_TILE(128, 64) PDT_TILE(128, 128)
#undef PDT_TILE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pdt_splitk_reduce(static_cast<const float*>(ws),
                                            splits,
                                            static_cast<long long>(M) * N,
                                            static_cast<float*>(C), s));
}
