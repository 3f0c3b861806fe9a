// Torso GEMM on bf16 operands, forward and backward: the Hopper port of
// the TPU kernel pytorch_distributed_tpu/ops/pallas_torso.py _mm (the
// pl.pallas_call at :104) as the forward of make_mxu_matmul and as its
// custom VJP's bwd (dx = g w^T, dw = x^T g, :132-137).  Wrapper, tile plan
// and plain version: ops/cuda_torso.py (gemm_bf16, plan_bf16).  The fp32
// torso (compute_dtype float32) runs csrc/torso_gemm.cu instead.
//
// Contract: C (M, N) fp32 = A (M, K) bf16 @ B (K, N) bf16 with fp32
// accumulation.  Each operand has one unit-stride dimension, and a layout
// flag says which:
//   - A K-major (row-major, row stride lda) or M-major (a transposed
//     view: column stride lda), the latter for dw = x^T g;
//   - B K-major (the transpose of a row-major (N, K) matrix, as the
//     forward's weights are stored) or N-major (row-major (K, N), row
//     stride ldb), the latter for dx = g w^T and dw = x^T g.
// So the backward hands over x, g and w as they lie, with no transposed
// copy.  Base addresses and the non-unit strides are 16-byte aligned (the
// wrapper checks, and raises otherwise).  M, N and K may be ragged.
//
// What bounds it on the card: bytes, at every config-12 shape.  The GEMMs
// of the dqn-cnn torso do 2*M*N*K operations for the bytes of their
// operands and fp32 output, about 6 (the Q head) to 100 (Dense_0)
// operations per byte, far below the ~295 at which the bf16 tensor cores
// become the limit; the backward's dw of Conv_0 (256 x 51,200 x 32) reads
// 29.5 MB for 4 output tiles, and the Q head's GEMMs are launch-bound.  So
// the design moves each byte once, keeps loads in flight, and fills the
// SMs:
//   - TMA: one thread per block copies whole K tiles of A and B from
//     device to shared memory with the 128-byte swizzle; the hardware
//     zero-fills past the ragged edges of M, N and K.  A K-major tile is
//     one box of 64 K values (128-byte rows) by the tile's rows; an
//     MN-major tile is boxes of 64 M or N values (128-byte rows) by the 64
//     K rows of the tile, one box per 64 of the tile's width (a narrower N
//     still takes a 64-wide box, zero-filled past N).
//   - A ring of STAGES tiles with a full and an empty mbarrier per stage:
//     the producer warp keeps up to STAGES tiles in flight while the
//     consumer warpgroups multiply the ones that have landed.
//   - wgmma m64nBNk16 on the tensor cores, fp32 accumulators in registers,
//     with the operand's transpose flag set for an MN-major tile (its
//     descriptor then walks K by rows, 16 rows = 2,048 bytes a step); one
//     consumer warpgroup per 64 rows of the block tile (BM 64 or 128), and
//     BN in {8, 32, 64, 128} picked per GEMM so a narrow N (6, 32) does not
//     pay for a 64-wide tile in registers.
//   - Split K: when the output has few tiles and a long contraction
//     (Dense_0's forward; every dw but the Q head's and Dense_0's),
//     ``splits`` blocks per tile sum disjoint K chunks into their own fp32
//     slabs, and common.cuh's reduce sums the slabs in a fixed order:
//     deterministic, no atomics.
//   - Masked fp32 stores straight from the accumulator registers.
// TMA descriptors are built on the host per call (tma.cuh: the encoder is
// reached through cudaGetDriverEntryPoint, no -lcuda) and passed by value
// as __grid_constant__ parameters, so a captured CUDA graph replays them
// with the addresses it captured.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int BK = 64;      // K tile: 64 bf16, one 128-byte swizzled row
constexpr int STAGES = 4;   // tiles in flight
constexpr int WG = 128;     // threads of a warpgroup
constexpr int MN_BOX = 64;  // M or N values in one box of an MN-major tile
constexpr int BOX_BYTES = MN_BOX * BK * 2;  // an MN-major box, 8 KB

// kBMn: B is N-major (read in 64-wide boxes, so at least 64 wide in
// shared memory)
template <int BM, int BN, bool kBMn>
struct Tile {
  static constexpr int kWarpgroups = BM / 64;
  static constexpr int kThreads = kWarpgroups * WG + 32;  // + producer warp
  static constexpr int kBRows = kBMn && BN < MN_BOX ? MN_BOX : BN;
  static constexpr int kBBoxes = kBRows / MN_BOX;  // N-major boxes
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = kBRows * BK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, 2 * STAGES mbarriers, and slack to align the ring to 1024
  static constexpr int kSmemBytes =
      STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
};

// wgmma descriptor of a tile that TMA wrote with the 128-byte swizzle
// (layout type 1 in bits 62-63): 128-byte rows, 8-row groups 1024 bytes
// apart (SBO).  K-major: the rows run along M or N, and LBO is unused
// (1).  MN-major: the rows run along K, and LBO is the distance between
// the 64-wide boxes along M or N (the canonical MN-major SW128 layout
// ((8,8,m),(8,k)) : ((1,8,LBO),(64,SBO)) in bf16 elements, as CUTLASS's
// cute/atom/mma_traits_sm90_gmma.hpp describes it).
template <bool kMn>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t lbo = kMn ? BOX_BYTES >> 4 : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the byte step of the descriptor's start per k16 slice: 16 K values are
// 32 bytes along a K-major row, and 16 rows of an MN-major tile
template <bool kMn>
constexpr uint32_t kK16Step = kMn ? 16 * 128 : 32;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its wait
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, wgmma's fragment layout) += A (64 x 16) B (16 x N),
// both read from shared memory through their descriptors; TA / TB set
// wgmma's transpose flag for an M- / N-major tile
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31,\n"
        " %32, %33, %34, %35, %36, %37, %38, %39,\n"
        " %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55,\n"
        " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// grid (ceil(N/BN), ceil(M/BM), splits); block z sums K range
// [z*k_chunk, min(K, (z+1)*k_chunk)) into slab z of ``out`` (M x N).
// kAMn / kBMn: A is M-major / B is N-major.
template <int BM, int BN, bool kAMn, bool kBMn>
__global__ void __launch_bounds__(Tile<BM, BN, kBMn>::kThreads)
    gemm_bf16_sm90(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ out, int M, int N, int K,
                   int k_chunk) {
  using T = Tile<BM, BN, kBMn>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle pattern repeats every 1024 bytes of the shared
  // window, and wgmma's descriptors assume a ring aligned to it
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * T::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = (k_end - k_begin + BK - 1) / BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                          // the producer
      mbar_init(empty(s), T::kWarpgroups * 4);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == T::kWarpgroups * 4) {  // the producer warp: one thread
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        // round r reuses stage s after the consumers released round r-1;
        // round 0 passes at once (parity 1 of a fresh barrier)
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), T::kStageBytes);
        const uint32_t a = ring + s * T::kStageBytes, b = a + T::kABytes;
        const int k0 = k_begin + kt * BK;
        if (kAMn) {  // one 64-row box per consumer warpgroup
          for (int i = 0; i < T::kWarpgroups; ++i)
            tma_load(a + i * BOX_BYTES, &map_a, full(s), m0 + i * MN_BOX, k0);
        } else {
          tma_load(a, &map_a, full(s), k0, m0);
        }
        if (kBMn) {
          for (int i = 0; i < T::kBBoxes; ++i)
            tma_load(b + i * BOX_BYTES, &map_b, full(s), n0 + i * MN_BOX, k0);
        } else {
          tma_load(b, &map_b, full(s), k0, n0);
        }
      }
    }
    return;
  }

  // consumer warpgroup ``wg`` owns rows [wg*64, wg*64 + 64) of the tile:
  // 8 KB into the stage for either layout of A (64 rows of 128 bytes, or
  // one 64-wide box)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t a = ring + s * T::kStageBytes + wg * BOX_BYTES;
    const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      Wgmma<BN>::template run<kAMn, kBMn>(
          acc, smem_desc<kAMn>(a + j * kK16Step<kAMn>),
          smem_desc<kBMn>(b + j * kK16Step<kBMn>));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BN / 2>(acc);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(s));
  }

  // acc[j*4 + i] holds row w*16 + lane/4 + 8*(i/2), column
  // j*8 + (lane%4)*2 + i%2 of the warpgroup's 64 x BN tile
  float* slab = out + static_cast<long long>(blockIdx.z) * M * N;
  const int lane = threadIdx.x % 32, w = warp % 4;
  const int row0 = m0 + wg * 64 + w * 16 + lane / 4;
  const bool pairs = (N % 2) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= M || c >= N) continue;
      float* p = slab + static_cast<long long>(r) * N + c;
      const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (c + 1 < N) p[1] = v1;
      }
    }
  }
}

// a bf16 matrix of ``outer`` lines of ``inner`` unit-stride values, ``ld``
// elements apart, in boxes of box_inner (64: 128 bytes) x box_outer
cudaError_t encode(CUtensorMap* map, const void* base, long long inner,
                   long long outer, long long ld, int box_inner,
                   int box_outer) {
  return pdt_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, inner,
                    outer, ld, box_inner, box_outer);
}

template <int BM, int BN, bool kAMn, bool kBMn>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_bf16_sm90<BM, BN, kAMn, kBMn>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<BM, BN, kBMn>::kSmemBytes);
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
  using T = Tile<BM, BN, kBMn>;
  CUtensorMap map_a, map_b;
  cudaError_t err = kAMn ? encode(&map_a, A, M, K, lda, MN_BOX, BK)
                         : encode(&map_a, A, K, M, lda, BK, BM);
  if (err == cudaSuccess)
    err = kBMn ? encode(&map_b, B, N, K, ldb, MN_BOX, BK)
               : encode(&map_b, B, K, N, ldb, BK, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_bf16_sm90<BM, BN, kAMn, kBMn><<<grid, T::kThreads, T::kSmemBytes, s>>>(
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
extern "C" int pdt_gemm_bf16_init() {
  const cudaError_t found = pdt_find_encode();
  if (found != cudaSuccess) return static_cast<int>(found);
  const cudaError_t errs[] = {
      allow_smem_all_layouts<64, 8>(),   allow_smem_all_layouts<64, 32>(),
      allow_smem_all_layouts<64, 64>(),  allow_smem_all_layouts<64, 128>(),
      allow_smem_all_layouts<128, 8>(),  allow_smem_all_layouts<128, 32>(),
      allow_smem_all_layouts<128, 64>(), allow_smem_all_layouts<128, 128>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return static_cast<int>(e);
  return 0;
}

// C = A @ B, A (M, K) bf16 and B (K, N) bf16.  A is K-major (a_mn = 0:
// row m starts at A + m*lda) or M-major (a_mn = 1: column k starts at
// A + k*lda); B is K-major (b_mn = 0: column n starts at B + n*ldb) or
// N-major (b_mn = 1: row k starts at B + k*ldb).  Tile bm x bn (bm in
// {64, 128}, bn in {8, 32, 64, 128}); ``ws`` holds splits*M*N floats when
// splits > 1.
extern "C" int pdt_gemm_bf16(const void* A, long long lda, int a_mn,
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
  PDT_TILE(64, 8) PDT_TILE(64, 32) PDT_TILE(64, 64) PDT_TILE(64, 128)
  PDT_TILE(128, 8) PDT_TILE(128, 32) PDT_TILE(128, 64) PDT_TILE(128, 128)
#undef PDT_TILE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(pdt_splitk_reduce(static_cast<const float*>(ws),
                                            splits,
                                            static_cast<long long>(M) * N,
                                            static_cast<float*>(C), s));
}
