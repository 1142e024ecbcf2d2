// Matrix product C = A @ B for bf16 inputs on Hopper's tensor cores, sm_90a
// (K2 of the port, the wgmma variant; csrc/matmul.cu is the SIMT variant).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` in
// src/repro/kernels/matmul.py and computes what it computes for bf16: A
// (M, K) and B (K, N) row-major bf16; products accumulated in fp32; the sum
// cast once to the output type (bf16 or fp32).  The dispatch rule
// (kernels/matmul.py `plan`) sends here bf16 inputs whose rows TMA can
// describe (K % 8 == 0 and N % 8 == 0: 16-byte row strides); everything
// else, fp32 included (TF32 would change the numbers), runs the SIMT kernel.
//
// What bounds it on the card: at the prefill projections (800 x 2560 x
// 4096) operations, at the tensor-core rate; at decode (4 rows) the bytes
// of B.  Design, one block per 128 x BN output tile (BN 128 or 256, chosen
// by `plan` from the wave count on 132 SMs):
//  - warp specialisation: warps 0-7 are two consumer warpgroups, each
//    computing 64 x BN of the tile by wgmma.mma_async (m64nBNk16, bf16 in,
//    fp32 accumulators in registers); warp 8 is the producer, one elected
//    thread of which issues every TMA load;
//  - a ring of kStages (A 128 x 64, B 64 x BN) bf16 stages in dynamic
//    shared memory, with a full and an empty mbarrier per stage and parity
//    phases: the producer waits for a stage to be empty, arms its full
//    barrier with the stage's byte count and issues the loads; consumers
//    wait for full, issue four k16 wgmmas as one group, and release the
//    previous stage once its group is done (one group stays in flight), so
//    that TMA keeps the other stages loading under the math;
//  - TMA descriptors (cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint so that the library needs no -lcuda) with the
//    128-byte swizzle, passed as __grid_constant__ parameters (so a CUDA
//    graph captures them by value); TMA zero-fills the ragged M / N / K
//    edges of a tile, and the epilogue's stores skip rows and columns past
//    M and N;
//  - A is K-major (a 128-byte row of 64 k); B stays as given, N-major:
//    wgmma's transpose-B form for 16-bit types reads it from 64-column
//    panels of 64 k-rows, one TMA box each;
//  - split K for grids below one wave (decode): blockIdx.z takes a
//    contiguous share of the k tiles and writes an fp32 partial to a
//    (split, M, N) workspace; a second kernel sums the partials in a fixed
//    order and casts, so the result is deterministic (no atomics).
// The wgmma instruction itself comes from CuTe's MMA atoms
// (cute/arch/mma_sm90_gmma.hpp, CUTLASS's headers, -I per source); the
// pipeline, descriptors and epilogue are written here.
//
// C entry point (bound with ctypes): returns a CUDA error code (0 on
// success) after the launches; launches on the given stream; allocates
// nothing (the wrapper allocates the output and the workspace).

#include <cuda.h>            // CUtensorMap and the driver's enums (no -lcuda)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cute/arch/mma_sm90_gmma.hpp>

namespace {

namespace gmma = cute::SM90::GMMA;

constexpr int kBM = 128;                       // rows of a block's tile
constexpr int kBK = 64;                        // k per stage: 128 bytes
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;
constexpr int kPanel = 64;                     // B columns per TMA box
constexpr uint32_t kSwizzleAtom = 1024;        // 8 rows x 128 bytes

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 128 ? 5 : 4;
  static constexpr int kABytes = kBM * kBK * 2;          // 16 KB
  static constexpr int kBBytes = kBK * BN * 2;           // 16 or 32 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  // + slack to align the ring to 1024 bytes, + the barriers
  static constexpr size_t kSmem =
      kSwizzleAtom + (size_t)kStages * kStageBytes + 2 * kStages * 8;
  using Atom = std::conditional_t<
      BN == 128,
      gmma::MMA_64x128x16_F32BF16BF16_SS<gmma::Major::K, gmma::Major::MN>,
      gmma::MMA_64x256x16_F32BF16BF16_SS<gmma::Major::K, gmma::Major::MN>>;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// box at (c0 innermost, c1) of `map` into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes, encoded in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <class Atom, size_t... I>
__device__ __forceinline__ void wgmma(uint64_t da, uint64_t db, float* d,
                                      std::index_sequence<I...>) {
  Atom::fma(da, db, d[I]...);                  // d += A . B
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One 128 x BN tile of C (split == 1) or of partial `blockIdx.z` (split > 1,
// fp32 into `part`, (split, M, N)).
template <int BN, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b, TO* __restrict__ c,
           float* __restrict__ part, int m, int n, int k_tiles, int split) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) &
      ~uintptr_t(kSwizzleAtom - 1));
  unsigned char* sa = ring;                            // [stage][128][64]
  unsigned char* sb = ring + C::kStages * C::kABytes;  // [stage][panel][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + C::kStages * C::kBBytes);
  uint64_t* empty = full + C::kStages;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int kt0 = (int)((long long)k_tiles * blockIdx.z / split);
  const int nk = (int)((long long)k_tiles * (blockIdx.z + 1) / split) - kt0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's arrive + tx
      mbar_init(&empty[s], kConsumers * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) mbar_wait(&empty[s], (i / C::kStages - 1) & 1);
        mbar_expect_tx(&full[s], C::kStageBytes);
        const int kc = (kt0 + i) * kBK;
        tma_load_2d(sa + s * C::kABytes, &map_a, &full[s], kc, m0);
#pragma unroll
        for (int p = 0; p < BN / kPanel; ++p)
          tma_load_2d(sb + s * C::kBBytes + p * kPanel * kBK * 2, &map_b,
                      &full[s], n0 + p * kPanel, kc);
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) ----
    const int wg = warp / 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::kStages;
      mbar_wait(&full[s], (i / C::kStages) & 1);
      const unsigned char* a = sa + s * C::kABytes + wg * 64 * 128;
      const unsigned char* b = sb + s * C::kBBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A, K-major: k16 is 32 bytes along the swizzled 128-byte row; the
        // next 8 rows are 1024 bytes on (SBO)
        const uint64_t da = desc_sw128(a + kk * 32, 16, kSwizzleAtom);
        // B, N-major: k16 is 16 rows of 128 bytes; the next 64-column panel
        // is kPanel * kBK * 2 bytes on (LBO), the next 8 k-rows 1024 (SBO)
        const uint64_t db = desc_sw128(b + kk * 16 * 128, kPanel * kBK * 2,
                                       kSwizzleAtom);
        wgmma<typename C::Atom>(da, db, acc,
                                std::make_index_sequence<BN / 2>{});
      }
      wgmma_commit();
      // keep this stage's group in flight under the next stage's wait; the
      // previous stage's group is done, so its buffers go back to TMA
      wgmma_wait<1>();
      if (i > 0) mbar_arrive(&empty[(i - 1) % C::kStages]);
    }
    wgmma_wait<0>();

    // accumulator fragment: register 4j + 2h + e holds row
    // 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the 64 x BN
    const int w = warp % 4, lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + w * 16 + lane / 4 + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * (lane % 4);
        if (col >= n) continue;                // N % 8 == 0: pairs whole
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (split == 1)
          store2<TO>(c + (size_t)row * n + col, x, y);
        else
          store2<float>(part + ((size_t)blockIdx.z * m + row) * n + col, x, y);
      }
    }
  }
}

// C = sum over the split partials in order, cast; four outputs a thread
template <typename TO>
__global__ void splitk_reduce(const float* __restrict__ part,
                              TO* __restrict__ c, long long mn, int split) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int p = 1; p < split; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(part + p * mn + i);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  store2<TO>(c + i, s.x, s.y);
  store2<TO>(c + i + 2, s.z, s.w);
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a row-major (outer, inner) bf16 matrix cut into (box_outer, box_inner)
// boxes, 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
              uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename TO>
cudaError_t launch(const void* a, const void* b, void* c, void* work, int m,
                   int n, int k, int split, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, k, m, kBK, kBM) ||
      !make_map(&map_b, b, n, k, kPanel, kBK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma<BN, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM, split);
  gemm_wgmma<BN, TO><<<grid, kThreads, smem, s>>>(
      map_a, map_b, static_cast<TO*>(c), static_cast<float*>(work), m, n,
      (k + kBK - 1) / kBK, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long mn = (long long)m * n;
  const int threads = 256;
  splitk_reduce<TO><<<(unsigned)((mn / 4 + threads - 1) / threads), threads,
                      0, s>>>(static_cast<const float*>(work),
                              static_cast<TO*>(c), mn, split);
  return cudaGetLastError();
}

}  // namespace

// a, b bf16 (M, K), (K, N) row-major with K % 8 == N % 8 == 0, 16-byte
// aligned; out_dtype 0 = float32, 1 = bfloat16; block_n 128 or 256; split
// >= 1 parts of the k tiles, `work` an fp32 (split, M, N) buffer when
// split > 1 (then two kernels are launched).
extern "C" int repro_matmul_wgmma(const void* a, const void* b, void* c,
                                  void* work, int m, int n, int k,
                                  int out_dtype, int block_n, int split,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n % 8 || k % 8 || k < 1 || split < 1 ||
      (block_n != 128 && block_n != 256) || (split > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (out_dtype * 2 + (block_n == 256)) {
    case 0: err = launch<128, float>(a, b, c, work, m, n, k, split, s); break;
    case 1: err = launch<256, float>(a, b, c, work, m, n, k, split, s); break;
    case 2:
      err = launch<128, __nv_bfloat16>(a, b, c, work, m, n, k, split, s);
      break;
    case 3:
      err = launch<256, __nv_bfloat16>(a, b, c, work, m, n, k, split, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dynamic shared memory of the GEMM kernel at tile width block_n, in bytes
extern "C" int repro_matmul_wgmma_smem(int block_n) {
  return block_n == 256 ? (int)Cfg<256>::kSmem : (int)Cfg<128>::kSmem;
}
