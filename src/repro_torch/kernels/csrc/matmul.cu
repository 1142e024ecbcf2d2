// Tiled matrix product C = A @ B for Hopper, sm_90a (K2 of the port).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` in
// src/repro/kernels/matmul.py and computes what it computes: A (M, K) and
// B (K, N), both float32 or both bfloat16, row-major; products accumulated
// in fp32; the sum cast once to the output type (float32 or bfloat16) at
// the end.  Unlike the TPU kernel it masks ragged M / N / K edges (loads
// past an edge read zero, stores past an edge are skipped) instead of
// asserting that the shapes divide the tiles: the port's projections see
// M = batch x prompt length, which no tile divides in general.
//
// What bounds it on the card: at the port's projection shapes the product
// is bound by operations (in bf16 the bound is FLOPs over the tensor-core
// rate), and this first version does its products on the CUDA cores in
// fp32, the TPU kernel's f32 accumulation kept exactly.  Design: the
// classic register-blocked SIMT GEMM.  One block of 256 threads computes a
// 128 x 128 tile of C; each k step stages a 128 x 8 slice of A (stored
// transposed) and an 8 x 128 slice of B in shared memory as fp32; each
// thread keeps an 8 x 8 fp32 accumulator in registers, for rows
// ty + 16 i and columns tx + 16 j, so that a warp's shared-memory reads
// fall on distinct banks or broadcast.  wgmma, TMA and a multi-stage ring
// are later work.
//
// C entry point (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the given stream; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
constexpr int kTM = 8;           // rows per thread (stride 16)
constexpr int kTN = 8;           // columns per thread (stride 16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
              TO* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kBK][kBM + 4];           // A slice, transposed
  __shared__ float bs[kBK][kBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, q = e % kBK;
      const int gr = row0 + r, gq = k0 + q;
      as[q][r] = (gr < m && gq < k) ? to_f32(a[(size_t)gr * k + gq]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int q = e / kBN, col = e % kBN;
      const int gq = k0 + q, gc = col0 + col;
      bs[q][col] = (gq < k && gc < n) ? to_f32(b[(size_t)gq * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[q][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < n) c[(size_t)gr * n + gc] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n,
                   int k, cudaStream_t s) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TI, TO><<<grid, kThreads, 0, s>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b),
      static_cast<TO*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m,
                            int n, int k, int in_dtype, int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (in_dtype * 2 + out_dtype) {
    case 0: err = launch<float, float>(a, b, c, m, n, k, s); break;
    case 1: err = launch<float, __nv_bfloat16>(a, b, c, m, n, k, s); break;
    case 2: err = launch<__nv_bfloat16, float>(a, b, c, m, n, k, s); break;
    case 3:
      err = launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
