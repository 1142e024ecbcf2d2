// Flash attention forward (online softmax, causal + GQA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py and computes what it computes:
//   q (BH, Sq, D), k and v (BKV, Sk, D); query head bh reads kv head
//   bh / (BH / BKV); inputs upcast to fp32; fp32 scores, softmax and P.V;
//   online softmax from m = NEG_INF = -1e30; l == 0 guarded at the end;
//   causal mask on absolute positions q_offset + row; kv tiles above the
//   causal frontier of a query tile are never loaded (`n_live`); output
//   cast to q's dtype.
// Unlike the TPU kernel it masks ragged Sq / Sk edges instead of asserting
// that they divide the tiles: a serving batch pads prompts only to its
// longest prompt, so Sq = Sk = 200 is an ordinary prefill.
//
// What bounds it on the card: as written, the fp32 FMAs it issues and the
// shared-memory reads that feed them.  At prefill shapes attention is
// compute-bound (the bound is FLOPs over the bf16 tensor-core rate), and
// this first version does its products on the CUDA cores in fp32 -- the
// TPU kernel's f32 accumulation, kept exactly.  Design: one block of four
// warps per (bh, 64-row query tile); the scaled query tile is staged once in
// shared memory; each 32-key K/V tile is staged in shared memory as fp32
// (K rows padded by one float so that lane j reading row j is free of bank
// conflicts); lane j scores key j of the tile for one query row at a time,
// warp shuffles give the row max and sum, and each lane keeps D/32 output
// columns of each of its warp's 16 rows in registers.  wgmma and TMA are
// later work.
//
// C entry point (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the given stream; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                        // query rows per block
constexpr int kBK = 32;                        // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;     // 16
constexpr float kNegInf = -1e30f;              // NEG_INF of the TPU kernel

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // query tile [kBQ][D] + K tile [kBK][D + 1] + V tile [kBK][D], all fp32
  return sizeof(float) * (size_t)(kBQ * D + kBK * (D + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int sq,
          int sk, float scale, int causal, int q_offset) {
  constexpr int kCols = (D + 31) / 32;         // output columns per lane
  constexpr int kKStride = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                            // [kBQ][D], scaled
  float* ks = qs + kBQ * D;                    // [kBK][D + 1]
  float* vs = ks + kBK * kKStride;             // [kBK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + ((size_t)bh * sq + q0) * D;
  const T* kb = k + (size_t)(bh / group) * sk * D;
  const T* vb = v + (size_t)(bh / group) * sk * D;

  // rows past Sq are zero and never written back
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x)
    qs[i] = (q0 + i / D < sq) ? to_f32(qb[i]) * scale : 0.f;

  const int n_tiles = (sk + kBK - 1) / kBK;
  int n_live = n_tiles;
  if (causal) {
    // skip kv tiles strictly above the causal frontier of this query tile
    const int hi_pos = q_offset + min(q0 + kBQ, sq) - 1;
    n_live = min(hi_pos / kBK + 1, n_tiles);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_live; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      ks[r * kKStride + c] = in ? to_f32(kb[(size_t)k0 * D + i]) : 0.f;
      vs[i] = in ? to_f32(vb[(size_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const float* krow = ks + lane * kKStride;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q0 + row;
      if (qpos >= sq) continue;                // uniform across the warp
      const float* qrow = qs + row * D;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qrow[c], krow[c], s);
      const bool valid = key < sk && (!causal || key <= q_offset + qpos);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = vs + j * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = lane + 32 * c;
          if (col < D) acc[r][c] = fmaf(pj, vrow[col], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + ((size_t)bh * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) orow[col] = from_f32<T>(acc[r][c] / l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int bkv, int sq, int sk, float scale, int causal,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh / bkv, sq, sk, scale,
      causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int bkv, int sq, int sk, int d, float scale,
                     int causal, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous on the device.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int bh, int bkv, int sq, int sk, int d,
                                     float scale, int causal, int q_offset,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, o, bh, bkv, sq, sk, d, scale, causal, q_offset, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(q, k, v, o, bh, bkv, sq, sk, d, scale, causal, q_offset, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
