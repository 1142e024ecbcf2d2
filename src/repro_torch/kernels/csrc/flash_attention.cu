// Flash attention forward (online softmax, causal + GQA) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention.py and computes what it computes:
//   q (BH, Sq, D), k and v (BKV, Sk, D); query head bh reads kv head
//   bh / (BH / BKV); fp32 scores, softmax and accumulation; online softmax
//   from m = NEG_INF = -1e30; l == 0 guarded at the end; causal mask on
//   absolute positions q_offset + row; kv tiles above the causal frontier of
//   a query tile are never loaded (`n_live`); output cast to q's dtype.
// Unlike the TPU kernel it masks ragged Sq / Sk edges instead of asserting
// that they divide the tiles: a serving batch pads prompts only to its
// longest prompt, so Sq = Sk = 200 is an ordinary prefill.
//
// Two kernels; the C entry point picks one by dtype, nothing else:
//
// bf16, `flash_fwd_mma` (FA2-style, tensor cores).  At the serving prefill
// (BH 128, S 200, D 128) attention is ~1.3 GFLOP against a byte bound of
// ~5 us: what bounds it is latency and occupancy, not the tensor-core
// rate, so the warp-level mma.sync (fragments in registers, no warpgroup
// barriers) suits it.  One block of 4 warps per (bh, 64-row query tile),
// each warp owning 16 rows.  Q (64 x D) and 64-key K / V tiles are staged
// in shared memory as bf16 by 16-byte cp.async copies (zero-filled past
// Sq / Sk), K / V double-buffered so that tile t+1 loads while tile t
// computes.  Rows are padded by 16 bytes, so that the 8 rows an ldmatrix
// reads fall on distinct banks (~85 KB at D = 128, opted in by
// cudaFuncSetAttribute).  S = Q.K^T by mma.m16n8k16 (bf16 in, fp32
// accumulate), Q / K fragments by ldmatrix.x4; the online softmax runs on
// the accumulator fragments in the log2 domain (a row's 64 scores sit in a
// quad of lanes: two xor-shuffles); P is rounded to bf16 in registers and
// reused directly as the A operand of P.V, whose V fragments come from
// ldmatrix.x4.trans; O accumulates in fp32.  Masks are applied only on
// tiles that cross the causal diagonal or the ragged Sk edge.
// Numerics: P is rounded to bf16 before P.V, as every tensor-core flash
// attention does, while the TPU kernel and the plain version keep P in
// fp32.  That rounding adds at most 2^-9 relative to each term of a convex
// combination of V rows, below the output's own bf16 rounding (2^-8), so
// the bf16 tolerance 1e-2 + 1e-2 |ref| holds as before.
//
// fp32, `flash_fwd` (SIMT, the first version, unchanged).  Its products
// run on the CUDA cores in fp32: TF32 would break the fp32 checks.  One
// block of four warps per (bh, 64-row query tile); the scaled query tile
// staged once in shared memory; each 32-key K/V tile staged in shared
// memory as fp32 (K rows padded by one float so that lane j reading row j
// is free of bank conflicts); lane j scores key j of the tile for one query
// row at a time, warp shuffles give the row max and sum, and each lane
// keeps D/32 output columns of each of its warp's 16 rows in registers.
//
// C entry point (bound with ctypes): returns cudaGetLastError() after the
// launch; launches on the given stream; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_sm80.cuh"

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


// ---- bf16: mma.sync + cp.async (see the header note) ----------------------

constexpr int kMmaBQ = 64;                     // query rows per block
constexpr int kMmaBK = 64;                     // keys per K / V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q tile + two K tiles + two V tiles, bf16 rows padded by 8 elements
  return sizeof(__nv_bfloat16) * (size_t)(kMmaBQ + 4 * kMmaBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int group, int sq, int sk,
              float scale_log2, int causal, int q_offset) {
  constexpr int kS = D + 8;                    // padded row, elements
  constexpr int kChunks = D / 8;               // 16-byte chunks per row
  constexpr int kKSteps = D / 16;              // k16 steps of Q.K^T
  constexpr int kSBlocks = kMmaBK / 8;         // n8 blocks of a score row
  constexpr int kOBlocks = D / 8;              // n8 blocks of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * kS;        // [2][kMmaBK][kS]
  __nv_bfloat16* vs = ks + 2 * kMmaBK * kS;    // [2][kMmaBK][kS]

  const int bh = blockIdx.y;
  // the last query tiles cross the most causal kv tiles: run them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;       // fragment row / column pair
  const int mi = lane / 8, mr = lane % 8;      // ldmatrix: matrix, row
  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * sk * D;

  // rows [r0, r0 + 64) of a (rows, D) matrix into a padded tile; rows past
  // the edge are zero-filled
  auto stage = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                   int rows) {
    for (int c = tid; c < 64 * kChunks; c += kWarps * 32) {
      const int r = c / kChunks, ch = c % kChunks;
      const bool in = r0 + r < rows;
      cp_async_16(dst + r * kS + ch * 8,
                  src + (size_t)(in ? r0 + r : 0) * D + ch * 8, in ? 16 : 0);
    }
  };

  const int n_tiles = (sk + kMmaBK - 1) / kMmaBK;
  int n_live = n_tiles;
  if (causal) {
    // skip kv tiles strictly above the causal frontier of this query tile
    const int hi_pos = q_offset + min(q0 + kMmaBQ, sq) - 1;
    n_live = min(hi_pos / kMmaBK + 1, n_tiles);
  }

  stage(qs, qb, q0, sq);
  stage(ks, kb, 0, sk);
  stage(vs, vb, 0, sk);
  cp_async_commit();

  // this thread's two query rows (fragment rows g and g + 8)
  const int row0 = q0 + warp * 16 + g;
  const int qpos[2] = {q_offset + row0, q_offset + row0 + 8};
  uint32_t qf[kKSteps][4];
  float acc[kOBlocks][4];
#pragma unroll
  for (int j = 0; j < kOBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                     // this lane's partial sums

  for (int t = 0; t < n_live; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_live) {                      // prefetch tile t + 1
      stage(ks + (buf ^ 1) * kMmaBK * kS, kb, (t + 1) * kMmaBK, sk);
      stage(vs + (buf ^ 1) * kMmaBK * kS, vb, (t + 1) * kMmaBK, sk);
      cp_async_commit();
      cp_async_wait<1>();                      // tile t (and Q) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kS + kk * 16
                                + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + buf * kMmaBK * kS;
    const __nv_bfloat16* vt = vs + buf * kMmaBK * kS;

    // S = Q . K^T: 16 rows x 64 keys per warp
    float s[kSBlocks][4];
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < kSBlocks / 2; ++j2) {
        // matrices: keys j2*16 + {0..7, 8..15} x dims kk*16 + {0..7, 8..15}
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (j2 * 16 + (mi >> 1) * 8 + mr) * kS + kk * 16
                            + (mi & 1) * 8);
        mma_16816_bf16(s[2 * j2], qf[kk], kf);
        mma_16816_bf16(s[2 * j2 + 1], qf[kk], kf + 2);
      }
    }

    // scale into the log2 domain; mask only a tile that crosses the causal
    // diagonal of this query tile or the ragged Sk edge
    const int k0 = t * kMmaBK;
    const bool edge = k0 + kMmaBK > sk ||
                      (causal && k0 + kMmaBK - 1 > q_offset + q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          if (key >= sk || (causal && key > qpos[e >> 1])) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score contributes exactly 0, as in the SIMT kernel
        const float p = s[j][e] == kNegInf ? 0.f
                                           : exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < kOBlocks; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P . V: P's accumulator fragments are its A fragments
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < kOBlocks / 2; ++j2) {
        // matrices: keys kc*16 + {0..7, 8..15} x dims j2*16 + {0..7, 8..15}
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kc * 16 + (mi & 1) * 8 + mr) * kS
                                  + j2 * 16 + (mi >> 1) * 8);
        mma_16816_bf16(acc[2 * j2], pa, vf);
        mma_16816_bf16(acc[2 * j2 + 1], pa, vf + 2);
      }
    }
    __syncthreads();   // tile t consumed before t + 2 overwrites its buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + ((size_t)bh * sq + row) * D;
#pragma unroll
    for (int j = 0; j < kOBlocks; ++j) {
      const int col = j * 8 + 2 * t4;
      orow[col] = __float2bfloat16(acc[j][2 * r] / l_safe);
      orow[col + 1] = __float2bfloat16(acc[j][2 * r + 1] / l_safe);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int bh, int bkv, int sq, int sk, float scale,
                       int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kMmaBQ - 1) / kMmaBQ, bh);
  flash_fwd_mma<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      bh / bkv, sq, sk, scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o,
                         int bh, int bkv, int sq, int sk, int d, float scale,
                         int causal, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 32: return launch_mma<32>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 64: return launch_mma<64>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 128: return launch_mma<128>(q, k, v, o, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the mma kernel).
// q, k, v, o contiguous on the device.
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
      err = launch_mma_d(q, k, v, o, bh, bkv, sq, sk, d, scale, causal, q_offset, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dynamic shared memory of the bf16 (mma) kernel at head dim d, in bytes
extern "C" int repro_flash_attention_mma_smem(int d) {
  switch (d) {
    case 16: return (int)mma_smem_bytes<16>();
    case 32: return (int)mma_smem_bytes<32>();
    case 64: return (int)mma_smem_bytes<64>();
    case 128: return (int)mma_smem_bytes<128>();
    default: return -1;
  }
}
