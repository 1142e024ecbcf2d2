// Flash attention (online softmax, causal + GQA) and its backward for
// Hopper, sm_90a.
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
// Both forward kernels write each row's fp32 log-sum-exp of the scaled
// scores when given an `lse` buffer (training; serving passes null).
//
// Backward (`repro_flash_attention_bwd`, training; the TPU kernel has none:
// the reference trains through XLA's autodiff of its einsum path).  FA2's
// algorithm at q_offset 0, causal or not, GQA, in three launches with no
// atomics, so a gradient is the same bits every run: D = rowsum(dO * O),
// then dK / dV with a block per (kv head, key tile) summing over its
// group's query heads and the q tiles from the causal frontier on, then dQ
// with a block per (query head, q tile) over its kv tiles up to the
// frontier.  Each rebuilds P = exp(scale * q.k - lse) from the forward's
// saved lse, so S x S never exists in memory; dS = P * (dP - D), dP =
// dO.v.  The entry point picks the kernels by dtype, as the forward:
//
// bf16, `flash_bwd_delta_mma` / `flash_bwd_dkv_mma` / `flash_bwd_dq_mma`
// (tensor cores).  What bounds it: at the train step's shape (q (128, 512,
// 128), kv (32, 512, 128), causal) the five products over the causal
// pairs are 2.2e10 FLOP, 3.0e10 with S and dP recomputed in both kernels
// (0.022-0.030 ms at 989 TFLOP/s), against ~84 MB moved (q, o, dO, dQ; k,
// v, dK, dV; lse: 0.025 ms at 3.35 TB/s): operations and bytes about
// even, so the products must run on the tensor cores and the tiles stay
// on chip.  The design is the
// forward's: mma.m16n8k16 (bf16 in, fp32 accumulate) on fragments from
// ldmatrix.x4, 64-row tiles staged by 16-byte cp.async copies (zero-filled
// past Sq / Sk) into rows padded by 16 bytes, 4 warps of 16 rows.
//   D: D / 8 lanes a row, one 16-byte access each, a butterfly.
//   dK / dV: K and V (64 keys) stay in shared memory; Q and dO tiles (and
//     64 lse, D) stream in double-buffered, lse and D through registers.
//     The products come out transposed, S^T = K.Q^T and dP^T = V.dO^T, so
//     a warp's rows are its 16 keys: P^T = exp2(S^T scale log2e - lse
//     log2e) and dS^T = P^T (dP^T - D) are formed on the accumulator
//     fragments and, rounded to bf16, are the A fragments of dV += P^T.dO
//     and dK += dS^T.Q (dO, Q by ldmatrix.x4.trans): no P or dS tile goes
//     to shared memory.  A q tile is taken 32 queries at a time: 128 dK /
//     dV accumulators and 32 of S^T / dP^T a thread at D = 128 (245
//     registers, no spills).  A chunk wholly above a warp's keys is skipped.
//   dQ: Q, dO, lse and D staged once; K / V tiles double-buffered up to
//     the frontier; S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K
//     (K by ldmatrix.x4.trans).
// Masks are applied only on tiles that cross the causal diagonal or a
// ragged edge.  Load balance: under the causal mask the first key tile
// sees 8x the q tiles of the last one at S 512, so the dK / dV grid puts
// the head on x and the key tile on y (the first key tiles of every head
// are handed out first) and the dQ grid hands out the last q tiles first.
// Numerics: P is rounded to bf16 before dV's product and dS before dK's
// and dQ's, as every tensor-core flash backward does; S, dP, D and every
// sum stay fp32.  As the forward's note says of P, that rounding adds at
// most 2^-9 relative to each term of a gradient's sum, under the
// gradient's own bf16 rounding (2^-8), so the bf16 tolerances hold as
// before: 1e-2 x max + 1e-2 |plain| on the card, 2e-2 under emulation.
//
// fp32, `flash_bwd_delta_f32` / `flash_bwd_dkv_tf32` / `flash_bwd_dq_tf32`
// (tensor cores in 3xTF32).  What bounds it: at the train step's shape
// the five products (3.0e10 FLOP with S and dP recomputed) take 0.45 ms on
// the fp32 CUDA cores (67 TFLOP/s); plain TF32 would break the fp32 checks
// (2^-11 relative a product), 3xTF32 keeps about 3 x 2^-22 (tc_sm80.cuh's
// note; fp32 rounds to 2^-24) at three tensor-core products a product:
// 9.0e10 FLOP, 0.18 ms at 495 TFLOP/s.  The design is the bf16 kernels'
// split, order, grids, masks and frontier, in fp32: 64-row tiles staged by
// 16-byte cp.async copies into rows padded by 4 floats (six tiles, 203 KB
// at D = 128: one block an SM), mma.m16n8k8 tf32 on fragments read from
// shared memory and split to hi / lo as they are loaded (`a_frag_tf32`,
// `b_frag_rows_tf32`).  The products' C fragments hold columns 2t, 2t + 1
// where an m16n8k8 A fragment wants t, t + 4, so P^T / dS^T (dK / dV) and
// dS (dQ) become A fragments in a permuted k order (`c_as_a_tf32`: slot t
// is column 2t, slot t + 4 column 2t + 1), and the B operand of those
// products -- dO and Q rows (dK / dV), K rows (dQ) -- is read in the same
// order (`b_frag_cols_tf32`: rows 2t and 2t + 1); the sum over k is the
// same.  With rows of D + 4 floats every fragment read is free of bank
// conflicts: A and n-major B reads fall on banks 4g + t, the permuted k-row
// reads on 8t + g.  dK / dV take 16 queries of S^T at a time and dQ 64
// keys of S (at D = 128: 128 and 64 fp32 accumulators, 255 and 242
// registers, no spills).  As in K2's tf32x3, the tensor core truncates
// each sum it adds into an accumulator to the accumulator's exponent, so
// dK, dV and dQ, summed over hundreds of products, take each chunk's
// products in fresh fragments added in fp32 (rounded to nearest).
//
// C entry points (bound with ctypes): return cudaGetLastError() after the
// launches; launch on the given stream; allocate nothing (the wrapper
// passes lse, and the backward's D as scratch).

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
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int group, int sq, int sk, float scale,
          int causal, int q_offset) {
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
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * sq + qpos] = m[r] + logf(l_safe);
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
                   float* lse, int bh, int bkv, int sq, int sk, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, bh / bkv, sq, sk,
      scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int bkv, int sq, int sk, int d,
                     float scale, int causal, int q_offset,
                     cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---- bf16: mma.sync + cp.async (see the header note) ----------------------

constexpr int kMmaBQ = 64;                     // query rows per block
constexpr int kMmaBK = 64;                     // keys per K / V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a tile of rows padded
// by 16 bytes, by 16-byte cp.async copies of the block's threads; rows past
// the edge are zero-filled
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int rows) {
  constexpr int kChunks = D / 8;               // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool in = r0 + r < rows;
    cp_async_16(dst + r * (D + 8) + ch * 8,
                src + (size_t)(in ? r0 + r : 0) * D + ch * 8, in ? 16 : 0);
  }
}

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
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              int group, int sq, int sk, float scale_log2, int causal,
              int q_offset) {
  constexpr int kS = D + 8;                    // padded row, elements
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

  const int n_tiles = (sk + kMmaBK - 1) / kMmaBK;
  int n_live = n_tiles;
  if (causal) {
    // skip kv tiles strictly above the causal frontier of this query tile
    const int hi_pos = q_offset + min(q0 + kMmaBQ, sq) - 1;
    n_live = min(hi_pos / kMmaBK + 1, n_tiles);
  }

  stage_rows<D>(qs, qb, q0, sq);
  stage_rows<D>(ks, kb, 0, sk);
  stage_rows<D>(vs, vb, 0, sk);
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
      stage_rows<D>(ks + (buf ^ 1) * kMmaBK * kS, kb, (t + 1) * kMmaBK, sk);
      stage_rows<D>(vs + (buf ^ 1) * kMmaBK * kS, vb, (t + 1) * kMmaBK, sk);
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
    // m and l are in the log2 domain: lse = ln(2^m * l)
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * sq + row] = (m[r] + log2f(l_safe)) * kLn2;
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
                       float* lse, int bh, int bkv, int sq, int sk,
                       float scale, int causal, int q_offset,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kMmaBQ - 1) / kMmaBQ, bh);
  flash_fwd_mma<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, bh / bkv, sq, sk, scale * kLog2e, causal, q_offset);
  return cudaGetLastError();
}

cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int bkv, int sq, int sk, int d,
                         float scale, int causal, int q_offset,
                         cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<16>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 32: return launch_mma<32>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 64: return launch_mma<64>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    case 128: return launch_mma<128>(q, k, v, o, lse, bh, bkv, sq, sk, scale, causal, q_offset, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---- bf16 backward: mma.sync + cp.async (see the header note) ------------

constexpr int kBwdThreads = 128;               // four warps
constexpr int kBwdTile = 64;                   // q rows and keys per tile
constexpr int kQC = 32;                        // q columns of S^T held at once

// D = rowsum(dO * O) in fp32 over bf16 rows of D elements: D / 8 lanes a
// row, one 16-byte access of each a lane (its eight products in order),
// then a butterfly over the row's lanes
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_mma(const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, long long rows) {
  constexpr int kLanes = D / 8;
  const long long row =
      ((long long)blockIdx.x * kBwdThreads + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  float s = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + c);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * D + c);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fa = __bfloat1622float2(ha[k]);
      const float2 fb = __bfloat1622float2(hb[k]);
      s = fmaf(fa.x, fb.x, s);
      s = fmaf(fa.y, fb.y, s);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) delta[row] = s;
}

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  // six bf16 tiles of 64 rows padded by 8 elements (dK / dV: K, V and two
  // each of Q and dO; dQ: Q, dO and two each of K and V) and two pairs of
  // 64 floats (lse in the log2 domain, D)
  return sizeof(__nv_bfloat16) * 6 * kBwdTile * (D + 8) +
         sizeof(float) * 4 * kBwdTile;
}

// dK and dV of one (kv head, 64-key tile): warp w owns keys 16w..16w+15 of
// the tile; the block walks its group's query heads in order, each over
// its 64-row q tiles from the causal frontier on, Q / dO double-buffered.
// S^T = K.Q^T and dP^T = V.dO^T come out with a warp's keys as rows, so
// P^T and dS^T are A fragments of dV += P^T.dO and dK += dS^T.Q as they
// stand in registers.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int group, int sq, int sk,
                  float scale, float scale_log2, int causal) {
  constexpr int kS = D + 8;                    // padded row, elements
  constexpr int kTileElems = kBwdTile * kS;
  constexpr int kKSteps = D / 16;              // k16 steps over the head dim
  constexpr int kCB = kQC / 8;                 // n8 blocks of a q chunk
  constexpr int kDBlocks = D / 8;              // n8 blocks of a dK / dV row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTileElems;
  __nv_bfloat16* qs = vs + kTileElems;         // [2][64][kS]
  __nv_bfloat16* dos = qs + 2 * kTileElems;    // [2][64][kS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileElems);  // [2][64]
  float* dl_s = lse_s + 2 * kBwdTile;                              // [2][64]

  const int kvh = blockIdx.x;
  // the first key tiles see the most q tiles: blockIdx.y 0 of every head
  // is handed out first
  const int k0 = blockIdx.y * kBwdTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;       // fragment row / column pair
  const int mi = lane / 8, mr = lane % 8;      // ldmatrix: matrix, row
  const int n_qt = (sq + kBwdTile - 1) / kBwdTile;
  const int qt0 = causal ? k0 / kBwdTile : 0;  // no query row below k0 sees it
  const int per_head = max(n_qt - qt0, 0);
  const int n_it = group * per_head;

  float dka[kDBlocks][4], dva[kDBlocks][4];
#pragma unroll
  for (int j = 0; j < kDBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // item it: query head kvh * group + it / per_head, q tile qt0 + it %
  // per_head; its Q and dO by cp.async, its lse and D through registers
  auto head_row = [&](int it) {
    return (size_t)(kvh * group + it / per_head) * sq;
  };
  auto q_row0 = [&](int it) { return (qt0 + it % per_head) * kBwdTile; };
  auto load_q = [&](int it, int b) {
    const size_t base = head_row(it) * D;
    stage_rows<D>(qs + b * kTileElems, q + base, q_row0(it), sq);
    stage_rows<D>(dos + b * kTileElems, dout + base, q_row0(it), sq);
  };
  // threads 0-63 carry lse (times log2 e), 64-127 D, of one row each
  auto fetch_stats = [&](int it) {
    const int r = q_row0(it) + (tid & 63);
    if (r >= sq) return 0.f;
    const size_t i = head_row(it) + r;
    return tid < 64 ? lse[i] * kLog2e : delta[i];
  };
  auto put_stats = [&](int b, float x) {
    (tid < 64 ? lse_s : dl_s)[b * kBwdTile + (tid & 63)] = x;
  };

  if (n_it > 0) {
    const size_t kv_base = (size_t)kvh * sk * D;
    stage_rows<D>(ks, k + kv_base, k0, sk);
    stage_rows<D>(vs, v + kv_base, k0, sk);
    load_q(0, 0);
    cp_async_commit();
    put_stats(0, fetch_stats(0));
  }
  for (int it = 0; it < n_it; ++it) {
    const int b = it & 1;
    float next = 0.f;
    if (it + 1 < n_it) {                       // prefetch item it + 1
      load_q(it + 1, b ^ 1);
      cp_async_commit();
      next = fetch_stats(it + 1);
      cp_async_wait<1>();                      // item it (and K, V) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = qs + b * kTileElems;
    const __nv_bfloat16* dot = dos + b * kTileElems;
    const float* ls = lse_s + b * kBwdTile;
    const float* dls = dl_s + b * kBwdTile;
    const int q0 = q_row0(it);
    // mask only a tile that crosses the causal diagonal or the ragged Sq
    // edge; keys past Sk are zero rows whose dK / dV are never written
    const bool edge = (causal && k0 + kBwdTile - 1 > q0) ||
                      q0 + kBwdTile > sq;

#pragma unroll
    for (int c = 0; c < kBwdTile / kQC; ++c) {
      const int qc0 = c * kQC;
      // a chunk whose queries all precede this warp's keys is all masked
      if (causal && q0 + qc0 + kQC - 1 < k0 + warp * 16) continue;
      float st[kCB][4], dpt[kCB][4];
#pragma unroll
      for (int j = 0; j < kCB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x kQC queries a warp
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t ka[4], va[4];
        const int a_off = (warp * 16 + (lane & 15)) * kS + kk * 16 +
                          (lane >> 4) * 8;
        ldmatrix_x4(ka, ks + a_off);
        ldmatrix_x4(va, vs + a_off);
#pragma unroll
        for (int j2 = 0; j2 < kCB / 2; ++j2) {
          // matrices: queries qc0 + j2*16 + {0..7, 8..15} x dims kk*16 +
          // {0..7, 8..15}
          uint32_t qb[4], ob[4];
          const int b_off = (qc0 + j2 * 16 + (mi >> 1) * 8 + mr) * kS +
                            kk * 16 + (mi & 1) * 8;
          ldmatrix_x4(qb, qt + b_off);
          ldmatrix_x4(ob, dot + b_off);
          mma_16816_bf16(st[2 * j2], ka, qb);
          mma_16816_bf16(st[2 * j2 + 1], ka, qb + 2);
          mma_16816_bf16(dpt[2 * j2], va, ob);
          mma_16816_bf16(dpt[2 * j2 + 1], va, ob + 2);
        }
      }
      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < kCB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc0 + j * 8 + 2 * t4 + (e & 1);
          float p = exp2f(st[j][e] * scale_log2 - ls[qi]);
          if (edge) {
            const int key = k0 + warp * 16 + g + 8 * (e >> 1);
            if (q0 + qi >= sq || (causal && key > q0 + qi)) p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dls[qi]);
        }
      }
      // dV += P^T.dO, dK += dS^T.Q over the chunk's queries: P^T and dS^T
      // rounded to bf16 are the A fragments, dO / Q by ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kQC / 16; ++kc) {
        const uint32_t pa[4] = {
            pack_bf16x2(st[2 * kc][0], st[2 * kc][1]),
            pack_bf16x2(st[2 * kc][2], st[2 * kc][3]),
            pack_bf16x2(st[2 * kc + 1][0], st[2 * kc + 1][1]),
            pack_bf16x2(st[2 * kc + 1][2], st[2 * kc + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16x2(dpt[2 * kc][0], dpt[2 * kc][1]),
            pack_bf16x2(dpt[2 * kc][2], dpt[2 * kc][3]),
            pack_bf16x2(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
            pack_bf16x2(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
        for (int j2 = 0; j2 < D / 16; ++j2) {
          // matrices: queries qc0 + kc*16 + {0..7, 8..15} x dims j2*16 +
          // {0..7, 8..15}
          uint32_t ob[4], qb[4];
          const int off = (qc0 + kc * 16 + (mi & 1) * 8 + mr) * kS +
                          j2 * 16 + (mi >> 1) * 8;
          ldmatrix_x4_trans(ob, dot + off);
          ldmatrix_x4_trans(qb, qt + off);
          mma_16816_bf16(dva[2 * j2], pa, ob);
          mma_16816_bf16(dva[2 * j2 + 1], pa, ob + 2);
          mma_16816_bf16(dka[2 * j2], sa, qb);
          mma_16816_bf16(dka[2 * j2 + 1], sa, qb + 2);
        }
      }
    }
    if (it + 1 < n_it) put_stats(b ^ 1, next);
    __syncthreads();   // item it consumed before it + 2 overwrites its buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= sk) continue;
    const size_t row = ((size_t)kvh * sk + key) * D;
#pragma unroll
    for (int j = 0; j < kDBlocks; ++j) {
      const int col = j * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(dka[j][2 * r] * scale,
                                dka[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// dQ of one (query head, 64-row q tile): warp w owns rows 16w..16w+15; Q,
// dO, lse and D staged once, K / V tiles double-buffered up to the causal
// frontier.  S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int group, int sq, int sk,
                 float scale, float scale_log2, int causal) {
  constexpr int kS = D + 8;
  constexpr int kTileElems = kBwdTile * kS;
  constexpr int kKSteps = D / 16;
  constexpr int kSBlocks = kBwdTile / 8;       // n8 blocks of a score row
  constexpr int kDBlocks = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTileElems;
  __nv_bfloat16* ks = dos + kTileElems;        // [2][64][kS]
  __nv_bfloat16* vs = ks + 2 * kTileElems;     // [2][64][kS]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTileElems);   // [64]
  float* dl_s = lse_s + kBwdTile;                                  // [64]

  const int bh = blockIdx.x;
  // the last q tiles cross the most kv tiles: hand them out first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const size_t q_base = (size_t)bh * sq;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * sk * D;

  const int n_kt = (sk + kBwdTile - 1) / kBwdTile;
  const int n_live = causal
      ? min((min(q0 + kBwdTile, sq) - 1) / kBwdTile + 1, n_kt) : n_kt;

  stage_rows<D>(qs, q + q_base * D, q0, sq);
  stage_rows<D>(dos, dout + q_base * D, q0, sq);
  stage_rows<D>(ks, kb, 0, sk);
  stage_rows<D>(vs, vb, 0, sk);
  cp_async_commit();
  {
    // rows past Sq: lse and D 0, with zero Q and dO their dS is 0
    const int r = q0 + (tid & 63);
    const float x = r >= sq ? 0.f
                  : tid < 64 ? lse[q_base + r] * kLog2e : delta[q_base + r];
    (tid < 64 ? lse_s : dl_s)[tid & 63] = x;
  }

  const int row0 = q0 + warp * 16 + g;         // this thread's rows: +0, +8
  float dqa[kDBlocks][4];
#pragma unroll
  for (int j = 0; j < kDBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int t = 0; t < n_live; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_live) {                      // prefetch tile t + 1
      stage_rows<D>(ks + (buf ^ 1) * kTileElems, kb, (t + 1) * kBwdTile, sk);
      stage_rows<D>(vs + (buf ^ 1) * kTileElems, vb, (t + 1) * kBwdTile, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * kTileElems;
    const __nv_bfloat16* vt = vs + buf * kTileElems;

    // S = Q.K^T and dP = dO.V^T: 16 rows x 64 keys a warp
    float s[kSBlocks][4], dp[kSBlocks][4];
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[4], oa[4];
      const int a_off = (warp * 16 + (lane & 15)) * kS + kk * 16 +
                        (lane >> 4) * 8;
      ldmatrix_x4(qa, qs + a_off);
      ldmatrix_x4(oa, dos + a_off);
#pragma unroll
      for (int j2 = 0; j2 < kSBlocks / 2; ++j2) {
        // matrices: keys j2*16 + {0..7, 8..15} x dims kk*16 + {0..7, 8..15}
        uint32_t kf[4], vf[4];
        const int b_off = (j2 * 16 + (mi >> 1) * 8 + mr) * kS + kk * 16 +
                          (mi & 1) * 8;
        ldmatrix_x4(kf, kt + b_off);
        ldmatrix_x4(vf, vt + b_off);
        mma_16816_bf16(s[2 * j2], qa, kf);
        mma_16816_bf16(s[2 * j2 + 1], qa, kf + 2);
        mma_16816_bf16(dp[2 * j2], oa, vf);
        mma_16816_bf16(dp[2 * j2 + 1], oa, vf + 2);
      }
    }
    // dS = P (dP - D), P = exp2(S scale log2e - lse log2e); mask only a tile
    // that crosses the causal diagonal or the ragged Sk edge
    const int k0 = t * kBwdTile;
    const bool edge = k0 + kBwdTile > sk ||
                      (causal && k0 + kBwdTile - 1 > q0);
    const float lr[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
    const float dr[2] = {dl_s[warp * 16 + g], dl_s[warp * 16 + g + 8]};
#pragma unroll
    for (int j = 0; j < kSBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lr[e >> 1]);
        if (edge) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          if (key >= sk || (causal && key > row0 + 8 * (e >> 1))) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dr[e >> 1]);
      }
    }
    // dQ += dS.K: dS rounded to bf16 is the A fragment, K by ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kBwdTile / 16; ++kc) {
      const uint32_t sa[4] = {
          pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < D / 16; ++j2) {
        // matrices: keys kc*16 + {0..7, 8..15} x dims j2*16 + {0..7, 8..15}
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, kt + (kc * 16 + (mi & 1) * 8 + mr) * kS +
                                  j2 * 16 + (mi >> 1) * 8);
        mma_16816_bf16(dqa[2 * j2], sa, kf);
        mma_16816_bf16(dqa[2 * j2 + 1], sa, kf + 2);
      }
    }
    __syncthreads();   // tile t consumed before t + 2 overwrites its buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* out = dq + (q_base + row) * D;
#pragma unroll
    for (int j = 0; j < kDBlocks; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dqa[j][2 * r] * scale,
                                dqa[j][2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* o, const float* lse, const void* dout,
                           void* dq, void* dk, void* dv, float* delta,
                           int bh, int bkv, int sq, int sk, float scale,
                           int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = bwd_mma_smem_bytes<D>();
  const int group = bh / bkv;
  const long long rows = (long long)bh * sq;
  const int delta_blocks = (int)((rows * (D / 8) + kBwdThreads - 1) /
                                 kBwdThreads);
  flash_bwd_delta_mma<D><<<delta_blocks, kBwdThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_mma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(bkv, (sk + kBwdTile - 1) / kBwdTile);
  flash_bwd_dkv_mma<D><<<grid_kv, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), group, sq, sk,
      scale, scale * kLog2e, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(bh, (sq + kBwdTile - 1) / kBwdTile);
  flash_bwd_dq_mma<D><<<grid_q, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), group, sq, sk, scale, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

cudaError_t launch_bwd_mma_d(const void* q, const void* k, const void* v,
                             const void* o, const float* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* delta, int bh, int bkv, int sq, int sk,
                             int d, float scale, int causal,
                             cudaStream_t stream) {
  switch (d) {
    case 16: return launch_bwd_mma<16>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 32: return launch_bwd_mma<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 64: return launch_bwd_mma<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 128: return launch_bwd_mma<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, bkv, sq, sk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---- fp32 backward: 3xTF32 mma.sync + cp.async (see the header note) ------

constexpr int kQC32 = 16;                      // q columns of S^T held at once
constexpr int kKC32 = 64;                      // key columns of S held at once

template <int D>
constexpr size_t bwd_tf32_smem_bytes() {
  // six fp32 tiles of 64 rows padded by 4 floats (as the bf16 kernels') and
  // two pairs of 64 floats (lse in the log2 domain, D)
  return sizeof(float) * (6 * kBwdTile * (D + 4) + 4 * kBwdTile);
}

// rows [r0, r0 + 64) of a (rows, D) fp32 matrix into a tile of rows padded
// by 4 floats, by 16-byte cp.async copies; rows past the edge zero-filled
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               int r0, int rows) {
  constexpr int kChunks = D / 4;               // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBwdTile * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool in = r0 + r < rows;
    cp_async_16(dst + r * (D + 4) + ch * 4,
                src + (size_t)(in ? r0 + r : 0) * D + ch * 4, in ? 16 : 0);
  }
}

// A fragment (16 x 8) of an fp32 tile of row stride S at rows r0.., columns
// c0..: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), split to hi / lo
template <int S>
__device__ __forceinline__ void a_frag_tf32(const float* tile, int r0, int c0,
                                            uint32_t h[4], uint32_t l[4]) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (r0 + lane / 4) * S + c0 + lane % 4;
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[8 * S], h[1], l[1]);
  split_tf32(p[4], h[2], l[2]);
  split_tf32(p[8 * S + 4], h[3], l[3]);
}

// B fragment (8 x 8, k down) whose n runs along the tile's rows r0.. and k
// along its columns c0..: b0 (k t, n g) = tile[r0 + g][c0 + t], b1 (k t +
// 4), split
template <int S>
__device__ __forceinline__ void b_frag_rows_tf32(const float* tile, int r0,
                                                 int c0, uint32_t h[2],
                                                 uint32_t l[2]) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (r0 + lane / 4) * S + c0 + lane % 4;
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[4], h[1], l[1]);
}

// B fragment whose k runs along the tile's rows r0.. in the permuted order
// (slot t is row 2t, slot t + 4 row 2t + 1) and n along its columns c0..:
// b0 = tile[r0 + 2t][c0 + g], b1 = tile[r0 + 2t + 1][c0 + g], split
template <int S>
__device__ __forceinline__ void b_frag_cols_tf32(const float* tile, int r0,
                                                 int c0, uint32_t h[2],
                                                 uint32_t l[2]) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (r0 + 2 * (lane % 4)) * S + c0 + lane / 4;
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[S], h[1], l[1]);
}

// A C fragment (16 x 8) reused as an A fragment of the next product in the
// permuted k order: a = {c0, c2, c1, c3}, split
__device__ __forceinline__ void c_as_a_tf32(const float c[4], uint32_t h[4],
                                            uint32_t l[4]) {
  split_tf32(c[0], h[0], l[0]);
  split_tf32(c[2], h[1], l[1]);
  split_tf32(c[1], h[2], l[2]);
  split_tf32(c[3], h[3], l[3]);
}

// D = rowsum(dO * O) in fp32 over fp32 rows of D elements: D / 4 lanes a
// row, one 16-byte access of each a lane (its four products in order),
// then a butterfly over the row's lanes
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_f32(const float* __restrict__ o,
                    const float* __restrict__ dout,
                    float* __restrict__ delta, long long rows) {
  constexpr int kLanes = D / 4;
  const long long row =
      ((long long)blockIdx.x * kBwdThreads + threadIdx.x) / kLanes;
  const int c = (threadIdx.x % kLanes) * 4;
  float s = 0.f;
  if (row < rows) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * D + c);
    const float4 b = *reinterpret_cast<const float4*>(dout + row * D + c);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) delta[row] = s;
}

// dK and dV of one (kv head, 64-key tile), as flash_bwd_dkv_mma in fp32:
// warp w owns keys 16w..16w+15; Q / dO double-buffered; S^T = K.Q^T and
// dP^T = V.dO^T by 3xTF32 m16n8k8 (K / V rows the A fragments, Q / dO rows
// the B fragments' n); P^T and dS^T are the A fragments of dV += P^T.dO
// and dK += dS^T.Q in the permuted k order, dO / Q rows loaded in the same
// order (b_frag_cols_tf32).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int group, int sq, int sk,
                   float scale, float scale_log2, int causal) {
  constexpr int kS = D + 4;                    // padded row: banks 4g + t
  constexpr int kTileElems = kBwdTile * kS;
  constexpr int kCB = kQC32 / 8;               // n8 blocks of a q chunk
  constexpr int kDBlocks = D / 8;              // n8 blocks of a dK / dV row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTileElems;
  float* qs = vs + kTileElems;                 // [2][64][kS]
  float* dos = qs + 2 * kTileElems;            // [2][64][kS]
  float* lse_s = dos + 2 * kTileElems;         // [2][64]
  float* dl_s = lse_s + 2 * kBwdTile;          // [2][64]

  const int kvh = blockIdx.x;
  // the first key tiles see the most q tiles: blockIdx.y 0 of every head
  // is handed out first
  const int k0 = blockIdx.y * kBwdTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_qt = (sq + kBwdTile - 1) / kBwdTile;
  const int qt0 = causal ? k0 / kBwdTile : 0;
  const int per_head = max(n_qt - qt0, 0);
  const int n_it = group * per_head;

  float dka[kDBlocks][4], dva[kDBlocks][4];
#pragma unroll
  for (int j = 0; j < kDBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  auto head_row = [&](int it) {
    return (size_t)(kvh * group + it / per_head) * sq;
  };
  auto q_row0 = [&](int it) { return (qt0 + it % per_head) * kBwdTile; };
  auto load_q = [&](int it, int b) {
    const size_t base = head_row(it) * D;
    stage_rows_f32<D>(qs + b * kTileElems, q + base, q_row0(it), sq);
    stage_rows_f32<D>(dos + b * kTileElems, dout + base, q_row0(it), sq);
  };
  auto fetch_stats = [&](int it) {
    const int r = q_row0(it) + (tid & 63);
    if (r >= sq) return 0.f;
    const size_t i = head_row(it) + r;
    return tid < 64 ? lse[i] * kLog2e : delta[i];
  };
  auto put_stats = [&](int b, float x) {
    (tid < 64 ? lse_s : dl_s)[b * kBwdTile + (tid & 63)] = x;
  };

  if (n_it > 0) {
    const size_t kv_base = (size_t)kvh * sk * D;
    stage_rows_f32<D>(ks, k + kv_base, k0, sk);
    stage_rows_f32<D>(vs, v + kv_base, k0, sk);
    load_q(0, 0);
    cp_async_commit();
    put_stats(0, fetch_stats(0));
  }
  for (int it = 0; it < n_it; ++it) {
    const int b = it & 1;
    float next = 0.f;
    if (it + 1 < n_it) {                       // prefetch item it + 1
      load_q(it + 1, b ^ 1);
      cp_async_commit();
      next = fetch_stats(it + 1);
      cp_async_wait<1>();                      // item it (and K, V) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + b * kTileElems;
    const float* dot = dos + b * kTileElems;
    const float* ls = lse_s + b * kBwdTile;
    const float* dls = dl_s + b * kBwdTile;
    const int q0 = q_row0(it);
    const bool edge = (causal && k0 + kBwdTile - 1 > q0) ||
                      q0 + kBwdTile > sq;

#pragma unroll 1
    for (int c = 0; c < kBwdTile / kQC32; ++c) {
      const int qc0 = c * kQC32;
      // a chunk whose queries all precede this warp's keys is all masked
      if (causal && q0 + qc0 + kQC32 - 1 < k0 + warp * 16) continue;
      float st[kCB][4], dpt[kCB][4];
#pragma unroll
      for (int j = 0; j < kCB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x kQC32 queries a warp
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        a_frag_tf32<kS>(ks, warp * 16, kk, kh, kl);
        a_frag_tf32<kS>(vs, warp * 16, kk, vh, vl);
#pragma unroll
        for (int j = 0; j < kCB; ++j) {
          uint32_t qh[2], ql[2], oh[2], ol[2];
          b_frag_rows_tf32<kS>(qt, qc0 + j * 8, kk, qh, ql);
          b_frag_rows_tf32<kS>(dot, qc0 + j * 8, kk, oh, ol);
          mma_1688_3xtf32(st[j], kh, kl, qh, ql);
          mma_1688_3xtf32(dpt[j], vh, vl, oh, ol);
        }
      }
      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < kCB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc0 + j * 8 + 2 * t4 + (e & 1);
          float p = exp2f(st[j][e] * scale_log2 - ls[qi]);
          if (edge) {
            const int key = k0 + warp * 16 + g + 8 * (e >> 1);
            if (q0 + qi >= sq || (causal && key > q0 + qi)) p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dls[qi]);
        }
      }
      // dV += P^T.dO, dK += dS^T.Q: n8 block j of the chunk is a k8 step;
      // P^T / dS^T in the permuted order, dO / Q rows likewise.  The
      // chunk's products go into fresh fragments, added to dK / dV in fp32
      // (the tensor core truncates what it adds into an accumulator)
      uint32_t ph[kCB][4], pl[kCB][4], sh[kCB][4], sl[kCB][4];
#pragma unroll
      for (int j = 0; j < kCB; ++j) {
        c_as_a_tf32(st[j], ph[j], pl[j]);
        c_as_a_tf32(dpt[j], sh[j], sl[j]);
      }
#pragma unroll
      for (int n = 0; n < kDBlocks; ++n) {
        float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kCB; ++j) {
          uint32_t oh[2], ol[2], qh[2], ql[2];
          b_frag_cols_tf32<kS>(dot, qc0 + j * 8, n * 8, oh, ol);
          b_frag_cols_tf32<kS>(qt, qc0 + j * 8, n * 8, qh, ql);
          mma_1688_3xtf32(tv, ph[j], pl[j], oh, ol);
          mma_1688_3xtf32(tk, sh[j], sl[j], qh, ql);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[n][e] += tv[e];
          dka[n][e] += tk[e];
        }
      }
    }
    if (it + 1 < n_it) put_stats(b ^ 1, next);
    __syncthreads();   // item it consumed before it + 2 overwrites its buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= sk) continue;
    const size_t row = ((size_t)kvh * sk + key) * D;
#pragma unroll
    for (int j = 0; j < kDBlocks; ++j) {
      const int col = j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(dk + row + col) =
          float2{dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale};
      *reinterpret_cast<float2*>(dv + row + col) =
          float2{dva[j][2 * r], dva[j][2 * r + 1]};
    }
  }
}

// dQ of one (query head, 64-row q tile), as flash_bwd_dq_mma in fp32: warp
// w owns rows 16w..16w+15; K / V tiles double-buffered up to the causal
// frontier, taken 64 keys at a time; S = Q.K^T, dP = dO.V^T, dS in
// registers; dQ += dS.K with dS in the permuted k order, K's rows likewise.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int group, int sq, int sk, float scale, float scale_log2,
                  int causal) {
  constexpr int kS = D + 4;
  constexpr int kTileElems = kBwdTile * kS;
  constexpr int kSB = kKC32 / 8;               // n8 blocks of a key chunk
  constexpr int kDBlocks = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTileElems;
  float* ks = dos + kTileElems;                // [2][64][kS]
  float* vs = ks + 2 * kTileElems;             // [2][64][kS]
  float* lse_s = vs + 2 * kTileElems;          // [64]
  float* dl_s = lse_s + kBwdTile;              // [64]

  const int bh = blockIdx.x;
  // the last q tiles cross the most kv tiles: hand them out first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t q_base = (size_t)bh * sq;
  const float* kb = k + (size_t)(bh / group) * sk * D;
  const float* vb = v + (size_t)(bh / group) * sk * D;

  const int n_kt = (sk + kBwdTile - 1) / kBwdTile;
  const int n_live = causal
      ? min((min(q0 + kBwdTile, sq) - 1) / kBwdTile + 1, n_kt) : n_kt;

  stage_rows_f32<D>(qs, q + q_base * D, q0, sq);
  stage_rows_f32<D>(dos, dout + q_base * D, q0, sq);
  stage_rows_f32<D>(ks, kb, 0, sk);
  stage_rows_f32<D>(vs, vb, 0, sk);
  cp_async_commit();
  {
    // rows past Sq: lse and D 0, with zero Q and dO their dS is 0
    const int r = q0 + (tid & 63);
    const float x = r >= sq ? 0.f
                  : tid < 64 ? lse[q_base + r] * kLog2e : delta[q_base + r];
    (tid < 64 ? lse_s : dl_s)[tid & 63] = x;
  }

  const int row0 = q0 + warp * 16 + g;         // this thread's rows: +0, +8
  float dqa[kDBlocks][4];
#pragma unroll
  for (int j = 0; j < kDBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  for (int t = 0; t < n_live; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_live) {                      // prefetch tile t + 1
      stage_rows_f32<D>(ks + (buf ^ 1) * kTileElems, kb, (t + 1) * kBwdTile,
                        sk);
      stage_rows_f32<D>(vs + (buf ^ 1) * kTileElems, vb, (t + 1) * kBwdTile,
                        sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * kTileElems;
    const float* vt = vs + buf * kTileElems;
    const int k0 = t * kBwdTile;
    const bool edge = k0 + kBwdTile > sk ||
                      (causal && k0 + kBwdTile - 1 > q0);
    const float lr[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
    const float dr[2] = {dl_s[warp * 16 + g], dl_s[warp * 16 + g + 8]};

#pragma unroll 1
    for (int c = 0; c < kBwdTile / kKC32; ++c) {
      const int kc0 = c * kKC32;
      // a chunk whose keys all follow this warp's rows is all masked
      if (causal && k0 + kc0 > q0 + warp * 16 + 15) continue;
      // S = Q.K^T and dP = dO.V^T: 16 rows x 64 keys a warp
      float s[kSB][4], dp[kSB][4];
#pragma unroll
      for (int j = 0; j < kSB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        a_frag_tf32<kS>(qs, warp * 16, kk, qh, ql);
        a_frag_tf32<kS>(dos, warp * 16, kk, oh, ol);
#pragma unroll
        for (int j = 0; j < kSB; ++j) {
          uint32_t kh[2], kl[2], vh[2], vl[2];
          b_frag_rows_tf32<kS>(kt, kc0 + j * 8, kk, kh, kl);
          b_frag_rows_tf32<kS>(vt, kc0 + j * 8, kk, vh, vl);
          mma_1688_3xtf32(s[j], qh, ql, kh, kl);
          mma_1688_3xtf32(dp[j], oh, ol, vh, vl);
        }
      }
      // dS = P (dP - D), P = exp2(S scale log2e - lse log2e)
#pragma unroll
      for (int j = 0; j < kSB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[j][e] * scale_log2 - lr[e >> 1]);
          if (edge) {
            const int key = k0 + kc0 + j * 8 + 2 * t4 + (e & 1);
            if (key >= sk || (causal && key > row0 + 8 * (e >> 1))) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      }
      // dQ += dS.K: n8 block j of the chunk is a k8 step; dS in the
      // permuted order, K's rows likewise; the chunk's products go into a
      // fresh fragment, added to dQ in fp32
      uint32_t sh[kSB][4], sl[kSB][4];
#pragma unroll
      for (int j = 0; j < kSB; ++j) c_as_a_tf32(s[j], sh[j], sl[j]);
#pragma unroll
      for (int n = 0; n < kDBlocks; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kSB; ++j) {
          uint32_t kh[2], kl[2];
          b_frag_cols_tf32<kS>(kt, kc0 + j * 8, n * 8, kh, kl);
          mma_1688_3xtf32(t, sh[j], sl[j], kh, kl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] += t[e];
      }
    }
    __syncthreads();   // tile t consumed before t + 2 overwrites its buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    float* out = dq + (q_base + row) * D;
#pragma unroll
    for (int j = 0; j < kDBlocks; ++j)
      *reinterpret_cast<float2*>(out + j * 8 + 2 * t4) =
          float2{dqa[j][2 * r] * scale, dqa[j][2 * r + 1] * scale};
  }
}

template <int D>
cudaError_t launch_bwd_tf32(const float* q, const float* k, const float* v,
                            const float* o, const float* lse,
                            const float* dout, float* dq, float* dk,
                            float* dv, float* delta, int bh, int bkv, int sq,
                            int sk, float scale, int causal,
                            cudaStream_t stream) {
  constexpr size_t smem = bwd_tf32_smem_bytes<D>();
  const int group = bh / bkv;
  const long long rows = (long long)bh * sq;
  const int delta_blocks = (int)((rows * (D / 4) + kBwdThreads - 1) /
                                 kBwdThreads);
  flash_bwd_delta_f32<D><<<delta_blocks, kBwdThreads, 0, stream>>>(
      o, dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tf32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tf32<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(bkv, (sk + kBwdTile - 1) / kBwdTile);
  flash_bwd_dkv_tf32<D><<<grid_kv, kWarps * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, group, sq, sk, scale,
      scale * kLog2e, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(bh, (sq + kBwdTile - 1) / kBwdTile);
  flash_bwd_dq_tf32<D><<<grid_q, kWarps * 32, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, group, sq, sk, scale, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tf32_d(const void* q, const void* k, const void* v,
                              const void* o, const float* lse,
                              const void* dout, void* dq, void* dk, void* dv,
                              float* delta, int bh, int bkv, int sq, int sk,
                              int d, float scale, int causal,
                              cudaStream_t stream) {
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(o);
  const float* fdo = static_cast<const float*>(dout);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  switch (d) {
    case 16: return launch_bwd_tf32<16>(fq, fk, fv, fo, lse, fdo, gq, gk, gv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 32: return launch_bwd_tf32<32>(fq, fk, fv, fo, lse, fdo, gq, gk, gv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 64: return launch_bwd_tf32<64>(fq, fk, fv, fo, lse, fdo, gq, gk, gv, delta, bh, bkv, sq, sk, scale, causal, stream);
    case 128: return launch_bwd_tf32<128>(fq, fk, fv, fo, lse, fdo, gq, gk, gv, delta, bh, bkv, sq, sk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the mma kernel).
// q, k, v, o contiguous on the device.  lse: null, or fp32 (bh, sq) that
// receives each row's log-sum-exp of the scaled scores (what the backward
// needs); the serving path passes null.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int dtype, int bh, int bkv, int sq,
                                     int sk, int d, float scale, int causal,
                                     int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, o, l, bh, bkv, sq, sk, d, scale, causal, q_offset, s);
      break;
    case 1:
      err = launch_mma_d(q, k, v, o, l, bh, bkv, sq, sk, d, scale, causal, q_offset, s);
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

// dynamic shared memory of each bf16 (mma) backward kernel at head dim d
extern "C" int repro_flash_attention_bwd_mma_smem(int d) {
  switch (d) {
    case 16: return (int)bwd_mma_smem_bytes<16>();
    case 32: return (int)bwd_mma_smem_bytes<32>();
    case 64: return (int)bwd_mma_smem_bytes<64>();
    case 128: return (int)bwd_mma_smem_bytes<128>();
    default: return -1;
  }
}

// The backward of the forward above at q_offset 0: dq (bh, sq, d), dk and
// dv (bkv, sk, d) in the inputs' dtype (0 = float32, 1 = bfloat16) from q,
// k, v, the forward's output o and fp32 lse (bh, sq), and the output
// gradient dout; `delta` is fp32 scratch of bh * sq.  Three launches on
// the given stream (D, then dK / dV, then dQ); no atomics.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         void* delta, int dtype, int bh,
                                         int bkv, int sq, int sk, int d,
                                         float scale, int causal,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || bkv <= 0 || bh % bkv || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_bwd_tf32_d(q, k, v, o, l, dout, dq, dk, dv, dl, bh, bkv, sq, sk, d, scale, causal, s);
      break;
    case 1:
      err = launch_bwd_mma_d(q, k, v, o, l, dout, dq, dk, dv, dl, bh, bkv, sq, sk, d, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
