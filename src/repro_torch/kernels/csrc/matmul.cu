// Matrix product C = A @ B for Hopper, sm_90a (K2 of the port): the
// kernels for the products that the wgmma + TMA kernel (matmul_wgmma.cu)
// does not take -- fp32 inputs, and bf16 rows TMA cannot describe.
//
// Replaces the Pallas TPU kernel `_matmul_kernel` in
// src/repro/kernels/matmul.py and computes what it computes: A (M, K) and
// B (K, N), both float32 or both bfloat16, row-major; products accumulated
// in fp32; the sum cast once to the output type (float32 or bfloat16) at
// the end.  Unlike the TPU kernel it masks ragged M / N / K edges (loads
// past an edge read zero, stores past an edge are skipped) instead of
// asserting that the shapes divide the tiles.
//
// Three regimes; kernels/matmul.py's plan() picks one from dtype and shape
// alone and passes it here with its tile width and split (the entry point
// refuses a regime its inputs do not fit; none stands in for another):
//
// `skinny`, fp32 with M <= 16 (a decode step's rows).  What bounds it: B's
// bytes.  At (4, 2560) x (2560, 4096) B is 42 MB against 84 MFLOP, 12.5 us
// at 3.35 TB/s, so the products stay fp32 FMAs on the CUDA cores and the
// design is about streaming B from every SM at once.  A block of 8 warps
// takes a 128-column panel of B and one slice of K; lane l reads columns
// 4l..4l+3 of each of its warp's rows as one 16-byte load (one element at a
// time where N % 4 or B's address forbids it), warps taking rows in turn,
// against A's slice staged in shared memory (all M rows, 256 columns at a
// time, read as broadcasts); each lane keeps M x 4 sums in registers.  The
// split (plan(): panels x split >= one wave of 132 SMs) puts 32 x 8 blocks
// on the card at (4, 2560, 4096) where a 128 x 128 tile gave 32.  The
// warps' sums meet in shared memory in a fixed order; with a split, each
// part writes its fp32 (M, N) partial to a workspace and `mm_split_sum`
// adds the parts in order: no atomics, the same bits every run.
//
// `tf32x3`, fp32 with M > 16 (prefill projections).  What bounds it: the
// operations (2 M N K: 17 GFLOP at (800, 2560, 4096), 0.25 ms on the fp32
// CUDA cores at 67 TFLOP/s).  Plain TF32 on the tensor cores would break
// the fp32 checks (2^-11 relative a product); 3xTF32 does not: each operand
// x is split into hi = tf32(x) and lo = tf32(x - hi), so x = hi + lo + e
// with |e| <= 2^-22 |x|, and a product is Ahi.Bhi + Ahi.Blo + Alo.Bhi in
// fp32 (tc_sm80.cuh's `mma_1688_3xtf32`); the dropped Alo.Blo and the two
// e's leave at most about 3 x 2^-22 = 7e-7 relative a product (fp32's own
// rounding is 2^-24), so a sum of K products is off by at most 7e-7 sum
// |a b|, against the checks' 1e-4.  hi is cvt.rna's, so a NaN operand
// gives a NaN hi and NaN reaches the output as in fp32.  The work is three
// times the products, on the tensor cores (495 TFLOP/s for TF32): 0.10 ms
// of tensor work at (800, 2560, 4096).  Design: a BM x BN tile a block of
// 8 warps (128 x 128: warps 2 x 4 of 64 x 32; 64 x 64 for M <= 64: 4 x 2
// of 16 x 32; plan() picks the tile from M), mma.m16n8k8 tf32 on fragments
// read from shared memory and split to hi / lo as they are loaded; 64-deep
// k stages of A and B staged as fp32 by 16-byte cp.async copies (4-byte
// ones where a row is not 16-byte aligned, zero-filled past the edges)
// into a ring of three, so stages t + 1 and t + 2 load while stage t
// computes (209 KB at 128 x 128: one block an SM); A rows padded to 68
// floats and B rows to BN + 8, so the fragments' reads (A: row g, column
// t; B: row t, column g) fall on 32 distinct banks.  The tensor core
// truncates each sum it adds into an accumulator to the accumulator's
// exponent: summing K's products into one fragment left a bias of up to
// 2^-23 |C| a product (1e-4 at K = 2560 on an H100, 30 x the fp32 CUDA
// cores' error), so each stage's products go into fresh fragments that
// are added to the fp32 sums in registers (rounded to nearest) at the
// stage's end: two sets of fragments, ~230 registers at 128 x 128.
//
// `mma`, bf16 whose K or N is not a multiple of 8 (TMA needs 16-byte row
// strides), such as (37, 100, 75).  What bounds it at such shapes: the
// latency of a few dependent steps, not bytes (16 KB) or operations.  So
// the tile is small (64 x 64, 4 warps of 32 x 32, grid 2 x 1 there) and K
// goes in 32-deep stages (4 at K = 100); each stage's elements are read
// as masked 2-byte loads into registers (rows need not be 4-byte
// aligned), the next stage's loads issued before this stage's products;
// mma.m16n8k16 bf16 with fp32 accumulation on ldmatrix fragments, rows
// padded by 16 bytes.
//
// C entry point (bound with ctypes): returns cudaGetLastError() after the
// launches; launches on the given stream; allocates nothing (the wrapper
// passes the split's workspace).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_sm80.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// c[row][col] and c[row][col + 1] of an (m, n) output from fp32 (x, y):
// both at once where n is even (the pair is then aligned), else each
// within the edge
template <typename TO>
__device__ __forceinline__ void store_pair(TO* c, int m, int n, int row,
                                           int col, float x, float y) {
  if (row >= m || col >= n) return;
  TO* p = c + (size_t)row * n + col;
  if (n % 2 == 0) {
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float2*>(p) = float2{x, y};
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    }
  } else {
    p[0] = from_f32<TO>(x);
    if (col + 1 < n) p[1] = from_f32<TO>(y);
  }
}


// ---- skinny: fp32, M <= 16, split K on the CUDA cores ---------------------

constexpr int kPanel = 128;                    // B columns a block: 4 a lane
constexpr int kSkinnyWarps = kThreads / 32;
constexpr int kChunk = 256;                    // A columns staged at a time

// A's chunk (MR x kChunk floats), then the warps' sums (8 x MR x kPanel)
template <int MR>
constexpr size_t skinny_smem_bytes() {
  return sizeof(float) * kSkinnyWarps * MR * kPanel;
}

// Rows [part * rows_per_part, ...) of K against the 128-column panel
// blockIdx.x: MR >= m rows of A (those past m read as zero).  VEC: B's
// rows are read as 16-byte loads (N % 4 == 0 and B 16-byte aligned).
template <int MR, bool VEC, typename TO>
__global__ void __launch_bounds__(kThreads)
mm_skinny(const float* __restrict__ a, const float* __restrict__ b,
          TO* __restrict__ c, float* __restrict__ work, int m, int n, int k,
          int rows_per_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = blockIdx.x * kPanel + 4 * lane;
  const int part = blockIdx.y;
  const int k_beg = part * rows_per_part;
  const int k_end = min(k, k_beg + rows_per_part);
  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_beg; k0 < k_end; k0 += kChunk) {
    const int kn = min(kChunk, k_end - k0);
    __syncthreads();                           // the last chunk is consumed
    for (int e = tid; e < MR * kChunk; e += kThreads) {
      const int i = e / kChunk, q = e % kChunk;
      sm[e] = i < m && q < kn ? a[(size_t)i * k + k0 + q] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int q = warp; q < kn; q += kSkinnyWarps) {
      const float* brow = b + (size_t)(k0 + q) * n;
      float4 bv = {0.f, 0.f, 0.f, 0.f};
      if (VEC) {
        if (col < n) bv = *reinterpret_cast<const float4*>(brow + col);
      } else {
        if (col < n) bv.x = brow[col];
        if (col + 1 < n) bv.y = brow[col + 1];
        if (col + 2 < n) bv.z = brow[col + 2];
        if (col + 3 < n) bv.w = brow[col + 3];
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float x = sm[i * kChunk + q];
        acc[i][0] = fmaf(x, bv.x, acc[i][0]);
        acc[i][1] = fmaf(x, bv.y, acc[i][1]);
        acc[i][2] = fmaf(x, bv.z, acc[i][2]);
        acc[i][3] = fmaf(x, bv.w, acc[i][3]);
      }
    }
  }
  __syncthreads();                 // A's chunk is consumed: sm takes the sums
#pragma unroll
  for (int i = 0; i < MR; ++i)
    *reinterpret_cast<float4*>(sm + (warp * MR + i) * kPanel + 4 * lane) =
        float4{acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
  __syncthreads();
  for (int e = tid; e < MR * kPanel; e += kThreads) {
    const int i = e / kPanel, cc = blockIdx.x * kPanel + e % kPanel;
    if (i >= m || cc >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kSkinnyWarps; ++w) s += sm[(w * MR + i) * kPanel + e % kPanel];
    if (work != nullptr) work[((size_t)part * m + i) * n + cc] = s;
    else c[(size_t)i * n + cc] = from_f32<TO>(s);
  }
}

// c = the sum of the split's fp32 partials (split, m, n), in part order
template <typename TO>
__global__ void __launch_bounds__(kThreads)
mm_split_sum(const float* __restrict__ work, TO* __restrict__ c,
             long long mn, int split) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= mn) return;
  float s = 0.f;
  for (int p = 0; p < split; ++p) s += work[p * mn + e];
  c[e] = from_f32<TO>(s);
}

template <int MR, typename TO>
cudaError_t launch_skinny_mr(const float* a, const float* b, TO* c,
                             float* work, int m, int n, int k, int split,
                             cudaStream_t s) {
  constexpr size_t smem = skinny_smem_bytes<MR>();
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int rows = (k + split - 1) / split;
  const dim3 grid((n + kPanel - 1) / kPanel, split);
  float* w = split > 1 ? work : nullptr;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(mm_skinny<MR, true, TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    mm_skinny<MR, true, TO><<<grid, kThreads, smem, s>>>(a, b, c, w, m, n, k, rows);
  } else {
    err = cudaFuncSetAttribute(mm_skinny<MR, false, TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    mm_skinny<MR, false, TO><<<grid, kThreads, smem, s>>>(a, b, c, w, m, n, k, rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long mn = (long long)m * n;
  const int blocks = (int)((mn + kThreads - 1) / kThreads);
  mm_split_sum<TO><<<blocks, kThreads, 0, s>>>(work, c, mn, split);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_skinny(const float* a, const float* b, TO* c, float* work,
                          int m, int n, int k, int split, cudaStream_t s) {
  if (m <= 1) return launch_skinny_mr<1, TO>(a, b, c, work, m, n, k, split, s);
  if (m <= 2) return launch_skinny_mr<2, TO>(a, b, c, work, m, n, k, split, s);
  if (m <= 4) return launch_skinny_mr<4, TO>(a, b, c, work, m, n, k, split, s);
  if (m <= 8) return launch_skinny_mr<8, TO>(a, b, c, work, m, n, k, split, s);
  return launch_skinny_mr<16, TO>(a, b, c, work, m, n, k, split, s);
}


// ---- tf32x3: fp32, M > 16, 3xTF32 mma.sync tiles ---------------------------

constexpr int kTK = 64;                        // k a stage
constexpr int kStages = 3;                     // stages in the ring
constexpr int kAS = kTK + 4;                   // A row stride: banks 4g + t

template <int BM, int BN>
constexpr size_t tf32_smem_bytes() {
  // A [kStages][BM][kAS] and B [kStages][kTK][BN + 8], fp32
  return sizeof(float) * kStages * (BM * kAS + kTK * (BN + 8));
}

// A BM x BN tile of C.  VA / VB: A's / B's rows staged by 16-byte
// copies (K % 4 == 0 / N % 4 == 0 and the matrix 16-byte aligned), else
// by 4-byte ones.
template <int BM, int BN, bool VA, bool VB, typename TO>
__global__ void __launch_bounds__(kThreads)
mm_tf32x3(const float* __restrict__ a, const float* __restrict__ b,
          TO* __restrict__ c, int m, int n, int k) {
  constexpr int kWN = BN == 128 ? 4 : 2;       // warps across the tile's n
  constexpr int kWM = kThreads / 32 / kWN;
  constexpr int kMT = BM / kWM / 16;           // m16 tiles a warp: 4, 1
  constexpr int kNT = BN / kWN / 8;            // n8 tiles a warp: 4
  constexpr int kBS = BN + 8;                  // B row stride: banks 8t + g
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);
  float* bs = as + kStages * BM * kAS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int wm = (warp / kWN) * kMT * 16, wn = (warp % kWN) * kNT * 8;

  // stage k0..k0 + kTK - 1 of A's rows and B's columns into buffer buf
  auto load = [&](int k0, int buf) {
    float* ad = as + buf * BM * kAS;
    float* bd = bs + buf * kTK * kBS;
    if (VA) {
      for (int e = tid; e < BM * kTK / 4; e += kThreads) {
        const int r = e / (kTK / 4), q = e % (kTK / 4) * 4;
        const bool in = row0 + r < m && k0 + q < k;
        cp_async_16(ad + r * kAS + q,
                    in ? a + (size_t)(row0 + r) * k + k0 + q : a, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * kTK; e += kThreads) {
        const int r = e / kTK, q = e % kTK;
        const bool in = row0 + r < m && k0 + q < k;
        cp_async_4(ad + r * kAS + q,
                   in ? a + (size_t)(row0 + r) * k + k0 + q : a, in ? 4 : 0);
      }
    }
    if (VB) {
      for (int e = tid; e < kTK * BN / 4; e += kThreads) {
        const int q = e / (BN / 4), cc = e % (BN / 4) * 4;
        const bool in = k0 + q < k && col0 + cc < n;
        cp_async_16(bd + q * kBS + cc,
                    in ? b + (size_t)(k0 + q) * n + col0 + cc : b, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kTK * BN; e += kThreads) {
        const int q = e / BN, cc = e % BN;
        const bool in = k0 + q < k && col0 + cc < n;
        cp_async_4(bd + q * kBS + cc,
                   in ? b + (size_t)(k0 + q) * n + col0 + cc : b, in ? 4 : 0);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // a ring of kStages buffers: stages kt + 1 .. kt + kStages - 1 are in
  // flight while stage kt computes (one commit group a stage, empty past
  // the end, so that the wait counts stay uniform)
  const int n_k = (k + kTK - 1) / kTK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load(st * kTK, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt % kStages;
    cp_async_wait<kStages - 2>();              // stage kt landed
    // ... for every thread; and every thread is done with stage kt - 1,
    // whose buffer the prefetch below refills
    __syncthreads();
    if (kt + kStages - 1 < n_k)
      load((kt + kStages - 1) * kTK, (kt + kStages - 1) % kStages);
    cp_async_commit();
    // the tensor core truncates each sum it adds into an accumulator to
    // the accumulator's exponent, so a running sum of |C| would lose up to
    // an ulp of |C| a product, the losses adding up along K: the stage's
    // products go into fresh fragments, added to the sums in fp32 (rounded
    // to nearest) at the stage's end
    float sp[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[i][j][e] = 0.f;
    const float* at = as + buf * BM * kAS + wm * kAS;
    const float* bt = bs + buf * kTK * kBS + wn;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 8) {
      // B fragments (k t / t + 4, n g) of the warp's n8 tiles, split
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        split_tf32(bt[(kk + t4) * kBS + j * 8 + g], bh[j][0], bl[j][0]);
        split_tf32(bt[(kk + t4 + 4) * kBS + j * 8 + g], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        const float* ar = at + (i * 16 + g) * kAS + kk + t4;
        uint32_t ah[4], al[4];
        split_tf32(ar[0], ah[0], al[0]);
        split_tf32(ar[8 * kAS], ah[1], al[1]);
        split_tf32(ar[4], ah[2], al[2]);
        split_tf32(ar[8 * kAS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_1688_3xtf32(sp[i][j], ah, al, bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += sp[i][j][e];
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store_pair(c, m, n, row0 + wm + i * 16 + g + 8 * r,
                   col0 + wn + j * 8 + 2 * t4, acc[i][j][2 * r],
                   acc[i][j][2 * r + 1]);
}

template <int BM, int BN, bool VA, bool VB, typename TO>
cudaError_t launch_tf32_inst(const float* a, const float* b, TO* c, int m,
                             int n, int k, cudaStream_t s) {
  constexpr size_t smem = tf32_smem_bytes<BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      mm_tf32x3<BM, BN, VA, VB, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_tf32x3<BM, BN, VA, VB, TO><<<grid, kThreads, smem, s>>>(a, b, c, m, n, k);
  return cudaGetLastError();
}

template <int BM, int BN, typename TO>
cudaError_t launch_tf32_tile(const float* a, const float* b, TO* c, int m,
                             int n, int k, cudaStream_t s) {
  const bool va = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (va && vb) return launch_tf32_inst<BM, BN, true, true, TO>(a, b, c, m, n, k, s);
  if (va) return launch_tf32_inst<BM, BN, true, false, TO>(a, b, c, m, n, k, s);
  if (vb) return launch_tf32_inst<BM, BN, false, true, TO>(a, b, c, m, n, k, s);
  return launch_tf32_inst<BM, BN, false, false, TO>(a, b, c, m, n, k, s);
}

// the tiles plan() gives: 128 x 128, 64 x 64
template <typename TO>
cudaError_t launch_tf32(const float* a, const float* b, TO* c, int m, int n,
                        int k, int block_m, int block_n, cudaStream_t s) {
  if (block_m == 128 && block_n == 128)
    return launch_tf32_tile<128, 128, TO>(a, b, c, m, n, k, s);
  if (block_m == 64 && block_n == 64)
    return launch_tf32_tile<64, 64, TO>(a, b, c, m, n, k, s);
  return cudaErrorInvalidValue;
}


// ---- mma: bf16 with ragged rows, mma.sync on small tiles -------------------

constexpr int kRT = 64;                        // tile rows and columns
constexpr int kRK = 32;                        // k a stage
constexpr int kRThreads = 128;                 // 4 warps of 32 x 32
constexpr int kRAS = kRK + 8;                  // A row stride: 80 bytes
constexpr int kRBS = kRT + 8;                  // B row stride: 144 bytes
constexpr int kRPer = kRT * kRK / kRThreads;   // A (and B) elements a thread

template <typename TO>
__global__ void __launch_bounds__(kRThreads)
mm_bf16_mma(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, TO* __restrict__ c, int m,
            int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 as[kRT * kRAS];
  __shared__ __align__(16) __nv_bfloat16 bs[kRK * kRBS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;      // ldmatrix: matrix, row
  const int row0 = blockIdx.y * kRT, col0 = blockIdx.x * kRT;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // element tid + r * 128 of the stage: A row e / 32, column e % 32; B row
  // e / 64, column e % 64 (consecutive threads on consecutive addresses)
  __nv_bfloat16 ra[kRPer], rb[kRPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kRPer; ++r) {
      const int e = tid + r * kRThreads;
      const int ar = row0 + e / kRK, aq = k0 + e % kRK;
      ra[r] = ar < m && aq < k ? a[(size_t)ar * k + aq] : zero;
      const int bq = k0 + e / kRT, bc = col0 + e % kRT;
      rb[r] = bq < k && bc < n ? b[(size_t)bq * n + bc] : zero;
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (k + kRK - 1) / kRK;
  if (n_k > 0) fetch(0);
  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();                           // the last stage is consumed
#pragma unroll
    for (int r = 0; r < kRPer; ++r) {
      const int e = tid + r * kRThreads;
      as[(e / kRK) * kRAS + e % kRK] = ra[r];
      bs[(e / kRT) * kRBS + e % kRT] = rb[r];
    }
    __syncthreads();
    if (kt + 1 < n_k) fetch((kt + 1) * kRK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kRK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], as + (wm + i * 16 + (lane & 15)) * kRAS + kk +
                               (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        // matrices: k kk + {0..7, 8..15} x columns wn + j2*16 + {0..7, 8..15}
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bs + (kk + (mi & 1) * 8 + mr) * kRBS + wn +
                                  j2 * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816_bf16(acc[i][2 * j2], af[i], bf);
          mma_16816_bf16(acc[i][2 * j2 + 1], af[i], bf + 2);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store_pair(c, m, n, row0 + wm + i * 16 + g + 8 * r,
                   col0 + wn + j * 8 + 2 * t4, acc[i][j][2 * r],
                   acc[i][j][2 * r + 1]);
}

template <typename TO>
cudaError_t launch_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                       TO* c, int m, int n, int k, cudaStream_t s) {
  const dim3 grid((n + kRT - 1) / kRT, (m + kRT - 1) / kRT);
  mm_bf16_mma<TO><<<grid, kRThreads, 0, s>>>(a, b, c, m, n, k);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch(const void* a, const void* b, void* c, void* work, int m,
                   int n, int k, int in_dtype, int variant, int block_m,
                   int block_n, int split, cudaStream_t s) {
  TO* out = static_cast<TO*>(c);
  switch (variant) {
    case 0:                                    // skinny
      if (in_dtype != 0 || m > 16 || split < 1 || (split > 1 && !work))
        return cudaErrorInvalidValue;
      return launch_skinny<TO>(static_cast<const float*>(a),
                               static_cast<const float*>(b), out,
                               static_cast<float*>(work), m, n, k, split, s);
    case 1:                                    // tf32x3
      if (in_dtype != 0 || split != 1) return cudaErrorInvalidValue;
      return launch_tf32<TO>(static_cast<const float*>(a),
                             static_cast<const float*>(b), out, m, n, k,
                             block_m, block_n, s);
    case 2:                                    // mma
      if (in_dtype != 1 || split != 1) return cudaErrorInvalidValue;
      return launch_mma<TO>(static_cast<const __nv_bfloat16*>(a),
                            static_cast<const __nv_bfloat16*>(b), out, m, n,
                            k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  variant: 0 = skinny (fp32, m <=
// 16; `split` parts of K, with split > 1 an fp32 workspace of split * m *
// n), 1 = tf32x3 (fp32; tiles block_m x block_n of 128 x 128 or 64 x 64),
// 2 = mma (bf16); block_m is read by tf32x3 only.
// m, n >= 1, k >= 0; a variant the inputs do not fit is refused.
extern "C" int repro_matmul(const void* a, const void* b, void* c,
                            void* work, int m, int n, int k, int in_dtype,
                            int out_dtype, int variant, int block_m,
                            int block_n, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (out_dtype) {
    case 0:
      err = launch<float>(a, b, c, work, m, n, k, in_dtype, variant, block_m, block_n, split, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(a, b, c, work, m, n, k, in_dtype, variant, block_m, block_n, split, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
