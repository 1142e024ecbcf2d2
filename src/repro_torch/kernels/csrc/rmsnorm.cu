// Fused RMSNorm for Hopper, sm_90a (K1 of the port).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py and computes what it computes:
//   y = (x * rsqrt(mean(x^2) + eps)).astype(T) * w, rounded to T again,
// with x (rows, d) and w (d,) both float32 or both bfloat16, row-major.
// The statistics are fp32: the sum of squares of a row in a fixed order
// (each access's elements in index order, a thread's accesses in order,
// then a fixed butterfly of shuffles, and in a block the same butterfly
// over the warps' totals), divided by d; no atomics, so a row is bitwise
// the same from run to run.  The normalised row is rounded to T before
// the product with w, and the product rounded once more (the reference's
// rounding order, as in kernels/ref.py); in bf16 that product is one
// bf16x2 multiply, exact before its rounding.
//
// What bounds it on the card: bytes.  One read of x, one write of y and
// a read of w that L1/L2 serve; four flops an element.  The TPU kernel
// cut rows into 256-row VMEM blocks; on Hopper what matters is that every
// byte of x is asked for at once and that no lane idles, so the design is
// rows in registers, sized to the row:
//
//   packed (threads_per_row 1..16): short rows, several a warp.  A lane
//     holds one 16-byte vector (8 bf16 or 4 fp32); a 128-element bf16
//     row is 16 lanes, two rows a warp; the sum is a butterfly of xor
//     shuffles whose masks stay inside the row's lane group.
//   warp (threads_per_row 32): a row a warp, held in registers: d = 2560
//     bf16 is 10 vectors a lane, no lane masked off.  All loads of a
//     lane, of x and of w, are issued before its first add (w loaded
//     after the sum cost an L2 round trip on the chain); x is read once.
//     Each 16-byte access is one 128-bit load or store.
//   block (threads_per_row = the block): rows too long for a warp's
//     registers, and rows too few to give every SM a warp (a decode step's
//     four d_model rows: one vector a thread, the shortest chain a thread
//     can have).  The block's warps post their totals to shared memory.
//     A row of up to threads x 4 vectors stays in registers; a longer one
//     is read twice (the second read mostly from L2).
//
// Rows per block and the grid come from kernels/rmsnorm.py's plan(), so
// that the grid covers the SMs wherever there are rows enough.  Where
// d * sizeof(T) is not a multiple of 16 bytes or a pointer is not 16-byte
// aligned, the plan asks for one element a load (the same kernels with a
// vector of one element).  Lanes past the row's end and rows past `rows`
// load zeros and store nothing, but still take part in the shuffles.
//
// The backward (`repro_rmsnorm_bwd`, training; the TPU kernel has none:
// the reference trains through XLA's autodiff) is at the end of this file,
// with its own note.
//
// C entry points (bound with ctypes): return cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape of launch they have no
// kernel for; launch on the given stream; allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxThreads = 1024;

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

// N elements loaded and stored as one access (16 bytes when N * sizeof(T)
// is 16, one element when N is 1).  Eight bf16 are four bf16x2 words, so
// that a row held in registers takes 4 of them an access, not 8.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};
template <>
struct alignas(16) Vec<__nv_bfloat16, 8> {
  __nv_bfloat162 h[4];
};

// An access of 16 bytes is one 128-bit load or store: a copy of the struct
// itself may be split into four 32-bit ones.
template <typename V>
__device__ __forceinline__ V load(const V* p) {
  if constexpr (sizeof(V) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    V v;
    memcpy(&v, &u, sizeof(V));
    return v;
  } else {
    return *p;
  }
}
template <typename V>
__device__ __forceinline__ void store(V* p, const V& v) {
  if constexpr (sizeof(V) == 16) {
    uint4 u;
    memcpy(&u, &v, sizeof(V));
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = v;
  }
}

// The sum of squares of one access's elements, in fp32, in index order.
template <typename T, int N>
__device__ __forceinline__ float sumsq(const Vec<T, N>& a) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float f = to_f32(a.v[e]);
    s = fmaf(f, f, s);
  }
  return s;
}
__device__ __forceinline__ float sumsq(const Vec<__nv_bfloat16, 8>& a) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(a.h[k]);
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}

// One access of the output: x * inv rounded to T, times w, rounded to T.
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> scale(const Vec<T, N>& x,
                                           const Vec<T, N>& w, float inv) {
  Vec<T, N> out;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float n = to_f32(from_f32<T>(to_f32(x.v[e]) * inv));
    out.v[e] = from_f32<T>(n * to_f32(w.v[e]));
  }
  return out;
}
// bf16x2: the product of two bf16 is exact in fp32, so the bf16x2 multiply
// rounds it as (n.float() * w.float()).to(bf16) does
__device__ __forceinline__ Vec<__nv_bfloat16, 8> scale(
    const Vec<__nv_bfloat16, 8>& x, const Vec<__nv_bfloat16, 8>& w,
    float inv) {
  Vec<__nv_bfloat16, 8> out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(x.h[k]);
    out.h[k] = __hmul2(__floats2bfloat162_rn(f.x * inv, f.y * inv), w.h[k]);
  }
  return out;
}

// The sum over a row's lane group (TPR lanes of a warp, or the whole block
// when TPR is 0), the same bits in every lane: xor partners add the same
// two values; a block's warps post their totals to shared memory and every
// warp adds them by the same butterfly.
template <int TPR>
__device__ __forceinline__ float group_sum(float s) {
  constexpr int kLanes = TPR == 0 ? 32 : TPR;
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  if constexpr (TPR == 0) {
    __shared__ float red[kMaxThreads / 32];
    const int lane = threadIdx.x % 32;
    if (lane == 0) red[threadIdx.x / 32] = s;
    __syncthreads();
    s = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// TPR threads a row (0: the whole block is one row's), VPT accesses of N
// elements each a thread per pass over the row; nvec = d / N accesses a row.
// A row that one pass holds stays in registers with w beside it; only the
// block variant (TPR 0) may make more passes, and then reads x and w again.
template <typename T, int N, int TPR, int VPT>
__global__ void __launch_bounds__(TPR == 0 ? kMaxThreads : 256)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int nvec, int d, float eps) {
  using V = Vec<T, N>;
  constexpr bool kStream = TPR == 0;
  int tpr, lane;
  long long row;
  if constexpr (kStream) {                 // a row a block
    tpr = blockDim.x;
    lane = threadIdx.x;
    row = blockIdx.x;
  } else {
    tpr = TPR;
    lane = threadIdx.x % TPR;
    row = (long long)blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  }
  const bool live = row < rows;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  V* yr = reinterpret_cast<V*>(y + row * d);
  const V* wr = reinterpret_cast<const V*>(w);
  const int span = tpr * VPT;
  const int passes_end = kStream ? nvec : 1;
  const bool resident = !kStream || nvec <= span;   // one pass holds the row

  V r[VPT], wv[VPT];
  float ss = 0.f;
  for (int c0 = 0; c0 < passes_end; c0 += span) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {        // every load before any add
      const int v = c0 + lane + tpr * j;
      if (live && v < nvec) {
        r[j] = load(xr + v);
        if (resident) wv[j] = load(wr + v);
      } else {
        r[j] = V{};
      }
    }
    // a short chain: each access summed alone, then the accesses in order
#pragma unroll
    for (int j = 0; j < VPT; ++j) ss += sumsq(r[j]);
  }
  ss = group_sum<TPR>(ss);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int c0 = 0; c0 < passes_end; c0 += span) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = c0 + lane + tpr * j;
      if (!(live && v < nvec)) continue;
      store(yr + v, resident ? scale(r[j], wv[j], inv)
                             : scale(load(xr + v), load(wr + v), inv));
    }
  }
}

template <typename T, int N, int TPR, int VPT>
cudaError_t go(const void* x, const void* w, void* y, int rows, int d,
               float eps, int threads, int grid, cudaStream_t s) {
  rmsnorm_kernel<T, N, TPR, VPT><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(y), rows, d / N, d, eps);
  return cudaGetLastError();
}

// the warp variant's instances: vectors a lane, a masked tail allowed
template <typename T, int N>
cudaError_t warp(const void* x, const void* w, void* y, int rows, int d,
                 float eps, int vpt, int threads, int grid, cudaStream_t s) {
#define REPRO_WARP(V) \
  case V: return go<T, N, 32, V>(x, w, y, rows, d, eps, threads, grid, s);
  switch (vpt) {
    REPRO_WARP(1) REPRO_WARP(2) REPRO_WARP(4) REPRO_WARP(6) REPRO_WARP(8)
    REPRO_WARP(10) REPRO_WARP(12) REPRO_WARP(16) REPRO_WARP(20)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_WARP
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, int tpr, int vpt, int threads, int grid,
                   cudaStream_t s) {
  if (d % N || threads <= 0 || threads > kMaxThreads || threads % 32 ||
      grid <= 0)
    return cudaErrorInvalidValue;
  if (tpr == threads && tpr > 32) {        // block
    if (vpt == 1) return go<T, N, 0, 1>(x, w, y, rows, d, eps, threads, grid, s);
    if (vpt == 4) return go<T, N, 0, 4>(x, w, y, rows, d, eps, threads, grid, s);
    return cudaErrorInvalidValue;
  }
  if ((vpt != 1 && tpr != 32) || d / N > tpr * vpt || threads % tpr)
    return cudaErrorInvalidValue;           // a packed or warp row in one pass
  switch (tpr) {                           // packed, then warp
    case 1: return go<T, N, 1, 1>(x, w, y, rows, d, eps, threads, grid, s);
    case 2: return go<T, N, 2, 1>(x, w, y, rows, d, eps, threads, grid, s);
    case 4: return go<T, N, 4, 1>(x, w, y, rows, d, eps, threads, grid, s);
    case 8: return go<T, N, 8, 1>(x, w, y, rows, d, eps, threads, grid, s);
    case 16: return go<T, N, 16, 1>(x, w, y, rows, d, eps, threads, grid, s);
    case 32: return warp<T, N>(x, w, y, rows, d, eps, vpt, threads, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- backward -------------------------------------------------------------
//
// The gradient of the forward above, for the output gradient dy (rows, d):
//   r = rsqrt(mean(x^2) + eps), dn = dy * w,
//   dx = r * dn - x * r^3 * mean(dn * x)      (rounded once to T),
//   dw = sum over rows of dy * n, n = (x * r) rounded to T (the forward's
//        rounding order: n is what multiplied w).
// Each element's arithmetic is in that order: dn = dy * w rounded to fp32,
// fma'd into the row's sum; dx from r * dn and x * coef; dy * n fma'd into
// the column's sum.  Bytes bound it, as the forward: a read of x and dy, a
// write of dx, ten flops an element.  rstd is recomputed (the forward
// saves nothing).
//
// rmsnorm_bwd_rows: a row is TPR threads (1-32 lanes of a warp, or 64-256
// threads of the block), each holding VPT accesses of N elements (16 bytes
// where the row and the pointers allow, else one element), as the
// forward's warp variant does: x and dy are read once, into registers,
// and held between the row's two sums (x^2 and dn * x, each access summed
// in index order, the accesses in order, then the forward's butterfly
// over the row's lanes and, past a warp, the warps' totals in order
// through shared memory) and its writes.  w is read again beside the
// writes (from L1).  Each thread keeps the dw partials of its columns in
// registers across the rows it walks: a block of 256 threads holds 256 /
// TPR rows at a time and walks its share of the rows in order, so the
// grid is a few blocks an SM (as the plan in kernels/rmsnorm.py sizes it)
// and writes one fp32 partial row a block.  At the end, the lanes of a
// warp that hold the same columns add them by a butterfly, the holders
// (warps, or the block's row slots) post theirs to rows of shared memory
// (up to 80 KB), and the block adds those rows in holder order into its
// row of `partial`.
// rmsnorm_bwd_cols: dw by a fixed-order column sum over those rows: warp k
// of a block adds rows k, k + 16, ... for 32 columns (coalesced), then
// warp 0 adds the sixteen sums in order.  No atomics: a step is the same
// bits every time.

constexpr int kBwdThreads = 256;
constexpr int kColWarps = 16;

// the N elements of an access as floats, and back (rounded to T)
template <typename T, int N>
__device__ __forceinline__ void unpack(const Vec<T, N>& a, float (&f)[N]) {
  if constexpr (N == 8 && sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __bfloat1622float2(a.h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = to_f32(a.v[e]);
  }
}
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> pack(const float (&f)[N]) {
  Vec<T, N> out;
  if constexpr (N == 8 && sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out.h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out.v[e] = from_f32<T>(f[e]);
  }
  return out;
}

template <typename T, int N, int TPR, int VPT>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int d,
                 int rows_per_block, float eps) {
  using V = Vec<T, N>;
  constexpr int kSlots = kBwdThreads / TPR;      // rows held at once
  constexpr int kRowWarps = TPR > 32 ? TPR / 32 : 1;
  extern __shared__ float smem[];                // [holders][d]: dw
  __shared__ float2 red[kBwdThreads / 32];       // TPR > 32: warps' sums
  const int slot = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int nvec = d / N;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)rows, r0 + rows_per_block);
  const V* wr = reinterpret_cast<const V*>(w);

  float dwa[VPT][N];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < N; ++e) dwa[j][e] = 0.f;

  // the same number of passes in every thread: TPR > 32 meets barriers
  for (long long base = r0; base < r1; base += kSlots) {
    const long long row = base + slot;
    const bool live = row < r1;
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    const V* dyr = reinterpret_cast<const V*>(dy + row * d);
    V xv[VPT], gv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {              // every load before any add
      const int v = lane + TPR * j;
      if (live && v < nvec) {
        xv[j] = load(xr + v);
        gv[j] = load(dyr + v);
      } else {
        xv[j] = V{};
        gv[j] = V{};
      }
    }
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = lane + TPR * j;
      float xf[N], gf[N], wf[N];
      unpack(xv[j], xf);
      unpack(gv[j], gf);
      unpack(v < nvec ? load(wr + v) : V{}, wf);
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        a = fmaf(xf[e], xf[e], a);
        b = fmaf(gf[e] * wf[e], xf[e], b);
      }
      ss += a;
      sd += b;
    }
    constexpr int kLanes = TPR < 32 ? TPR : 32;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sd += __shfl_xor_sync(0xffffffffu, sd, o);
    }
    if constexpr (TPR > 32) {
      const int warp = threadIdx.x / 32;
      if (threadIdx.x % 32 == 0) red[warp] = float2{ss, sd};
      __syncthreads();
      ss = sd = 0.f;
#pragma unroll
      for (int k = 0; k < kRowWarps; ++k) {
        const float2 t = red[slot * kRowWarps + k];
        ss += t.x;
        sd += t.y;
      }
      __syncthreads();                           // red read before reuse
    }
    const float r = rsqrtf(ss / (float)d + eps);
    const float coef = r * r * r * (sd / (float)d);
    if (!live) continue;
    V* dxr = reinterpret_cast<V*>(dx + row * d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = lane + TPR * j;
      if (v >= nvec) continue;
      float xf[N], gf[N], wf[N], out[N];
      unpack(xv[j], xf);
      unpack(gv[j], gf);
      unpack(load(wr + v), wf);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        out[e] = r * (gf[e] * wf[e]) - xf[e] * coef;
        dwa[j][e] = fmaf(gf[e], to_f32(from_f32<T>(xf[e] * r)), dwa[j][e]);
      }
      store(dxr + v, pack<T, N>(out));
    }
  }

  // lanes of a warp holding the same columns (TPR < 32): a butterfly
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < N; ++e)
        dwa[j][e] += __shfl_xor_sync(0xffffffffu, dwa[j][e], o);
  // then the holders (each warp's first TPR lanes when TPR < 32, else each
  // row slot) post their partials to their own row of shared memory, an
  // access's N floats as 16-byte stores where N allows (no bank
  // conflicts), and the block adds the rows in holder order column by
  // column
  constexpr int kHolders = TPR < 32 ? kBwdThreads / 32 : kSlots;
  const int holder = TPR < 32 ? threadIdx.x / 32 : slot;
  if (TPR >= 32 || threadIdx.x % 32 < TPR) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = lane + TPR * j;
      if (v >= nvec) continue;
      float* c = smem + (size_t)holder * d + v * N;
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int k = 0; k < N / 4; ++k)
          reinterpret_cast<float4*>(c)[k] =
              float4{dwa[j][4 * k], dwa[j][4 * k + 1], dwa[j][4 * k + 2],
                     dwa[j][4 * k + 3]};
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) c[e] = dwa[j][e];
      }
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kBwdThreads) {
    float t = 0.f;
#pragma unroll
    for (int h = 0; h < kHolders; ++h) t += smem[(size_t)h * d + c];
    out[c] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kColWarps * 32)
rmsnorm_bwd_cols(const float* __restrict__ partial, T* __restrict__ dw,
                 int blocks, int d) {
  __shared__ float part[kColWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kColWarps)
      s += partial[(size_t)b * d + c];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
    for (int k = 0; k < kColWarps; ++k) t += part[k][lane];
    dw[c] = from_f32<T>(t);
  }
}

template <typename T, int N, int TPR, int VPT>
cudaError_t go_bwd(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, void* partial, int rows, int d, float eps,
                   int blocks, cudaStream_t s) {
  const int rpb = (rows + blocks - 1) / blocks;
  // a row of d floats for each holder of dw partials: <= 80 KB
  const int smem = (int)sizeof(float) * d *
                   (TPR < 32 ? kBwdThreads / 32 : kBwdThreads / TPR);
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_rows<T, N, TPR, VPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_rows<T, N, TPR, VPT><<<blocks, kBwdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, rpb, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int col_blocks = (d + 31) / 32;
  rmsnorm_bwd_cols<T><<<col_blocks, kColWarps * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<T*>(dw), blocks, d);
  return cudaGetLastError();
}

// the backward's instances: (threads a row, accesses a thread) as
// kernels/rmsnorm.py's bwd_plan() picks them
template <typename T, int N>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy,
                       void* dx, void* dw, void* partial, int rows, int d,
                       float eps, int tpr, int vpt, int blocks,
                       cudaStream_t s) {
  if (d % N || (long long)tpr * vpt * N < d) return cudaErrorInvalidValue;
#define REPRO_BWD(P, V)                                                   \
  if (tpr == P && vpt == V)                                               \
    return go_bwd<T, N, P, V>(x, w, dy, dx, dw, partial, rows, d, eps,    \
                              blocks, s);
  REPRO_BWD(1, 1) REPRO_BWD(2, 1) REPRO_BWD(4, 1) REPRO_BWD(8, 1)
  REPRO_BWD(16, 1) REPRO_BWD(32, 1) REPRO_BWD(32, 2) REPRO_BWD(32, 4)
  REPRO_BWD(32, 10) REPRO_BWD(64, 10) REPRO_BWD(128, 10) REPRO_BWD(256, 10)
#undef REPRO_BWD
  if constexpr (N == 1)        // one element an access: rows up to 256 x 40
    if (tpr == 256 && vpt == 40)
      return go_bwd<T, 1, 256, 40>(x, w, dy, dx, dw, partial, rows, d, eps,
                                   blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  vector: 16-byte accesses (d *
// sizeof(T) a multiple of 16, every pointer 16-byte aligned) or one
// element an access.  tpr, vpt, threads and grid as planned by
// kernels/rmsnorm.py.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows,
                             int d, float eps, int dtype, int vector, int tpr,
                             int vpt, int threads, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype * 2 + (vector ? 1 : 0)) {
    case 0: err = launch<float, 1>(x, w, y, rows, d, eps, tpr, vpt, threads, grid, s); break;
    case 1: err = launch<float, 4>(x, w, y, rows, d, eps, tpr, vpt, threads, grid, s); break;
    case 2: err = launch<__nv_bfloat16, 1>(x, w, y, rows, d, eps, tpr, vpt, threads, grid, s); break;
    case 3: err = launch<__nv_bfloat16, 8>(x, w, y, rows, d, eps, tpr, vpt, threads, grid, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The backward: dx (rows, d) and dw (d,) in the dtype of x, for dy (rows,
// d); `partial` is fp32 scratch of blocks x d.  vector, tpr, vpt and
// blocks as planned by kernels/rmsnorm.py's bwd_plan().  Two launches on
// the given stream.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w,
                                 const void* dy, void* dx, void* dw,
                                 void* partial, int rows, int d, float eps,
                                 int dtype, int vector, int tpr, int vpt,
                                 int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (dtype * 2 + (vector ? 1 : 0)) {
    case 0: err = launch_bwd<float, 1>(x, w, dy, dx, dw, partial, rows, d, eps, tpr, vpt, blocks, s); break;
    case 1: err = launch_bwd<float, 4>(x, w, dy, dx, dw, partial, rows, d, eps, tpr, vpt, blocks, s); break;
    case 2: err = launch_bwd<__nv_bfloat16, 1>(x, w, dy, dx, dw, partial, rows, d, eps, tpr, vpt, blocks, s); break;
    case 3: err = launch_bwd<__nv_bfloat16, 8>(x, w, dy, dx, dw, partial, rows, d, eps, tpr, vpt, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
