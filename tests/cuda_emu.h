// CPU emulation of the CUDA subset that the port's kernels use, for tests on
// hosts without a GPU: each block runs as one std::thread per CUDA thread,
// blocks one after another; __syncthreads is a std::barrier over the block,
// __shfl_xor_sync an exchange through memory with a barrier per warp;
// __shared__ arrays become statics (one block runs at a time).  The test
// that includes it rewrites each <<<grid, threads, smem, stream>>> launch
// into emu_launch(grid, threads, body).  Vector types are plain structs
// (float4 aligned to 16 bytes, as the kernels' vector loads expect).
//
// The warp-level primitives of csrc/tc_sm80.cuh (ldmatrix, mma.sync in bf16
// and tf32, the tf32 split, cp.async) are emulated here with the PTX ISA's
// fragment layouts (see the table in that header): each lane posts its
// operands to a per-warp exchange, the warp meets at a barrier, and each
// lane computes what the hardware would hand it.  cp.async copies at once,
// so its commit and wait are no-ops; the kernels' __syncthreads still
// orders the copies.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>

struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 x) {
  uint32_t u = (uint32_t)x.v << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {   // round to nearest even
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {   // exact product, rounded once
  return __floats2bfloat162_rn(__bfloat162float(a.x) * __bfloat162float(b.x),
                               __bfloat162float(a.y) * __bfloat162float(b.y));
}
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<std::barrier<>*> g_warp;
inline float g_xch[1024];
alignas(16) inline float g_smem[65536];
inline uint32_t g_xu[1024][6];
inline const void* g_xp[1024];
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
using std::max;
using std::min;
typedef void* cudaStream_t;
typedef int cudaError_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
#define cudaFuncAttributeMaxDynamicSharedMemorySize 0
inline int cudaGetLastError() { return 0; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  int t = threadIdx.x; auto* b = g_warp[t / 32];
  g_xch[t] = v; b->arrive_and_wait(); float r = g_xch[(t & ~31) | ((t & 31) ^ o)]; b->arrive_and_wait(); return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  int t = threadIdx.x; auto* b = g_warp[t / 32];
  g_xch[t] = v; b->arrive_and_wait(); float r = g_xch[(t & ~31) | (src & 31)]; b->arrive_and_wait(); return r;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
// One std::thread per CUDA thread for the whole launch: each walks the
// blocks in order and meets the others at an end-of-block barrier after
// each, so blocks still run one after another (their statics and g_smem are
// reused).  That barrier is not __syncthreads' one: a thread that leaves
// the body while the others wait in a __syncthreads still hangs the launch,
// as such a divergent barrier must.
inline void emu_launch(dim3 grid, int nt, std::function<void()> f) {
  gridDim = grid; blockDim = dim3(nt);
  std::barrier<> bar(nt), done(nt); g_bar = &bar;
  std::vector<std::barrier<>*> w; for (int i = 0; i < nt / 32; ++i) w.push_back(new std::barrier<>(32)); g_warp = w;
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back([&, t] {
    threadIdx = dim3(t);
    for (unsigned z = 0; z < grid.z; ++z) for (unsigned y = 0; y < grid.y; ++y) for (unsigned x = 0; x < grid.x; ++x) {
      blockIdx = dim3(x, y, z); f(); done.arrive_and_wait();
    }
  });
  for (auto& th : ts) th.join();
  for (auto* p : w) delete p;
}

// ---- csrc/tc_sm80.cuh ------------------------------------------------------
inline uint32_t emu_b16(const void* row, int col) {   // a b16 element's bits
  uint16_t x; std::memcpy(&x, static_cast<const char*>(row) + 2 * col, 2); return x;
}
inline void emu_ldmatrix(uint32_t r[4], const void* p, bool trans) {
  int t = threadIdx.x, w = t & ~31, lane = t & 31, g = lane / 4, c = 2 * (lane % 4);
  auto* b = g_warp[t / 32];
  g_xp[t] = p; b->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const void* const* rows = g_xp + w + 8 * i;        // matrix i's 8 rows
    r[i] = trans ? emu_b16(rows[c], g) | emu_b16(rows[c + 1], g) << 16
                 : emu_b16(rows[g], c) | emu_b16(rows[g], c + 1) << 16;
  }
  b->arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t r[4], const void* p) { emu_ldmatrix(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t r[4], const void* p) { emu_ldmatrix(r, p, true); }
inline float emu_half(uint32_t reg, int hi) {
  __nv_bfloat16 x{(uint16_t)(hi ? reg >> 16 : reg & 0xffff)}; return __bfloat162float(x);
}
inline void mma_16816_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  int t = threadIdx.x, w = t & ~31, lane = t & 31, g = lane / 4, c = 2 * (lane % 4);
  auto* bar = g_warp[t / 32];
  for (int i = 0; i < 4; ++i) g_xu[t][i] = a[i];
  g_xu[t][4] = b[0]; g_xu[t][5] = b[1];
  bar->arrive_and_wait();
  auto A = [&](int row, int k) {           // A (16 x 16), row major
    return emu_half(g_xu[w + (row % 8) * 4 + (k % 8) / 2][row / 8 + 2 * (k / 8)], k & 1);
  };
  auto B = [&](int k, int n) {             // B (16 x 8), k down
    return emu_half(g_xu[w + n * 4 + (k % 8) / 2][4 + k / 8], k & 1);
  };
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = c + (e & 1);
    float s = d[e];
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    d[e] = s;
  }
  bar->arrive_and_wait();
}
inline void cp_async_16(void* dst, const void* src, int src_bytes) {
  if (src_bytes) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async_4(void* dst, const void* src, int src_bytes) {
  if (src_bytes) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline uint32_t pack_bf16x2(float lo, float hi) {
  return __float2bfloat16(lo).v | (uint32_t)__float2bfloat16(hi).v << 16;
}
// cvt.rna.tf32.f32 as the card gives it: to nearest, ties away from zero
// (half of the dropped 13 bits' weight added to the magnitude), the low 13
// bits cleared; a NaN has its low 13 bits cleared and no more (0x7fffffff
// -> 0x7fffe000; a NaN whose payload lies wholly in them becomes Inf)
inline uint32_t emu_cvt_rna_tf32(float x) {
  const uint32_t b = __float_as_uint(x);
  return x != x ? b & 0xffffe000u : (b + 0x1000u) & 0xffffe000u;
}
// tc_sm80.cuh's: the same rounding on the bits, for values that are no NaN
inline uint32_t tf32_rna_no_nan(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = emu_cvt_rna_tf32(x);
  lo = tf32_rna_no_nan(x - __uint_as_float(hi));
}
// mma.m16n8k8 tf32: each product of two tf32 values is exact in fp32 (11 x
// 11 significant bits); the products are added to d in k order; the low 13
// bits of an operand are ignored, as the tensor core ignores them.  The
// adds here round to nearest, as fp32 does; the tensor core truncates what
// it adds into an accumulator to the accumulator's exponent, so this is
// more accurate than the card over long sums into one fragment.  The
// kernels sum each k stage into fresh fragments for that reason, and only
// the card tests (test_matmul_tf32x3_keeps_fp32_error, chip_smoke phase
// 6's float64 error) can see the truncation's bias.
inline void mma_1688_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  int t = threadIdx.x, w = t & ~31, lane = t & 31, g = lane / 4, c = 2 * (lane % 4);
  auto* bar = g_warp[t / 32];
  for (int i = 0; i < 4; ++i) g_xu[t][i] = a[i];
  g_xu[t][4] = b[0]; g_xu[t][5] = b[1];
  bar->arrive_and_wait();
  auto A = [&](int row, int k) {           // A (16 x 8), row major
    return __uint_as_float(g_xu[w + (row % 8) * 4 + k % 4][row / 8 + 2 * (k / 4)] & 0xffffe000u);
  };
  auto B = [&](int k, int n) {             // B (8 x 8), k down
    return __uint_as_float(g_xu[w + n * 4 + k % 4][4 + k / 4] & 0xffffe000u);
  };
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = c + (e & 1);
    float s = d[e];
    for (int k = 0; k < 8; ++k) s += A(row, k) * B(k, col);
    d[e] = s;
  }
  bar->arrive_and_wait();
}
inline void mma_1688_3xtf32(float d[4], const uint32_t ah[4], const uint32_t al[4],
                            const uint32_t bh[2], const uint32_t bl[2]) {
  mma_1688_tf32(d, al, bh);
  mma_1688_tf32(d, ah, bl);
  mma_1688_tf32(d, ah, bh);
}
