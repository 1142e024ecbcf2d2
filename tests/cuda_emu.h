// CPU emulation of the CUDA subset that the port's kernels use, for tests on
// hosts without a GPU: each block runs as one std::thread per CUDA thread,
// blocks one after another; __syncthreads is a std::barrier over the block,
// __shfl_xor_sync an exchange through memory with a barrier per warp;
// __shared__ arrays become statics (one block runs at a time).  The test
// that includes it rewrites each <<<grid, threads, smem, stream>>> launch
// into emu_launch(grid, threads, body).
#pragma once
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
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<std::barrier<>*> g_warp;
inline float g_xch[1024];
inline float g_smem[65536];
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
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
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline void emu_launch(dim3 grid, int nt, std::function<void()> f) {
  gridDim = grid; blockDim = dim3(nt);
  for (unsigned z = 0; z < grid.z; ++z) for (unsigned y = 0; y < grid.y; ++y) for (unsigned x = 0; x < grid.x; ++x) {
    std::barrier<> bar(nt); g_bar = &bar;
    std::vector<std::barrier<>*> w; for (int i = 0; i < nt / 32; ++i) w.push_back(new std::barrier<>(32)); g_warp = w;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t) ts.emplace_back([&, t] { threadIdx = dim3(t); blockIdx = dim3(x, y, z); f(); });
    for (auto& th : ts) th.join();
    for (auto* p : w) delete p;
  }
}
