// Warp-level tensor-core and asynchronous-copy primitives (sm_80 and later,
// so also sm_90a) as inline PTX: what K3's bf16 path is built from.
//
// Fragment layouts are the PTX ISA's (mma.m16n8k16 with .bf16 operands;
// g = lane / 4, t = lane % 4; a register holds two bf16, the lower column
// or row in its low half):
//   A (16 x 16, row major), 4 registers: a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//     a2 (g, 2t+8..), a3 (g+8, 2t+8..);
//   B (16 x 8, "col": k down, n across), 2 registers: b0 (k 2t..2t+1, n g),
//     b1 (k 2t+8.., n g);
//   C / D (16 x 8 fp32), 4 floats: (g, 2t), (g, 2t+1), (g+8, 2t),
//     (g+8, 2t+1).
// ldmatrix.x4 reads four 8 x 8 b16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives row g of matrix i,
// columns 2t..2t+1 (with .trans: column g, rows 2t..2t+1).
//
// tests/cuda_emu.h carries a CPU version of every function here (a
// per-warp exchange through memory), so the kernels built on them run
// under the CPU tests; a source that includes this header has the include
// dropped there.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A (16 x 16 bf16) . B (16 x 8 bf16), fp32 accumulate
__device__ __forceinline__ void mma_16816_bf16(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes 16 zero
// bytes and reads nothing (the zero-fill form)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
