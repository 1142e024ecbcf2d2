// Warp-level tensor-core and asynchronous-copy primitives (sm_80 and later,
// so also sm_90a) as inline PTX: what K3's bf16 path, K3's fp32 backward
// and K2's non-TMA kernels are built from.
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
// mma.m16n8k8 with .tf32 operands (one tf32 a register: an fp32 bit pattern
// whose low 13 mantissa bits the tensor core ignores) has other A and B
// layouts than m16n8k16's:
//   A (16 x 8, row major), 4 registers: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//     a3 (g+8, t+4);
//   B (8 x 8, k down, n across), 2 registers: b0 (k t, n g), b1 (k t+4,
//     n g);
//   C / D as m16n8k16's.
// So a C fragment is not an A fragment as it stands (C holds columns 2t,
// 2t+1; A columns t, t+4).  It is one under a permuted k order: read A's
// slot t as column 2t and slot t+4 as column 2t+1, i.e. a = {c0, c2, c1,
// c3}, and load B's rows in the same order (b0 from k row 2t, b1 from
// 2t+1); the product is unchanged, since a sum over k does not depend on
// the order k is numbered in.
//
// 3xTF32: an fp32 x splits into hi = tf32(x) and lo = tf32(x - hi)
// (`split_tf32`, cvt.rna's rounding: to nearest with ties away from zero,
// the low 13 bits cleared; a NaN x gives a NaN hi), so x = hi + lo + e with
// |e| <= 2^-22 |x|; a product is then Ahi.Bhi + Ahi.Blo + Alo.Bhi
// (`mma_1688_3xtf32`, the small terms first), Alo.Blo (<= 2^-22 |ab|)
// dropped: about 3 x 2^-22 relative a product against fp32's 2^-24, on
// the tensor cores.
//
// tests/cuda_emu.h carries a CPU version of every function here (a
// per-warp exchange through memory), so the kernels built on them run
// under the CPU tests; a source that includes this header has the include
// dropped there.  One difference: the emulated mma rounds its adds to
// nearest, where the tensor core truncates what it adds into an
// accumulator, so the error that truncation leaves shows only on the card.
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

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes 4 zero bytes
// (for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// x rounded to tf32 on the bits: add half the weight of the 13 dropped
// bits to the magnitude, then clear them.  That is cvt.rna.tf32.f32's
// result (to nearest, ties away from zero) bit for bit for every x that is
// not a NaN (tools/tf32_split.py checks it on the card), in two integer
// operations.  A NaN with high mantissa bits, such as 0x7fffffff (what the
// card's fp32 arithmetic makes of 0/0 or Inf - Inf), would carry through
// the exponent into the sign and come out -0: so it rounds only values that
// cannot be a NaN unless hi already is one (split_tf32's lo).
__device__ __forceinline__ uint32_t tf32_rna_no_nan(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to 2^-22, both tf32: hi = cvt.rna(x), lo = tf32(x - hi).  hi
// takes the cvt, which keeps a NaN a NaN (0x7fffffff becomes 0x7fffe000;
// only a NaN whose payload lies wholly in the low 13 bits becomes Inf), so
// a NaN x reaches every product it is in.  x - hi is a NaN only when x is
// not finite, and then hi is NaN or Inf already, so lo takes the integer
// rounding: on an H100 a cvt for lo too makes K2 tf32x3 and K3-bwd fp32
// 3-6 % slower (tools/tf32_split.py).  An Inf x gives hi = Inf and a lo
// that may be -0: a product with it comes out Inf or NaN, never finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = tf32_rna_no_nan(x - __uint_as_float(hi));
}

// d += A (16 x 8 tf32) . B (8 x 8 tf32), fp32 accumulate
__device__ __forceinline__ void mma_1688_tf32(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A.B of fp32 operands in 3xTF32, A and B given as hi / lo fragments
__device__ __forceinline__ void mma_1688_3xtf32(float d[4],
                                                const uint32_t ah[4],
                                                const uint32_t al[4],
                                                const uint32_t bh[2],
                                                const uint32_t bl[2]) {
  mma_1688_tf32(d, al, bh);
  mma_1688_tf32(d, ah, bl);
  mma_1688_tf32(d, ah, bh);
}
