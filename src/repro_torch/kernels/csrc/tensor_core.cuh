// Warp-level copy and register primitives of the bf16 kernels, as raw PTX
// for sm_90a: transposed ldmatrix, cp.async with zero fill, shared-memory
// stores, the swizzled byte offset of a 64-column bf16 tile, and the bf16
// hi/lo split of float32 values.
//
// Register fragments (lane = 4 * g + t), per warp of a warpgroup, as a
// wgmma A operand from registers (16 rows x 16 columns) and as wgmma's
// float32 accumulators (16 rows x 8 columns a tile):
//   A: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 8+2t..),
//      a3 = (g+8, 8+2t..)
//   C: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so the accumulators of two neighbouring column tiles are, split into
// bf16, the A fragment of the next product over those 16 columns.
//
// The split: a float32 value a is hi = bf16(a) plus lo = bf16(a - hi),
// which leaves |a - hi - lo| <= 2^-16 |a| (2^-17 for most a).  A product
// of a float32 operand with a bf16 one is then two tensor-core products
// (hi, lo), and of two float32 operands three (hi*hi + hi*lo + lo*hi).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a bf16 tile of 64 columns (128 bytes a
// row): the 16-byte chunk index is XORed with r % 8, the 128-byte swizzle
// that wgmma's descriptors read (wgmma.cuh) and that keeps the eight row
// addresses of an ldmatrix in eight distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                               (c & 7) * 2);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a,
                                             uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(addr), "r"(a), "r"(b)
               : "memory");
}

// two bf16 in one register, x in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 x, __nv_bfloat16 y) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
}

// hi/lo bf16 pairs of two float32 values (x in the low halves)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x);
  const __nv_bfloat16 yh = __float2bfloat16_rn(y);
  hi = pack(xh, yh);
  lo = pack(__float2bfloat16_rn(x - __bfloat162float(xh)),
            __float2bfloat16_rn(y - __bfloat162float(yh)));
}

}  // namespace tc
