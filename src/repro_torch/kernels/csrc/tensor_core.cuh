// Warp-level copy and register primitives of the bf16 kernels, as raw PTX
// for sm_90a: transposed ldmatrix, cp.async with zero fill, shared-memory
// stores, the swizzled byte offset of a 64-column bf16 tile (and of a tile
// of up to 128 columns kept as 64-column blocks), the staging of such a
// tile from a row-major tensor, the bf16 hi/lo split of float32 values,
// and of an accumulator into the next product's A fragments.
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

// 4 bytes global -> shared; zero when src_bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// hi/lo bf16 pairs of two float32 values (x in the low halves), each pair
// one paired conversion
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// The A fragments (bf16 hi and lo parts) of the next product over the
// columns of a float32 accumulator: k-step kk takes column tiles 2 kk and
// 2 kk + 1.
template <int NT>
__device__ __forceinline__ void split_frags(const float (&c)[NT][4],
                                            uint32_t (&f)[NT / 2][2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    split(c[2 * kk][0], c[2 * kk][1], f[kk][0][0], f[kk][1][0]);
    split(c[2 * kk][2], c[2 * kk][3], f[kk][0][1], f[kk][1][1]);
    split(c[2 * kk + 1][0], c[2 * kk + 1][1], f[kk][0][2], f[kk][1][2]);
    split(c[2 * kk + 1][2], c[2 * kk + 1][3], f[kk][0][3], f[kk][1][3]);
  }
}

// Byte offset of (r, c) in a tile of R rows and up to 128 bf16 columns
// kept as 64-column blocks (block b at b * R * 128), each with the 128-byte
// swizzle (wgmma.cuh).
template <int R>
__device__ __forceinline__ uint32_t swz_tile(int r, int c) {
  return static_cast<uint32_t>((c >> 6) * R * 128 + r * 128 +
                               ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                               (c & 7) * 2);
}

// Stage ROWS rows of a row-major bf16 tensor (row stride ld elements) into
// such a tile at dst, HD (64, 112 or 128) columns: rows past len and
// columns past hd are zero.  With vec (hd % 8 == 0, src 16-byte aligned)
// by cp.async (the caller commits and waits); otherwise by plain loads
// and stores.  THREADS threads of the block share the copy.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t ld, int len, int hd,
                                          bool vec) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const uint32_t d = dst + swz_tile<ROWS>(r, c);
    const __nv_bfloat16* s = src + static_cast<size_t>(r) * ld + c;
    if (vec) {
      const bool in = r < len && c < hd;
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c + 2 * e;
        const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
        w[e] = pack(r < len && c0 < hd ? s[2 * e] : z,
                    r < len && c0 + 1 < hd ? s[2 * e + 1] : z);
      }
      st_shared_v4(d, w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace tc
