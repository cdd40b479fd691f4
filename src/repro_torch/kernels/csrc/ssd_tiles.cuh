// Tile staging of the bf16 SSD kernels on the tensor cores (ssd_scan.cu,
// ssd_scan_bwd.cu): float32 rows of B, C (or a state) staged as they are,
// split into swizzled bf16 hi/lo tiles (and plane rows), bf16 rows of x or
// dy as one swizzled tile, plane rows as hi/lo tiles, the in-chunk
// cumulative sum in order, and the m64 x kS product over one k-step.  A
// plane holds float32 rows of up to kS values as bf16 hi (columns 0 ..
// kS-1) and lo (kS .. 2 kS-1), zero past the row's width: 4 kS aligned
// bytes a row, so that any tile of it is a cp.async copy.  A tile of kS
// state columns is kS / 64 column blocks of 64 x 64 (tc::swz_tile<64>).
// Every helper is shared by the block's kThreads threads (two warpgroups).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace ssdt {

using tc::swz;
using tc::swz_tile;
constexpr int kT = 64;          // tile rows and columns
constexpr int kThreads = 256;   // two warpgroups

// Rows [0, 64) of a float32 matrix (row stride ld) as they are into a
// 64 x kS float32 tile (4 kS bytes a row), zero at rows >= nrows and
// columns >= ncols: by cp.async when the rows are float4 chunks, else by
// plain loads; the caller commits and waits
template <int kS>
__device__ __forceinline__ void stage_raw(uint32_t dst, const float* src,
                                          size_t ld, int nrows, int ncols,
                                          bool vec) {
  constexpr int kQuads = kS / 4;
  for (int idx = threadIdx.x; idx < kT * kQuads; idx += kThreads) {
    const int r = idx / kQuads, c = (idx % kQuads) * 4;
    const float* s = src + static_cast<size_t>(r) * ld + c;
    const uint32_t d = dst + (r * kS + c) * 4;
    if (vec) {
      const bool in = r < nrows && c < ncols;
      tc::cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (r < nrows && c + e < ncols) v[e] = s[e];
      tc::st_shared_v4(d, __float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
  }
}

// A float32 tile from stage_raw split into swizzled bf16 hi and lo tiles
// (kS / 64 column blocks each), and into plane rows (pl, if not null;
// rows < nrows only)
template <int kS>
__device__ __forceinline__ void split_raw(uint32_t hi, uint32_t lo,
                                          __nv_bfloat16* pl, const float* raw,
                                          int nrows) {
  constexpr int kQuads = kS / 4;
  for (int idx = threadIdx.x; idx < kT * kQuads; idx += kThreads) {
    const int r = idx / kQuads, c = (idx % kQuads) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * kS + c);
    uint32_t h0, l0, h1, l1;
    tc::split(v.x, v.y, h0, l0);
    tc::split(v.z, v.w, h1, l1);
    const uint32_t off = swz_tile<kT>(r, c);
    tc::st_shared_v2(hi + off, h0, h1);
    tc::st_shared_v2(lo + off, l0, l1);
    if (pl && r < nrows) {
      __nv_bfloat16* row = pl + static_cast<size_t>(r) * 2 * kS + c;
      *reinterpret_cast<uint2*>(row) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(row + kS) = make_uint2(l0, l1);
    }
  }
}

// x rows (bf16, row stride ld) as one swizzled bf16 tile: by cp.async
// (zero-filled past nrows and ncols) when the rows are 16-byte chunks, else
// by plain loads; the caller commits and waits for the copies
__device__ __forceinline__ void stage_x(uint32_t dst,
                                        const __nv_bfloat16* src, size_t ld,
                                        int nrows, int ncols, bool vec) {
  for (int idx = threadIdx.x; idx < kT * kT / 8; idx += kThreads) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    const __nv_bfloat16* s = src + static_cast<size_t>(r) * ld + c;
    const uint32_t d = dst + swz(r, c);
    if (vec) {
      const bool in = r < nrows && c < ncols;
      tc::cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < nrows) {
        const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = tc::pack(c + 2 * e < ncols ? s[2 * e] : z,
                          c + 2 * e + 1 < ncols ? s[2 * e + 1] : z);
      }
      tc::st_shared_v4(d, w[0], w[1], w[2], w[3]);
    }
  }
}

// Rows [0, 64) of a plane of kS columns (zero-filled at rows >= nrows)
// into swizzled hi and lo tiles of kS / 64 column blocks, by cp.async; the
// caller commits and waits
template <int kS>
__device__ __forceinline__ void stage_plane(uint32_t hi, uint32_t lo,
                                            const __nv_bfloat16* pl,
                                            int nrows) {
  constexpr int kChunks = 2 * kS / 8;  // 16-byte chunks of a plane row
  for (int idx = threadIdx.x; idx < kT * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;  // plane column
    const bool in = r < nrows;
    const __nv_bfloat16* s = pl + static_cast<size_t>(r) * 2 * kS + c;
    tc::cp_async16((c < kS ? hi : lo) + swz_tile<kT>(r, c % kS),
                   in ? s : pl, in ? 16 : 0);
  }
}

// cum[j] = sum_{j' <= j} d[j'] * a for j < len, by one thread, each product
// rounded and then added in order: torch.cumsum along a dimension that is
// not the innermost sums so on the card, and cum's differences feed exp,
// which would amplify a different rounding of a long chunk's sums
__device__ __forceinline__ void seq_cumsum(float* cum, const float* d,
                                           float a, int len) {
  float acc = 0.f;
  int j = 0;
  for (; j + 8 <= len; j += 8) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(d[j + e], a);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc = __fadd_rn(acc, v[e]);
      cum[j + e] = acc;
    }
  }
  for (; j < len; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(d[j], a));
    cum[j] = acc;
  }
}

// d (64 x kS) += A B over one k-step: B MN-major, kS / 64 column blocks
// LBO apart (the descriptor's)
template <int NT>
__device__ __forceinline__ void mma_rs_state(float (&d)[NT][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (NT == 8) wg::mma_rs_n64(d, a, db);
  else wg::mma_rs_n128(d, a, db);
}

}  // namespace ssdt
