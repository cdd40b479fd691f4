// RMSNorm on Hopper (sm_90a): y = (x * r) * w over the last axis with
// r = 1 / sqrtf(mean(x^2) + eps), in float32, written back in x's dtype.
//
// The forward (rmsnorm_launch) replaces the Pallas TPU kernel of
// src/repro/kernels/rmsnorm.py (rmsnorm, _rmsnorm_kernel), which
// normalises a (256, D) VMEM tile per grid step.
//
// What bounds it.  Each row is read once and written once, with 3 float32
// operations an element: at bf16 that is 1.5 operations a byte, far below
// the card's ~295 operations a byte, so the kernel is bound by bytes (at
// 8,192 rows of 3,072 bf16, 101 MB: 0.030 ms at 3.35 TB/s).
//
// What the design does about it: every byte of x and y makes one trip, at
// 16 bytes an access, with enough of them in flight to cover the memory's
// latency.  The launch geometry is kernels/rmsnorm.py::layout's, a pure
// function of (rows, D, x's element size).  A row goes to a group of the
// fewest threads that hold it in at most three 16-byte chunks each (a
// power of two below a warp, a multiple of 32 above: 128 threads at 3,072
// bf16, 8 at QK-norm's 128), a few groups a block, one row a group and as
// many blocks as rows need.  Each thread copies its chunks of x from
// device memory into its own slots of shared memory with cp.async, so
// the copies hold no registers while in flight and the kernel runs at 32
// registers a thread, 2,048 threads an SM; it reads them back for the sum
// of squares and again for the scaled store, and reads its chunks of w
// (L1/L2) at the store.  The sum reduces by shuffles within a warp and one
// exchange of the group's warps through shared memory (a named barrier,
// no block-wide one).  When D is not a multiple of the chunk or a row is
// misaligned, threads load element by element and mask the ragged tail.
// When the row groups would leave SMs idle (decode's 8 rows; up to 524
// rows at 3,072 bf16) a row gets a whole block of up to 512 threads, so
// the call is one load and one store deep.  Rows wider than the registers
// hold (above 12,288 bf16 or 6,144 float32) take a block of 256 threads a
// row, walked twice with 16-byte loads where aligned.  No atomics, a fixed
// order of sums: a rerun gives the same bits.  Tried while designing it
// and not kept: a persistent grid whose groups walk rows at a stride, w
// held in registers (its float conversions were hoisted out of the row
// loop and spilled), x held in registers (spills at four chunks), and a
// ring of rows copied ahead (its per-launch cudaFuncSetAttribute slowed
// decode's calls); one row a group at full occupancy was faster.  On an
// NVIDIA H100 80GB HBM3 at 700.00 W, the card time of the kernel alone
// (torch.profiler; scripts/time_rmsnorm_fwd.py, this kernel and the
// previous one, a 256-thread block a row, 2-byte loads, the row read
// twice, in turns): 0.0359-0.0364 ms at the training shape (8,192 rows of
// 3,072 bf16; previous 0.0400-0.0401), 0.1562-0.1563 at the prefill's
// 16,384 rows of 7,168 (previous 0.1816-0.1817), and 0.0022-0.0024 and
// 0.0026 at decode's 8 rows of 3,584 and 7,168 (previous 0.0031 and
// 0.0036).  chip_smoke.py [11] and [17a] time it with the wrapper after
// an L2 flush, in turns with F.rms_norm.
//
// The backward (rmsnorm_bwd_launch) is the gradient of the same function,
// which the reference trains through as XLA's autodiff of its twin
// src/repro/models/layers.py:20 (rms_norm): with r = rsqrt(mean(x^2) + eps)
// and g = dy * w, dx = r * g - x * r^3 * mean(g * x) and dw = sum over rows
// of dy * x * r, in float32; dx is written in x's dtype and dw, summed in
// float32, in w's.  It is bound by bytes too: x and dy read once, dx
// written once (at 8,192 rows of 3,072 bf16, 151 MB: 0.045 ms at 3.35
// TB/s), about 2 operations a byte.  So the design keeps every byte to one
// trip: a persistent grid of one 512-thread block an SM; a row to a group
// of a few warps (the fewest, from 64 threads, whose threads hold the row
// in at most three 16-byte chunks each: 128 threads and 24 bf16 a thread
// at D = 3,072), its x and dy loaded once, by 16-byte cp.async a row
// ahead into a thread's own slots in shared memory (when D is a multiple
// of the chunk and the rows aligned; element by element otherwise), and
// kept in registers through both sums and the write of dx;
// the sums reduce by shuffles and one exchange of the group's warps (a
// named barrier, no block-wide one a row); a thread owns fixed columns
// across every row its group walks, and keeps their dw partial sums in
// registers.  No float atomics: the block's groups add their partials in
// group order into the block's row of a float32 workspace, and a second
// kernel adds the blocks' rows column by column, in block order, and
// casts, so a rerun gives the same bits.  Rows wider than the registers
// hold (above 12,288 bf16 or 6,144 float32) take a block a row at a time,
// walk it twice and keep the block's dw partials in shared memory.  At
// 8,192 rows of 3,072 bf16 it takes 0.076 to 0.084 ms on an H100 80GB HBM3 at
// 700 W against the 0.045 ms bound (chip_smoke.py [17a]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tensor_core.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of one type, loaded or stored as one access (two for 32 bytes)
template <typename U, int N>
struct alignas(N * sizeof(U) >= 16 ? 16 : N * sizeof(U)) Pack {
  U e[N];
};

// The chunk of N elements at column col of a row: one vector access when
// vec (D % N == 0 and the row aligned), else element by element, zero past
// D.  The caller keeps col < D.
template <typename U, int N>
__device__ __forceinline__ Pack<U, N> load_chunk(const U* row, int col,
                                                 int D, bool vec) {
  if (vec) return *reinterpret_cast<const Pack<U, N>*>(row + col);
  Pack<U, N> t;
#pragma unroll
  for (int i = 0; i < N; ++i)
    t.e[i] = col + i < D ? row[col + i] : from_f32<U>(0.f);
  return t;
}

// The chunk c at column col of a row: one vector store when vec, else
// element by element up to D.
template <typename U, int N>
__device__ __forceinline__ void store_chunk(U* row, int col, int D, bool vec,
                                            const Pack<U, N>& c) {
  if (vec) {
    *reinterpret_cast<Pack<U, N>*>(row + col) = c;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (col + i < D) row[col + i] = c.e[i];
  }
}

// Named barrier of the `count` threads of one row group (ids 1..8).
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// a block of the wide paths (rows too wide for registers), both ways
constexpr int kWideThreads = 256;

// the sums of v over the block, the same on every thread
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (*red)[kWideThreads / 32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[k][warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kWideThreads / 32; ++i) v[k] += red[k][i];
  }
  __syncthreads();  // red is free for the next row
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 512;  // the largest block of the row path
// 16-byte chunks of a row a thread holds: four spill at the 32 registers a
// thread has at 2,048 threads an SM, and measured no faster than three
constexpr int kMaxFwdChunks = 3;

// Each row group of tpr threads (a part of a warp, a warp or a few warps;
// blockDim.x / tpr groups a block) normalises one row; thread t of the
// group owns the 16-byte chunks c * tpr + t (c < NV).  With vec it copies
// them from device memory into its own slots of shared memory with
// cp.async (no registers hold data in flight, so all NV copies of all the
// SM's threads overlap), and reads them there for the sum of squares and
// again for the scaled store; w's chunks are read at the store (L1/L2).
// Otherwise it reads its chunks element by element, twice, the second time
// from L1/L2.  The sum reduces by shuffles within a warp and, for a group
// of several warps, one exchange through shared memory and a named
// barrier.  Groups past the last row still take part in their warp's
// shuffles.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kFwdThreads, 2048 / kFwdThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, int rows, int D, int tpr, int vec,
                   float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint4 slots[];  // [NV][blockDim.x] chunks of x
  __shared__ float red[kFwdThreads / 32];
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / tpr) + grp;
  const bool live = row < rows;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * D;
  const auto chunk = [&](int c) -> Pack<T, VEC> {
    return vec ? reinterpret_cast<const Pack<T, VEC>&>(
                     slots[c * blockDim.x + threadIdx.x])
               : load_chunk<T, VEC>(xr, (c * tpr + t) * VEC, D, false);
  };

  if (vec && live) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * tpr + t) * VEC;
      if (col < D)
        tc::cp_async16(tc::smem_addr(slots + c * blockDim.x + threadIdx.x),
                       xr + col, 16);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  float ss = 0.f;
  if (live) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      if ((c * tpr + t) * VEC >= D) continue;
      const Pack<T, VEC> xv = chunk(c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = to_f32(xv.e[i]);
        ss += xf * xf;
      }
    }
  }
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {
    if (lane == 0) red[warp] = ss;
    group_sync(1 + grp, tpr);
    ss = 0.f;
    for (int i = 0; i < tpr / 32; ++i) ss += red[grp * (tpr / 32) + i];
  }
  if (!live) return;
  // read x again from shared memory rather than hold it in registers
  asm volatile("" ::: "memory");
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  T* yr = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (c * tpr + t) * VEC;
    if (col >= D) continue;
    const Pack<T, VEC> xv = chunk(c);
    const Pack<W, VEC> wv = load_chunk<W, VEC>(w, col, D, vec);
    Pack<T, VEC> y;
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      y.e[i] = from_f32<T>((to_f32(xv.e[i]) * r) * to_f32(wv.e[i]));
    store_chunk<T, VEC>(yr, col, D, vec, y);
  }
}

// Rows too wide for registers (more than kMaxFwdChunks * kFwdThreads
// chunks): one block a row at a time, the row walked twice by 16-byte
// chunks (element by element unless vec), the second walk from L1/L2.
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_fwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        T* __restrict__ out, int rows, int D, int vec,
                        float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[1][kWideThreads / 32];
  const int chunks = (D + VEC - 1) / VEC;
  const float d = static_cast<float>(D);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * D;
    T* yr = out + static_cast<size_t>(row) * D;
    float ss[1] = {0.f};
#pragma unroll 4
    for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
      const Pack<T, VEC> xv = load_chunk<T, VEC>(xr, c * VEC, D, vec);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = to_f32(xv.e[i]);
        ss[0] += xf * xf;
      }
    }
    block_sum(ss, red);
    const float r = 1.0f / sqrtf(ss[0] / d + eps);
#pragma unroll 4
    for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
      const Pack<T, VEC> xv = load_chunk<T, VEC>(xr, c * VEC, D, vec);
      const Pack<W, VEC> wv = load_chunk<W, VEC>(w, c * VEC, D, vec);
      Pack<T, VEC> y;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        y.e[i] = from_f32<T>((to_f32(xv.e[i]) * r) * to_f32(wv.e[i]));
      store_chunk<T, VEC>(yr, c * VEC, D, vec, y);
    }
  }
}

struct FwdArgs {
  const void* x;
  const void* w;
  void* out;
  int rows, D, tpr, threads, grid, nv, vec;
  float eps;
};

template <typename T, typename W, int NV>
cudaError_t launch_fwd_rows(const FwdArgs& a, cudaStream_t stream) {
  // at most 3 chunks of 512 threads: 24 KB, under the 48 KB a launch may
  // ask for without an attribute
  const int smem = a.vec ? NV * a.threads * 16 : 0;
  rmsnorm_fwd_kernel<T, W, NV><<<a.grid, a.threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const W*>(a.w),
      static_cast<T*>(a.out), a.rows, a.D, a.tpr, a.vec, a.eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  switch (a.nv) {
    case 0:
      rmsnorm_fwd_wide_kernel<T, W><<<a.grid, kWideThreads, 0, stream>>>(
          static_cast<const T*>(a.x), static_cast<const W*>(a.w),
          static_cast<T*>(a.out), a.rows, a.D, a.vec, a.eps);
      return cudaGetLastError();
    case 1: return launch_fwd_rows<T, W, 1>(a, stream);
    case 2: return launch_fwd_rows<T, W, 2>(a, stream);
    case 3: return launch_fwd_rows<T, W, 3>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kMaxBwdD = 227 * 1024 / 4 - 64;  // D floats of shared memory
constexpr int kBwdThreads = 512;  // a block: 512 / tpr row groups
// 16-byte chunks of a row a thread holds: at 512 threads an SM a thread
// has 128 registers, and four bf16 chunks spill
constexpr int kMaxChunks = 3;
constexpr int kStages = 2;  // rows of a thread's ring in shared memory

struct Args {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  void* dw;
  float* ws;  // parts x D
  int rows, D, parts, vec;
  float eps;
};

// Each row group of tpr threads (a few warps) walks rows grp, grp + groups
// in all, ...; thread t of a group owns the 16-byte chunks c * tpr + t
// (c < NV) of every row, so it loads w once, keeps the row's x and dy in
// registers between the sums and the write of dx, and keeps its columns'
// dw partial sums in registers across all its rows.  With vec, each thread
// copies its own chunks of its next rows into its own slots of a ring of
// kStages rows in shared memory (cp.async), kStages - 1 rows ahead, so its
// wait needs no barrier and the loads of later rows overlap this row's
// work; otherwise it loads element by element.  The sums reduce by
// shuffles within a warp and one exchange of the group's warps through
// shared memory (two buffers by row parity, one named barrier a row).  At
// the end the block's groups add their dw partials in group order into the
// block's row of the workspace.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_part, int rows, int D, int tpr,
                   int vec, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  // [kStages][NV][x, dy][kBwdThreads] chunks; at the end, (groups - 1) x D
  // floats: groups 1.. dw partials
  extern __shared__ uint4 ring[];
  __shared__ float red[2][kBwdThreads / 32][2];
  const int groups = kBwdThreads / tpr;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = tpr / 32, w_first = grp * wpr;
  const int first = blockIdx.x * groups + grp, stride = gridDim.x * groups;
  const float inv_d = 1.0f / static_cast<float>(D);
  const auto slot = [&](int stage, int c, int which) {
    return ((stage * NV + c) * 2 + which) * kBwdThreads + threadIdx.x;
  };
  // rows past the end commit an empty group: the wait counts stay uniform
  const auto prefetch = [&](int row, int stage) {
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = (c * tpr + t) * VEC;
        if (col >= D) continue;
        const size_t off = static_cast<size_t>(row) * D + col;
        tc::cp_async16(tc::smem_addr(ring + slot(stage, c, 0)), x + off, 16);
        tc::cp_async16(tc::smem_addr(ring + slot(stage, c, 1)), dy + off,
                       16);
      }
    }
    tc::cp_async_commit();
  };

  Pack<W, VEC> wv[NV];
  float dwp[NV][VEC];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int col = (c * tpr + t) * VEC;
    if (col < D) wv[c] = load_chunk<W, VEC>(w, col, D, vec);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dwp[c][i] = 0.f;
  }
  if (vec)
    for (int s = 0; s < kStages - 1; ++s) prefetch(first + s * stride, s);
  int parity = 0;
  for (int row = first, j = 0; row < rows; row += stride, ++j) {
    Pack<T, VEC> xv[NV], gv[NV];
    if (vec) {
      prefetch(row + (kStages - 1) * stride, (j + kStages - 1) % kStages);
      tc::cp_async_wait<kStages - 1>();  // this row's chunks have landed
    }
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * tpr + t) * VEC;
      if (col >= D) continue;
      if (vec) {
        xv[c] = reinterpret_cast<const Pack<T, VEC>&>(
            ring[slot(j % kStages, c, 0)]);
        gv[c] = reinterpret_cast<const Pack<T, VEC>&>(
            ring[slot(j % kStages, c, 1)]);
      } else {
        xv[c] = load_chunk<T, VEC>(xr, col, D, false);
        gv[c] = load_chunk<T, VEC>(gr, col, D, false);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = to_f32(xv[c].e[i]);
        ss += xf * xf;
        gx += to_f32(gv[c].e[i]) * to_f32(wv[c].e[i]) * xf;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0) {
      red[parity][warp][0] = ss;
      red[parity][warp][1] = gx;
    }
    group_sync(1 + grp, tpr);
    ss = gx = 0.f;
    for (int i = 0; i < wpr; ++i) {
      ss += red[parity][w_first + i][0];
      gx += red[parity][w_first + i][1];
    }
    parity ^= 1;  // the other buffer is free: its readers passed the barrier
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float cc = gx * inv_d * r * r * r;
    T* dxr = dx + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = (c * tpr + t) * VEC;
      if (col >= D) continue;
      Pack<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = to_f32(xv[c].e[i]), gf = to_f32(gv[c].e[i]);
        out.e[i] = from_f32<T>(gf * to_f32(wv[c].e[i]) * r - xf * cc);
        dwp[c][i] += gf * (xf * r);
      }
      if (vec) {
        *reinterpret_cast<Pack<T, VEC>*>(dxr + col) = out;
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (col + i < D) dxr[col + i] = out.e[i];
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
  float* others = reinterpret_cast<float*>(ring);
  if (grp > 0) {
    float* mine = others + static_cast<size_t>(grp - 1) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int col = (c * tpr + t) * VEC + i;
        if (col < D) mine[col] = dwp[c][i];
      }
  }
  __syncthreads();
  if (grp == 0) {
    float* part = dw_part + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int col = (c * tpr + t) * VEC + i;
        if (col >= D) continue;
        float s = dwp[c][i];
        for (int g = 1; g < groups; ++g)
          s += others[static_cast<size_t>(g - 1) * D + col];
        part[col] = s;
      }
  }
}

// Rows too wide for registers (more than kMaxChunks * kBwdThreads chunks):
// one block of 256 threads a row at a time, the row walked twice, the
// block's dw partial sums in shared memory, one column a thread.
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw_part, int rows, int D,
                        float eps) {
  extern __shared__ float acc[];  // [D]: this block's partial sums of dw
  __shared__ float red[2][kWideThreads / 32];
  for (int i = threadIdx.x; i < D; i += kWideThreads) acc[i] = 0.f;
  const float inv_d = 1.0f / static_cast<float>(D);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    T* dxr = dx + static_cast<size_t>(row) * D;
    float ss = 0.f, gx = 0.f;
    for (int i = threadIdx.x; i < D; i += kWideThreads) {
      const float xv = to_f32(xr[i]);
      ss += xv * xv;
      gx += to_f32(gr[i]) * to_f32(w[i]) * xv;
    }
    float sums[2] = {ss, gx};
    block_sum(sums, red);
    ss = sums[0];
    gx = sums[1];
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float c = gx * inv_d * r * r * r;
    for (int i = threadIdx.x; i < D; i += kWideThreads) {
      const float xv = to_f32(xr[i]), gv = to_f32(gr[i]);
      dxr[i] = from_f32<T>(gv * to_f32(w[i]) * r - xv * c);
      acc[i] += gv * (xv * r);
    }
  }
  // each thread reads back only the columns it wrote
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += kWideThreads) part[i] = acc[i];
}

// dw = the blocks' partial sums added in block order, column by column
constexpr int kDwThreads = 64;

template <typename W>
__global__ void __launch_bounds__(kDwThreads)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, W* __restrict__ dw,
                  int parts, int D) {
  const int i = blockIdx.x * kDwThreads + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
#pragma unroll 16
  for (int p = 0; p < parts; ++p)
    s += dw_part[static_cast<size_t>(p) * D + i];
  dw[i] = from_f32<W>(s);
}

template <typename T, typename W, int NV>
cudaError_t launch_rows(const Args& a, int tpr, cudaStream_t stream) {
  const int ring = kStages * NV * 2 * kBwdThreads * 16;
  const int others = (kBwdThreads / tpr - 1) * a.D * 4;
  const int smem = ring > others ? ring : others;
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, W, NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_kernel<T, W, NV><<<a.parts, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const W*>(a.w),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.ws, a.rows, a.D,
      tpr, a.vec, a.eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const Args& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (a.D + VEC - 1) / VEC;
  int tpr = 64;  // the fewest threads a row that hold it in registers
  while (tpr < kBwdThreads && chunks > kMaxChunks * tpr) tpr *= 2;
  const int nv = (chunks + tpr - 1) / tpr;
  cudaError_t err;
  if (nv == 1) err = launch_rows<T, W, 1>(a, tpr, stream);
  else if (nv == 2) err = launch_rows<T, W, 2>(a, tpr, stream);
  else if (nv == 3) err = launch_rows<T, W, 3>(a, tpr, stream);
  else {
    const int smem = a.D * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(rmsnorm_bwd_wide_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    rmsnorm_bwd_wide_kernel<T, W><<<a.parts, kWideThreads, smem, stream>>>(
        static_cast<const T*>(a.x), static_cast<const W*>(a.w),
        static_cast<const T*>(a.dy), static_cast<T*>(a.dx), a.ws, a.rows,
        a.D, a.eps);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<W><<<(a.D + kDwThreads - 1) / kDwThreads, kDwThreads, 0,
                         stream>>>(a.ws, static_cast<W*>(a.dw), a.parts,
                                   a.D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  The launch geometry comes from
// the wrapper (kernels/rmsnorm.py::layout): nv 16-byte chunks a thread
// (1..3) on the row path, where groups of tpr threads (a power of two
// below 32, else a multiple of 32) fill blocks of `threads` and a grid of
// `grid` blocks of threads / tpr rows each cover the rows; nv = 0 takes
// the wide path (`grid` blocks of 256 threads walk the rows, a block a
// row at a time).  Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int D, int x_dtype, int w_dtype,
                              float eps, int tpr, int threads, int grid,
                              int nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_x = x_dtype == 0 ? 4 : 8;  // elements of a 16-byte chunk
  const bool bad_rows =
      nv < 0 || nv > kMaxFwdChunks ||
      (nv > 0 && (threads <= 0 || threads > kFwdThreads || threads % 32 ||
                  tpr <= 0 || threads % tpr ||
                  (tpr < 32 ? (tpr & (tpr - 1)) : tpr % 32) ||
                  static_cast<long long>(nv) * tpr * vec_x < D ||
                  static_cast<long long>(grid) * (threads / tpr) < rows)) ||
      (nv == 0 && threads != kWideThreads);
  if (rows <= 0 || D <= 0 || grid <= 0 || bad_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const FwdArgs a{x, w, out, rows, D, tpr, threads, grid, nv,
                  D % vec_x == 0 && aligned(x) && aligned(w) && aligned(out),
                  eps};
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_fwd<float, float>(a, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_fwd<float, __nv_bfloat16>(a, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_fwd<__nv_bfloat16, float>(a, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_fwd<__nv_bfloat16, __nv_bfloat16>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// parts blocks (1 <= parts <= rows) sum dw: the workspace ws holds their
// parts x D float32 partial sums.  dtype codes as above.  Returns a
// cudaError_t.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* ws, int rows, int D, int parts,
                                  int x_dtype, int w_dtype, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0 || D > kMaxBwdD || parts <= 0 || parts > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = x_dtype == 0 ? 4 : 8;  // elements of a 16-byte chunk
  const Args a{x, w, dy, dx, dw, static_cast<float*>(ws), rows, D, parts,
               D % vec_x == 0 && aligned(x) && aligned(w) && aligned(dy) &&
                   aligned(dx),
               eps};
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_bwd<float, float>(a, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_bwd<float, __nv_bfloat16>(a, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_bwd<__nv_bfloat16, float>(a, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
