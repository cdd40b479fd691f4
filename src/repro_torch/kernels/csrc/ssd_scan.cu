// Mamba2 SSD chunked scan on Hopper (sm_90a), ngroups = 1.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd_scan.py
// (ssd_scan, _ssd_kernel).  Same function, per (batch, head) and chunk of
// Q steps, with cum = the in-chunk cumulative sum of dA = dt * A:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (h C_i)                       (h: state before)
//   h    <- h exp(cum_{Q-1}) + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_j^T
// L is built from differences of cum, as the TPU kernel builds it.  y is
// written in x's dtype, the final state (hp, st) in float32.
//
// Widths.  hp <= 64, and the state st <= 128, as the TPU kernel's tiles
// (st = 64 or 128).  Every kernel is a template on kS, the state columns
// of its tiles: 64 for st <= 64 (Zamba2), 128 above (Mamba2-2.7B); widths
// below kS are zero-filled.  The state is never split into two launches
// of 64 whose outputs are added: y would be rounded to bf16 twice.
//
// What bounds it.  At Zamba2's prefill (Q = 256, hp = st = 64, nh = 112) a
// chunk costs a (Q, Q) score product over st, the masked (Q, Q) by
// (Q, hp) product, and two (Q, 64, st) products for the offset and the
// state: about 120 operations for each byte of x, B, C, dt read and y
// written (about 150 at st = 128), below the tensor cores' ~295 a byte, so
// on the tensor cores the work is bound by its bytes; on the CUDA cores (67
// TFLOP/s float32) it would be bound by its operations.
//
// Two designs, by the dtype of x.
//
// bfloat16 x (the serving path): Mamba2's GPU formulation, in three
// kernels that run in order on the stream, with a float32 workspace that
// the wrapper allocates.
//   1. ssd_state_kernel, one block per (batch, head block of kHB = 4
//      heads, chunk): cum (summed in order by one thread a head, as
//      torch.cumsum sums it on the card, since exp of its differences
//      amplifies any other rounding of a long chunk's sums), the chunk's
//      own state S_c = (x w)^T B (64 x kS) with w_j = exp(cum_{Q-1} -
//      cum_j) dt_j, and its total decay.  It also leaves cum and dt by
//      head, and the blocks of the first head block leave B and C as bf16
//      hi/lo planes (4 kS aligned bytes a row, zero past st), for kernel 3.
//   2. ssd_pass_kernel, one thread per (batch, head, state element): the
//      serial pass over chunks, h <- h exp(total_c) + S_c, in float32 as
//      the reference runs it; it leaves the state before each chunk as a
//      plane, and writes the final state.
//   3. ssd_out_kernel, one block per (batch, head block, chunk, 64-row
//      tile), a chunk's row tiles side by side, heaviest first: y =
//      exp(cum_i) (C_i h^T) + sum_{j <= i} (C_i B_j^T o L o dt_j) x_j.
//      Each 64 x 64 tile of C B^T is formed once for the block's 4 heads:
//      each warpgroup forms half of it, and both read the whole from
//      shared memory where M is built.
// All four tile products (C B^T, the masked M times x, C h^T and
// (x w)^T B) are Hopper warpgroup products (wgmma, wgmma.cuh) with float32
// accumulators: a block is two warpgroups, each owning all 64 rows of a
// tile for 2 of the 4 heads.  Operands in shared memory are bf16 tiles of
// 64 rows in 64-column blocks with the 128-byte swizzle (kS / 64 blocks
// across the state), and every one arrives by cp.async (x as it is, B, C
// and h from the planes), the next while the current one is multiplied.
// C B^T and C h^T take kS / 16 k-steps over the state; (x w)^T B is one
// m64n64 or m64n128 product a k-step.  x is bf16 and enters as it is.
// Every float32 operand (B, C, the masked decay tile M, h, x w) enters as
// a bf16 hi/lo pair: three products where both operands are float32, two
// where one is bf16, so no operand loses more than about 2^-16 of itself.
// M and x w are built in registers, in the layout of a wgmma A operand,
// from the C B^T halves and from x's transposed fragments (ldmatrix,
// tensor_core.cuh); two 16-column steps are in flight, so that one step's
// fragments are built while the step before multiplies.  What holds kernel
// 3 is M's construction (an exp and a split for each of its elements, for
// every head) and the bytes of x, h and y; see PERF.md.  Heads past nh,
// rows past the chunk and widths below 64 (hp) or kS (st) are zero-filled
// or masked.
//
// Shared memory a block, of the 227 KB a block may take: kernels 1 and 3
// hold (4 kS / 64 + 8) tiles of 8 KB and cum and dt of 4 heads (32 Q
// bytes), + 1 KB to align: kS = 64, 105 KB at Q = 256 (two blocks an SM)
// and 129 KB at Q = 1024; kS = 128, 137 KB at Q = 256 (one block an SM)
// and 161 KB at Q = 1024.  At kS = 128 kernel 1 holds a 64 x 128 float32
// accumulator for each of a thread's two heads (128 registers): both
// kernels run one block an SM at kS = 128, with up to 255 registers a
// thread.
//
// float32 x (ssd_kernel, as first written): the TPU kernel's arithmetic on
// the CUDA cores.  One block of 256 threads owns
// one (batch, head) and walks the chunks in order, h (64 x kS float32) in
// shared memory; the chunk's rows are tiled by 64, and for each row tile
// the masked 64 x 64 tile of (C B^T) * exp(cum_i - cum_j) * dt_j is formed
// in shared memory and multiplied into y; the state update walks the
// column tiles once more.  89 KB of shared memory a block at kS = 64, 137
// KB at kS = 128 (KB = 1,024 bytes throughout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_tiles.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kT = 64;          // tile rows and columns; the widest hp
constexpr int kStride = kT + 1;
constexpr int kMaxState = 2 * kT;
constexpr int kMaxChunk = 1024;
constexpr int kThreads = 256;   // 16 x 16

// the float32 kernel's shared memory: cum and dt, the x and M tiles
// (64 x 64), and the C, B and h tiles (64 x kS)
template <int kS>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kMaxChunk + 2 * kT * kStride + 3 * kT * (kS + 1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// rows [r0, r0 + kT) of a (., width) float32 matrix with row stride `ld`,
// kS columns at a row stride of kS + 1, zero past `rows` and past `width`
template <int kS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t ld, int r0, int rows,
                                          int width) {
  for (int idx = threadIdx.x; idx < kT * kS; idx += kThreads) {
    const int r = idx / kS, c = idx % kS;
    const int row = r0 + r;
    dst[r * (kS + 1) + c] =
        (row < rows && c < width) ? src[row * ld + c] : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage_x(float* dst, const T* src, size_t ld,
                                        int r0, int rows, int width) {
  for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
    const int r = idx / kT, c = idx % kT;
    const int row = r0 + r;
    dst[r * kStride + c] =
        (row < rows && c < width) ? to_f32(src[row * ld + c]) : 0.f;
  }
}

// out[a][c] = sum_{s < n} P[ty + 16a][s] * R[tx + 16c][s] over two staged
// tiles of row stride LD: a 4 x 4 register tile a thread, 8 shared loads
// for 16 products
template <int LD>
__device__ __forceinline__ void tile_product(float (&out)[4][4],
                                             const float* P, const float* R,
                                             int n) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.f;
  for (int s = 0; s < n; ++s) {
    float pv[4], rv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pv[a] = P[(ty + 16 * a) * LD + s];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = R[(tx + 16 * c) * LD + s];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[a][c] += pv[a] * rv[c];
  }
}

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state, int S, int nh, int hp, int st,
           int Q) {
  constexpr int kSS = kS + 1;          // row stride of the state tiles
  constexpr int kSC = kS / 16;         // a thread's state columns
  extern __shared__ float smem[];
  float* cum = smem;                    // [kMaxChunk]
  float* dts = cum + kMaxChunk;         // [kMaxChunk]: dt, then state weights
  float* Xs = dts + kMaxChunk;          // [kT][kStride]  x rows j
  float* Ms = Xs + kT * kStride;        // [kT][kStride]  masked decay tile
  float* Cs = Ms + kT * kStride;        // [kT][kSS]      C rows i
  float* Bs = Cs + kT * kSS;            // [kT][kSS]      B rows j
  float* Hs = Bs + kT * kSS;            // [kT][kSS]      h[p][s]

  const int bi = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a_h = A[hh];
  const size_t x_ld = static_cast<size_t>(nh) * hp;
  const T* xb = x + static_cast<size_t>(bi) * S * x_ld + hh * hp;
  T* yb = y + static_cast<size_t>(bi) * S * x_ld + hh * hp;
  const float* dtb = dt + static_cast<size_t>(bi) * S * nh + hh;
  const float* Bb = Bm + static_cast<size_t>(bi) * S * st;
  const float* Cb = Cm + static_cast<size_t>(bi) * S * st;

  for (int idx = tid; idx < kT * kSS; idx += kThreads) Hs[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // dt of the chunk, and cum = inclusive cumsum of dt * A (one warp:
    // each lane walks a run of consecutive steps, then a shuffle scan of
    // the runs' totals)
    for (int j = tid; j < Q; j += kThreads) dts[j] = dtb[(c0 + j) * nh];
    __syncthreads();
    if (tid < 32) {
      const int run = (Q + 31) / 32;
      const int j0 = tid * run, j1 = min(j0 + run, Q);
      float acc = 0.f;
      for (int j = j0; j < j1; ++j) {
        acc += dts[j] * a_h;
        cum[j] = acc;
      }
      float incl = acc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) before = 0.f;
      for (int j = j0; j < j1; ++j) cum[j] += before;
    }
    __syncthreads();

    const T* xc = xb + static_cast<size_t>(c0) * x_ld;
    T* yc = yb + static_cast<size_t>(c0) * x_ld;
    const float* Bc = Bb + static_cast<size_t>(c0) * st;
    const float* Cc = Cb + static_cast<size_t>(c0) * st;

    for (int i0 = 0; i0 < Q; i0 += kT) {
      stage_f32<kS>(Cs, Cc, st, i0, Q, st);
      __syncthreads();

      // offset from the carried state: exp(cum_i) * (C_i . h[p])
      float acc[4][4];
      tile_product<kSS>(acc, Cs, Hs, st);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ig = i0 + ty + 16 * a;
        const float decay = ig < Q ? expf(cum[ig]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[a][cc] *= decay;
      }

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // Bs, Xs and Ms of the previous tile consumed
        stage_f32<kS>(Bs, Bc, st, j0, Q, st);
        stage_x(Xs, xc, x_ld, j0, Q, hp);
        __syncthreads();
        float sc[4][4];
        tile_product<kSS>(sc, Cs, Bs, st);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a, ig = i0 + i;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = tx + 16 * cc, jg = j0 + j;
            Ms[i * kStride + j] =
                (jg <= ig && ig < Q)
                    ? sc[a][cc] * expf(cum[ig] - cum[jg]) * dts[jg]
                    : 0.f;
          }
        }
        __syncthreads();
        const int nj = min(kT, Q - j0);
        for (int j = 0; j < nj; ++j) {
          float xv[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            xv[cc] = Xs[j * kStride + tx + 16 * cc];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float m = Ms[(ty + 16 * a) * kStride + j];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[a][cc] += m * xv[cc];
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ig = i0 + ty + 16 * a;
        if (ig >= Q) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int p = tx + 16 * cc;
          if (p < hp) yc[ig * x_ld + p] = from_f32<T>(acc[a][cc]);
        }
      }
      __syncthreads();  // Cs consumed before the next row tile
    }

    // state: h <- h exp(cum_last) + sum_j w_j x_j B_j^T,
    // w_j = exp(cum_last - cum_j) dt_j (written over dt)
    const float cum_last = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = expf(cum_last - cum[j]) * dts[j];
    const float g = expf(cum_last);
    float hacc[4][kSC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc)
        hacc[a][cc] = Hs[(ty + 16 * a) * kSS + tx + 16 * cc] * g;
    for (int j0 = 0; j0 < Q; j0 += kT) {
      __syncthreads();
      stage_f32<kS>(Bs, Bc, st, j0, Q, st);
      stage_x(Xs, xc, x_ld, j0, Q, hp);
      __syncthreads();
      const int nj = min(kT, Q - j0);
      for (int j = 0; j < nj; ++j) {
        const float w = dts[j0 + j];
        float bv[kSC];
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) bv[cc] = Bs[j * kSS + tx + 16 * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float xw = Xs[j * kStride + ty + 16 * a] * w;
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) hacc[a][cc] += xw * bv[cc];
        }
      }
    }
    __syncthreads();  // every read of the old h and of dts is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc)
        Hs[(ty + 16 * a) * kSS + tx + 16 * cc] = hacc[a][cc];
    __syncthreads();
  }

  float* sb = state + static_cast<size_t>(blockIdx.x) * hp * st;
  for (int idx = tid; idx < hp * st; idx += kThreads) {
    const int p = idx / st, s = idx % st;
    sb[idx] = Hs[p * kSS + s];
  }
}

template <typename T, int kS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state, int b,
                   int S, int nh, int hp, int st, int Q,
                   cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<kS>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T, kS><<<b * nh, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<T*>(y),
      static_cast<float*>(state), S, nh, hp, st, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 x: tensor cores, chunk-parallel
// ---------------------------------------------------------------------------

namespace bf16 {

using ssdt::mma_rs_state;
using ssdt::seq_cumsum;
using ssdt::split_raw;
using ssdt::stage_plane;
using ssdt::stage_raw;
using ssdt::stage_x;
using tc::swz;
using tc::swz_tile;
constexpr int kHB = 4;               // heads a block
constexpr int kWarps = 8;            // a 16-row slab of a tile x 2 heads
constexpr int kThreads2 = kWarps * 32;
constexpr int kTileBytes = kT * kT * 2;  // one 64 x 64 bf16 tile

// A plane holds float32 rows of up to kS values as bf16 hi (columns
// 0 .. kS-1) and lo (kS .. 2 kS-1), zero past the row's width: 4 kS aligned
// bytes a row, so that any tile of it is a cp.async copy.  A tile of kS
// state columns is kS / 64 column blocks of 64 x 64 (swz_tile<kT>).
struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  __nv_bfloat16* y;
  float* state;
  float* s_c;            // (b, nc, nh, hp, st): each chunk's own state
  float* total;          // (b, nc, nh): cum at the chunk's last step
  __nv_bfloat16* h_pl;   // (b, nc, nh, 64) planes: the state before chunk c
  __nv_bfloat16* b_pl;   // (b * S) planes of B
  __nv_bfloat16* c_pl;   // (b * S) planes of C
  float* cum_t;          // (b, nc, nh, Q): cum, by head
  float* dt_t;           // (b, nc, nh, Q): dt, by head
  int b, S, nh, hp, st, Q, nc, nhb;
  int vec_x;   // x and y rows in 16-byte chunks (hp % 8 == 0, aligned)
  int vec_bc;  // B and C rows in float4 (st % 4 == 0, aligned)
};

// float32 offsets of the workspace's parts, each 256-byte aligned; `end`
// is its size.  A plane row of kS columns is kS float32 values.  The
// wrapper sizes the workspace by the same sums.
struct Workspace {
  size_t s_c, total, h_pl, b_pl, c_pl, cum_t, dt_t, end;
  Workspace(int b, int S, int nh, int hp, int st, int Q, int kS) {
    const auto up = [](size_t n) { return (n + 63) / 64 * 64; };
    const size_t nc = S / Q;
    s_c = 0;
    total = up(static_cast<size_t>(b) * nc * nh * hp * st);
    h_pl = total + up(static_cast<size_t>(b) * nc * nh);
    b_pl = h_pl + static_cast<size_t>(b) * nc * nh * kT * kS;
    c_pl = b_pl + static_cast<size_t>(b) * S * kS;
    cum_t = c_pl + static_cast<size_t>(b) * S * kS;
    dt_t = cum_t + up(static_cast<size_t>(b) * S * nh);
    end = dt_t + up(static_cast<size_t>(b) * S * nh);
  }
};

// Rows [0, nrows) of a float32 matrix (row stride ld; zero at columns >=
// ncols), split into bf16 hi and lo, as plane rows of kS columns.  The
// loads of each half are issued before its first store.
template <int kS>
__device__ __forceinline__ void write_plane(__nv_bfloat16* pl,
                                            const float* src, size_t ld,
                                            int nrows, int ncols, bool vec) {
  constexpr int kQuads = kS / 4;                         // float4 a row
  constexpr int kIters = kT * kQuads / kThreads2 / 2;    // two batches
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + (half * kIters + it) * kThreads2;
      const int r = idx / kQuads, c = (idx % kQuads) * 4;
      v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows) {
        const float* s = src + static_cast<size_t>(r) * ld + c;
        if (vec) {
          if (c < ncols) v[it] = *reinterpret_cast<const float4*>(s);
        } else {
          if (c < ncols) v[it].x = s[0];
          if (c + 1 < ncols) v[it].y = s[1];
          if (c + 2 < ncols) v[it].z = s[2];
          if (c + 3 < ncols) v[it].w = s[3];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int idx = threadIdx.x + (half * kIters + it) * kThreads2;
      const int r = idx / kQuads, c = (idx % kQuads) * 4;
      if (r >= nrows) continue;
      uint32_t h0, l0, h1, l1;
      tc::split(v[it].x, v[it].y, h0, l0);
      tc::split(v[it].z, v[it].w, h1, l1);
      __nv_bfloat16* row = pl + static_cast<size_t>(r) * 2 * kS + c;
      *reinterpret_cast<uint2*>(row) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(row + kS) = make_uint2(l0, l1);
    }
  }
}

// dt of the block's heads at steps [0, len) of the chunk from `t0`, into
// [kHB][Q] (0 for heads past nh); neighbouring threads read neighbouring
// heads, and each thread's loads are issued before its stores
__device__ __forceinline__ void load_dt(float* dts, const Args& a, size_t t0,
                                        int h0, int nheads, int len) {
  constexpr int kBatch = 8;
  const int n = kHB * len;
  for (int base = 0; base < n; base += kBatch * kThreads2) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads2 + threadIdx.x;
      const int t = idx / kHB, hh = idx % kHB;
      v[u] = idx < n && hh < nheads ? a.dt[(t0 + t) * a.nh + h0 + hh] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads2 + threadIdx.x;
      if (idx < n) dts[(idx % kHB) * a.Q + idx / kHB] = v[u];
    }
  }
}

// 1. the chunk's own state S_c = (x w)^T B, per head, and its total decay;
// the blocks of the first head block also write the chunk's rows of B and
// C as planes for kernel 3.  At kS = 128 a thread's two 64 x 128
// accumulators take 128 registers: one block an SM, 255 registers a
// thread.
template <int kS>
__global__ void __launch_bounds__(kThreads2, kS == kT ? 2 : 1)
ssd_state_kernel(Args a) {
  constexpr int kSW = kS / kT;        // column blocks across the state
  constexpr int kPlane = 2 * kS;      // bf16 a plane row
  extern __shared__ unsigned char smem_raw[];
  // tiles at 1024-byte boundaries, as wgmma's swizzled descriptors need
  const uint32_t raw = tc::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sBh = tc::smem_addr(smem), sBl = sBh + kSW * kTileBytes;
  const uint32_t sX0 = sBl + kSW * kTileBytes;    // kHB tiles, x of even j
  const uint32_t sX1 = sX0 + kHB * kTileBytes;    // kHB tiles, x of odd j
  const uint32_t sRaw = sX1 + kHB * kTileBytes;   // B_j as it is, float32
  const float* raw_b = reinterpret_cast<const float*>(
      smem + (2 * kSW + 2 * kHB) * kTileBytes);
  float* dts = reinterpret_cast<float*>(
      smem + (4 * kSW + 2 * kHB) * kTileBytes);
  float* cum = dts + kHB * a.Q;

  const int Q = a.Q;
  const int c = blockIdx.x % a.nc, rest = blockIdx.x / a.nc;
  const int hb = rest % a.nhb, bb = rest / a.nhb;
  const int h0 = hb * kHB, nheads = min(kHB, a.nh - h0);
  const size_t t0 = static_cast<size_t>(bb) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(a.nh) * a.hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const auto load_j = [&](int j0) {  // B_j and x_j, as they are
    const int nrows = min(kT, Q - j0);
    stage_raw<kS>(sRaw, a.B + (t0 + j0) * a.st, a.st, nrows, a.st, a.vec_bc);
    const uint32_t dst = (j0 / kT) % 2 ? sX1 : sX0;
#pragma unroll
    for (int hh = 0; hh < kHB; ++hh)
      if (hh < nheads)
        stage_x(dst + hh * kTileBytes,
                a.x + (t0 + j0) * x_ld + (h0 + hh) * a.hp, x_ld, nrows,
                a.hp, a.vec_x);
  };
  load_j(0);
  tc::cp_async_commit();
  load_dt(dts, a, t0, h0, nheads, Q);
  if (hb == 0)
    for (int j0 = 0; j0 < Q; j0 += kT)
      write_plane<kS>(a.c_pl + (t0 + j0) * kPlane, a.C + (t0 + j0) * a.st,
                      a.st, min(kT, Q - j0), a.st, a.vec_bc);
  __syncthreads();
  if (warp < nheads && lane == 0)
    seq_cumsum(cum + warp * Q, dts + warp * Q, a.A[h0 + warp], Q);
  __syncthreads();
  // cum and dt by head for kernel 3, then w_j = exp(cum_{Q-1} - cum_j) dt_j
  // over dt
  float* cum_t = a.cum_t + ((static_cast<size_t>(bb) * a.nc + c) * a.nh + h0) * Q;
  float* dt_t = a.dt_t + (cum_t - a.cum_t);
  for (int idx = threadIdx.x; idx < nheads * Q; idx += kThreads2) {
    const int hh = idx / Q;
    cum_t[idx] = cum[idx];
    dt_t[idx] = dts[idx];
    dts[idx] = expf(cum[hh * Q + Q - 1] - cum[idx]) * dts[idx];
  }
  if (threadIdx.x < nheads)
    a.total[(static_cast<size_t>(bb) * a.nc + c) * a.nh + h0 + threadIdx.x] =
        cum[threadIdx.x * Q + Q - 1];
  __syncthreads();

  // warp = (slab, pair): rows p = 16 slab + g (+8), columns s, of heads
  // 2 pair and 2 pair + 1
  const int slab = warp & 3, pair = warp >> 2;
  float acc[2][kS / 8][4];
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int n = 0; n < kS / 8; ++n)
      acc[hl][n][0] = acc[hl][n][1] = acc[hl][n][2] = acc[hl][n][3] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kT) {
    const int nrows = min(kT, Q - j0);
    tc::cp_async_wait<0>();
    __syncthreads();  // B_j and x_j have landed
    split_raw<kS>(sBh, sBl, hb == 0 ? a.b_pl + (t0 + j0) * kPlane : nullptr,
                  raw_b, nrows);
    wg::fence_proxy();
    __syncthreads();  // B_j split; its float32 tile is free
    if (j0 + kT < Q) load_j(j0 + kT);  // the next tile, while this one runs
    tc::cp_async_commit();
    const uint32_t sX = (j0 / kT) % 2 ? sX1 : sX0;
    // the warpgroup `pair` takes heads 2 pair and 2 pair + 1: A = (x w)^T
    // (rows p, k = the step j) built in registers from x's transposed
    // fragments times w_j, split into bf16 hi/lo; B = B_j (k = j, n = s)
    // from shared memory, MN-major; hi*hi, hi*lo, lo*hi.  Two k-steps in
    // flight: a step's fragments are built while the one before it
    // multiplies.
    uint32_t xa[2][2][2][4];  // [step % 2][head][hi, lo]
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) wg::touch(acc[hl]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks * 16 >= nrows) continue;  // the same for the whole block
      uint32_t(&xs)[2][2][4] = xa[ks & 1];
      if (ks >= 2) {
        wg::wait<1>();  // step ks - 2 has read xs
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) wg::touch_a(xs[hl]);
      }
      const uint32_t offA = swz(ks * 16 + (lane & 7) + (lane >> 4) * 8,
                                slab * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int hh = 2 * pair + hl;
        uint32_t xr[4];  // x^T: rows p, k = j (2t, 2t+1 | 8+2t, 9+2t)
        tc::ldsm_x4_t(xr, sX + hh * kTileBytes + offA);
        float wj[4];     // w at those four steps
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wj[u] = dts[hh * Q + min(j0 + ks * 16 + (u >> 1) * 8 + 2 * t4 +
                                       (u & 1), Q - 1)];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(&xr[q]);
          const int u = (q >> 1) * 2;
          tc::split(__low2float(x2) * wj[u], __high2float(x2) * wj[u + 1],
                    xs[hl][0][q], xs[hl][1][q]);
        }
      }
      wg::fence();
      // B_j's 16 rows of this step; its column blocks are kTileBytes apart
      const uint64_t dbh = wg::desc(sBh + ks * 16 * 128, kTileBytes, 1024);
      const uint64_t dbl = wg::desc(sBl + ks * 16 * 128, kTileBytes, 1024);
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        if (2 * pair + hl >= nheads) continue;
        mma_rs_state(acc[hl], xs[hl][0], dbh);
        mma_rs_state(acc[hl], xs[hl][0], dbl);
        mma_rs_state(acc[hl], xs[hl][1], dbh);
      }
      wg::commit();
    }
    wg::wait<0>();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      wg::touch(acc[hl]);
      wg::touch_a(xa[0][hl]);
      wg::touch_a(xa[1][hl]);
    }
    __syncthreads();  // the tiles are consumed before the next are staged
  }

#pragma unroll
  for (int hl = 0; hl < 2; ++hl) {
    const int hh = 2 * pair + hl;
    if (hh >= nheads) continue;
    float* out = a.s_c + ((static_cast<size_t>(bb) * a.nc + c) * a.nh + h0 +
                          hh) * a.hp * a.st;
#pragma unroll
    for (int n = 0; n < kS / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = slab * 16 + g + 8 * r, s = n * 8 + 2 * t4;
        if (p >= a.hp) continue;
        if (a.st % 2 == 0) {
          if (s < a.st)
            *reinterpret_cast<float2*>(out + p * a.st + s) =
                make_float2(acc[hl][n][2 * r], acc[hl][n][2 * r + 1]);
        } else {
          if (s < a.st) out[p * a.st + s] = acc[hl][n][2 * r];
          if (s + 1 < a.st) out[p * a.st + s + 1] = acc[hl][n][2 * r + 1];
        }
      }
  }
}

// 2. the pass over chunks, in float32 as the reference runs it:
// h <- h exp(total_c) + S_c; the state before each chunk c > 0 is written
// as a plane (zero past hp and st) for kernel 3, the final state as it is.
// Each batch of chunks is read before any is written.
template <int kS>
__global__ void ssd_pass_kernel(Args a) {
  constexpr int kBatch = 8;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;  // (p, s) of 64 x kS
  const int p = e / kS, s = e % kS;
  const bool in = p < a.hp && s < a.st;
  const int bb = blockIdx.x / a.nh, hh = blockIdx.x % a.nh;
  const size_t k0 = static_cast<size_t>(bb) * a.nc * a.nh + hh;
  const size_t n = static_cast<size_t>(a.hp) * a.st;
  float h = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float s_c[kBatch], g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const size_t k = k0 + static_cast<size_t>(c0 + i) * a.nh;
      const bool ok = c0 + i < a.nc;
      s_c[i] = ok && in ? a.s_c[k * n + p * a.st + s] : 0.f;
      g[i] = ok ? a.total[k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i;
      if (c >= a.nc) break;
      if (c > 0) {
        __nv_bfloat16* row = a.h_pl +
            ((k0 + static_cast<size_t>(c) * a.nh) * kT + p) * 2 * kS + s;
        const __nv_bfloat16 hi = __float2bfloat16_rn(h);
        row[0] = hi;
        row[kS] = __float2bfloat16_rn(h - __bfloat162float(hi));
      }
      h = __fadd_rn(__fmul_rn(h, expf(g[i])), s_c[i]);  // as torch rounds
    }
  }
  if (in) a.state[static_cast<size_t>(blockIdx.x) * n + p * a.st + s] = h;
}

// 3. y of one 64-row tile of a chunk for the block's heads.  A warpgroup
// owns the tile's 64 rows for two of the heads; the two warpgroups each
// form half of the C B^T tile and put it in shared memory, where M's
// construction reads the whole.  Every tile arrives by cp.async from the
// planes and x: at kS = 64 the second pair of heads' h while the first
// pair's offset is formed (a pair's h takes one x buffer), at kS = 128 B
// (a pair's h takes both); the next column tile's x while one tile's M x
// runs (its B after, as the halves lie where B is kept).  C, B and h are
// kS / 64 column blocks each; C B^T and C h^T take kS / 16 k-steps.  At
// kS = 128 its shared memory leaves room for one block an SM, so it may
// take up to 255 registers a thread (at 128 it spills).
template <int kS>
__global__ void __launch_bounds__(kThreads2, kS == kT ? 2 : 1)
ssd_out_kernel(Args a) {
  constexpr int kSW = kS / kT;        // column blocks across the state
  constexpr int kPlane = 2 * kS;      // bf16 a plane row
  extern __shared__ unsigned char smem_raw[];
  // tiles at 1024-byte boundaries, as wgmma's swizzled descriptors need
  const uint32_t raw = tc::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sCh = tc::smem_addr(smem), sCl = sCh + kSW * kTileBytes;
  const uint32_t sBh = sCl + kSW * kTileBytes, sBl = sBh + kSW * kTileBytes;
  const uint32_t sX0 = sBl + kSW * kTileBytes;    // kHB tiles, x of even j
  const uint32_t sX1 = sX0 + kHB * kTileBytes;    // kHB tiles, x of odd j
  // C B^T halves [slab][half][16][lane], over B once it is consumed
  float* xcb = reinterpret_cast<float*>(smem + 2 * kSW * kTileBytes);
  float* dts = reinterpret_cast<float*>(
      smem + (4 * kSW + 2 * kHB) * kTileBytes);
  float* cum = dts + kHB * a.Q;

  // the row tiles of one (batch, head block, chunk) are neighbours in the
  // grid, heaviest first, so that they share x, B and h through L2
  const int Q = a.Q, ni = (Q + kT - 1) / kT;
  const int it = ni - 1 - static_cast<int>(blockIdx.x % ni);
  int rest = static_cast<int>(blockIdx.x / ni);
  const int c = rest % a.nc;
  rest /= a.nc;
  const int hb = rest % a.nhb, bb = rest / a.nhb;
  const int h0 = hb * kHB, nheads = min(kHB, a.nh - h0);
  const int i0 = it * kT, len = min(i0 + kT, Q);
  const size_t t0 = static_cast<size_t>(bb) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(a.nh) * a.hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slab = warp & 3, pair = warp >> 2;  // heads 2 pair, 2 pair + 1
  const int rl = slab * 16 + g;  // local row of r = 0; r = 1 is rl + 8
  const bool carry = c > 0;      // a state comes in
  const __nv_bfloat16* h_pl =
      a.h_pl + (static_cast<size_t>(bb) * a.nc + c) * a.nh * kT * kPlane;

  // h of heads r and 2 + r (hi, lo each: 2 kS / 64 tiles a head) into
  // the x buffer r at kS = 64, into both x buffers at kS = 128
  const auto h_buf = [&](int r) { return kSW == 1 && r ? sX1 : sX0; };
  const auto load_h = [&](int r) {
    const uint32_t base = h_buf(r);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (2 * q + r < nheads)
        stage_plane<kS>(
            base + 2 * q * kSW * kTileBytes,
            base + (2 * q + 1) * kSW * kTileBytes,
            h_pl + static_cast<size_t>(h0 + 2 * q + r) * kT * kPlane, a.hp);
  };
  const auto load_b = [&](int j0) {  // B_j
    stage_plane<kS>(sBh, sBl, a.b_pl + (t0 + j0) * kPlane, min(kT, Q - j0));
  };
  const auto load_x = [&](int j0) {  // x_j of the block's heads
    const uint32_t dst = (j0 / kT) % 2 ? sX1 : sX0;
#pragma unroll
    for (int hh = 0; hh < kHB; ++hh)
      if (hh < nheads)
        stage_x(dst + hh * kTileBytes,
                a.x + (t0 + j0) * x_ld + (h0 + hh) * a.hp, x_ld,
                min(kT, Q - j0), a.hp, a.vec_x);
  };

  // group 0: C_i, and the first two heads' h
  stage_plane<kS>(sCh, sCl, a.c_pl + (t0 + i0) * kPlane, len - i0);
  if (carry) load_h(0);
  tc::cp_async_commit();
  if (!carry) {
    load_b(0);
    load_x(0);
    tc::cp_async_commit();
  }
  {  // cum and dt of the block's heads at steps [0, len), from kernel 1
    const size_t k0 = ((static_cast<size_t>(bb) * a.nc + c) * a.nh + h0) * Q;
    constexpr int kBatch = 4;
    const int n = nheads * len;
    for (int base = 0; base < n; base += kBatch * kThreads2) {
      float cv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads2 + threadIdx.x;
        const size_t src = k0 + static_cast<size_t>(idx / len) * Q + idx % len;
        cv[u] = idx < n ? a.cum_t[src] : 0.f;
        dv[u] = idx < n ? a.dt_t[src] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads2 + threadIdx.x;
        if (idx < n) {
          cum[(idx / len) * Q + idx % len] = cv[u];
          dts[(idx / len) * Q + idx % len] = dv[u];
        }
      }
    }
  }
  __syncthreads();

  float cr[2][2];  // cum at this thread's two rows, for its two heads
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = 2 * pair + hl, ig = i0 + rl + 8 * r;
      cr[hl][r] = hh < nheads && ig < Q ? cum[hh * Q + ig] : 0.f;
    }

  float y[2][8][4];
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      y[hl][n][0] = y[hl][n][1] = y[hl][n][2] = y[hl][n][3] = 0.f;

  // the carried state's part: y += exp(cum_i) (C_i h^T), C and h as hi/lo;
  // in round r the warp takes its head 2 pair + r.  At kS = 64 round 0
  // loads the second pair's h into the other buffer and round 1 B_0 and
  // x_0; at kS = 128 round 0 loads B_0, round 1 the second pair's h over
  // the first's (waiting for it), and x_0 follows the rounds.
  if (carry) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kSW == 1 && r == 1) {
        load_b(0);
        load_x(0);
      } else if (kSW == 1 || r == 1) {
        load_h(1);
      } else {
        load_b(0);
      }
      tc::cp_async_commit();
      if (kSW == 1 || r == 0) tc::cp_async_wait<1>();
      else tc::cp_async_wait<0>();
      wg::fence_proxy();
      __syncthreads();
      if (2 * pair + r < nheads) {  // the same for the whole warpgroup
        // C_i h^T over the 64 rows, C and h from shared memory (h stored
        // [p][s]: k = s, n = p), hi*hi, hi*lo, lo*hi
        const uint32_t sHh = h_buf(r) + 2 * pair * kSW * kTileBytes;
        const uint32_t sHl = sHh + kSW * kTileBytes;
        float off[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          off[n][0] = off[n][1] = off[n][2] = off[n][3] = 0.f;
        wg::touch(off);
        wg::fence();
#pragma unroll
        for (int ks = 0; ks < kS / 16; ++ks) {
          if (ks * 16 >= a.st) continue;
          // k-step ks: column block ks / 4, 32 bytes a step within it
          const uint32_t kb = (ks >> 2) * kTileBytes + (ks & 3) * 32;
          const uint64_t ch = wg::desc(sCh + kb, 16, 1024);
          const uint64_t cl = wg::desc(sCl + kb, 16, 1024);
          wg::mma_ss_n64(off, ch, wg::desc(sHh + kb, 16, 1024), 1);
          wg::mma_ss_n64(off, ch, wg::desc(sHl + kb, 16, 1024), 1);
          wg::mma_ss_n64(off, cl, wg::desc(sHh + kb, 16, 1024), 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::touch(off);
        const float d0 = expf(cr[r][0]), d1 = expf(cr[r][1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          y[r][n][0] += off[n][0] * d0;
          y[r][n][1] += off[n][1] * d0;
          y[r][n][2] += off[n][2] * d1;
          y[r][n][3] += off[n][3] * d1;
        }
      }
      __syncthreads();  // h consumed before its buffer is reloaded
    }
    if (kSW > 1) {
      load_x(0);
      tc::cp_async_commit();
    }
  }

  // the chunk's own part, one column tile j <= i at a time
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    tc::cp_async_wait<0>();
    wg::fence_proxy();
    __syncthreads();  // B_j and x_j have landed

    // this warpgroup's half of C_i B_j^T: columns j of 32 pair .. + 31 for
    // the 64 rows, C and B from shared memory, hi*hi, hi*lo, lo*hi
    float cbh[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      cbh[n][0] = cbh[n][1] = cbh[n][2] = cbh[n][3] = 0.f;
    wg::touch(cbh);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks) {
      if (ks * 16 >= a.st) continue;
      const uint32_t kc = (ks >> 2) * kTileBytes + (ks & 3) * 32;
      const uint32_t kb = kc + pair * 32 * 128;
      const uint64_t ch = wg::desc(sCh + kc, 16, 1024);
      const uint64_t cl = wg::desc(sCl + kc, 16, 1024);
      wg::mma_ss_n32(cbh, ch, wg::desc(sBh + kb, 16, 1024), 1);
      wg::mma_ss_n32(cbh, ch, wg::desc(sBl + kb, 16, 1024), 1);
      wg::mma_ss_n32(cbh, cl, wg::desc(sBh + kb, 16, 1024), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::touch(cbh);
    __syncthreads();  // B_j consumed: its space takes the halves
    {
      float* mine = xcb + ((slab * 2 + pair) * 16) * 32 + lane;
#pragma unroll
      for (int k = 0; k < 16; ++k) mine[k * 32] = cbh[k >> 2][k & 3];
    }
    __syncthreads();
    // the slab's whole C_i B_j^T, read where M needs it: n-tile n, element
    // e at cbs[(4 n + e) * 32]
    const float* cbs = xcb + slab * 2 * 16 * 32 + lane;
    if (j0 + kT <= i0) load_x(j0 + kT);  // the next x, while M x runs

    const uint32_t sX = (j0 / kT) % 2 ? sX1 : sX0;
    const bool diag = j0 == i0;
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
      const int hh = 2 * pair + hl;
      if (hh >= nheads) continue;  // the same for the whole warpgroup
      const float* cum_h = cum + hh * Q;
      const float* dt_h = dts + hh * Q;
      // y += M x for 16 columns j at a time: M's fragments (rows i, k = j)
      // in bf16 hi/lo from registers, x_j (k = j, n = p) from shared
      // memory, MN-major.  Two steps in flight: a step's M is built while
      // the one before it multiplies.
      uint32_t ma[2][2][4];  // [step % 2][hi, lo]
      wg::touch(y[hl]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (j0 + kk * 16 >= len) continue;  // past the chunk
        uint32_t(&mk)[2][4] = ma[kk & 1];
        if (kk >= 2) {
          wg::wait<1>();  // step kk - 2 has read mk
          wg::touch_a(mk);
        }
        // the thread's four columns j of these 16: cum_j and dt_j
        float cj[4], dj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jc = min(j0 + kk * 16 + (u >> 1) * 8 + 2 * t4 + (u & 1),
                             len - 1);
          cj[u] = cum_h[jc];
          dj[u] = dt_h[jc];
        }
        // M = C B^T o exp(cum_i - cum_j) o dt_j, masked j <= i on the
        // diagonal tile.  Rows past the chunk are never written, so they
        // go unmasked.
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = 2 * kk + (q >> 1), r = q & 1;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = (q >> 1) * 2 + e;
            v[e] = cbs[(4 * n + 2 * r + e) * 32] * __expf(cr[hl][r] - cj[u]) *
                   dj[u];
            if (diag) {
              const int jg = j0 + kk * 16 + (q >> 1) * 8 + 2 * t4 + e;
              if (jg > i0 + rl + 8 * r) v[e] = 0.f;
            }
          }
          tc::split(v[0], v[1], mk[0][q], mk[1][q]);
        }
        wg::fence();
        const uint64_t dx =
            wg::desc(sX + hh * kTileBytes + kk * 16 * 128, kTileBytes, 1024);
        wg::mma_rs_n64(y[hl], mk[0], dx);
        wg::mma_rs_n64(y[hl], mk[1], dx);
        wg::commit();
      }
      wg::wait<0>();
      wg::touch(y[hl]);
      wg::touch_a(ma[0]);
      wg::touch_a(ma[1]);
    }
    __syncthreads();  // the halves are read before B_{j+1} lands on them
    if (j0 + kT <= i0) load_b(j0 + kT);
    tc::cp_async_commit();
  }

#pragma unroll
  for (int hl = 0; hl < 2; ++hl) {
    const int hh = 2 * pair + hl;
    if (hh >= nheads) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ig = i0 + rl + 8 * r;
      if (ig >= Q) continue;
      __nv_bfloat16* yrow = a.y + (t0 + ig) * x_ld + (h0 + hh) * a.hp;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = n * 8 + 2 * t4;
        const float v0 = y[hl][n][2 * r], v1 = y[hl][n][2 * r + 1];
        if (a.hp % 2 == 0) {
          if (p < a.hp)
            *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < a.hp) yrow[p] = __float2bfloat16_rn(v0);
          if (p + 1 < a.hp) yrow[p + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int kS>
cudaError_t run(const void* x, const void* dt, const void* A, const void* B,
                const void* C, void* y, void* state, void* ws,
                long long ws_floats, int b, int S, int nh, int hp, int st,
                int Q, cudaStream_t stream) {
  constexpr int kSW = kS / kT;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Workspace w(b, S, nh, hp, st, Q, kS);
  if (ws_floats < 0 || static_cast<size_t>(ws_floats) < w.end || !aligned(ws))
    return cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.state = static_cast<float*>(state);
  a.s_c = wsf + w.s_c;
  a.total = wsf + w.total;
  a.h_pl = reinterpret_cast<__nv_bfloat16*>(wsf + w.h_pl);
  a.b_pl = reinterpret_cast<__nv_bfloat16*>(wsf + w.b_pl);
  a.c_pl = reinterpret_cast<__nv_bfloat16*>(wsf + w.c_pl);
  a.cum_t = wsf + w.cum_t;
  a.dt_t = wsf + w.dt_t;
  a.b = b, a.S = S, a.nh = nh, a.hp = hp, a.st = st, a.Q = Q;
  a.nc = S / Q;
  a.nhb = (nh + kHB - 1) / kHB;
  a.vec_x = hp % 8 == 0 && aligned(x) && aligned(y);
  a.vec_bc = st % 4 == 0 && aligned(B) && aligned(C);

  // (4 kSW + 2 kHB) tiles, cum and dt of kHB heads, + 1024: room to align
  // the tiles (at most 161 KB: kS = 128, Q = 1024)
  const int smem = (4 * kSW + 2 * kHB) * kTileBytes + 2 * kHB * Q * 4 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_out_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks1 = static_cast<long long>(b) * a.nhb * a.nc;
  const long long blocks3 = blocks1 * ((Q + kT - 1) / kT);
  if (blocks3 > 0x7fffffffLL || static_cast<long long>(b) * nh > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;

  ssd_state_kernel<kS><<<static_cast<unsigned>(blocks1), kThreads2, smem,
                         stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_pass_kernel<kS><<<dim3(b * nh, kT * kS / 256), 256, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_out_kernel<kS><<<static_cast<unsigned>(blocks3), kThreads2, smem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// x_dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, three
// launches).  st <= 64 runs the kernels of 64 state columns, 64 < st <= 128
// those of 128.  ws: float32 scratch of ws_floats values for bfloat16 x
// (the wrapper's _workspace_floats), unused for float32.  Returns a
// cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, void* ws, long long ws_floats,
                               int b, int S, int nh, int hp, int st,
                               int chunk, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || S <= 0 || nh <= 0 || hp <= 0 || hp > kT || st <= 0 ||
      st > kMaxState || chunk <= 0 || chunk > kMaxChunk || S % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = st > kT;
  cudaError_t err;
  if (x_dtype == 0)
    err = wide ? launch<float, 2 * kT>(x, dt, A, B, C, y, state, b, S, nh,
                                       hp, st, chunk, s)
               : launch<float, kT>(x, dt, A, B, C, y, state, b, S, nh, hp,
                                   st, chunk, s);
  else if (x_dtype == 1 && ws != nullptr)
    err = wide ? bf16::run<2 * kT>(x, dt, A, B, C, y, state, ws, ws_floats,
                                   b, S, nh, hp, st, chunk, s)
               : bf16::run<kT>(x, dt, A, B, C, y, state, ws, ws_floats, b, S,
                               nh, hp, st, chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
