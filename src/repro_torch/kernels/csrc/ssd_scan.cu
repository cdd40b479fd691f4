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
// What bounds it.  At the prefill's shapes (Q = 256, hp = st = 64, nh =
// 112) a chunk costs a (Q, Q) score product over st, the masked (Q, Q) by
// (Q, hp) product, and two (Q, 64, 64) products for the offset and the
// state: about 170 float32 operations for each byte of x, B, C, dt read
// and y written, so the work is bound by operations, not bytes.  This
// first kernel runs in float32 on the CUDA cores, and recomputes C B^T for
// every head (B and C are shared by the heads).
//
// What the design does about it.  The TPU kernel carries h in VMEM scratch
// across a sequential chunk axis.  Here one block of 256 threads owns one
// (batch, head) and walks the chunks in order, so h (64 x 64 float32,
// 16 KB) stays in shared memory for the whole sequence: b * nh blocks, 896
// at b = 8.  The (Q, Q) decay matrix of a 256-step chunk (256 KB) does not
// fit a block's 227 KB, so the chunk's rows are tiled by 64: for each row
// tile i the block stages C_i, then for each column tile j <= i stages B_j
// and x_j (converted to float32), forms the masked 64 x 64 tile of
// (C B^T) * exp(cum_i - cum_j) * dt_j in shared memory, and adds its
// product with x_j to the row tile's y held in registers (a 4 x 4 tile a
// thread).  The state update then walks the column tiles once more.  One
// warp computes cum with a segmented shuffle scan.  Tiles are padded by one
// word a row so that the reads are free of bank conflicts.  91 KB of
// shared memory a block: two blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tile rows and columns
constexpr int kStride = kT + 1;
constexpr int kMaxChunk = 1024;
constexpr int kThreads = 256;   // 16 x 16
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kMaxChunk + 5 * kT * kStride);

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

// rows [r0, r0 + kT) of a (., width) float32 matrix with row stride `ld`,
// zero past `rows` and past `width`
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t ld, int r0, int rows,
                                          int width) {
  for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
    const int r = idx / kT, c = idx % kT;
    const int row = r0 + r;
    dst[r * kStride + c] =
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
// tiles: a 4 x 4 register tile a thread, 8 shared loads for 16 products
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
    for (int a = 0; a < 4; ++a) pv[a] = P[(ty + 16 * a) * kStride + s];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = R[(tx + 16 * c) * kStride + s];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[a][c] += pv[a] * rv[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state, int S, int nh, int hp, int st,
           int Q) {
  extern __shared__ float smem[];
  float* cum = smem;                    // [kMaxChunk]
  float* dts = cum + kMaxChunk;         // [kMaxChunk]: dt, then state weights
  float* Cs = dts + kMaxChunk;          // [kT][kStride]  C rows i
  float* Bs = Cs + kT * kStride;        // [kT][kStride]  B rows j
  float* Xs = Bs + kT * kStride;        // [kT][kStride]  x rows j
  float* Ms = Xs + kT * kStride;        // [kT][kStride]  masked decay tile
  float* Hs = Ms + kT * kStride;        // [kT][kStride]  h[p][s]

  const int bi = blockIdx.x / nh, hh = blockIdx.x % nh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a_h = A[hh];
  const size_t x_ld = static_cast<size_t>(nh) * hp;
  const T* xb = x + static_cast<size_t>(bi) * S * x_ld + hh * hp;
  T* yb = y + static_cast<size_t>(bi) * S * x_ld + hh * hp;
  const float* dtb = dt + static_cast<size_t>(bi) * S * nh + hh;
  const float* Bb = Bm + static_cast<size_t>(bi) * S * st;
  const float* Cb = Cm + static_cast<size_t>(bi) * S * st;

  for (int idx = tid; idx < kT * kStride; idx += kThreads) Hs[idx] = 0.f;

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
      stage_f32(Cs, Cc, st, i0, Q, st);
      __syncthreads();

      // offset from the carried state: exp(cum_i) * (C_i . h[p])
      float acc[4][4];
      tile_product(acc, Cs, Hs, st);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ig = i0 + ty + 16 * a;
        const float decay = ig < Q ? expf(cum[ig]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[a][cc] *= decay;
      }

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // Bs, Xs and Ms of the previous tile consumed
        stage_f32(Bs, Bc, st, j0, Q, st);
        stage_x(Xs, xc, x_ld, j0, Q, hp);
        __syncthreads();
        float sc[4][4];
        tile_product(sc, Cs, Bs, st);
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
    float hacc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        hacc[a][cc] = Hs[(ty + 16 * a) * kStride + tx + 16 * cc] * g;
    for (int j0 = 0; j0 < Q; j0 += kT) {
      __syncthreads();
      stage_f32(Bs, Bc, st, j0, Q, st);
      stage_x(Xs, xc, x_ld, j0, Q, hp);
      __syncthreads();
      const int nj = min(kT, Q - j0);
      for (int j = 0; j < nj; ++j) {
        const float w = dts[j0 + j];
        float bv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[j * kStride + tx + 16 * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float xw = Xs[j * kStride + ty + 16 * a] * w;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) hacc[a][cc] += xw * bv[cc];
        }
      }
    }
    __syncthreads();  // every read of the old h and of dts is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        Hs[(ty + 16 * a) * kStride + tx + 16 * cc] = hacc[a][cc];
    __syncthreads();
  }

  float* sb = state + static_cast<size_t>(blockIdx.x) * hp * st;
  for (int idx = tid; idx < hp * st; idx += kThreads) {
    const int p = idx / st, s = idx % st;
    sb[idx] = Hs[p * kStride + s];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state, int b,
                   int S, int nh, int hp, int st, int Q,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<b * nh, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<T*>(y),
      static_cast<float*>(state), S, nh, hp, st, Q);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int b, int S, int nh, int hp,
                               int st, int chunk, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || S <= 0 || nh <= 0 || hp <= 0 || hp > kT || st <= 0 ||
      st > kT || chunk <= 0 || chunk > kMaxChunk || S % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch<float>(x, dt, A, B, C, y, state, b, S, nh, hp, st, chunk, s);
  else if (x_dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, S, nh, hp, st,
                                chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
