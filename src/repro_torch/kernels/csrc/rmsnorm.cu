// RMSNorm on Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w over the
// last axis, in float32, written back in x's dtype.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rmsnorm.py (rmsnorm,
// _rmsnorm_kernel), which normalises a (256, D) VMEM tile per grid step.
//
// What bounds it.  Each row is read once and written once, with 3 float32
// operations an element: at bf16 that is 1.5 operations a byte, far below
// the card's ~295 operations a byte, so the kernel is bound by bytes.
//
// What the design does about it.  One block of 256 threads owns one row:
// the threads stride over the row with coalesced loads (neighbouring
// threads on neighbouring elements), sum x^2 in float32 registers, reduce
// across the warp with shuffles and across the block's 8 warps through
// shared memory, then stream the row again (from L1/L2: a row of D = 7168
// bf16 is 14 KB) to scale and store it.  D need not be a power of two or a
// multiple of the block: the strided loop masks the tail.  rsqrt is
// 1 / sqrtf, both correctly rounded, so the kernel rounds as the plain
// version does up to the order of the sum.
//
// The backward (rmsnorm_bwd_launch) is the gradient of the same function,
// which the reference trains through as XLA's autodiff of its twin
// src/repro/models/layers.py:20 (rms_norm): with r = rsqrt(mean(x^2) + eps)
// and g = dy * w, dx = r * g - x * r^3 * mean(g * x) and dw = sum over rows
// of dy * x * r, in float32; dx is written in x's dtype and dw, summed in
// float32, in w's.  It is bound by bytes too (x and dy read, dx written:
// about 2 operations a byte).  One block owns a strided set of rows: for
// each, one pass sums x^2 and g*x (block reductions in a fixed order), a
// second writes dx and adds dy * x * r into the block's float32 partial
// sums of dw, one column a thread, in shared memory.  No float atomics: a
// second kernel sums the blocks' partials column by column, in block
// order, and casts, so a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = out + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(partial[0] / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < D; i += kThreads)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int D,
                   float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kMaxBwdD = 227 * 1024 / 4 - 64;  // D floats of shared memory

// the sums of a and b over the block, the same on every thread
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kThreads / 32]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    a += red[0][i];
    b += red[1][i];
  }
  __syncthreads();  // red is free for the next row
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_part, int rows, int D, float eps) {
  extern __shared__ float acc[];  // [D]: this block's partial sums of dw
  __shared__ float red[2][kThreads / 32];
  for (int i = threadIdx.x; i < D; i += kThreads) acc[i] = 0.f;
  const float inv_d = 1.0f / static_cast<float>(D);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    T* dxr = dx + static_cast<size_t>(row) * D;
    float ss = 0.f, gx = 0.f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xv = to_f32(xr[i]);
      ss += xv * xv;
      gx += to_f32(gr[i]) * to_f32(w[i]) * xv;
    }
    block_sum2(ss, gx, red);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float c = gx * inv_d * r * r * r;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xv = to_f32(xr[i]), gv = to_f32(gr[i]);
      dxr[i] = from_f32<T>(gv * to_f32(w[i]) * r - xv * c);
      acc[i] += gv * (xv * r);
    }
  }
  // each thread reads back only the columns it wrote
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) part[i] = acc[i];
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, W* __restrict__ dw,
                  int parts, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p)
    s += dw_part[static_cast<size_t>(p) * D + i];
  dw[i] = from_f32<W>(s);
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       void* dw, void* ws, int rows, int D, int parts,
                       float eps, cudaStream_t stream) {
  const int smem = D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_kernel<T, W><<<parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(ws), rows, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<W><<<(D + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(ws),
                                   static_cast<W*>(dw), parts, D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int D, int x_dtype, int w_dtype,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch<float, float>(x, w, out, rows, D, eps, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps, s);
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
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_bwd<float, float>(x, w, dy, dx, dw, ws, rows, D, parts,
                                   eps, s);
  else if (x_dtype == 0 && w_dtype == 1)
    err = launch_bwd<float, __nv_bfloat16>(x, w, dy, dx, dw, ws, rows, D,
                                           parts, eps, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, dw, ws, rows, D,
                                           parts, eps, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, dy, dx, dw, ws,
                                                   rows, D, parts, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
