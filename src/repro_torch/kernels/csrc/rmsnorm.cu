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
