// Flash attention on Hopper (sm_90a): causal or non-causal grouped-query
// attention with an online softmax, float32 throughout, output in q's type.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel).  Same function: q (B,S,H,hd), k and v
// (B,T,K,hd), query head h reads kv head h / (H/K); s = (q*scale) k^T in
// float32; masked where kpos >= T or, if causal, kpos > qpos (no offset);
// masked scores are -1e30 and their p is 0; m starts at -1e30, l at 0;
// out = acc / max(l, 1e-30).
//
// What bounds it.  At the prefill's shapes (S = T = 2048, hd = 112) the
// work is 2 * 2 * S * T / 2 * hd operations per (batch, head) against
// 4 * S * hd * 2 bytes in and out: about 500 operations a byte, above the
// card's ~295 a byte for bf16 tensor cores, so the function is bound by
// operations.  This first kernel computes in float32 on the CUDA cores
// (the TPU kernel's arithmetic, with no bf16 rounding of p), so its own
// ceiling is the float32 rate, and within that its shared-memory reads.
//
// What the design does about it.  The TPU kernel leans on a sequential
// grid axis to keep (m, l, acc) in VMEM across kv blocks.  Here one block
// of 256 threads owns one (batch*head, 64-query tile) and walks the kv
// tiles itself, so (m, l, acc) stay in registers: thread (ty, tx) holds
// rows ty + 16i (i < 4) and output columns tx + 16j (j < 8, < hd).  Each
// 32-key tile of K (transposed) and V is staged in shared memory in
// float32; the q tile is staged once, pre-scaled.  Scores are a 4 x 2
// register tile per thread; the row max and sum reduce across the 16
// threads of a row with xor shuffles.  p goes through shared memory for
// the p·V product.  Causal blocks skip every kv tile wholly above the
// diagonal, and the heaviest query tiles are launched first.  Strides
// padded by one word keep the transposed stores and the reads free of bank
// conflicts.  hd = 112 (not a power of two) and ragged S, T are masked.
// 75 KB of shared memory a block: three blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // queries a block
constexpr int kBKV = 32;       // keys a tile
constexpr int kHD = 128;       // largest head dim
constexpr int kThreads = 256;  // 16 x 16
constexpr int kQStride = kHD + 1;
constexpr int kKStride = kBKV + 1;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kQStride + kHD * kKStride + kBKV * kQStride +
                     kBQ * kKStride);

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

// Reduce over the 16 threads of one row group (lanes differing in bits 0-3).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int B, int S,
             int T_, int H, int K, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][kQStride]
  float* Kt = Qs + kBQ * kQStride;        // [kHD][kKStride]  (d-major)
  float* Vs = Kt + kHD * kKStride;        // [kBKV][kQStride]
  float* Ps = Vs + kBKV * kQStride;       // [kBQ][kKStride]

  const int n_q = (S + kBQ - 1) / kBQ;
  const int BH = B * H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const size_t q_row = static_cast<size_t>(H) * hd;   // stride between s
  const size_t k_row = static_cast<size_t>(K) * hd;   // stride between t
  const T* qb = q + (static_cast<size_t>(b) * S) * q_row + h * hd;
  const T* kb = k + (static_cast<size_t>(b) * T_) * k_row + kh * hd;
  const T* vb = v + (static_cast<size_t>(b) * T_) * k_row + kh * hd;
  T* ob = out + (static_cast<size_t>(b) * S) * q_row + h * hd;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    const int s = q0 + r;
    Qs[r * kQStride + d] = s < S ? to_f32(qb[s * q_row + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_end = causal ? min(T_, q_last + 1) : T_;
  for (int t0 = 0; t0 < t_end; t0 += kBKV) {
    __syncthreads();  // the previous tile's Kt, Vs and Ps are consumed
    for (int idx = tid; idx < kBKV * hd; idx += kThreads) {
      const int c = idx / hd, d = idx % hd;
      const int t = t0 + c;
      const bool in = t < T_;
      Kt[d * kKStride + c] = in ? to_f32(kb[t * k_row + d]) : 0.f;
      Vs[c * kQStride + d] = in ? to_f32(vb[t * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k0 = Kt[d * kKStride + tx];
      const float k1 = Kt[d * kKStride + tx + 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty + 16 * i) * kQStride + d];
        s[i][0] += qv * k0;
        s[i][1] += qv * k1;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + tx + 16 * j;
        valid[j] = kpos < T_ && (!causal || kpos <= qpos);
        if (!valid[j]) s[i][j] = kNegInf;
      }
      const float m_new = fmaxf(m[i], row_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kKStride + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int n_kv = min(kBKV, T_ - t0);
    for (int c = 0; c < n_kv; ++c) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < hd ? Vs[c * kQStride + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kKStride + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[s * q_row + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_, int H, int K, int hd, int causal,
                   float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((S + kBQ - 1) / kBQ) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_kernel<T><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, S, T_, H, K, hd,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int K, int hd, int dtype,
                                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0 || H % K || hd <= 0 || hd > kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, out, B, S, T, H, K, hd, causal, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, hd, causal,
                                scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
