// Flash attention on Hopper (sm_90a): causal or non-causal grouped-query
// attention with an online softmax, output in q's type.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel).  Same function: q (B,S,H,hd), k and v
// (B,T,K,hd), query head h reads kv head h / (H/K); s = (q*scale) k^T in
// float32; masked where kpos >= T or, if causal, kpos > qpos (no offset);
// masked scores give p = 0; out = acc / max(l, 1e-30).
//
// What bounds it.  At the prefill's shapes (S = T = 2048, hd = 112) the
// work is 2 * 2 * S * T / 2 * hd operations per (batch, head) against
// 4 * S * hd * 2 bytes in and out: about 500 operations a byte, above the
// card's ~295 a byte for bf16 tensor cores, so the function is bound by
// operations, and only the tensor cores come near that bound.
//
// For training (flash_attention_bwd.cu) the caller may pass a float32
// (B, H, S) buffer: both kernels then also store each row's natural-log
// log-sum-exp of its masked, scaled scores (+inf for a row with no key),
// once a row, from the online softmax's (m, l); the output's arithmetic is
// the same with or without it.  Serving passes none.
//
// Two kernels, by dtype.
//
// bfloat16 (flash_wgmma_kernel, the serving path): Hopper's warpgroup
// tensor-core products (wgmma, wgmma.cuh), no added rounding.  q·k^T is a
// bf16 x bf16 product, exact in float32, so it runs as wgmma m64n64k16
// with q and k read from shared memory and float32 accumulators; the scale
// (times log2 e, for exp2) is applied to s afterwards, which differs from
// the TPU kernel's q*scale by about one float32 ulp of s.  p stays float32
// for the softmax and the row sums; for p·V it is split into bf16 hi and lo
// parts (tensor_core.cuh), and both parts go to wgmma m64nHDk16 from
// registers against the same V tile in shared memory, so p loses about
// 2^-17 of itself where plain bf16 p would lose 2^-9 and miss the 1e-5
// tolerance.  A block of two warpgroups owns 128 queries of one
// (batch*head), 64 a warpgroup, with (m, l, acc) in registers in the
// accumulators' layout; 64-key tiles of K and V stream through a 2-stage
// cp.async ring in shared memory, stored as 64-column blocks with the
// 128-byte swizzle that wgmma's descriptors read (K-major for q and k,
// MN-major for V); the q tile is staged once.  The head dim is padded to
// 64, 112 or 128 (zeros, which add nothing); rows past S or T are
// zero-filled, and the mask is applied only on edge tiles.  Causal blocks
// skip every kv tile wholly above the diagonal (a warpgroup skips those
// above its own 64 rows), and the heaviest query tiles launch first.  Rows
// whose 16-byte chunks are not aligned (hd % 8, or a pointer) are staged
// by plain loads into the same layout.  cp.async rather than TMA: one
// loader zero-fills the padded head dim and the ragged rows for every hd
// the wrapper takes, with no tensor map to encode on the host for each
// call, and the warpgroups' products, not the loads, hold the kernel.
// 97 KB of shared memory a block: two blocks an SM.

// float32 (flash_kernel, as first written): the TPU kernel's arithmetic on
// the CUDA cores.  One block of 256 threads owns
// one (batch*head, 64-query tile) and walks 32-key tiles, (m, l, acc) in
// registers (thread (ty, tx) holds rows ty + 16i, i < 4, and columns
// tx + 16j, j < 8), K transposed and V staged in float32 shared memory,
// the q tile pre-scaled; 75 KB of shared memory a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "tensor_core.cuh"
#include "wgmma.cuh"

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
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int B, int S, int T_, int H, int K,
             int hd, int causal, float scale) {
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
    if (lse && tx == 0)  // +inf for a row with no key
      lse[static_cast<size_t>(bh) * S + s] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
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
                   float* lse, int B, int S, int T_, int H, int K, int hd,
                   int causal, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, B, S, T_, H, K,
      hd, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int kWGs = 2;             // warpgroups of 64 queries
constexpr int kThreads = kWGs * 128;
constexpr int kBQ = kWGs * 64;      // queries a block
constexpr int kBKV = 64;            // keys a tile
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* lse;  // (B, H, S) or null
  int B, S, T, H, K, hd, causal, vec;
  float scale_log2;  // scale * log2(e)
};


// HD: the head dim padded to 64, 112 or 128
template <int HD>
struct Tile {
  static constexpr int kBlocks = HD > 64 ? 2 : 1;  // 64-column blocks
  static constexpr int kQBytes = kBlocks * kBQ * 128;
  static constexpr int kKVBytes = kBlocks * kBKV * 128;
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;  // + alignment
};

template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                   const uint32_t (&p)[4], uint64_t dv) {
  if constexpr (HD == 64) wg::mma_rs_n64(o, p, dv);
  else if constexpr (HD == 112) wg::mma_rs_n112(o, p, dv);
  else wg::mma_rs_n128(o, p, dv);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_wgmma_kernel(Args a) {
  using Tl = Tile<HD>;
  constexpr int kKSteps = HD / 16;  // k-steps of q·k^T
  constexpr int kNT = HD / 8;       // n-tiles of the output
  extern __shared__ unsigned char smem_w[];
  const uint32_t sQ = (tc::smem_addr(smem_w) + 1023) & ~1023u;
  const uint32_t sKV = sQ + Tl::kQBytes;  // stage i: K, then V

  const int n_q = (a.S + kBQ - 1) / kBQ;
  const int BH = a.B * a.H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * kBQ;
  const int wgi = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  const size_t q_ld = static_cast<size_t>(a.H) * a.hd;
  const size_t k_ld = static_cast<size_t>(a.K) * a.hd;
  const __nv_bfloat16* qb =
      a.q + (static_cast<size_t>(b) * a.S + q0) * q_ld + h * a.hd;
  const __nv_bfloat16* kb =
      a.k + static_cast<size_t>(b) * a.T * k_ld + kh * a.hd;
  const __nv_bfloat16* vb =
      a.v + static_cast<size_t>(b) * a.T * k_ld + kh * a.hd;
  __nv_bfloat16* ob = a.out + static_cast<size_t>(b) * a.S * q_ld + h * a.hd;

  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int t_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int n_kv = (t_end + kBKV - 1) / kBKV;

  auto load_kv = [&](int it) {
    const int t0 = it * kBKV;
    const uint32_t sK = sKV + (it & 1) * 2 * Tl::kKVBytes;
    tc::load_tile<HD, kBKV, kThreads>(sK, kb + t0 * k_ld, k_ld, a.T - t0,
                                      a.hd, a.vec);
    tc::load_tile<HD, kBKV, kThreads>(sK + Tl::kKVBytes, vb + t0 * k_ld,
                                      k_ld, a.T - t0, a.hd, a.vec);
  };
  tc::load_tile<HD, kBQ, kThreads>(sQ, qb, q_ld, a.S - q0, a.hd, a.vec);
  tc::cp_async_commit();
  if (n_kv > 0) load_kv(0);
  tc::cp_async_commit();

  const int wq0 = q0 + wgi * 64;  // the warpgroup's first query
  const int w0 = q0 + warp * 16;  // the warp's first query
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) load_kv(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // q and tile `it` have landed
    wg::fence_proxy();
    __syncthreads();
    const int t0 = it * kBKV;
    const uint32_t sK = sKV + (it & 1) * 2 * Tl::kKVBytes;
    const uint32_t sV = sK + Tl::kKVBytes;
    if (wq0 < a.S && !(a.causal && t0 > wq0 + 63)) {  // warpgroup-uniform
      // s = q k^T: 64 x 64 a warpgroup, q and k from shared memory
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      wg::touch(s);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t kq = (ks >> 2) * kBQ * 128 + (ks & 3) * 32;
        const uint32_t kk = (ks >> 2) * kBKV * 128 + (ks & 3) * 32;
        wg::mma_ss_n64(s, wg::desc(sQ + wgi * 64 * 128 + kq, 16, 1024),
                       wg::desc(sK + kk, 16, 1024), ks > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(s);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= a.scale_log2;
      if (t0 + kBKV > a.T || (a.causal && t0 + kBKV - 1 > w0)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = t0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = w0 + g + (e >> 1) * 8;
            if (kpos >= a.T || (a.causal && kpos > qpos)) s[n][e] = -INFINITY;
          }
      }

      // online softmax: rows g (r = 0) and g + 8 (r = 1), over the quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - base);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * r] = exp2f(s[n][2 * r] - base);
          s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - base);
          sum += s[n][2 * r] + s[n][2 * r + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }

      // o += p V, p as bf16 hi + lo from registers, V from shared memory.
      // Every p fragment has registers of its own until the products have
      // completed: wgmma reads them asynchronously.
      uint32_t pp[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        tc::split(s[2 * kk][0], s[2 * kk][1], pp[kk][0][0], pp[kk][1][0]);
        tc::split(s[2 * kk][2], s[2 * kk][3], pp[kk][0][1], pp[kk][1][1]);
        tc::split(s[2 * kk + 1][0], s[2 * kk + 1][1], pp[kk][0][2],
                  pp[kk][1][2]);
        tc::split(s[2 * kk + 1][2], s[2 * kk + 1][3], pp[kk][0][3],
                  pp[kk][1][3]);
      }
      wg::touch(o);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = wg::desc(sV + kk * 16 * 128, kBKV * 128, 1024);
        pv<HD>(o, pp[kk][0], dv);
        pv<HD>(o, pp[kk][1], dv);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::touch_a(pp[kk]);
    }
    __syncthreads();  // tile `it` consumed before its stage is reloaded
  }

  if (w0 >= a.S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= a.S) continue;
    // the row's natural-log lse from the log2-unit state; +inf with no key
    if (a.lse && t4 == 0)
      a.lse[static_cast<size_t>(bh) * a.S + row] =
          l[r] > 0.f ? kLn2 * (m[r] + log2f(l[r])) : INFINITY;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<size_t>(row) * q_ld;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t4;
      const float v0 = o[n][2 * r] * inv, v1 = o[n][2 * r + 1] * inv;
      if (a.hd % 2 == 0) {
        if (col < a.hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < a.hd) orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < a.hd) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.S + kBQ - 1) / kBQ) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kThreads,
                           Tile<HD>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int T, int H, int K, int hd,
                     int causal, float scale, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v),
         static_cast<__nv_bfloat16*>(out), lse,
         B, S, T, H, K, hd, causal,
         hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v),
         scale * 1.4426950408889634f};
  if (hd <= 64) return launch<64>(a, stream);
  if (hd <= 112) return launch<112>(a, stream);
  return launch<128>(a, stream);
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse, if
// not null, receives the float32 (B, H, S) natural-log log-sum-exp of each
// row's masked, scaled scores (+inf for a row with no key), which the
// backward reads.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int T, int H, int K,
                                      int hd, int dtype, int causal,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T < 0 || H <= 0 || K <= 0 || H % K || hd <= 0 ||
      hd > kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, out, static_cast<float*>(lse), B, S, T, H,
                        K, hd, causal, scale, s);
  else if (dtype == 1)
    err = bf16::dispatch(q, k, v, out, static_cast<float*>(lse), B, S, T, H,
                         K, hd, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
