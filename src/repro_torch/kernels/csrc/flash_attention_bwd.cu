// Flash attention backward on Hopper (sm_90a): dq, dk and dv of causal or
// non-causal grouped-query attention, for q (B,S,H,hd), k and v (B,T,K,hd),
// hd <= 128, in float32 or bfloat16.
//
// What it differentiates.  The forward is the kernel of flash_attention.cu
// (the Pallas TPU kernel of src/repro/kernels/flash_attention.py); the
// reference has no backward kernel and trains through XLA's autodiff of
// the kernel's twin src/repro/models/layers.py:91 (full_attention).  So
// this is the gradient of that function: with s = (q k^T) * scale masked
// (kpos >= T, or kpos > qpos if causal), p = exp(s - lse) the softmax,
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - delta),  delta = rowsum(dO*o),
//   dq = ds k * scale,  dk = ds^T q * scale,
// all in float32, written in q's dtype.  Query head h reads kv head
// h / (H/K), so dk and dv of a kv head sum over the H/K query heads of its
// group.
//
// What bounds it.  At the training shapes (S = T = 2048, hd = 128, causal)
// the gradient is 5 products of S * T / 2 * hd multiply-adds a (batch,
// head), against 8 tensors of S * hd read or written: about 960 operations
// a byte, above the card's ~295 a byte for bf16 tensor cores, so it is
// bound by operations.  This first design runs them on the CUDA cores in
// float32 (a simple kernel that is right first; the tensor-core redesign
// is later work), so it stays far from that bound.
//
// Design.  The forward does not keep the row log-sum-exp, so the backward
// recomputes p.  Two kernels, no float atomics (a rerun gives the same
// bits):
// * flash_bwd_dq_kernel: one block per (batch, head, 64 queries).  It sums
//   delta = rowsum(dO * o) for its rows, walks the kv tiles once for the
//   row log-sum-exp (an online max and sum, as the forward), then again for
//   p, dp and ds, and dq += ds k; it writes lse and delta to a workspace.
// * flash_bwd_dkdv_kernel: one block per (batch, kv head, 64 keys).  It
//   walks the H/K query heads of its group and, for each, the 32-query
//   tiles that can see its keys, recomputing p from lse and ds from delta,
//   and sums dv += p^T dO and dk += ds^T q in registers.
// Tiles are staged in shared memory in q's dtype (float32, or bfloat16 at
// half the bytes) and read as float32; each product is a register tile of
// 4 x 4 (or 4 x 8, 4 x 2) outputs a thread over a k loop that reads
// 16-byte rows of both operands, so operands are stored k-major: q, dO, k
// and v both as (row, d) and transposed (d, row).  p and ds go through
// shared memory in float32.  Causal blocks skip the tiles wholly above the
// diagonal, and the heaviest blocks launch first.  The head dim is padded
// with zeros to 64 or 128; rows past S or T are zero and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr int kBQ = 64;        // dq kernel: queries a block
constexpr int kBKV = 64;       // keys a tile (dq) / a block (dk, dv)
constexpr int kBQ2 = 32;       // dk, dv kernel: queries a tile
constexpr int kHD = 128;       // largest head dim

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

// Row padding (elements) that keeps every row 16-byte aligned.
template <typename T>
constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T, int COLS>
constexpr int ld() { return COLS + pad<T>(); }

// N consecutive elements from shared memory (N = 2 or 4; aligned) as floats
__device__ __forceinline__ void ldn(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldn(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void ldn(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ldn(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = a.x; v[1] = a.y;
}

// c[i][j] += sum_k a[k][m0 + i] * b[k][n0 + j]: both operands k-major
template <int MI, int NJ, typename TA, typename TB>
__device__ __forceinline__ void mm(float (&c)[MI][NJ], const TA* a, int lda,
                                   int m0, const TB* b, int ldb, int n0,
                                   int kdim) {
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    float av[MI], bv[NJ];
    ldn(a + k * lda + m0, av);
    ldn(b + k * ldb + n0, bv);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// c[i][g*4 + j] += sum_k a[k][m0 + i] * b[k][g*64 + n0 + j]: the output
// columns of a thread are 4 in each 64-column group of the head dim
template <int MI, int NG, typename TA, typename TB>
__device__ __forceinline__ void mm_hd(float (&c)[MI][NG * 4], const TA* a,
                                      int lda, int m0, const TB* b, int ldb,
                                      int n0, int kdim) {
#pragma unroll 4
  for (int k = 0; k < kdim; ++k) {
    float av[MI];
    ldn(a + k * lda + m0, av);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float bv[4];
      ldn(b + k * ldb + g * 64 + n0, bv);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[i][g * 4 + j] = fmaf(av[i], bv[j], c[i][g * 4 + j]);
    }
  }
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

// Stage rows [0, ROWS) x cols [0, HD) of a (rows, ld_g) global tensor
// (rows past `len` and columns past `hd` zero) into shared memory as
// (row, d) with row stride `lrow` and/or transposed (d, row) with stride
// `lt`; either destination may be null.
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void stage(T* rowm, int lrow, T* trans, int lt,
                                      const T* src, size_t ld_g, int len,
                                      int hd) {
  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const T val = r < len && d < hd ? src[static_cast<size_t>(r) * ld_g + d]
                                    : zero;
    if (rowm) rowm[r * lrow + d] = val;
    if (trans) trans[d * lt + r] = val;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, H, S)
  float* delta;  // (B, H, S)
  int B, S, T, H, K, hd, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// dq (and the row statistics lse, delta)
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct DqSmem {
  static constexpr int kLq = ld<T, kBQ>();      // (d, query) tiles
  static constexpr int kLk = ld<T, kBKV>();     // (d, key) tiles
  static constexpr int kLkr = ld<T, HD>();      // (key, d) tile
  static constexpr int kLs = kBKV + 4;          // (key, query) float
  static constexpr size_t kBytes =
      sizeof(T) * (2 * HD * kLq + 2 * HD * kLk + kBKV * kLkr) +
      sizeof(float) * (kBKV * (kBQ + 4) + 2 * kBQ);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  using L = DqSmem<T, HD>;
  constexpr int NG = HD / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qt = reinterpret_cast<T*>(smem_raw);  // [HD][kLq]
  T* dOt = Qt + HD * L::kLq;               // [HD][kLq]
  T* Kt = dOt + HD * L::kLq;               // [HD][kLk]
  T* Vt = Kt + HD * L::kLk;                // [HD][kLk]
  T* Ks = Vt + HD * L::kLk;                // [kBKV][kLkr]
  float* dSt = reinterpret_cast<float*>(Ks + kBKV * L::kLkr);  // [kBKV][kLs]
  float* lse_s = dSt + kBKV * L::kLs;
  float* delta_s = lse_s + kBQ;

  const int n_q = (a.S + kBQ - 1) / kBQ;
  const int BH = a.B * a.H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / BH);  // heavy first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_ld = static_cast<size_t>(a.H) * a.hd;
  const size_t k_ld = static_cast<size_t>(a.K) * a.hd;
  const size_t q_off = (static_cast<size_t>(b) * a.S + q0) * q_ld +
                       static_cast<size_t>(h) * a.hd;
  const T* qb = static_cast<const T*>(a.q) + q_off;
  const T* ob = static_cast<const T*>(a.o) + q_off;
  const T* dob = static_cast<const T*>(a.dout) + q_off;
  T* dqb = static_cast<T*>(a.dq) + q_off;
  const size_t k_off = static_cast<size_t>(b) * a.T * k_ld +
                       static_cast<size_t>(kh) * a.hd;
  const T* kb = static_cast<const T*>(a.k) + k_off;
  const T* vb = static_cast<const T*>(a.v) + k_off;
  const size_t stat = static_cast<size_t>(bh) * a.S + q0;
  const int q_len = a.S - q0;

  stage<T, kBQ, HD>(nullptr, 0, Qt, L::kLq, qb, q_ld, q_len, a.hd);
  stage<T, kBQ, HD>(nullptr, 0, dOt, L::kLq, dob, q_ld, q_len, a.hd);
  // delta = rowsum(dO * o): a warp a row, 8 rows a warp
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float acc = 0.f;
      if (r < q_len)
        for (int d = lane; d < a.hd; d += 32)
          acc += to_f32(dob[r * q_ld + d]) * to_f32(ob[r * q_ld + d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        delta_s[r] = acc;
        if (r < q_len) a.delta[stat + r] = acc;
      }
    }
  }

  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int t_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int n_kv = (t_end + kBKV - 1) / kBKV;

  // s[i][j] for rows ty*4 + i, keys tx*4 + j of the tile at t0, scaled and
  // masked (-inf)
  auto scores = [&](float (&s)[4][4], int t0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm<4, 4>(s, Qt, L::kLq, ty * 4, Kt, L::kLk, tx * 4, HD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = t0 + tx * 4 + j;
        const bool valid = kpos < a.T && (!a.causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * a.scale : -INFINITY;
      }
    }
  };

  // pass 1: the row log-sum-exp
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int it = 0; it < n_kv; ++it) {
    const int t0 = it * kBKV;
    __syncthreads();  // the previous tile is consumed
    stage<T, kBKV, HD>(nullptr, 0, Kt, L::kLk, kb + t0 * k_ld, k_ld,
                       a.T - t0, a.hd);
    __syncthreads();
    float s[4][4];
    scores(s, t0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                     fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - base);
      l[i] = l[i] * expf(m[i] - base) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const int r = ty * 4 + i;
    if (tx == 0) {
      lse_s[r] = lse[i];
      if (r < q_len) a.lse[stat + r] = lse[i];
    }
  }
  __syncthreads();  // delta_s is written
#pragma unroll
  for (int i = 0; i < 4; ++i) dlt[i] = delta_s[ty * 4 + i];

  // pass 2: dq += ds k
  float dq[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) dq[i][j] = 0.f;
  for (int it = 0; it < n_kv; ++it) {
    const int t0 = it * kBKV;
    __syncthreads();  // the previous tile and dSt are consumed
    stage<T, kBKV, HD>(Ks, L::kLkr, Kt, L::kLk, kb + t0 * k_ld, k_ld,
                       a.T - t0, a.hd);
    stage<T, kBKV, HD>(nullptr, 0, Vt, L::kLk, vb + t0 * k_ld, k_ld,
                       a.T - t0, a.hd);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(s, t0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
    mm<4, 4>(dp, dOt, L::kLq, ty * 4, Vt, L::kLk, tx * 4, HD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[i][j] - lse[i]);  // 0 where masked
        ds[i] = p * (dp[i][j] - dlt[i]);
      }
      *reinterpret_cast<float4*>(dSt + (tx * 4 + j) * L::kLs + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mm_hd<4, NG>(dq, dSt, L::kLs, ty * 4, Ks, L::kLkr, tx * 4, kBKV);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_len) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = g * 64 + tx * 4 + j;
        if (d < a.hd)
          dqb[r * q_ld + d] = from_f32<T>(dq[i][g * 4 + j] * a.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct DkvSmem {
  static constexpr int kLk = ld<T, kBKV>();    // (d, key) tiles
  static constexpr int kLq = ld<T, kBQ2>();    // (d, query) tiles
  static constexpr int kLqr = ld<T, HD>();     // (query, d) tiles
  static constexpr int kLp = kBKV + 4;         // (query, key) float
  static constexpr size_t kBytes =
      sizeof(T) * (2 * HD * kLk + 2 * HD * kLq + 2 * kBQ2 * kLqr) +
      sizeof(float) * (2 * kBQ2 * kLp + 2 * kBQ2);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(Args a) {
  using L = DkvSmem<T, HD>;
  constexpr int NG = HD / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Kt = reinterpret_cast<T*>(smem_raw);  // [HD][kLk]
  T* Vt = Kt + HD * L::kLk;                // [HD][kLk]
  T* Qt = Vt + HD * L::kLk;                // [HD][kLq]
  T* dOt = Qt + HD * L::kLq;               // [HD][kLq]
  T* Qs = dOt + HD * L::kLq;               // [kBQ2][kLqr]
  T* dOs = Qs + kBQ2 * L::kLqr;            // [kBQ2][kLqr]
  float* Ps = reinterpret_cast<float*>(dOs + kBQ2 * L::kLqr);  // [kBQ2][kLp]
  float* dSs = Ps + kBQ2 * L::kLp;
  float* lse_s = dSs + kBQ2 * L::kLp;
  float* delta_s = lse_s + kBQ2;

  const int BK = a.B * a.K;
  const int kt = static_cast<int>(blockIdx.x / BK);  // heavy (early) first
  const int bk = static_cast<int>(blockIdx.x % BK);
  const int b = bk / a.K, kh = bk % a.K;
  const int G = a.H / a.K;
  const int t0 = kt * kBKV;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_ld = static_cast<size_t>(a.H) * a.hd;
  const size_t k_ld = static_cast<size_t>(a.K) * a.hd;
  const size_t k_off = (static_cast<size_t>(b) * a.T + t0) * k_ld +
                       static_cast<size_t>(kh) * a.hd;
  const int k_len = a.T - t0;

  stage<T, kBKV, HD>(nullptr, 0, Kt, L::kLk,
                     static_cast<const T*>(a.k) + k_off, k_ld, k_len, a.hd);
  stage<T, kBKV, HD>(nullptr, 0, Vt, L::kLk,
                     static_cast<const T*>(a.v) + k_off, k_ld, k_len, a.hd);

  float dk[4][NG * 4], dv[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_q = (a.S + kBQ2 - 1) / kBQ2;
  const int q_first = a.causal ? t0 / kBQ2 : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t stat = (static_cast<size_t>(b) * a.H + h) * a.S;
    for (int qi = q_first; qi < n_q; ++qi) {
      const int q0 = qi * kBQ2;
      const size_t q_off = (static_cast<size_t>(b) * a.S + q0) * q_ld +
                           static_cast<size_t>(h) * a.hd;
      const int q_len = a.S - q0;
      __syncthreads();  // the previous tile, Ps and dSs are consumed
      stage<T, kBQ2, HD>(Qs, L::kLqr, Qt, L::kLq,
                         static_cast<const T*>(a.q) + q_off, q_ld, q_len,
                         a.hd);
      stage<T, kBQ2, HD>(dOs, L::kLqr, dOt, L::kLq,
                         static_cast<const T*>(a.dout) + q_off, q_ld, q_len,
                         a.hd);
      if (tid < kBQ2) {
        const bool in = tid < q_len;
        lse_s[tid] = in ? a.lse[stat + q0 + tid] : INFINITY;
        delta_s[tid] = in ? a.delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed scores: keys ty*4 + i, queries tx*2 + j
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      mm<4, 2>(s, Kt, L::kLk, ty * 4, Qt, L::kLq, tx * 2, HD);
      mm<4, 2>(dp, Vt, L::kLk, ty * 4, dOt, L::kLq, tx * 2, HD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tx * 2 + j, qpos = q0 + r;
        const float lse = lse_s[r], dlt = delta_s[r];
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = t0 + ty * 4 + i;
          const bool valid = qpos < a.S && kpos < a.T &&
                             (!a.causal || kpos <= qpos);
          p[i] = valid ? expf(s[i][j] * a.scale - lse) : 0.f;
          ds[i] = p[i] * (dp[i][j] - dlt);
        }
        *reinterpret_cast<float4*>(Ps + r * L::kLp + ty * 4) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(dSs + r * L::kLp + ty * 4) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      mm_hd<4, NG>(dv, Ps, L::kLp, ty * 4, dOs, L::kLqr, tx * 4, kBQ2);
      mm_hd<4, NG>(dk, dSs, L::kLp, ty * 4, Qs, L::kLqr, tx * 4, kBQ2);
    }
  }

  T* dkb = static_cast<T*>(a.dk) + k_off;
  T* dvb = static_cast<T*>(a.dv) + k_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty * 4 + i;
    if (c >= k_len) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = g * 64 + tx * 4 + j;
        if (d < a.hd) {
          dkb[c * k_ld + d] = from_f32<T>(dk[i][g * 4 + j] * a.scale);
          dvb[c * k_ld + d] = from_f32<T>(dv[i][g * 4 + j]);
        }
      }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Lq = DqSmem<T, HD>;
  using Lk = DkvSmem<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Lq::kBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Lk::kBytes));
  if (err != cudaSuccess) return err;
  const long long dq_blocks =
      static_cast<long long>((a.S + kBQ - 1) / kBQ) * a.B * a.H;
  const long long kv_blocks =
      static_cast<long long>((a.T + kBKV - 1) / kBKV) * a.B * a.K;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_dq_kernel<T, HD><<<static_cast<unsigned>(dq_blocks), kThreads,
                               Lq::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<static_cast<unsigned>(kv_blocks), kThreads,
                                 Lk::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  return a.hd <= 64 ? launch<T, 64>(a, stream) : launch<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse and delta are float32 workspaces
// of B * H * S each.  S, T > 0.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int T, int H, int K, int hd, int dtype, int causal,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K || hd <= 0 ||
      hd > kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv,
               static_cast<float*>(lse), static_cast<float*>(delta),
               B, S, T, H, K, hd, causal, scale};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
