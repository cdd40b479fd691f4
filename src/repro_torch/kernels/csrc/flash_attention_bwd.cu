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
// all in float32, written in q's dtype.  lse is the row log-sum-exp that
// the forward kernel stores when asked (the training path asks), so p
// costs one exp a score and no pass of its own.  Query head h reads kv
// head h / (H/K), so dk and dv of a kv head sum over the H/K query heads of
// its group.
//
// What bounds it.  At the training shapes (S = T = 2048, hd = 128, causal)
// the gradient is 5 products of S * T / 2 * hd multiply-adds a (batch,
// head), against 8 tensors of S * hd read or written: about 960 operations
// a byte, above the card's ~295 a byte for bf16 tensor cores, so it is
// bound by operations, and only the tensor cores come near that bound:
// 0.26 ms for the bf16 call at 4 x 2048, 24 / 8 heads of 128, causal, on
// an H100 SXM (989 TFLOP/s), where this design takes 1.4 to 1.6 ms
// (H100 80GB HBM3 at 700 W; chip_smoke.py [17a]).
//
// Two kernels, no float atomics (a rerun gives the same bits), launched in
// this order on one stream: the dq kernel writes delta, which the dk/dv
// kernel reads.
//
// bfloat16 (the training path): Hopper's warpgroup products (wgmma,
// wgmma.cuh), the tiles staged by cp.async in the forward's layout
// (64-column blocks with the 128-byte swizzle, tensor_core.cuh), so one
// copy of each tile serves both as a K-major operand and, read MN-major,
// as the right operand of the next product: no transposed copy is staged.
// * flash_bwd_dq_wgmma_kernel: a block of two warpgroups owns 128 queries
//   of one (batch, head), 64 a warpgroup; Q and dO are staged once and
//   delta summed from dO and o; 64-key tiles of K and V stream through a
//   2-stage ring.  A tile: s = q k^T and dp = dO v^T (m64n64k16, both
//   operands from shared memory), p = exp2(s scale log2e - lse log2e) and
//   ds = p (dp - delta) in the accumulators, then dq += ds k with ds from
//   registers against the same K tile read MN-major.
// * flash_bwd_dkdv_wgmma_kernel: a block of two warpgroups owns 128 keys
//   of one (batch, kv head), 64 a warpgroup; K and V are staged once, and
//   the 64-query tiles of the group's heads that can see the keys (Q, dO,
//   lse, delta) stream through a 2-stage ring, each taken as two halves of
//   32 queries so that s^T and dp^T (m64n32k16) fit beside the dk and dv
//   accumulators (128 floats a thread at hd 128).  A half: s^T = k q^T and
//   dp^T = v dO^T, p^T and ds^T, then dv += p^T dO and dk += ds^T q, the
//   accumulators as the A operand from registers, dO and Q read MN-major.
// p and ds are float32; each product that takes them takes them as bf16
// hi and lo parts (tc::split), as the forward takes p, so they lose about
// 2^-17 of themselves: 7 products of the gradient become 10 on the tensor
// cores (s, dp; dq x 2; s^T, dp^T; dv x 2, dk x 2), and what error is left
// is delta's, taken from the bf16 output.  The head dim is padded with
// zeros to 64, 112 or 128; rows past S or T are zero-filled, and the mask
// is applied only on tiles that cross it.  Causal blocks skip the tiles
// wholly above the diagonal, and the heaviest blocks launch first.  Rows
// whose 16-byte chunks are not aligned are staged by plain loads.  About
// 130 KB of shared memory and up to ~200 registers a thread: one block an
// SM.
//
// float32 (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel): the same two
// kernels on the CUDA cores, to hold the float32 tolerance (1e-5).  Tiles
// are staged in float32 shared memory, both as (row, d) and transposed;
// each product is a register tile of 4 x 4 (or 4 x 2, 4 x 8) outputs a
// thread over a k loop; p and ds go through shared memory.  The dq kernel
// takes 64 queries and 64-key tiles, the dk/dv kernel 64 keys and 32-query
// tiles; the head dim is padded to 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr int kBQ = 64;        // dq kernel: queries a block
constexpr int kBKV = 64;       // keys a tile (dq) / a block (dk, dv)
constexpr int kBQ2 = 32;       // dk, dv kernel: queries a tile
constexpr int kHD = 128;       // largest head dim

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Row padding (elements) that keeps every row 16-byte aligned.
template <typename T>
constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T, int COLS>
constexpr int ld() { return COLS + pad<T>(); }

// N consecutive floats from shared memory (N = 2 or 4; aligned)
__device__ __forceinline__ void ldn(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldn(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
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
  const float* lse;  // (B, H, S), from the forward
  float* delta;      // (B, H, S)
  int B, S, T, H, K, hd, causal;
  int vec;  // bf16: rows of 16-byte chunks (hd % 8 == 0, aligned)
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// float32, CUDA cores: dq (and delta)
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct DqSmem {
  static constexpr int kLq = ld<T, kBQ>();      // (d, query) tiles
  static constexpr int kLk = ld<T, kBKV>();     // (d, key) tiles
  static constexpr int kLkr = ld<T, HD>();      // (key, d) tile
  static constexpr int kLs = kBKV + 4;          // (key, query) float
  static constexpr size_t kBytes =
      sizeof(T) * (2 * HD * kLq + 2 * HD * kLk + kBKV * kLkr) +
      sizeof(float) * (kBKV * (kBQ + 4) + kBQ);
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
  float* delta_s = dSt + kBKV * L::kLs;

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

  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    lse[i] = r < q_len ? a.lse[stat + r] : INFINITY;
  }
  __syncthreads();  // delta_s is written
#pragma unroll
  for (int i = 0; i < 4; ++i) dlt[i] = delta_s[ty * 4 + i];

  // dq += ds k
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
// float32, CUDA cores: dk, dv
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
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
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


// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace bf16 {

using bf = __nv_bfloat16;
using tc::split_frags;
using tc::zero;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBQ = 128;       // dq kernel: queries a block, 64 a warpgroup
constexpr int kBKV = 64;       // dq kernel: keys a tile
constexpr int kBK = 128;       // dk/dv kernel: keys a block, 64 a warpgroup
constexpr int kBQT = 64;       // dk/dv kernel: queries a tile (two of 32)
constexpr float kLog2e = 1.4426950408889634f;

// bytes of a tile of R rows of HD (64, 112 or 128) columns, kept as
// 64-column blocks (tensor_core.cuh)
template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return (HD > 64 ? 2 : 1) * rows * 128;
}

// o += A B, A (64 x 16 bf16) from registers, B (16 x HD) MN-major
template <int HD>
__device__ __forceinline__ void mma_rs(float (&o)[HD / 8][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64) wg::mma_rs_n64(o, a, b);
  else if constexpr (HD == 112) wg::mma_rs_n112(o, a, b);
  else wg::mma_rs_n128(o, a, b);
}

// byte offset of k-step ks (16 columns) of a K-major tile of R rows
template <int R>
__device__ __forceinline__ uint32_t kstep(int ks) {
  return (ks >> 2) * R * 128 + (ks & 3) * 32;
}

// Store rows [row0 + g, row0 + g + 8] of a 64 x HD accumulator, times
// mult, in bf16: rows past len and columns past hd are left.
template <int HD>
__device__ __forceinline__ void store_rows(bf* base, size_t ld, int row0,
                                           int len, int hd,
                                           const float (&c)[HD / 8][4],
                                           float mult) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= len) continue;
    bf* out = base + static_cast<size_t>(row) * ld;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      const float v0 = c[n][2 * r] * mult, v1 = c[n][2 * r + 1] * mult;
      if (hd % 2 == 0) {
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < hd) out[col] = __float2bfloat16_rn(v0);
        if (col + 1 < hd) out[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// dq kernel: one block a (batch*head, 128 queries), heaviest first; Q and
// dO staged once, delta = rowsum(dO * o) summed and written for the dk/dv
// kernel, then the 64-key tiles of K and V through a 2-stage cp.async
// ring.  A tile: s = q k^T and dp = dO v^T (K and V K-major), p from the
// saved lse, ds = p (dp - delta), dq += ds k (ds from registers as bf16
// hi + lo, K read MN-major: the same tile).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(Args a) {
  constexpr int kKSteps = HD / 16;
  constexpr int kQBytes = tile_bytes<HD>(kBQ);
  constexpr int kKVBytes = tile_bytes<HD>(kBKV);
  extern __shared__ unsigned char smem_w[];
  const uint32_t sQ = (tc::smem_addr(smem_w) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kQBytes;
  const uint32_t sKV = sdO + kQBytes;  // stage i: K, then V

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
  const size_t q_off = (static_cast<size_t>(b) * a.S + q0) * q_ld +
                       static_cast<size_t>(h) * a.hd;
  const size_t k_off = static_cast<size_t>(b) * a.T * k_ld +
                       static_cast<size_t>(kh) * a.hd;
  const bf* kb = static_cast<const bf*>(a.k) + k_off;
  const bf* vb = static_cast<const bf*>(a.v) + k_off;
  const size_t stat = static_cast<size_t>(bh) * a.S;

  const int q_last = min(q0 + kBQ, a.S) - 1;
  const int t_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int n_kv = (t_end + kBKV - 1) / kBKV;

  auto load_kv = [&](int it) {
    const int t0 = it * kBKV;
    const uint32_t sK = sKV + (it & 1) * 2 * kKVBytes;
    tc::load_tile<HD, kBKV, kThreads>(sK, kb + t0 * k_ld, k_ld, a.T - t0,
                                      a.hd, a.vec);
    tc::load_tile<HD, kBKV, kThreads>(sK + kKVBytes, vb + t0 * k_ld, k_ld,
                                      a.T - t0, a.hd, a.vec);
  };
  tc::load_tile<HD, kBQ, kThreads>(sQ, static_cast<const bf*>(a.q) + q_off,
                                   q_ld, a.S - q0, a.hd, a.vec);
  tc::load_tile<HD, kBQ, kThreads>(sdO,
                                   static_cast<const bf*>(a.dout) + q_off,
                                   q_ld, a.S - q0, a.hd, a.vec);
  tc::cp_async_commit();
  if (n_kv > 0) load_kv(0);
  tc::cp_async_commit();

  // the warp's 16 rows: delta = rowsum(dO * o), a lane pair a row (each
  // lane every other 16-byte chunk, all loads in flight at once), written
  // for the dk/dv kernel and kept for rows g and g + 8; and the saved lse
  // in log2 units (+inf past S: p = 0 there)
  const int w0 = q0 + warp * 16;  // the warp's first query
  float dlt[2], lse2[2] = {INFINITY, INFINITY};
  {
    const int i = lane >> 1, half = lane & 1, row = w0 + i;
    float acc = 0.f;
    if (row < a.S) {
      const size_t off = q_off + static_cast<size_t>(warp * 16 + i) * q_ld;
      const bf* dr = static_cast<const bf*>(a.dout) + off;
      const bf* orow = static_cast<const bf*>(a.o) + off;
      if (a.vec) {
#pragma unroll
        for (int c = half * 8; c < HD; c += 16) {
          if (c >= a.hd) break;
          const uint4 u = *reinterpret_cast<const uint4*>(dr + c);
          const uint4 w = *reinterpret_cast<const uint4*>(orow + c);
          const uint32_t uu[4] = {u.x, u.y, u.z, u.w};
          const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&uu[e]));
            const float2 y = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ww[e]));
            acc += x.x * y.x + x.y * y.y;
          }
        }
      } else {
        for (int c = half; c < a.hd; c += 2)
          acc += __bfloat162float(dr[c]) * __bfloat162float(orow[c]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (row < a.S && half == 0) a.delta[stat + row] = acc;
    dlt[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row < a.S) lse2[r] = a.lse[stat + row] * kLog2e;
  }

  const int wq0 = q0 + wgi * 64;  // the warpgroup's first query
  float dq[HD / 8][4];
  zero(dq);
  for (int it = 0; it < n_kv; ++it) {
    if (it + 1 < n_kv) load_kv(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // Q, dO and tile `it` have landed
    wg::fence_proxy();
    __syncthreads();
    const int t0 = it * kBKV;
    const uint32_t sK = sKV + (it & 1) * 2 * kKVBytes;
    const uint32_t sV = sK + kKVBytes;
    if (wq0 < a.S && !(a.causal && t0 > wq0 + 63)) {  // warpgroup-uniform
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      wg::touch(s);
      wg::touch(dp);
      wg::fence();
      // two groups: p is formed while dp's products run
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wg::mma_ss_n64(s, wg::desc(sQ + kstep<kBQ>(ks) + wgi * 64 * 128, 16,
                                   1024),
                       wg::desc(sK + kstep<kBKV>(ks), 16, 1024), ks > 0);
      wg::commit();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wg::mma_ss_n64(dp, wg::desc(sdO + kstep<kBQ>(ks) + wgi * 64 * 128,
                                    16, 1024),
                       wg::desc(sV + kstep<kBKV>(ks), 16, 1024), ks > 0);
      wg::commit();
      wg::wait<1>();
      wg::touch(s);
      const bool edge = t0 + kBKV > a.T || (a.causal && t0 + kBKV - 1 > w0);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(s[n][e] * a.scale_log2 - lse2[r]);
          if (edge) {
            const int kpos = t0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = w0 + g + 8 * r;
            if (kpos >= a.T || (a.causal && kpos > qpos)) p = 0.f;
          }
          s[n][e] = p;
        }
      wg::wait<0>();
      wg::touch(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= dp[n][e] - dlt[e >> 1];  // ds
      // dq += ds k: every fragment keeps its registers until the wait
      uint32_t f[4][2][4];
      split_frags(s, f);
      wg::touch(dq);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dk = wg::desc(sK + kk * 16 * 128, kBKV * 128, 1024);
        mma_rs<HD>(dq, f[kk][0], dk);
        mma_rs<HD>(dq, f[kk][1], dk);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::touch_a(f[kk]);
    }
    __syncthreads();  // tile `it` consumed before its stage is reloaded
  }
  tc::cp_async_wait<0>();
  store_rows<HD>(static_cast<bf*>(a.dq) + q_off, q_ld, warp * 16,
                 a.S - q0, a.hd, dq, a.scale);
}

// dk/dv kernel: one block a (batch*kv head, 128 keys), the earliest keys
// (the most queries) first; K and V staged once, then for each query head
// of the group the 64-query tiles that can see the keys (Q, dO, lse,
// delta) through a 2-stage cp.async ring, each taken as two halves of 32
// queries.  A half: s^T = k q^T and dp^T = v dO^T (Q and dO K-major), p^T
// and ds^T from lse and delta, then dv += p^T dO and dk += ds^T q with p^T
// and ds^T from registers as bf16 hi + lo, dO and Q read MN-major.  dk
// and dv of the whole group stay in registers.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(Args a) {
  constexpr int kKSteps = HD / 16;
  constexpr int kKBytes = tile_bytes<HD>(kBK);
  constexpr int kQBytes = tile_bytes<HD>(kBQT);
  constexpr int kStage = 2 * kQBytes;       // Q, dO (1024-byte aligned)
  constexpr int kStatBytes = 2 * kBQT * 4;  // lse, delta
  extern __shared__ unsigned char smem_w[];
  const uint32_t sK = (tc::smem_addr(smem_w) + 1023) & ~1023u;
  const uint32_t sV = sK + kKBytes;
  const uint32_t sQ0 = sV + kKBytes;        // stage i at sQ0 + i * kStage
  const uint32_t sStat = sQ0 + 2 * kStage;  // stage i at + i * kStatBytes
  const unsigned char* stat_g = smem_w + (sStat - tc::smem_addr(smem_w));

  const int BK = a.B * a.K;
  const int kt = static_cast<int>(blockIdx.x / BK);  // heavy (early) first
  const int bk = static_cast<int>(blockIdx.x % BK);
  const int b = bk / a.K, kh = bk % a.K;
  const int G = a.H / a.K;
  const int t0 = kt * kBK;
  const int wgi = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const size_t q_ld = static_cast<size_t>(a.H) * a.hd;
  const size_t k_ld = static_cast<size_t>(a.K) * a.hd;
  const size_t k_off = (static_cast<size_t>(b) * a.T + t0) * k_ld +
                       static_cast<size_t>(kh) * a.hd;

  tc::load_tile<HD, kBK, kThreads>(sK, static_cast<const bf*>(a.k) + k_off,
                                   k_ld, a.T - t0, a.hd, a.vec);
  tc::load_tile<HD, kBK, kThreads>(sV, static_cast<const bf*>(a.v) + k_off,
                                   k_ld, a.T - t0, a.hd, a.vec);
  tc::cp_async_commit();

  const int n_qt = (a.S + kBQT - 1) / kBQT;
  const int q_first = a.causal ? min(t0 / kBQT, n_qt) : 0;
  const int per_head = n_qt - q_first;
  const int n_it = G * per_head;

  auto load_q = [&](int it) {
    const int h = kh * G + it / per_head;
    const int q0 = (q_first + it % per_head) * kBQT;
    const size_t q_off = (static_cast<size_t>(b) * a.S + q0) * q_ld +
                         static_cast<size_t>(h) * a.hd;
    const uint32_t st = sQ0 + (it & 1) * kStage;
    tc::load_tile<HD, kBQT, kThreads>(
        st, static_cast<const bf*>(a.q) + q_off, q_ld, a.S - q0, a.hd,
        a.vec);
    tc::load_tile<HD, kBQT, kThreads>(
        st + kQBytes, static_cast<const bf*>(a.dout) + q_off, q_ld,
        a.S - q0, a.hd, a.vec);
    if (threadIdx.x < 2 * kBQT) {  // lse, then delta; zero past S
      const int i = threadIdx.x % kBQT;
      const float* src = (threadIdx.x < kBQT ? a.lse : a.delta) +
                         (static_cast<size_t>(b) * a.H + h) * a.S;
      const bool in = q0 + i < a.S;
      tc::cp_async4(sStat + (it & 1) * kStatBytes + threadIdx.x * 4,
                    in ? src + q0 + i : src, in ? 4 : 0);
    }
  };
  if (n_it > 0) load_q(0);
  tc::cp_async_commit();

  const int wk0 = t0 + wgi * 64;   // the warpgroup's first key
  const int k0 = t0 + warp * 16;   // the warp's first key
  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // K, V and tile `it` have landed
    wg::fence_proxy();
    __syncthreads();
    const int q0 = (q_first + it % per_head) * kBQT;
    const uint32_t sQ = sQ0 + (it & 1) * kStage;
    const uint32_t sdO = sQ + kQBytes;
    const float* lse_s =
        reinterpret_cast<const float*>(stat_g + (it & 1) * kStatBytes);
    const float* dlt_s = lse_s + kBQT;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qs = q0 + half * 32;
      // warpgroup-uniform: past S, or every query before every key
      if (wk0 >= a.T || qs >= a.S || (a.causal && qs + 31 < wk0)) continue;
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
      wg::touch(st);
      wg::touch(dpt);
      wg::fence();
      // four groups, each formed while the one before runs: s^T; dp^T
      // (p^T formed meanwhile); dv (ds^T formed meanwhile); dk
      const uint32_t kq0 = wgi * 64 * 128, qq0 = half * 32 * 128;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wg::mma_ss_n32(st, wg::desc(sK + kq0 + kstep<kBK>(ks), 16, 1024),
                       wg::desc(sQ + qq0 + kstep<kBQT>(ks), 16, 1024),
                       ks > 0);
      wg::commit();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        wg::mma_ss_n32(dpt, wg::desc(sV + kq0 + kstep<kBK>(ks), 16, 1024),
                       wg::desc(sdO + qq0 + kstep<kBQT>(ks), 16, 1024),
                       ks > 0);
      wg::commit();
      wg::wait<1>();
      wg::touch(st);
      // rows: keys k0 + g (+ 8); columns: queries qs + 8n + 2t4 (+ 1)
      const bool edge = qs + 32 > a.S || k0 + 16 > a.T ||
                        (a.causal && k0 + 15 > qs);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = half * 32 + n * 8 + 2 * t4 + (e & 1);
          float p = exp2f(st[n][e] * a.scale_log2 - lse_s[c] * kLog2e);
          if (edge) {
            const int kpos = k0 + g + 8 * (e >> 1), qpos = q0 + c;
            if (qpos >= a.S || kpos >= a.T || (a.causal && kpos > qpos))
              p = 0.f;
          }
          st[n][e] = p;
        }
      uint32_t fp[2][2][4], fd[2][2][4];
      split_frags(st, fp);
      wg::touch(dv);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bo = wg::desc(sdO + (half * 32 + kk * 16) * 128,
                                     kBQT * 128, 1024);
        mma_rs<HD>(dv, fp[kk][0], bo);
        mma_rs<HD>(dv, fp[kk][1], bo);
      }
      wg::commit();
      wg::wait<1>();  // dp^T has landed; dv may still run
      wg::touch(dpt);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = half * 32 + n * 8 + 2 * t4 + (e & 1);
          dpt[n][e] = st[n][e] * (dpt[n][e] - dlt_s[c]);  // ds^T
        }
      split_frags(dpt, fd);
      wg::touch(dk);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bq = wg::desc(sQ + (half * 32 + kk * 16) * 128,
                                     kBQT * 128, 1024);
        mma_rs<HD>(dk, fd[kk][0], bq);
        mma_rs<HD>(dk, fd[kk][1], bq);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(dv);
      wg::touch(dk);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wg::touch_a(fp[kk]);
        wg::touch_a(fd[kk]);
      }
    }
    __syncthreads();  // tile `it` consumed before its stage is reloaded
  }
  tc::cp_async_wait<0>();
  const size_t k_base = static_cast<size_t>(b) * a.T * k_ld +
                        static_cast<size_t>(kh) * a.hd;
  store_rows<HD>(static_cast<bf*>(a.dk) + k_base, k_ld, k0, a.T, a.hd, dk,
                 a.scale);
  store_rows<HD>(static_cast<bf*>(a.dv) + k_base, k_ld, k0, a.T, a.hd, dv,
                 1.f);
}

template <int HD>
constexpr int dq_smem() {
  return 2 * tile_bytes<HD>(kBQ) + 4 * tile_bytes<HD>(kBKV) + 1024;
}
template <int HD>
constexpr int dkdv_smem() {
  return 2 * tile_bytes<HD>(kBK) +
         2 * (2 * tile_bytes<HD>(kBQT) + 2 * kBQT * 4) + 1024;
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem<HD>());
  if (err != cudaSuccess) return err;
  const long long dq_blocks =
      static_cast<long long>((a.S + kBQ - 1) / kBQ) * a.B * a.H;
  const long long kv_blocks =
      static_cast<long long>((a.T + kBK - 1) / kBK) * a.B * a.K;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  // in this order on one stream: the dk/dv kernel reads delta
  flash_bwd_dq_wgmma_kernel<HD><<<static_cast<unsigned>(dq_blocks),
                                  kThreads, dq_smem<HD>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<HD><<<static_cast<unsigned>(kv_blocks),
                                    kThreads, dkdv_smem<HD>(), stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd <= 64) return launch<64>(a, stream);
  if (a.hd <= 112) return launch<112>(a, stream);
  return launch<128>(a, stream);
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  lse is the
// forward's float32 (B, H, S) row log-sum-exp; delta a float32 workspace of
// B * H * S.  S, T > 0.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int S, int T, int H, int K, int hd, int dtype,
    int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || K <= 0 || H % K || hd <= 0 ||
      hd > kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Args a{q, k, v, o, dout, dq, dk, dv,
               static_cast<const float*>(lse), static_cast<float*>(delta),
               B, S, T, H, K, hd, causal,
               hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                   aligned(o) && aligned(dout),
               scale, scale * bf16::kLog2e};
  cudaError_t err;
  if (dtype == 0)
    err = a.hd <= 64 ? launch_f32<float, 64>(a, s)
                     : launch_f32<float, 128>(a, s);
  else if (dtype == 1)
    err = bf16::dispatch(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
