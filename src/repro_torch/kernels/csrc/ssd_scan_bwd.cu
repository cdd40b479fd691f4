// The gradient of the Mamba2 SSD chunked scan on Hopper (sm_90a),
// ngroups = 1: from x, dt, A, B, C, the output gradient dy and the final
// state's gradient dstate (or none), the five gradients dx (x's dtype) and
// ddt, dA, dB, dC (float32).
//
// Replaces no TPU kernel: the reference has no backward of its Pallas scan
// and trains through XLA's autodiff of src/repro/models/ssm.py:36
// ssd_chunked, whose function the forward kernel (ssd_scan.cu) computes.
// This kernel computes the same gradient as autograd of the port's plain
// version (kernels/ssd_scan.py::ssd_scan_ref).
//
// The function, per (batch, head) and chunk of Q steps, with cum the
// in-chunk cumulative sum of dt * A, T = cum[Q-1], H the state before the
// chunk and G the gradient of the state after it:
//   y[i]  = sum_{j<=i} s_ij L_ij dt_j x_j + exp(cum_i) H C_i,
//           s_ij = C_i . B_j, L_ij = exp(cum_i - cum_j)
//   h'    = exp(T) H + sum_j W_j x_j B_j^T,  W_j = exp(T - cum_j) dt_j
// and between chunks the state's gradient runs backwards:
//   G_prev = exp(T) G + sum_i exp(cum_i) dy_i C_i^T.
// Per chunk, with dyx_ij = dy_i . x_j and Pm_ij = L_ij dt_j dyx_ij (j <= i):
//   dx_j  = dt_j r_j,  r_j = sum_{i>=j} s_ij L_ij dy_i + exp(T - cum_j) G B_j
//   dC_i  = sum_j Pm_ij B_j + exp(cum_i) H^T dy_i
//   dB_j  = sum_i Pm_ij C_i + W_j G^T x_j
//   dcum  : + rows and - columns of s o Pm, + exp(cum_i) dy_i . (H C_i),
//           - W_j x_j . (G B_j), and dT = sum_j W_j x_j . (G B_j)
//           + exp(T) <G, H> at the chunk's last step
//   ddt_j = x_j . r_j + A * sum_{i>=j} dcum_i,  dA = sum dt_j sum_{i>=j} dcum_i
// The exponentials of L are taken only where j <= i: above the diagonal
// cum_i - cum_j is positive and large, and exp(.) * 0 would be NaN.  B and
// C are shared by the heads, so dB and dC sum over them.  cum is summed in
// order by one thread a head (in float64 for a float32 x, see below).
//
// Two designs, by the dtype of x.
//
// bfloat16 x (the training path): Hopper's warpgroup products (wgmma,
// wgmma.cuh) for every product, five kernels in order on the stream, with
// a float32 workspace that the wrapper allocates (bf16::Workspace, its size
// from ssd_scan_bwd_workspace_floats below).  A block is
// two warpgroups (256 threads); chunks are cut into 64-row tiles, nt a
// chunk.
//   1. ssd_bwd_state_kernel, one block a (batch, chunk, head pair), a
//      warpgroup a head: cum, T, w_j = exp(T - cum_j) dt_j and e_i =
//      exp(cum_i); the chunk's own state S_c = (x w)^T B and its part of the
//      state gradient U_c = (dy e)^T C (64 x kS each, a m64nkS k16 product
//      a k-step, as the forward's ssd_state_kernel); cum and dt by head for
//      the later kernels; the blocks of the first head pair leave B and C
//      as bf16 hi/lo planes.
//   2. ssd_bwd_pass_kernel, one thread per (batch, head, state element):
//      the float32 recurrences, H <- H exp(T) + S_c forwards and G <- G
//      exp(T) + U_c backwards from dstate, each chunk's H and G left as
//      hi/lo planes in the forward's layout, read by 3 and 4 as operands.
//   3. ssd_bwd_rows_kernel, one block a (batch, chunk, row tile i, row
//      group of rh <= 32 heads), the heaviest row tiles first: for each
//      column tile j <= i, s = C_i B_j^T (each warpgroup 32 columns,
//      exchanged through shared memory, written once for kernel 4), then a
//      pair of heads at a time (a warpgroup each) dyx = dy_i x_j^T, Pm and
//      the rows' and columns' sums of s o Pm into dcum; the heads' Pm are
//      summed (the warpgroups' parts added through shared memory), and
//      warpgroup 0 takes dC_i += Pm B_j while warpgroup 1 takes dB_j's part
//      Pm^T C_i (Pm^T read transposed from shared memory).  Then per head
//      the carried state's terms: warpgroup 0 v = dy_i H (dC_i += e_i v,
//      dcum_i += e_i C_i . v), warpgroup 1 x_i G (dB_i += W_i x_i G); the
//      first row tile's blocks sum <G, H>.
//   4. ssd_bwd_cols_kernel, one block a (batch, chunk, column tile j,
//      kColHeads = 2 heads), the heaviest column tiles first, a warpgroup
//      a head, two blocks an SM: r_j += (s o L)^T dy_i over i >= j, r_j in
//      registers, then gb = B_j G^T: r_j += exp(T - cum_j) gb, dx_j = dt_j
//      r_j, ddt_j's part x_j . r_j, and dcum's and dT's parts through G.
//   5. ssd_bwd_finish_kernel: per (batch, chunk, head) dcum from its parts
//      and its reversed sum over the chunk (a warp a head), ddt += A sum,
//      dA's partial; per (batch, chunk, row tile) dB and dC from the
//      partials.  The last block to finish (an integer ticket) sums dA in
//      (batch, chunk) order.
// Every sum over blocks is taken by one thread in a fixed order and no
// float atomic is used, so a rerun and a checkpoint's recompute are
// bit-equal.  The row groups are as few as the limit of 32 heads allows,
// and enough that kernel 3 launches about kFill = 132 blocks: dB's and dC's
// partials are by row group (ngr of them: 3 at mamba2-2.7b's 80 heads, 4 at
// Zamba2's 112), dB's also by tile pair: at mamba2's 4 x 2048 call 44 MB
// written and read back once (dC 12.6, dB 31.5), where the float32
// design's groups of 4 heads wrote 168 MB.
//
// The operand plan, as the forward's: x and dy are bf16 and enter as they
// are; every float32 operand (B, C, H, G, x w, dy e, Pm and its transpose,
// (s o L)^T) enters as a bf16 hi/lo pair (tc::split), three products where
// both operands are float32 (hi*hi + hi*lo + lo*hi) and two where one is
// bf16, so no operand loses more than about 2^-16 of itself; every
// accumulator is float32.  dyx = dy x^T is one product.  Operands in
// shared memory are bf16 tiles of 64 rows in 64-column blocks with the
// 128-byte swizzle, staged by cp.async (x and dy as they are, B, C, H and
// G from the planes); in kernel 3 a ring of two stages brings the next
// head pair's dy_i and x_j while a pair is multiplied, and then the next
// head's dy_i, x_i, H and G while one head's state terms are; in kernel 4
// the next row tile's dy_i, s and cum_i while one is.  The products whose
// A operand is built in registers step by step (x w, dy e, (s o L)^T) have
// two k-steps in flight.
//
// Shared memory a block, of the 227 KB a block may take (KB = 1,024
// bytes; at kS = 64 / 128): kernel 1, (8 kS / 64 + 8) tiles of 8 KB and 24
// Q bytes: 153 / 217 KB at Q = 1024 (135 / 199 KB at Q = 256), one block
// an SM; kernel 3, C_i (2 kS / 64 tiles), the larger of the column loop's
// B_j, ring, two float32 64 x 68 tiles and cum_j, dt_j, and the state
// terms' two stages, and 0.75 KB a head of cum_i, dt_i and dcum: 173 / 219
// KB at rh = 32 (any Q), one block an SM; kernel 4, B_j and a ring of two
// stages of two dy tiles and s: 86 / 102 KB, two blocks an SM.  Registers
// a thread (ptxas, CUDA 12.8, kS = 128 / 64): kernel 1 234 / 170 (two 64 x
// kS float32 accumulators, 128 floats at kS = 128), kernel 3 254 / 250
// (dC_i, 64 x kS, beside the 64 x 64 tiles s, Pm and dyx), kernel 4 128
// (its cap for two blocks an SM), kernels 2 and 5 54 and 48; none spills.
//
// What bounds it.  At mamba2-2.7b's 4 x 2048 call (80 heads of 64, state
// 128, chunk 256) the gradient is ~7.6e10 operations on ~0.27 GB: its
// bound is the bytes' 0.08 ms; the hi/lo plan makes it ~2.4x the products
// on the tensor cores (~0.19 ms at their peak).  This design takes ~1.7
// ms there (H100 80GB HBM3 at 700 W; chip_smoke.py [20b], the five
// kernels' shares in PERF.md): kernel 3 ~0.77 ms, of which its state
// terms ~0.28 (L2-bound: H and G read again for every row tile, ~0.8 GB)
// and L's exponentials ~0.18; kernel 4 ~0.39; kernel 1 ~0.33 (its hi/lo
// products, six a k-step, and B's and C's tiles for every head pair);
// kernel 2 ~0.12 (336 MB of state planes at ~2.8 TB/s).
//
// float32 x (the first design, on the CUDA cores; the float32 path keeps
// it): three kernels with a float32 workspace (Workspace below):
//   1. ssd_bwd_chunk_kernel, one block per (batch, chunk, head): the chunk's
//      own state S_c = sum_j W_j x_j B_j^T and its part of the state
//      gradient U_c = sum_i exp(cum_i) dy_i C_i^T (hp x st each), and T.
//   2. ssd_bwd_f32_pass_kernel, one thread per (batch, head, state
//      element): the serial pass over chunks forwards, H <- H exp(T) + S_c,
//      leaving the state before each chunk over S_c, and backwards from
//      dstate (or 0), G <- G exp(T) + U_c, leaving the gradient after each
//      chunk over U_c.
//   3. ssd_bwd_grad_kernel, one block per (batch, chunk, group of kHG = 4
//      heads): every gradient above.  s = C B^T is formed once a tile for
//      the group's heads, and the heads' Pm are summed before the two
//      products with B and C.  dB and dC leave as partials by head group,
//      dA as partials by (batch, chunk); the last block of a chunk to
//      finish (an integer ticket) sums the chunk's partials in group order,
//      and the last block of all sums dA in (batch, chunk) order.
// A 4 x 4 (or 4 x kS/16) register tile a thread over 256 threads; every
// operand staged in shared memory in float32 at a row stride of width + 1;
// kernel 3 holds three 64 x kS and three 64 x 64 tiles, cum and dcum (kHG
// Q doubles each) and the column partials (16 x 64 doubles): 219 KB at kS
// = 128 and Q = 1024 (dt is read from global memory).  Per head and chunk
// about Q^2 (hp + st) / 2 + 4 Q hp st multiply-adds, bound by the CUDA
// cores' 67 TFLOP/s.
//   Two parts are in float64, for dA.  cum is summed and held in float64,
// and every exponent (cum_i - cum_j, T - cum_j, cum_i) is formed in
// float64 before it is rounded: at a decay dt A of ~-10 a step cum reaches
// ~-2,600 in a chunk of 256, where float32's spacing is 2.4e-4, an error
// of that size in the exponent of every L_ij near the diagonal.  And
// dcum_i is the difference of the rows' and columns' sums of s o Pm, each
// far larger than it, while dA sums dcum's reversed sums: those sums, dcum
// and its reversed sums are float64 (each s o Pm term stays float32: it
// enters both sums alike), and so is dT's sum of W_j dW_j, whose terms
// dcum_j also takes.  In float32 either part alone puts dA ~1e-4 to
// 2e-3 of its largest magnitude from the exact gradient at the shapes of
// chip_smoke.py [20a], past the 1e-4 tolerance; the float32 plain version,
// which has both, is as far.
//
// Widths.  hp <= 64, st <= 128, Q <= 1024 and a divisor of S, any head
// count, as the forward's; kernels are templates on kS (64 for st <= 64,
// 128 above), the state columns past st zero-filled and never written.

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
constexpr int kHG = 4;          // heads a block of kernel 3

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// rows [r0, r0 + kT) of a (rows, width) matrix with row stride `ld`, into
// kT x kW floats at a row stride of kW + 1, zero past `rows` and `width`
template <int kW, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t ld,
                                      int r0, int rows, int width) {
  for (int idx = threadIdx.x; idx < kT * kW; idx += kThreads) {
    const int r = idx / kW, c = idx % kW;
    const int row = r0 + r;
    dst[r * (kW + 1) + c] =
        (row < rows && c < width) ? to_f32(src[row * ld + c]) : 0.f;
  }
}

// the sum over the 16 threads of one tile row (lanes of a half-warp)
template <typename V>
__device__ __forceinline__ V row_sum(V v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const T* dy;
  const float* dstate;   // (b, nh, hp, st) or null
  T* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* hs;     // (b, nc, nh, hp, st): S_c, then the state before chunk c
  float* gs;     // (b, nc, nh, hp, st): U_c, then the gradient after c
  float* tot;    // (b, nc, nh): T
  float* dap;    // (b, nc, nh): dA partials
  float* dbp;    // (b, nc, nhg, Q, st): dB partials by head group
  float* dcp;    // (b, nc, nhg, Q, st): dC partials
  int* cnt;      // b * nc tickets, then one for dA; zeroed before kernel 3
  int b, S, nh, hp, st, Q, nc, nhg;
};

// float32 offsets of the workspace's parts, each a multiple of 64 values;
// `end` is its size (ssd_scan_bwd_workspace_floats).
struct Workspace {
  size_t hs, gs, tot, dap, dbp, dcp, cnt, end;
  Workspace(int b, int S, int nh, int hp, int st, int Q) {
    const auto up = [](size_t n) { return (n + 63) / 64 * 64; };
    const size_t nc = S / Q, nhg = (nh + kHG - 1) / kHG;
    const size_t states = up(static_cast<size_t>(b) * nc * nh * hp * st);
    const size_t per_chunk = up(static_cast<size_t>(b) * nc * nh);
    const size_t parts = up(static_cast<size_t>(b) * S * nhg * st);
    hs = 0;
    gs = hs + states;
    tot = gs + states;
    dap = tot + per_chunk;
    dbp = dap + per_chunk;
    dcp = dbp + parts;
    cnt = dcp + parts;
    end = cnt + up(static_cast<size_t>(b) * nc + 1);
  }
};

// the in-chunk cumulative sum of dt * a in float64, in order (one thread;
// dt_j at dt[j * stride])
__device__ __forceinline__ void chunk_cumsum(double* cum, const float* dt,
                                             size_t stride, float a, int Q) {
  double acc = 0.0;
  for (int j = 0; j < Q; ++j) {
    acc += static_cast<double>(dt[j * stride]) * a;
    cum[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// 1. each chunk's own state and its part of the state gradient
// ---------------------------------------------------------------------------

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(Args<T> a) {
  constexpr int kSS = kS + 1, kSC = kS / 16;
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q;
  double* cum = reinterpret_cast<double*>(smem);  // [Q]
  float* w = smem + 2 * Q;             // [Q]: dt, then W_j
  float* e = w + Q;                    // [Q]: exp(cum_i)
  float* Xs = e + Q;                   // [kT][kStride]  W_j x_j
  float* DYs = Xs + kT * kStride;      // [kT][kStride]  exp(cum_i) dy_i
  float* Bs = DYs + kT * kStride;      // [kT][kSS]
  float* Cs = Bs + kT * kSS;           // [kT][kSS]

  const int h = blockIdx.x % a.nh;
  const int bc = blockIdx.x / a.nh;    // bi * nc + c
  const int bi = bc / a.nc, c = bc % a.nc;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nh = a.nh, hp = a.hp, st = a.st;
  const size_t t0 = static_cast<size_t>(bi) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(nh) * hp;

  for (int j = tid; j < Q; j += kThreads) w[j] = a.dt[(t0 + j) * nh + h];
  __syncthreads();
  if (tid == 0) {
    chunk_cumsum(cum, w, 1, a.A[h], Q);
    a.tot[static_cast<size_t>(bc) * nh + h] = static_cast<float>(cum[Q - 1]);
  }
  __syncthreads();
  const double T_c = cum[Q - 1];
  for (int j = tid; j < Q; j += kThreads) {
    w[j] = expf(static_cast<float>(T_c - cum[j])) * w[j];
    e[j] = expf(static_cast<float>(cum[j]));
  }

  const T* xc = a.x + t0 * x_ld + h * hp;
  const T* dyc = a.dy + t0 * x_ld + h * hp;
  const float* Bc = a.B + t0 * st;
  const float* Cc = a.C + t0 * st;
  float sacc[4][kSC], uacc[4][kSC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < kSC; ++cc) sacc[r][cc] = uacc[r][cc] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kT) {
    __syncthreads();  // the previous tiles consumed; w and e written
    for (int idx = tid; idx < kT * kT; idx += kThreads) {
      const int r = idx / kT, p = idx % kT, j = j0 + r;
      const bool in = j < Q && p < hp;
      Xs[r * kStride + p] = in ? to_f32(xc[j * x_ld + p]) * w[j] : 0.f;
      DYs[r * kStride + p] = in ? to_f32(dyc[j * x_ld + p]) * e[j] : 0.f;
    }
    stage<kS>(Bs, Bc, st, j0, Q, st);
    stage<kS>(Cs, Cc, st, j0, Q, st);
    __syncthreads();
    const int nj = min(kT, Q - j0);
    for (int j = 0; j < nj; ++j) {
      float xv[4], dv[4], bv[kSC], cv[kSC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xv[r] = Xs[j * kStride + ty + 16 * r];
        dv[r] = DYs[j * kStride + ty + 16 * r];
      }
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) {
        bv[cc] = Bs[j * kSS + tx + 16 * cc];
        cv[cc] = Cs[j * kSS + tx + 16 * cc];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) {
          sacc[r][cc] += xv[r] * bv[cc];
          uacc[r][cc] += dv[r] * cv[cc];
        }
    }
  }

  const size_t base = (static_cast<size_t>(bc) * nh + h) * hp * st;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= hp) continue;
#pragma unroll
    for (int cc = 0; cc < kSC; ++cc) {
      const int s = tx + 16 * cc;
      if (s < st) {
        a.hs[base + p * st + s] = sacc[r][cc];
        a.gs[base + p * st + s] = uacc[r][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the passes over chunks: the states forwards, their gradients backwards
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_f32_pass_kernel(Args<T> a) {
  const size_t n = static_cast<size_t>(a.b) * a.nh * a.hp * a.st;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  if (idx >= n) return;
  const size_t plane = static_cast<size_t>(a.hp) * a.st;
  const size_t e = idx % plane;        // p * st + s
  const size_t bh = idx / plane;       // bi * nh + h
  const int h = static_cast<int>(bh % a.nh);
  const size_t bi = bh / a.nh;
  const auto at = [&](int c) {
    return ((bi * a.nc + c) * a.nh + h) * plane + e;
  };
  const auto total = [&](int c) {
    return a.tot[(bi * a.nc + c) * a.nh + h];
  };
  // kRun chunks' values and decays are loaded before any is used, so that
  // a thread keeps kRun loads in flight rather than one
  constexpr int kRun = 8;
  float hv = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kRun) {
    float v[kRun], d[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (c0 + k < a.nc) {
        v[k] = a.hs[at(c0 + k)];
        d[k] = expf(total(c0 + k));
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (c0 + k < a.nc) {
        a.hs[at(c0 + k)] = hv;
        hv = hv * d[k] + v[k];
      }
    }
  }
  float g = a.dstate ? a.dstate[idx] : 0.f;
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= kRun) {
    float v[kRun], d[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (c1 - k >= 0) {
        v[k] = a.gs[at(c1 - k)];
        d[k] = expf(total(c1 - k));
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (c1 - k >= 0) {
        a.gs[at(c1 - k)] = g;
        g = g * d[k] + v[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the gradients, per (batch, chunk, head group)
// ---------------------------------------------------------------------------

template <int kS>
constexpr size_t grad_smem_floats(int Q) {
  return 4 * kHG * static_cast<size_t>(Q) + 2 * 16 * kT + 2 * kHG +
         3 * kT * (kS + 1) + 3 * kT * kStride + kThreads + kHG;
}

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad_kernel(Args<T> a) {
  constexpr int kSS = kS + 1, kSC = kS / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int chunk_last, all_last;
  const int Q = a.Q, nh = a.nh, hp = a.hp, st = a.st;
  double* cum = reinterpret_cast<double*>(smem);  // [kHG][Q]
  double* dcum = cum + kHG * Q;         // [kHG][Q]
  double* colp = dcum + kHG * Q;        // [16][kT]  column partials
  double* dTacc = colp + 16 * kT;       // [kHG]  sum_j W_j dW_j
  float* Cs = reinterpret_cast<float*>(dTacc + kHG);  // [kT][kSS] C rows i
  float* Bs = Cs + kT * kSS;            // [kT][kSS]   B rows j
  float* Ms = Bs + kT * kSS;            // [kT][kSS]   H or G of one head
  float* Xs = Ms + kT * kSS;            // [kT][kStride]  x rows j
  float* DYs = Xs + kT * kStride;       // [kT][kStride]  dy rows i
  float* SLs = DYs + kT * kStride;      // [kT][kStride]  s o L, then sum Pm
  float* red = SLs + kT * kStride;      // [kThreads]
  float* gh = red + kThreads;           // [kHG]  <G, H>

  const int g = blockIdx.x % a.nhg;
  const int bc = blockIdx.x / a.nhg;    // bi * nc + c
  const int bi = bc / a.nc, c = bc % a.nc;
  const int h0 = g * kHG, nk = min(kHG, nh - h0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t t0 = static_cast<size_t>(bi) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(nh) * hp;
  const size_t plane = static_cast<size_t>(hp) * st;
  const float* Bc = a.B + t0 * st;
  const float* Cc = a.C + t0 * st;
  const auto state_of = [&](const float* base, int k) {
    return base + (static_cast<size_t>(bc) * nh + h0 + k) * plane;
  };
  // dt of head h0 + k at step j: dt_of(k)[j * nh]
  const auto dt_of = [&](int k) { return a.dt + t0 * nh + h0 + k; };
  // dB / dC partial rows of this block
  const size_t part0 = (static_cast<size_t>(bc) * a.nhg + g) * Q * st;

  for (int idx = tid; idx < kHG * Q; idx += kThreads) dcum[idx] = 0.0;
  if (tid < kHG) {
    if (tid < nk) {
      chunk_cumsum(cum + tid * Q, dt_of(tid), nh, a.A[h0 + tid], Q);
    } else {
      for (int j = 0; j < Q; ++j) cum[tid * Q + j] = 0.0;
    }
    dTacc[tid] = 0.0;
  }
  // <G, H> of each head, summed in a fixed order
  for (int k = 0; k < nk; ++k) {
    const float* hk = state_of(a.hs, k);
    const float* gk = state_of(a.gs, k);
    float part = 0.f;
    for (size_t i = tid; i < plane; i += kThreads) part += hk[i] * gk[i];
    red[tid] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int i = 0; i < kThreads; ++i) sum += red[i];
      gh[k] = sum;
    }
    __syncthreads();
  }

  // dC's term from the carried state, and its dcum: per row tile i,
  // v_i = H^T dy_i, dC_i = sum_k exp(cum_i) v_i, dcum_i += exp(cum_i) C_i.v_i
  for (int i0 = 0; i0 < Q; i0 += kT) {
    stage<kS>(Cs, Cc, st, i0, Q, st);
    float dca[4][kSC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) dca[r][cc] = 0.f;
    for (int k = 0; k < nk; ++k) {
      stage<kS>(Ms, state_of(a.hs, k), st, 0, hp, st);
      stage<kT>(DYs, a.dy + t0 * x_ld + (h0 + k) * hp, x_ld, i0, Q, hp);
      __syncthreads();
      float v[4][kSC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) v[r][cc] = 0.f;
      for (int p = 0; p < hp; ++p) {
        float dv[4], hv[kSC];
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[r] = DYs[(ty + 16 * r) * kStride + p];
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) hv[cc] = Ms[p * kSS + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) v[r][cc] += dv[r] * hv[cc];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e =
            i < Q ? expf(static_cast<float>(cum[k * Q + i])) : 0.f;
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) {
          dot += Cs[(ty + 16 * r) * kSS + tx + 16 * cc] * v[r][cc];
          dca[r][cc] += e * v[r][cc];
        }
        dot = row_sum(dot);
        if (tx == 0 && i < Q) dcum[k * Q + i] += e * dot;
      }
      __syncthreads();  // Ms and DYs consumed
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= Q) continue;
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) {
        const int s = tx + 16 * cc;
        if (s < st) a.dcp[part0 + static_cast<size_t>(i) * st + s] = dca[r][cc];
      }
    }
    __syncthreads();  // Cs consumed
  }

  for (int j0 = 0; j0 < Q; j0 += kT) {
    stage<kS>(Bs, Bc, st, j0, Q, st);
    float dxr[kHG][4][4];
    float dba[4][kSC];
#pragma unroll
    for (int k = 0; k < kHG; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dxr[k][r][cc] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) dba[r][cc] = 0.f;

    for (int i0 = j0; i0 < Q; i0 += kT) {
      stage<kS>(Cs, Cc, st, i0, Q, st);
      __syncthreads();
      // s = C_i . B_j, once for the group's heads
      float sc[4][4], pms[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sc[r][cc] = pms[r][cc] = 0.f;
      for (int s = 0; s < st; ++s) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kSS + s];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[(tx + 16 * cc) * kSS + s];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sc[r][cc] += cv[r] * bv[cc];
      }
      const int ni = min(kT, Q - i0);
#pragma unroll
      for (int k = 0; k < kHG; ++k) {
        if (k < nk) {
          const double* ck = cum + k * Q;
          const float* dtk = dt_of(k);
          float dk[4];  // dt of this thread's columns
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = j0 + tx + 16 * cc;
            dk[cc] = j < Q ? dtk[static_cast<size_t>(j) * nh] : 0.f;
          }
          stage<kT>(Xs, a.x + t0 * x_ld + (h0 + k) * hp, x_ld, j0, Q, hp);
          stage<kT>(DYs, a.dy + t0 * x_ld + (h0 + k) * hp, x_ld, i0, Q, hp);
          __syncthreads();
          float dyx[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) dyx[r][cc] = 0.f;
          for (int p = 0; p < hp; ++p) {
            float dv[4], xv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              dv[r] = DYs[(ty + 16 * r) * kStride + p];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              xv[cc] = Xs[(tx + 16 * cc) * kStride + p];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) dyx[r][cc] += dv[r] * xv[cc];
          }
          // the rows' and columns' sums of s o Pm in float64: dcum_i is
          // their difference, and dA a sum of dcum's reversed sums
          double pcol[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 16 * r;
            double prow = 0.0;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = j0 + tx + 16 * cc;
              float sl = 0.f;
              if (j <= i && i < Q) {   // never exp above the diagonal
                const float L = expf(static_cast<float>(ck[i] - ck[j]));
                const float pm = L * dk[cc] * dyx[r][cc];
                const float pp = sc[r][cc] * pm;
                sl = sc[r][cc] * L;
                pms[r][cc] += pm;
                prow += pp;
                pcol[cc] += pp;
              }
              SLs[(ty + 16 * r) * kStride + tx + 16 * cc] = sl;
            }
            prow = row_sum(prow);
            if (tx == 0 && i < Q) dcum[k * Q + i] += prow;
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            colp[ty * kT + tx + 16 * cc] = pcol[cc];
          __syncthreads();
          if (tid < kT && j0 + tid < Q) {
            double sum = 0.0;
            for (int y = 0; y < 16; ++y) sum += colp[y * kT + tid];
            dcum[k * Q + j0 + tid] -= sum;
          }
          // r_j += sum_i (s o L)_ij dy_i
          for (int i = 0; i < ni; ++i) {
            float sv[4], dv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) sv[r] = SLs[i * kStride + ty + 16 * r];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              dv[cc] = DYs[i * kStride + tx + 16 * cc];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) dxr[k][r][cc] += sv[r] * dv[cc];
          }
          __syncthreads();  // Xs, DYs, SLs and colp consumed
        }
      }
      // the heads' Pm summed: dB_j += Pm^T C_i, dC_i += Pm B_j
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          SLs[(ty + 16 * r) * kStride + tx + 16 * cc] = pms[r][cc];
      __syncthreads();
      for (int i = 0; i < ni; ++i) {
        float pv[4], cv[kSC];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = SLs[i * kStride + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < kSC; ++cc) cv[cc] = Cs[i * kSS + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) dba[r][cc] += pv[r] * cv[cc];
      }
      {
        float dcc[4][kSC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) dcc[r][cc] = 0.f;
        const int nj = min(kT, Q - j0);
        for (int j = 0; j < nj; ++j) {
          float pv[4], bv[kSC];
#pragma unroll
          for (int r = 0; r < 4; ++r) pv[r] = SLs[(ty + 16 * r) * kStride + j];
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) bv[cc] = Bs[j * kSS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < kSC; ++cc) dcc[r][cc] += pv[r] * bv[cc];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i >= Q) continue;
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) {
            const int s = tx + 16 * cc;
            if (s < st)
              a.dcp[part0 + static_cast<size_t>(i) * st + s] += dcc[r][cc];
          }
        }
      }
      __syncthreads();  // Cs and SLs consumed
    }

    // the terms through the state after the chunk, head by head
#pragma unroll
    for (int k = 0; k < kHG; ++k) {
      if (k < nk) {
        const double* ck = cum + k * Q;
        const float* dtk = dt_of(k);
        const double T_c = ck[Q - 1];
        stage<kS>(Ms, state_of(a.gs, k), st, 0, hp, st);
        stage<kT>(Xs, a.x + t0 * x_ld + (h0 + k) * hp, x_ld, j0, Q, hp);
        __syncthreads();
        // gb_j = G B_j (rows j, columns p), xg_j = G^T x_j (columns s)
        float gb[4][4], xg[4][kSC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) gb[r][cc] = 0.f;
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) xg[r][cc] = 0.f;
        }
        for (int s = 0; s < st; ++s) {
          float bv[4], gv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) bv[r] = Bs[(ty + 16 * r) * kSS + s];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) gv[cc] = Ms[(tx + 16 * cc) * kSS + s];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) gb[r][cc] += bv[r] * gv[cc];
        }
        for (int p = 0; p < hp; ++p) {
          float xv[4], gv[kSC];
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[r] = Xs[(ty + 16 * r) * kStride + p];
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) gv[cc] = Ms[p * kSS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < kSC; ++cc) xg[r][cc] += xv[r] * gv[cc];
        }
        T* dxk = a.dx + t0 * x_ld + (h0 + k) * hp;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jl = ty + 16 * r, j = j0 + jl;
          const bool in = j < Q;
          const float ej = in ? expf(static_cast<float>(T_c - ck[j])) : 0.f;
          const float dtj = in ? dtk[static_cast<size_t>(j) * nh] : 0.f;
          const float W = ej * dtj;
          float dW = 0.f, ddir = 0.f;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float xv = Xs[jl * kStride + tx + 16 * cc];
            dW += xv * gb[r][cc];
            dxr[k][r][cc] += ej * gb[r][cc];
            ddir += xv * dxr[k][r][cc];
          }
#pragma unroll
          for (int cc = 0; cc < kSC; ++cc) dba[r][cc] += W * xg[r][cc];
          dW = row_sum(dW);
          ddir = row_sum(ddir);
          if (tx == 0) {
            red[jl] = W * dW;
            if (in) {
              dcum[k * Q + j] -= W * dW;
              a.ddt[(t0 + j) * nh + h0 + k] = ddir;
            }
          }
          if (in) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int p = tx + 16 * cc;
              if (p < hp) dxk[j * x_ld + p] = from_f32<T>(dtj * dxr[k][r][cc]);
            }
          }
        }
        __syncthreads();  // Ms, Xs consumed; red written
        if (tid == 0) {
          double sum = dTacc[k];
          for (int r = 0; r < kT; ++r) sum += red[r];
          dTacc[k] = sum;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + 16 * r;
      if (j >= Q) continue;
#pragma unroll
      for (int cc = 0; cc < kSC; ++cc) {
        const int s = tx + 16 * cc;
        if (s < st) a.dbp[part0 + static_cast<size_t>(j) * st + s] = dba[r][cc];
      }
    }
    __syncthreads();  // Bs and red consumed
  }

  // dT at the chunk's last step, then d(dt A)_j = sum_{i>=j} dcum_i
  if (tid < nk) {
    double* dc = dcum + tid * Q;
    const double* ck = cum + tid * Q;
    const float* dtk = dt_of(tid);
    dc[Q - 1] += dTacc[tid] + expf(static_cast<float>(ck[Q - 1])) * gh[tid];
    double acc = 0.0, da = 0.0;
    for (int j = Q - 1; j >= 0; --j) {
      acc += dc[j];
      dc[j] = acc;
      da += acc * dtk[static_cast<size_t>(j) * nh];
    }
    a.dap[static_cast<size_t>(bc) * nh + h0 + tid] = static_cast<float>(da);
  }
  __syncthreads();
  for (int idx = tid; idx < nk * Q; idx += kThreads) {
    const int k = idx / Q, j = idx % Q;
    a.ddt[(t0 + j) * nh + h0 + k] +=
        static_cast<float>(a.A[h0 + k] * dcum[k * Q + j]);
  }

  // the last block of the chunk sums its dB and dC partials in group order;
  // the last block of all sums dA in (batch, chunk) order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    chunk_last = atomicAdd(a.cnt + bc, 1) == a.nhg - 1;
    all_last = atomicAdd(a.cnt + a.b * a.nc, 1) ==
               static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (chunk_last) {
    __threadfence();
    const size_t stride = static_cast<size_t>(Q) * st;
    const float* pb = a.dbp + static_cast<size_t>(bc) * a.nhg * stride;
    const float* pc = a.dcp + static_cast<size_t>(bc) * a.nhg * stride;
    for (size_t idx = tid; idx < stride; idx += kThreads) {
      float sb = 0.f, sc = 0.f;
      for (int gg = 0; gg < a.nhg; ++gg) {
        sb += __ldcg(pb + gg * stride + idx);
        sc += __ldcg(pc + gg * stride + idx);
      }
      a.dB[t0 * st + idx] = sb;
      a.dC[t0 * st + idx] = sc;
    }
  }
  if (all_last) {
    __threadfence();
    const int nbc = a.b * a.nc;
    for (int h = tid; h < nh; h += kThreads) {
      double sum = 0.0;
      for (int i = 0; i < nbc; ++i)
        sum += __ldcg(a.dap + static_cast<size_t>(i) * nh + h);
      a.dA[h] = static_cast<float>(sum);
    }
  }
}

template <typename T, int kS>
cudaError_t run(Args<T> a, cudaStream_t stream) {
  const size_t smem1 =
      sizeof(float) * (4 * a.Q + 2 * kT * kStride + 2 * kT * (kS + 1));
  const size_t smem3 = sizeof(float) * grad_smem_floats<kS>(a.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<T, kS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_grad_kernel<T, kS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return err;
  const long long blocks1 = static_cast<long long>(a.b) * a.nc * a.nh;
  const long long n2 = static_cast<long long>(a.b) * a.nh * a.hp * a.st;
  const long long blocks3 = static_cast<long long>(a.b) * a.nc * a.nhg;
  if (blocks1 > 0x7fffffffLL || (n2 + 255) / 256 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(a.cnt, 0, sizeof(int) * (a.b * a.nc + 1), stream);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, kS>
      <<<static_cast<unsigned>(blocks1), kThreads, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_f32_pass_kernel<T>
      <<<static_cast<unsigned>((n2 + 255) / 256), 256, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_grad_kernel<T, kS>
      <<<static_cast<unsigned>(blocks3), kThreads, smem3, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* dy,
                     const void* dstate, void* dx, void* ddt, void* dA,
                     void* dB, void* dC, void* ws, long long ws_floats, int b,
                     int S, int nh, int hp, int st, int Q,
                     cudaStream_t stream) {
  const Workspace w(b, S, nh, hp, st, Q);
  if (ws == nullptr || ws_floats < 0 ||
      static_cast<size_t>(ws_floats) < w.end)
    return cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dy = static_cast<const T*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dx = static_cast<T*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.hs = wsf + w.hs;
  a.gs = wsf + w.gs;
  a.tot = wsf + w.tot;
  a.dap = wsf + w.dap;
  a.dbp = wsf + w.dbp;
  a.dcp = wsf + w.dcp;
  a.cnt = reinterpret_cast<int*>(wsf + w.cnt);
  a.b = b, a.S = S, a.nh = nh, a.hp = hp, a.st = st, a.Q = Q;
  a.nc = S / Q;
  a.nhg = (nh + kHG - 1) / kHG;
  return st > kT ? run<T, 2 * kT>(a, stream) : run<T, kT>(a, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 x: tensor cores
// ---------------------------------------------------------------------------

namespace bf16 {

using bf = __nv_bfloat16;
using ssdt::mma_rs_state;
using ssdt::seq_cumsum;
using ssdt::split_raw;
using ssdt::stage_plane;
using ssdt::stage_raw;
using ssdt::stage_x;
using tc::split_frags;
using tc::swz;
using tc::swz_tile;
using tc::zero;
constexpr int kThreads2 = ssdt::kThreads;  // two warpgroups
constexpr int kTileBytes = kT * kT * 2;   // one 64 x 64 bf16 tile
constexpr int kSP = kT + 4;               // row stride of a float32 64 x 64 tile
constexpr int kExBytes = kT * kSP * 4;    // one such tile
constexpr int kMaxRowHeads = 32;          // heads a block of the rows kernel
constexpr int kColHeads = 2;              // heads a block of the columns kernel
constexpr int kFill = 132;                // rows-kernel blocks aimed at (SMs)

// Planes and tiles as in ssd_tiles.cuh.
struct Args {
  const bf* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const bf* dy;
  const float* dstate;   // (b, nh, hp, st) or null
  bf* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  bf* b_pl;              // (b * S) plane rows of B
  bf* c_pl;              // (b * S) plane rows of C
  float* s_c;            // (b, nc, nh, hp, st): each chunk's own state
  float* u_c;            // (b, nc, nh, hp, st): its part of the gradient
  float* total;          // (b, nc, nh): cum at the chunk's last step
  float* cum_t;          // (b, nc, nh, Q): cum, by head
  float* dt_t;           // (b, nc, nh, Q): dt, by head
  bf* h_pl;              // (b, nc, nh) planes of 64 rows: H, the state before
  bf* g_pl;              // (b, nc, nh) planes: G, the gradient after
  float* s_t;            // (b, nc, npair, 64, 64): C B^T by tile pair
  float* dcp;            // (ngr) x (b * S, st): dC partials by row group
  float* dbp;            // (ngr, b, nc, npair, 64, st): dB partials
  float* dcs;            // (b, nc, nh, nt, Q): dcum partials by row tile
  float* gcum;           // (b, nc, nh, Q): dcum's part through G
  float* dtp;            // (b, nc, nh, nt): dT's parts by column tile
  float* gh;             // (b, nc, nh): <G, H>
  float* dap;            // (b, nc, nh): dA partials
  int* cnt;              // the finish kernel's ticket
  size_t dcp_stride;     // floats between two row groups' dC partials
  int b, S, nh, hp, st, Q, nc, nt, npair, ngr, rh, ncg;
  int vec_x;   // x, dy and dx rows in 16-byte chunks (hp % 8 == 0, aligned)
  int vec_bc;  // B and C rows in float4 (st % 4 == 0, aligned)
};

// The launch's geometry: nt row tiles of 64 a chunk, npair tile pairs
// (i >= j), ngr row groups of rh heads (at most kMaxRowHeads, and enough
// groups that the rows kernel launches about kFill blocks), ncg column
// groups of kColHeads heads.
struct Layout {
  int nc, nt, npair, ngr, rh, ncg;
  Layout(int b, int S, int nh, int Q) {
    nc = S / Q;
    nt = (Q + kT - 1) / kT;
    npair = nt * (nt + 1) / 2;
    const long long tiles = static_cast<long long>(b) * nc * nt;
    const long long fill = kFill / tiles;
    int g0 = (nh + kMaxRowHeads - 1) / kMaxRowHeads;
    g0 = max(g0, static_cast<int>(min(fill, static_cast<long long>(
                     (nh + 1) / 2))));
    g0 = max(g0, 1);
    rh = (nh + g0 - 1) / g0;
    ngr = (nh + rh - 1) / rh;
    ncg = (nh + kColHeads - 1) / kColHeads;
  }
};

// float32 offsets of the workspace's parts, each a multiple of 64 values;
// `end` is its size (ssd_scan_bwd_workspace_floats).
struct Workspace {
  size_t b_pl, c_pl, s_c, u_c, total, cum_t, dt_t, h_pl, g_pl, s_t, dcp,
      dcp_stride, dbp, dcs, gcum, dtp, gh, dap, cnt, end;
  Workspace(int b, int S, int nh, int hp, int st, int Q, int kS,
            const Layout& l) {
    const auto up = [](size_t n) { return (n + 63) / 64 * 64; };
    const size_t B = b, nc = l.nc, bs = B * S, bcn = B * nc * nh;
    size_t o = 0;
    const auto take = [&](size_t n) { const size_t at = o; o += up(n); return at; };
    b_pl = take(bs * kS);
    c_pl = take(bs * kS);
    s_c = take(bcn * hp * st);
    u_c = take(bcn * hp * st);
    total = take(bcn);
    cum_t = take(bs * nh);
    dt_t = take(bs * nh);
    h_pl = take(bcn * kT * kS);
    g_pl = take(bcn * kT * kS);
    s_t = take(B * nc * l.npair * kT * kT);
    dcp_stride = up(bs * st);
    dcp = take(l.ngr * dcp_stride);
    dbp = take(static_cast<size_t>(l.ngr) * B * nc * l.npair * kT * st);
    dcs = take(bcn * l.nt * Q);
    gcum = take(bs * nh);
    dtp = take(bcn * l.nt);
    gh = take(bcn);
    dap = take(bcn);
    cnt = take(64);
    end = o;
  }
};

// d (64 x kS) += A B over one k-step, A K-major and B MN-major, both from
// shared memory
template <int NT>
__device__ __forceinline__ void mma_ss_t_state(float (&d)[NT][4],
                                               uint64_t da, uint64_t db) {
  if constexpr (NT == 8) wg::mma_ss_t_n64(d, da, db);
  else wg::mma_ss_t_n128(d, da, db);
}

// a barrier over the 128 threads of warpgroup wgi
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wgi) : "memory");
}

// the two bf16 at a shared-memory address, as floats
__device__ __forceinline__ float2 lds_bf2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// shared memory of the kernels, in bytes (the 1024 added aligns the tiles)
template <int kS>
__host__ __device__ constexpr int state_smem(int Q) {
  return (8 * (kS / kT) + 8) * kTileBytes + 6 * Q * 4 + 1024;
}
// the rows kernel: C_i; then either the column loop's B_j, ring, s and Pm
// tiles and cum_j, dt_j, or two stages of the carried state's terms; then
// cum_i, dt_i, dcum, T, the column sums and a reduction's 8 values
template <int kS>
__host__ __device__ constexpr int rows_stage_bytes() {
  return (2 + 4 * (kS / kT)) * kTileBytes;
}
template <int kS>
__host__ __device__ constexpr int rows_union_bytes(int rh) {
  const int j = (2 * (kS / kT) + 8) * kTileBytes + 2 * kExBytes +
                2 * rh * kT * 4;
  const int st = 2 * rows_stage_bytes<kS>();
  return j > st ? j : st;
}
template <int kS>
__host__ __device__ constexpr int rows_smem(int rh) {
  return 2 * (kS / kT) * kTileBytes + rows_union_bytes<kS>(rh) +
         (3 * rh * kT + kMaxRowHeads + 8 * kT + 8) * 4 + 1024;
}
constexpr int kColStage = 2 * kTileBytes + (kExBytes + 1023) / 1024 * 1024;
template <int kS>
__host__ __device__ constexpr int cols_smem() {
  return 2 * (kS / kT) * kTileBytes + 2 * kColStage +
         (5 * kColHeads * kT + kColHeads) * 4 + 1024;
}

// ---------------------------------------------------------------------------
// 1. each chunk's own state S_c = (x w)^T B and its part of the state
// gradient U_c = (dy e)^T C, per head; cum, dt and T for the later kernels;
// the blocks of the first head pair write B and C as planes.
// ---------------------------------------------------------------------------

template <int kS>
__global__ void __launch_bounds__(kThreads2, 1)
ssd_bwd_state_kernel(Args a) {
  constexpr int kSW = kS / kT;
  constexpr int kPlane = 2 * kS;
  constexpr int kRawBytes = kT * kS * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = tc::smem_addr(smem);
  const uint32_t sBh = base, sBl = sBh + kSW * kTileBytes;
  const uint32_t sCh = sBl + kSW * kTileBytes, sCl = sCh + kSW * kTileBytes;
  const uint32_t sX = sCl + kSW * kTileBytes;   // [2 buffers][2 heads]
  const uint32_t sDY = sX + 4 * kTileBytes;     // [2 buffers][2 heads]
  const uint32_t sRawB = sDY + 4 * kTileBytes;  // B_j as it is, float32
  const uint32_t sRawC = sRawB + kRawBytes;     // C_j
  const float* raw_b = reinterpret_cast<const float*>(smem + (sRawB - base));
  const float* raw_c = raw_b + kT * kS;
  float* wv = reinterpret_cast<float*>(smem + (sRawC - base) + kRawBytes);
  float* ev = wv + 2 * a.Q;   // [2][Q]: exp(cum)
  float* cum = ev + 2 * a.Q;  // [2][Q]; wv: dt, then w

  const int Q = a.Q;
  const int nhp = (a.nh + 1) / 2;
  const int pr = blockIdx.x % nhp, bc = blockIdx.x / nhp;
  const int bb = bc / a.nc, c = bc % a.nc;
  const int h0 = 2 * pr, nheads = min(2, a.nh - h0);
  const size_t t0 = static_cast<size_t>(bb) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(a.nh) * a.hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3, wgi = warp >> 2, slab = warp & 3;

  const auto load_j = [&](int j0) {  // B_j, C_j as they are; x_j, dy_j
    const int nrows = min(kT, Q - j0);
    stage_raw<kS>(sRawB, a.B + (t0 + j0) * a.st, a.st, nrows, a.st,
                  a.vec_bc);
    stage_raw<kS>(sRawC, a.C + (t0 + j0) * a.st, a.st, nrows, a.st,
                  a.vec_bc);
    const uint32_t buf = ((j0 / kT) & 1) * 2 * kTileBytes;
    for (int hh = 0; hh < nheads; ++hh) {
      const size_t off = (t0 + j0) * x_ld + static_cast<size_t>(h0 + hh) * a.hp;
      stage_x(sX + buf + hh * kTileBytes, a.x + off, x_ld, nrows, a.hp,
              a.vec_x);
      stage_x(sDY + buf + hh * kTileBytes, a.dy + off, x_ld, nrows, a.hp,
              a.vec_x);
    }
  };
  load_j(0);
  tc::cp_async_commit();
  for (int idx = threadIdx.x; idx < 2 * Q; idx += kThreads2) {
    const int hh = idx / Q, j = idx % Q;
    wv[idx] = hh < nheads ? a.dt[(t0 + j) * a.nh + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (warp < nheads && lane == 0)
    seq_cumsum(cum + warp * Q, wv + warp * Q, a.A[h0 + warp], Q);
  __syncthreads();
  // cum and dt by head for the later kernels, then w_j = exp(T - cum_j)
  // dt_j over dt and e_j = exp(cum_j)
  const size_t k0 = (static_cast<size_t>(bc) * a.nh + h0) * Q;
  for (int idx = threadIdx.x; idx < nheads * Q; idx += kThreads2) {
    const int hh = idx / Q;
    const float cv = cum[idx];
    a.cum_t[k0 + idx] = cv;
    a.dt_t[k0 + idx] = wv[idx];
    wv[idx] = expf(cum[hh * Q + Q - 1] - cv) * wv[idx];
    ev[idx] = expf(cv);
  }
  if (threadIdx.x < nheads)
    a.total[static_cast<size_t>(bc) * a.nh + h0 + threadIdx.x] =
        cum[threadIdx.x * Q + Q - 1];
  __syncthreads();

  // warpgroup wgi takes head h0 + wgi: rows p = 16 slab + g (+8), columns s
  float sacc[kS / 8][4], uacc[kS / 8][4];
  zero(sacc);
  zero(uacc);
  const float* wh = wv + wgi * Q;
  const float* eh = ev + wgi * Q;
  for (int j0 = 0; j0 < Q; j0 += kT) {
    const int nrows = min(kT, Q - j0);
    tc::cp_async_wait<0>();
    __syncthreads();  // B_j, C_j, x_j and dy_j have landed
    bf* bpl = pr == 0 ? a.b_pl + (t0 + j0) * kPlane : nullptr;
    bf* cpl = pr == 0 ? a.c_pl + (t0 + j0) * kPlane : nullptr;
    split_raw<kS>(sBh, sBl, bpl, raw_b, nrows);
    split_raw<kS>(sCh, sCl, cpl, raw_c, nrows);
    wg::fence_proxy();
    __syncthreads();  // split; the float32 tiles are free
    if (j0 + kT < Q) load_j(j0 + kT);  // the next tiles, while these run
    tc::cp_async_commit();
    if (wgi < nheads) {  // the same for the whole warpgroup
      const uint32_t buf = ((j0 / kT) & 1) * 2 * kTileBytes + wgi * kTileBytes;
      // A = (x w)^T and (dy e)^T (rows p, k = the step j) built in
      // registers from x's and dy's transposed fragments, split into bf16
      // hi/lo; B = B_j, C_j (k = j, n = s) MN-major: hi*hi, hi*lo, lo*hi.
      // Two k-steps in flight.
      uint32_t fa[2][2][2][4];  // [step % 2][x w, dy e][hi, lo]
      wg::touch(sacc);
      wg::touch(uacc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 16 >= nrows) continue;  // the same for the whole block
        uint32_t(&f)[2][2][4] = fa[ks & 1];
        if (ks >= 2) {
          wg::wait<1>();  // step ks - 2 has read f
          wg::touch_a(f[0]);
          wg::touch_a(f[1]);
        }
        const uint32_t offA = swz(ks * 16 + (lane & 7) + (lane >> 4) * 8,
                                  slab * 16 + ((lane >> 3) & 1) * 8);
        uint32_t xr[4], dr[4];
        tc::ldsm_x4_t(xr, sX + buf + offA);
        tc::ldsm_x4_t(dr, sDY + buf + offA);
        float wj[4], ej[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jj = min(j0 + ks * 16 + (u >> 1) * 8 + 2 * t4 + (u & 1),
                             Q - 1);
          wj[u] = wh[jj];
          ej[u] = eh[jj];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u = (q >> 1) * 2;
          const __nv_bfloat162 x2 =
              *reinterpret_cast<const __nv_bfloat162*>(&xr[q]);
          const __nv_bfloat162 d2 =
              *reinterpret_cast<const __nv_bfloat162*>(&dr[q]);
          tc::split(__low2float(x2) * wj[u], __high2float(x2) * wj[u + 1],
                    f[0][0][q], f[0][1][q]);
          tc::split(__low2float(d2) * ej[u], __high2float(d2) * ej[u + 1],
                    f[1][0][q], f[1][1][q]);
        }
        wg::fence();
        const uint64_t dbh = wg::desc(sBh + ks * 16 * 128, kTileBytes, 1024);
        const uint64_t dbl = wg::desc(sBl + ks * 16 * 128, kTileBytes, 1024);
        const uint64_t dch = wg::desc(sCh + ks * 16 * 128, kTileBytes, 1024);
        const uint64_t dcl = wg::desc(sCl + ks * 16 * 128, kTileBytes, 1024);
        mma_rs_state(sacc, f[0][0], dbh);
        mma_rs_state(sacc, f[0][0], dbl);
        mma_rs_state(sacc, f[0][1], dbh);
        mma_rs_state(uacc, f[1][0], dch);
        mma_rs_state(uacc, f[1][0], dcl);
        mma_rs_state(uacc, f[1][1], dch);
        wg::commit();
      }
      wg::wait<0>();
      wg::touch(sacc);
      wg::touch(uacc);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        wg::touch_a(fa[s2][0]);
        wg::touch_a(fa[s2][1]);
      }
    }
    __syncthreads();  // the tiles are consumed before the next are split
  }

  if (wgi >= nheads) return;
  const size_t off = (static_cast<size_t>(bc) * a.nh + h0 + wgi) * a.hp * a.st;
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < kS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = slab * 16 + g + 8 * r, s = n * 8 + 2 * t4;
      if (p >= a.hp) continue;
      float* so = a.s_c + off + p * a.st + s;
      float* uo = a.u_c + off + p * a.st + s;
      if (a.st % 2 == 0) {
        if (s < a.st) {
          *reinterpret_cast<float2*>(so) =
              make_float2(sacc[n][2 * r], sacc[n][2 * r + 1]);
          *reinterpret_cast<float2*>(uo) =
              make_float2(uacc[n][2 * r], uacc[n][2 * r + 1]);
        }
      } else {
        if (s < a.st) so[0] = sacc[n][2 * r], uo[0] = uacc[n][2 * r];
        if (s + 1 < a.st) so[1] = sacc[n][2 * r + 1], uo[1] = uacc[n][2 * r + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// 2. the passes over chunks, in float32: the state forwards from 0, H <- H
// exp(T) + S_c, and its gradient backwards from dstate (or 0), G <- G exp(T)
// + U_c; every chunk's H (the state before it) and G (the gradient after
// it) are left as planes.  Each batch of chunks is read before any is
// written.
// ---------------------------------------------------------------------------

template <int kS>
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(Args a) {
  constexpr int kBatch = 8;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;  // (p, s) of 64 x kS
  const int p = e / kS, s = e % kS;
  const bool in = p < a.hp && s < a.st;
  const int bb = blockIdx.x / a.nh, hh = blockIdx.x % a.nh;
  const size_t k0 = static_cast<size_t>(bb) * a.nc * a.nh + hh;
  const size_t n = static_cast<size_t>(a.hp) * a.st;
  const size_t pe = static_cast<size_t>(p) * 2 * kS + s;
  const auto put = [&](bf* planes, int c, float v) {
    bf* row = planes + (k0 + static_cast<size_t>(c) * a.nh) * kT * 2 * kS + pe;
    const bf hi = __float2bfloat16_rn(v);
    row[0] = hi;
    row[kS] = __float2bfloat16_rn(v - __bfloat162float(hi));
  };
  float h = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float v[kBatch], d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = c0 + i < a.nc;
      const size_t k = k0 + static_cast<size_t>(ok ? c0 + i : 0) * a.nh;
      v[i] = ok && in ? a.s_c[k * n + p * a.st + s] : 0.f;
      d[i] = ok ? a.total[k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i >= a.nc) break;
      put(a.h_pl, c0 + i, h);
      h = __fadd_rn(__fmul_rn(h, expf(d[i])), v[i]);
    }
  }
  float gv = in && a.dstate ? a.dstate[static_cast<size_t>(blockIdx.x) * n +
                                       p * a.st + s]
                            : 0.f;
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= kBatch) {
    float v[kBatch], d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = c1 - i >= 0;
      const size_t k = k0 + static_cast<size_t>(ok ? c1 - i : 0) * a.nh;
      v[i] = ok && in ? a.u_c[k * n + p * a.st + s] : 0.f;
      d[i] = ok ? a.total[k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c1 - i < 0) break;
      put(a.g_pl, c1 - i, gv);
      gv = __fadd_rn(__fmul_rn(gv, expf(d[i])), v[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the rows kernel: one block a (batch, chunk, row tile i, row group of
// rh heads), the last row tiles (the most column tiles) first.  For each
// column tile j <= i: s = C_i B_j^T (each warpgroup 32 of its columns, put
// together in shared memory and written for the columns kernel); for each
// head (a warpgroup each of a pair) dyx = dy_i x_j^T, Pm = L o dt_j o dyx
// (L's exponentials only where j <= i), the rows' and columns' sums of
// s o Pm into dcum, and Pm summed over the warpgroup's heads; then the
// heads' summed Pm: warpgroup 0 adds warpgroup 1's part and takes dC_i +=
// Pm B_j, warpgroup 1 its transpose, dB_j's part Pm^T C_i, written by tile
// pair.  Then for each head the carried state's terms: warpgroup 0 v =
// dy_i H (dC_i += e_i v, dcum_i += e_i C_i . v), warpgroup 1 x_i G (dB_i +=
// W_i x_i G, into its diagonal pair's partial); the blocks of the first row
// tile also sum <G, H>.  dC_i leaves as the row group's partial, dcum by
// (head, row tile).
// ---------------------------------------------------------------------------

template <int kS>
__global__ void __launch_bounds__(kThreads2, 1)
ssd_bwd_rows_kernel(Args a) {
  constexpr int kSW = kS / kT;
  constexpr int kPlane = 2 * kS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = tc::smem_addr(smem);
  const uint32_t sCh = base, sCl = sCh + kSW * kTileBytes;
  const uint32_t sU = sCl + kSW * kTileBytes;
  // the column tiles' loop
  const uint32_t sBh = sU, sBl = sBh + kSW * kTileBytes;
  const uint32_t sRing = sBl + kSW * kTileBytes;  // 2 x [dy, dy, x, x]
  float* sS = reinterpret_cast<float*>(smem + (sRing - base) +
                                       8 * kTileBytes);  // s [i][j]
  float* sP = sS + kT * kSP;                            // Pm [i][j]
  float* cum_j = sP + kT * kSP;                         // [rh][64]
  float* dt_j = cum_j + a.rh * kT;                      // [rh][64]
  // (the carried state's terms: two stages of rows_stage_bytes at sU)
  float* cum_i = reinterpret_cast<float*>(smem + (sU - base) +
                                          rows_union_bytes<kS>(a.rh));
  float* dt_i = cum_i + a.rh * kT;
  float* dcr = dt_i + a.rh * kT;       // [rh][64]: dcum of the row tile
  float* Tk = dcr + a.rh * kT;         // [kMaxRowHeads]
  float* colp = Tk + kMaxRowHeads;     // [2][4][64]: column sums by warp
  float* red = colp + 8 * kT;          // [8]

  const int Q = a.Q, nt = a.nt;
  const int per_t = a.b * a.nc * a.ngr;
  const int t = nt - 1 - static_cast<int>(blockIdx.x / per_t);
  const int rest = static_cast<int>(blockIdx.x % per_t);
  const int grp = rest % a.ngr, bc = rest / a.ngr;
  const int bb = bc / a.nc, c = bc % a.nc;
  const int hr0 = grp * a.rh, nrh = min(a.rh, a.nh - hr0);
  const int i0 = t * kT, len_i = min(kT, Q - i0);
  const size_t t0 = static_cast<size_t>(bb) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(a.nh) * a.hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wgi = warp >> 2, slab = warp & 3;
  const int rl = slab * 16 + g;  // the thread's rows of a tile: rl, rl + 8
  const size_t kh = static_cast<size_t>(bc) * a.nh + hr0;  // (bc, first head)
  const int npr = (nrh + 1) / 2;
  const int nsteps = (t + 1) * npr;

  const auto load_b = [&](int jt) {
    stage_plane<kS>(sBh, sBl, a.b_pl + (t0 + jt * kT) * kPlane,
                    min(kT, Q - jt * kT));
  };
  const auto load_cum = [&](float* cdst, float* ddst, int p0) {
    for (int idx = threadIdx.x; idx < nrh * kT; idx += kThreads2) {
      const int k = idx / kT, j = p0 + idx % kT;
      const size_t src = (kh + k) * Q + min(j, Q - 1);
      cdst[idx] = a.cum_t[src];
      ddst[idx] = j < Q ? a.dt_t[src] : 0.f;
    }
  };
  // step = (column tile, head pair): dy_i and x_j of the pair's two heads
  const auto load_step = [&](int step) {
    const int j0 = (step / npr) * kT, k = 2 * (step % npr);
    const uint32_t st = sRing + (step & 1) * 4 * kTileBytes;
    for (int hh = 0; hh < 2; ++hh) {
      if (k + hh >= nrh) continue;
      const size_t hoff = static_cast<size_t>(hr0 + k + hh) * a.hp;
      stage_x(st + hh * kTileBytes, a.dy + (t0 + i0) * x_ld + hoff, x_ld,
              len_i, a.hp, a.vec_x);
      stage_x(st + (2 + hh) * kTileBytes, a.x + (t0 + j0) * x_ld + hoff,
              x_ld, min(kT, Q - j0), a.hp, a.vec_x);
    }
  };

  stage_plane<kS>(sCh, sCl, a.c_pl + (t0 + i0) * kPlane, len_i);
  load_b(0);
  load_step(0);
  tc::cp_async_commit();
  load_cum(cum_i, dt_i, i0);
  for (int idx = threadIdx.x; idx < nrh * kT; idx += kThreads2) dcr[idx] = 0.f;
  if (threadIdx.x < nrh) Tk[threadIdx.x] = a.total[kh + threadIdx.x];

  // warpgroup 0: dC_i; warpgroup 1: dB_i's part through G (state phase)
  float acc[kS / 8][4];
  zero(acc);
  int step = 0;
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * kT;
    const bool diag = jt == t;
    load_cum(cum_j, dt_j, j0);
    tc::cp_async_wait<0>();
    wg::fence_proxy();
    __syncthreads();  // C_i, B_j, the first pair's tiles and cum_j are in

    // s = C_i B_j^T: this warpgroup's 32 columns, C and B as hi/lo
    {
      float cb[4][4];
      zero(cb);
      wg::touch(cb);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kS / 16; ++ks) {
        if (ks * 16 >= a.st) continue;
        const uint32_t kc = (ks >> 2) * kTileBytes + (ks & 3) * 32;
        const uint32_t kb = kc + wgi * 32 * 128;
        const uint64_t ch = wg::desc(sCh + kc, 16, 1024);
        const uint64_t cl = wg::desc(sCl + kc, 16, 1024);
        wg::mma_ss_n32(cb, ch, wg::desc(sBh + kb, 16, 1024), 1);
        wg::mma_ss_n32(cb, ch, wg::desc(sBl + kb, 16, 1024), 1);
        wg::mma_ss_n32(cb, cl, wg::desc(sBh + kb, 16, 1024), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(cb);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sS + (rl + 8 * r) * kSP + wgi * 32 +
                                     n * 8 + 2 * t4) =
              make_float2(cb[n][2 * r], cb[n][2 * r + 1]);
    }
    __syncthreads();
    if (grp == 0) {  // s for the columns kernel
      float* dst = a.s_t + (static_cast<size_t>(bc) * a.npair +
                            t * (t + 1) / 2 + jt) * kT * kT;
      for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kThreads2) {
        const int r = idx >> 4, q = idx & 15;
        *reinterpret_cast<float4*>(dst + r * kT + 4 * q) =
            *reinterpret_cast<const float4*>(sS + r * kSP + 4 * q);
      }
    }
    float sv[8][4], pms[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            sS + (rl + 8 * r) * kSP + n * 8 + 2 * t4);
        sv[n][2 * r] = v.x;
        sv[n][2 * r + 1] = v.y;
      }
    zero(pms);

    for (int pr = 0; pr < npr; ++pr, ++step) {
      if (step + 1 < nsteps) load_step(step + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      wg::fence_proxy();
      __syncthreads();  // this pair's tiles are in; the last pair's read
      const int k = 2 * pr + wgi;
      if (k >= nrh) continue;  // the same for the whole warpgroup
      const uint32_t st = sRing + (step & 1) * 4 * kTileBytes;
      float dyx[8][4];
      zero(dyx);
      wg::touch(dyx);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks * 16 >= a.hp) continue;
        wg::mma_ss_n64(dyx, wg::desc(st + wgi * kTileBytes + ks * 32, 16, 1024),
                       wg::desc(st + (2 + wgi) * kTileBytes + ks * 32, 16,
                                1024),
                       1);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(dyx);
      const float* cjk = cum_j + k * kT;
      const float* djk = dt_j + k * kT;
      const float ci[2] = {cum_i[k * kT + rl], cum_i[k * kT + rl + 8]};
      float rs[2] = {0.f, 0.f}, cs[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = n * 8 + 2 * t4 + (e & 1);
          float pm = 0.f;
          if (!diag || col <= rl + 8 * r)  // never exp above the diagonal
            pm = __expf(ci[r] - cjk[col]) * djk[col] * dyx[n][e];
          const float sp = sv[n][e] * pm;
          rs[r] += sp;
          cs[n][e & 1] += sp;
          pms[n][e] += pm;
        }
      }
      // dcum: + the rows' sums, - the columns' sums of s o Pm
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      }
      if (t4 == 0) {
        dcr[k * kT + rl] += rs[0];
        dcr[k * kT + rl + 8] += rs[1];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float v = cs[n][e2];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colp[(wgi * 4 + slab) * kT + n * 8 + 2 * t4 + e2] = v;
        }
      wg_sync(wgi);
      const int tw = threadIdx.x & 127;
      if (tw < kT) {
        const float* cp = colp + wgi * 4 * kT + tw;
        const float sum = cp[0] + cp[kT] + cp[2 * kT] + cp[3 * kT];
        if (diag)
          dcr[k * kT + tw] -= sum;
        else if (j0 + tw < Q)
          a.dcs[((kh + k) * nt + t) * Q + j0 + tw] = -sum;
      }
    }

    // the heads' summed Pm: warpgroup 1's part through shared memory
    if (wgi == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sP + (rl + 8 * r) * kSP + n * 8 +
                                     2 * t4) =
              make_float2(pms[n][2 * r], pms[n][2 * r + 1]);
    }
    __syncthreads();
    if (wgi == 0) {
      // the sum, kept in shared memory for warpgroup 1; dC_i += Pm B_j with
      // Pm from registers as bf16 hi/lo and B_j MN-major: hi*hi, hi*lo,
      // lo*hi
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* p = reinterpret_cast<float2*>(sP + (rl + 8 * r) * kSP +
                                                n * 8 + 2 * t4);
          const float2 o = *p;
          pms[n][2 * r] += o.x;
          pms[n][2 * r + 1] += o.y;
          *p = make_float2(pms[n][2 * r], pms[n][2 * r + 1]);
        }
      uint32_t f[4][2][4];
      split_frags(pms, f);
      wg::touch(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (j0 + kk * 16 >= Q) continue;
        const uint64_t bh = wg::desc(sBh + kk * 16 * 128, kTileBytes, 1024);
        const uint64_t bl = wg::desc(sBl + kk * 16 * 128, kTileBytes, 1024);
        mma_rs_state(acc, f[kk][0], bh);
        mma_rs_state(acc, f[kk][0], bl);
        mma_rs_state(acc, f[kk][1], bh);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::touch_a(f[kk]);
    }
    __syncthreads();
    if (wgi == 1) {
      // dB_j's part Pm^T C_i: Pm^T (rows j, k = i) read transposed from
      // shared memory as bf16 hi/lo, C_i MN-major
      uint32_t f[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = rl + 8 * (q & 1);
          const int ii = kk * 16 + 8 * (q >> 1) + 2 * t4;
          tc::split(sP[ii * kSP + row], sP[(ii + 1) * kSP + row],
                    f[kk][0][q], f[kk][1][q]);
        }
      float db[kS / 8][4];
      zero(db);
      wg::touch(db);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 >= len_i) continue;
        const uint64_t ch = wg::desc(sCh + kk * 16 * 128, kTileBytes, 1024);
        const uint64_t cl = wg::desc(sCl + kk * 16 * 128, kTileBytes, 1024);
        mma_rs_state(db, f[kk][0], ch);
        mma_rs_state(db, f[kk][0], cl);
        mma_rs_state(db, f[kk][1], ch);
      }
      wg::commit();
      wg::wait<0>();
      wg::touch(db);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::touch_a(f[kk]);
      float* out = a.dbp + ((static_cast<size_t>(grp) * a.b * a.nc + bc) *
                                a.npair + t * (t + 1) / 2 + jt) * kT * a.st;
#pragma unroll
      for (int n = 0; n < kS / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rl + 8 * r, s = n * 8 + 2 * t4;
          if (j0 + row >= Q) continue;
          float* o = out + row * a.st + s;
          if (s < a.st) o[0] = db[n][2 * r];
          if (s + 1 < a.st) o[1] = db[n][2 * r + 1];
        }
    }
    __syncthreads();  // B_j, s, Pm and the ring consumed
    if (jt < t) load_b(jt + 1);
    tc::cp_async_commit();
  }

  // the carried state's terms, head by head: dy_i, x_i, H and G (hi/lo)
  // through a ring of two stages, the next head's while one's multiply
  constexpr int kStage = rows_stage_bytes<kS>();
  const auto load_state = [&](int k) {
    const uint32_t st = sU + (k & 1) * kStage;
    const size_t hoff = static_cast<size_t>(hr0 + k) * a.hp;
    stage_x(st, a.dy + (t0 + i0) * x_ld + hoff, x_ld, len_i, a.hp, a.vec_x);
    stage_x(st + kTileBytes, a.x + (t0 + i0) * x_ld + hoff, x_ld, len_i,
            a.hp, a.vec_x);
    const uint32_t sH = st + 2 * kTileBytes, sG = sH + 2 * kSW * kTileBytes;
    stage_plane<kS>(sH, sH + kSW * kTileBytes,
                    a.h_pl + (kh + k) * kT * kPlane, a.hp);
    stage_plane<kS>(sG, sG + kSW * kTileBytes,
                    a.g_pl + (kh + k) * kT * kPlane, a.hp);
  };
  load_state(0);
  tc::cp_async_commit();
  for (int k = 0; k < nrh; ++k) {
    if (k + 1 < nrh) load_state(k + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    wg::fence_proxy();
    __syncthreads();  // head k's tiles are in
    const uint32_t sDY1 = sU + (k & 1) * kStage, sX1 = sDY1 + kTileBytes;
    const uint32_t sHh = sX1 + kTileBytes, sHl = sHh + kSW * kTileBytes;
    const uint32_t sGh = sHl + kSW * kTileBytes, sGl = sGh + kSW * kTileBytes;
    if (t == 0) {  // <G, H> of the head, from the hi/lo tiles
      float part = 0.f;
      for (int idx = threadIdx.x; idx < kSW * kTileBytes / 4; idx += kThreads2) {
        const uint32_t o = idx * 4;
        const float2 hh = lds_bf2(sHh + o), hl = lds_bf2(sHl + o);
        const float2 gg = lds_bf2(sGh + o), gl = lds_bf2(sGl + o);
        part += (gg.x + gl.x) * (hh.x + hl.x) + (gg.y + gl.y) * (hh.y + hl.y);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) red[warp] = part;
    }
    float v[kS / 8][4];
    zero(v);
    wg::touch(v);
    wg::fence();
    // warpgroup 0: v = dy_i H; warpgroup 1: x_i G (K-major dy / x, H and G
    // MN-major as hi/lo)
    const uint32_t sA = wgi == 0 ? sDY1 : sX1;
    const uint32_t sMh = wgi == 0 ? sHh : sGh;
    const uint32_t sMl = wgi == 0 ? sHl : sGl;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks * 16 >= a.hp) continue;
      const uint64_t da = wg::desc(sA + ks * 32, 16, 1024);
      mma_ss_t_state(v, da, wg::desc(sMh + ks * 16 * 128, kTileBytes, 1024));
      mma_ss_t_state(v, da, wg::desc(sMl + ks * 16 * 128, kTileBytes, 1024));
    }
    wg::commit();
    wg::wait<0>();
    wg::touch(v);
    const float ci[2] = {cum_i[k * kT + rl], cum_i[k * kT + rl + 8]};
    if (wgi == 0) {
      // dC_i += e_i v, dcum_i += e_i C_i . v
      const float e[2] = {expf(ci[0]), expf(ci[1])};
      float d[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kS / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz_tile<kT>(rl + 8 * r, n * 8 + 2 * t4);
          const float2 ch = lds_bf2(sCh + off), cl = lds_bf2(sCl + off);
          d[r] += (ch.x + cl.x) * v[n][2 * r] + (ch.y + cl.y) * v[n][2 * r + 1];
          acc[n][2 * r] += e[r] * v[n][2 * r];
          acc[n][2 * r + 1] += e[r] * v[n][2 * r + 1];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      }
      if (t4 == 0) {
        dcr[k * kT + rl] += e[0] * d[0];
        dcr[k * kT + rl + 8] += e[1] * d[1];
      }
    } else {
      // dB_i += W_i x_i G, W_i = exp(T - cum_i) dt_i
      const float W[2] = {expf(Tk[k] - ci[0]) * dt_i[k * kT + rl],
                          expf(Tk[k] - ci[1]) * dt_i[k * kT + rl + 8]};
#pragma unroll
      for (int n = 0; n < kS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += W[e >> 1] * v[n][e];
    }
    __syncthreads();  // the tiles are consumed; red is written
    if (t == 0 && threadIdx.x == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w];
      a.gh[kh + k] = sum;
    }
  }

  // dC_i as the row group's partial (warpgroup 0); dB_i's part through G
  // added to the diagonal pair's partial this thread wrote (warpgroup 1)
  float* dbd = a.dbp + ((static_cast<size_t>(grp) * a.b * a.nc + bc) *
                            a.npair + t * (t + 1) / 2 + t) * kT * a.st;
  float* dcd = a.dcp + grp * a.dcp_stride + (t0 + i0) * a.st;
#pragma unroll
  for (int n = 0; n < kS / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r, s = n * 8 + 2 * t4;
      if (row >= len_i) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e >= a.st) continue;
        if (wgi == 0) dcd[row * a.st + s + e] = acc[n][2 * r + e];
        else dbd[row * a.st + s + e] += acc[n][2 * r + e];
      }
    }
  for (int idx = threadIdx.x; idx < nrh * len_i; idx += kThreads2) {
    const int k = idx / len_i, i = idx % len_i;
    a.dcs[((kh + k) * nt + t) * Q + i0 + i] = dcr[k * kT + i];
  }
}

// ---------------------------------------------------------------------------
// 4. the columns kernel: one block a (batch, chunk, column tile j, pair of
// heads), a chunk's column tiles side by side, the first (the most row
// tiles) first, a warpgroup a head, two blocks an SM.  For each row tile i >= j: r_j += (s o L)^T dy_i,
// (s o L)^T built in registers from s (the rows kernel's) as bf16 hi/lo,
// L's exponentials only where j <= i, dy_i MN-major.  Then gb = B_j G^T (B
// and G hi/lo): r_j += exp(T - cum_j) gb, dx_j = dt_j r_j, ddt_j's part
// x_j . r_j, dcum's part -W_j x_j . gb and dT's.
// ---------------------------------------------------------------------------

template <int kS>
__global__ void __launch_bounds__(kThreads2, 2)
ssd_bwd_cols_kernel(Args a) {
  constexpr int kSW = kS / kT;
  constexpr int kPlane = 2 * kS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = tc::smem_addr(smem);
  const uint32_t sBh = base, sBl = sBh + kSW * kTileBytes;
  const uint32_t sRing = sBl + kSW * kTileBytes;  // 2 x [2 dy_i, s]
  float* cum_j = reinterpret_cast<float*>(smem + (sRing - base) +
                                          2 * kColStage);
  float* dt_j = cum_j + kColHeads * kT;
  float* cum_is = dt_j + kColHeads * kT;    // [2][2][64]
  float* wx = cum_is + 2 * kColHeads * kT;  // [2][64]: W_j x_j . gb
  float* Tk = wx + kColHeads * kT;          // [2]

  // the column tiles of one (batch, chunk, head pair) are neighbours in
  // the grid, heaviest first, so that they share G, dy and s through L2
  const int Q = a.Q, nt = a.nt;
  const int u = static_cast<int>(blockIdx.x % nt);
  const int rest = static_cast<int>(blockIdx.x / nt);
  const int grp = rest % a.ncg, bc = rest / a.ncg;
  const int bb = bc / a.nc, c = bc % a.nc;
  const int hc0 = grp * kColHeads, nch = min(kColHeads, a.nh - hc0);
  const int j0 = u * kT, len_j = min(kT, Q - j0);
  const size_t t0 = static_cast<size_t>(bb) * a.S + static_cast<size_t>(c) * Q;
  const size_t x_ld = static_cast<size_t>(a.nh) * a.hp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, wgi = warp >> 2, slab = warp & 3;
  const int rl = slab * 16 + g;
  const size_t kh = static_cast<size_t>(bc) * a.nh + hc0;
  const int n_it = nt - u;

  const auto load_it = [&](int it) {  // dy_i of the heads, s, cum_i
    const int i0 = j0 + it * kT, len_i = min(kT, Q - i0);
    const uint32_t st = sRing + (it & 1) * kColStage;
    for (int hh = 0; hh < nch; ++hh)
      stage_x(st + hh * kTileBytes,
              a.dy + (t0 + i0) * x_ld + static_cast<size_t>(hc0 + hh) * a.hp,
              x_ld, len_i, a.hp, a.vec_x);
    const int ti = i0 / kT;
    const float* src = a.s_t + (static_cast<size_t>(bc) * a.npair +
                                ti * (ti + 1) / 2 + u) * kT * kT;
    const uint32_t ds = st + 2 * kTileBytes;
    for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kThreads2) {
      const int r = idx >> 4, q = idx & 15;
      tc::cp_async16(ds + (r * kSP + 4 * q) * 4, src + r * kT + 4 * q, 16);
    }
    const uint32_t ci = tc::smem_addr(cum_is + (it & 1) * kColHeads * kT);
    for (int idx = threadIdx.x; idx < nch * kT; idx += kThreads2) {
      const int k = idx / kT, i = i0 + idx % kT;
      tc::cp_async4(ci + idx * 4, a.cum_t + (kh + k) * Q + min(i, Q - 1), 4);
    }
  };

  stage_plane<kS>(sBh, sBl, a.b_pl + (t0 + j0) * kPlane, len_j);
  load_it(0);
  tc::cp_async_commit();
  for (int idx = threadIdx.x; idx < nch * kT; idx += kThreads2) {
    const int k = idx / kT, j = j0 + idx % kT;
    const size_t src = (kh + k) * Q + min(j, Q - 1);
    cum_j[idx] = a.cum_t[src];
    dt_j[idx] = j < Q ? a.dt_t[src] : 0.f;
  }
  if (threadIdx.x < nch) Tk[threadIdx.x] = a.total[kh + threadIdx.x];

  const int k = wgi;  // this warpgroup's head; none when k >= nch
  float r[8][4];      // r_j: rows j, columns p
  zero(r);
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_it(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    wg::fence_proxy();
    __syncthreads();  // tile `it` is in
    const int i0 = j0 + it * kT, len_i = min(kT, Q - i0);
    const bool diag = it == 0;
    const uint32_t st = sRing + (it & 1) * kColStage;
    const float* sS = reinterpret_cast<const float*>(smem + (st - base) +
                                                     2 * kTileBytes);
    if (k < nch) {  // the same for the whole warpgroup
      const float cj[2] = {cum_j[k * kT + rl], cum_j[k * kT + rl + 8]};
      const float* cik = cum_is + (it & 1) * kColHeads * kT + k * kT;
      // (s o L)^T (rows j, k = i) as bf16 hi/lo, dy_i (k = i, n = p)
      // MN-major; two k-steps in flight
      uint32_t ma[2][2][4];
      wg::touch(r);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 >= len_i) continue;  // the same for the whole block
        uint32_t(&mk)[2][4] = ma[kk & 1];
        if (kk >= 2) {
          wg::wait<1>();
          wg::touch_a(mk);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = rl + 8 * (q & 1);
          const int il = kk * 16 + 8 * (q >> 1) + 2 * t4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = 0.f;
            if (!diag || il + e >= row)  // never exp above the diagonal
              v[e] = sS[(il + e) * kSP + row] *
                     __expf(cik[il + e] - cj[q & 1]);
          }
          tc::split(v[0], v[1], mk[0][q], mk[1][q]);
        }
        wg::fence();
        const uint64_t bd =
            wg::desc(st + k * kTileBytes + kk * 16 * 128, kTileBytes, 1024);
        wg::mma_rs_n64(r, mk[0], bd);
        wg::mma_rs_n64(r, mk[1], bd);
        wg::commit();
      }
      wg::wait<0>();
      wg::touch(r);
      wg::touch_a(ma[0]);
      wg::touch_a(ma[1]);
    }
    __syncthreads();  // tile `it` consumed before its stage is reloaded
  }

  // the terms through G, both heads' G at once (a warpgroup each); x_j at
  // the thread's (row, p, p + 1) of r is loaded meanwhile, as bf16 pairs
  for (int w = 0; w < nch; ++w)
    stage_plane<kS>(sRing + 2 * w * kSW * kTileBytes,
                    sRing + (2 * w + 1) * kSW * kTileBytes,
                    a.g_pl + (kh + w) * kT * kPlane, a.hp);
  tc::cp_async_commit();
  const size_t xoff = (t0 + j0) * x_ld + static_cast<size_t>(hc0 + k) * a.hp;
  uint32_t xw[2][8];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rl + 8 * rr;
    const bf* xrow = a.x + xoff + static_cast<size_t>(row) * x_ld;
    const bool in = k < nch && row < len_j;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = n * 8 + 2 * t4;
      const bf z = __float2bfloat16_rn(0.f);
      if (a.hp % 2 == 0)
        xw[rr][n] = in && p < a.hp
                        ? *reinterpret_cast<const uint32_t*>(xrow + p)
                        : 0u;
      else
        xw[rr][n] = tc::pack(in && p < a.hp ? xrow[p] : z,
                             in && p + 1 < a.hp ? xrow[p + 1] : z);
    }
  }
  tc::cp_async_wait<0>();
  wg::fence_proxy();
  __syncthreads();
  if (k < nch) {
    const uint32_t sGh = sRing + 2 * k * kSW * kTileBytes;
    const uint32_t sGl = sGh + kSW * kTileBytes;
    // gb = B_j G^T (rows j, columns p): B and G K-major, hi*hi, hi*lo,
    // lo*hi
    float gb[8][4];
    zero(gb);
    wg::touch(gb);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks) {
      if (ks * 16 >= a.st) continue;
      const uint32_t kb = (ks >> 2) * kTileBytes + (ks & 3) * 32;
      const uint64_t bh = wg::desc(sBh + kb, 16, 1024);
      wg::mma_ss_n64(gb, bh, wg::desc(sGh + kb, 16, 1024), 1);
      wg::mma_ss_n64(gb, bh, wg::desc(sGl + kb, 16, 1024), 1);
      wg::mma_ss_n64(gb, wg::desc(sBl + kb, 16, 1024),
                     wg::desc(sGh + kb, 16, 1024), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::touch(gb);
    float ej[2], dtj[2], xgb[2] = {0.f, 0.f}, xr[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      ej[rr] = expf(Tk[k] - cum_j[k * kT + rl + 8 * rr]);
      dtj[rr] = dt_j[k * kT + rl + 8 * rr];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xw[rr][n]));
        float& r0 = r[n][2 * rr];
        float& r1 = r[n][2 * rr + 1];
        r0 += ej[rr] * gb[n][2 * rr];
        r1 += ej[rr] * gb[n][2 * rr + 1];
        xgb[rr] += xv.x * gb[n][2 * rr] + xv.y * gb[n][2 * rr + 1];
        xr[rr] += xv.x * r0 + xv.y * r1;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      xgb[rr] += __shfl_xor_sync(0xffffffffu, xgb[rr], 1);
      xgb[rr] += __shfl_xor_sync(0xffffffffu, xgb[rr], 2);
      xr[rr] += __shfl_xor_sync(0xffffffffu, xr[rr], 1);
      xr[rr] += __shfl_xor_sync(0xffffffffu, xr[rr], 2);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rl + 8 * rr, j = j0 + row;
      const float W = ej[rr] * dtj[rr];
      if (t4 == 0) {
        wx[k * kT + row] = j < Q ? W * xgb[rr] : 0.f;
        if (j < Q) {
          a.gcum[(kh + k) * Q + j] = -W * xgb[rr];
          a.ddt[(t0 + j) * a.nh + hc0 + k] = xr[rr];
        }
      }
      if (j >= Q) continue;
      bf* dr = a.dx + xoff + static_cast<size_t>(row) * x_ld;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = n * 8 + 2 * t4;
        const float v0 = dtj[rr] * r[n][2 * rr];
        const float v1 = dtj[rr] * r[n][2 * rr + 1];
        if (a.hp % 2 == 0) {
          if (p < a.hp)
            *reinterpret_cast<__nv_bfloat162*>(dr + p) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < a.hp) dr[p] = __float2bfloat16_rn(v0);
          if (p + 1 < a.hp) dr[p + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
  __syncthreads();  // wx written
  if (threadIdx.x < nch) {  // dT's part of the column tile, in row order
    float sum = 0.f;
    for (int row = 0; row < len_j; ++row) sum += wx[threadIdx.x * kT + row];
    a.dtp[(kh + threadIdx.x) * nt + u] = sum;
  }
}

// ---------------------------------------------------------------------------
// 5. finish: per (batch, chunk) and 8 heads (a warp a head), dcum from its
// parts (the rows kernel's by row tile, the G part, dT and exp(T) <G, H> at
// the chunk's last step) and its reversed sum over the chunk, 32 steps at a
// time from the chunk's end (a lane a step, a shuffle scan, the later
// steps' sum carried), ddt += A sum and dA's partial; the last such block
// to finish (an integer ticket) sums dA in (batch, chunk) order.  The other
// blocks, an element a thread, sum the row groups' dC partials and the row
// groups' and row tiles' dB partials in a fixed order.  No float atomics.
// ---------------------------------------------------------------------------

constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads) ssd_bwd_finish_kernel(
    Args a) {
  __shared__ int last;
  const int Q = a.Q, nt = a.nt, nh = a.nh;
  const int noct = (nh + 7) / 8;
  const int n_d = a.b * a.nc * noct;
  if (static_cast<int>(blockIdx.x) < n_d) {
    const int bc = blockIdx.x / noct;
    const int h = (blockIdx.x % noct) * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const size_t t0 = static_cast<size_t>(bc / a.nc) * a.S +
                      static_cast<size_t>(bc % a.nc) * Q;
    if (h < nh) {
      const size_t bh = static_cast<size_t>(bc) * nh + h;
      const float Ah = a.A[h];
      float carry = 0.f, da = 0.f;
      for (int m = (Q + 31) / 32 - 1; m >= 0; --m) {
        const int j = 32 * m + lane;
        float d = 0.f;
        if (j < Q) {
          d = a.gcum[bh * Q + j];
#pragma unroll 4
          for (int t = (32 * m) / kT; t < nt; ++t)
            d += a.dcs[(bh * nt + t) * Q + j];
          if (j == Q - 1) {
            for (int u = 0; u < nt; ++u) d += a.dtp[bh * nt + u];
            d += expf(a.total[bh]) * a.gh[bh];
          }
        }
        float sfx = d;  // the sum over this step and the later ones of 32
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_down_sync(0xffffffffu, sfx, off);
          if (lane + off < 32) sfx += o;
        }
        const float rev = sfx + carry;
        carry += __shfl_sync(0xffffffffu, sfx, 0);
        if (j < Q) {
          const size_t at = (t0 + j) * nh + h;
          a.ddt[at] += Ah * rev;
          da += a.dt[at] * rev;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, off);
      if (lane == 0) a.dap[bh] = da;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.cnt, 1) == n_d - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      const int nbc = a.b * a.nc;
      for (int hh = threadIdx.x; hh < nh; hh += kFinishThreads) {
        float sum = 0.f;
        for (int i = 0; i < nbc; ++i)
          sum += __ldcg(a.dap + static_cast<size_t>(i) * nh + hh);
        a.dA[hh] = sum;
      }
    }
    return;
  }
  // dB and dC: element e of the (batch, chunk)'s rows, row-major over st
  const long long idx = static_cast<long long>(blockIdx.x - n_d) *
                        kFinishThreads + threadIdx.x;
  const long long per_bc = static_cast<long long>(Q) * a.st;
  if (idx >= static_cast<long long>(a.b) * a.nc * per_bc) return;
  const int bc = static_cast<int>(idx / per_bc);
  const int e = static_cast<int>(idx % per_bc);
  const int j = e / a.st, u = j / kT;
  const size_t t0 = static_cast<size_t>(bc / a.nc) * a.S +
                    static_cast<size_t>(bc % a.nc) * Q;
  const size_t tile = static_cast<size_t>(kT) * a.st;
  const size_t group = static_cast<size_t>(a.b) * a.nc * a.npair * tile;
  const float* pb = a.dbp + static_cast<size_t>(bc) * a.npair * tile +
                    static_cast<size_t>(e - u * kT * a.st);
  float db = 0.f, dc = 0.f;
  for (int gr = 0; gr < a.ngr; ++gr) {
    dc += a.dcp[gr * a.dcp_stride + t0 * a.st + e];
#pragma unroll 4
    for (int t = u; t < nt; ++t)
      db += pb[gr * group + static_cast<size_t>(t * (t + 1) / 2 + u) * tile];
  }
  a.dB[t0 * a.st + e] = db;
  a.dC[t0 * a.st + e] = dc;
}

template <int kS>
cudaError_t run(Args a, cudaStream_t stream) {
  const int s1 = state_smem<kS>(a.Q);
  const int s3 = rows_smem<kS>(a.rh);
  const int s4 = cols_smem<kS>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_state_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_rows_kernel<kS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s3);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_cols_kernel<kS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s4);
  if (err != cudaSuccess) return err;
  const long long bnc = static_cast<long long>(a.b) * a.nc;
  const long long g1 = bnc * ((a.nh + 1) / 2);
  const long long g3 = bnc * a.nt * a.ngr;
  const long long g4 = bnc * a.nt * a.ncg;
  const long long g5 = bnc * ((a.nh + 7) / 8) +
                       (bnc * a.Q * a.st + kFinishThreads - 1) / kFinishThreads;
  if (g1 > 0x7fffffffLL || g3 > 0x7fffffffLL || g4 > 0x7fffffffLL ||
      g5 > 0x7fffffffLL || static_cast<long long>(a.b) * a.nh > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(a.cnt, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<kS>
      <<<static_cast<unsigned>(g1), kThreads2, s1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_pass_kernel<kS>
      <<<dim3(a.b * a.nh, kT * kS / 256), 256, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_rows_kernel<kS>
      <<<static_cast<unsigned>(g3), kThreads2, s3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_cols_kernel<kS>
      <<<static_cast<unsigned>(g4), kThreads2, s4, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish_kernel<<<static_cast<unsigned>(g5), kFinishThreads, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* dy,
                     const void* dstate, void* dx, void* ddt, void* dA,
                     void* dB, void* dC, void* ws, long long ws_floats, int b,
                     int S, int nh, int hp, int st, int Q,
                     cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int kS = st > kT ? 2 * kT : kT;
  const Layout l(b, S, nh, Q);
  const Workspace w(b, S, nh, hp, st, Q, kS, l);
  if (ws == nullptr || ws_floats < 0 ||
      static_cast<size_t>(ws_floats) < w.end || !aligned(ws))
    return cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  Args a;
  a.x = static_cast<const bf*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dy = static_cast<const bf*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dx = static_cast<bf*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.b_pl = reinterpret_cast<bf*>(wsf + w.b_pl);
  a.c_pl = reinterpret_cast<bf*>(wsf + w.c_pl);
  a.s_c = wsf + w.s_c;
  a.u_c = wsf + w.u_c;
  a.total = wsf + w.total;
  a.cum_t = wsf + w.cum_t;
  a.dt_t = wsf + w.dt_t;
  a.h_pl = reinterpret_cast<bf*>(wsf + w.h_pl);
  a.g_pl = reinterpret_cast<bf*>(wsf + w.g_pl);
  a.s_t = wsf + w.s_t;
  a.dcp = wsf + w.dcp;
  a.dbp = wsf + w.dbp;
  a.dcs = wsf + w.dcs;
  a.gcum = wsf + w.gcum;
  a.dtp = wsf + w.dtp;
  a.gh = wsf + w.gh;
  a.dap = wsf + w.dap;
  a.cnt = reinterpret_cast<int*>(wsf + w.cnt);
  a.dcp_stride = w.dcp_stride;
  a.b = b, a.S = S, a.nh = nh, a.hp = hp, a.st = st, a.Q = Q;
  a.nc = l.nc, a.nt = l.nt, a.npair = l.npair, a.ngr = l.ngr, a.rh = l.rh;
  a.ncg = l.ncg;
  a.vec_x = hp % 8 == 0 && aligned(x) && aligned(dy);
  a.vec_bc = st % 4 == 0 && aligned(B) && aligned(C);
  return kS == kT ? run<kT>(a, stream) : run<2 * kT>(a, stream);
}

}  // namespace bf16

bool widths_ok(int b, int S, int nh, int hp, int st, int chunk) {
  return b > 0 && S > 0 && nh > 0 && hp > 0 && hp <= kT && st > 0 &&
         st <= kMaxState && chunk > 0 && chunk <= kMaxChunk && S % chunk == 0;
}

}  // namespace

// The float32 values of scratch that ssd_scan_bwd_launch needs for these
// widths and x_dtype (0 = float32, 1 = bfloat16), written to *floats: the
// end of that dtype's Workspace.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_workspace_floats(int b, int S, int nh, int hp,
                                             int st, int chunk, int x_dtype,
                                             long long* floats) {
  if (floats == nullptr || !widths_ok(b, S, nh, hp, st, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) {
    *floats = static_cast<long long>(Workspace(b, S, nh, hp, st, chunk).end);
  } else if (x_dtype == 1) {
    const bf16::Layout l(b, S, nh, chunk);
    *floats = static_cast<long long>(
        bf16::Workspace(b, S, nh, hp, st, chunk, st > kT ? 2 * kT : kT, l)
            .end);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

// x_dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, five
// kernels).  dstate may be null (a zero gradient of the final state).  ws:
// float32 scratch of ws_floats values (ssd_scan_bwd_workspace_floats for
// x's dtype), 16-byte aligned for bfloat16.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* B,
                                   const void* C, const void* dy,
                                   const void* dstate, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* ws,
                                   long long ws_floats, int b, int S, int nh,
                                   int hp, int st, int chunk, int x_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(b, S, nh, hp, st, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == 0)
    err = dispatch<float>(x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC,
                          ws, ws_floats, b, S, nh, hp, st, chunk, s);
  else if (x_dtype == 1)
    err = bf16::dispatch(x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC, ws,
                         ws_floats, b, S, nh, hp, st, chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
