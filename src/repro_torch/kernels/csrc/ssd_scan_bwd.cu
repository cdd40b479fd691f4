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
// cum_i - cum_j is positive and large, and exp(.) * 0 would be NaN.
//
// Three kernels run in order on the stream, with a float32 workspace that
// the wrapper allocates (Workspace below; the wrapper's
// _bwd_workspace_floats must agree):
//   1. ssd_bwd_chunk_kernel, one block per (batch, chunk, head): the chunk's
//      own state S_c = sum_j W_j x_j B_j^T and its part of the state
//      gradient U_c = sum_i exp(cum_i) dy_i C_i^T (hp x st each), and T.
//   2. ssd_bwd_pass_kernel, one thread per (batch, head, state element): the
//      serial pass over chunks forwards, H <- H exp(T) + S_c, leaving the
//      state before each chunk over S_c, and backwards from dstate (or 0),
//      G <- G exp(T) + U_c, leaving the gradient after each chunk over U_c.
//   3. ssd_bwd_grad_kernel, one block per (batch, chunk, group of kHG = 4
//      heads): every gradient above.  s = C B^T is formed once a tile for
//      the group's heads, and the heads' Pm are summed before the two
//      products with B and C, so the state-wide products run once a group.
//      dB and dC leave as partials by head group, dA as partials by (batch,
//      chunk); the last block of a chunk to finish (an integer ticket)
//      sums the chunk's partials in group order, and the last block of all
//      sums dA in (batch, chunk) order.  No float atomics: reruns are
//      bit-equal.
// cum is summed in order by one thread a head, as torch.cumsum sums it.
//
// What bounds it.  A simple design on the CUDA cores in float32: per head
// and chunk about Q^2 (hp + st) / 2 + 4 Q hp st multiply-adds at Q = 256,
// hp = 64, st = 128 (mamba2-2.7b), a few times its operations over bytes,
// so it is bound by the CUDA cores' 67 TFLOP/s, far from the tensor cores'
// bound of the same work; see PERF.md.  Tiles of 64 rows, a 4 x 4 (or
// 4 x kS/16) register tile a thread over 256 threads; every operand staged
// in shared memory in float32 at a row stride of width + 1.  Kernel 3 holds
// three 64 x kS and three 64 x 64 tiles and 3 kHG Q floats: 199 KB at
// kS = 128 and Q = 1024 (one block an SM).
//
// Widths.  hp <= 64, st <= 128, Q <= 1024 and a divisor of S, as the
// forward's; kernels are templates on kS (64 for st <= 64, 128 above), the
// state columns past st zero-filled and never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tile rows and columns; the widest hp
constexpr int kStride = kT + 1;
constexpr int kMaxState = 2 * kT;
constexpr int kMaxChunk = 1024;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kHG = 4;          // heads a block of kernel 3

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
  return __float2bfloat16(v);
}

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
__device__ __forceinline__ float row_sum(float v) {
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
// `end` is its size.  The wrapper sizes the workspace by the same sums.
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

// the in-chunk cumulative sum of dt * a, in order (one thread)
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dts,
                                             float a, int Q) {
  float acc = 0.f;
  for (int j = 0; j < Q; ++j) {
    acc += dts[j] * a;
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
  extern __shared__ float smem[];
  const int Q = a.Q;
  float* cum = smem;                   // [Q]
  float* w = cum + Q;                  // [Q]: dt, then W_j
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
    chunk_cumsum(cum, w, a.A[h], Q);
    a.tot[static_cast<size_t>(bc) * nh + h] = cum[Q - 1];
  }
  __syncthreads();
  const float T_c = cum[Q - 1];
  for (int j = tid; j < Q; j += kThreads) {
    w[j] = expf(T_c - cum[j]) * w[j];
    e[j] = expf(cum[j]);
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
__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(Args<T> a) {
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
  return 3 * kT * (kS + 1) + 3 * kT * kStride + 16 * kT + kThreads +
         2 * kHG + 3 * kHG * static_cast<size_t>(Q);
}

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad_kernel(Args<T> a) {
  constexpr int kSS = kS + 1, kSC = kS / 16;
  extern __shared__ float smem[];
  __shared__ int chunk_last, all_last;
  const int Q = a.Q, nh = a.nh, hp = a.hp, st = a.st;
  float* Cs = smem;                     // [kT][kSS]   C rows i
  float* Bs = Cs + kT * kSS;            // [kT][kSS]   B rows j
  float* Ms = Bs + kT * kSS;            // [kT][kSS]   H or G of one head
  float* Xs = Ms + kT * kSS;            // [kT][kStride]  x rows j
  float* DYs = Xs + kT * kStride;       // [kT][kStride]  dy rows i
  float* SLs = DYs + kT * kStride;      // [kT][kStride]  s o L, then sum Pm
  float* colp = SLs + kT * kStride;     // [16][kT]  column partials
  float* red = colp + 16 * kT;          // [kThreads]
  float* dTacc = red + kThreads;        // [kHG]  sum_j W_j dW_j
  float* gh = dTacc + kHG;              // [kHG]  <G, H>
  float* cum = gh + kHG;                // [kHG][Q]
  float* dts = cum + kHG * Q;           // [kHG][Q]
  float* dcum = dts + kHG * Q;          // [kHG][Q]

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
  // dB / dC partial rows of this block
  const size_t part0 = (static_cast<size_t>(bc) * a.nhg + g) * Q * st;

  for (int idx = tid; idx < kHG * Q; idx += kThreads) {
    const int k = idx / Q, j = idx % Q;
    dts[idx] = k < nk ? a.dt[(t0 + j) * nh + h0 + k] : 0.f;
    dcum[idx] = 0.f;
  }
  __syncthreads();
  if (tid < kHG) {
    chunk_cumsum(cum + tid * Q, dts + tid * Q, tid < nk ? a.A[h0 + tid] : 0.f,
                 Q);
    dTacc[tid] = 0.f;
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
        const float e = i < Q ? expf(cum[k * Q + i]) : 0.f;
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
          const float* ck = cum + k * Q;
          const float* dk = dts + k * Q;
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
          float pcol[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + ty + 16 * r;
            float prow = 0.f;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = j0 + tx + 16 * cc;
              float sl = 0.f;
              if (j <= i && i < Q) {   // never exp above the diagonal
                const float L = expf(ck[i] - ck[j]);
                const float pm = L * dk[j] * dyx[r][cc];
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
            float sum = 0.f;
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
        const float* ck = cum + k * Q;
        const float* dk = dts + k * Q;
        const float T_c = ck[Q - 1];
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
          const float ej = in ? expf(T_c - ck[j]) : 0.f;
          const float dtj = in ? dk[j] : 0.f;
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
          float sum = dTacc[k];
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
    float* dc = dcum + tid * Q;
    const float* ck = cum + tid * Q;
    const float* dk = dts + tid * Q;
    dc[Q - 1] += dTacc[tid] + expf(ck[Q - 1]) * gh[tid];
    float acc = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      acc += dc[j];
      dc[j] = acc;
    }
    float da = 0.f;
    for (int j = 0; j < Q; ++j) da += dc[j] * dk[j];
    a.dap[static_cast<size_t>(bc) * nh + h0 + tid] = da;
  }
  __syncthreads();
  for (int idx = tid; idx < nk * Q; idx += kThreads) {
    const int k = idx / Q, j = idx % Q;
    a.ddt[(t0 + j) * nh + h0 + k] += a.A[h0 + k] * dcum[k * Q + j];
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
      float sum = 0.f;
      for (int i = 0; i < nbc; ++i)
        sum += __ldcg(a.dap + static_cast<size_t>(i) * nh + h);
      a.dA[h] = sum;
    }
  }
}

template <typename T, int kS>
cudaError_t run(Args<T> a, cudaStream_t stream) {
  const size_t smem1 =
      sizeof(float) * (3 * a.Q + 2 * kT * kStride + 2 * kT * (kS + 1));
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
  ssd_bwd_pass_kernel<T>
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

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (x, dy and dx).  dstate may be null
// (a zero gradient of the final state).  ws: float32 scratch of ws_floats
// values (the wrapper's _bwd_workspace_floats).  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* B,
                                   const void* C, const void* dy,
                                   const void* dstate, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* ws,
                                   long long ws_floats, int b, int S, int nh,
                                   int hp, int st, int chunk, int x_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || S <= 0 || nh <= 0 || hp <= 0 || hp > kT || st <= 0 ||
      st > kMaxState || chunk <= 0 || chunk > kMaxChunk || S % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == 0)
    err = dispatch<float>(x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC,
                          ws, ws_floats, b, S, nh, hp, st, chunk, s);
  else if (x_dtype == 1)
    err = dispatch<__nv_bfloat16>(x, dt, A, B, C, dy, dstate, dx, ddt, dA,
                                  dB, dC, ws, ws_floats, b, S, nh, hp, st,
                                  chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
