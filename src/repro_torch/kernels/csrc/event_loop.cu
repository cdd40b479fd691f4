// OpenMP self-scheduling event loop on Hopper (sm_90a): the batched
// simulator's sequential core, one warp per simulated loop instance.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/event_loop.py:
//   event_finish_kernel        <- event_finish       (_loop_kernel, _assign_segment)
//   event_finish_fused_kernel  <- event_finish_fused (_fused_kernel)
//
// Per lane b: fin = jitter[b].  For each chunk i < count[b]: the PE is
// forced[b,i] when it is >= 0, else argmin(fin) with ties to the lowest
// index; then fin[pe] += (h_eff + eff*speed[pe]) + bcost.  The fused kernel
// computes eff itself from the lane's cumulative-cost row:
//   pos = f32(x) * gscale, i = clamp(int(pos), 0, G-1),
//   pref(x) = lo + (pos - i) * (row[i+1] - lo),
//   eff = ((pref(start+size) - pref(start)) * loc) * noise,
// so eff never goes to device memory.
//
// What bounds it.  The recurrence is a serial chain of count[b] dependent
// steps per lane (each step's argmin reads the previous step's update), so
// a lane is latency-bound: one step is a warp-wide argmin (5 xor-shuffle
// rounds over (value, index) pairs) plus one update.  The bytes are small:
// 8 B per live chunk in event_finish (eff, forced), about 20 B per live
// chunk in the fused kernel (start, size, loc, noise, forced) plus two
// gathers from the grid row, which stays in L2 for the lanes that share it.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// axis over segments and keeps fin in VMEM between them; here a loop inside
// the warp takes the place of that axis.  fin and speed live in registers
// (thread t holds PEs t, t+32, t+64, t+96; PEs past P hold +inf), so a step
// touches no memory.  The warp loads the next 32 chunks' inputs with one
// coalesced load while it walks the current 32, taking each value from its
// owner thread with __shfl_sync.  Many lanes run side by side (one warp
// each) to fill the card; a lane with count == 0 writes jitter and exits.
//
// Rounding.  The reference's float32 arithmetic is contracted by XLA into
// fused multiply-adds at exactly two places: h_eff + eff*speed and the grid
// interpolation.  They are written here as __fmaf_rn, every other operation
// as an explicit round-to-nearest intrinsic, and the file is compiled with
// -fmad=false so that nvcc contracts nothing else.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxP = 128;
constexpr int kRegs = kMaxP / 32;

// Lexicographic (value, index) argmin across the warp; every thread ends
// with the winner's index.  Ties go to the lowest index, as jnp.argmin.
__device__ __forceinline__ int warp_argmin(const float (&fin)[kRegs], int t) {
  float v = fin[0];
  int idx = t;
#pragma unroll
  for (int r = 1; r < kRegs; ++r) {
    if (fin[r] < v) {  // indices grow with r: strict < keeps the lowest
      v = fin[r];
      idx = t + 32 * r;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

// One assignment step with the chunk's eff and forced PE (warp-uniform).
__device__ __forceinline__ void assign(float (&fin)[kRegs],
                                       const float (&spd)[kRegs], int t,
                                       float e, int f, float h, float bc) {
  const int pe = f >= 0 ? f : warp_argmin(fin, t);
  if ((pe & 31) == t) {
    const int slot = pe >> 5;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      if (r == slot) {
        const float inc = __fadd_rn(__fmaf_rn(e, spd[r], h), bc);
        fin[r] = __fadd_rn(fin[r], inc);
      }
    }
  }
}

__device__ __forceinline__ float prefix_at(const float* __restrict__ row,
                                           float gs, int x, int G) {
  const float pos = __fmul_rn(__int2float_rn(x), gs);
  int i = __float2int_rz(pos);
  i = min(max(i, 0), G - 1);
  const float lo = row[i];
  const float hi = row[i + 1];
  return __fmaf_rn(__fsub_rn(pos, __int2float_rn(i)), __fsub_rn(hi, lo), lo);
}

struct Lane {
  int b;
  int t;
};

__device__ __forceinline__ bool lane_of_thread(int B, Lane* lane) {
  lane->b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  lane->t = threadIdx.x & 31;
  return lane->b < B;  // uniform across the warp
}

__device__ __forceinline__ void load_pe_rows(const float* __restrict__ speed,
                                             const float* __restrict__ jitter,
                                             long long off, int P, int t,
                                             float (&fin)[kRegs],
                                             float (&spd)[kRegs]) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int p = t + 32 * r;
    fin[r] = p < P ? jitter[off + p] : CUDART_INF_F;
    spd[r] = p < P ? speed[off + p] : 0.0f;
  }
}

__device__ __forceinline__ void store_pe_row(float* __restrict__ out,
                                             long long off, int P, int t,
                                             const float (&fin)[kRegs]) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int p = t + 32 * r;
    if (p < P) out[off + p] = fin[r];
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
event_finish_kernel(const float* __restrict__ eff,
                    const float* __restrict__ speed,
                    const float* __restrict__ jitter,
                    const float* __restrict__ h_eff,
                    const float* __restrict__ bcost,
                    const int* __restrict__ forced,
                    const int* __restrict__ count, float* __restrict__ out,
                    int B, int K, int P) {
  Lane lane;
  if (!lane_of_thread(B, &lane)) return;
  const int b = lane.b, t = lane.t;
  float fin[kRegs], spd[kRegs];
  load_pe_rows(speed, jitter, (long long)b * P, P, t, fin, spd);
  const int cnt = count[b];
  const float h = h_eff[b], bc = bcost[b];
  const long long row = (long long)b * K;

  float e_next = 0.0f;
  int f_next = -1;
  if (t < cnt) {
    e_next = eff[row + t];
    f_next = forced[row + t];
  }
  for (int base = 0; base < cnt; base += 32) {
    const float e = e_next;
    const int f = f_next;
    const int i = base + 32 + t;  // next segment's loads overlap this walk
    if (i < cnt) {
      e_next = eff[row + i];
      f_next = forced[row + i];
    }
    const int n = min(32, cnt - base);
    for (int j = 0; j < n; ++j) {
      const float ej = __shfl_sync(kFull, e, j);
      const int fj = __shfl_sync(kFull, f, j);
      assign(fin, spd, t, ej, fj, h, bc);
    }
  }
  store_pe_row(out, (long long)b * P, P, t, fin);
}

__device__ __forceinline__ float fused_eff(const float* __restrict__ grow,
                                           float gs, int G, int s, int z,
                                           float loc, float noise) {
  const float cost = __fsub_rn(prefix_at(grow, gs, s + z, G),
                               prefix_at(grow, gs, s, G));
  return __fmul_rn(__fmul_rn(cost, loc), noise);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
event_finish_fused_kernel(const float* __restrict__ grids,
                          const int* __restrict__ grid_id,
                          const float* __restrict__ gscale,
                          const int* __restrict__ starts,
                          const int* __restrict__ sizes,
                          const float* __restrict__ loc,
                          const float* __restrict__ noise,
                          const float* __restrict__ speed,
                          const float* __restrict__ jitter,
                          const float* __restrict__ h_eff,
                          const float* __restrict__ bcost,
                          const int* __restrict__ forced,
                          const int* __restrict__ count,
                          float* __restrict__ out, int B, int K, int P,
                          int G) {
  Lane lane;
  if (!lane_of_thread(B, &lane)) return;
  const int b = lane.b, t = lane.t;
  float fin[kRegs], spd[kRegs];
  load_pe_rows(speed, jitter, (long long)b * P, P, t, fin, spd);
  const int cnt = count[b];
  const float h = h_eff[b], bc = bcost[b];
  const float gs = gscale[b];
  const float* __restrict__ grow = grids + (long long)grid_id[b] * (G + 1);
  const long long row = (long long)b * K;

  float e_next = 0.0f;
  int f_next = -1;
  if (t < cnt) {
    e_next = fused_eff(grow, gs, G, starts[row + t], sizes[row + t],
                       loc[row + t], noise[row + t]);
    f_next = forced[row + t];
  }
  for (int base = 0; base < cnt; base += 32) {
    const float e = e_next;
    const int f = f_next;
    const int i = base + 32 + t;  // next segment's loads overlap this walk
    if (i < cnt) {
      e_next = fused_eff(grow, gs, G, starts[row + i], sizes[row + i],
                         loc[row + i], noise[row + i]);
      f_next = forced[row + i];
    }
    const int n = min(32, cnt - base);
    for (int j = 0; j < n; ++j) {
      const float ej = __shfl_sync(kFull, e, j);
      const int fj = __shfl_sync(kFull, f, j);
      assign(fin, spd, t, ej, fj, h, bc);
    }
  }
  store_pe_row(out, (long long)b * P, P, t, fin);
}

inline unsigned blocks_for(int B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported where it happened.
extern "C" int event_finish_launch(const float* eff, const float* speed,
                                   const float* jitter, const float* h_eff,
                                   const float* bcost, const int* forced,
                                   const int* count, float* out, int B, int K,
                                   int P, void* stream) {
  if (B <= 0) return 0;
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  event_finish_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(eff, speed, jitter, h_eff,
                                                bcost, forced, count, out, B,
                                                K, P);
  return (int)cudaGetLastError();
}

extern "C" int event_finish_fused_launch(
    const float* grids, const int* grid_id, const float* gscale,
    const int* starts, const int* sizes, const float* loc, const float* noise,
    const float* speed, const float* jitter, const float* h_eff,
    const float* bcost, const int* forced, const int* count, float* out,
    int B, int K, int P, int G, void* stream) {
  if (B <= 0) return 0;
  if (P < 1 || P > kMaxP || G < 1) return (int)cudaErrorInvalidValue;
  event_finish_fused_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                              (cudaStream_t)stream>>>(
      grids, grid_id, gscale, starts, sizes, loc, noise, speed, jitter, h_eff,
      bcost, forced, count, out, B, K, P, G);
  return (int)cudaGetLastError();
}
