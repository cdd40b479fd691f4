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
// What bounds it.  A lane is a serial chain of count[b] dependent steps
// (each step's argmin reads the previous step's update); its bytes are few
// (8 B a chunk in event_finish, about 20 B and two grid gathers in the fused
// kernel).  A lane is bound by its chain, a call of many lanes by issue:
// the campaign's largest call (B = 4096, P = 128, 3.10e6 live chunks) cut
// to its first 132 / 528 / 1056 / 2112 / 4096 lanes takes 0.053 / 0.081 /
// 0.094 / 0.144 / 0.260 ms (H100 80GB HBM3, 700 W; the warp-shuffle design
// it replaces: 0.141 / 0.226 / 0.237 / 0.281 / 0.501), its longest lane
// alone 0.080 ms (787 steps): flat while the chain holds the call, then
// about linear in lanes.  Most of a step's instructions are compares and
// selects, which the ALU pipe takes at half the issue rate, and every
// thread of a warp issues every one; so the lever is fewer instructions
// a step.
//
// Layout: one warp a lane, thread t holding PEs t + 32 r (r < R =
// ceil(P/32)) of fin and speed in registers, +inf past P.  Each thread
// keeps the key and index of its own minimum; a step changes one PE, in
// its owner thread, so only the owner's pair changes.  The warp re-derives
// every thread's pair branch-free, with a select per register slot (the
// other threads' pairs come out as they were), and the argmin is two
// __reduce_min_sync on 32-bit keys:
//   key(x) = u ^ (u >> 31 ? 0xffffffff : 0x80000000), u = bits(x + 0.0f),
// which orders keys as the floats (x + 0.0f turns -0.0 into +0.0, so the
// two tie as they do for jnp.argmin; +inf padding ranks above every finite
// value).  The first reduction gives the least key, the second the least
// index among the threads that hold it; inside a thread a strict < in slot
// order keeps the lowest index.  So the PE is the lowest index of the least
// value: jnp.argmin's rule, bit for bit.  Each slot's fin after taking the
// chunk is formed while the reductions run, so only a select and the
// write-back follow them.  The segment's (eff, forced) pairs are staged in
// shared memory, one pair a thread, and read by every thread with one
// broadcast load a step; their inputs are loaded two segments ahead (the
// fused kernel gathers its grid values one ahead).
//
// The warp layout serves every P.  A thread-per-lane layout (all of fin in
// one thread's registers, a tree argmin) was built and measured for small
// P (PERF.md): on the what-if call it was meant for (B = 138,
// P = 8) it tied this layout, the call being mostly launch and its
// 324-step chain; in the fused kernel it lost at every P.  It was not kept.
//
// Contract: finite inputs, as before.  A NaN is outside it: a compare
// with a NaN is false, so a strict < never moves the minimum onto one, and
// the key of a NaN with a clear sign bit ranks above +inf, so the kernel
// never takes it over a number of another thread; but which PE a lane
// holding a NaN takes is not defined (nor was it in the shuffle design).
//
// Rounding.  The reference's float32 arithmetic is contracted by XLA into
// fused multiply-adds at exactly two places: h_eff + eff*speed and the grid
// interpolation.  They are written here as __fmaf_rn, every other operation
// as an explicit round-to-nearest intrinsic, and the file is compiled with
// -fmad=false so that nvcc contracts nothing else.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP = 128;
constexpr int kWarpsPerBlock = 4;  // lanes a block

struct Chunk {
  float e;  // effective cost
  int f;    // forced PE, -1 for the argmin
};

// ---------------------------------------------------------------------------
// chunk sources: load (raw inputs) -> gather (grid values) -> finish (eff)
// ---------------------------------------------------------------------------

struct PlainSource {
  const float* __restrict__ eff;
  const int* __restrict__ forced;
  long long row;
  int cnt;

  struct Raw {
    float e;
    int f;
  };
  using Mid = Raw;

  __device__ __forceinline__ Raw load(int i) const {
    Raw r{0.0f, -1};
    if (i < cnt) {
      r.e = eff[row + i];
      r.f = forced[row + i];
    }
    return r;
  }
  __device__ __forceinline__ Mid gather(const Raw& r) const { return r; }
  __device__ __forceinline__ Chunk finish(const Mid& m) const {
    return Chunk{m.e, m.f};
  }
};

struct FusedSource {
  const float* __restrict__ grow;  // the lane's grid row (G + 1 points)
  float gs;
  int G;
  const int* __restrict__ starts;
  const int* __restrict__ sizes;
  const float* __restrict__ loc;
  const float* __restrict__ noise;
  const int* __restrict__ forced;
  long long row;
  int cnt;

  struct Raw {
    int s, z;
    float l, n;
    int f;
  };
  // both ends' (pos - i, row[i], row[i+1]), and the chunk's factors
  struct Mid {
    float fa, la, ha, fb, lb, hb, l, n;
    int f;
  };

  __device__ __forceinline__ Raw load(int i) const {
    Raw r{0, 0, 0.0f, 0.0f, -1};
    if (i < cnt) {
      r.s = starts[row + i];
      r.z = sizes[row + i];
      r.l = loc[row + i];
      r.n = noise[row + i];
      r.f = forced[row + i];
    }
    return r;
  }
  // pos = f32(x) * gs, i = clamp(int(pos), 0, G-1): the fraction and the
  // two grid values around it
  __device__ __forceinline__ void point(int x, float* fr, float* lo,
                                        float* hi) const {
    const float pos = __fmul_rn(__int2float_rn(x), gs);
    int i = __float2int_rz(pos);
    i = min(max(i, 0), G - 1);
    *fr = __fsub_rn(pos, __int2float_rn(i));
    *lo = grow[i];
    *hi = grow[i + 1];
  }
  __device__ __forceinline__ Mid gather(const Raw& r) const {
    Mid m;
    point(r.s, &m.fa, &m.la, &m.ha);
    point(r.s + r.z, &m.fb, &m.lb, &m.hb);
    m.l = r.l;
    m.n = r.n;
    m.f = r.f;
    return m;
  }
  __device__ __forceinline__ Chunk finish(const Mid& m) const {
    const float pa = __fmaf_rn(m.fa, __fsub_rn(m.ha, m.la), m.la);
    const float pb = __fmaf_rn(m.fb, __fsub_rn(m.hb, m.lb), m.lb);
    return Chunk{__fmul_rn(__fmul_rn(__fsub_rn(pb, pa), m.l), m.n), m.f};
  }
};

// ---------------------------------------------------------------------------
// one warp a lane
// ---------------------------------------------------------------------------

// Order-preserving key of a float: unsigned order of keys = order of
// floats, -0.0 and +0.0 equal.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

// This thread's minimum over its R slots (strict <: lowest index on ties).
template <int R>
__device__ __forceinline__ void thread_min(const float (&fin)[R], int t,
                                           unsigned* key, int* idx) {
  float v = fin[0];
  int i = t;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    const bool p = fin[r] < v;
    v = p ? fin[r] : v;
    i = p ? t + 32 * r : i;
  }
  *key = order_key(v);
  *idx = i;
}

// One step: every thread ends with the same pe and the owner's slot
// updated; (key, idx) re-derived for every thread without a branch.
template <int R>
__device__ __forceinline__ void warp_step(float (&fin)[R],
                                          const float (&spd)[R],
                                          unsigned* key, int* idx, int t,
                                          Chunk c, float h, float bc) {
  // the least key, then the least index holding it; a forced PE enters
  // the second reduction from every thread instead
  const unsigned m = __reduce_min_sync(kFull, *key);
  const int pe = (int)__reduce_min_sync(
      kFull, c.f >= 0 ? (unsigned)c.f : *key == m ? (unsigned)*idx : kFull);
  // every slot's fin after taking this chunk, while the reductions run;
  // the owner keeps pe's
  float cand[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    cand[r] = __fadd_rn(fin[r], __fadd_rn(__fmaf_rn(c.e, spd[r], h), bc));
  const bool own = (pe & 31) == t;
  const int slot = pe >> 5;
  float nv = cand[0];
#pragma unroll
  for (int r = 1; r < R; ++r) nv = slot == r ? cand[r] : nv;
#pragma unroll
  for (int r = 0; r < R; ++r) fin[r] = own && slot == r ? nv : fin[r];
  thread_min(fin, t, key, idx);
}

template <int R, class Src>
__device__ __forceinline__ void warp_lane(const Src& src, Chunk* seg,
                                          const float* __restrict__ speed,
                                          const float* __restrict__ jitter,
                                          float* __restrict__ out, int b,
                                          int t, int P, float h, float bc) {
  float fin[R], spd[R];
  const long long off = (long long)b * P;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = t + 32 * r;
    fin[r] = p < P ? jitter[off + p] : CUDART_INF_F;
    spd[r] = p < P ? speed[off + p] : 0.0f;
  }
  unsigned key;
  int idx;
  thread_min(fin, t, &key, &idx);

  // thread t stages chunk base + t of each segment: loaded two segments
  // ahead, gathered one ahead, finished when its segment starts (the
  // first two segments' loads issued together)
  const typename Src::Raw first = src.load(t);
  typename Src::Raw raw = src.load(32 + t);
  typename Src::Mid mid = src.gather(first);
  for (int base = 0; base < src.cnt; base += 32) {
    const Chunk mine = src.finish(mid);
    mid = src.gather(raw);
    raw = src.load(base + 64 + t);
    __syncwarp();
    seg[t] = mine;
    __syncwarp();
    const int n = min(32, src.cnt - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j)
      warp_step(fin, spd, &key, &idx, t, seg[j], h, bc);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = t + 32 * r;
    if (p < P) out[off + p] = fin[r];
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

struct Lanes {
  const float* __restrict__ speed;
  const float* __restrict__ jitter;
  const float* __restrict__ h_eff;
  const float* __restrict__ bcost;
  const int* __restrict__ count;
  float* __restrict__ out;
  int B, K, P;
};

__device__ __forceinline__ PlainSource plain_source(const float* eff,
                                                    const int* forced,
                                                    const Lanes& L, int b) {
  return PlainSource{eff, forced, (long long)b * L.K, L.count[b]};
}

struct FusedArgs {
  const float* __restrict__ grids;
  const int* __restrict__ grid_id;
  const float* __restrict__ gscale;
  const int* __restrict__ starts;
  const int* __restrict__ sizes;
  const float* __restrict__ loc;
  const float* __restrict__ noise;
  const int* __restrict__ forced;
  int G;
};

__device__ __forceinline__ FusedSource fused_source(const FusedArgs& a,
                                                    const Lanes& L, int b) {
  return FusedSource{a.grids + (long long)a.grid_id[b] * (a.G + 1),
                     a.gscale[b], a.G, a.starts, a.sizes, a.loc, a.noise,
                     a.forced, (long long)b * L.K, L.count[b]};
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
event_finish_kernel(const float* __restrict__ eff,
                    const int* __restrict__ forced, Lanes L) {
  __shared__ Chunk seg[kWarpsPerBlock][32];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= L.B) return;  // uniform across the warp
  warp_lane<R>(plain_source(eff, forced, L, b), seg[w], L.speed, L.jitter,
               L.out, b, t, L.P, L.h_eff[b], L.bcost[b]);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
event_finish_fused_kernel(FusedArgs a, Lanes L) {
  __shared__ Chunk seg[kWarpsPerBlock][32];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= L.B) return;
  warp_lane<R>(fused_source(a, L, b), seg[w], L.speed, L.jitter, L.out, b,
               t, L.P, L.h_eff[b], L.bcost[b]);
}

unsigned blocks_for(int B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Launch warp(std::integral_constant<int, R>) for R = ceil(P/32) slots a
// thread (1 <= P <= kMaxP, checked by the caller).
template <class Warp>
void dispatch(int P, Warp warp) {
  switch ((P + 31) / 32) {
    case 1: warp(std::integral_constant<int, 1>()); break;
    case 2: warp(std::integral_constant<int, 2>()); break;
    case 3: warp(std::integral_constant<int, 3>()); break;
    default: warp(std::integral_constant<int, 4>()); break;
  }
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
  const Lanes L{speed, jitter, h_eff, bcost, count, out, B, K, P};
  dispatch(P, [&](auto r) {
    event_finish_kernel<decltype(r)::value>
        <<<blocks_for(B), 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            eff, forced, L);
  });
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
  const Lanes L{speed, jitter, h_eff, bcost, count, out, B, K, P};
  const FusedArgs a{grids, grid_id, gscale, starts, sizes, loc, noise,
                    forced, G};
  dispatch(P, [&](auto r) {
    event_finish_fused_kernel<decltype(r)::value>
        <<<blocks_for(B), 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            a, L);
  });
  return (int)cudaGetLastError();
}
