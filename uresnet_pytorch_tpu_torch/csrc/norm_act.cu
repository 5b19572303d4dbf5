// Batch norm, its activation and its re-mask over rows of C channels, for
// Hopper (sm_90a): kernels norm_act_*.
//
// x is (rows, C) channels last: the tile engine's (B, T, cells, C), or a
// dense (B, C, *S) volume in channels-last memory. Optionally it is a pair
// of tensors (rows, C0) and (rows, C1) that stand for their channel concat
// (the decoder's (up, skip)); per-channel vectors then cover C0 + C1. A
// single tensor may carry a residual r (rows, C) added before the
// activation (a post-activation residual block). With the per-channel
// pre-activation v = (x - sh) * a + b [+ r]:
//
//   stats        s1 = sum m x, s2 = sum m x^2, n = sum m over the rows
//                (m the row's mask byte, 1 where there is no mask)
//   apply        y = act(v), times m under `remask`
//   bwd reduce   sum g and sum g (x - sh), g = dy act'(v) (times m under
//                remask), and from them d_scale and d_bias
//   bwd apply    dx = g a + m (c1 + c2 x), and with r, d_r = g
//
// The kernels with r are instances of their own (template flag R), so a
// call without r runs the code it ran before r existed.
//
// act(v) = v >= 0 ? v : slope v; act' is 1 at v > 0, slope at v < 0, and at
// v = 0 1 for a leaky slope (the gradient of where(v >= 0, v, s v)) and 0
// for slope 0 (that of relu). Every block derives (sh, a, b) itself, in f32,
// from the sums (train) or the running moments (eval): mean = s1 / max(n, 1),
// var = max(s2 / max(n, 1) - mean^2, 0), inv = rsqrt(var + eps), then
// `folded` (the masked BN): sh = 0, a = scale inv and b = bias - mean scale
// inv, each rounded to x's type; else (flax's f32 BatchNorm): sh = mean,
// a = inv scale, b = bias. c1 and c2 are the gradients that reach x through
// the sums (the autograd of those formulas, the clamp's gradient at var = 0
// included: a half for the masked BN's maximum, all of it for the dense
// BN's clamp); in eval they are 0. Sums run in f32; each output is rounded
// once to x's type.
//
// Replaces no TPU kernel: the JAX package's BN is jnp code that XLA fuses on
// the TPU. In the port it was a chain of about a dozen torch ops (casts,
// mask products, two sums, a bf16 affine, the activation, the re-mask), each
// a pass over every cell of the tile interiors, replayed by autograd and by
// the recompute; it took most of a training step's device time.
//
// What bounds it on an H100: HBM bandwidth (a few operations an element),
// and, at the tile engine's level 0 where 5% of the rows are active, the
// latency of finding them. Design: each warp takes tiles of 512 rows. It
// stages their mask bytes with one 16-byte load a lane and, where only the
// active rows are read (the sums; everything under `remask`), lists them
// in shared memory by a warp scan, so a warp has the loads of all its
// active rows in flight together, not one mask byte, then one row, at a
// time.
// A lane reads V channels (a 16-byte vector where C and the addresses
// allow), always the same ones, so its sums and coefficients stay in
// registers. Under `remask` every output and input gradient of an inactive
// row is 0 and is stored without a read. The reducing kernels write
// per-block partials that the last block to finish sums in a fixed order
// (deterministic, no float atomics), so a train-mode forward is 2 launches
// (stats, apply), eval 1, a backward 2. Between the two, the caller sums
// the stats (or the backward's sums) over the ranks of a data mesh. The
// backward kernels hold x, dy and five coefficient vectors a lane: capped
// at 128 registers (two blocks an SM) they read the rows faster than at
// their free ~150 (one block), and slower at 85 (spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;      // rows a warp tile
constexpr int kRed = 4096;      // floats of a block's per-lane sums

enum Kernel { kStats = 0, kApply = 1, kBwdReduce = 2, kBwdApply = 3 };

struct Params {
  const void* x[2];       // the halves, (rows, c[h]) each
  const void* dy[2];      // backward: their output gradients
  void* out[2];           // y (apply) or dx (bwd apply)
  const void* res[2];     // the residual (rows, c[0]), both entries (R)
  void* dres[2];          // bwd apply: its gradient, both entries (R)
  int c[2];               // channels of each half (c[1] = 0: one tensor)
  long long rows;
  const uint8_t* mask;    // (rows,) or null: every row counts
  const float* scale;     // (C,) each, C = c[0] + c[1]
  const float* bias;
  const float* run_mean;  // eval: the running moments
  const float* run_var;
  float* stats;           // (5, C): s1, s2, n, mean, var (train)
  float* grads;           // (4, C): sum g, sum g (x - sh), d_scale, d_bias
  float* part;            // reducing kernels: per-block partials
  unsigned* ticket;       // their last-block counter (one a stream), 0
                          // between launches
  float slope, eps;
  int train, folded, remask;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float act(float v, float s) {
  return v >= 0.f ? v : (s == 0.f ? 0.f : s * v);
}
__device__ __forceinline__ float dact(float v, float s) {
  return (v > 0.f || (v == 0.f && s > 0.f)) ? 1.f : s;
}

struct Moments {
  float mean, var, raw, cnt;   // raw: the variance before its clamp
};

// each rounding as torch's op-by-op f32 chain (no contraction to an FMA)
__device__ Moments moments(const Params& p, int c, int C) {
  if (!p.train) return {p.run_mean[c], p.run_var[c], p.run_var[c], 1.f};
  const float cnt = fmaxf(p.stats[2 * C + c], 1.f);
  const float mean = __fdiv_rn(p.stats[c], cnt);
  const float raw =
      __fsub_rn(__fdiv_rn(p.stats[C + c], cnt), __fmul_rn(mean, mean));
  return {mean, raw < 0.f ? 0.f : raw, raw, cnt};
}

struct Coef {
  float sh, a, b, inv;
};

template <typename T>
__device__ Coef coef(const Params& p, int c, const Moments& mo) {
  // rsqrtf, the op torch's rsqrt runs on the card, so (a, b) equal the
  // plain version's: 1 / sqrt differs from it in the last bit at some
  // variances, and a and b, rounded to x's type, can then land a step apart
  const float inv = rsqrtf(__fadd_rn(mo.var, p.eps));
  const float s = p.scale[c];
  if (p.folded) {
    const float a = __fmul_rn(s, inv);
    const float b =
        __fsub_rn(p.bias[c], __fmul_rn(__fmul_rn(mo.mean, s), inv));
    return {0.f, to_f(from_f<T>(a)), to_f(from_f<T>(b)), inv};
  }
  return {mo.mean, __fmul_rn(inv, s), p.bias[c], inv};
}

__device__ __forceinline__ float pre(float x, float sh, float a, float b) {
  return fmaf(x - sh, a, b);
}

// d(loss)/d(s1) and 2 d(loss)/d(s2) from the (mesh-wide) backward sums
__device__ void stat_grads(const Params& p, int c, int C, const Moments& mo,
                           const Coef& k, float& c1, float& c2) {
  if (!p.train) {
    c1 = c2 = 0.f;
    return;
  }
  const float s = p.scale[c], gb = p.grads[c], gx = p.grads[C + c];
  float d_inv, d_mean;
  if (p.folded) {   // a = scale inv, b = bias - (mean scale) inv
    d_inv = gx * s - gb * (mo.mean * s);
    d_mean = -(gb * k.inv) * s;
  } else {          // (x - mean) (inv scale) + bias
    d_inv = gx * s;
    d_mean = -gb * (k.inv * s);
  }
  const float d_var = d_inv * (-0.5f * (k.inv * k.inv * k.inv));
  const float d_raw = mo.raw > 0.f ? d_var
                    : mo.raw == 0.f ? (p.folded ? 0.5f : 1.f) * d_var
                                    : 0.f;
  d_mean -= 2.f * mo.mean * d_raw;
  c1 = d_mean / mo.cnt;
  c2 = 2.f * (d_raw / mo.cnt);
}

// This lane's place in its warp: with U = C / V vectors a row, U <= 32
// (G = 1) puts Q = 32 / U rows side by side, lane r0 U + u reading vector u
// of row r0 of each step (lanes past Q U idle); 32 < U <= 64 (G = 2) takes
// one row a step, lane l reading vectors l and l + 32. A lane always reads
// the same channels [u V, u V + V), so its sums and coefficients stay in
// registers.
template <int V, int G>
struct Lane {
  int C, Q, r0;
  bool on;                  // this lane takes rows
  int u[G];                 // its vectors of a row
  bool ok[G];
  int h[G], stride[G], col[G];   // half, its row length, the vector's column
  __device__ explicit Lane(const Params& p) {
    C = p.c[0] + p.c[1];
    const int U = C / V, U0 = p.c[0] / V, lane = threadIdx.x & 31;
    if (G == 1) {
      Q = 32 / U;
      r0 = lane / U;
      on = r0 < Q;
      u[0] = lane - r0 * U;
    } else {
      Q = 1;
      r0 = 0;
      on = true;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (G > 1) u[g] = lane + 32 * g;
      ok[g] = on && u[g] < U;
      const int uu = ok[g] ? u[g] : 0;
      h[g] = uu >= U0;
      stride[g] = p.c[h[g]];
      col[g] = (h[g] ? uu - U0 : uu) * V;
    }
  }
};

template <typename T, int V, int G>
__device__ __forceinline__ Vec<T, V> load(const void* const* base,
                                          long long row, const Lane<V, G>& l,
                                          int g) {
  return *reinterpret_cast<const Vec<T, V>*>(
      static_cast<const T*>(base[l.h[g]]) + (size_t)row * l.stride[g] +
      l.col[g]);
}

template <typename T, int V, int G>
__device__ __forceinline__ void store(void* const* base, long long row,
                                      const Lane<V, G>& l, int g,
                                      const Vec<T, V>& v) {
  *reinterpret_cast<Vec<T, V>*>(static_cast<T*>(base[l.h[g]]) +
                                (size_t)row * l.stride[g] + l.col[g]) = v;
}

// A warp's tile of kTile rows: their mask bytes and, compacted, the tile
// rows whose byte is set.
struct alignas(16) WarpTile {
  uint8_t m[kTile];
  uint16_t act[kTile];
};

enum Stage { kNoMask = 0, kBytes = 1, kCompact = 2 };

// Stages the mask bytes of rows [row0, row0 + n) (16 a lane, one load),
// and with kCompact lists the active ones in order. Returns the items to
// visit: the active rows (kCompact) or all n.
__device__ int stage(const Params& p, WarpTile& w, long long row0, int n,
                     int mode) {
  if (mode == kNoMask) return n;
  const int lane = threadIdx.x & 31, b0 = 16 * lane;
  union {
    uint4 v;
    uint8_t b[16];
  } mb;
  const uint8_t* src = p.mask + row0 + b0;
  if (b0 + 16 <= n && ((uintptr_t)src & 15) == 0) {
    mb.v = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) mb.b[k] = b0 + k < n ? src[k] : 0;
  }
  *reinterpret_cast<uint4*>(w.m + b0) = mb.v;
  if (mode == kBytes) {
    __syncwarp();
    return n;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) bits |= (unsigned)(mb.b[k] != 0) << k;
  const int cnt = __popc(bits);
  int pre = cnt;   // inclusive scan of the lanes' counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, pre, o);
    if (lane >= o) pre += y;
  }
  const int total = __shfl_sync(0xffffffffu, pre, 31);
  int at = pre - cnt;
  while (bits) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    w.act[at++] = (uint16_t)(b0 + k);
  }
  __syncwarp();
  return total;
}

// The rows of warp tile t: item j is its active row act[j] (kCompact) or
// its row j.
struct TileRows {
  long long row0;
  bool compact;
  __device__ TileRows(long long t, int mode)
      : row0(t * kTile), compact(mode == kCompact) {}
  // rows of the tile in range
  __device__ int count(const Params& p) const {
    const long long left = p.rows - row0;
    return left < kTile ? (int)left : kTile;
  }
  __device__ long long row(const WarpTile& w, int j) const {
    return row0 + (compact ? w.act[j] : j);
  }
};

__device__ __forceinline__ float warp_sum(float a) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

__device__ __forceinline__ long long warp_sum(long long a) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// Each block's per-channel sums of two quantities (q[0], q[1]) into
// part[(k C + c) G + block], k = 0, 1, summed over its lanes in a fixed
// order, and, with `counts`, its sum of n into counts[block]; then true in
// the last block to finish (every block's partials visible to it).
template <int V, int G>
__device__ bool block_partials(const Params& p, const Lane<V, G>& l,
                               const float (&q)[2][G][V], float (*red)[kRed],
                               long long n, long long* counts) {
  __shared__ bool last;
  __shared__ long long wcount[kWarps];
  const int warp = threadIdx.x >> 5;
  n = warp_sum(n);
  if ((threadIdx.x & 31) == 0) wcount[warp] = n;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!l.ok[g]) continue;
    const int at = (warp * l.Q + l.r0) * l.C + l.u[g] * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[0][at + j] = q[0][g][j];
      red[1][at + j] = q[1][g][j];
    }
  }
  __syncthreads();
  const int B = gridDim.x, rows = kWarps * l.Q;
  for (int i = threadIdx.x; i < 2 * l.C; i += kThreads) {
    const int k = i >= l.C, c = i - k * l.C;
    float a = 0.f;
    for (int r = 0; r < rows; ++r) a += red[k][r * l.C + c];
    p.part[(size_t)i * B + blockIdx.x] = a;
  }
  if (counts != nullptr && threadIdx.x == 0) {
    long long c = 0;
    for (int w = 0; w < kWarps; ++w) c += wcount[w];
    counts[blockIdx.x] = c;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1u) == (unsigned)B - 1;
  __syncthreads();
  return last;
}

// In the last block: the 2C partial rows summed over the blocks, each by
// one warp in a fixed order, into out[i] (and red[0][i]).
__device__ void sum_partials(const Params& p, int C, float* out,
                             float (*red)[kRed]) {
  const int B = gridDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < 2 * C; i += kWarps) {
    float a = 0.f;
    for (int b = lane; b < B; b += 32) a += __ldcg(p.part + (size_t)i * B + b);
    a = warp_sum(a);
    if (lane == 0) out[i] = red[0][i] = a;
  }
}

template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads) norm_act_stats_kernel(Params p) {
  constexpr int kB = 8 / G;    // rows in flight a lane
  __shared__ float red[2][kRed];
  __shared__ WarpTile wt[kWarps];
  const Lane<V, G> l(p);
  WarpTile& w = wt[threadIdx.x >> 5];
  const bool compact = p.mask != nullptr;
  float q[2][G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < V; ++j) q[0][g][j] = q[1][g][j] = 0.f;
  long long n = 0;
  const long long tiles = (p.rows + kTile - 1) / kTile;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kWarps) {
    const TileRows tr(t, compact ? kCompact : kNoMask);
    const int nt = tr.count(p);
    const int A = stage(p, w, tr.row0, nt, compact ? kCompact : kNoMask);
    if ((threadIdx.x & 31) == 0) n += A;
    if (l.on) {
      for (int s0 = 0; s0 * l.Q + l.r0 < A; s0 += kB) {
        Vec<T, V> v[kB][G];
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          const int j = (s0 + b) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (l.ok[g]) v[b][g] = load<T, V, G>(p.x, r, l, g);
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          if ((s0 + b) * l.Q + l.r0 >= A) break;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float f = to_f(v[b][g].v[j]);
              q[0][g][j] += f;
              q[1][g][j] += f * f;
            }
          }
        }
      }
    }
    __syncwarp();
  }
  long long* counts =
      reinterpret_cast<long long*>(p.part + (size_t)2 * l.C * gridDim.x);
  if (!block_partials<V, G>(p, l, q, red, n, counts)) return;
  sum_partials(p, l.C, p.stats, red);
  if (threadIdx.x < 32) {
    long long c = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32)
      c += __ldcg(counts + b);
    c = warp_sum(c);
    for (int i = threadIdx.x; i < l.C; i += 32)
      p.stats[2 * l.C + i] = (float)c;
  }
  if (threadIdx.x == 0) *p.ticket = 0;
}

// Under a re-mask: zeros into every inactive row of the tile, no read.
template <typename T, int V, int G>
__device__ void zero_inactive(const Params& p, const Lane<V, G>& l,
                              const WarpTile& w, long long row0, int nt) {
  if (!l.on) return;
  Vec<T, V> z;
#pragma unroll
  for (int j = 0; j < V; ++j) z.v[j] = from_f<T>(0.f);
  for (int rl = l.r0; rl < nt; rl += l.Q) {
    if (w.m[rl]) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (l.ok[g]) store<T, V, G>(p.out, row0 + rl, l, g, z);
  }
}

// Under a re-mask with a residual: zeros into every inactive row of d_r.
template <typename T, int V, int G>
__device__ void zero_inactive_dres(const Params& p, const Lane<V, G>& l,
                                   const WarpTile& w, long long row0,
                                   int nt) {
  if (!l.on) return;
  Vec<T, V> z;
#pragma unroll
  for (int j = 0; j < V; ++j) z.v[j] = from_f<T>(0.f);
  for (int rl = l.r0; rl < nt; rl += l.Q) {
    if (w.m[rl]) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (l.ok[g]) store<T, V, G>(p.dres, row0 + rl, l, g, z);
  }
}

template <typename T, int V, int G, bool R>
__global__ void __launch_bounds__(kThreads) norm_act_apply_kernel(Params p) {
  constexpr int kB = 8 / G;
  __shared__ WarpTile wt[kWarps];
  const Lane<V, G> l(p);
  WarpTile& w = wt[threadIdx.x >> 5];
  const bool compact = p.remask && p.mask != nullptr;
  float sh[G][V], a[G][V], b[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = (l.ok[g] ? l.u[g] : 0) * V + j;
      const Moments mo = moments(p, c, l.C);
      const Coef k = coef<T>(p, c, mo);
      sh[g][j] = k.sh;
      a[g][j] = k.a;
      b[g][j] = k.b;
      if (p.train && blockIdx.x == 0 && threadIdx.x < 32 && l.ok[g] &&
          l.r0 == 0) {
        p.stats[3 * l.C + c] = mo.mean;
        p.stats[4 * l.C + c] = mo.var;
      }
    }
  }
  const long long tiles = (p.rows + kTile - 1) / kTile;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kWarps) {
    const TileRows tr(t, compact ? kCompact : kNoMask);
    const int nt = tr.count(p);
    const int A = stage(p, w, tr.row0, nt, compact ? kCompact : kNoMask);
    if (compact) zero_inactive<T, V, G>(p, l, w, tr.row0, nt);
    if (l.on) {
      for (int s0 = 0; s0 * l.Q + l.r0 < A; s0 += kB) {
        Vec<T, V> v[kB][G], rv[R ? kB : 1][G];
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          const int j = (s0 + bb) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
            v[bb][g] = load<T, V, G>(p.x, r, l, g);
            if constexpr (R) rv[bb][g] = load<T, V, G>(p.res, r, l, g);
          }
        }
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          const int j = (s0 + bb) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
            Vec<T, V> o;
#pragma unroll
            for (int jj = 0; jj < V; ++jj) {
              float pv =
                  pre(to_f(v[bb][g].v[jj]), sh[g][jj], a[g][jj], b[g][jj]);
              if constexpr (R) pv = __fadd_rn(pv, to_f(rv[bb][g].v[jj]));
              o.v[jj] = from_f<T>(act(pv, p.slope));
            }
            store<T, V, G>(p.out, r, l, g, o);
          }
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int V, int G, bool R>
__global__ void __launch_bounds__(kThreads, 2)
    norm_act_bwd_reduce_kernel(Params p) {
  constexpr int kB = 4 / G;
  __shared__ float red[2][kRed];
  __shared__ WarpTile wt[kWarps];
  const Lane<V, G> l(p);
  WarpTile& w = wt[threadIdx.x >> 5];
  const bool compact = p.remask && p.mask != nullptr;
  float q[2][G][V], sh[G][V], a[G][V], b[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = (l.ok[g] ? l.u[g] : 0) * V + j;
      const Coef k = coef<T>(p, c, moments(p, c, l.C));
      sh[g][j] = k.sh;
      a[g][j] = k.a;
      b[g][j] = k.b;
      q[0][g][j] = q[1][g][j] = 0.f;
    }
  }
  const long long tiles = (p.rows + kTile - 1) / kTile;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kWarps) {
    const TileRows tr(t, compact ? kCompact : kNoMask);
    const int nt = tr.count(p);
    const int A = stage(p, w, tr.row0, nt, compact ? kCompact : kNoMask);
    if (l.on) {
      for (int s0 = 0; s0 * l.Q + l.r0 < A; s0 += kB) {
        Vec<T, V> v[kB][G], d[kB][G], rv[R ? kB : 1][G];
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          const int j = (s0 + bb) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
            v[bb][g] = load<T, V, G>(p.x, r, l, g);
            d[bb][g] = load<T, V, G>(p.dy, r, l, g);
            if constexpr (R) rv[bb][g] = load<T, V, G>(p.res, r, l, g);
          }
        }
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          if ((s0 + bb) * l.Q + l.r0 >= A) break;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
#pragma unroll
            for (int jj = 0; jj < V; ++jj) {
              const float xf = to_f(v[bb][g].v[jj]);
              float pv = pre(xf, sh[g][jj], a[g][jj], b[g][jj]);
              if constexpr (R) pv = __fadd_rn(pv, to_f(rv[bb][g].v[jj]));
              const float gj = to_f(d[bb][g].v[jj]) * dact(pv, p.slope);
              q[0][g][jj] += gj;
              q[1][g][jj] += gj * (xf - sh[g][jj]);
            }
          }
        }
      }
    }
    __syncwarp();
  }
  if (!block_partials<V, G>(p, l, q, red, 0, nullptr)) return;
  sum_partials(p, l.C, p.grads, red);
  __syncthreads();
  // this rank's parameter gradients, from its own sums
  for (int c = threadIdx.x; c < l.C; c += kThreads) {
    const Moments mo = moments(p, c, l.C);
    const Coef k = coef<T>(p, c, mo);
    const float gb = red[0][c], gx = red[0][l.C + c];
    p.grads[2 * l.C + c] =
        p.folded ? gx * k.inv + (-(gb * k.inv)) * mo.mean : gx * k.inv;
    p.grads[3 * l.C + c] = gb;
  }
  if (threadIdx.x == 0) *p.ticket = 0;
}

template <typename T, int V, int G, bool R>
__global__ void __launch_bounds__(kThreads, 2)
    norm_act_bwd_apply_kernel(Params p) {
  constexpr int kB = 4 / G;
  __shared__ WarpTile wt[kWarps];
  const Lane<V, G> l(p);
  WarpTile& w = wt[threadIdx.x >> 5];
  const bool compact = p.remask && p.mask != nullptr;
  // without a re-mask the rows' mask bytes still say where the sums' term
  // applies
  const int mode = compact ? kCompact : p.mask != nullptr ? kBytes : kNoMask;
  float sh[G][V], a[G][V], b[G][V], c1[G][V], c2[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = (l.ok[g] ? l.u[g] : 0) * V + j;
      const Moments mo = moments(p, c, l.C);
      const Coef k = coef<T>(p, c, mo);
      sh[g][j] = k.sh;
      a[g][j] = k.a;
      b[g][j] = k.b;
      stat_grads(p, c, l.C, mo, k, c1[g][j], c2[g][j]);
    }
  }
  const long long tiles = (p.rows + kTile - 1) / kTile;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kWarps) {
    const TileRows tr(t, mode);
    const int nt = tr.count(p);
    const int A = stage(p, w, tr.row0, nt, mode);
    if (compact) {
      zero_inactive<T, V, G>(p, l, w, tr.row0, nt);
      if constexpr (R) zero_inactive_dres<T, V, G>(p, l, w, tr.row0, nt);
    }
    if (l.on) {
      for (int s0 = 0; s0 * l.Q + l.r0 < A; s0 += kB) {
        Vec<T, V> v[kB][G], d[kB][G], rv[R ? kB : 1][G];
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          const int j = (s0 + bb) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
            v[bb][g] = load<T, V, G>(p.x, r, l, g);
            d[bb][g] = load<T, V, G>(p.dy, r, l, g);
            if constexpr (R) rv[bb][g] = load<T, V, G>(p.res, r, l, g);
          }
        }
#pragma unroll
        for (int bb = 0; bb < kB; ++bb) {
          const int j = (s0 + bb) * l.Q + l.r0;
          if (j >= A) break;
          const long long r = tr.row(w, j);
          const bool on = compact || mode == kNoMask || w.m[j];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (!l.ok[g]) continue;
            Vec<T, V> o, od;
#pragma unroll
            for (int jj = 0; jj < V; ++jj) {
              const float xf = to_f(v[bb][g].v[jj]);
              float pv = pre(xf, sh[g][jj], a[g][jj], b[g][jj]);
              if constexpr (R) pv = __fadd_rn(pv, to_f(rv[bb][g].v[jj]));
              const float gj = to_f(d[bb][g].v[jj]) * dact(pv, p.slope);
              float dd = gj * a[g][jj];
              if (on) dd += c1[g][jj] + c2[g][jj] * xf;
              o.v[jj] = from_f<T>(dd);
              if constexpr (R) od.v[jj] = from_f<T>(gj);
            }
            store<T, V, G>(p.out, r, l, g, o);
            if constexpr (R) store<T, V, G>(p.dres, r, l, g, od);
          }
        }
      }
    }
    __syncwarp();
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <typename T, int V, int G, bool R>
int launch(int kernel, const Params& p, int part_blocks, cudaStream_t st) {
  // one warp tile a warp at a time; up to 4 blocks an SM (each reducing
  // block writes 2C partials), fewer where the rows run out
  const long long tiles = (p.rows + kTile - 1) / kTile;
  long long g = (long long)sm_count() * 4;
  if ((kernel == kStats || kernel == kBwdReduce) && g > part_blocks)
    g = part_blocks;
  const long long need = (tiles + kWarps - 1) / kWarps;
  if (need < g) g = need;
  if (g < 1) g = 1;
  const dim3 grid((unsigned)g);
  switch (kernel) {
    case kStats:
      norm_act_stats_kernel<T, V, G><<<grid, kThreads, 0, st>>>(p);
      break;
    case kApply:
      norm_act_apply_kernel<T, V, G, R><<<grid, kThreads, 0, st>>>(p);
      break;
    case kBwdReduce:
      norm_act_bwd_reduce_kernel<T, V, G, R><<<grid, kThreads, 0, st>>>(p);
      break;
    case kBwdApply:
      norm_act_bwd_apply_kernel<T, V, G, R><<<grid, kThreads, 0, st>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int V, bool R>
int launch_gr(int kernel, const Params& p, int part_blocks, cudaStream_t st) {
  return (p.c[0] + p.c[1]) / V > 32
             ? launch<T, V, 2, R>(kernel, p, part_blocks, st)
             : launch<T, V, 1, R>(kernel, p, part_blocks, st);
}

template <typename T, int V>
int launch_g(int kernel, const Params& p, int part_blocks, cudaStream_t st) {
  // the stats kernel never reads the residual: one instance serves both
  return p.res[0] != nullptr && kernel != kStats
             ? launch_gr<T, V, true>(kernel, p, part_blocks, st)
             : launch_gr<T, V, false>(kernel, p, part_blocks, st);
}

}  // namespace

extern "C" {

// The vector width (elements) the kernels take for halves of c0 and c1
// channels of elem_bytes each (2: bf16, 4: f32) at 16-byte aligned bases,
// or 0 where they take no such rows (more than 64 vectors a row).
int norm_act_vector(int c0, int c1, int elem_bytes) {
  if (c0 < 1 || c1 < 0 || (elem_bytes != 2 && elem_bytes != 4)) return 0;
  const unsigned a = (unsigned)(c0 * elem_bytes) | (unsigned)(c1 * elem_bytes);
  const int vb = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
  if (vb < elem_bytes) return 0;
  const int v = vb / elem_bytes;
  return (c0 + c1) / v > 64 ? 0 : v;
}

// One kernel (0 stats, 1 apply, 2 bwd reduce, 3 bwd apply) over `rows` rows
// of the halves x0 (rows, c0) and x1 (rows, c1; null with c1 = 0), bf16
// (bf16 = 1) or f32; dy and out likewise; res (rows, c0) a residual or null
// (only with c1 = 0), dres its gradient (bwd apply; null without res);
// mask (rows,) uint8 or null;
// scale, bias, run_mean, run_var (C,) f32; stats (5, C) and grads (4, C)
// f32; part holds part_blocks * (2C + 2) floats; ticket one unsigned, 0.
// Returns a cudaError_t (0 = launched).
int norm_act_launch(int kernel, const void* x0, const void* x1,
                    const void* dy0, const void* dy1, void* out0, void* out1,
                    const void* res, void* dres, int c0, int c1,
                    long long rows, const void* mask,
                    const void* scale, const void* bias, const void* run_mean,
                    const void* run_var, void* stats, void* grads, void* part,
                    void* ticket, int part_blocks, float slope, float eps,
                    int train, int folded, int remask, int bf16,
                    void* stream) {
  const int es = bf16 ? 2 : 4;
  int v = norm_act_vector(c0, c1, es);
  if (v == 0 || rows < 0 || part_blocks < 1 || kernel < 0 || kernel > 3 ||
      (c1 > 0) != (x1 != nullptr) || (res != nullptr && c1 > 0) ||
      (kernel == kBwdApply && (res != nullptr) != (dres != nullptr)))
    return (int)cudaErrorInvalidValue;
  // narrower vectors where a base address is less aligned
  const uintptr_t addr = (uintptr_t)x0 | (uintptr_t)x1 | (uintptr_t)dy0 |
                         (uintptr_t)dy1 | (uintptr_t)out0 | (uintptr_t)out1 |
                         (uintptr_t)res | (uintptr_t)dres;
  while (v > 1 && addr % (uintptr_t)(v * es) != 0) v /= 2;
  if ((c0 + c1) / v > 64) return (int)cudaErrorInvalidValue;
  Params p;
  p.x[0] = x0;
  p.x[1] = x1;
  p.dy[0] = dy0;
  p.dy[1] = dy1;
  p.out[0] = out0;
  p.out[1] = out1;
  p.res[0] = p.res[1] = res;
  p.dres[0] = p.dres[1] = dres;
  p.c[0] = c0;
  p.c[1] = c1;
  p.rows = rows;
  p.mask = static_cast<const uint8_t*>(mask);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.run_mean = static_cast<const float*>(run_mean);
  p.run_var = static_cast<const float*>(run_var);
  p.stats = static_cast<float*>(stats);
  p.grads = static_cast<float*>(grads);
  p.part = static_cast<float*>(part);
  p.ticket = static_cast<unsigned*>(ticket);
  p.slope = slope;
  p.eps = eps;
  p.train = train;
  p.folded = folded;
  p.remask = remask;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    switch (v) {
      case 8: return launch_g<__nv_bfloat16, 8>(kernel, p, part_blocks, st);
      case 4: return launch_g<__nv_bfloat16, 4>(kernel, p, part_blocks, st);
      case 2: return launch_g<__nv_bfloat16, 2>(kernel, p, part_blocks, st);
      default: return launch_g<__nv_bfloat16, 1>(kernel, p, part_blocks, st);
    }
  }
  switch (v) {
    case 4: return launch_g<float, 4>(kernel, p, part_blocks, st);
    case 2: return launch_g<float, 2>(kernel, p, part_blocks, st);
    default: return launch_g<float, 1>(kernel, p, part_blocks, st);
  }
}

}  // extern "C"
