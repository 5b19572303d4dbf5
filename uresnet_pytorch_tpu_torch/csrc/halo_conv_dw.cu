// Kernel C: weight gradient of the submanifold 3^dim conv on halo'd tiles,
// for Hopper (sm_90a).
//
//   d_W[k, ci, co] = sum over events, live tiles, cells p of
//                    ext(x)[tile, p + delta_k, ci] * g[tile, p, co]
//
// Replaces the d_W side of the TPU training kernels in
// uresnet_pytorch_tpu/ops/pallas/halo_conv.py:
//   halo_conv_dw v2 (_dw_kernel_v2) and v1 (_dw_kernel_v1)
//   the d_W half of halo_conv_bwd (_bwd_kernel_v2)
// The TPU kernels rebuild each grid step's extended block in VMEM with
// one-hot gathers and accumulate a banded Toeplitz cotangent in one f32
// block that the sequential grid revisits, mapped to d_W afterwards by
// toeplitz_adjoint. Here a block stages extended tiles straight from plain
// (B, T, t^dim, C) rows through idx/ok, so one kernel serves every (t, C),
// Cin = 1 included, and computes d_W itself.
//
// What bounds it on an H100: d_W is a GEMM with a tiny output (27 x Cin x
// Cout, at most 27x256x256 f32 at the repo's widths) and a reduction over
// millions of cells: M = (offset, input channel), N = output channel,
// depth = cells. Its card bound is the bytes of x and g (0.05 ms at
// config-4 L0); a kernel pays on top for staging the extended tiles
// (indexed loads of neighbor rows; at t=2 the extended block is 8x the
// tile) and for the latency of each chunk's loads and barriers. The
// earlier design gave each block one group of 9 offsets and a 16-channel
// input slice, so every chunk was staged 3-15 times (once per block row),
// with no copy in flight while the MMAs ran, and the stem staged 16
// channels a cell for its one.
//
// Design:
// - A block owns a 16-channel input slice and ALL offsets for a slice of
//   output channels (blockIdx.y), so each chunk of cells is staged once per
//   Cout slice. The block's M rows come in 16-row MMA tiles: one per offset
//   (Cin >= 16), or, for Cin < 16, the 27 x Cin (offset, channel) rows
//   packed into ceil(27 Cin / 16) tiles (the stem: 2, not 27). Nine warps
//   split the M tiles into wm groups of mw tiles; where there are fewer
//   tiles than warps (the stem), the warps of a group split the chunk's
//   16-cell depth steps round-robin instead. Each warp keeps its mw x Cout
//   slice x 16 accumulators in registers over all its chunks (at most 120
//   f32 a lane: wider Cout is split across blocks, not offsets, in
//   slices of at most 128) and adds them into d_W once, with atomics. Cout
//   not a multiple of 8 runs on zero g columns up to the next multiple (g
//   then staged by plain loads) and adds only the real columns.
// - A block walks chunks of whole tiles (256 cells: 4 tiles at t=4, 32 at
//   t=2) in a grid-stride loop, one wave of blocks; the per-block tables
//   (each extended cell's source, each chunk cell's extended row) are built
//   once. Each chunk's 27 neighbor rows per tile are read into registers a
//   chunk ahead. A chunk's extended rows and g rows come by 16-byte
//   cp.async, all in flight at once; then its MMAs run, and the blocks on
//   one SM overlap each other's copies and MMAs. (A second buffer, copying
//   the next chunk during this one's MMAs, gained nothing once chunks were
//   256 cells.)
// - Operands: g rows by ldmatrix.trans (cells x Cout -> the MMA's B); the
//   extended rows by ldmatrix.trans at each offset's shifted rows, or, for
//   packed rows, by scalar loads through a per-lane (offset, channel) row
//   offset, the extended block staged at its true width. Padded rows read a
//   real cell and are never added. mma.sync m16n8k16, bf16 in, f32 sums.
// - Dead tiles (blive = 0) stage g as zeros and add nothing; a chunk with
//   no live tile is skipped. The f32 sums run in another order than the
//   plain version's, so results agree to rounding, not bitwise.

#include "halo_stage.cuh"

namespace {

using halo::cp_async16;
using halo::cp_async_commit;
using halo::cp_async_wait;
using halo::ext_source;
using halo::FastDiv;
using halo::ipow;
using halo::pack2;

constexpr int kWarps = 9;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 pad per smem row (bank spread)
constexpr int kMaxSlice = 128;            // Cout per block: 16 n-tiles (the instances)
constexpr int kNbrPerThread = 3;          // map entries (tiles x K) per thread
constexpr int kMaxAcc = 120;              // f32 accumulators a lane may hold
constexpr size_t kMaxSmem = 232448;       // dynamic shared memory a block may use

// the shape and the launch plan, shared by host and device
struct DwPlan {
  int T, t, dim, Cin, Cout;
  int coutp;                 // Cout padded to 8: the MMA's N side
  int gvec;                  // stage g by 16-byte copies (Cout % 8 == 0)
  int cells, ecells, K;      // t^dim, (t+2)^dim, 3^dim
  int tiles, chunk, ksteps;  // tiles, cells and 16-cell depth steps per chunk
  int per_event, chunks;     // chunks per event, in all
  int packed;                // (offset, channel) rows packed: Cin < 16
  int width, sa;             // channels staged per ext cell, smem row stride
  int cslices, mtiles;       // Cin slices (blockIdx.y), 16-row M tiles per block
  int wm, mw, nph;           // warp groups, M tiles per warp, depth phases
  int cs, sg;                // Cout per slice (blockIdx.y), g smem row stride
  int vec;                   // stage ext by 16-byte copies
  FastDiv by_unit, by_ecells, by_per_event, by_k;
  size_t ext_elems, g_elems, table_bytes, smem;
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// x (B,T,cells,Cin) bf16, g (B,T,cells,Cout) bf16 (16-byte aligned where
// Cout % 8 == 0),
// idx/ok (B,K-1,T), live (B,T), dw (K,Cin,Cout) f32, zeroed by the caller.
// blockIdx.y = Cin slice * (coutp / cs) + Cout slice.
template <int MW, int NT, bool kPacked>
__global__ void __launch_bounds__(kThreads)
halo_conv_dw_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const int* __restrict__ idx, const uint8_t* __restrict__ ok,
                    const uint8_t* __restrict__ live, float* __restrict__ dw,
                    DwPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* esrc = reinterpret_cast<int*>(smem);             // ecells
  int* erow = esrc + p.ecells;                          // chunk: ext row * sa
  int* nbr = erow + p.chunk;                            // tiles * K
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem + p.table_bytes);
  //                                                       ext, then g

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int nslices = p.coutp / p.cs;
  const int c_lo = (blockIdx.y / nslices) * 16;         // unpacked only
  const int co_lo = (blockIdx.y % nslices) * p.cs;
  const int center = p.K / 2;
  const int wgrp = warp % p.wm, ph = warp / p.wm;

  // once per block: the geometry tables
  for (int e = tid; e < p.ecells; e += kThreads) esrc[e] = ext_source(e, p.t, p.dim);
  for (int i = tid; i < p.chunk; i += kThreads) {
    const int j = i / p.cells;
    erow[i] = (j * p.ecells + halo::cell_ext_row(i - j * p.cells, p.t, p.dim)) * p.sa;
  }

  // this lane's operand offsets: A rows of each of its M tiles (unpacked:
  // the ldmatrix row's offset shift + channel half; packed: rows g and
  // g + 8 as (offset shift, channel)), B's ldmatrix row and column
  int ro[MW][2];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int mt = wgrp + i * p.wm;
    if (kPacked) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + gq + 8 * h;
        const int k = p.by_k.div(m);
        ro[i][h] = m < p.K * p.Cin
                       ? halo::offset_shift(k, p.dim, p.t + 2) * p.sa + (m - k * p.Cin)
                       : 0;
      }
    } else {
      ro[i][0] = mt < p.K ? halo::offset_shift(mt, p.dim, p.t + 2) * p.sa
                                + ((lane >> 3) & 1) * 8
                          : 0;
      ro[i][1] = 0;
    }
  }
  const int a_cell = ((lane >> 4) << 3) + (lane & 7);
  const int b_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * p.sg + (lane >> 4) * 8;

  // A chunk's neighbor rows: `prefetch` loads this thread's entries of the
  // maps into registers, `take` writes them into nb as source rows (-1 =
  // none; every offset of a dead tile or one past T) and returns true if
  // this thread saw a live tile. Between the two the loads are in flight.
  uint8_t pl[kNbrPerThread], po[kNbrPerThread];
  int pi[kNbrPerThread];
  auto prefetch = [&](int c) {
    const int ev = p.by_per_event.div(c);
    const int tile0 = (c - ev * p.per_event) * p.tiles;
#pragma unroll
    for (int e = 0; e < kNbrPerThread; ++e) {
      const int i = tid + e * kThreads;
      pl[e] = 0;
      if (c < p.chunks && i < p.tiles * p.K) {
        const int j = i / p.K, k = i - j * p.K;
        const int tile = tile0 + j;
        if (tile < p.T) {
          pl[e] = live[(size_t)ev * p.T + tile];
          if (k != center) {
            const size_t m =
                ((size_t)ev * (p.K - 1) + (k < center ? k : k - 1)) * p.T + tile;
            po[e] = ok[m];
            pi[e] = idx[m];
          }
        }
      }
    }
  };
  auto take = [&](int c, int* nb) {
    const int ev = p.by_per_event.div(c);
    const int tile0 = (c - ev * p.per_event) * p.tiles;
    bool mine = false;
#pragma unroll
    for (int e = 0; e < kNbrPerThread; ++e) {
      const int i = tid + e * kThreads;
      if (i < p.tiles * p.K) {
        const int j = i / p.K, k = i - j * p.K;
        int r = -1;
        if (pl[e]) {
          mine = true;
          r = k == center ? tile0 + j : (po[e] ? pi[e] : -1);
        }
        nb[i] = r;
      }
    }
    return mine;
  };
  // stage a chunk's extended rows (this block's channels, zeros past Cin
  // and for a missing neighbor) and its g rows (this block's Cout slice,
  // zeros on dead tiles and past Cout) into b: cp.async, committed by the
  // caller; by plain loads and stores off the vector paths
  auto stage = [&](int c, const int* nb, __nv_bfloat16* b) {
    const int ev = p.by_per_event.div(c);
    const int tile0 = (c - ev * p.per_event) * p.tiles;
    const __nv_bfloat16* xev = x + (size_t)ev * p.T * p.cells * p.Cin;
    const int unit = p.vec ? 8 : 1;
    const int per_cell = p.width / unit;
    for (int i = tid; i < p.tiles * p.ecells * per_cell; i += kThreads) {
      const int cellu = p.by_unit.div(i);           // tile * ecells + e
      const int c8 = (i - cellu * per_cell) * unit;
      const int j = p.by_ecells.div(cellu);
      const int es = esrc[cellu - j * p.ecells];
      const int r = nb[j * p.K + (es & 31)];
      const int ch = (kPacked ? 0 : c_lo) + c8;
      const bool hit = r >= 0 && ch < p.Cin;
      const __nv_bfloat16* src =
          hit ? xev + ((size_t)r * p.cells + (es >> 5)) * p.Cin + ch : xev;
      __nv_bfloat16* dst = b + (size_t)cellu * p.sa + c8;
      if (p.vec)
        cp_async16(dst, src, hit);
      else
        *dst = hit ? *src : __float2bfloat16(0.f);
    }
    const __nv_bfloat16* gev = g + ((size_t)ev * p.T + tile0) * p.cells * p.Cout + co_lo;
    __nv_bfloat16* gb = b + p.ext_elems;
    if (p.gvec) {
      const int per = p.cs / 8;
      for (int i = tid; i < p.chunk * per; i += kThreads) {
        const int cell = i / per;
        const int ch = (i - cell * per) * 8;
        const bool hit = nb[(cell / p.cells) * p.K + center] >= 0;
        cp_async16(gb + (size_t)cell * p.sg + ch,
                   hit ? gev + (size_t)cell * p.Cout + ch : gev, hit);
      }
    } else {
      for (int i = tid; i < p.chunk * p.cs; i += kThreads) {
        const int cell = i / p.cs;
        const int ch = i - cell * p.cs;
        const bool hit = nb[(cell / p.cells) * p.K + center] >= 0 && co_lo + ch < p.Cout;
        gb[(size_t)cell * p.sg + ch] = hit ? gev[(size_t)cell * p.Cout + ch]
                                           : __float2bfloat16(0.f);
      }
    }
  };

  float acc[MW][NT][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  // this warp's depth steps of a chunk in buffer b: ks = ks0, ks0 + nph,
  // ...; returns where the next chunk starts (the phases rotate over
  // chunks, so a warp group's steps stay balanced across its warps)
  auto compute = [&](const __nv_bfloat16* b, int ks0) {
    const __nv_bfloat16* gb = b + p.ext_elems;
    int ks = ks0;
    for (; ks < p.ksteps; ks += p.nph) {
      const int k0 = ks * 16;
      uint32_t bf[NT][2];
      const __nv_bfloat16* bp = gb + (size_t)k0 * p.sg + b_off;
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bp + n * 8);
        bf[n][0] = r[0]; bf[n][1] = r[1]; bf[n + 1][0] = r[2]; bf[n + 1][1] = r[3];
      }
      if (NT & 1) ldsm_x2_trans(bf[NT - 1], bp + (NT - 1) * 8);
      if (kPacked) {
        // cells k0 + 2q, +1, +8, +9: A[row][cell] = ext[erow(cell) + ro(row)]
        const int e0 = erow[k0 + 2 * q], e1 = erow[k0 + 2 * q + 1];
        const int e2 = erow[k0 + 2 * q + 8], e3 = erow[k0 + 2 * q + 9];
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          if (wgrp + i * p.wm >= p.mtiles) continue;
          uint32_t af[4];
          af[0] = pack2(b[e0 + ro[i][0]], b[e1 + ro[i][0]]);
          af[1] = pack2(b[e0 + ro[i][1]], b[e1 + ro[i][1]]);
          af[2] = pack2(b[e2 + ro[i][0]], b[e3 + ro[i][0]]);
          af[3] = pack2(b[e2 + ro[i][1]], b[e3 + ro[i][1]]);
#pragma unroll
          for (int n = 0; n < NT; ++n) halo::mma_16816(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      } else {
        const __nv_bfloat16* ap = b + erow[k0 + a_cell];
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          if (wgrp + i * p.wm >= p.mtiles) continue;
          uint32_t af[4];
          ldsm_x4_trans(af, ap + ro[i][0]);
#pragma unroll
          for (int n = 0; n < NT; ++n) halo::mma_16816(acc[i][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
    return ks - p.ksteps;
  };

  // the loop over this block's chunks: each barrier also ends the last
  // chunk's reads; the next chunk's maps load while this one is staged and
  // multiplied
  int c = blockIdx.x, ks0 = ph;
  prefetch(c);
  while (c < p.chunks) {
    const int nxt = c + gridDim.x;
    const bool any_live = __syncthreads_or(take(c, nbr));
    if (any_live) stage(c, nbr, buf);
    cp_async_commit();
    prefetch(nxt);
    cp_async_wait<0>();
    __syncthreads();
    if (any_live) ks0 = compute(buf, ks0);
    c = nxt;
  }

  // c0,c1 -> (row g, co 8n + 2q, +1); c2,c3 -> row g + 8
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int mt = wgrp + i * p.wm;
    if (mt >= p.mtiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row;                // row of d_W viewed as (K * Cin, Cout)
      if (kPacked) {
        row = mt * 16 + gq + 8 * h;
        if (row >= p.K * p.Cin) continue;
      } else {
        const int ci = c_lo + gq + 8 * h;
        if (ci >= p.Cin) continue;
        row = mt * p.Cin + ci;
      }
      float* out = dw + (size_t)row * p.Cout + co_lo + 2 * q;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = co_lo + 2 * q + n * 8;    // the pad's columns add nothing
        if (co < p.Cout) atomicAdd(out + n * 8, acc[i][n][2 * h]);
        if (co + 1 < p.Cout) atomicAdd(out + n * 8 + 1, acc[i][n][2 * h + 1]);
      }
    }
  }
}

template <int MW, int NT, bool kPacked>
int launch(const void* x, const void* g, const void* idx, const void* ok,
           const void* live, void* dw, const DwPlan& p, cudaStream_t stream) {
  auto kernel = halo_conv_dw_kernel<MW, NT, kPacked>;
  // the blocks one wave holds, asked of the runtime once per (device,
  // shared memory size) of this instantiation: the launch is on the
  // training step's host path
  struct Wave {
    int dev;
    size_t smem;
    int blocks;
  };
  thread_local Wave waves[8];
  thread_local int n_waves = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  for (int i = 0; i < n_waves && i < 8; ++i)
    if (waves[i].dev == dev && waves[i].smem == p.smem) blocks = waves[i].blocks;
  if (!blocks) {
    int sms = 0, per_sm = 0;
    // the largest plan's size, so that every cached size may launch
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kMaxSmem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           p.smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    waves[n_waves++ % 8] = Wave{dev, p.smem, blocks};
  }
  // one wave: as many blocks as fit on the SMs at once (a second, partial
  // wave would double the time of the blocks in it)
  const int gy = p.cslices * (p.coutp / p.cs);
  int gx = blocks / gy;
  if (gx < 1) gx = 1;
  if (gx > p.chunks) gx = p.chunks;
  kernel<<<dim3(gx, gy), kThreads, p.smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const int*)idx,
      (const uint8_t*)ok, (const uint8_t*)live, (float*)dw, p);
  return (int)cudaGetLastError();
}

// The launch of a plan chosen on the host (ops/cuda/halo_conv_dw.py:
// dw_plan): cs output channels per block, `tiles` whole tiles a chunk,
// and wm warp groups of mw M tiles a warp. Fills in this shape's chunks,
// M tiles, strides and byte sizes, and refuses (cudaErrorInvalidValue) a
// shape or plan outside the kernel's compile-time limits, with no
// template instance, or whose warp groups leave an M tile out.
int make_plan(DwPlan& p, int B, int T, int t, int dim, int Cin, int Cout, int cs,
              int tiles, int wm, int mw, bool aligned) {
  if (dim < 2 || dim > 3 || t < 2 || Cin < 1 || Cout < 1 || B < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  p.T = T; p.t = t; p.dim = dim; p.Cin = Cin; p.Cout = Cout;
  p.coutp = (Cout + 7) / 8 * 8;
  p.gvec = Cout % 8 == 0;
  p.cells = ipow(t, dim);
  p.ecells = ipow(t + 2, dim);
  p.K = ipow(3, dim);
  // a chunk: whole tiles in whole 16-cell depth steps, its map entries
  // within the threads' registers
  if (tiles < 1 || tiles * p.cells % 16 || tiles * p.K > kNbrPerThread * kThreads)
    return (int)cudaErrorInvalidValue;
  p.tiles = tiles;
  p.chunk = p.tiles * p.cells;
  p.ksteps = p.chunk / 16;
  p.per_event = (T + p.tiles - 1) / p.tiles;
  p.chunks = B * p.per_event;
  p.packed = Cin < 16;
  p.width = p.packed ? Cin : 16;
  p.sa = p.packed ? Cin : 16 + kPad;
  p.cslices = p.packed ? 1 : (Cin + 15) / 16;
  p.mtiles = p.packed ? (p.K * Cin + 15) / 16 : p.K;
  // warp groups that split the nine warps, up to 3 M tiles a warp (2 only
  // packed: the instances), covering every M tile
  if ((wm != 1 && wm != 3 && wm != 9) || mw < 1 || mw > 3 || (!p.packed && mw == 2) ||
      wm * mw < p.mtiles)
    return (int)cudaErrorInvalidValue;
  p.wm = wm;
  p.mw = mw;
  p.nph = kWarps / p.wm;
  p.vec = Cin % 8 == 0 && aligned;
  p.ext_elems = ((size_t)p.tiles * p.ecells * p.sa + 7) / 8 * 8;
  p.table_bytes = ((size_t)(p.ecells + p.chunk + p.tiles * p.K) * sizeof(int) + 15) / 16 * 16;
  // a Cout slice within the accumulator budget
  if (cs < 8 || cs % 8 || cs > kMaxSlice || p.coutp % cs || p.mw * (cs / 8) * 4 > kMaxAcc)
    return (int)cudaErrorInvalidValue;
  p.cs = cs;
  p.sg = p.cs + kPad;
  p.g_elems = (size_t)p.chunk * p.sg;
  p.smem = p.table_bytes + (p.ext_elems + p.g_elems) * sizeof(__nv_bfloat16);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int unit = p.vec ? 8 : 1;
  p.by_unit = FastDiv(p.width / unit);
  p.by_ecells = FastDiv(p.ecells);
  p.by_per_event = FastDiv(p.per_event > 0 ? p.per_event : 1);
  p.by_k = FastDiv(Cin);
  return 0;
}

template <int MW, bool kPacked>
int dispatch_nt(const void* x, const void* g, const void* idx, const void* ok,
                const void* live, void* dw, const DwPlan& p, cudaStream_t st) {
  switch (p.cs / 8) {
#define HALO_CONV_DW_CASE(N)                                                          \
  case N:                                                                             \
    if (MW * N * 4 <= kMaxAcc)                                                        \
      return launch<MW, (MW * N * 4 <= kMaxAcc ? N : 1), kPacked>(                    \
          x, g, idx, ok, live, dw, p, st);                                            \
    break;
    HALO_CONV_DW_CASE(1) HALO_CONV_DW_CASE(2) HALO_CONV_DW_CASE(3) HALO_CONV_DW_CASE(4)
    HALO_CONV_DW_CASE(5) HALO_CONV_DW_CASE(6) HALO_CONV_DW_CASE(7) HALO_CONV_DW_CASE(8)
    HALO_CONV_DW_CASE(9) HALO_CONV_DW_CASE(10) HALO_CONV_DW_CASE(11) HALO_CONV_DW_CASE(12)
    HALO_CONV_DW_CASE(13) HALO_CONV_DW_CASE(14) HALO_CONV_DW_CASE(15) HALO_CONV_DW_CASE(16)
#undef HALO_CONV_DW_CASE
    default: break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, g bfloat16 (g 16-byte aligned where Cout % 8 == 0), dw (K, Cin, Cout)
// float32 zeroed by the caller; (cs, tiles, wm, mw) is the plan
// (make_plan above). Returns a cudaError_t (0 = launched).
int halo_conv_dw(const void* x, const void* g, const void* idx, const void* ok,
                 const void* live, void* dw, int B, int T, int t, int dim,
                 int Cin, int Cout, int cs, int tiles, int wm, int mw,
                 void* stream) {
  if (Cout % 8 == 0 && (uintptr_t)g % 16) return (int)cudaErrorInvalidValue;
  DwPlan p;
  const int err = make_plan(p, B, T, t, dim, Cin, Cout, cs, tiles, wm, mw,
                            (uintptr_t)x % 16 == 0);
  if (err) return err;
  if (p.chunks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // unpacked rows: one M tile per offset, so mw = 3 (dim 3) or 1 (dim 2)
  if (p.packed) {
    if (p.mw == 1) return dispatch_nt<1, true>(x, g, idx, ok, live, dw, p, st);
    if (p.mw == 2) return dispatch_nt<2, true>(x, g, idx, ok, live, dw, p, st);
    return dispatch_nt<3, true>(x, g, idx, ok, live, dw, p, st);
  }
  if (p.mw == 3) return dispatch_nt<3, false>(x, g, idx, ok, live, dw, p, st);
  return dispatch_nt<1, false>(x, g, idx, ok, live, dw, p, st);
}

}  // extern "C"
