// Halo'd tile staging shared by kernel B (halo_conv.cu) and kernel C
// (halo_conv_dw.cu): the neighbor table of a block's tiles and the copy of
// their (t+2)^dim extended blocks from plain (B, T, t^dim, C) rows into
// shared memory, zero where a neighbor is missing. Also the bf16 tensor-core
// MMA both kernels issue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace halo {

__host__ __device__ __forceinline__ int ipow(int b, int e) {
  int r = 1;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}

// n / d for the block-uniform runtime divisors of the staging loop, as a
// multiply and shift (Granlund-Montgomery; exact for n < 2^31)
struct FastDiv {
  unsigned d, m, s;
  __host__ FastDiv() : d(1), m(0), s(0) {}
  __host__ explicit FastDiv(unsigned div) : d(div) {
    for (s = 0; s < 32; ++s)
      if ((1u << s) >= d) break;
    const unsigned long long one = 1;
    m = (unsigned)(((one << 32) * ((one << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Geometry of one block's staging.
struct Stage {
  int T, t, dim, Cin;
  int cells, ecells, K;      // t^dim, (t+2)^dim, 3^dim
  int tiles;                 // tiles staged per block
  int width;                 // channels staged per ext cell (multiple of 16)
  int sa;                    // smem row stride (bf16), a multiple of 8
  int vec;                   // 1: stage 8 channels per 16-byte load
  FastDiv by_e, by_groups, by_tile;   // (t+2), channel groups, per-tile units

  // fills every field from the shape; vec needs Cin % 8 and an aligned x
  __host__ void init(int T_, int t_, int dim_, int Cin_, int tiles_,
                     int width_, int pad, bool aligned) {
    T = T_; t = t_; dim = dim_; Cin = Cin_; tiles = tiles_; width = width_;
    cells = ipow(t, dim);
    ecells = ipow(t + 2, dim);
    K = ipow(3, dim);
    sa = width + pad;
    vec = Cin % 8 == 0 && aligned;
    const int unit = vec ? 8 : 1;
    by_e = FastDiv(t + 2);
    by_groups = FastDiv(width / unit);
    by_tile = FastDiv(ecells * (width / unit));
  }
};

// nbr[j*K + k]: the source tile row of stencil offset k (halo_offsets
// order with the center inserted) for staged tile j = tile0 + j, or -1 for
// none. Dead tiles (live = 0) and tiles past T get -1 everywhere. Sets
// *any_live (shared, zeroed and synced by the caller) if a staged tile is
// live. The caller syncs after.
__device__ __forceinline__ void build_nbr(int* nbr, int* any_live,
                                          const int* __restrict__ idx,
                                          const uint8_t* __restrict__ ok,
                                          const uint8_t* __restrict__ live,
                                          int ev, int tile0, const Stage& s) {
  const size_t evrow = (size_t)ev * s.T;
  const int center = s.K / 2;
  for (int i = threadIdx.x; i < s.tiles * s.K; i += blockDim.x) {
    const int j = i / s.K, k = i - j * s.K;
    const int tile = tile0 + j;
    int r = -1;
    if (tile < s.T && live[evrow + tile]) {
      if (k == center) {
        r = tile;
        *any_live = 1;
      } else {
        const int k26 = k < center ? k : k - 1;
        const size_t m = ((size_t)ev * (s.K - 1) + k26) * s.T + tile;
        r = ok[m] ? idx[m] : -1;
      }
    }
    nbr[i] = r;
  }
}

// Stage channels [c_lo, c_lo + width) of the staged tiles' extended blocks
// into ext_s (tiles*ecells rows of sa bf16). Ext cell e (row-major, last
// axis fastest) takes, per axis, ext coord 0 from the -1 neighbor's cell
// t-1, coord t+1 from the +1 neighbor's cell 0 and coords 1..t from the
// tile itself (the slab_cells geometry of ops/halo.py). Channels at or past
// Cin stage as zeros. xev is x at the event's first row.
__device__ __forceinline__ void stage_ext(__nv_bfloat16* ext_s,
                                          const __nv_bfloat16* __restrict__ xev,
                                          const int* nbr, int c_lo,
                                          const Stage& s) {
  const int E = s.t + 2;
  const int unit = s.vec ? 8 : 1;        // channels per staged element
  const int groups = s.width / unit;
  const int per_tile = s.ecells * groups;
  for (int i = threadIdx.x; i < s.tiles * per_tile; i += blockDim.x) {
    const int j = s.by_tile.div(i);
    const int rest = i - j * per_tile;
    const int e = s.by_groups.div(rest);
    const int c = (rest - e * groups) * unit;
    int rem = e, kfull = 0, scell = 0, mk = 1, ms = 1;
    for (int ax = 0; ax < s.dim; ++ax) {
      const int nxt = s.by_e.div(rem);
      const int ea = rem - nxt * E;
      rem = nxt;
      kfull += (ea == 0 ? 0 : (ea == s.t + 1 ? 2 : 1)) * mk;
      scell += (ea == 0 ? s.t - 1 : (ea == s.t + 1 ? 0 : ea - 1)) * ms;
      mk *= 3;
      ms *= s.t;
    }
    const int r = nbr[j * s.K + kfull];
    const int ch = c_lo + c;
    const bool hit = r >= 0 && ch < s.Cin;
    const size_t src = hit ? ((size_t)r * s.cells + scell) * s.Cin + ch : 0;
    __nv_bfloat16* dst = ext_s + (size_t)(j * s.ecells + e) * s.sa + c;
    if (s.vec) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hit) v = __ldg(reinterpret_cast<const uint4*>(xev + src));
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      *dst = hit ? xev[src] : __float2bfloat16(0.f);
    }
  }
}

// Ext-row offset of stencil offset k from a cell's own ext row: per axis
// (k's base-3 digit - 1) times the axis stride, last axis fastest.
__device__ __forceinline__ int offset_shift(int k, int dim, int E) {
  int rem = k, doff = 0, me = 1;
  for (int ax = 0; ax < dim; ++ax) {
    doff += (rem % 3 - 1) * me;
    rem /= 3;
    me *= E;
  }
  return doff;
}

// Ext row of cell `cell` of a t^dim tile (its own position in the
// (t+2)^dim block).
__device__ __forceinline__ int cell_ext_row(int cell, int t, int dim) {
  int rem = cell, e = 0, me = 1;
  for (int ax = 0; ax < dim; ++ax) {   // last axis fastest
    e += (rem % t + 1) * me;
    rem /= t;
    me *= t + 2;
  }
  return e;
}

}  // namespace halo
