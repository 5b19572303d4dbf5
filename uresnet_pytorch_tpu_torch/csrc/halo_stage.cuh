// Device helpers shared by kernel B (halo_conv.cu), kernel C
// (halo_conv_dw.cu) and kernels D/E (halo_extend.cu): the geometry of a
// halo'd tile's (t+2)^dim extended block (where each extended cell comes
// from, where each tile cell sits in it, the row shift of each stencil
// offset), runtime division by a multiply, cp.async copies and the bf16
// tensor-core MMA.

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

// 16 bytes global -> shared without a register round trip; zeros when
// !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>   // until at most N of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Ext cell e of a tile (row-major, last axis fastest) takes, per axis, ext
// coord 0 from the -1 neighbor's cell t-1, coord t+1 from the +1 neighbor's
// cell 0 and coords 1..t from the tile itself (the slab_cells geometry of
// ops/halo.py): its stencil offset (halo_offsets order with the center
// inserted) | its source cell << 5.
__device__ __forceinline__ int ext_source(int e, int t, int dim) {
  const int E = t + 2;
  int rem = e, kfull = 0, scell = 0, mk = 1, ms = 1;
  for (int ax = 0; ax < dim; ++ax) {
    const int ea = rem % E;
    rem /= E;
    kfull += (ea == 0 ? 0 : (ea == t + 1 ? 2 : 1)) * mk;
    scell += (ea == 0 ? t - 1 : (ea == t + 1 ? 0 : ea - 1)) * ms;
    mk *= 3;
    ms *= t;
  }
  return kfull | (scell << 5);
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
