// Kernel B: submanifold 3^dim convolution on halo'd tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernels in uresnet_pytorch_tpu/ops/pallas/halo_conv.py:
//   fused_halo_conv_bn_act (_fused_kernel_v2_bn)  -> halo_conv_bn_act below
//   halo_conv_fwd v2 (_fused_kernel_v2) and v1 (_fused_kernel) -> halo_conv_raw
//   _preslice0_pallas (the lane repack feeding both) -> not needed
//   the d_x half of halo_conv_bwd, and halo_conv_fwd on flipped weights ->
//   halo_conv_raw on flip_weights(w) (the adjoint stencil)
// The TPU kernels gather neighbor slabs with one-hot MXU matmuls over
// windows + correction rows, in lane-packed layouts that only exist for
// certain (t, C). Hopper has native indexed loads: each block reads its
// tiles' 26 neighbors' slab cells straight from plain (B, T, t^dim, C) rows
// through the halo maps idx/ok, so one kernel serves every (t, C), Cin = 1
// included.
//
// What bounds it on an H100: the conv is a small implicit GEMM per tile
// (rows = cells, K = 27 x Cin, N = Cout <= 128) whose A operand comes from
// an indexed gather, so it is bound by staging the extended tiles (global
// loads of neighbor rows, then shared-memory traffic), not by tensor-core
// FLOPs. Design: one block of 4 warps per 64 output rows (one t=4 tile, or
// eight t=2 tiles). The block stages its tiles' (t+2)^dim x Cin extended
// blocks in shared memory as bf16 (16-byte loads when Cin % 8 == 0;
// halo_stage.cuh, shared with kernel C),
// padded to 16 channels. Each warp owns 16 rows x Cout and runs mma.sync
// m16n8k16 (bf16 in, f32 accumulate) over the 3^dim offsets, reading A
// rows at the offset's shifted ext position from shared memory and B
// straight from the (K, Cin, Cout) weights through the read-only cache:
// the largest stacks (27x128x64 bf16 = 442 KB) do not fit the 227 KB of
// shared memory a block may use, but every block reads the same weights,
// so they stay in L1/L2. The epilogue (per-channel affine, leaky, cell
// mask) runs on the f32 accumulators and rounds once on store. Tiles at or
// past the live prefix (blive = 0) write zeros; a block with no live tile
// skips the staging and the MMAs.

#include "halo_stage.cuh"

namespace {

using halo::ipow;

constexpr int kRows = 64;                 // output rows per block
constexpr int kWarps = kRows / 16;        // each warp: 16 rows x Cout
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 pad per smem row (bank spread)
constexpr int kMaxTiles = 16;             // tiles per block (dim 2, t = 2)

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// the staging geometry (width = cpad: every channel, padded to 16) plus the
// output side
struct Shape : halo::Stage {
  int Cout;
  int slices;                // 64-row slices per tile
  int cpad;                  // Cin padded to 16
};

template <int NT, bool kEpilogue>
__global__ void __launch_bounds__(kThreads)
halo_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wt,
                 const int* __restrict__ idx, const uint8_t* __restrict__ ok,
                 const uint8_t* __restrict__ live, const float* __restrict__ a,
                 const float* __restrict__ b, const uint8_t* __restrict__ mask,
                 float alpha, __nv_bfloat16* __restrict__ out, Shape s) {
  const int ev = blockIdx.y;
  const int tile0 = (blockIdx.x / s.slices) * s.tiles;
  const int slice = blockIdx.x % s.slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const size_t evrow = (size_t)ev * s.T;

  extern __shared__ __align__(16) __nv_bfloat16 ext_s[];   // tiles*ecells x sa
  __shared__ int nbr[kMaxTiles * 27];   // source row per (tile, offset), -1 = none
  __shared__ int any_live;

  if (threadIdx.x == 0) any_live = 0;
  __syncthreads();
  halo::build_nbr(nbr, &any_live, idx, ok, live, ev, tile0, s);
  __syncthreads();

  // rows owned by this thread's fragments: r0 = 16*warp + g, r1 = r0 + 8
  int rtile[2], rcell[2], rbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
    const int j = s.slices == 1 ? m / s.cells : 0;
    const int cell = s.slices == 1 ? m - j * s.cells : slice * kRows + m;
    rtile[h] = j;
    rcell[h] = cell;
    rbase[h] = j * s.ecells + halo::cell_ext_row(cell, s.t, s.dim);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (any_live) {
    halo::stage_ext(ext_s, x + evrow * s.cells * s.Cin, nbr, 0, s);
    __syncthreads();

    for (int k = 0; k < s.K; ++k) {
      const int doff = halo::offset_shift(k, s.dim, s.t + 2);
      const __nv_bfloat16* a0p = ext_s + (size_t)(rbase[0] + doff) * s.sa + 2 * q;
      const __nv_bfloat16* a1p = ext_s + (size_t)(rbase[1] + doff) * s.sa + 2 * q;
      // B fragment: wt[k][n*8 + g][c0 + 2q .. +1] and the same at c0 + 8
      const __nv_bfloat16* wk = wt + ((size_t)k * s.Cout + g) * s.cpad + 2 * q;
      for (int c0 = 0; c0 < s.cpad; c0 += 16) {
        uint32_t af[4] = {lds32(a0p + c0), lds32(a1p + c0), lds32(a0p + c0 + 8),
                          lds32(a1p + c0 + 8)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* bn = wk + (size_t)n * 8 * s.cpad + c0;
          halo::mma_16816(acc[n], af, ldg32(bn), ldg32(bn + 8));
        }
      }
    }
  }

  // epilogue + store: c0,c1 -> row r0, cols 2q, 2q+1; c2,c3 -> row r1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tile = tile0 + rtile[h];
    if (tile >= s.T) continue;
    const size_t row = evrow + tile;
    const bool alive = live[row] != 0;
    const bool keep = alive && (!kEpilogue || mask[row * s.cells + rcell[h]]);
    __nv_bfloat16* orow = out + (row * s.cells + rcell[h]) * s.Cout;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * q;
      float z0 = acc[n][2 * h], z1 = acc[n][2 * h + 1];
      if (kEpilogue) {
        z0 = z0 * a[col] + b[col];
        z1 = z1 * a[col + 1] + b[col + 1];
        z0 = z0 >= 0.f ? z0 : alpha * z0;
        z1 = z1 >= 0.f ? z1 : alpha * z1;
      }
      if (!keep) z0 = z1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(z0, z1);
    }
  }
}

template <int NT, bool kEpilogue>
int launch(const void* x, const void* wt, const void* idx, const void* ok,
           const void* live, const void* a, const void* b, const void* mask,
           float alpha, void* out, int B, const Shape& s, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)s.tiles * s.ecells * s.sa;
  auto kernel = halo_conv_kernel<NT, kEpilogue>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (s.T + s.tiles - 1) / s.tiles;
  dim3 grid(groups * s.slices, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const int*)idx,
      (const uint8_t*)ok, (const uint8_t*)live, (const float*)a, (const float*)b,
      (const uint8_t*)mask, alpha, (__nv_bfloat16*)out, s);
  return (int)cudaGetLastError();
}

template <bool kEpilogue>
int dispatch(const void* x, const void* wt, const void* idx, const void* ok,
             const void* live, const void* a, const void* b, const void* mask,
             float alpha, void* out, int B, int T, int t, int dim, int Cin,
             int Cout, cudaStream_t stream) {
  if (dim < 2 || dim > 3 || t < 2 || Cin < 1 || Cout % 8 || Cout > 128)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.Cout = Cout;
  const int cells = ipow(t, dim);
  int tiles;
  if (cells <= kRows) {
    if (kRows % cells) return (int)cudaErrorInvalidValue;
    tiles = kRows / cells;
    s.slices = 1;
  } else {
    if (cells % kRows) return (int)cudaErrorInvalidValue;
    tiles = 1;
    s.slices = cells / kRows;
  }
  if (tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  s.cpad = (Cin + 15) / 16 * 16;
  s.init(T, t, dim, Cin, tiles, s.cpad, kPad, (uintptr_t)x % 16 == 0);
  switch (Cout / 8) {
#define HALO_CONV_CASE(N) \
  case N: return launch<N, kEpilogue>(x, wt, idx, ok, live, a, b, mask, alpha, out, B, s, stream);
    HALO_CONV_CASE(1) HALO_CONV_CASE(2) HALO_CONV_CASE(3) HALO_CONV_CASE(4)
    HALO_CONV_CASE(5) HALO_CONV_CASE(6) HALO_CONV_CASE(7) HALO_CONV_CASE(8)
    HALO_CONV_CASE(9) HALO_CONV_CASE(10) HALO_CONV_CASE(11) HALO_CONV_CASE(12)
    HALO_CONV_CASE(13) HALO_CONV_CASE(14) HALO_CONV_CASE(15) HALO_CONV_CASE(16)
#undef HALO_CONV_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bfloat16 tensors, f32 affine; wt is (K, Cout, round_up(Cin, 16)): the
// weights transposed and zero-padded. Returns a cudaError_t (0 = launched).
int halo_conv_raw(const void* x, const void* wt, const void* idx, const void* ok,
                  const void* live, void* out, int B, int T, int t, int dim,
                  int Cin, int Cout, void* stream) {
  return dispatch<false>(x, wt, idx, ok, live, nullptr, nullptr, nullptr, 1.f, out,
                         B, T, t, dim, Cin, Cout, (cudaStream_t)stream);
}

int halo_conv_bn_act(const void* x, const void* wt, const void* idx,
                     const void* ok, const void* live, const void* a,
                     const void* b, const void* mask, float alpha, void* out,
                     int B, int T, int t, int dim, int Cin, int Cout,
                     void* stream) {
  return dispatch<true>(x, wt, idx, ok, live, a, b, mask, alpha, out, B, T, t, dim,
                        Cin, Cout, (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
