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
// toeplitz_adjoint. Here the block stages extended tiles straight from plain
// (B, T, t^dim, C) rows through idx/ok (halo_stage.cuh, the staging of
// kernel B), so one kernel serves every (t, C), Cin = 1 included, and
// computes d_W itself.
//
// What bounds it on an H100: d_W is a GEMM with a tiny output (27 x Cin x
// Cout, at most 27x128x128 f32) and a reduction over millions of cells, so
// the work is the reduction: staging each tile's extended block and g rows
// (global loads, then shared-memory traffic), not tensor-core FLOPs. The
// output does not fit one block (27x80x80 f32 = 691 KB in training), and
// one atomic per tile per element would be ~1e9 atomics a call. Design:
// blocks split the output by (16-channel Cin slice, group of 9 offsets),
// one offset per warp, and split the cells by a grid-stride loop over
// chunks of 64 cells (one t=4 tile, eight t=2 tiles). Each warp keeps its
// 16 x Cout slice of d_W[k] in registers over all its chunks and adds it
// into global memory once, with atomics: about 1e6 atomics a call. Per
// chunk the block stages 16 input channels of the extended tiles and all
// Cout channels of g in shared memory; each warp runs mma.sync m16n8k16
// (bf16 in, f32 accumulate) with M = Cin slice, N = Cout, K = 16 cells,
// both operands loaded transposed by ldmatrix from the [cell][channel]
// rows (the A rows at the offset's shifted ext position). Dead tiles
// (blive = 0) stage g as zeros and add nothing; a chunk with no live tile
// is skipped. The f32 sums run in another order than the plain version's,
// so results agree to rounding, not bitwise.

#include "halo_stage.cuh"

namespace {

using halo::ipow;

constexpr int kWarps = 9;                 // one stencil offset per warp
constexpr int kThreads = kWarps * 32;
constexpr int kWidth = 16;                // input channels per block (MMA M)
constexpr int kPad = 8;                   // bf16 pad per smem row (bank spread)
constexpr int kChunk = 64;                // cells per chunk when a tile is smaller
constexpr int kMaxTiles = 16;             // tiles per chunk (dim 2, t = 2)
constexpr int kTargetBlocks = 132 * 4;    // about 4 resident blocks per SM
constexpr size_t kMaxSmem = 232448;       // dynamic shared memory a block may use

// the staging geometry (width = 16 channels at c_lo) plus the g side
struct DwShape : halo::Stage {
  int B, Cout;
  int sg;                    // g smem row stride (bf16)
  int chunk;                 // cells per chunk (tiles * cells)
  int kgroups;               // groups of kWarps offsets: K / kWarps
  int per_event;             // chunks per event
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

// x (B,T,cells,Cin) bf16, g (B,T,cells,Cout) bf16 (16-byte aligned),
// idx/ok (B,K-1,T), live (B,T), dw (K,Cin,Cout) f32, zeroed by the caller.
template <int NT>
__global__ void __launch_bounds__(kThreads)
halo_conv_dw_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    const int* __restrict__ idx, const uint8_t* __restrict__ ok,
                    const uint8_t* __restrict__ live, float* __restrict__ dw,
                    DwShape s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_lo = (blockIdx.y / s.kgroups) * kWidth;
  const int k = (blockIdx.y % s.kgroups) * kWarps + warp;   // this warp's offset
  const int doff = halo::offset_shift(k, s.dim, s.t + 2);

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ext_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* g_s = ext_s + (size_t)s.tiles * s.ecells * s.sa;
  int* erow = reinterpret_cast<int*>(g_s + (size_t)s.chunk * s.sg);
  __shared__ int nbr[kMaxTiles * 27];   // source row per (tile, offset), -1 = none
  __shared__ int any_live;

  // ext row of each chunk cell (tile j, cell p)
  for (int i = threadIdx.x; i < s.chunk; i += kThreads) {
    const int j = i / s.cells;
    erow[i] = j * s.ecells + halo::cell_ext_row(i - j * s.cells, s.t, s.dim);
  }

  // ldmatrix row of this lane: A (16 Cin x 16 cells) as four 8x8 matrices
  // (cells 0-7 | 8-15) x (channels 0-7 | 8-15); B (16 cells x 16 Cout)
  // as (cells 0-7 | 8-15) x (Cout n..n+7 | n+8..n+15)
  const int a_cell = ((lane >> 4) << 3) + (lane & 7);
  const int a_ch = ((lane >> 3) & 1) * 8;
  const int b_cell = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_ch = (lane >> 4) * 8;
  const int gvec = s.Cout / 8;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int total = s.B * s.per_event;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int ev = c / s.per_event;
    const int tile0 = (c - ev * s.per_event) * s.tiles;
    __syncthreads();          // the previous chunk's reads are done
    if (threadIdx.x == 0) any_live = 0;
    __syncthreads();
    halo::build_nbr(nbr, &any_live, idx, ok, live, ev, tile0, s);
    __syncthreads();
    if (!any_live) continue;

    const size_t evrow = (size_t)ev * s.T;
    halo::stage_ext(ext_s, x + evrow * s.cells * s.Cin, nbr, c_lo, s);
    const __nv_bfloat16* gev = g + evrow * s.cells * s.Cout;
    for (int i = threadIdx.x; i < s.chunk * gvec; i += kThreads) {
      const int cell = i / gvec;
      const int ch = (i - cell * gvec) * 8;
      const int j = cell / s.cells;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (nbr[j * s.K + s.K / 2] >= 0) {       // live tile
        const size_t src = ((size_t)(tile0 + j) * s.cells + cell - j * s.cells)
                           * s.Cout + ch;
        v = __ldg(reinterpret_cast<const uint4*>(gev + src));
      }
      *reinterpret_cast<uint4*>(g_s + (size_t)cell * s.sg + ch) = v;
    }
    __syncthreads();

    for (int k0 = 0; k0 < s.chunk; k0 += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af, ext_s + (size_t)(erow[k0 + a_cell] + doff) * s.sa + a_ch);
      const __nv_bfloat16* bp = g_s + (size_t)(k0 + b_cell) * s.sg + b_ch;
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bp + n * 8);
        halo::mma_16816(acc[n], af, bf[0], bf[1]);
        halo::mma_16816(acc[n + 1], af, bf[2], bf[3]);
      }
      if (NT & 1) {
        uint32_t bf[2];
        ldsm_x2_trans(bf, bp + (NT - 1) * 8);
        halo::mma_16816(acc[NT - 1], af, bf[0], bf[1]);
      }
    }
  }

  // c0,c1 -> (ci = c_lo + g, co = 8n + 2q, +1); c2,c3 -> ci + 8
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = c_lo + gq + 8 * h;
    if (ci >= s.Cin) continue;
    float* row = dw + ((size_t)k * s.Cin + ci) * s.Cout;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      atomicAdd(row + n * 8 + 2 * q, acc[n][2 * h]);
      atomicAdd(row + n * 8 + 2 * q + 1, acc[n][2 * h + 1]);
    }
  }
}

template <int NT>
int launch(const void* x, const void* g, const void* idx, const void* ok,
           const void* live, void* dw, const DwShape& s, size_t smem,
           cudaStream_t stream) {
  auto kernel = halo_conv_dw_kernel<NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (s.Cin + kWidth - 1) / kWidth;
  const int gy = mtiles * s.kgroups;
  const int total = s.B * s.per_event;
  int gx = kTargetBlocks / gy;
  gx = gx < 1 ? 1 : (gx > total ? total : gx);
  dim3 grid(gx, gy);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (const int*)idx,
      (const uint8_t*)ok, (const uint8_t*)live, (float*)dw, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, g bfloat16 (g 16-byte aligned), dw (K, Cin, Cout) float32 zeroed by
// the caller; Cout a multiple of 8 up to 128. Returns a cudaError_t
// (0 = launched).
int halo_conv_dw(const void* x, const void* g, const void* idx, const void* ok,
                 const void* live, void* dw, int B, int T, int t, int dim,
                 int Cin, int Cout, void* stream) {
  if (dim < 2 || dim > 3 || t < 2 || Cin < 1 || Cout % 8 || Cout > 128 ||
      (uintptr_t)g % 16)
    return (int)cudaErrorInvalidValue;
  const int cells = ipow(t, dim);
  int tiles;
  if (cells <= kChunk) {
    if (kChunk % cells) return (int)cudaErrorInvalidValue;
    tiles = kChunk / cells;
  } else {
    if (cells % 16) return (int)cudaErrorInvalidValue;
    tiles = 1;
  }
  if (tiles > kMaxTiles) return (int)cudaErrorInvalidValue;
  DwShape s;
  s.init(T, t, dim, Cin, tiles, kWidth, kPad, (uintptr_t)x % 16 == 0);
  s.B = B;
  s.Cout = Cout;
  s.sg = Cout + kPad;
  s.chunk = tiles * cells;
  s.kgroups = s.K / kWarps;
  s.per_event = (T + tiles - 1) / tiles;
  const size_t smem = sizeof(__nv_bfloat16) *
                          ((size_t)tiles * s.ecells * s.sa + (size_t)s.chunk * s.sg) +
                      sizeof(int) * (size_t)s.chunk;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (Cout / 8) {
#define HALO_CONV_DW_CASE(N) \
  case N: return launch<N>(x, g, idx, ok, live, dw, s, smem, st);
    HALO_CONV_DW_CASE(1) HALO_CONV_DW_CASE(2) HALO_CONV_DW_CASE(3) HALO_CONV_DW_CASE(4)
    HALO_CONV_DW_CASE(5) HALO_CONV_DW_CASE(6) HALO_CONV_DW_CASE(7) HALO_CONV_DW_CASE(8)
    HALO_CONV_DW_CASE(9) HALO_CONV_DW_CASE(10) HALO_CONV_DW_CASE(11) HALO_CONV_DW_CASE(12)
    HALO_CONV_DW_CASE(13) HALO_CONV_DW_CASE(14) HALO_CONV_DW_CASE(15) HALO_CONV_DW_CASE(16)
#undef HALO_CONV_DW_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
