// Kernel A: the tile-link gathers, for Hopper (sm_90a).
//
// A down link joins a fine tile grid (tile edge t_f) to a coarse one (edge
// t_c, each coarse tile has 2^dim child tiles, one per octant o, x-major
// bits). Each direction is one launch over all octants, written straight
// into the layout the caller needs (th = t_c / 2, C channels a cell):
//
//   assemble  out[b, c, k, :] = ok[b, o, c] ? src[b, idx[b, o, c], h, :] : 0
//             src (B, S, th^dim, C) half-blocks of the fine tiles,
//             out (B, N, t_c^dim, C) coarse tiles; (o, h) are the octant
//             and the cell of the half-block that coarse cell k lies in
//             (its x-major digits split into a high bit and th low bits).
//   parent    out[b, f, h, :] = ok[b, f] ? src[b, j >> dim, k(j & 2^dim-1, h), :] : 0
//             src (B, S, t_c^dim, C) coarse tiles, out (B, N, th^dim, C):
//             each fine tile reads its own corner of its parent, j being
//             parent * 2^dim + octant, k the coarse cell of cell h of that
//             octant's corner.
//
// With dim = 0 (one octant, one cell) `assemble` is the single-spec row
// gather out[b, i, :] = ok[b, i] ? src[b, idx[b, i], :] : 0. Rows whose
// index lies outside the source read as zeros.
//
// Replaces the TPU kernel uresnet_pytorch_tpu/ops/pallas/windowed_gather.py
// gather_forward (_kernel) and the per-octant loops around it
// (uresnet_pytorch_tpu/ops/tile_conv.py _assemble_impl and
// _parent_corner_impl): there, rows move as block one-hot MXU matmuls
// against DMA'd source windows, plus an exact correction list, one call per
// octant, then a zero fill and slice updates (assemble) or a sum of the
// octants' disjoint results over a corner-view copy (parent). Hopper has a
// cheap indexed load, so this kernel reads each source vector directly and
// writes each output vector once: no windows, no zero fill, no copies, no
// adds, exact for any index pattern.
//
// What bounds it on an H100: HBM bandwidth (it computes nothing; a cell is
// 2 B to 160 B). Design: one thread per output vector, of the widest width
// (16 B down to 1 B) that divides a cell's bytes and both base addresses,
// so a warp's stores are contiguous and every lane works at any width; the
// batch on blockIdx.y (no 64-bit division); cells and octants by shifts
// (t_c and the cell counts are powers of two); one 32-bit division by the
// vectors a cell. A row's idx/ok are read by each of its threads and served
// from L1. One wave of grid-stride blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// lt = log2(t_c); lo / ls = log2 of the out / src cells a row
template <typename V, bool kParent>
__global__ void __launch_bounds__(kThreads)
link_gather_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                   const uint8_t* __restrict__ ok, V* __restrict__ out, int N,
                   int S, int lt, int dim, int lo, int ls, unsigned nv) {
  const int b = blockIdx.y;
  const unsigned total = ((unsigned)N << lo) * nv;
  const int lh = lt - 1;   // log2(th)
  src += (size_t)b * S * ((size_t)nv << ls);
  out += (size_t)b * N * ((size_t)nv << lo);
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total;
       e += gridDim.x * kThreads) {
    const unsigned rc = e / nv;
    const unsigned v = e - rc * nv;
    const unsigned r = rc >> lo;
    const unsigned k = rc & ((1u << lo) - 1);
    int s;
    bool live;
    unsigned ks = 0;
    if (kParent) {
      const int j = idx[(size_t)b * N + r];
      live = ok[(size_t)b * N + r] && j >= 0 && (j >> dim) < S;
      s = j >> dim;
      // cell k = h of the corner; its digit d gains the octant's bit d
      for (int d = 0; d < dim; ++d) {
        const int sh = dim - 1 - d;
        const unsigned hd = (k >> (lh * sh)) & ((1u << lh) - 1);
        const unsigned bit = (j >> sh) & 1;
        ks = (ks << lt) | (bit << lh) | hd;
      }
    } else {
      // coarse cell k: digit d's high bit is the octant's bit d, its low
      // lh bits the half-block cell's digit d
      unsigned o = 0;
      for (int d = 0; d < dim; ++d) {
        const unsigned pd = (k >> (lt * (dim - 1 - d))) & ((1u << lt) - 1);
        o = (o << 1) | (pd >> lh);
        ks = (ks << lh) | (pd & ((1u << lh) - 1));
      }
      const size_t at = ((size_t)b << dim | o) * N + r;
      s = idx[at];
      live = ok[at] && s >= 0 && s < S;
    }
    V val{};
    if (live) val = src[(((size_t)s << ls) + ks) * nv + v];
    out[(size_t)rc * nv + v] = val;
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

template <typename V, bool kParent>
int launch(const void* src, const void* idx, const void* ok, void* out, int B,
           int N, int S, int cell_bytes, int lt, int dim,
           cudaStream_t stream) {
  const int lc = lt * dim, lhc = (lt - 1) * dim;   // log2 of t_c^dim, th^dim
  const int lo = kParent ? lhc : lc, ls = kParent ? lc : lhc;
  const unsigned nv = (unsigned)(cell_bytes / (int)sizeof(V));
  const unsigned long long total = ((unsigned long long)N << lo) * nv;
  if (total == 0 || B == 0) return 0;
  if (total > 0xFFFFFFFFull) return (int)cudaErrorInvalidValue;
  // one wave: 8 blocks of 256 threads an SM, shared by the batch
  const unsigned long long need = (total + kThreads - 1) / kThreads;
  const unsigned long long wave =
      ((unsigned long long)sm_count() * 8 + B - 1) / B;
  const unsigned gx = (unsigned)(need < wave ? need : wave);
  link_gather_kernel<V, kParent><<<dim3(gx, B), kThreads, 0, stream>>>(
      (const V*)src, (const int*)idx, (const uint8_t*)ok, (V*)out, N, S, lt,
      dim, lo, ls, nv);
  return (int)cudaGetLastError();
}

template <bool kParent>
int dispatch(const void* src, const void* idx, const void* ok, void* out,
             int B, int N, int S, int cell_bytes, int lt, int dim,
             void* stream) {
  if (B < 0 || N < 0 || S < 0 || cell_bytes <= 0 || dim < 0 || dim > 3 ||
      lt < 1 || lt > 3 || (kParent && dim == 0))
    return (int)cudaErrorInvalidValue;
  // widest vector that divides a cell's bytes and both base addresses
  const uintptr_t a = (uintptr_t)src | (uintptr_t)out | (uintptr_t)cell_bytes;
  cudaStream_t st = (cudaStream_t)stream;
#define A_LAUNCH(V) \
  launch<V, kParent>(src, idx, ok, out, B, N, S, cell_bytes, lt, dim, st)
  if (a % 16 == 0) return A_LAUNCH(uint4);
  if (a % 8 == 0) return A_LAUNCH(uint2);
  if (a % 4 == 0) return A_LAUNCH(uint32_t);
  if (a % 2 == 0) return A_LAUNCH(uint16_t);
  return A_LAUNCH(uint8_t);
#undef A_LAUNCH
}

}  // namespace

extern "C" {

// assemble: src (B, S, th^dim, C) with cell_bytes = C * element size, idx /
// ok (B, 2^dim, N) int32 / bool, out (B, N, t_c^dim, C); t_c = 2^lt, dim 0-3
// (dim 0: the single-spec gather, src (B, S, C), idx / ok (B, N)).
// Returns a cudaError_t (0 = launched).
int link_assemble(const void* src, const void* idx, const void* ok,
                  void* out, int B, int N, int S, int cell_bytes, int lt,
                  int dim, void* stream) {
  return dispatch<false>(src, idx, ok, out, B, N, S, cell_bytes, lt, dim,
                         stream);
}

// parent: src (B, S, t_c^dim, C), idx / ok (B, N) with idx = parent * 2^dim
// + octant, out (B, N, th^dim, C); t_c = 2^lt, dim 1-3.
int link_parent(const void* src, const void* idx, const void* ok, void* out,
                int B, int N, int S, int cell_bytes, int lt, int dim,
                void* stream) {
  return dispatch<true>(src, idx, ok, out, B, N, S, cell_bytes, lt, dim,
                        stream);
}

}  // extern "C"
