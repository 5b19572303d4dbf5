// Kernels D and E: the standalone halo extend of tiles and its transpose, for
// Hopper (sm_90a).
//
//   D  ext[b, j, e, :] = x[b, j, s, :]           e a body cell of tile j
//                        x[b, idx[b,k,j], s, :]  e in offset k's slab, ok[b,k,j]
//                        0                       otherwise
//   E  d_x[b, j, s, :] = g[b, j, body(s), :], then for each offset k whose
//                        slab holds s, in ascending k:
//                        + (ok[b,K-1-k,j] ? g[b, idx[b,K-1-k,j], e_k(s), :] : 0)
//                        rounded to the dtype after every add
//
// x (B, T, t^dim, C), ext and g (B, T, (t+2h)^dim, C), channels last, at a
// halo width h of 1 (the 3^dim stencil) or 2 (the 5^dim stencil: two
// layers of the same 26 neighbors, h <= t); idx/ok
// (B, 3^dim - 1, T) are the halo maps of ops/halo.py (offsets in
// halo_offsets order: -delta_k is offset K-1-k). Every row is computed, dead
// ones included: this is ops/halo.py's halo26_extend and halo26_transpose on
// every row, bit for bit (E adds in the order and dtype of the plain
// version, a missing neighbor adding +0.0 as there, so the two agree bitwise
// in bf16 and f32).
//
// Replace the TPU kernels in uresnet_pytorch_tpu/ops/pallas/halo_fused.py:
//   halo26_fwd (:410, pallas_call at :455) -> D (halo_extend below)
//   halo26_bwd (:469, pallas_call at :515) -> E (halo_transpose below)
// Those gather each neighbor slab with a one-hot MXU matmul over a window of
// lane-presliced rows, with patch rows and a correction list for neighbors
// outside the window, because a TPU has no cheap row gather. Hopper loads
// rows by index, so nothing of that comes across: each thread reads its
// cell's source rows through idx/ok directly.
//
// What bounds them on an H100: bytes. They compute nothing (E adds at most
// 2^dim - 1 values per element at h = 1, up to 3^dim - 1 at h = 2 on t = 2).
// D writes B*T*(t+2h)^dim*C*itemsize and reads
// B*T*t^dim*C*itemsize once from HBM (a source row is read by up to 2^dim
// tiles, the repeats mostly from L2); E reads the extended cells that have a
// source and writes the second. What keeps a row mover from HBM's rate is
// too few independent loads in flight, so:
//   - a unit is `vec` bytes of one cell's row (the widest vector dividing
//     the row and the input's address);
//   - D: a piece is `per_piece` consecutive units of one tile stored as one
//     vector of up to 16 bytes (so narrow rows, 2 bytes a cell at C = 1,
//     still store 16 bytes a thread), and a thread takes `pieces` pieces
//     (kThreads apart, so a warp's stores are contiguous), four units in
//     all, issuing every load before its first store; stores are
//     evict-first;
//   - E: a thread takes one unit a step and issues its body load and all
//     of its slab loads (unrolled, predicated on the table's count and on
//     the neighbor) before its first add. Wider pieces or more units a
//     thread cost E registers and measured slower (PERF.md);
//   - a block takes `tiles` consecutive tile rows (about 2048 units) and
//     first reads their neighbor rows into shared memory with the tile
//     index fastest, so the map reads coalesce.
// The split is chosen on the host (ops/cuda/halo_extend.py: extend_plan)
// and so is the static cell geometry (extend_table), a small uint16 table in
// global memory (D reads it through the read-only cache, E stages it in
// shared memory):
//   D: for each ext cell e, (3^dim stencil offset or center) << 10 | source
//      cell;
//   E: for each source cell s, W entries (8, or 32 where a cell lies in
//      more than 7 slabs): (its slab count n) << 10 | its body ext cell,
//      then the (negated offset) << 10 | ext cell of each of the n slabs
//      that hold it, in ascending offset order, then 0xFFFF.

#include <cstring>

#include "halo_stage.cuh"

namespace {

using halo::FastDiv;
using halo::ipow;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 64;      // tiles per block
constexpr int kMaxEntries = 4096;  // E's table in shared memory (uint16)

template <int N> struct Vec;       // an N-byte vector type
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

struct Geo {
  int rows;              // B * T
  int T, cells, ecells, Kf, nvec, tiles;
  int units;             // this kernel's output units per tile
  int pieces;            // output pieces per tile (units / per_piece)
  FastDiv by_T, by_tiles, by_pieces, by_vec;
};

// nbr[jj * Kf + k]: the absolute source row of full stencil offset k (the
// center: the tile itself) for the block's tile jj, or -1 where the neighbor
// is missing, out of range, or the tile is past the end. Reads the maps with
// the tile index fastest across threads, so each offset's read coalesces.
__device__ __forceinline__ void load_tiles(int* nbr, int row0,
                                           const int* __restrict__ idx,
                                           const uint8_t* __restrict__ ok,
                                           const Geo& g) {
  const int center = g.Kf / 2;
  for (int i = threadIdx.x; i < g.tiles * g.Kf; i += blockDim.x) {
    const int k = (int)g.by_tiles.div((unsigned)i);
    const int jj = i - k * g.tiles;
    const int row = row0 + jj;
    int r = -1;
    if (row < g.rows) {
      const int b = (int)g.by_T.div((unsigned)row);
      const int j = row - b * g.T;
      if (k == center) {
        r = row;
      } else {
        const long long m =
            ((long long)b * (g.Kf - 1) + (k < center ? k : k - 1)) * g.T + j;
        const int cand = idx[m];
        r = ok[m] && cand >= 0 && cand < g.T ? b * g.T + cand : -1;
      }
    }
    nbr[jj * g.Kf + k] = r;
  }
}

// unit v of cell c of row r, or zeros where r < 0
template <typename V>
__device__ __forceinline__ V load_unit(const V* base, int r, int c, int v,
                                       const Geo& g, int cells) {
  V val{};
  if (r >= 0) val = __ldg(base + ((long long)r * cells + c) * g.nvec + v);
  return val;
}

// D: VB-byte units, M units a piece, P pieces a thread.
template <int VB, int M, int P>
__global__ void __launch_bounds__(kThreads)
halo_extend_kernel(const typename Vec<VB>::T* __restrict__ x,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ ok,
                   const uint16_t* __restrict__ tab,
                   char* __restrict__ ext, const Geo g) {
  using V = typename Vec<VB>::T;
  using S = typename Vec<VB * M>::T;
  __shared__ int nbr[kMaxTiles * 27];
  const int row0 = blockIdx.x * g.tiles;
  load_tiles(nbr, row0, idx, ok, g);
  __syncthreads();
  const int total = g.tiles * g.pieces;
  for (int p0 = threadIdx.x; p0 < total; p0 += kThreads * P) {
    V val[P][M];
    long long dst[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int p = p0 + q * kThreads;
      const int jj = (int)g.by_pieces.div((unsigned)p);
      const int pc = p - jj * g.pieces;
      const bool live = p < total && row0 + jj < g.rows;
      dst[q] = live ? ((long long)(row0 + jj) * g.pieces + pc) : -1;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int u = pc * M + i;
        const int e = (int)g.by_vec.div((unsigned)u);
        const int v = u - e * g.nvec;
        const uint32_t code = live ? __ldg(tab + e) : 0u;
        const int r = live ? nbr[jj * g.Kf + (int)(code >> 10)] : -1;
        val[q][i] = load_unit(x, r, (int)(code & 1023u), v, g, g.cells);
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (dst[q] < 0) continue;
      S out;
      memcpy(&out, val[q], sizeof(S));
      // evict-first: ext is read by the next kernel, not by this one,
      // while x's rows are read again by the neighbor tiles
      __stcs(reinterpret_cast<S*>(ext) + dst[q], out);
    }
  }
}

// a + b elementwise over a vector of E, rounded to E: f32 adds, or bf16
// adds two at a time (add.rn.bf16x2). torch adds bf16 in f32 and rounds the
// f32 sum to bf16; that double rounding equals one rounding of the exact
// sum, because the f32 sum of two bf16 values is inexact only when one is
// below 2^-16 of the other, far under half a bf16 ulp, and then no tie
// arises. Fewer registers than widening each value to f32 (PERF.md).
template <typename E, typename V>
__device__ __forceinline__ V vadd(V a, const V& b) {
  if constexpr (sizeof(E) == 4) {
    constexpr int n = sizeof(V) / 4;
    float ea[n], eb[n];
    memcpy(ea, &a, sizeof(V));
    memcpy(eb, &b, sizeof(V));
#pragma unroll
    for (int i = 0; i < n; ++i) ea[i] = __fadd_rn(ea[i], eb[i]);
    memcpy(&a, ea, sizeof(V));
  } else if constexpr (sizeof(V) == 2) {
    __nv_bfloat16 ea, eb;
    memcpy(&ea, &a, 2);
    memcpy(&eb, &b, 2);
    ea = __hadd(ea, eb);
    memcpy(&a, &ea, 2);
  } else {
    constexpr int n = sizeof(V) / 4;
    __nv_bfloat162 ea[n], eb[n];
    memcpy(ea, &a, sizeof(V));
    memcpy(eb, &b, sizeof(V));
#pragma unroll
    for (int i = 0; i < n; ++i) ea[i] = __hadd2(ea[i], eb[i]);
    memcpy(&a, ea, sizeof(V));
  }
  return a;
}

// E: one VB-byte unit a thread per step, added in the element type E. The
// unit's body load and its n <= W - 1 slab loads (n from the table of W
// entries a cell) are all issued before the first add; a missing
// neighbor's term loads +0.0 and is added as in the plain version.
template <int VB, typename E, int W>
__global__ void __launch_bounds__(kThreads)
halo_transpose_kernel(const typename Vec<VB>::T* __restrict__ gr,
                      const int* __restrict__ idx,
                      const uint8_t* __restrict__ ok,
                      const uint16_t* __restrict__ tab,
                      char* __restrict__ dx, const Geo g) {
  using V = typename Vec<VB>::T;
  constexpr int kSlabs = W - 1;    // slabs a cell at most
  __shared__ int nbr[kMaxTiles * 27];
  __shared__ uint4 stab[kMaxEntries / 8];   // W entries a cell
  const int row0 = blockIdx.x * g.tiles;
  load_tiles(nbr, row0, idx, ok, g);
  for (int i = threadIdx.x; i < g.cells * (W / 8); i += blockDim.x)
    stab[i] = __ldg(reinterpret_cast<const uint4*>(tab) + i);
  __syncthreads();
  const uint16_t* entries = reinterpret_cast<const uint16_t*>(stab);
  const int total = g.tiles * g.units;
  for (int u = threadIdx.x; u < total; u += kThreads) {
    const int jj = (int)g.by_pieces.div((unsigned)u);   // a piece: a unit
    const int row = row0 + jj;
    if (row >= g.rows) break;          // units ascend with the tile
    const int rest = u - jj * g.units;
    const int s = (int)g.by_vec.div((unsigned)rest);
    const int v = rest - s * g.nvec;
    const uint16_t* w = entries + s * W;
    const int n = w[0] >> 10;
    V acc = load_unit(gr, row, w[0] & 1023, v, g, g.ecells);
    V val[kSlabs];
#pragma unroll
    for (int i = 0; i < kSlabs; ++i) {
      int r = -1, c = 0;
      if (i < n) {
        const int code = w[i + 1];
        r = nbr[jj * g.Kf + (code >> 10)];
        c = code & 1023;
      }
      val[i] = load_unit(gr, r, c, v, g, g.ecells);
    }
#pragma unroll
    for (int i = 0; i < kSlabs; ++i)
      if (i < n) acc = vadd<E>(acc, val[i]);
    reinterpret_cast<V*>(dx)[(long long)row * g.units + rest] = acc;
  }
}

// Entries a source cell of E's table (ops/cuda/halo_extend.py:
// table_width): 8, or 32 where a halo of 2 on t = 2 puts a cell in all 26
// slabs.
int table_width(int t, int h) { return h == 1 || t >= 2 * h ? 8 : 32; }

// The launch geometry from the host's plan, or a cudaError_t for a plan or
// arguments the kernels refuse.
int geometry(int B, int T, int t, int dim, int h, int row_bytes, int vec,
             int store, int per_piece, int tiles, bool transpose, Geo* g) {
  if (B < 1 || T < 1 || row_bytes < 1 || dim < 2 || dim > 3 || t < 2 ||
      t > 8 || h < 1 || h > 2 || h > t || tiles < 1 || tiles > kMaxTiles ||
      vec < 2 || vec > 16 ||
      (vec & (vec - 1)) || row_bytes % vec || store != vec * per_piece ||
      store > 16 || (long long)B * T + tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  g->rows = B * T;
  g->T = T;
  g->cells = ipow(t, dim);
  g->ecells = ipow(t + 2 * h, dim);
  g->Kf = ipow(3, dim);
  g->nvec = row_bytes / vec;
  g->tiles = tiles;
  const int cells_out = transpose ? g->cells : g->ecells;
  if (g->ecells > 1024 || g->cells * table_width(t, h) > kMaxEntries ||
      (cells_out * row_bytes) % store)
    return (int)cudaErrorInvalidValue;
  g->units = cells_out * g->nvec;
  g->pieces = g->units / per_piece;
  g->by_T = FastDiv(T);
  g->by_tiles = FastDiv(tiles);
  g->by_pieces = FastDiv(g->pieces);
  g->by_vec = FastDiv(g->nvec);
  return 0;
}

unsigned blocks(const Geo& g) {
  return (unsigned)((g.rows + g.tiles - 1) / g.tiles);
}

template <int VB, int M, int P>
int launch_extend(const void* x, const void* idx, const void* ok,
                  const void* tab, void* ext, const Geo& g, cudaStream_t st) {
  halo_extend_kernel<VB, M, P><<<blocks(g), kThreads, 0, st>>>(
      (const typename Vec<VB>::T*)x, (const int*)idx, (const uint8_t*)ok,
      (const uint16_t*)tab, (char*)ext, g);
  return (int)cudaGetLastError();
}

template <int VB, typename E, int W>
int launch_transpose(const void* gr, const void* idx, const void* ok,
                     const void* tab, void* dx, const Geo& g,
                     cudaStream_t st) {
  halo_transpose_kernel<VB, E, W><<<blocks(g), kThreads, 0, st>>>(
      (const typename Vec<VB>::T*)gr, (const int*)idx, (const uint8_t*)ok,
      (const uint16_t*)tab, (char*)dx, g);
  return (int)cudaGetLastError();
}

// The splits extend_plan makes. D: (vec, per_piece), four units a thread
// (pieces = 4 / per_piece, at least 1).
#define D_PLANS(X)                                                      \
  X(16, 1) X(8, 1) X(8, 2) X(4, 1) X(4, 2) X(4, 4) X(2, 1) X(2, 2)     \
  X(2, 4) X(2, 8)
// E: (vec), one unit a piece and a thread.
#define E_PLANS(X) X(16) X(8) X(4) X(2)

int dispatch_extend(const void* x, const void* idx, const void* ok,
                    const void* tab, void* ext, const Geo& g, int vec,
                    int per_piece, int pieces, cudaStream_t st) {
#define X(VB, M)                                                        \
  if (vec == VB && per_piece == M && pieces == (M < 4 ? 4 / M : 1))     \
    return launch_extend<VB, M, (M < 4 ? 4 / M : 1)>(x, idx, ok, tab,   \
                                                      ext, g, st);
  D_PLANS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int dispatch_transpose(const void* gr, const void* idx, const void* ok,
                       const void* tab, void* dx, const Geo& g, int vec,
                       int per_piece, int pieces, int width,
                       cudaStream_t st) {
#define X(VB)                                                           \
  if constexpr (VB % sizeof(E) == 0) {                                  \
    if (vec == VB && per_piece == 1 && pieces == 1) {                   \
      if (width == 8)                                                   \
        return launch_transpose<VB, E, 8>(gr, idx, ok, tab, dx, g, st); \
      if (width == 32)                                                  \
        return launch_transpose<VB, E, 32>(gr, idx, ok, tab, dx, g,     \
                                           st);                         \
    }                                                                   \
  }
  E_PLANS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel D at halo width h. row_bytes = C * itemsize; (vec, store,
// per_piece, pieces, tiles) is extend_plan's split of
// ops/cuda/halo_extend.py and `table` its extend_table("d", t, dim, h) on
// the device. Returns a cudaError_t (0 = launched).
int halo_extend(const void* x, const void* idx, const void* ok,
                const void* table, void* ext, int B, int T, int t, int dim,
                int h, int row_bytes, int vec, int store, int per_piece,
                int pieces, int tiles, void* stream) {
  Geo g;
  const int err = geometry(B, T, t, dim, h, row_bytes, vec, store,
                           per_piece, tiles, false, &g);
  if (err) return err;
  return dispatch_extend(x, idx, ok, table, ext, g, vec, per_piece, pieces,
                         (cudaStream_t)stream);
}

// Kernel E, in bfloat16 (is_f32 = 0) or float32 (is_f32 = 1, vec >= 4),
// with extend_table("e", t, dim, h), whose width (entries a cell) is 8
// unless h = 2 on t = 2 (32: every cell in all 26 slabs). Otherwise as
// halo_extend.
int halo_transpose(const void* g_ext, const void* idx, const void* ok,
                   const void* table, void* dx, int B, int T, int t, int dim,
                   int h, int row_bytes, int vec, int store, int per_piece,
                   int pieces, int tiles, int is_f32, void* stream) {
  Geo g;
  const int err = geometry(B, T, t, dim, h, row_bytes, vec, store,
                           per_piece, tiles, true, &g);
  if (err) return err;
  const int width = table_width(t, h);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    return dispatch_transpose<float>(g_ext, idx, ok, table, dx, g, vec,
                                     per_piece, pieces, width, st);
  return dispatch_transpose<__nv_bfloat16>(g_ext, idx, ok, table, dx, g, vec,
                                           per_piece, pieces, width, st);
}

}  // extern "C"
