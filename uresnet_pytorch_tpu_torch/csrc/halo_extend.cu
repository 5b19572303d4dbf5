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
// x (B, T, t^dim, C), ext and g (B, T, (t+2)^dim, C), channels last; idx/ok
// (B, 3^dim - 1, T) are the halo maps of ops/halo.py (offsets in
// halo_offsets order: -delta_k is offset K-1-k). Every row is computed, dead
// ones included: this is ops/halo.py's halo26_extend and halo26_transpose on
// every row, bit for bit (E adds in the order and dtype of the plain
// version, so the two agree bitwise in bf16 and f32).
//
// Replace the TPU kernels in uresnet_pytorch_tpu/ops/pallas/halo_fused.py:
//   halo26_fwd (:410, pallas_call at :455) -> D (halo_extend below)
//   halo26_bwd (:469, pallas_call at :515) -> E (halo_transpose below)
// Those gather each neighbor slab with a one-hot MXU matmul over a window of
// lane-presliced rows, with patch rows and a correction list for neighbors
// outside the window, because a TPU has no cheap row gather. Hopper loads
// rows by index, so nothing of that comes across: each thread reads its
// cell's source row through idx/ok directly.
//
// What bounds them on an H100: bytes. They compute nothing (E adds at most
// 2^dim - 1 values per element). D writes B*T*(t+2)^dim*C*itemsize and reads
// B*T*t^dim*C*itemsize once from HBM (a source row is read by up to 2^dim
// tiles, the repeats mostly from L2); E reads the first and writes the
// second. At config 3's level 0 (8 x 29184 tiles, t = 4, C = 16, bf16) that
// is about 2.1 GB, 0.6 ms at 3.35 TB/s. Design: a block takes a few tiles
// (about 2048 (cell, vector) units), reads their 3^dim neighbor rows once
// into shared memory, and its threads walk the units in output order, so
// stores are coalesced and loads of one slab row are contiguous. Each unit
// moves one vector of the widest width (16, 8, 4 or 2 bytes) that divides
// the row of C channels and both base addresses: at C*itemsize <= 16 one
// load and one store move a cell's channels. The cell geometry (slab_cells
// / body_cells of ops/halo.py) is a static table in constant memory, built
// once per device and copied to shared memory by each block:
//   D: for each ext cell e, (3^dim stencil offset or center, source cell s);
//   E: for each source cell s, its body cell and the (negated offset, ext
//      cell) of every slab that holds it, in ascending offset order.

#include <cstring>
#include <mutex>
#include <vector>

#include "halo_stage.cuh"

namespace {

using halo::FastDiv;
using halo::ipow;

constexpr int kThreads = 256;
constexpr int kUnits = 2048;       // (cell, vector) units per block, about
constexpr int kMaxTiles = 64;      // tiles per block
constexpr int kMaxDevices = 64;
// the tile sizes with tables: every power of two the config takes up to 8
constexpr int kNumT = 3;           // t = 2, 4, 8
constexpr int kMaxExtCells = 1000;           // (8 + 2)^3
constexpr int kMaxSrcWords = 512 * 8;        // 8^3 cells x 2^3 words
// D tables: sum over dim 2, 3 and t of (t+2)^dim; E tables: t^dim * 2^dim
constexpr int kTabWords = (16 + 36 + 100) + (64 + 216 + 1000)
                          + (4 + 16 + 64) * 4 + (8 + 64 + 512) * 8;

__constant__ uint32_t c_tab[kTabWords];

struct TabIndex {
  int ext_cells;   // offset of the D table: ext cell -> (offset << 16 | s)
  int src_cells;   // offset of the E table: 2^dim words per source cell
};

struct Geo {
  long long rows;        // B * T
  int T, cells, ecells, K, nvec, tiles;
  int tab;               // offset of this (t, dim)'s table in c_tab
  int words;             // E: table words per source cell (2^dim)
  FastDiv by_tile, by_vec;   // units per tile, vectors per cell
};

std::mutex g_mu;
std::vector<uint32_t> g_host;
TabIndex g_index[2][kNumT];
bool g_ready[kMaxDevices];

// The geometry of ops/halo.py for every (dim, t) with a table, in one
// buffer. Cells are row-major, last axis fastest; stencil offsets are
// base-3 digits (delta + 1), first axis most significant, so the center is
// K / 2 and negation maps offset k to K - 1 - k.
void build_tables() {
  for (int dim = 2; dim <= 3; ++dim) {
    const int K = ipow(3, dim);
    for (int i = 0; i < kNumT; ++i) {
      const int t = 2 << i, E = t + 2;
      const int cells = ipow(t, dim), ecells = ipow(E, dim);
      g_index[dim - 2][i].ext_cells = (int)g_host.size();
      for (int e = 0; e < ecells; ++e) {
        int rem = e, k = 0, s = 0, mk = 1, ms = 1;
        for (int ax = 0; ax < dim; ++ax) {   // last axis first
          const int ea = rem % E;
          rem /= E;
          // ext coord 0 <- the -1 neighbor's cell t-1, t+1 <- the +1
          // neighbor's cell 0, 1..t <- the tile's own cells
          k += (ea == 0 ? 0 : ea == t + 1 ? 2 : 1) * mk;
          s += (ea == 0 ? t - 1 : ea == t + 1 ? 0 : ea - 1) * ms;
          mk *= 3;
          ms *= t;
        }
        g_host.push_back((uint32_t)k << 16 | (uint32_t)s);
      }
      g_index[dim - 2][i].src_cells = (int)g_host.size();
      for (int s = 0; s < cells; ++s) {
        int a[3], rem = s;
        for (int ax = dim - 1; ax >= 0; --ax) {
          a[ax] = rem % t;
          rem /= t;
        }
        int body = 0;
        for (int ax = 0; ax < dim; ++ax) body = body * E + a[ax] + 1;
        std::vector<uint32_t> slabs;
        for (int k = 0; k < K; ++k) {
          if (k == K / 2) continue;
          int digit[3], rk = k, e = 0;
          bool holds = true;
          for (int ax = dim - 1; ax >= 0; --ax) {
            digit[ax] = rk % 3;
            rk /= 3;
          }
          for (int ax = 0; ax < dim; ++ax) {
            int ea = a[ax] + 1;
            if (digit[ax] == 0) {          // delta -1: ext 0 holds cell t-1
              holds = holds && a[ax] == t - 1;
              ea = 0;
            } else if (digit[ax] == 2) {   // delta +1: ext t+1 holds cell 0
              holds = holds && a[ax] == 0;
              ea = t + 1;
            }
            e = e * E + ea;
          }
          // the tile whose slab k holds s is s's tile's neighbor at -delta_k
          if (holds) slabs.push_back((uint32_t)(K - 1 - k) << 16 | (uint32_t)e);
        }
        g_host.push_back((uint32_t)slabs.size() << 16 | (uint32_t)body);
        g_host.insert(g_host.end(), slabs.begin(), slabs.end());
        // t >= 2: at most one extra slab choice per axis, 2^dim - 1 slabs
        g_host.resize(g_host.size() + (1 << dim) - 1 - slabs.size(), 0u);
      }
    }
  }
}

// This (t, dim)'s table offsets; uploads the tables to the current device
// on its first use there (a synchronous copy, once per device).
int tables(int t, int dim, TabIndex* out) {
  int slot = -1;
  for (int i = 0; i < kNumT; ++i)
    if (t == 2 << i) slot = i;
  if (slot < 0 || dim < 2 || dim > 3) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_host.empty()) build_tables();
  if ((int)g_host.size() != kTabWords) return (int)cudaErrorInvalidValue;
  if (!g_ready[dev]) {
    err = cudaMemcpyToSymbol(c_tab, g_host.data(),
                             g_host.size() * sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    g_ready[dev] = true;
  }
  *out = g_index[dim - 2][slot];
  return 0;
}

// nbr[jj*K + k]: the source row of stencil offset k (the center: the tile
// itself) for the block's tile jj, -1 where the neighbor is missing or the
// row is past the end; base[jj]: the first row of jj's event.
__device__ __forceinline__ void load_tiles(int* nbr, long long* base,
                                           const int* __restrict__ idx,
                                           const uint8_t* __restrict__ ok,
                                           const Geo& g) {
  const long long row0 = (long long)blockIdx.x * g.tiles;
  const int center = g.K / 2;
  for (int i = threadIdx.x; i < g.tiles * g.K; i += blockDim.x) {
    const int jj = i / g.K, k = i - jj * g.K;
    const long long row = row0 + jj;
    int r = -1;
    if (row < g.rows) {
      const long long b = row / g.T;
      const int j = (int)(row - b * g.T);
      if (k == center) {
        r = j;
        base[jj] = b * g.T;
      } else {
        const long long m = (b * (g.K - 1) + (k < center ? k : k - 1)) * g.T + j;
        const int cand = idx[m];
        r = ok[m] && cand >= 0 && cand < g.T ? cand : -1;
      }
    }
    nbr[i] = r;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_extend_kernel(const V* __restrict__ x, const int* __restrict__ idx,
                   const uint8_t* __restrict__ ok, V* __restrict__ ext,
                   const Geo g) {
  __shared__ int nbr[kMaxTiles * 27];
  __shared__ long long base[kMaxTiles];
  __shared__ uint32_t tab[kMaxExtCells];
  load_tiles(nbr, base, idx, ok, g);
  for (int i = threadIdx.x; i < g.ecells; i += blockDim.x)
    tab[i] = c_tab[g.tab + i];
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * g.tiles;
  const int per_tile = g.ecells * g.nvec;
  const int units = g.tiles * per_tile;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int jj = g.by_tile.div(u);
    const long long row = row0 + jj;
    if (row >= g.rows) break;          // units ascend with the tile
    const int rest = u - jj * per_tile;
    const int e = g.by_vec.div(rest);
    const int v = rest - e * g.nvec;
    const uint32_t code = tab[e];
    const int r = nbr[jj * g.K + (int)(code >> 16)];
    V val{};
    if (r >= 0)
      val = x[((base[jj] + r) * g.cells + (int)(code & 0xffffu)) * g.nvec + v];
    ext[(row * g.ecells + e) * g.nvec + v] = val;
  }
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  // as torch's bf16 add: the f32 sum, rounded to nearest even
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a),
                                       __bfloat162float(b)));
}

// a + b elementwise over the sizeof(V) / sizeof(S) values of S in a vector
template <typename S, typename V>
__device__ __forceinline__ V vadd(V a, const V& b) {
  constexpr int n = sizeof(V) / sizeof(S);
  S sa[n], sb[n];
  memcpy(sa, &a, sizeof(V));
  memcpy(sb, &b, sizeof(V));
#pragma unroll
  for (int i = 0; i < n; ++i) sa[i] = add_rn(sa[i], sb[i]);
  memcpy(&a, sa, sizeof(V));
  return a;
}

template <typename V, typename S>
__global__ void __launch_bounds__(kThreads)
halo_transpose_kernel(const V* __restrict__ gr, const int* __restrict__ idx,
                      const uint8_t* __restrict__ ok, V* __restrict__ dx,
                      const Geo g) {
  __shared__ int nbr[kMaxTiles * 27];
  __shared__ long long base[kMaxTiles];
  __shared__ uint32_t tab[kMaxSrcWords];
  load_tiles(nbr, base, idx, ok, g);
  for (int i = threadIdx.x; i < g.cells * g.words; i += blockDim.x)
    tab[i] = c_tab[g.tab + i];
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * g.tiles;
  const int per_tile = g.cells * g.nvec;
  const int units = g.tiles * per_tile;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int jj = g.by_tile.div(u);
    const long long row = row0 + jj;
    if (row >= g.rows) break;
    const int rest = u - jj * per_tile;
    const int s = g.by_vec.div(rest);
    const int v = rest - s * g.nvec;
    const uint32_t* w = tab + s * g.words;
    const int n = (int)(w[0] >> 16);
    V acc = gr[(row * g.ecells + (int)(w[0] & 0xffffu)) * g.nvec + v];
    for (int i = 1; i <= n; ++i) {
      const int r = nbr[jj * g.K + (int)(w[i] >> 16)];
      V val{};
      if (r >= 0)
        val = gr[((base[jj] + r) * g.ecells + (int)(w[i] & 0xffffu)) * g.nvec
                 + v];
      acc = vadd<S>(acc, val);     // a missing neighbor adds 0, as plain
    }
    dx[(row * g.cells + s) * g.nvec + v] = acc;
  }
}

// The launch geometry, or a cudaError_t for arguments the kernels refuse.
int geometry(int B, int T, int t, int dim, int row_bytes, int vec_bytes,
             bool transpose, Geo* g) {
  if (B < 1 || T < 1 || row_bytes < 1 || vec_bytes < 2 || vec_bytes > 16 ||
      vec_bytes & (vec_bytes - 1) || row_bytes % vec_bytes)
    return (int)cudaErrorInvalidValue;
  TabIndex ti;
  const int err = tables(t, dim, &ti);
  if (err) return err;
  g->rows = (long long)B * T;
  g->T = T;
  g->cells = ipow(t, dim);
  g->ecells = ipow(t + 2, dim);
  g->K = ipow(3, dim);
  g->nvec = row_bytes / vec_bytes;
  g->words = 1 << dim;
  g->tab = transpose ? ti.src_cells : ti.ext_cells;
  const int per_tile = (transpose ? g->cells : g->ecells) * g->nvec;
  g->tiles = per_tile >= kUnits ? 1 : kUnits / per_tile;
  if (g->tiles > kMaxTiles) g->tiles = kMaxTiles;
  g->by_tile = FastDiv(per_tile);
  g->by_vec = FastDiv(g->nvec);
  return 0;
}

unsigned blocks(const Geo& g) {
  return (unsigned)((g.rows + g.tiles - 1) / g.tiles);
}

template <typename V>
int launch_extend(const void* x, const void* idx, const void* ok, void* ext,
                  const Geo& g, cudaStream_t st) {
  halo_extend_kernel<V><<<blocks(g), kThreads, 0, st>>>(
      (const V*)x, (const int*)idx, (const uint8_t*)ok, (V*)ext, g);
  return (int)cudaGetLastError();
}

template <typename V, typename S>
int launch_transpose(const void* gr, const void* idx, const void* ok,
                     void* dx, const Geo& g, cudaStream_t st) {
  halo_transpose_kernel<V, S><<<blocks(g), kThreads, 0, st>>>(
      (const V*)gr, (const int*)idx, (const uint8_t*)ok, (V*)dx, g);
  return (int)cudaGetLastError();
}

template <typename S>
int transpose_as(const void* gr, const void* idx, const void* ok, void* dx,
                 const Geo& g, int vec_bytes, cudaStream_t st) {
  switch (vec_bytes) {
    case 16: return launch_transpose<uint4, S>(gr, idx, ok, dx, g, st);
    case 8: return launch_transpose<uint2, S>(gr, idx, ok, dx, g, st);
    case 4: return launch_transpose<uint32_t, S>(gr, idx, ok, dx, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Kernel D. row_bytes = C * itemsize; vec_bytes (16, 8, 4 or 2) must divide
// it and both base addresses; t in {2, 4, 8}, dim in {2, 3}. Returns a
// cudaError_t (0 = launched).
int halo_extend(const void* x, const void* idx, const void* ok, void* ext,
                int B, int T, int t, int dim, int row_bytes, int vec_bytes,
                void* stream) {
  Geo g;
  const int err = geometry(B, T, t, dim, row_bytes, vec_bytes, false, &g);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16: return launch_extend<uint4>(x, idx, ok, ext, g, st);
    case 8: return launch_extend<uint2>(x, idx, ok, ext, g, st);
    case 4: return launch_extend<uint32_t>(x, idx, ok, ext, g, st);
    case 2: return launch_extend<uint16_t>(x, idx, ok, ext, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel E, in bfloat16 (is_f32 = 0; vec_bytes 16, 8, 4 or 2) or float32
// (is_f32 = 1; vec_bytes 16, 8 or 4). Otherwise as halo_extend.
int halo_transpose(const void* g_ext, const void* idx, const void* ok,
                   void* dx, int B, int T, int t, int dim, int row_bytes,
                   int vec_bytes, int is_f32, void* stream) {
  Geo g;
  const int err = geometry(B, T, t, dim, row_bytes, vec_bytes, true, &g);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32) return transpose_as<float>(g_ext, idx, ok, dx, g, vec_bytes, st);
  if (vec_bytes == 2)
    return launch_transpose<uint16_t, __nv_bfloat16>(g_ext, idx, ok, dx, g, st);
  return transpose_as<__nv_bfloat16>(g_ext, idx, ok, dx, g, vec_bytes, st);
}

}  // extern "C"
