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
// certain (t, C). Hopper has native indexed loads: a block reads its
// tiles' 26 neighbors' slab cells straight from plain (B, T, t^dim, C) rows
// through the halo maps idx/ok, so one kernel serves every (t, C), Cin = 1
// included.
//
// What bounds it on an H100: per group of 64 output rows (one t=4 tile,
// eight t=2 tiles, or one 64-cell slab of a t=8 tile) the conv is an
// implicit GEMM, rows x (K = 3^dim offsets x Cin) x Cout, whose A operand
// is the group's extended rows at each offset's shift. The card's bound is
// the bytes of x and of the output (0.25 ms at config-3 L0). A kernel pays
// on top for staging (indexed loads of neighbor rows; at t=2 the extended
// block is 8x the output rows), for the MMA loop's latency, and for
// weights. The earlier design ran one short block per 64 rows, each
// staging, then multiplying, then storing in series, with four scalar
// loads per A fragment and every warp re-reading the whole 27 x Cout x Cin
// stack (up to 442 KB) from L1/L2; its MMA loop took 70-85% of its time,
// 14-56x over the bound.
//
// Design:
// - Weights resident in shared memory. The weights come as the GEMM's B
//   operand, (Cout padded to 8, kp) with depth kp = K x round_up(Cin, 16)
//   (offset-major, channel-minor) or, for Cin < 16, kp = round_up(K x
//   Cin, 16): the offsets packed into the MMA depth, so the stem's 27
//   offsets of one channel are two 16-deep MMA steps, not 27. A block
//   copies its slice of Cout rows once; A and B fragments come by ldmatrix
//   (rows padded by 16 bytes: conflict-free), one depth step ahead of the
//   MMAs, which are mma.sync m16n8k16 (bf16 in, f32 accumulate). Cout not
//   a multiple of 8 runs on zero weight rows up to the next multiple (the
//   pad's affine is the identity) and stores only the real columns.
// - Every group is 64 rows, one 16-row MMA tile per warp along the rows.
//   A tile larger than 64 cells (t=8 in 3D) is cut into slabs of whole
//   slices along its first axis, each group staging its slab's extended
//   rows only ((1 + 2) x 10 x 10 cells at t=8, not the tile's 1000), so
//   wide Cin fits beside the weights.
// - A block walks many groups (grid-stride over (event, group), as many
//   blocks as fit on the SMs), so the weight copy and the offset, geometry
//   and affine tables are set up once per block, not once per 64 rows.
// - Each group's 27 neighbor rows per tile are read into registers one
//   group ahead, so their loads land while the previous group multiplies.
//   The extended rows come by 16-byte cp.async (zero-filled for a missing
//   neighbor), all of a block's copies in flight at once; at Cin < 16 they
//   are staged at their true width, and at Cin not a multiple of 8 by
//   plain loads, zero-padded to 16.
// - Where the stack and one buffer of the group's extended rows fit the
//   227 KB a block may use, the block stages a group, then multiplies it
//   (several blocks per SM overlap each other). Where they do not (wide
//   Cin: dec L3 128->64 holds 442 KB of weights), Cout is split across
//   blocks (blockIdx.y, at most 128 channels a slice), each staging the
//   extended rows itself, and the block runs a pipeline of two buffers of
//   channel chunks (at most 128 channels) instead: the next chunk's copies
//   fly while the MMAs run on this one. The plan, chosen on the host
//   (ops/cuda/halo_conv.py:kernel_plan) and checked by make_plan below,
//   takes the pipeline where it needs fewer slices (dec L3: 4 slices, not
//   8), or where Cin is wider than one chunk, and the widest chunks that
//   fit. At 256 wide a slice
//   would be 8 channels, each of 32 slices re-reading the input: such
//   shapes take the wide path (below) where the input stages by vectors.
//   With one block per SM two warps share each 16 rows, one per half of
//   the slice.
// - The epilogue (per-channel affine, leaky, cell mask) runs on the f32
//   accumulators and rounds once on store; a tile at or past the live
//   prefix (blive = 0) writes zeros, and a group with no live tile skips
//   the staging and the MMAs.
//
// The wide path (halo_conv_kernel_wide), for shapes whose resident plan
// splits Cout and whose input stages by 16-byte vectors (Cin >= 16, Cin %
// 8 == 0): MinkUNet34C's 64- to 256-wide convs, the U-ResNet's levels 3-4.
// - What bounds the resident path there: each of its slices (8 channels at
//   256 wide, up to 32 of them) stages the group's extended rows again, at
//   t=2 8x the output rows, and each warp issues one ldmatrix of A and one
//   of B per mma.sync: 256->256 took 25 ms against 1.6 for D + cuDNN.
// - A block computes 128 rows (two groups, one warpgroup each) by N = Cout
//   rounded up to 32 (up to 256; wider Cout in slices of 128), so one
//   staging of a channel chunk feeds all N channels. The weights are not
//   resident: tiles of N x cw per (chunk, offset), laid out by the wrapper
//   (ops/cuda/halo_conv.py:wide_weights) as wgmma's K-major core matrices,
//   stream through a ring of stages in shared memory, one bulk copy (the
//   TMA engine) per stage, completion on an mbarrier; thread 0 keeps the
//   ring ahead of the warps. Each warp loads its 16 rows' A fragment by
//   ldmatrix at the offset's shifted ext rows (the register fragment wgmma
//   takes), and its warpgroup issues one wgmma m64nNk16 per k16 step with
//   B from the ring, three steps in flight.
// - What bounds it then: the weights cross L2 once per 128 rows (27 Cin N
//   x 2 bytes: 3.5 MB at 256->256), and the staging of the extended rows
//   (at t=2 8x the rows) takes two buffers of both groups' chunks, 160 KB
//   at 32 channels. So the plan takes the widest chunk that leaves room
//   for 4 weight tiles, and stages of up to 9 offsets, up to 8 of them in
//   flight, so that the copies land before the warps need them.
// - The resident path stays where Cout fits one slice (and for the packed
//   and scalar-staged inputs): there each block already stages a chunk once
//   for all of Cout, and its weights are copied once per block instead of
//   streaming per 128 rows. Forced onto those shapes on an H100, the wide
//   path ran 2.9x slower at config-3 L0 16->16 (t=4; 2.8x as d_x), 2.1x at
//   dec L0 32->16 and 1.45x at 32->32 (t=2); it tied at 48->48 and won only
//   at MinkUNet34C's 32->64 (5%) and dec L0 32->96 (21%, forward only).

#include "halo_stage.cuh"

namespace {

using halo::cp_async16;
using halo::cp_async_commit;
using halo::cp_async_wait;
using halo::ext_source;
using halo::FastDiv;
using halo::ipow;
using halo::pack2;

constexpr int kRows = 64;                 // output rows per group
constexpr int kWarpsM = kRows / 16;       // warps along the rows
constexpr int kMaxThreads = 2 * kWarpsM * 32;
constexpr int kPad = 8;                   // bf16 pad per smem row (bank spread)
constexpr int kMaxNbr = 216;              // tiles x K per group: 8 x 27, 16 x 9
constexpr int kMaxK = 27;
constexpr int kMaxChunk = 128;            // channels per staged chunk
constexpr int kMaxSlice = 128;            // output channels per block (ab_s)
constexpr int kMaxSteps = kMaxK * kMaxChunk / 16;   // depth steps of one chunk
constexpr int kMaxEcells = 1000;          // (t + 2)^dim for t = 8, dim 3
constexpr int kMaxSmem = 232448 - 8192;   // dynamic smem, the static tables aside

// the shape and the launch plan, shared by host and device
struct Plan {
  int T, t, dim, Cin, Cout;
  int coutp;                 // Cout padded to 8: the MMA's N side
  int cells, ecells, K;      // t^dim, (t+2)^dim, 3^dim
  int tiles, subs;           // tiles per group; groups per tile (slabs)
  int gc, gcells, zoff;      // a tile's output cells, its ext cells staged
  //                            and the slab's ext-cell shift, per group
  int per_event, groups;     // groups per event, in all
  int cpad;                  // Cin padded to 16 (Cin when packed)
  int cw, nch;               // channels per staged chunk, chunks per group
  int sa;                    // ext smem row stride (bf16): cw + kPad
  int kp;                    // GEMM depth (a multiple of 16)
  int sw;                    // weight smem row stride (bf16): kp + kPad
  int cs;                    // Cout per slice (blockIdx.y)
  int wn;                    // warps per 16 rows, each a share of the slice
  int vec;                   // stage 8 channels per 16-byte cp.async
  int ahead;                 // two ext buffers: stage the next chunk ahead
  int ring;                  // wide path: weight stages in the ring (0 =
  //                            the resident path)
  int items;                 // wide path: work items of two groups
  int kg;                    // wide path: offsets per weight stage
  FastDiv by_unit, by_gcells, by_per_event, by_subs, by_cin;
  size_t w_bytes, ext_bytes, stage_bytes, smem;
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

template <int NTW, bool kEpilogue, bool kPacked, bool kAhead>
__global__ void __launch_bounds__(kMaxThreads)
halo_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wt,
                 const int* __restrict__ idx, const uint8_t* __restrict__ ok,
                 const uint8_t* __restrict__ live, const float* __restrict__ a,
                 const float* __restrict__ b, const uint8_t* __restrict__ mask,
                 float alpha, __nv_bfloat16* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);      // cs x sw
  __nv_bfloat16* ext_s = reinterpret_cast<__nv_bfloat16*>(smem + p.w_bytes);
  __shared__ int nbr[2][kMaxNbr];         // per group buffer: source row per
  //                                         (tile, offset), -1 = none
  __shared__ int shift_s[kMaxK];          // ext-row shift of each offset, x sa
  __shared__ short esrc[kMaxEcells];      // ext_source of each ext cell
  __shared__ float2 ab_s[kMaxSlice];      // the slice's (a, b); (1, 0) past Cout
  // depth table: packed, the smem offset of each depth kk (row + shift,
  // channel); else per depth step of a chunk, (A offset, B depth) as one
  // 8-byte entry, read in one load
  __shared__ __align__(8) int dtab[2 * kMaxSteps];
  int2* dtab2 = reinterpret_cast<int2*>(dtab);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane >> 2, q = lane & 3;
  const int n_lo = blockIdx.y * p.cs;     // first output channel of the slice
  const int center = p.K / 2;
  const int csteps = kPacked ? p.kp / 16 : p.K * (p.cw / 16);   // per chunk

  // once per block: the slice's weights and the tables
  {
    const int vrow = p.kp / 8;
    const uint4* src = reinterpret_cast<const uint4*>(wt + (size_t)n_lo * p.kp);
    for (int i = tid; i < p.cs * vrow; i += nthreads) {
      const int r = i / vrow, c = i - r * vrow;
      *reinterpret_cast<uint4*>(w_s + (size_t)r * p.sw + c * 8) = __ldg(src + i);
    }
    if (tid < p.K) {
      int rem = tid, doff = 0, me = 1;
      for (int ax = 0; ax < p.dim; ++ax) {
        doff += (rem % 3 - 1) * me;
        rem /= 3;
        me *= p.t + 2;
      }
      shift_s[tid] = doff * p.sa;
    }
    for (int e = tid; e < p.ecells; e += nthreads)
      esrc[e] = (short)ext_source(e, p.t, p.dim);
    if (kEpilogue)
      for (int c = tid; c < p.cs; c += nthreads)
        ab_s[c] = n_lo + c < p.Cout ? make_float2(a[n_lo + c], b[n_lo + c])
                                    : make_float2(1.f, 0.f);
    __syncthreads();
    if (kPacked) {  // depth kk = k*Cin + c reads ext row + shift_k, channel c;
      //               the padded depth reads the row itself (its weights are 0)
      for (int kk = tid; kk < p.kp; kk += nthreads) {
        const int k = p.by_cin.div(kk);
        dtab[kk] = k < p.K ? shift_s[k] + (kk - k * p.Cin) : 0;
      }
    } else {        // step ks of a chunk = (offset k, 16 of the chunk's channels)
      const int per_k = p.cw / 16;
      for (int ks = tid; ks < csteps; ks += nthreads) {
        const int k = ks / per_k, c16 = (ks - k * per_k) * 16;
        dtab2[ks] = make_int2(shift_s[k] + c16, k * p.cpad + c16);
      }
    }
  }

  // ldmatrix rows of this lane: A (16 rows x 16 depth) as (rows 0-7 | 8-15)
  // x (depth 0-7 | 8-15); B (16 channels x 16 depth) as (channels 0-7 |
  // 8-15) x (depth 0-7 | 8-15), in the fragment order of m16n8k16
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* w_warp = w_s + (size_t)(wn * NTW * 8 + b_row) * p.sw + b_col;
  const size_t ext_elems = p.ext_bytes / sizeof(__nv_bfloat16);

  // A group's neighbor rows: `prefetch` loads this thread's entries of the
  // maps (at most two of tiles x K <= 216) into registers, `take` writes
  // them into nb as source rows (-1 = none; every offset of a dead tile or
  // one past T) and returns true if this thread saw a live tile. Between
  // the two the loads are in flight.
  uint8_t pl[2], po[2];
  int pi[2];
  // group grp = (event ev, its first tile tile0, slab sub of that tile)
  auto locate = [&](int grp, int& ev, int& tile0, int& sub) {
    ev = p.by_per_event.div(grp);
    const int r = grp - ev * p.per_event;
    const int tg = p.by_subs.div(r);
    sub = r - tg * p.subs;
    tile0 = tg * p.tiles;
  };
  auto prefetch = [&](int grp) {
    int ev, tile0, sub;
    locate(grp, ev, tile0, sub);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * nthreads;
      pl[e] = 0;
      if (grp < p.groups && i < p.tiles * p.K) {
        const int j = i / p.K, k = i - j * p.K;
        const int tile = tile0 + j;
        if (tile < p.T) {
          pl[e] = live[(size_t)ev * p.T + tile];
          if (k != center) {
            const size_t m = ((size_t)ev * (p.K - 1) + (k < center ? k : k - 1)) * p.T + tile;
            po[e] = ok[m];
            pi[e] = idx[m];
          }
        }
      }
    }
  };
  auto take = [&](int grp, int* nb) {
    int ev, tile0, sub;
    locate(grp, ev, tile0, sub);
    bool mine = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * nthreads;
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
  // start staging channels [ch*cw, ch*cw + cw) of a group's extended
  // rows (each tile's whole block, or the slab's ext cells [sub * zoff,
  // sub * zoff + gcells)) into eb (zeros past Cin and for a missing
  // neighbor): cp.async, committed by the caller, or plain loads and
  // stores off the vector path
  auto stage = [&](int grp, int ch, const int* nb, __nv_bfloat16* eb) {
    int ev, tile0, sub;
    locate(grp, ev, tile0, sub);
    const __nv_bfloat16* xev = x + (size_t)ev * p.T * p.cells * p.Cin;
    const int unit = p.vec ? 8 : 1;
    const int per_cell = p.cw / unit;
    const int c_lo = ch * p.cw;
    for (int i = tid; i < p.tiles * p.gcells * per_cell; i += nthreads) {
      const int cellu = p.by_unit.div(i);           // tile * gcells + e
      const int c = (i - cellu * per_cell) * unit;
      const int j = p.by_gcells.div(cellu);
      const int es = esrc[sub * p.zoff + cellu - j * p.gcells];
      const int r = nb[j * p.K + (es & 31)];
      const bool hit = r >= 0 && c_lo + c < p.Cin;
      const __nv_bfloat16* src =
          hit ? xev + ((size_t)r * p.cells + (es >> 5)) * p.Cin + c_lo + c : xev;
      __nv_bfloat16* dst = eb + (size_t)cellu * p.sa + c;
      if (p.vec)
        cp_async16(dst, src, hit);
      else
        *dst = hit ? *src : __float2bfloat16(0.f);
    }
  };

  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // the loop over (group, chunk) stages; with two buffers (ahead) the next
  // stage is staged while this one multiplies, else each group in turn
  int grp = blockIdx.x, ch = 0, eb_i = 0, nb_i = 0;
  bool any_live = false;
  prefetch(grp);
  if (kAhead && grp < p.groups) {
    any_live = __syncthreads_or(take(grp, nbr[0]));
    if (any_live) stage(grp, 0, nbr[0], ext_s);
    cp_async_commit();
    prefetch(grp + gridDim.x);
  }
  while (grp < p.groups) {
    const bool last = ch == p.nch - 1;
    const int nxt = last ? grp + (int)gridDim.x : grp;
    bool any_next = any_live;
    __syncthreads();          // the last reads of the buffers refilled now
    if (kAhead) {
      const int nb_n = last ? nb_i ^ 1 : nb_i;
      if (last) any_next = __syncthreads_or(nxt < p.groups && take(nxt, nbr[nb_n]));
      if (nxt < p.groups && any_next)
        stage(nxt, last ? 0 : ch + 1, nbr[nb_n], ext_s + (eb_i ^ 1) * ext_elems);
      cp_async_commit();
      if (last) prefetch(nxt + gridDim.x);   // read by the next group change
      cp_async_wait<1>();     // this stage's copies, not the next one's
    } else {
      // one chunk a group here: the next group's maps load meanwhile
      any_live = __syncthreads_or(take(grp, nbr[0]));
      if (any_live) stage(grp, 0, nbr[0], ext_s);
      cp_async_commit();
      prefetch(nxt);
      cp_async_wait<0>();
      any_next = any_live;
    }
    __syncthreads();

    const int* nb = nbr[nb_i];
    const __nv_bfloat16* eb = ext_s + eb_i * ext_elems;
    int ev, tile0, sub;
    locate(grp, ev, tile0, sub);
    const size_t evrow = (size_t)ev * p.T;
    const int mt = wm;        // each warp's one 16-row MMA tile of the group
    if (any_live) {
      // A: this lane's ldmatrix row (unpacked) or its rows g, g + 8
      // (packed), at their own ext rows
      int rb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + (kPacked ? g + 8 * h : a_row);
        const int j = m / p.gc, cell = sub * p.gc + m - j * p.gc;
        rb[h] = (j * p.gcells + halo::cell_ext_row(cell, p.t, p.dim) - sub * p.zoff) * p.sa
                + (kPacked ? 0 : a_col);
      }
      const __nv_bfloat16* wch = w_warp + ch * p.cw;
      // the fragments of depth step ks: A at the step's shifted rows, B
      // from the resident weights; loaded one step ahead of the MMAs
      auto load = [&](int ks, uint32_t* af, uint32_t* bf) {
        const __nv_bfloat16* wb;
        if (kPacked) {
          const int* o = dtab + ks * 16 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat16* e = eb + rb[h];
            af[h] = pack2(e[o[0]], e[o[1]]);
            af[2 + h] = pack2(e[o[8]], e[o[9]]);
          }
          wb = wch + ks * 16;
        } else {
          const int2 o = dtab2[ks];
          ldsm_x4(af, eb + rb[0] + o.x);
          wb = wch + o.y;
        }
#pragma unroll
        for (int n = 0; n + 1 < NTW; n += 2)
          ldsm_x4(bf + 2 * n, wb + (size_t)n * 8 * p.sw);
        if (NTW & 1) ldsm_x2(bf + 2 * (NTW - 1), wb + (size_t)(NTW - 1) * 8 * p.sw);
      };
      auto mma = [&](const uint32_t* af, const uint32_t* bf) {
#pragma unroll
        for (int n = 0; n < NTW; ++n) halo::mma_16816(acc[n], af, bf[2 * n], bf[2 * n + 1]);
      };
      uint32_t a0[4], b0[2 * NTW], a1[4], b1[2 * NTW];
      load(0, a0, b0);
      for (int ks = 0; ks < csteps; ks += 2) {
        if (ks + 1 < csteps) load(ks + 1, a1, b1);
        mma(a0, b0);
        if (ks + 1 < csteps) {
          if (ks + 2 < csteps) load(ks + 2, a0, b0);
          mma(a1, b1);
        }
      }
    }
    if (last) {
      // epilogue + store: c0,c1 -> row g, cols 2q, 2q+1; c2,c3 -> row g + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        const int j = m / p.gc, cell = sub * p.gc + m - j * p.gc;
        const int tile = tile0 + j;
        if (tile >= p.T) continue;
        const size_t row = evrow + tile;
        const bool keep = nb[j * p.K + center] >= 0 &&
                          (!kEpilogue || mask[row * p.cells + cell]);
        __nv_bfloat16* orow = out + (row * p.cells + cell) * p.Cout + n_lo;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int col = (wn * NTW + n) * 8 + 2 * q;
          if (n_lo + col >= p.Cout) continue;      // the pad's columns
          float z0 = acc[n][2 * h], z1 = acc[n][2 * h + 1];
          if (kEpilogue) {
            const float2 ab0 = ab_s[col], ab1 = ab_s[col + 1];
            z0 = z0 * ab0.x + ab0.y;
            z1 = z1 * ab1.x + ab1.y;
            z0 = z0 >= 0.f ? z0 : alpha * z0;
            z1 = z1 >= 0.f ? z1 : alpha * z1;
          }
          if (!keep) z0 = z1 = 0.f;
          if (p.Cout % 2 == 0) {   // col even: the pair is 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(z0, z1);
          } else {
            orow[col] = __float2bfloat16(z0);
            if (n_lo + col + 1 < p.Cout) orow[col + 1] = __float2bfloat16(z1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }

    if (kAhead) {
      eb_i ^= 1;
      if (last) nb_i ^= 1;
    }
    any_live = any_next;
    grp = nxt;
    ch = last ? 0 : ch + 1;
  }
}

template <int NTW, bool kEpilogue, bool kPacked, bool kAhead>
int launch(const void* x, const void* wt, const void* idx, const void* ok,
           const void* live, const void* a, const void* b, const void* mask,
           float alpha, void* out, int B, const Plan& p, cudaStream_t stream) {
  auto kernel = halo_conv_kernel<NTW, kEpilogue, kPacked, kAhead>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = p.wn * kWarpsM * 32;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                         p.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int slices = p.coutp / p.cs;
  int gx = (sms * per_sm + slices - 1) / slices;
  if (gx > p.groups) gx = p.groups;
  kernel<<<dim3(gx, slices), threads, p.smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const int*)idx,
      (const uint8_t*)ok, (const uint8_t*)live, (const float*)a, (const float*)b,
      (const uint8_t*)mask, alpha, (__nv_bfloat16*)out, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide path: weights streamed through a ring in shared memory.
// ---------------------------------------------------------------------------

constexpr int kWideWarps = 8;                        // 2 groups x 4 quarters of N
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideMaxN = 256;                       // output channels per block
constexpr int kMaxRing = 8;                          // weight stages in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// `bytes` contiguous bytes global -> shared by the TMA engine (a bulk
// copy), their arrival counted on `bar`, which this call arrives on
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// wgmma (sm_90a): a warpgroup's 64 x 32 f32 accumulators += A (64 x 16
// bf16, each warp's 16 rows in registers, the fragment of mma.m16n8k16's
// A) x B (16 x 32 bf16 in shared memory, K-major, no swizzle: 8 x 8 core
// matrices of 128 contiguous bytes, `lbo` bytes apart along K and `sbo`
// along N, as `desc` gives them). The accumulators of thread (warp w,
// lane 4 g + q): d[4 i + 2 h + e] at row 16 w + g + 8 h, column 8 i + 2 q
// + e.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// d (16 NT accumulators a thread: N = 32 NT columns) += A x B, one wgmma
// m64nNk16
template <int NT>
__device__ __forceinline__ void wgmma_m64nNk16(float* d, const uint32_t* a, uint64_t desc);

// the accumulator operands and their place-holders, 16 (32 columns) at a time
#define HALO_WG_D16(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), \
    "+f"(d[i + 9]), "+f"(d[i + 10]), "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]), \
    "+f"(d[i + 14]), "+f"(d[i + 15])
#define HALO_WG_S0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HALO_WG_S1 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HALO_WG_S2 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HALO_WG_S3 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HALO_WG_S4 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define HALO_WG_S5 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HALO_WG_S6 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define HALO_WG_S7 ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HALO_WG_MMA(NT, SHAPE, LIST, TAIL, ...)                                          \
  template <>                                                                          \
  __device__ __forceinline__ void wgmma_m64nNk16<NT>(float* d, const uint32_t* a,      \
                                                     uint64_t desc) {                  \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, 1, 0;\n\t"                      \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 {" LIST TAIL       \
                 ", p, 1, 1, 0;\n\t}\n"                                                   \
                 : __VA_ARGS__                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));             \
  }
HALO_WG_MMA(1, "m64n32k16", HALO_WG_S0,
            "}, {%16, %17, %18, %19}, %20", HALO_WG_D16(0))
HALO_WG_MMA(2, "m64n64k16", HALO_WG_S0 HALO_WG_S1,
            "}, {%32, %33, %34, %35}, %36", HALO_WG_D16(0), HALO_WG_D16(16))
HALO_WG_MMA(3, "m64n96k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2,
            "}, {%48, %49, %50, %51}, %52", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32))
HALO_WG_MMA(4, "m64n128k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2 HALO_WG_S3,
            "}, {%64, %65, %66, %67}, %68", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32), HALO_WG_D16(48))
HALO_WG_MMA(5, "m64n160k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2 HALO_WG_S3 HALO_WG_S4,
            "}, {%80, %81, %82, %83}, %84", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32), HALO_WG_D16(48), HALO_WG_D16(64))
HALO_WG_MMA(6, "m64n192k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2 HALO_WG_S3 HALO_WG_S4 HALO_WG_S5,
            "}, {%96, %97, %98, %99}, %100", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32), HALO_WG_D16(48), HALO_WG_D16(64), HALO_WG_D16(80))
HALO_WG_MMA(7, "m64n224k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2 HALO_WG_S3 HALO_WG_S4 HALO_WG_S5 HALO_WG_S6,
            "}, {%112, %113, %114, %115}, %116", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32), HALO_WG_D16(48), HALO_WG_D16(64), HALO_WG_D16(80), HALO_WG_D16(96))
HALO_WG_MMA(8, "m64n256k16", HALO_WG_S0 HALO_WG_S1 HALO_WG_S2 HALO_WG_S3 HALO_WG_S4 HALO_WG_S5 HALO_WG_S6 HALO_WG_S7,
            "}, {%128, %129, %130, %131}, %132", HALO_WG_D16(0), HALO_WG_D16(16), HALO_WG_D16(32), HALO_WG_D16(48), HALO_WG_D16(64), HALO_WG_D16(80), HALO_WG_D16(96), HALO_WG_D16(112))
#undef HALO_WG_MMA
#undef HALO_WG_D16
#undef HALO_WG_S0
#undef HALO_WG_S1
#undef HALO_WG_S2
#undef HALO_WG_S3
#undef HALO_WG_S4
#undef HALO_WG_S5
#undef HALO_WG_S6
#undef HALO_WG_S7

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>   // until at most N of this warpgroup's wgmma groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// this point (wgmma writes them asynchronously)
template <int NT>
__device__ __forceinline__ void hold(float (&acc)[NT][16]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 16; ++r) asm volatile("" : "+f"(acc[n][r]) :: "memory");
}

// One block walks work items of two 64-row groups (128 output rows) by N =
// p.cs output channels. The weights come as tiles (slice, chunk, offset k)
// of N x cw, laid out unit-major ([cw / 8][N][8], contiguous: wgmma's
// K-major core matrices without swizzle), one bulk copy of p.kg
// consecutive offsets' tiles per stage, through a ring of p.ring stages
// that thread 0 keeps filled (`issue`). Its eight warps stage the item's
// extended rows one channel chunk ahead, as the resident path's pipeline
// does; warpgroup wm then runs group wm's 64 rows by all N channels, each
// warp loading its 16 rows' A fragment by ldmatrix at the offset's shifted
// ext rows, against the ring's tiles. An item with no live tile takes no
// stage.
template <int NT, bool kEpilogue>
__global__ void __launch_bounds__(kWideThreads, 1)
halo_conv_kernel_wide(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wt,
                      const int* __restrict__ idx, const uint8_t* __restrict__ ok,
                      const uint8_t* __restrict__ live, const float* __restrict__ a,
                      const float* __restrict__ b, const uint8_t* __restrict__ mask,
                      float alpha, __nv_bfloat16* __restrict__ out, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);   // ring x stage
  __nv_bfloat16* ext_s =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)p.ring * p.stage_bytes);
  __shared__ int nbr[2][2 * kMaxNbr];     // per item buffer: source row per
  //                                         (group, tile, offset), -1 = none
  __shared__ int shift_s[kMaxK];          // ext-row shift of each offset, x sa
  __shared__ short esrc[kMaxEcells];      // ext_source of each ext cell
  __shared__ float2 ab_s[kWideMaxN];      // the slice's (a, b); (1, 0) past Cout
  __shared__ __align__(8) uint64_t full[kMaxRing], empty[kMaxRing];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_lo = blockIdx.y * p.cs;     // first output channel of the slice
  const int center = p.K / 2;
  const int per_group = p.tiles * p.K;    // map entries of a group
  const size_t stage_elems = p.stage_bytes / sizeof(__nv_bfloat16);

  if (tid < p.K) shift_s[tid] = halo::offset_shift(tid, p.dim, p.t + 2) * p.sa;
  for (int e = tid; e < p.ecells; e += blockDim.x)
    esrc[e] = (short)ext_source(e, p.t, p.dim);
  if (kEpilogue)
    for (int c = tid; c < p.cs; c += blockDim.x)
      ab_s[c] = n_lo + c < p.Cout ? make_float2(a[n_lo + c], b[n_lo + c])
                                  : make_float2(1.f, 0.f);
  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWideWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto locate = [&](int grp, int& ev, int& tile0, int& sub) {
    ev = p.by_per_event.div(grp);
    const int r = grp - ev * p.per_event;
    const int tg = p.by_subs.div(r);
    sub = r - tg * p.subs;
    tile0 = tg * p.tiles;
  };

  // Thread 0 streams the weight tiles: every live item takes the same
  // steps = nch x K / kg stages of this slice's tiles, so the block's stage
  // u is stage u % steps of the slice. It issues stage u once all warps
  // have released stage u - ring (the slot's last use), up to ring - 1
  // stages ahead of the warps, and never past the stages `known` to be
  // taken: the current item's, and the next item's once its liveness is
  // known.
  const int per_chunk = p.K / p.kg;       // stages of a chunk
  const int steps = p.nch * per_chunk;
  const int tile_elems = (int)(stage_elems / p.kg);
  const __nv_bfloat16* wslice = wt + (size_t)blockIdx.y * steps * stage_elems;
  int issued = 0, known = 0;
  auto issue = [&](int use) {
    for (; issued < known && issued < use + p.ring; ++issued) {
      const int slot = issued % p.ring;
      mbar_wait(&empty[slot], ((issued / p.ring) & 1) ^ 1);
      bulk_load(ring + slot * stage_elems, wslice + (size_t)(issued % steps) * stage_elems,
                (uint32_t)p.stage_bytes, &full[slot]);
    }
  };

  // warpgroup wm computes group wm of the item, warp wr of it its rows
  // 16 wr .. 16 wr + 15, all N channels
  const int wm = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  // this lane's ldmatrix row of A, in the fragment order of m16n8k16
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const size_t ext_elems = p.ext_bytes / sizeof(__nv_bfloat16);
  const int csteps = p.cw / 16;

  // an item's neighbor rows, entry i = (group gs, tile j, offset k): as
  // the resident path's prefetch / take, over both groups
  uint8_t pl[2], po[2];
  int pi[2];
  auto prefetch = [&](int item) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kWideWarps * 32;
      pl[e] = 0;
      if (item < p.items && i < 2 * per_group) {
        const int gs = i >= per_group, rem = i - gs * per_group;
        const int j = rem / p.K, k = rem - j * p.K;
        const int grp = 2 * item + gs;
        if (grp < p.groups) {
          int ev, tile0, sub;
          locate(grp, ev, tile0, sub);
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
    }
  };
  auto take = [&](int item, int* nb) {
    bool mine = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kWideWarps * 32;
      if (i < 2 * per_group) {
        const int gs = i >= per_group, rem = i - gs * per_group;
        const int j = rem / p.K, k = rem - j * p.K;
        int r = -1;
        if (pl[e]) {
          int ev, tile0, sub;
          locate(2 * item + gs, ev, tile0, sub);
          mine = true;
          r = k == center ? tile0 + j : (po[e] ? pi[e] : -1);
        }
        nb[i] = r;
      }
    }
    return mine;
  };
  // start staging channels [ch*cw, ch*cw + cw) of both groups' extended
  // rows into eb, group gs at ext cell gs * tiles * gcells
  auto stage = [&](int item, int ch, const int* nb, __nv_bfloat16* eb) {
    int evs[2], subs[2];
#pragma unroll
    for (int gs = 0; gs < 2; ++gs) {
      int tile0;
      evs[gs] = subs[gs] = 0;
      if (2 * item + gs < p.groups) locate(2 * item + gs, evs[gs], tile0, subs[gs]);
    }
    const int per_cell = p.cw / 8;
    const int c_lo = ch * p.cw;
    const int n = 2 * p.tiles * p.gcells * per_cell;
    for (int i = tid; i < n; i += kWideWarps * 32) {
      const int cellu = p.by_unit.div(i);          // (gs * tiles + j) * gcells + e
      const int c = (i - cellu * per_cell) * 8;
      const int jj = p.by_gcells.div(cellu);       // gs * tiles + j
      const int gs = jj >= p.tiles;
      const int es = esrc[subs[gs] * p.zoff + cellu - jj * p.gcells];
      const int r = nb[jj * p.K + (es & 31)];
      const bool hit = r >= 0 && c_lo + c < p.Cin;
      const __nv_bfloat16* src =
          hit ? x + (((size_t)evs[gs] * p.T + r) * p.cells + (es >> 5)) * p.Cin + c_lo + c
              : x;
      cp_async16(eb + (size_t)cellu * p.sa + c, src, hit);
    }
  };

  float acc[NT][16];     // 32 channels each
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[n][r] = 0.f;
  hold(acc);

  // the loop over (item, chunk) stages, the next one staged while this one
  // multiplies
  int item = blockIdx.x, ch = 0, eb_i = 0, nb_i = 0, use = 0;
  bool any_live = false;
  prefetch(item);
  if (item < p.items) {
    any_live = __syncthreads_or(take(item, nbr[0]));
    if (any_live) stage(item, 0, nbr[0], ext_s);
    cp_async_commit();
    prefetch(item + gridDim.x);
  }
  while (item < p.items) {
    const bool last = ch == p.nch - 1;
    const int nxt = last ? item + (int)gridDim.x : item;
    const int nb_n = last ? nb_i ^ 1 : nb_i;
    bool any_next = any_live;
    __syncthreads();          // the last reads of the buffers refilled now
    if (last) any_next = __syncthreads_or(nxt < p.items && take(nxt, nbr[nb_n]));
    if (nxt < p.items && any_next)
      stage(nxt, last ? 0 : ch + 1, nbr[nb_n], ext_s + (eb_i ^ 1) * ext_elems);
    cp_async_commit();
    if (last) prefetch(nxt + gridDim.x);
    cp_async_wait<1>();       // this stage's copies, not the next one's
    __syncthreads();
    if (tid == 0 && any_live) {
      if (ch == 0) known = use + steps;                   // this item's
      if (last && nxt < p.items && any_next) known = use + per_chunk + steps;
    }

    const int* nb = nbr[nb_i];
    const __nv_bfloat16* eb = ext_s + eb_i * ext_elems;
    const int grp = 2 * item + wm;
    int ev, tile0, sub;
    locate(grp, ev, tile0, sub);
    if (any_live) {
      // A: this lane's ldmatrix row, at its ext row
      const int m = wr * 16 + a_row;
      const int j = m / p.gc, cell = sub * p.gc + m - j * p.gc;
      const int rb = ((wm * p.tiles + j) * p.gcells + halo::cell_ext_row(cell, p.t, p.dim)
                      - sub * p.zoff) * p.sa + a_col;
      // B: a tile's core matrices lie N x 16 bytes apart along K, 128
      // along N; a k16 step takes two units, 32 channels a wgmma
      const uint32_t lbo = p.cs * 16;
      const int nsteps = p.kg * csteps;
      for (int k0 = 0; k0 < p.K; k0 += p.kg, ++use) {
        if (tid == 0) issue(use);
        __syncwarp();
        const int slot = use % p.ring;
        mbar_wait(&full[slot], (use / p.ring) & 1);
        const __nv_bfloat16* ws = ring + slot * stage_elems;
        uint32_t af[4][4];
        int k = k0, c = 0;
        for (int st = 0; st < nsteps; ++st) {
          uint32_t* a = af[st & 3];
          ldsm_x4(a, eb + shift_s[k] + rb + c * 16);
          wgmma_fence();
          wgmma_m64nNk16<NT>(&acc[0][0], a, wgmma_desc(ws + (size_t)c * 16 * p.cs, lbo, 128));
          wgmma_commit();
          wgmma_wait<2>();    // three steps back: its A registers are free
          if (++c == csteps) {
            c = 0;
            ++k;
            ws += tile_elems;
          }
        }
        wgmma_wait<0>();      // this stage's tiles read
        hold(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }
    if (last) {
      // epilogue + store, as the resident path's, for this warp's rows
      if (grp < p.groups) {
        const size_t evrow = (size_t)ev * p.T;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wr * 16 + g + 8 * h;
          const int j = m / p.gc, cell = sub * p.gc + m - j * p.gc;
          const int tile = tile0 + j;
          if (tile >= p.T) continue;
          const size_t row = evrow + tile;
          const bool keep = nb[(wm * p.tiles + j) * p.K + center] >= 0 &&
                            (!kEpilogue || mask[row * p.cells + cell]);
          __nv_bfloat16* orow = out + (row * p.cells + cell) * p.Cout + n_lo;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = n * 32 + i * 8 + 2 * q;
              if (n_lo + col >= p.Cout) continue;      // the pad's columns
              float z0 = acc[n][4 * i + 2 * h], z1 = acc[n][4 * i + 2 * h + 1];
              if (kEpilogue) {
                const float2 ab0 = ab_s[col], ab1 = ab_s[col + 1];
                z0 = z0 * ab0.x + ab0.y;
                z1 = z1 * ab1.x + ab1.y;
                z0 = z0 >= 0.f ? z0 : alpha * z0;
                z1 = z1 >= 0.f ? z1 : alpha * z1;
              }
              if (!keep) z0 = z1 = 0.f;
              if (p.Cout % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(z0, z1);
              } else {
                orow[col] = __float2bfloat16(z0);
                if (n_lo + col + 1 < p.Cout) orow[col + 1] = __float2bfloat16(z1);
              }
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[n][r] = 0.f;
      hold(acc);
    }

    eb_i ^= 1;
    if (last) nb_i ^= 1;
    any_live = any_next;
    item = nxt;
    ch = last ? 0 : ch + 1;
  }
}

template <int NT, bool kEpilogue>
int launch_wide(const void* x, const void* wt, const void* idx, const void* ok,
                const void* live, const void* a, const void* b, const void* mask,
                float alpha, void* out, const Plan& p, cudaStream_t stream) {
  auto kernel = halo_conv_kernel_wide<NT, kEpilogue>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads,
                                                         p.smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int slices = p.coutp / p.cs;
  int gx = (sms * per_sm + slices - 1) / slices;
  if (gx > p.items) gx = p.items;
  kernel<<<dim3(gx, slices), kWideThreads, p.smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wt, (const int*)idx,
      (const uint8_t*)ok, (const uint8_t*)live, (const float*)a, (const float*)b,
      (const uint8_t*)mask, alpha, (__nv_bfloat16*)out, p);
  return (int)cudaGetLastError();
}

template <bool kEpilogue>
int dispatch_wide(const void* x, const void* wt, const void* idx, const void* ok,
                  const void* live, const void* a, const void* b, const void* mask,
                  float alpha, void* out, const Plan& p, cudaStream_t stream) {
  switch (p.cs / 32) {
#define HALO_CONV_WIDE_CASE(N)                                                          \
  case N:                                                                               \
    return launch_wide<N, kEpilogue>(x, wt, idx, ok, live, a, b, mask, alpha, out, p,   \
                                     stream);
    HALO_CONV_WIDE_CASE(1) HALO_CONV_WIDE_CASE(2) HALO_CONV_WIDE_CASE(3)
    HALO_CONV_WIDE_CASE(4) HALO_CONV_WIDE_CASE(5) HALO_CONV_WIDE_CASE(6)
    HALO_CONV_WIDE_CASE(7) HALO_CONV_WIDE_CASE(8)
#undef HALO_CONV_WIDE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch of a plan chosen on the host (ops/cuda/halo_conv.py:
// kernel_plan): cs output channels per block, cw channels per staged
// chunk, the wide path's ring of weight stages of kg offsets each (both 0
// on the resident path), and on the resident path one buffer of a group's
// whole extended rows (ahead 0) or two buffers of channel chunks (ahead
// 1). Fills in this shape's groups, strides, byte sizes and warps per 16
// rows, and refuses (cudaErrorInvalidValue) a shape or plan outside the
// kernels' compile-time limits or with no template instance. The wide
// path stages by vectors only, so dispatch refuses it an x off 16 bytes
// (the wrapper copies such an x first); the resident path stages that x
// by scalars.
int make_plan(Plan& p, int B, int T, int t, int dim, int Cin, int Cout, int cs, int cw,
              int ring, int kg, int ahead, bool aligned) {
  if (dim < 2 || dim > 3 || t < 2 || Cin < 1 || Cout < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  p.T = T; p.t = t; p.dim = dim; p.Cin = Cin; p.Cout = Cout;
  p.cells = ipow(t, dim);
  p.ecells = ipow(t + 2, dim);
  p.K = ipow(3, dim);
  if (p.ecells > kMaxEcells) return (int)cudaErrorInvalidValue;
  if (p.cells <= kRows) {   // whole tiles
    if (kRows % p.cells) return (int)cudaErrorInvalidValue;
    p.tiles = kRows / p.cells;
    p.subs = 1;
    p.gc = p.cells;
    p.gcells = p.ecells;
    p.zoff = 0;
  } else {                  // slabs of `rows` whole slices along axis 0
    const int slice = p.cells / t;
    if (kRows % slice || t % (kRows / slice)) return (int)cudaErrorInvalidValue;
    const int rows = kRows / slice, plane = ipow(t + 2, dim - 1);
    p.tiles = 1;
    p.subs = t / rows;
    p.gc = kRows;
    p.gcells = (rows + 2) * plane;
    p.zoff = rows * plane;
  }
  if (p.tiles * p.K > kMaxNbr) return (int)cudaErrorInvalidValue;
  p.per_event = (T + p.tiles - 1) / p.tiles * p.subs;
  p.groups = B * p.per_event;
  const bool packed = Cin < 16;
  p.cpad = packed ? Cin : (Cin + 15) / 16 * 16;
  p.kp = packed ? (p.K * Cin + 15) / 16 * 16 : p.K * p.cpad;
  p.sw = p.kp + kPad;
  const bool vec_shape = !packed && Cin % 8 == 0;
  p.vec = vec_shape && aligned;
  // a chunk: all of a packed Cin, else a multiple of 16 dividing the
  // padded Cin
  if (packed ? cw != Cin : (cw < 16 || cw > kMaxChunk || cw % 16 || p.cpad % cw))
    return (int)cudaErrorInvalidValue;
  p.cs = cs;
  p.cw = cw;
  p.nch = p.cpad / cw;
  p.ring = ring;
  p.kg = kg;
  p.ahead = ahead;
  if (ring) {   // the wide path: N = cs in 32-column wgmma tiles
    if (!vec_shape || ahead || ring < 0 || ring > kMaxRing || kg < 1 || p.K % kg || cs < 32 ||
        cs % 32 || cs > kWideMaxN)
      return (int)cudaErrorInvalidValue;
    p.coutp = (Cout + cs - 1) / cs * cs;
    p.sa = cw + kPad;
    p.ext_bytes = ((size_t)2 * p.tiles * p.gcells * p.sa * sizeof(__nv_bfloat16) + 15) / 16 * 16;
    p.stage_bytes = (size_t)kg * cs * cw * sizeof(__nv_bfloat16);
    p.w_bytes = 0;
    p.smem = ring * p.stage_bytes + 2 * p.ext_bytes;
    p.wn = 1;
    p.items = (p.groups + 1) / 2;
    p.by_unit = FastDiv(cw / 8);
  } else {      // resident: one buffer of a group's whole extended rows,
    //             or (ahead) a pipeline of two buffers of chunks
    if (kg || (ahead ? packed : p.nch != 1) ||
        cs < 8 || cs % 8 || cs > kMaxSlice || ((Cout + 7) / 8 * 8) % cs)
      return (int)cudaErrorInvalidValue;
    p.coutp = (Cout + 7) / 8 * 8;
    p.sa = packed ? Cin : cw + kPad;
    p.ext_bytes = ((size_t)p.tiles * p.gcells * p.sa * sizeof(__nv_bfloat16) + 15) / 16 * 16;
    p.stage_bytes = 0;
    p.w_bytes = (size_t)cs * p.sw * sizeof(__nv_bfloat16);
    p.smem = p.w_bytes + (ahead ? 2 : 1) * p.ext_bytes;
    // two warps per 16 rows, each a half of the slice, where only one
    // block fits an SM
    p.wn = (2 * p.smem > (size_t)kMaxSmem && (cs / 8) % 2 == 0) ? 2 : 1;
    p.items = 0;
    p.by_unit = FastDiv(cw / (p.vec ? 8 : 1));
  }
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  p.by_gcells = FastDiv(p.gcells);
  p.by_per_event = FastDiv(p.per_event);
  p.by_subs = FastDiv(p.subs);
  p.by_cin = FastDiv(Cin);
  return 0;
}

template <bool kEpilogue, bool kPacked, bool kAhead>
int dispatch_ntw(const void* x, const void* wt, const void* idx, const void* ok,
                 const void* live, const void* a, const void* b, const void* mask,
                 float alpha, void* out, int B, const Plan& p, cudaStream_t stream) {
  switch (p.cs / 8 / p.wn) {
#define HALO_CONV_CASE(N)                                                              \
  case N:                                                                              \
    return launch<N, kEpilogue, kPacked, kAhead>(x, wt, idx, ok, live, a, b, mask,     \
                                                 alpha, out, B, p, stream);
    HALO_CONV_CASE(1) HALO_CONV_CASE(2) HALO_CONV_CASE(3) HALO_CONV_CASE(4)
    HALO_CONV_CASE(5) HALO_CONV_CASE(6) HALO_CONV_CASE(7) HALO_CONV_CASE(8)
    HALO_CONV_CASE(9) HALO_CONV_CASE(10) HALO_CONV_CASE(11) HALO_CONV_CASE(12)
    HALO_CONV_CASE(13) HALO_CONV_CASE(14) HALO_CONV_CASE(15) HALO_CONV_CASE(16)
#undef HALO_CONV_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kEpilogue>
int dispatch(const void* x, const void* wt, const void* idx, const void* ok,
             const void* live, const void* a, const void* b, const void* mask,
             float alpha, void* out, int B, int T, int t, int dim, int Cin,
             int Cout, int cs, int cw, int ring, int kg, int ahead,
             cudaStream_t stream) {
  Plan p;
  const int err = make_plan(p, B, T, t, dim, Cin, Cout, cs, cw, ring, kg, ahead,
                            (uintptr_t)x % 16 == 0);
  if (err) return err;
  if (p.groups == 0) return 0;
  if (p.ring)
    return (uintptr_t)x % 16
               ? (int)cudaErrorMisalignedAddress
               : dispatch_wide<kEpilogue>(x, wt, idx, ok, live, a, b, mask, alpha, out,
                                          p, stream);
  // the pipeline (p.ahead) is its own kernel, so the single-buffer one
  // keeps no registers for it; it never runs packed
  if (Cin < 16)
    return dispatch_ntw<kEpilogue, true, false>(x, wt, idx, ok, live, a, b, mask, alpha,
                                                out, B, p, stream);
  if (p.ahead)
    return dispatch_ntw<kEpilogue, false, true>(x, wt, idx, ok, live, a, b, mask, alpha,
                                                out, B, p, stream);
  return dispatch_ntw<kEpilogue, false, false>(x, wt, idx, ok, live, a, b, mask, alpha,
                                               out, B, p, stream);
}

}  // namespace

extern "C" {

// bfloat16 tensors, f32 affine; wt is the GEMM's B operand: on the
// resident path (ring 0) (Cout padded to 8 with zero rows, kp), kp =
// 3^dim x round_up(Cin, 16) offset-major, or round_up(3^dim x Cin, 16)
// with the offsets packed for Cin < 16 (ops/cuda/halo_conv.py:
// kernel_weights), zero-padded; on the wide path the (slice, chunk,
// offset) tiles of ops/cuda/halo_conv.py:wide_weights. (cs, cw, ring, kg,
// ahead) is the plan (make_plan above). Returns a cudaError_t (0 =
// launched).
int halo_conv_raw(const void* x, const void* wt, const void* idx, const void* ok,
                  const void* live, void* out, int B, int T, int t, int dim,
                  int Cin, int Cout, int cs, int cw, int ring, int kg, int ahead,
                  void* stream) {
  return dispatch<false>(x, wt, idx, ok, live, nullptr, nullptr, nullptr, 1.f, out,
                         B, T, t, dim, Cin, Cout, cs, cw, ring, kg, ahead,
                         (cudaStream_t)stream);
}

int halo_conv_bn_act(const void* x, const void* wt, const void* idx,
                     const void* ok, const void* live, const void* a,
                     const void* b, const void* mask, float alpha, void* out,
                     int B, int T, int t, int dim, int Cin, int Cout, int cs,
                     int cw, int ring, int kg, int ahead, void* stream) {
  return dispatch<true>(x, wt, idx, ok, live, a, b, mask, alpha, out, B, T, t, dim,
                        Cin, Cout, cs, cw, ring, kg, ahead, (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
