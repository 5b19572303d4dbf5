"""Standalone halo extend of tiles and its transpose.

    halo26_fwd: x (B, T, t^dim, C) -> ext (B, T, (t+2h)^dim, C)
    halo26_bwd: g (B, T, (t+2h)^dim, C) -> d_x (B, T, t^dim, C)

ext holds each tile's own cells and the h facing layers of its 3^dim - 1
neighbors (zeros where a neighbor is missing), through the `idx`/`ok` maps
of a `Halo26Spec`; the backward is its exact transpose, summed in the
working dtype. Both take bfloat16 or float32 (pure row movement, the
transpose adds in that dtype) and any C; a halo of h = 1 (the 3^dim
stencil) t in {2, 4, 8}, a halo of h = 2 (the 5^dim stencil) t in {2, 4}.

Kernels D and E (`csrc/halo_extend.cu`) replace the TPU kernels
`halo26_fwd` and `halo26_bwd` of `uresnet_pytorch_tpu/ops/pallas/
halo_fused.py`, which move slabs as one-hot matmuls over windows with patch
rows and correction lists; the kernels read each source row by index
instead. Their plain versions are `ops/halo.py`'s `halo26_extend` and
`halo26_transpose`, which the kernels equal bitwise.

`halo26_extend_op` is the extend as a torch operator whose gradient is
the transpose: the port of the reference's custom VJP
(`ops/halo.py:halo26_extend`). It feeds the unfused tile conv
(`ops/tile_conv.py`, `USE_FUSED`).
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.halo import (Halo26Spec, body_cells,
                                                halo26_extend,
                                                halo26_transpose,
                                                halo_offsets, slab_cells)

# kernel launches, for showing a run went through the kernels
launches_fwd = 0   # kernel D
launches_bwd = 0   # kernel E
# the same launches by (t, dim, C, dtype), for each shape's share of a run
launches_by_shape_fwd: collections.Counter = collections.Counter()
launches_by_shape_bwd: collections.Counter = collections.Counter()

TILE_SIZES = (2, 4, 8)   # the tile sizes the kernels take at a halo of 1
# and by halo width: E's table packs an ext cell in 10 bits, (8 + 4)^3 > 1024
TILE_SIZES_BY_HALO = {1: TILE_SIZES, 2: (2, 4)}
THREADS = 256            # a block's threads (kThreads in the kernel)
BLOCK_UNITS = 2048       # about this many units a block
MAX_TILES = 64           # tiles a block (kMaxTiles)
NO_TERM = 0xFFFF         # an unused entry of E's table


class ExtendPlan(NamedTuple):
    """How kernel D or E splits its output (mirrored in
    csrc/halo_extend.cu). A unit is `vec` bytes of one cell's row, loaded
    as one vector; a piece is `per_piece` consecutive units of one tile,
    `store` bytes stored as one vector; a thread takes `pieces` pieces
    (`THREADS` apart) per step and issues all of their loads before any
    store; a block takes `tiles` consecutive tile rows."""
    vec: int
    store: int
    per_piece: int
    pieces: int
    tiles: int


def _pow2_part(n: int, cap: int = 16) -> int:
    """The largest power of two up to cap that divides n."""
    v = cap
    while n % v:
        v //= 2
    return v


def extend_plan(kernel: str, t: int, dim: int, row_bytes: int,
                in_align: int = 16, out_align: int = 16,
                h: int = 1) -> ExtendPlan:
    """The work split of kernel D ("d") or E ("e") for rows of `row_bytes`
    (C x itemsize) on base addresses aligned to `in_align` and
    `out_align` bytes. A unit is the widest vector dividing the row and
    the input's address. D: a thread stores 16 bytes a piece where a
    tile's output allows (one vector of one cell, or 16 / row_bytes cells
    of narrow rows), else the widest power of two dividing a tile's
    output, and takes four units a thread. E: one unit a piece and a
    thread (its up to 2^dim loads; wider pieces or more units cost
    registers and measured slower on the card, PERF.md). A block
    takes about BLOCK_UNITS units. h is the halo width."""
    cells_out = (t + 2 * h) ** dim if kernel == "d" else t ** dim
    store = min(_pow2_part(cells_out * row_bytes), _pow2_part(out_align))
    vec = min(_pow2_part(row_bytes), _pow2_part(in_align), store)
    if kernel == "e":
        store = vec
    per_piece = store // vec
    pieces = max(1, 4 // per_piece) if kernel == "d" else 1
    units = cells_out * row_bytes // vec
    tiles = max(1, min(MAX_TILES, BLOCK_UNITS // units))
    return ExtendPlan(vec, store, per_piece, pieces, tiles)


def table_width(t: int, dim: int, h: int = 1) -> int:
    """Entries a source cell of E's table: 8 where a cell lies in at most
    7 slabs (h = 1, or h = 2 at t >= 4: one face layer a side), else 32
    (h = 2 at t = 2: every cell faces both sides, 26 slabs)."""
    return 8 if h == 1 or t >= 2 * h else 32


@functools.lru_cache(maxsize=None)
def extend_table(kernel: str, t: int, dim: int, h: int = 1) -> np.ndarray:
    """The static cell geometry kernel D ("d") or E ("e") reads at halo
    width h, from ops/halo.py's `body_cells` / `slab_cells`. The neighbor
    index k is the full 3^dim stencil's (`halo_offsets` with the center
    inserted, so the center is 3^dim // 2 and -delta_k is 3^dim - 1 - k).

    D: (ext cells,) uint16, ext cell e -> k << 10 | the source cell in
    tile k (the center for the body).
    E: (cells, `table_width`) uint16, source cell s -> [n << 10 | its body
    ext cell, then for each of the n offsets k whose slab holds s, in
    ascending k (the plain version's order of adds): (the neighbor
    -delta_k) << 10 | the ext cell there, then NO_TERM]."""
    K = 3 ** dim
    center = K // 2
    cells, ecells = t ** dim, (t + 2 * h) ** dim
    if kernel == "d":
        tab = np.full(ecells, NO_TERM, np.int64)
        tab[body_cells(t, dim, h)] = center << 10 | np.arange(cells)
        for k, off in enumerate(halo_offsets(dim)):
            ec, sc = slab_cells(off, t, h)
            tab[ec] = (k + (k >= center)) << 10 | sc
        return tab.astype(np.uint16)
    tab = np.full((cells, table_width(t, dim, h)), NO_TERM, np.int64)
    n = np.zeros(cells, np.int64)
    for k, off in enumerate(halo_offsets(dim)):
        ec, sc = slab_cells(off, t, h)
        kf = k + (k >= center)
        n[sc] += 1
        tab[sc, n[sc]] = (K - 1 - kf) << 10 | ec
    tab[:, 0] = n << 10 | body_cells(t, dim, h)
    return tab.astype(np.uint16)


_tables: dict = {}


def _table(kernel: str, t: int, dim: int, h: int, device) -> torch.Tensor:
    """extend_table on the device, copied there once."""
    key = (kernel, t, dim, h, device)
    if key not in _tables:
        _tables[key] = torch.from_numpy(
            extend_table(kernel, t, dim, h).view(np.int16)).to(device)
    return _tables[key]


def _check(name, a, spec, t, dim, cells_in, cells_out, h=1):
    B, T, cells, C = a.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got "
                        f"{a.dtype}")
    sizes = TILE_SIZES_BY_HALO.get(h, ())
    if dim not in (2, 3) or t not in sizes or cells != cells_in:
        raise ValueError(f"{name}: {tuple(a.shape)} does not fit t={t}, "
                         f"dim={dim}, h={h} (the kernel takes t in "
                         f"{sizes} at halo width {h})")
    K = 3 ** dim - 1
    for key, v, dtype in (("idx", spec.idx, torch.int32),
                          ("ok", spec.ok, torch.bool)):
        if tuple(v.shape) != (B, K, T) or v.dtype != dtype:
            raise ValueError(f"{name}: {key} is {tuple(v.shape)} {v.dtype}, "
                             f"need {(B, K, T)} {dtype}")
    for key, v in (("input", a), ("idx", spec.idx), ("ok", spec.ok)):
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {dev}")
    return torch.empty(B, T, cells_out, C, dtype=a.dtype, device=dev)


def _launch(kernel, a, spec, t, dim, h, out, *extra):
    B, T, _, C = a.shape
    row_bytes = C * a.element_size()
    plan = extend_plan(kernel, t, dim, row_bytes, a.data_ptr() % 16 or 16,
                       out.data_ptr() % 16 or 16, h)
    fn = cuda.library().halo_extend if kernel == "d" else \
        cuda.library().halo_transpose
    with torch.cuda.device(a.device):
        return fn(a.data_ptr(), spec.idx.data_ptr(), spec.ok.data_ptr(),
                  _table(kernel, t, dim, h, a.device).data_ptr(),
                  out.data_ptr(), B, T, t, dim, h, row_bytes, *plan, *extra,
                  torch.cuda.current_stream().cuda_stream)


def halo26_fwd(x: torch.Tensor, spec: Halo26Spec, t: int,
               dim: int, h: int = 1) -> torch.Tensor:
    """The extend at halo width h on x's device: the plain version for a
    CPU tensor, kernel D for a CUDA tensor (raises if it cannot launch)."""
    if x.device.type == "cpu":
        return halo26_extend(x, spec, t, dim, h)
    global launches_fwd
    out = _check("halo26_fwd", x, spec, t, dim, t ** dim,
                 (t + 2 * h) ** dim, h)
    if out.numel() == 0:
        return out
    cuda.check(_launch("d", x, spec, t, dim, h, out), "halo26_fwd")
    launches_fwd += 1
    launches_by_shape_fwd[(t, dim, x.shape[-1], x.dtype)
                          + ((h,) if h != 1 else ())] += 1
    return out


def halo26_bwd(g: torch.Tensor, spec: Halo26Spec, t: int,
               dim: int, h: int = 1) -> torch.Tensor:
    """The transpose at halo width h on g's device: the plain version for
    a CPU tensor, kernel E for a CUDA tensor (raises if it cannot
    launch)."""
    if g.device.type == "cpu":
        return halo26_transpose(g, spec, t, dim, h)
    global launches_bwd
    out = _check("halo26_bwd", g, spec, t, dim, (t + 2 * h) ** dim,
                 t ** dim, h)
    if out.numel() == 0:
        return out
    cuda.check(_launch("e", g, spec, t, dim, h, out,
                       int(g.dtype == torch.float32)), "halo26_bwd")
    launches_bwd += 1
    launches_by_shape_bwd[(t, dim, g.shape[-1], g.dtype)
                          + ((h,) if h != 1 else ())] += 1
    return out


@torch.library.custom_op("uresnet_torch::halo26_extend", mutates_args=())
def halo26_extend_op(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                     t: int, dim: int, h: int = 1) -> torch.Tensor:
    """`halo26_fwd(x, Halo26Spec(idx, ok, ...), t, dim, h)` with the
    transpose as its gradient (x contiguous)."""
    return halo26_fwd(x, Halo26Spec(idx, ok, None, None), t, dim, h)


def _setup_context(ctx, inputs, output):
    _, idx, ok, t, dim, h = inputs
    ctx.save_for_backward(idx, ok)
    ctx.geometry = (t, dim, h)


def _backward(ctx, grad):
    idx, ok = ctx.saved_tensors
    t, dim, h = ctx.geometry
    d_x = None
    if ctx.needs_input_grad[0]:
        d_x = halo26_bwd(grad.contiguous(), Halo26Spec(idx, ok, None, None),
                         t, dim, h)
    return d_x, None, None, None, None, None


halo26_extend_op.register_autograd(_backward, setup_context=_setup_context)
