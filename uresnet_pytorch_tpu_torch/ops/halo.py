"""Direct 26-neighbor tile halo maps.

Port of `uresnet_pytorch_tpu/ops/halo.py`: the static slab geometry
(`halo_offsets`, `slab_cells`, `body_cells`), the neighbor maps of
`build_halo26`, the exact extend `halo26_extend_xla` and its transpose
`halo26_transpose_xla`, in plain torch.

Only the neighbor maps come across. The reference's windows, rebases,
lidx/hasp and correction lists plan one-hot gathers on the TPU; the
Hopper kernels (`ops/cuda/halo_conv.py`, `ops/cuda/halo_extend.py`) read
neighbor rows directly through `idx`/`ok`. With no correction budget
nothing can be dropped, so `overflow` is 0 by construction.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.ops.coords import (SENTINEL, decode, encode,
                                                  lookup)


@lru_cache(maxsize=None)
def halo_offsets(dim: int) -> tuple:
    """The 3^dim - 1 nonzero neighbor offsets, lexicographic. Negation
    reverses this order: offset index of -delta is (K-1-k)."""
    offs = [tuple(int(v) for v in o) for o in
            np.stack(np.meshgrid(*([np.arange(-1, 2)] * dim),
                                 indexing="ij"), -1).reshape(-1, dim)
            if any(o)]
    return tuple(offs)


def _check_halo(t: int, h: int) -> None:
    # a halo of h reads h cells of each of the 26 neighbor tiles: wider
    # than a tile it would need the tiles beyond them
    if h not in (1, 2) or h > t:
        raise ValueError(f"halo width {h} on tiles of {t}: need h in "
                         f"(1, 2) and h <= t")


@lru_cache(maxsize=None)
def slab_cells(delta: tuple, t: int, h: int = 1):
    """Static cell geometry for one neighbor offset, at halo width h.

    Returns (ext_cells, src_cells) int64 arrays of length S: positions in
    the (t+2h)^dim halo-extended tile (row-major, last axis fastest) that
    offset `delta` fills, and the matching positions in the neighbor's
    t^dim tile: its h facing layers along each axis where delta is
    nonzero."""
    _check_halo(t, h)
    dim = len(delta)
    axes_ext, axes_src = [], []
    for d in delta:
        if d == -1:
            axes_ext.append(np.arange(h))
            axes_src.append(np.arange(t - h, t))
        elif d == 1:
            axes_ext.append(np.arange(t + h, t + 2 * h))
            axes_src.append(np.arange(h))
        else:
            axes_ext.append(np.arange(h, t + h))
            axes_src.append(np.arange(t))
    eg = np.stack(np.meshgrid(*axes_ext, indexing="ij"), -1).reshape(-1, dim)
    sg = np.stack(np.meshgrid(*axes_src, indexing="ij"), -1).reshape(-1, dim)
    ext_cells = np.zeros(len(eg), np.int64)
    src_cells = np.zeros(len(sg), np.int64)
    for a in range(dim):
        ext_cells = ext_cells * (t + 2 * h) + eg[:, a]
        src_cells = src_cells * t + sg[:, a]
    return ext_cells, src_cells


@lru_cache(maxsize=None)
def body_cells(t: int, dim: int, h: int = 1) -> np.ndarray:
    """Ext positions of the tile's own t^dim cells (offset zero) in the
    (t+2h)^dim extended tile."""
    _check_halo(t, h)
    g = np.stack(np.meshgrid(*([np.arange(h, t + h)] * dim),
                             indexing="ij"), -1).reshape(-1, dim)
    cells = np.zeros(len(g), np.int64)
    for a in range(dim):
        cells = cells * (t + 2 * h) + g[:, a]
    return cells


class Halo26Spec(NamedTuple):
    """Per-level neighbor maps, batched over events."""
    idx: torch.Tensor       # (B, K, T) int32 neighbor row per offset or 0
    ok: torch.Tensor        # (B, K, T) bool neighbor exists
    blive: torch.Tensor     # (B, T) bool live tile row. Keys are sorted with
    #                         SENTINEL padding, so live rows are a prefix;
    #                         the conv kernel writes zeros for dead rows
    overflow: torch.Tensor  # (B,) int32 dropped pairs: always 0 here


def build_halo26(keys: torch.Tensor, grid: int, dim: int) -> Halo26Spec:
    """keys (B, T) sorted tile keys on a grid^dim tile grid -> neighbor maps
    for all 3^dim - 1 offsets, in `halo_offsets` order."""
    offs = torch.tensor(halo_offsets(dim), dtype=torch.int32,
                        device=keys.device)                   # (K, dim)
    coords = decode(keys, grid, dim)                          # (B, T, dim)
    valid = keys != SENTINEL
    nkeys = encode(coords[:, None] + offs[None, :, None],
                   valid[:, None], grid)                      # (B, K, T)
    idx, ok = lookup(keys, nkeys)
    overflow = torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
    return Halo26Spec(idx, ok, valid, overflow)


def halo26_extend(x: torch.Tensor, spec: Halo26Spec, t: int,
                  dim: int, h: int = 1) -> torch.Tensor:
    """Exact halo extend: (B, T, t^dim, C) -> (B, T, (t+2h)^dim, C).

    Port of `halo26_extend_xla`: one row gather per offset, zeros where
    the neighbor is missing. A halo of h = 2 (a 5^dim stencil) reads two
    layers of the same 26 neighbors, so t >= 2 keeps the tile graph."""
    B, T, cells, C = x.shape
    ext = x.new_zeros(B, T, (t + 2 * h) ** dim, C)
    dev = x.device
    ext[:, :, torch.as_tensor(body_cells(t, dim, h), device=dev)] = x
    # row T is all zeros: missing neighbors read it
    xp = torch.cat([x, x.new_zeros(B, 1, cells, C)], 1)
    bidx = torch.arange(B, device=dev)[:, None]
    for k, off in enumerate(halo_offsets(dim)):
        ecells, scells = slab_cells(off, t, h)
        rows = torch.where(spec.ok[:, k], spec.idx[:, k], T).long()
        slab = xp[:, :, torch.as_tensor(scells, device=dev)][bidx, rows]
        ext[:, :, torch.as_tensor(ecells, device=dev)] = slab
    return ext


def halo26_transpose(g: torch.Tensor, spec: Halo26Spec, t: int,
                     dim: int, h: int = 1) -> torch.Tensor:
    """Exact transpose of `halo26_extend`: (B, T, (t+2h)^dim, C) cotangent
    -> (B, T, t^dim, C).

    Port of `halo26_transpose_xla`: the body cells, then per offset k in
    order the slab-k cotangent of the tile's -delta_k neighbor (row
    idx[K-1-k]), added in g's dtype."""
    B, T, ecells, C = g.shape
    K = 3 ** dim - 1
    dev = g.device
    d_x = g[:, :, torch.as_tensor(body_cells(t, dim, h), device=dev)]
    gp = torch.cat([g, g.new_zeros(B, 1, ecells, C)], 1)
    bidx = torch.arange(B, device=dev)[:, None]
    for k, off in enumerate(halo_offsets(dim)):
        ecells_k, scells = slab_cells(off, t, h)
        rows = torch.where(spec.ok[:, K - 1 - k], spec.idx[:, K - 1 - k],
                           T).long()
        slab = gp[:, :, torch.as_tensor(ecells_k, device=dev)][bidx, rows]
        sc = torch.as_tensor(scells, device=dev)
        d_x[:, :, sc] = d_x[:, :, sc] + slab
    return d_x
