"""Tiled-dense sparse representation: the per-batch tile graph.

Port of `uresnet_pytorch_tpu/ops/tile_graph.py`. Active voxels bucket into
t^dim tiles stored as dense blocks with per-cell occupancy; each level
carries its 26-neighbor halo maps, and each pair of levels a down link of
row gathers between the tile grids. Counters (tile and voxel spills) match
the reference exactly; the halo and link correction overflows it counts
cannot happen here, so they are 0.

`GatherSpec` keeps `idx` and the FULL `ok`: the reference splits `ok` into
an in-window part plus a correction list for its one-hot TPU gathers
(`make_gather_spec`), which the port's indexed gather does not need.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.ops.coords import (SENTINEL, _dedup_sorted,
                                                  decode, encode, lookup)
from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec, build_halo26


class GatherSpec(NamedTuple):
    """Row gather: out[b, i] = src[b, idx[b, i]] if ok[b, i] else 0."""
    idx: torch.Tensor       # (B, N) int32 rows into src
    ok: torch.Tensor        # (B, N) bool


class TileLevel(NamedTuple):
    keys: torch.Tensor      # (B, T) sorted tile keys, sentinel-padded
    num: torch.Tensor       # (B,) int32 live tiles
    occ: torch.Tensor       # (B, T, t^d) bool active cells
    halo: Halo26Spec


class TileDownLink(NamedTuple):
    children: Tuple[GatherSpec, ...]  # 2^d specs: coarse row <- fine tile row
    parents: Tuple[GatherSpec, ...]   # 2^d specs: fine row <- coarse
    #                                   corner-view row (8*parent + octant)
    overflow: torch.Tensor            # (B,) int32, always 0
    # the same maps as kernel A reads them, one launch a direction (None
    # on an identity link, which moves nothing):
    cidx: Optional[torch.Tensor] = None  # (B, 2^d, Tc) int32: children idx
    cok: Optional[torch.Tensor] = None   # (B, 2^d, Tc) bool: children ok
    idx2: Optional[torch.Tensor] = None  # (B, Tf) int32: the parents' idx
    #                                      (2^d * parent + octant), shared
    pok: Optional[torch.Tensor] = None   # (B, Tf) bool: the union of the
    #                                      parents' (disjoint) oks


class TileGraph(NamedTuple):
    levels: Tuple[TileLevel, ...]
    links: Tuple[TileDownLink, ...]
    feats0: torch.Tensor       # (B, T0, t^d, 1)
    vox_tile: torch.Tensor     # (B, Vin) int32
    vox_cell: torch.Tensor     # (B, Vin) int32
    input_valid: torch.Tensor  # (B, Vin) bool
    tile_spill: torch.Tensor   # (B,) int32 tiles dropped by capacity
    vox_spill: torch.Tensor    # (B,) int32 level-0 voxels of dropped tiles


def graph_overflows(graph: TileGraph) -> torch.Tensor:
    """Total dropped neighbor/link pairs (0 here: lookups are exact)."""
    tot = sum(lev.halo.overflow.sum() for lev in graph.levels)
    return tot + sum(link.overflow.sum() for link in graph.links)


def graph_spills(graph: TileGraph) -> torch.Tensor:
    """Tiles dropped because a level's tile capacity overflowed."""
    return graph.tile_spill.sum()


def tile_size_at(cfg: URESNetConfig, level: int) -> int:
    t = cfg.tile_sizes[level] if cfg.tile_sizes is not None else cfg.tile_size
    return min(t, cfg.level_spatial_size(level))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_capacity_at(cfg: URESNetConfig, level: int) -> int:
    """Static tile rows at `level`, exactly as the reference sizes them
    (including its quirks: a halving transition inherits the parent's
    capacity, and `tile_occupancy_at` ignores the spatial clamp)."""
    t = tile_size_at(cfg, level)
    if level > 0 and tile_size_at(cfg, level - 1) == 2 * t:
        return tile_capacity_at(cfg, level - 1)
    cap = max(cfg.min_tiles,
              int(np.ceil(cfg.level_capacity(level)
                          / cfg.tile_occupancy_at(level))))
    grid_tiles = (cfg.level_spatial_size(level) // t) ** cfg.data_dim
    cap = min(cap, grid_tiles)
    return _round_up(max(8, cap), min(256, _round_up(cap, 8)))


def _sort_unique(keys: torch.Tensor, cap: int):
    """(B, V) keys -> (unique sorted keys (B, cap), n_kept, n_dropped)."""
    skeys = torch.sort(keys, dim=1).values
    _, uniq, num, n_dropped = _dedup_sorted(skeys, cap)
    return uniq, num, n_dropped


def _cell_index(coords: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    cell = coords[..., 0] & (t - 1)
    for d in range(1, dim):
        cell = cell * t + (coords[..., d] & (t - 1))
    return cell


def build_tile_input(coords, values, n, spatial_size: int, t: int, Tcap: int,
                     merge_mode: str):
    """Bucket voxels into occupied tiles; merge duplicates per cell.

    coords (B, Vin, dim) int32, values (B, Vin), n (B,). Returns
    (tile_keys (B, Tcap), num, feats (B, Tcap, t^d), occ, vox_tile (B, Vin),
    vox_cell, n_spill, vox_spill)."""
    B, Vin, dim = coords.shape
    cells = t ** dim
    dev = coords.device
    rows = torch.arange(Vin, device=dev)
    valid = rows[None] < n[:, None]
    tkey = encode(coords >> int(np.log2(t)), valid, spatial_size // t)
    uniq, num, n_spill = _sort_unique(tkey, Tcap)

    vt, vt_ok = lookup(uniq, tkey)
    vox_tile = torch.where(vt_ok, vt, Tcap).to(torch.int32)
    vox_spill = (valid & ~vt_ok).sum(1, dtype=torch.int32)
    vox_cell = torch.where(valid, _cell_index(coords, t, dim),
                           0).to(torch.int32)

    # one extra column takes the dropped rows (the reference's mode="drop")
    nf = Tcap * cells
    flat = torch.where(vox_tile < Tcap, vox_tile * cells + vox_cell,
                       nf).long()
    occ = torch.zeros(B, nf + 1, dtype=torch.bool, device=dev)
    occ.scatter_(1, flat, valid)
    vals = torch.where(valid, values, 0.0)
    fsum = values.new_zeros(B, nf + 1).scatter_add_(1, flat, vals)
    if merge_mode == "sum":
        feats = fsum
    elif merge_mode == "mean":
        cnt = torch.zeros(B, nf + 1, device=dev).scatter_add_(
            1, flat, valid.float())
        feats = fsum / cnt.clamp(min=1.0)
    elif merge_mode == "max":
        feats = values.new_full((B, nf + 1), -float("inf")).scatter_reduce_(
            1, flat, torch.where(valid, values, -float("inf")), "amax")
        feats = torch.where(torch.isfinite(feats), feats, 0.0)
    elif merge_mode == "last":
        pos_last = torch.zeros(B, nf + 1, dtype=torch.long,
                               device=dev).scatter_reduce_(
            1, flat, torch.where(valid, rows[None], 0), "amax")
        feats = torch.where(occ, torch.gather(values, 1,
                                              pos_last.clamp(max=Vin - 1)),
                            0.0)
    else:
        raise ValueError(merge_mode)
    feats = feats[:, :nf].reshape(B, Tcap, cells)
    occ = occ[:, :nf].reshape(B, Tcap, cells)
    return (uniq, num, feats, occ, vox_tile, vox_cell, n_spill, vox_spill)


def _fold_occ_downsample(occ: torch.Tensor, t: int, dim: int) -> torch.Tensor:
    """(B, T, t^d) cell occupancy -> (B, T, (t/2)^d): a parent cell is
    occupied when any of its 2^d children is."""
    B, T, _ = occ.shape
    th = t // 2
    x = occ.reshape((B, T) + (th, 2) * dim).to(torch.int32)
    s = x.sum(dim=tuple(3 + 2 * d for d in range(dim)))
    return s.reshape(B, T, th ** dim) > 0


def _down_link(keys_f, occ_any, grid_f: int, dim: int, Tc: int):
    """Coarse keys (occupied parents), their count, the link (child gather
    specs, coarse <- fine, one per corner; per-octant parent specs, fine <-
    coarse corner view; both also stacked as kernel A reads them) and the
    coarse tiles dropped by capacity."""
    fc = decode(keys_f, grid_f, dim)
    valid = keys_f != SENTINEL
    grid_c = grid_f // 2
    keys_c, num_c, n_spill = _sort_unique(
        encode(fc >> 1, valid & occ_any, grid_c), Tc)

    cc = decode(keys_c, grid_c, dim)
    valid_c = keys_c != SENTINEL
    noct = 2 ** dim
    bits = torch.tensor([[(o >> (dim - 1 - d)) & 1 for d in range(dim)]
                         for o in range(noct)], dtype=torch.int32,
                        device=keys_f.device)                 # (2^d, dim)
    child_keys = encode(cc[:, None] * 2 + bits[None, :, None],
                        valid_c[:, None], grid_f)             # (B, 2^d, Tc)
    cidx, cok = lookup(keys_f, child_keys)
    children = tuple(GatherSpec(cidx[:, o].contiguous(),
                                cok[:, o].contiguous()) for o in range(noct))

    pidx, pok = lookup(keys_c, encode(fc >> 1, valid, grid_c))
    corner = torch.zeros_like(keys_f)
    for d in range(dim):
        corner = (corner << 1) | (fc[..., d] & 1)
    corner = corner.masked_fill(~valid, 0)
    idx2 = pidx * noct + corner
    parents = tuple(GatherSpec(idx2, pok & (corner == o))
                    for o in range(noct))
    link = TileDownLink(children, parents, torch.zeros_like(num_c),
                        cidx.contiguous(), cok.contiguous(),
                        idx2.contiguous(), pok.contiguous())
    return keys_c, num_c, link, n_spill


def build_tile_graph(coords, values, n_voxels,
                     cfg: URESNetConfig) -> TileGraph:
    """Padded blob tensors -> batched TileGraph.

    coords (B, Vin, dim) int32, values (B, Vin) float, n_voxels (B,) int32,
    all on one device."""
    from uresnet_pytorch_tpu_torch.ops.tile_conv import assemble_children
    S, dim, nlev = cfg.spatial_size, cfg.data_dim, cfg.uresnet_num_strides
    t0 = tile_size_at(cfg, 0)
    T0 = tile_capacity_at(cfg, 0)
    (keys, num, feats0, occ, vox_tile, vox_cell, tile_spill,
     vox_spill) = build_tile_input(coords, values, n_voxels, S, t0, T0,
                                   cfg.input_merge_mode)
    rows = torch.arange(coords.shape[1], device=coords.device)
    input_valid = rows[None] < n_voxels[:, None]

    levels, links = [], []
    for l in range(nlev):
        t_l = tile_size_at(cfg, l)
        G_l = cfg.level_spatial_size(l) // t_l
        levels.append(TileLevel(keys, num, occ, build_halo26(keys, G_l, dim)))
        if l == nlev - 1:
            break
        t_c = tile_size_at(cfg, l + 1)
        if t_c == t_l:
            Tc = min(tile_capacity_at(cfg, l + 1), keys.shape[1])
            keys_c, num_c, link, spill_c = _down_link(
                keys, occ.any(-1), G_l, dim, Tc)
            tile_spill = tile_spill + spill_c
            # coarse occupancy: each corner pulls its child's folded
            # occupancy (0/1 is exact in bf16, as in the reference)
            occ_h = _fold_occ_downsample(occ, t_l, dim)
            occ_c = assemble_children(
                occ_h[..., None].to(torch.bfloat16), link, t_c,
                dim)[..., 0] > 0
        else:
            # the tile edge halves with the grid: same tile rows, 8x fewer
            # cells, and both link directions are the identity
            assert t_c * 2 == t_l, (t_c, t_l)
            keys_c, num_c = keys, num
            ident = torch.arange(keys.shape[1], dtype=torch.int32,
                                 device=keys.device).expand_as(keys)
            spec = GatherSpec(ident, keys != SENTINEL)
            link = TileDownLink((spec,), (spec,), torch.zeros_like(num))
            occ_c = _fold_occ_downsample(occ, t_l, dim)
        links.append(link)
        keys, num, occ = keys_c, num_c, occ_c

    return TileGraph(tuple(levels), tuple(links), feats0[..., None],
                     vox_tile, vox_cell, input_valid, tile_spill, vox_spill)
