"""Sparse coordinate graph of the row-gather engine.

Port of `uresnet_pytorch_tpu/ops/sparse_graph.py`, batched over the
leading event axis where the reference vmaps a per-event builder:

- each level's active set is a sorted int32 key array of static
  capacity, sentinel-padded (lookups are binary searches, `ops/coords.py`);
- submanifold rules give, for each of the 3^d offsets (`kernel_offsets`,
  raster order, last axis fastest), each site's neighbor row in the same
  key array and whether it exists;
- a stride-2 link gives each fine site its coarse parent row (`cap_c`
  where padding or dropped by capacity) and which of the 2^d corners it
  occupies; per corner the fine -> coarse map is injective.

Integer outputs match the reference bitwise, except `nbr_idx` where
`nbr_ok` is false: the reference's `lookup` leaves garbage there, the
port's leaves 0.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.ops.coords import (SENTINEL, _dedup_sorted,
                                                  decode, encode, lookup)


class SparseLevel(NamedTuple):
    """One resolution level's active set and submanifold rulebook."""
    keys: torch.Tensor      # (B, V) int32, sorted ascending, SENTINEL padding
    num: torch.Tensor       # (B,) int32 active count
    nbr_idx: torch.Tensor   # (B, K, V) int32 neighbor row per kernel offset
    nbr_ok: torch.Tensor    # (B, K, V) bool


class DownLink(NamedTuple):
    """Stride-2 correspondence between level l (fine) and l+1 (coarse)."""
    parent: torch.Tensor    # (B, Vf) int32 row in coarse level; == Vc dropped
    offset: torch.Tensor    # (B, Vf) int32 corner id in [0, 2^d)
    overflow: torch.Tensor  # (B,) int32 coarse sites dropped for capacity


class SparseGraph(NamedTuple):
    levels: Tuple[SparseLevel, ...]
    links: Tuple[DownLink, ...]
    feats0: torch.Tensor        # (B, V0, 1) merged input features
    row_of_input: torch.Tensor  # (B, Vin) int32: blob row -> level-0 row
    input_valid: torch.Tensor   # (B, Vin) bool


def kernel_offsets(data_dim: int, kernel_size: int = 3) -> np.ndarray:
    """Static (K, dim) offset table in SCN's raster order (last axis
    fastest, -r..r); the importers depend on this order."""
    r = kernel_size // 2
    grids = np.meshgrid(*([np.arange(-r, r + 1)] * data_dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def build_input_level(coords: torch.Tensor, values: torch.Tensor,
                      n: torch.Tensor, spatial_size: int, cap: int,
                      merge_mode: str):
    """SCN's InputLayer: encode, stable sort, dedupe with the configured
    duplicate merge.

    coords (B, Vin, dim), values (B, Vin), n (B,). Returns (keys (B, cap),
    num (B,), feats (B, cap), row_of_input (B, Vin), rep (B, cap)): `rep`
    is the first blob row (in input order) of each level-0 row, and
    `row_of_input` inverts it (`cap` for invalid or dropped rows)."""
    B, Vin, _ = coords.shape
    dev = coords.device
    rows = torch.arange(Vin, device=dev)
    valid = rows[None] < n[:, None]
    keys = encode(coords, valid, spatial_size)
    skeys, order = torch.sort(keys, dim=1, stable=True)
    svals = torch.gather(values, 1, order)
    seg, uniq, num, _ = _dedup_sorted(skeys, cap)

    def into(fill, src, reduce=None):
        """Per-segment reduction of src (B, Vin) into (B, cap), starting
        from fill; the extra column takes the dropped rows (the
        reference's mode="drop")."""
        out = torch.full((B, cap + 1), fill, dtype=src.dtype, device=dev)
        if reduce is None:
            out.scatter_add_(1, seg, src)
        else:
            out.scatter_reduce_(1, seg, src, reduce)
        return out[:, :cap]

    ssum = into(0.0, svals)
    if merge_mode == "sum":
        feats = ssum
    elif merge_mode == "mean":
        cnt = into(0.0, torch.ones_like(svals, dtype=torch.float32))
        feats = ssum / cnt.clamp(min=1.0)
    elif merge_mode == "max":
        feats = into(-float("inf"), svals, "amax")
        feats = torch.where(torch.isfinite(feats), feats, 0.0)
    elif merge_mode == "last":
        # the stable sort keeps input order within a segment: the last
        # sorted position wins; empty rows read sorted position 0, as in
        # the reference
        pos_last = into(0, rows[None].expand(B, Vin), "amax")
        feats = torch.gather(svals, 1, pos_last)
    else:
        raise ValueError(merge_mode)

    rep = into(Vin, order, "amin")
    rep = torch.where(rep == Vin, 0, rep).to(torch.int32)
    row_of_input = torch.full((B, Vin), cap, dtype=torch.long, device=dev)
    row_of_input.scatter_(1, order, seg)
    return uniq, num, feats, row_of_input.to(torch.int32), rep


def submanifold_rules(keys: torch.Tensor, spatial_size: int, data_dim: int,
                      kernel_size: int = 3):
    """(B, V) sorted keys -> per-offset neighbor rows (B, K, V) int32 and
    their validity (B, K, V), by binary search (SCN's
    getSubmanifoldRuleBook); the center offset pairs each row with
    itself."""
    offsets = torch.from_numpy(kernel_offsets(data_dim, kernel_size)).to(
        keys.device)
    coords = decode(keys, spatial_size, data_dim)
    valid = keys != SENTINEL
    nkeys = encode(coords[:, None] + offsets[None, :, None],
                   valid[:, None].expand(-1, len(offsets), -1), spatial_size)
    idx, ok = lookup(keys, nkeys)
    center = (len(offsets) - 1) // 2
    idx[:, center] = torch.arange(keys.shape[1], dtype=torch.int32,
                                  device=keys.device)
    ok[:, center] = valid
    return idx, ok


def downsample_link(keys_f: torch.Tensor, spatial_size: int, data_dim: int,
                    cap_c: int):
    """Stride-2 rules (SCN's ConvolutionRules): the coarse active set (the
    unique parent cells) and, per fine site, its coarse row and corner.
    Returns (keys_c (B, cap_c), num_c, parent (B, Vf), corner, dropped)."""
    coords = decode(keys_f, spatial_size, data_dim)
    valid = keys_f != SENTINEL
    pkey = encode(coords >> 1, valid, max(1, spatial_size // 2))
    spk, porder = torch.sort(pkey, dim=1, stable=True)
    seg, uniq, num_c, dropped = _dedup_sorted(spk, cap_c)
    parent = torch.full_like(seg, cap_c).scatter_(1, porder, seg)
    corner = torch.zeros_like(keys_f)
    for d in range(data_dim):
        corner = (corner << 1) | (coords[..., d] & 1)
    corner = corner.masked_fill(~valid, 0)
    return uniq, num_c, parent.to(torch.int32), corner, dropped


def build_graph(coords: torch.Tensor, values: torch.Tensor,
                n_voxels: torch.Tensor, cfg: URESNetConfig):
    """Padded blob tensors -> (SparseGraph, rep): every level's rules and
    every link, rebuilt per batch on the blob's device."""
    S, dim = cfg.spatial_size, cfg.data_dim
    nlev = cfg.uresnet_num_strides
    keys, num, feats0, row_of_input, rep = build_input_level(
        coords, values, n_voxels, S, cfg.level_capacity(0),
        cfg.input_merge_mode)
    rows = torch.arange(coords.shape[1], device=coords.device)
    input_valid = rows[None] < n_voxels[:, None]

    levels, links = [], []
    for l in range(nlev):
        S_l = cfg.level_spatial_size(l)
        levels.append(SparseLevel(keys, num,
                                  *submanifold_rules(keys, S_l, dim)))
        if l < nlev - 1:
            keys, num, parent, corner, dropped = downsample_link(
                keys, S_l, dim, cfg.level_capacity(l + 1))
            links.append(DownLink(parent, corner, dropped))
    return SparseGraph(tuple(levels), tuple(links), feats0[..., None],
                       row_of_input, input_valid), rep


def gather_rows(batched: torch.Tensor, idx: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """(B, V, ...) values gathered at (B, R) row indices; rows out of
    range read `fill`."""
    V = batched.shape[1]
    ok = (idx >= 0) & (idx < V)
    safe = torch.where(ok, idx, 0).long()
    tail = batched.shape[2:]
    g = torch.gather(batched, 1, safe.view(safe.shape + (1,) * len(tail))
                     .expand(safe.shape + tail))
    return torch.where(ok.view(ok.shape + (1,) * len(tail)), g,
                       torch.full((), fill, dtype=g.dtype, device=g.device))
