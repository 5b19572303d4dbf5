"""Voxel-coordinate keys: integer coords packed into sortable int32 scalars.

Port of `uresnet_pytorch_tpu/ops/coords.py` (encode/decode/lookup) and of
`_dedup_sorted` from `ops/sparse_graph.py`. Every function is batched: the
leading axis is the event, where the reference vmaps a per-event function.

The reference's `lookup_monotone`, `compact_marked` and `flat_cumsum` work
around a slow sort on the TPU. Here `lookup` is an exact
`torch.searchsorted`, which equals `lookup_monotone` wherever the latter
reports no dropped queries.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)


def check_key_capacity(spatial_size: int, data_dim: int) -> int:
    bits = max(1, int(np.ceil(np.log2(spatial_size))))
    if data_dim * bits > 30:
        raise ValueError(
            f"coordinate key needs {data_dim * bits} bits > 30; reduce "
            f"spatial_size (per-axis bits={bits}, dim={data_dim})")
    return bits


def encode(coords: torch.Tensor, valid: torch.Tensor,
           spatial_size: int) -> torch.Tensor:
    """(..., dim) int coords + (...) bool valid -> (...) int32 keys.

    Out-of-bounds coordinates and invalid rows map to SENTINEL."""
    dim = coords.shape[-1]
    bits = check_key_capacity(spatial_size, dim)
    in_bounds = ((coords >= 0) & (coords < spatial_size)).all(-1)
    c = coords.to(torch.int32)
    key = c[..., 0]
    for d in range(1, dim):
        key = (key << bits) | c[..., d]
    return key.masked_fill(~(valid & in_bounds), SENTINEL)


def decode(keys: torch.Tensor, spatial_size: int,
           data_dim: int) -> torch.Tensor:
    """(...) int32 keys -> (..., dim) int32 coords (sentinel rows -> 0)."""
    bits = check_key_capacity(spatial_size, data_dim)
    mask = (1 << bits) - 1
    k = keys.masked_fill(keys == SENTINEL, 0)
    cs = []
    for _ in range(data_dim):
        cs.append(k & mask)
        k = k >> bits
    return torch.stack(cs[::-1], dim=-1)


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """Resolve query keys against per-event sorted (sentinel-padded) keys.

    sorted_keys (B, V), queries (B, ...). Returns (idx int32, found bool),
    both shaped like `queries`; idx is 0 where not found."""
    B, V = sorted_keys.shape
    q = queries.reshape(B, -1).contiguous()
    pos = torch.searchsorted(sorted_keys.contiguous(), q).clamp_(0, V - 1)
    found = (torch.gather(sorted_keys, 1, pos) == q) & (q != SENTINEL)
    idx = pos.masked_fill_(~found, 0).to(torch.int32)
    return idx.reshape(queries.shape), found.reshape(queries.shape)


def _dedup_sorted(skeys: torch.Tensor, cap_out: int):
    """Sorted keys (B, V) -> (segment id per sorted row (cap_out = dropped),
    unique sorted keys (B, cap_out), n_unique kept (B,), n_dropped (B,))."""
    B = skeys.shape[0]
    valid = skeys != SENTINEL
    prev = torch.cat([skeys.new_full((B, 1), SENTINEL), skeys[:, :-1]], 1)
    first = (skeys != prev) & valid
    seg = torch.cumsum(first, 1) - 1
    n_unique = first.sum(1, dtype=torch.int32)
    seg = torch.where(valid & (seg < cap_out), seg, cap_out)
    # rows of one segment all hold the same key, so a plain scatter is
    # deterministic; the extra column takes invalid and dropped rows
    uniq = skeys.new_full((B, cap_out + 1), SENTINEL)
    uniq.scatter_(1, seg, skeys)
    n_kept = n_unique.clamp(max=cap_out)
    return seg, uniq[:, :cap_out], n_kept, n_unique - n_kept
