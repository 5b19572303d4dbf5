"""On-device voxelization: padded sparse blob <-> dense volume.

Port of `uresnet_pytorch_tpu/ops/voxelize.py`: the dense model scatters
the blob's O(N) rows into its volume on the device and gathers per-voxel
logits back, so the host never builds the volume. Volumes are
channels-last, `(B, S, ..., S, C)`, as in the reference.
"""

from __future__ import annotations

import torch


def _flat_indices(coords: torch.Tensor, valid: torch.Tensor,
                  spatial_size: int) -> torch.Tensor:
    """(B, V, dim) int coords -> (B, V) int32 flattened cell index;
    invalid rows -> 0."""
    dim = coords.shape[-1]
    flat = coords[..., 0].to(torch.int32)
    for d in range(1, dim):
        flat = flat * spatial_size + coords[..., d]
    return torch.where(valid, flat, 0)


def valid_mask(n_voxels: torch.Tensor, capacity: int) -> torch.Tensor:
    """(B,) counts -> (B, V) row-validity mask."""
    rows = torch.arange(capacity, device=n_voxels.device)
    return rows[None] < n_voxels[:, None]


def voxelize(coords: torch.Tensor, values: torch.Tensor,
             n_voxels: torch.Tensor, spatial_size: int) -> torch.Tensor:
    """Scatter sparse (B, V) values into a dense (B, S, ..., S, 1) volume.

    Padding rows carry value 0 into cell 0, so the add-scatter leaves the
    volume exact (input coordinates are unique per event by loader
    contract)."""
    B, V, dim = coords.shape
    mask = valid_mask(n_voxels, V)
    flat = _flat_indices(coords, mask, spatial_size).long()
    vals = torch.where(mask, values, 0.0)
    vol = vals.new_zeros(B, spatial_size ** dim).scatter_add_(1, flat, vals)
    return vol.reshape((B,) + (spatial_size,) * dim + (1,))


def gather_voxels(volume: torch.Tensor, coords: torch.Tensor,
                  n_voxels: torch.Tensor, spatial_size: int) -> torch.Tensor:
    """Per-voxel rows (B, V, C) of a dense (B, S..., C) volume at sparse
    coords; rows beyond n_voxels read cell 0 (masked downstream)."""
    B, V, _ = coords.shape
    C = volume.shape[-1]
    flat = _flat_indices(coords, valid_mask(n_voxels, V), spatial_size)
    return torch.gather(volume.reshape(B, -1, C), 1,
                        flat.long()[..., None].expand(-1, -1, C))
