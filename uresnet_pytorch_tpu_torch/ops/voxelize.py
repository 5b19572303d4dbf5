"""Row validity of padded voxel buffers.

The port's copy of `valid_mask` from `uresnet_pytorch_tpu/ops/voxelize.py`
(the loss needs it; the dense voxelizer is not ported yet).
"""

from __future__ import annotations

import torch


def valid_mask(n_voxels: torch.Tensor, capacity: int) -> torch.Tensor:
    """(B,) counts -> (B, V) row-validity mask."""
    rows = torch.arange(capacity, device=n_voxels.device)
    return rows[None] < n_voxels[:, None]
