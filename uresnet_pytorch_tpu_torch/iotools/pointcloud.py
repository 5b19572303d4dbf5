"""Converters between the padded blob and the upstream flat point-cloud
format: an (N, dim+2) array of ``[x, y, z, batch_id, value]`` rows
concatenated over the batch; labels are the same with a class-id value
column. Port of `uresnet_pytorch_tpu/iotools/pointcloud.py`.
"""

from __future__ import annotations

import numpy as np
from typing import Dict, Tuple


def blob_to_pointcloud(blob: Dict[str, np.ndarray], key: str = "values") -> np.ndarray:
    """Padded blob -> reference (N, dim+2) [coords..., batch_id, value]."""
    rows = []
    vals = blob[key] if key in blob else blob["values"]
    for b in range(blob["coords"].shape[0]):
        n = int(blob["n_voxels"][b])
        c = blob["coords"][b, :n].astype(np.float32)
        bid = np.full((n, 1), b, np.float32)
        v = np.asarray(vals[b, :n], np.float32)[:, None]
        rows.append(np.concatenate([c, bid, v], axis=1))
    return np.concatenate(rows, axis=0) if rows else np.zeros((0, 0), np.float32)


def pointcloud_to_blob(pc: np.ndarray, max_voxels: int, data_dim: int,
                       label_pc: np.ndarray = None) -> Dict[str, np.ndarray]:
    """Reference (N, dim+2) point cloud -> padded blob (inverse of above)."""
    bids = pc[:, data_dim].astype(np.int32)
    B = int(bids.max()) + 1 if len(pc) else 1
    blob = {
        "coords": np.zeros((B, max_voxels, data_dim), np.int32),
        "values": np.zeros((B, max_voxels), np.float32),
        "n_voxels": np.zeros((B,), np.int32),
        "index": np.arange(B, dtype=np.int64),
    }
    if label_pc is not None:
        blob["label"] = np.zeros((B, max_voxels), np.int32)
    for b in range(B):
        sel = bids == b
        n = min(int(sel.sum()), max_voxels)
        rows = pc[sel][:n]
        blob["coords"][b, :n] = rows[:, :data_dim].astype(np.int32)
        blob["values"][b, :n] = rows[:, data_dim + 1]
        blob["n_voxels"][b] = n
        if label_pc is not None:
            blob["label"][b, :n] = label_pc[label_pc[:, data_dim] == b][:n, data_dim + 1].astype(np.int32)
    return blob
