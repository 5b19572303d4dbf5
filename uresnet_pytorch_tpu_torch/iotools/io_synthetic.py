"""On-the-fly synthetic-event IO: no files needed. Port of
`uresnet_pytorch_tpu/iotools/io_synthetic.py`, on the port's
`generate_event` (the same events per seed and index)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools.io_base import IOBase
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event


class IOSynthetic(IOBase):
    def __init__(self, cfg: URESNetConfig, n_events: int = 1024,
                 mean_voxels: int = 2048):
        super().__init__(cfg)
        self._num_entries = n_events
        self._mean_voxels = mean_voxels

    def _read_event(self, index: int) -> Dict[str, tuple]:
        coords, vals, labs = generate_event(
            self.cfg.seed, index, self.cfg.spatial_size, self.cfg.data_dim,
            self._mean_voxels)
        ev = {"data": (coords, vals), "label": (coords, labs.astype(np.float32))}
        if self.cfg.weight_key:
            counts = np.bincount(labs, minlength=self.cfg.num_class).astype(np.float32)
            w = 1.0 / np.maximum(counts[labs], 1.0)
            ev["weight"] = (coords, (w / w.mean()).astype(np.float32))
        return ev
