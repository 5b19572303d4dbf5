"""HDF5-backed IO. Port of `uresnet_pytorch_tpu/iotools/io_h5.py`; the
prediction writer for ``store_segment`` is `writer.py`."""

from __future__ import annotations

import numpy as np
from typing import Dict

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools.io_base import IOBase
from uresnet_pytorch_tpu_torch.iotools.h5_io import H5Reader


class IOH5(IOBase):
    def __init__(self, cfg: URESNetConfig):
        super().__init__(cfg)
        # positional --data-keys: first key = data, second = label, third =
        # weight
        keys = list(cfg.data_keys)
        if cfg.weight_key and cfg.weight_key not in keys:
            keys.append(cfg.weight_key)
        canon_names = ["data", "label", "weight"]
        self._key_map = {canon_names[i]: k for i, k in enumerate(keys[:3])}
        if cfg.weight_key:
            self._key_map["weight"] = cfg.weight_key
        paths = list(cfg.input_file)
        if cfg.limit_num_files > 0:
            paths = paths[: cfg.limit_num_files]
        self._reader = H5Reader(paths, list(self._key_map.values()))
        self._num_entries = len(self._reader)
        if self._reader.data_dim != cfg.data_dim:
            raise ValueError(
                f"file data_dim {self._reader.data_dim} != config {cfg.data_dim}")

    def _read_event(self, index: int) -> Dict[str, tuple]:
        # no lock: H5Reader keeps per-thread file handles, so producer
        # threads read concurrently
        raw = self._reader.read(index)
        return {canon: raw[real] for canon, real in self._key_map.items()}

    def finalize(self) -> None:
        super().finalize()
        self._reader.close()
