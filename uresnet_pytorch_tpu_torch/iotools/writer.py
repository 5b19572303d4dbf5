"""Per-voxel prediction writer (HDF5), buffered.

Port of `uresnet_pytorch_tpu/iotools/writer.py`: the same file, dataset
for dataset. The schema is the input event schema (h5_io.py) plus a full
softmax dataset:

  /prediction/coords      (T, dim) i32
  /prediction/values      (T,)     f32   argmax class id
  /prediction/softmax     (T, C)   f32
  /prediction/row_splits  (E+1,)   i64
  /prediction/entries     (E,)     i64   original dataset indices

Events buffer in host RAM and flush to disk in multi-event chunks (one
h5 resize per chunk per dataset).
"""

from __future__ import annotations

import threading

import numpy as np

from uresnet_pytorch_tpu_torch.config import URESNetConfig

# flush when the buffered voxel payload reaches this many rows
_FLUSH_ROWS = 1 << 20


class PredictionWriter:
    def __init__(self, cfg: URESNetConfig, flush_rows: int = _FLUSH_ROWS):
        if not cfg.output_file:
            raise ValueError("store_segment requires --output-file")
        self.cfg = cfg
        self._f = None
        self._lock = threading.Lock()
        self._flush_rows = flush_rows
        self._buf = {"coords": [], "values": [], "softmax": []}
        self._splits = []          # per-event voxel counts (buffered)
        self._entries = []
        self._buf_rows = 0

    def _ensure_open(self):
        import h5py
        if self._f is not None:
            return
        cfg = self.cfg
        f = h5py.File(cfg.output_file, "w")
        meta = f.create_group("meta")
        meta.attrs["spatial_size"] = cfg.spatial_size
        meta.attrs["data_dim"] = cfg.data_dim
        g = f.create_group("prediction")
        dim, nc = cfg.data_dim, cfg.num_class
        g.create_dataset("coords", (0, dim), maxshape=(None, dim), dtype="i4")
        g.create_dataset("values", (0,), maxshape=(None,), dtype="f4")
        g.create_dataset("softmax", (0, nc), maxshape=(None, nc), dtype="f4")
        g.create_dataset("row_splits", data=np.zeros(1, "i8"), maxshape=(None,))
        g.create_dataset("entries", (0,), maxshape=(None,), dtype="i8")
        self._f = f

    def store_segment(self, index, blob, softmax) -> None:
        with self._lock:
            softmax = np.asarray(softmax)
            for b in range(len(blob["index"])):
                n = int(blob["n_voxels"][b])
                sm = np.ascontiguousarray(softmax[b, :n])
                self._buf["coords"].append(
                    np.ascontiguousarray(blob["coords"][b, :n]))
                self._buf["values"].append(
                    sm.argmax(axis=-1).astype(np.float32))
                self._buf["softmax"].append(sm)
                self._splits.append(n)
                self._entries.append(int(blob["index"][b]))
                self._buf_rows += n
            if self._buf_rows >= self._flush_rows:
                self._flush()

    def _flush(self) -> None:
        """One resize + one write per dataset for the whole buffered chunk.
        Caller holds the lock."""
        if not self._splits:
            return
        self._ensure_open()
        g = self._f["prediction"]
        t = g["coords"].shape[0]
        n_new = self._buf_rows
        for name in ("coords", "values", "softmax"):
            arr = np.concatenate(self._buf[name], axis=0)
            g[name].resize(t + n_new, axis=0)
            g[name][t:] = arr
            self._buf[name] = []
        rs = g["row_splits"]
        e0 = rs.shape[0]
        rs.resize(e0 + len(self._splits), axis=0)
        rs[e0:] = t + np.cumsum(self._splits)
        ent = g["entries"]
        ent.resize(e0 - 1 + len(self._entries), axis=0)
        ent[e0 - 1:] = self._entries
        self._splits, self._entries, self._buf_rows = [], [], 0

    def close(self) -> None:
        with self._lock:
            self._flush()
            if self._f is not None:
                self._f.close()
                self._f = None
