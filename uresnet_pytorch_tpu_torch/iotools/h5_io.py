"""HDF5 event file format (reader/writer).

Port of `uresnet_pytorch_tpu/iotools/h5_io.py`; files written by either
package read in both. The schema mirrors LArCV's EventSparseTensor:

  /meta/spatial_size   int         volume edge in voxels
  /meta/data_dim       int         2 or 3
  /<key>/coords        (T, dim) i32   concatenated voxel coords, all events
  /<key>/values        (T,)     f32   voxel values (charge / class id / weight)
  /<key>/row_splits    (E+1,)   i64   CSR offsets: event e = [row_splits[e], row_splits[e+1])

where <key> is one of data_keys (e.g. ``data``, ``label``, ``weight``). Keys
share coords row-for-row with ``data``.
"""

from __future__ import annotations

import numpy as np
import h5py
from typing import Dict, List, Sequence, Tuple


def write_events(path: str, events: Dict[str, List[Tuple[np.ndarray, np.ndarray]]],
                 spatial_size: int, data_dim: int,
                 compression: str = None) -> None:
    """events: key -> list of (coords (N,dim) int32, values (N,) float32).

    Default is UNCOMPRESSED contiguous datasets: the reader then serves
    events from a zero-copy memmap fast path that bypasses libhdf5's global
    lock entirely (the lock and gzip serialize multi-threaded reads). Pass
    compression='gzip' to trade read throughput for disk."""
    with h5py.File(path, "w") as f:
        meta = f.create_group("meta")
        meta.attrs["spatial_size"] = spatial_size
        meta.attrs["data_dim"] = data_dim
        kw = {}
        if compression:
            kw = dict(compression=compression, compression_opts=1)
        for key, evs in events.items():
            g = f.create_group(key)
            coords = np.concatenate([c for c, _ in evs], axis=0).astype(np.int32)
            values = np.concatenate([v for _, v in evs], axis=0).astype(np.float32)
            splits = np.zeros(len(evs) + 1, dtype=np.int64)
            np.cumsum([len(c) for c, _ in evs], out=splits[1:])
            g.create_dataset("coords", data=coords, **kw)
            g.create_dataset("values", data=values, **kw)
            g.create_dataset("row_splits", data=splits)


class H5Reader:
    """Random-access reader over one or more files sharing the schema.

    Concurrency, fastest path first:
      * contiguous UNCOMPRESSED datasets (the write_events default) are
        served from numpy memmaps — zero-copy page-cache slices with no
        libhdf5 involvement, so producer threads scale freely (libhdf5
        holds a GLOBAL lock that serializes even separate handles).
      * chunked/compressed datasets fall back to h5py with per-thread
        handles (thread-local), still lock-free at the Python level.
    CSR row_splits are tiny and cached in memory at open, removing two h5
    dataset reads per key per event."""

    def __init__(self, paths: Sequence[str], data_keys: Sequence[str]):
        import threading
        if not paths:
            raise ValueError("h5 io requires at least one --input-file")
        self._paths = list(paths)
        self.data_keys = tuple(data_keys)
        self._local = threading.local()
        self._handles_lock = threading.Lock()
        self._all_handles: List[h5py.File] = []
        self._splits: List[Dict[str, np.ndarray]] = []
        self._mmaps: List[Dict[str, tuple]] = []  # key -> (coords, values)
        self._counts = []
        for p in self._paths:
            with h5py.File(p, "r") as f:
                if not self._counts:
                    self.spatial_size = int(f["meta"].attrs["spatial_size"])
                    self.data_dim = int(f["meta"].attrs["data_dim"])
                splits, mmaps = {}, {}
                for key in self.data_keys:
                    if key not in f:
                        raise KeyError(f"key {key!r} missing from {p}")
                    splits[key] = np.asarray(f[key]["row_splits"])
                    mm = []
                    for name in ("coords", "values"):
                        ds = f[key][name]
                        off = ds.id.get_offset()
                        if ds.chunks is None and ds.compression is None \
                                and off is not None:
                            mm.append(np.memmap(p, dtype=ds.dtype, mode="r",
                                                shape=ds.shape, offset=off))
                        else:
                            mm.append(None)
                    mmaps[key] = tuple(mm)
                self._splits.append(splits)
                self._mmaps.append(mmaps)
                self._counts.append(len(splits[self.data_keys[0]]) - 1)
        self._cum = np.concatenate([[0], np.cumsum(self._counts)])
        self._closed = False

    def _thread_files(self) -> List[h5py.File]:
        files = getattr(self._local, "files", None)
        if files is None:
            files = [h5py.File(p, "r") for p in self._paths]
            self._local.files = files
            with self._handles_lock:
                if self._closed:  # lost the race with close(): give up
                    for f in files:
                        f.close()
                    raise RuntimeError("H5Reader is closed")
                self._all_handles.extend(files)
        return files

    def __len__(self) -> int:
        return int(self._cum[-1])

    def read(self, index: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        fi = int(np.searchsorted(self._cum, index, side="right") - 1)
        local = index - int(self._cum[fi])
        splits = self._splits[fi]
        mmaps = self._mmaps[fi]
        out = {}
        f = None
        for key in self.data_keys:
            s, e = int(splits[key][local]), int(splits[key][local + 1])
            mc, mv = mmaps[key]
            if mc is not None and mv is not None:
                out[key] = (np.asarray(mc[s:e]), np.asarray(mv[s:e]))
                continue
            if f is None:
                f = self._thread_files()[fi]
            g = f[key]
            out[key] = (np.asarray(g["coords"][s:e]),
                        np.asarray(g["values"][s:e]))
        return out

    def close(self) -> None:
        with self._handles_lock:
            self._closed = True
            for f in self._all_handles:
                try:
                    f.close()
                except Exception:
                    pass
            self._all_handles = []


def generate_h5_file(path: str, n_events: int, spatial_size: int, data_dim: int = 3,
                     seed: int = 0, mean_voxels: int = 2048,
                     keys: Sequence[str] = ("data", "label")) -> str:
    """Write a synthetic-event fixture file (tests, iotest, benchmarks)."""
    from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
    events: Dict[str, list] = {k: [] for k in keys}
    for i in range(n_events):
        coords, vals, labs = generate_event(seed, i, spatial_size, data_dim, mean_voxels)
        for k in keys:
            if k == "data":
                events[k].append((coords, vals))
            elif k == "label":
                events[k].append((coords, labs.astype(np.float32)))
            elif k == "weight":
                # simple class-balancing weights as a fixture
                counts = np.bincount(labs, minlength=5).astype(np.float32)
                w = 1.0 / np.maximum(counts[labs], 1.0)
                events[k].append((coords, (w / w.mean()).astype(np.float32)))
            else:
                raise KeyError(k)
    write_events(path, events, spatial_size, data_dim)
    return path
