"""IO base: blob contract, batch collation, threaded prefetch.

Port of `uresnet_pytorch_tpu/iotools/io_base.py`, behaviour for behaviour:
producer threads assemble batches ahead of compute; ``next()`` pops the
next blob. Blob contract (numpy, fixed shapes):

  coords   (B, V, dim) int32   voxel coordinates, zero-padded
  values   (B, V)      f32     voxel charge
  label    (B, V)      i32     per-voxel class id   (when a label key is read)
  weight   (B, V)      f32     per-voxel loss weight (when a weight key is read)
  n_voxels (B,)        i32     valid-row count per event (<= V)
  index    (B,)        i64     dataset event indices

V = cfg.max_voxels. Events longer than V are truncated (counted in
``self.truncated``). Each epoch's order comes from
``np.random.default_rng((seed, epoch))``, as in the reference, so the same
events arrive in the same order. Under torch.distributed each rank samples
the rank-strided share of every epoch, batch_size / world events a batch,
so that a step's ranks together hold the single-process batch's events;
otherwise stride 1, offset 0. The
flat point-cloud format (N, dim+2) is in
:mod:`uresnet_pytorch_tpu_torch.iotools.pointcloud`.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from uresnet_pytorch_tpu_torch.config import URESNetConfig


class IOBase:
    """Subclasses implement ``_read_event(index) -> {key: (coords, values)}``
    and set ``self._num_entries``."""

    def __init__(self, cfg: URESNetConfig):
        self.cfg = cfg
        self._num_entries = 0
        self._queue: Optional[queue.Queue] = None
        self._threads = []
        self._stop = threading.Event()
        self.truncated = 0
        self._epoch_order: Optional[np.ndarray] = None
        self._cursor = 0
        self._epoch_counter = 0
        self._pred_writer = None
        # data parallelism: each rank samples a disjoint strided subset of
        # every epoch. A single process sees stride 1 / offset 0.
        self.sampler_stride = 1
        self.sampler_offset = 0
        if dist.is_available() and dist.is_initialized():
            self.sampler_stride = dist.get_world_size()
            self.sampler_offset = dist.get_rank()

    # -------- subclass interface --------
    def _read_event(self, index: int) -> Dict[str, tuple]:
        raise NotImplementedError

    # -------- public API (reference parity: initialize/next/finalize) ------
    def __len__(self) -> int:
        return self._num_entries

    @property
    def num_entries(self) -> int:
        return self._num_entries

    def initialize(self) -> None:
        self._queue = queue.Queue(maxsize=max(1, self.cfg.prefetch_depth))
        self._stop.clear()
        n = max(1, self.cfg.num_threads)
        for _ in range(n):
            t = threading.Thread(target=self._producer, daemon=True)
            t.start()
            self._threads.append(t)

    def next(self) -> Dict[str, np.ndarray]:
        item = self._queue.get()
        if isinstance(item, _ProducerError):
            self._stop.set()
            raise RuntimeError("io producer thread failed") from item.exc
        return item

    def finalize(self) -> None:
        self._stop.set()
        # drain so producers blocked on put() can observe the stop flag
        while self._threads and any(t.is_alive() for t in self._threads):
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            for t in self._threads:
                t.join(timeout=0.05)
        self._threads = []
        if self._pred_writer is not None:
            self._pred_writer.close()
            self._pred_writer = None

    def store_segment(self, index, blob, softmax) -> None:
        if self._pred_writer is None:
            from uresnet_pytorch_tpu_torch.iotools.writer import PredictionWriter
            self._pred_writer = PredictionWriter(self.cfg)
        self._pred_writer.store_segment(index, blob, softmax)

    # -------- batching --------
    def _next_indices(self) -> np.ndarray:
        # a rank's share of the global batch: the ranks' batches of one
        # step are together the events of one single-process batch
        bs = self.cfg.batch_size // self.sampler_stride
        out = np.empty(bs, dtype=np.int64)
        for i in range(bs):
            if self._epoch_order is None or self._cursor >= len(self._epoch_order):
                order = np.arange(self._num_entries)
                if self.cfg.shuffle:
                    # epoch permutation seeded by (seed, epoch) ONLY — never
                    # by which producer thread happened to trigger the
                    # reshuffle. Disjoint sharding requires every rank to
                    # compute the identical permutation; a thread-scheduling-
                    # dependent RNG draw here would make shards overlap or
                    # miss samples.
                    epoch_rng = np.random.default_rng(
                        (self.cfg.seed, self._epoch_counter))
                    epoch_rng.shuffle(order)
                self._epoch_counter += 1
                # process-strided shard of the epoch (no-op single-process)
                shard = order[self.sampler_offset::self.sampler_stride]
                order = shard if len(shard) else order
                self._epoch_order = order
                self._cursor = 0
            out[i] = self._epoch_order[self._cursor]
            self._cursor += 1
        return out

    def _producer(self) -> None:
        while not self._stop.is_set():
            try:
                with _sampler_lock:
                    indices = self._next_indices()
                blob = self.collate(
                    [self._read_event(int(i)) for i in indices], indices)
            except Exception as e:  # surface errors to the consumer
                blob = _ProducerError(e)
            while not self._stop.is_set():
                try:
                    self._queue.put(blob, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(blob, _ProducerError):
                return

    def collate(self, events, indices) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, V, dim = len(events), cfg.max_voxels, cfg.data_dim
        from uresnet_pytorch_tpu_torch.utils import native
        if native.available():
            return self._collate_native(events, indices, B, V, dim)
        return self._collate_python(events, indices, B, V, dim)

    def _collate_native(self, events, indices, B, V, dim) -> Dict[str, np.ndarray]:
        """Single-pass native collation (utils/uresnet_native.cpp)."""
        from uresnet_pytorch_tpu_torch.utils import native
        has_label = any("label" in ev for ev in events)
        has_weight = any("weight" in ev for ev in events)
        coords = np.concatenate([ev["data"][0][:, :dim] for ev in events])
        values = np.concatenate([ev["data"][1] for ev in events])
        splits = np.zeros(B + 1, np.int64)
        np.cumsum([len(ev["data"][0]) for ev in events], out=splits[1:])
        labels = (np.concatenate([ev["label"][1] for ev in events])
                  if has_label else None)
        weights = (np.concatenate([ev["weight"][1] for ev in events])
                   if has_weight else None)
        oc, ov, ol, ow, on, truncated = native.collate(
            coords, values, labels, weights, splits, B, V, dim)
        self.truncated += truncated
        blob = {"coords": oc, "values": ov, "n_voxels": on,
                "index": np.asarray(indices, np.int64)}
        if ol is not None:
            blob["label"] = ol
        if ow is not None:
            blob["weight"] = ow
        return blob

    def _collate_python(self, events, indices, B, V, dim) -> Dict[str, np.ndarray]:
        blob: Dict[str, np.ndarray] = {
            "coords": np.zeros((B, V, dim), np.int32),
            "values": np.zeros((B, V), np.float32),
            "n_voxels": np.zeros((B,), np.int32),
            "index": np.asarray(indices, np.int64),
        }
        keys = set()
        for ev in events:
            keys.update(ev.keys())
        if "label" in keys:
            blob["label"] = np.zeros((B, V), np.int32)
        if "weight" in keys:
            blob["weight"] = np.zeros((B, V), np.float32)
        for b, ev in enumerate(events):
            coords, values = ev["data"]
            n = len(coords)
            if n > V:
                self.truncated += 1
                coords, values = coords[:V], values[:V]
                n = V
            blob["coords"][b, :n] = coords[:, :dim]
            blob["values"][b, :n] = values
            blob["n_voxels"][b] = n
            if "label" in ev:
                blob["label"][b, :n] = ev["label"][1][:n].astype(np.int32)
            if "weight" in ev:
                blob["weight"][b, :n] = ev["weight"][1][:n]
        return blob


# The sampler state (epoch order/cursor) is shared across producer threads.
_sampler_lock = threading.Lock()


class _ProducerError:
    """Sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: Exception):
        self.exc = exc
