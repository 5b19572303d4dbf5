"""The benchmark's events: a frozen copy of the port's synthetic generator
(`uresnet_pytorch_tpu_torch/iotools/synthetic.py`, numpy only) and the
event pool a run draws its batches from.

The copy differs from the original in one place: the point budget of an
event can be passed in (`budget`), where the original draws it from the
event's own stream. The pool passes budgets drawn from a stream that does
not depend on the run's seed, so every seed gets the same set of event
sizes and only the events' shapes, the weights and the order of batches
change with the seed. Without that, a pool of 64 events whose sizes vary
by 15% moves the mean work of a run by about 2% from seed to seed.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

import numpy as np

# the stream the event sizes come from, the same for every seed
SIZE_STREAM = 20240917


def _track(rng, size, n_pts, width, jitter=0.4):
    a = rng.uniform(0.1 * size, 0.9 * size, 3)
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction) + 1e-9
    t = np.linspace(0.0, rng.uniform(0.3, 0.9) * size, n_pts)
    pts = a[None, :] + t[:, None] * direction[None, :]
    return pts + rng.normal(scale=jitter * width, size=pts.shape)


def _shower(rng, size, n_pts):
    apex = rng.uniform(0.2 * size, 0.8 * size, 3)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis) + 1e-9
    length = min(0.45 * size, max(24.0, 1.2 * n_pts ** 0.5))
    t = rng.uniform(0.0, length, n_pts)
    width = max(0.6, 0.7 * (n_pts / max(length, 1.0)) ** 0.5)
    spread = 0.15 + 0.85 * t / (length + 1e-9)
    perp = rng.normal(size=(n_pts, 3)) * (spread * width)[:, None]
    return apex[None, :] + t[:, None] * axis[None, :] + perp


def _blob(rng, center, n_pts, scale):
    return center[None, :] + rng.normal(scale=scale, size=(n_pts, 3))


def generate_event(seed: int, index: int, spatial_size: int,
                   data_dim: int = 3, mean_voxels: int = 2048,
                   budget: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One event: (coords int32 (N, dim), values float32 (N,), labels
    int32 (N,)) with unique coordinates. Classes: 0 HIP, 1 MIP, 2 shower,
    3 delta ray, 4 Michel electron."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    size = spatial_size
    drawn = max(32, int(rng.normal(mean_voxels, 0.15 * mean_voxels)))
    budget = drawn if budget is None else budget
    pts_list, val_list, lab_list = [], [], []

    def add(pts, label, dedx):
        pts_list.append(pts)
        val_list.append(rng.gamma(2.0, dedx / 2.0,
                                  len(pts)).astype(np.float32))
        lab_list.append(np.full(len(pts), label, dtype=np.int32))

    mult = max(1, budget // 4000)
    n_mip = int(rng.integers(1, 4)) * mult
    n_hip = int(rng.integers(0, 3)) * max(1, mult // 2)
    n_shower = int(rng.integers(1, 4)) * mult
    shares = rng.dirichlet(
        np.concatenate([np.full(n_mip, 2.0), np.full(n_hip, 1.0),
                        np.full(n_shower, 3.0)]))
    parts = iter(shares)
    for _ in range(n_mip):
        n = max(8, int(next(parts) * budget))
        pts = _track(rng, size, n, width=1.0)
        add(pts, 1, dedx=2.0)
        if rng.random() < 0.5:
            m = max(4, n // 8)
            mdir = rng.normal(size=3)
            mdir /= np.linalg.norm(mdir) + 1e-9
            mhi = min(36.0, 0.12 * size)
            mlen = rng.uniform(min(8.0, 0.5 * mhi), mhi)
            tm = np.linspace(0.0, mlen, m)
            mpts = pts[-1][None, :] + tm[:, None] * mdir[None, :]
            mpts = mpts + np.cumsum(
                rng.normal(scale=0.45, size=(m, 3)), axis=0)
            add(mpts, 4, dedx=2.5)
        if rng.random() < 0.5:
            k = max(3, n // 12)
            origin = pts[rng.integers(0, len(pts))]
            add(_blob(rng, origin, k, scale=3.0), 3, dedx=1.5)
    for _ in range(n_hip):
        n = max(6, int(next(parts) * budget))
        add(_track(rng, size, n, width=1.2), 0, dedx=8.0)
    for _ in range(n_shower):
        n = max(16, int(next(parts) * budget))
        add(_shower(rng, size, n), 2, dedx=1.2)

    pts = np.concatenate(pts_list, axis=0)
    vals = np.concatenate(val_list, axis=0)
    labs = np.concatenate(lab_list, axis=0)
    coords = np.clip(np.round(pts), 0, size - 1).astype(np.int32)
    if data_dim == 2:
        coords = coords[:, :2]

    # dedupe voxels: values sum, the label of the largest hit wins
    keys = np.zeros(len(coords), dtype=np.int64)
    for d in range(coords.shape[1]):
        keys = keys * size + coords[:, d]
    order = np.argsort(keys, kind="stable")
    keys, coords, vals, labs = (keys[order], coords[order], vals[order],
                                labs[order])
    uniq, inv = np.unique(keys, return_inverse=True)
    out_vals = np.zeros(len(uniq), np.float32)
    np.add.at(out_vals, inv, vals)
    order2 = np.lexsort((vals, inv))
    last = np.searchsorted(inv[order2], np.arange(len(uniq)),
                           side="right") - 1
    first = np.searchsorted(keys, uniq)
    return coords[first], out_vals, labs[order2[last]]


def pool_budgets(n_events: int, mean_voxels: int,
                 max_points: Optional[int] = None) -> np.ndarray:
    """The point budget of each pool event: drawn as the generator draws
    one (normal, 15% spread), from SIZE_STREAM, so the same for every
    seed; draws over `max_points` are dropped and drawn again."""
    rng = np.random.default_rng(np.random.SeedSequence([SIZE_STREAM,
                                                        mean_voxels]))
    out = np.zeros(0, np.int64)
    while len(out) < n_events:
        b = np.maximum(32, rng.normal(mean_voxels, 0.15 * mean_voxels,
                                      n_events).astype(np.int64))
        out = np.concatenate([out, b[b <= (max_points or b.max())]])
    return out[:n_events]


def _one(args):
    seed, index, spatial, dim, mean_voxels, budget = args
    return generate_event(seed, index, spatial, dim, mean_voxels,
                          budget=int(budget))


def make_pool(seed: int, n_events: int, spatial: int, dim: int,
              mean_voxels: int, workers: int = 0,
              max_points: Optional[int] = None) -> list:
    """`n_events` events of the seed, in index order, made by `workers`
    spawned processes (0: in this process)."""
    jobs = [(seed, i, spatial, dim, mean_voxels, b) for i, b in
            enumerate(pool_budgets(n_events, mean_voxels, max_points))]
    if workers <= 1:
        return [_one(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(_one, jobs, chunksize=max(1, len(jobs)
                                                        // (4 * workers))))


def blob_of(events: list, capacity: int, dim: int,
            class_weights: Optional[list] = None) -> dict:
    """The padded numpy blob a loader hands `TrainVal` for these events:
    coords, values, label, n_voxels, and per-voxel weights by class when
    the configuration has class weights."""
    B = len(events)
    blob = {"coords": np.zeros((B, capacity, dim), np.int32),
            "values": np.zeros((B, capacity), np.float32),
            "label": np.zeros((B, capacity), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b, (c, v, lab) in enumerate(events):
        n = min(len(c), capacity)
        blob["coords"][b, :n] = c[:n]
        blob["values"][b, :n] = v[:n]
        blob["label"][b, :n] = lab[:n]
        blob["n_voxels"][b] = n
    if class_weights is not None:
        w = np.asarray(class_weights, np.float32)
        blob["weight"] = w[blob["label"]] * (
            np.arange(capacity)[None] < blob["n_voxels"][:, None])
    return blob


def batch_order(seed: int, n_events: int, batch: int, epochs: int):
    """Batches of event indices: each epoch a permutation of the pool,
    drawn from the seed, cut into batches of `batch` events. Every event
    appears once an epoch, so a run of whole epochs does the same work
    whatever the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    out = []
    for _ in range(epochs):
        perm = rng.permutation(n_events)
        out.extend(perm[i:i + batch].tolist()
                   for i in range(0, n_events - batch + 1, batch))
    return out
