"""Synthetic LArTPC-like events, deterministic per (seed, event index).

Port of `uresnet_pytorch_tpu/iotools/synthetic.py` (numpy only): straight
ionisation tracks (HIP/MIP) with Michel electrons and delta rays, and
diffuse electromagnetic showers, voxelised and deduplicated. The draws
follow the reference's order exactly, so both give the same event for the
same (seed, index). Classes: 0=HIP, 1=MIP, 2=shower, 3=delta, 4=Michel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _track(rng, size, n_pts, width, jitter=0.4):
    """Points along a random chord through the volume."""
    a = rng.uniform(0.1 * size, 0.9 * size, 3)
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction) + 1e-9
    t = np.linspace(0.0, rng.uniform(0.3, 0.9) * size, n_pts)
    pts = a[None, :] + t[:, None] * direction[None, :]
    return pts + rng.normal(scale=jitter * width, size=pts.shape)


def _shower(rng, size, n_pts):
    """A diffuse cone whose width grows with its point count."""
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


def generate_event(seed: int, index: int, spatial_size: int, data_dim: int = 3,
                   mean_voxels: int = 2048
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One event: (coords int32 (N, dim), values float32 (N,), labels int32
    (N,)) with unique coordinates, N >= 1."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    size = spatial_size
    budget = max(32, int(rng.normal(mean_voxels, 0.15 * mean_voxels)))
    pts_list, val_list, lab_list = [], [], []

    def add(pts, label, dedx):
        pts_list.append(pts)
        val_list.append(rng.gamma(2.0, dedx / 2.0, len(pts)).astype(np.float32))
        lab_list.append(np.full(len(pts), label, dtype=np.int32))

    # Dirichlet shares of the point budget; larger events hold more particles
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
            # Michel electron: a multiple-scattered walk from the track's end
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
            # delta ray: a blob off a random point of the track
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
    keys, coords, vals, labs = keys[order], coords[order], vals[order], labs[order]
    uniq, inv = np.unique(keys, return_inverse=True)
    out_vals = np.zeros(len(uniq), np.float32)
    np.add.at(out_vals, inv, vals)
    order2 = np.lexsort((vals, inv))
    last = np.searchsorted(inv[order2], np.arange(len(uniq)), side="right") - 1
    first = np.searchsorted(keys, uniq)
    return coords[first], out_vals, labs[order2[last]]
