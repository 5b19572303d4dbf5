"""The benchmark's site and pair counts against a brute-force count."""

import itertools

import numpy as np
import torch

from perfbench.core import flops
from perfbench.core.events import generate_event


def brute(coords: np.ndarray, S: int, nlev: int):
    sites, pairs = [], []
    c = {tuple(x) for x in coords.tolist()}
    for l in range(nlev):
        sites.append(len(c))
        n = 0
        for s in c:
            for o in itertools.product((-1, 0, 1), repeat=3):
                t = tuple(a + b for a, b in zip(s, o))
                if all(0 <= v < S >> l for v in t) and t in c:
                    n += 1
        pairs.append(n)
        c = {tuple(v >> 1 for v in s) for s in c}
    return sites, pairs


def test_level_counts_match_brute_force():
    ev = [generate_event(5, i, 32, 3, 300)[0] for i in range(2)]
    got = flops.level_counts([torch.as_tensor(c) for c in ev], 32, 3)
    want = [brute(c, 32, 3) for c in ev]
    assert got[0] == [a + b for a, b in zip(want[0][0], want[1][0])]
    assert got[1] == [a + b for a, b in zip(want[0][1], want[1][1])]


def test_sparse_work_counts_each_conv():
    planes, reps = (4, 8), 1
    sites, pairs = [10, 3], [40, 9]
    w = flops.sparse_work(sites, pairs, planes, reps, 5)
    # stem, enc0 a/b, down, enc1 a/b, up, nin, dec0 a/b, head
    sm = 2 * (40 * 1 * 4 + 2 * 40 * 4 * 4 + 2 * 9 * 8 * 8
              + 40 * 8 * 4 + 40 * 4 * 4)
    other = 2 * (10 * 4 * 8 + 10 * 8 * 4 + 10 * 8 * 4 + 10 * 4 * 5)
    assert w["sm_flops"] == sm
    assert w["flops"] == sm + other
    assert w["sm_bound_s"] > 0


def test_dense_work_every_cell():
    w = flops.dense_work(8, (2,), 1, 3)
    vol = 8 ** 3
    assert w["flops"] == 2 * 27 * vol * (1 * 2 + 2 * 2 * 2) + 2 * vol * 2 * 3
