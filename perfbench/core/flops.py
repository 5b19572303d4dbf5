"""The work of a forward pass, counted from the events' coordinates: the
benchmark's own counts, whatever implements a convolution.

A copy of the numpy accounting of `benchmarks/flops.py` (sparse-ideal and
dense FLOPs, its `model_convs` list), with the bytes of each convolution
added and the site and pair counts taken on the device.

- Sparse-ideal FLOPs: a submanifold 3^3 convolution pays 2 Cin Cout for
  each (site, active neighbour) pair, the centre included; a stride-2 down
  or up convolution 2 Cin Cout for each fine site; a 1x1 shortcut and the
  head 2 Cin Cout for each site.
- Dense FLOPs: every cell of the volume is a site with 27 neighbours
  (border taps counted, under 2% at 128^3).
- Bytes of a convolution: each active input row and output row once, and
  the weights once, in bfloat16, the compute type of the configurations.
- A training step is three forwards' work (forward, d_x, d_W); the
  recompute of a checkpointed stage is not counted.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from perfbench.core.peaks import bound_s
from perfbench.reference.sparse import Level, _key

BYTES = 2          # bfloat16


def model_convs(planes: Sequence[int], reps: int) -> List[tuple]:
    """(kind, level, Cin, Cout) of every convolution of the U-ResNet's
    forward. kind: sm (submanifold 3^3), down, up, nin (1x1), head."""
    n = len(planes)
    convs = [("sm", 0, 1, planes[0])]
    for l in range(n):
        for _ in range(reps):
            convs.append(("sm", l, planes[l], planes[l]))
            convs.append(("sm", l, planes[l], planes[l]))
        if l < n - 1:
            convs.append(("down", l + 1, planes[l], planes[l + 1]))
    for l in reversed(range(n - 1)):
        convs.append(("up", l, planes[l + 1], planes[l]))
        convs.append(("nin", l, 2 * planes[l], planes[l]))
        convs.append(("sm", l, 2 * planes[l], planes[l]))
        convs.append(("sm", l, planes[l], planes[l]))
        for _ in range(1, reps):
            convs.append(("sm", l, planes[l], planes[l]))
            convs.append(("sm", l, planes[l], planes[l]))
    convs.append(("head", 0, planes[0], None))
    return convs


def level_counts(coords: Sequence[torch.Tensor], S: int, nlev: int
                 ) -> Tuple[List[int], List[int]]:
    """(sites per level, (site, active neighbour) pairs per level), summed
    over the events whose voxel coordinates (N, 3) are given, on their
    device."""
    b = torch.cat([torch.full((len(c),), i, dtype=torch.long,
                              device=c.device) for i, c in enumerate(coords)])
    c = torch.cat([c.long() for c in coords])
    sites, pairs = [], []
    for l in range(nlev):
        Sl = S >> l
        lev = Level(torch.unique(_key(b, c >> l, Sl)), Sl)
        sites.append(lev.n)
        pairs.append(int((lev.nbr < lev.n).sum()))
    return sites, pairs


def sparse_work(sites: Sequence[int], pairs: Sequence[int],
                planes: Sequence[int], reps: int, num_class: int) -> dict:
    """A forward's sparse-ideal FLOPs, and the FLOPs, bytes and least time
    on the card of its submanifold convolutions."""
    flops = sm_flops = sm_bytes = sm_bound = 0.0
    for kind, l, cin, cout in model_convs(planes, reps):
        if kind == "sm":
            f = 2.0 * pairs[l] * cin * cout
            nbytes = BYTES * (sites[l] * (cin + cout) + 27 * cin * cout)
            sm_flops += f
            sm_bytes += nbytes
            sm_bound += bound_s(f, nbytes)
        elif kind in ("down", "up"):
            f = 2.0 * sites[l - 1 if kind == "down" else l] * cin * cout
        elif kind == "nin":
            f = 2.0 * sites[l] * cin * cout
        else:
            f = 2.0 * sites[0] * cin * num_class
        flops += f
    return {"flops": flops, "sm_flops": sm_flops, "sm_bytes": sm_bytes,
            "sm_bound_s": sm_bound}


def dense_work(S: int, planes: Sequence[int], reps: int,
               num_class: int) -> dict:
    """A forward's FLOPs on one dense S^3 event, and the least time on
    the card of its convolutions (every one of them runs on
    cuDNN: 3^3, down, transposed up, 1x1 shortcut and head)."""
    flops = conv_bound = 0.0
    for kind, l, cin, cout in model_convs(planes, reps):
        vol = max(1, S >> l) ** 3
        if kind == "sm":
            f, vin, vout, taps = 2.0 * 27 * vol * cin * cout, vol, vol, 27
        elif kind == "down":
            fine = max(1, S >> (l - 1)) ** 3
            f, vin, vout, taps = 2.0 * fine * cin * cout, fine, vol, 8
        elif kind == "up":
            coarse = max(1, S >> (l + 1)) ** 3
            f, vin, vout, taps = 2.0 * vol * cin * cout, coarse, vol, 8
        elif kind == "nin":
            f, vin, vout, taps = 2.0 * vol * cin * cout, vol, vol, 1
        else:
            cout = num_class
            f, vin, vout, taps = 2.0 * vol * cin * cout, vol, vol, 1
        nbytes = BYTES * (vin * cin + vout * cout + taps * cin * cout)
        flops += f
        conv_bound += bound_s(f, nbytes)
    return {"flops": flops, "conv_bound_s": conv_bound}
