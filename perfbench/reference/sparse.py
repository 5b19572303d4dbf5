"""Plain float32 reference of the submanifold-sparse U-ResNet.

It works from the events alone: the active sites of each level, their
neighbours and their parents are found here from the voxel coordinates
(sorted keys and binary search), and nothing of the program is used, not
its tile graph, masks or moments. Its parameters are the benchmark's tree
of named tensors, the one the program is handed.

The model (the configuration's file names the source):
- level 0 holds the events' voxels, duplicates summed; level l+1 holds
  the parents (coordinate // 2) of level l's sites;
- the stem and every block's two convolutions are submanifold 3^3
  convolutions: a site sums its active neighbours' rows times the
  weight of the offset, offset (d0, d1, d2) in {-1, 0, 1}^3 at index
  9 (d0 + 1) + 3 (d1 + 1) + (d2 + 1), d0 along the first coordinate;
- a block is pre-activation: BN and ReLU, conv a, BN and ReLU, conv b,
  plus the input (through a 1x1 weight where the width changes);
- down: BN and ReLU, then each parent sums its children's rows times the
  weight of the child's octant, b0 4 + b1 2 + b2 with b_d its
  coordinate's lowest bit; up: BN and ReLU, then each child takes its
  parent's row times the weight of its octant;
- the decoder concatenates (up, skip) before its first block; the head
  is BN, ReLU and a linear layer to the classes.
Train mode takes BN moments over every active site of the batch (biased
variance); eval mode uses the running moments.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference.common import Quant, act, batch_norm, masked_ce


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and running moment, with the
    program's names. kind: conv (fan-in init), scale, bias, mean, var."""
    p = planes(model)
    reps, nlev, nc = model["reps"], model["uresnet_num_strides"], \
        model["num_class"]
    out = [("stem.w", (27, 1, p[0]), "conv")]

    def bn(prefix, c):
        b = f"{prefix}.MaskedBatchNorm_0"
        out.extend([(f"{b}.scale", (c,), "scale"), (f"{b}.bias", (c,), "bias"),
                    (f"{b}.mean", (c,), "mean"), (f"{b}.var", (c,), "var")])

    def block(prefix, cin, f):
        if cin != f:
            out.append((f"{prefix}.w_shortcut", (1, cin, f), "conv"))
        bn(f"{prefix}.bn_a", cin)
        out.append((f"{prefix}.conv_a.w", (27, cin, f), "conv"))
        bn(f"{prefix}.bn_b", f)
        out.append((f"{prefix}.conv_b.w", (27, f, f), "conv"))

    for l in range(nlev):
        for r in range(reps):
            block(f"enc{l}_block{r}", p[l], p[l])
        if l < nlev - 1:
            bn(f"down{l}_bnact", p[l])
            out.append((f"down{l}_w", (8, p[l], p[l + 1]), "conv"))
    for l in reversed(range(nlev - 1)):
        bn(f"up{l}_bnact", p[l + 1])
        out.append((f"up{l}_w", (8, p[l + 1], p[l]), "up"))
        for r in range(reps):
            block(f"dec{l}_block{r}", 2 * p[l] if r == 0 else p[l], p[l])
    bn("head_bnact", p[0])
    out.extend([("head_w", (p[0], nc), "head"), ("head_b", (nc,), "bias")])
    return out


def planes(model: dict) -> Tuple[int, ...]:
    m, s = model["uresnet_filters"], model["uresnet_num_strides"]
    if model.get("width_ramp", "linear") == "linear":
        return tuple(m * (i + 1) for i in range(s))
    return tuple(m * 2 ** i for i in range(s))


# ---------------------------------------------------------------------------
# geometry: sites, neighbours, parents, from the coordinates
# ---------------------------------------------------------------------------

OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
           for c in (-1, 0, 1)]


def _key(b, c, S):
    return ((b * S + c[:, 0]) * S + c[:, 1]) * S + c[:, 2]


class Level:
    """One resolution level of a batch, from its sorted unique site keys:
    the batch index and coordinates of each site, and each site's 27
    neighbours (row, or n where there is none)."""

    def __init__(self, keys: torch.Tensor, S: int):
        self.keys, self.S, self.n = keys, S, len(keys)
        self.b = keys // S ** 3
        rem = keys % S ** 3
        self.c = torch.stack([rem // (S * S), (rem // S) % S, rem % S], 1)
        self.nbr = torch.stack([self.find(self.b, self.c + torch.tensor(
            o, device=keys.device)) for o in OFFSETS])

    def find(self, b, c) -> torch.Tensor:
        """Row of each (b, c) among the sites, or n where it is none."""
        inside = ((c >= 0) & (c < self.S)).all(1)
        k = _key(b, c.clamp(0, self.S - 1), self.S)
        pos = torch.searchsorted(self.keys, k).clamp(max=max(self.n - 1, 0))
        hit = inside & (self.keys[pos] == k)
        return torch.where(hit, pos, self.n)


class Geometry:
    """Every level of a batch of events, the links between them, and the
    site of each input voxel."""

    def __init__(self, events: List[Tuple[torch.Tensor, torch.Tensor]],
                 S: int, nlev: int):
        dev = events[0][0].device
        b = torch.cat([torch.full((len(c),), i, dtype=torch.long,
                                  device=dev) for i, (c, _) in
                       enumerate(events)])
        keys = _key(b, torch.cat([c.long() for c, _ in events]), S)
        lev = Level(torch.unique(keys), S)
        self.levels = [lev]
        self.voxel_site = torch.searchsorted(lev.keys, keys)
        vals = torch.cat([v.float() for _, v in events])
        self.feats = torch.zeros(lev.n, device=dev).index_add(
            0, self.voxel_site, vals)[:, None]
        self.parent, self.octant_rows = [], []
        for _ in range(nlev - 1):
            pc = lev.c >> 1
            nxt = Level(torch.unique(_key(lev.b, pc, lev.S >> 1)),
                        lev.S >> 1)
            self.parent.append(nxt.find(lev.b, pc))
            octant = ((lev.c[:, 0] & 1) * 4 + (lev.c[:, 1] & 1) * 2
                      + (lev.c[:, 2] & 1))
            self.octant_rows.append([torch.nonzero(octant == o)[:, 0]
                                     for o in range(8)])
            self.levels.append(nxt)
            lev = nxt


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

class _SubmConv(torch.autograd.Function):
    """out[s] = sum_k x[nbr[k, s]] w[k]. The backward recomputes the
    gathers rather than keeping 27 of them: d_x scatters g w[k]^T back to
    each neighbour, d_w[k] = x[nbr[k]]^T g."""

    @staticmethod
    def forward(ctx, x, w, nbr, quant):
        ctx.save_for_backward(x, w, nbr)
        ctx.quant = quant
        xq, wq = quant(x), quant(w)
        xp = torch.cat([xq, xq.new_zeros(1, xq.shape[1])])
        out = xq.new_zeros(x.shape[0], w.shape[2])
        for k in range(w.shape[0]):
            out += xp[nbr[k]] @ wq[k]
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, nbr = ctx.saved_tensors
        q = ctx.quant
        xq, wq, gq = q(x), q(w), q(g)
        n = x.shape[0]
        xp = torch.cat([xq, xq.new_zeros(1, xq.shape[1])])
        dx = xq.new_zeros(n + 1, x.shape[1])
        dw = torch.empty_like(w)
        for k in range(w.shape[0]):
            dx.index_add_(0, nbr[k], gq @ wq[k].T)
            dw[k] = xp[nbr[k]].T @ gq
        return dx[:n], dw, None, None


class SparseUResNet:
    """forward(geometry, params, train) -> per-voxel logits (rows in the
    order of the events' voxels, concatenated)."""

    def __init__(self, model: dict, quant: Optional[Quant] = None):
        self.model = model
        self.quant = quant or Quant("none")
        self.eps = model.get("bn_eps", 1e-4)
        self.slope = model.get("leaky_relu_slope", 0.0)
        self.moments: Dict[str, tuple] = {}

    def bnact(self, x, p, name, train):
        b = f"{name}.MaskedBatchNorm_0"
        rec: list = []
        y = batch_norm(x, p[f"{b}.scale"], p[f"{b}.bias"], p[f"{b}.mean"],
                       p[f"{b}.var"], self.eps, train, rec)
        if rec:
            self.moments[b] = rec[0]
        return self.quant(act(y, self.slope))

    def conv(self, x, w, level: Level):
        return self.quant(_SubmConv.apply(x, w, level.nbr, self.quant))

    def block(self, x, p, name, level, train):
        sc = x
        if f"{name}.w_shortcut" in p:
            sc = self.quant.mm(x, p[f"{name}.w_shortcut"][0])
        y = self.bnact(x, p, f"{name}.bn_a", train)
        y = self.conv(y, p[f"{name}.conv_a.w"], level)
        y = self.bnact(y, p, f"{name}.bn_b", train)
        y = self.conv(y, p[f"{name}.conv_b.w"], level)
        return self.quant(sc + y)

    def down(self, x, w, geo: Geometry, l: int):
        nxt = geo.levels[l + 1]
        out = x.new_zeros(nxt.n, w.shape[2])
        for o, rows in enumerate(geo.octant_rows[l]):
            out = out.index_add(0, geo.parent[l][rows],
                                self.quant.mm(x[rows], w[o]))
        return self.quant(out)

    def up(self, x, w, geo: Geometry, l: int):
        fine = geo.levels[l]
        out = x.new_zeros(fine.n, w.shape[2])
        for o, rows in enumerate(geo.octant_rows[l]):
            out = out.index_copy(0, rows, self.quant.mm(
                x[geo.parent[l][rows]], w[o]))
        return self.quant(out)

    def forward(self, geo: Geometry, p: Dict[str, torch.Tensor],
                train: bool) -> torch.Tensor:
        m = self.model
        nlev, reps = m["uresnet_num_strides"], m["reps"]
        self.moments = {}
        x = self.conv(geo.feats, p["stem.w"], geo.levels[0])
        skips = []
        for l in range(nlev):
            for r in range(reps):
                x = self.block(x, p, f"enc{l}_block{r}", geo.levels[l],
                               train)
            if l < nlev - 1:
                skips.append(x)
                y = self.bnact(x, p, f"down{l}_bnact", train)
                x = self.down(y, p[f"down{l}_w"], geo, l)
        for l in reversed(range(nlev - 1)):
            y = self.bnact(x, p, f"up{l}_bnact", train)
            y = self.up(y, p[f"up{l}_w"], geo, l)
            x = torch.cat([y, skips[l]], 1)
            for r in range(reps):
                x = self.block(x, p, f"dec{l}_block{r}", geo.levels[l],
                               train)
        y = self.bnact(x, p, "head_bnact", train)
        logits = self.quant.mm(y, p["head_w"]) + p["head_b"]
        return logits[geo.voxel_site]


def events_of(blob: dict, device, rows: Optional[list] = None) -> list:
    """The events of a numpy blob as (coords, values) tensors on `device`,
    each cut to its n_voxels."""
    rows = range(len(blob["n_voxels"])) if rows is None else rows
    out = []
    for b in rows:
        n = int(blob["n_voxels"][b])
        out.append((torch.as_tensor(blob["coords"][b, :n], device=device),
                    torch.as_tensor(blob["values"][b, :n], device=device)))
    return out


def voxel_rows(blob: dict, key: str, device, rows=None) -> torch.Tensor:
    rows = range(len(blob["n_voxels"])) if rows is None else rows
    return torch.cat([torch.as_tensor(blob[key][b, :int(blob["n_voxels"][b])],
                                      device=device) for b in rows])


def net(model: dict, quant: Optional[Quant] = None) -> SparseUResNet:
    return SparseUResNet(model, quant)


def infer(model: dict, params: dict, blob: dict, device,
          quant: Optional[Quant] = None) -> torch.Tensor:
    """Eval-mode logits of every valid voxel of the blob, events in
    order."""
    geo = Geometry(events_of(blob, device), model["spatial_size"],
                   model["uresnet_num_strides"])
    with torch.no_grad():
        return SparseUResNet(model, quant).forward(geo, params, train=False)


def work(model: dict, coords: List[torch.Tensor]) -> dict:
    """A forward's sparse-ideal FLOPs over the events whose voxel
    coordinates are given, and the least time of its submanifold
    convolutions (`core/flops.py`)."""
    from perfbench.core import flops     # flops counts sites with Level
    sites, pairs = flops.level_counts(coords, model["spatial_size"],
                                      model["uresnet_num_strides"])
    w = flops.sparse_work(sites, pairs, planes(model), model["reps"],
                          model["num_class"])
    return {"flops": w["flops"], "sm_bound_s": w["sm_bound_s"],
            "dense_conv_bound_s": 0.0}


def loss_and_grads(net, model: dict, params: dict, blob: dict, device,
                   rows=None):
    """Train-mode loss of the blob's events (or of `rows` of them) and the
    gradient of every parameter."""
    geo = Geometry(events_of(blob, device, rows), model["spatial_size"],
                   model["uresnet_num_strides"])
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if not k.endswith((".mean", ".var"))}
    full = dict(params)
    full.update(leaves)
    logits = net.forward(geo, full, train=True)
    w = voxel_rows(blob, "weight", device, rows) if "weight" in blob \
        else None
    loss = masked_ce(logits, voxel_rows(blob, "label", device, rows), w)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
