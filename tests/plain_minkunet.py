"""Plain float32 MinkUNet34C: the port's CPU tests hold
`uresnet_pytorch_tpu_torch/models/minkunet_tiled.py` to it.

The network of NVIDIA/MinkowskiEngine `examples/minkunet.py` (class
`MinkUNet34C`), written out from the events alone, in float32 with autograd
doing the backward, with nothing of the port or of JAX imported:

- level 0 holds the events' voxels (duplicates summed); level l+1 the
  parents (coordinate // 2) of level l's sites, MinkowskiEngine's
  stride-2 output map;
- a submanifold k^3 conv sums, for each site, its active neighbours' rows
  times the weight of the offset; offsets (d0, d1, d2) in
  {-k//2 .. k//2}^3, row-major (index ((d0 + h) k + d1 + h) k + d2 + h);
- the stride-2 conv: each parent sums its children's rows times the weight
  of the child's octant (b0 4 + b1 2 + b2, b_d the coordinate's lowest
  bit); the transposed conv: each child takes its parent's row times the
  weight of its octant;
- BN over the active sites (biased variance) in train, the running moments
  in eval; a BasicBlock is relu(bn2(conv2(relu(bn1(conv1 x)))) + r), r the
  input or BN(x W) where the width changes;
- stem 5^3 to INIT_DIM, BN, ReLU; encoder levels 1-4: stride-2 conv, BN,
  ReLU, blocks; decoder levels 3-0: transposed conv, BN, ReLU, concat
  (up, skip), blocks; head: a linear layer with a bias.

Parameters are a dict of named tensors with the port's names
(`param_spec`).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

INIT_DIM = 32
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
LEVELS = 5


def param_spec(num_class: int, planes: Sequence[int] = PLANES,
               layers: Sequence[int] = LAYERS, init_dim: int = INIT_DIM
               ) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and running moment. kind:
    conv, head, scale, bias, mean, var."""
    out = [("stem.w", (125, 1, init_dim), "conv")]

    def bn(name, c):
        b = f"{name}.MaskedBatchNorm_0"
        out.extend([(f"{b}.scale", (c,), "scale"), (f"{b}.bias", (c,), "bias"),
                    (f"{b}.mean", (c,), "mean"), (f"{b}.var", (c,), "var")])

    def block(name, cin, f):
        if cin != f:
            out.append((f"{name}.w_shortcut", (1, cin, f), "conv"))
            bn(f"{name}.bn_shortcut", f)
        out.append((f"{name}.conv1.w", (27, cin, f), "conv"))
        bn(f"{name}.bn1", f)
        out.append((f"{name}.conv2.w", (27, f, f), "conv"))
        bn(f"{name}.bn2", f)

    bn("stem_bn", init_dim)
    width = [init_dim]
    for l in range(1, LEVELS):
        cin = width[-1]
        out.append((f"down{l - 1}_w", (8, cin, cin), "conv"))
        bn(f"down{l - 1}_bn", cin)
        for r in range(layers[l - 1]):
            block(f"enc{l}_block{r}", cin if r == 0 else planes[l - 1],
                  planes[l - 1])
        width.append(planes[l - 1])
    cin = width[-1]
    for l in reversed(range(LEVELS - 1)):
        f = planes[7 - l]
        out.append((f"up{l}_w", (8, cin, f), "conv"))
        bn(f"up{l}_bn", f)
        for r in range(layers[7 - l]):
            block(f"dec{l}_block{r}", f + width[l] if r == 0 else f, f)
        cin = f
    out.extend([("head_w", (cin, num_class), "head"),
                ("head_b", (num_class,), "bias")])
    return out


def make_params(spec, seed: int) -> Dict[str, torch.Tensor]:
    """A tree away from every default: weights at variance 1 / fan-in, BN
    scales 1 + 0.1 z, biases and means 0.1 z, variances 1 + 0.1 |z|."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in spec:
        z = torch.randn(shape, generator=g)
        if kind == "conv":
            z = z / (shape[0] * shape[1]) ** 0.5
        elif kind == "head":
            z = z / shape[0] ** 0.5
        elif kind == "scale":
            z = 1.0 + 0.1 * z
        elif kind in ("bias", "mean"):
            z = 0.1 * z
        else:
            z = 1.0 + 0.1 * z.abs()
        out[name] = z
    return out


def _key(b, c, S):
    return ((b * S + c[:, 0]) * S + c[:, 1]) * S + c[:, 2]


class Level:
    """The sorted unique sites of a level and their neighbours at offsets
    of a k^3 stencil (row, or n where there is none)."""

    def __init__(self, keys: torch.Tensor, S: int):
        self.keys, self.S, self.n = keys, S, len(keys)
        self.b = keys // S ** 3
        rem = keys % S ** 3
        self.c = torch.stack([rem // (S * S), (rem // S) % S, rem % S], 1)
        self._nbr = {}

    def find(self, b, c):
        inside = ((c >= 0) & (c < self.S)).all(1)
        k = _key(b, c.clamp(0, self.S - 1), self.S)
        pos = torch.searchsorted(self.keys, k).clamp(max=max(self.n - 1, 0))
        return torch.where(inside & (self.keys[pos] == k), pos, self.n)

    def nbr(self, k: int) -> torch.Tensor:
        if k not in self._nbr:
            h = k // 2
            offs = itertools.product(range(-h, h + 1), repeat=3)
            self._nbr[k] = torch.stack([self.find(self.b, self.c
                                                  + torch.tensor(o))
                                        for o in offs])
        return self._nbr[k]


class Geometry:
    def __init__(self, events: List[Tuple[torch.Tensor, torch.Tensor]],
                 S: int):
        b = torch.cat([torch.full((len(c),), i, dtype=torch.long)
                       for i, (c, _) in enumerate(events)])
        keys = _key(b, torch.cat([c.long() for c, _ in events]), S)
        lev = Level(torch.unique(keys), S)
        self.levels = [lev]
        self.voxel_site = torch.searchsorted(lev.keys, keys)
        vals = torch.cat([v.float() for _, v in events])
        self.feats = torch.zeros(lev.n).index_add(0, self.voxel_site,
                                                  vals)[:, None]
        self.parent, self.octant = [], []
        for _ in range(LEVELS - 1):
            pc = lev.c >> 1
            nxt = Level(torch.unique(_key(lev.b, pc, lev.S >> 1)), lev.S >> 1)
            self.parent.append(nxt.find(lev.b, pc))
            self.octant.append((lev.c[:, 0] & 1) * 4 + (lev.c[:, 1] & 1) * 2
                               + (lev.c[:, 2] & 1))
            self.levels.append(nxt)
            lev = nxt


class MinkUNet:
    def __init__(self, num_class: int, eps: float, layers=LAYERS):
        self.num_class, self.eps, self.layers = num_class, eps, layers
        self.moments: Dict[str, tuple] = {}

    def bn(self, x, p, name, train, relu=True, r=None):
        b = f"{name}.MaskedBatchNorm_0"
        if train:
            mu = x.mean(0)
            va = ((x - mu) ** 2).mean(0)
            self.moments[b] = (mu.detach(), va.detach())
        else:
            mu, va = p[f"{b}.mean"], p[f"{b}.var"]
        y = (x - mu) * torch.rsqrt(va + self.eps) * p[f"{b}.scale"] \
            + p[f"{b}.bias"]
        if r is not None:
            y = y + r
        return torch.relu(y) if relu else y

    @staticmethod
    def conv(x, w, lev: Level):
        k = round(w.shape[0] ** (1 / 3))
        nbr = lev.nbr(k)
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        out = x.new_zeros(x.shape[0], w.shape[2])
        for o in range(w.shape[0]):
            out = out + xp[nbr[o]] @ w[o]
        return out

    def block(self, x, p, name, lev, train):
        if f"{name}.w_shortcut" in p:
            r = self.bn(x @ p[f"{name}.w_shortcut"][0], p,
                        f"{name}.bn_shortcut", train, relu=False)
        else:
            r = x
        y = self.bn(self.conv(x, p[f"{name}.conv1.w"], lev), p,
                    f"{name}.bn1", train)
        return self.bn(self.conv(y, p[f"{name}.conv2.w"], lev), p,
                       f"{name}.bn2", train, r=r)

    def forward(self, geo: Geometry, p, train: bool) -> torch.Tensor:
        self.moments = {}
        L = self.layers
        lv = geo.levels
        x = self.bn(self.conv(geo.feats, p["stem.w"], lv[0]), p, "stem_bn",
                    train)
        skips = [x]
        for l in range(1, LEVELS):
            w = p[f"down{l - 1}_w"]
            y = x.new_zeros(lv[l].n, w.shape[2]).index_add(
                0, geo.parent[l - 1],
                torch.einsum("nc,ncd->nd", x, w[geo.octant[l - 1]]))
            x = self.bn(y, p, f"down{l - 1}_bn", train)
            for r in range(L[l - 1]):
                x = self.block(x, p, f"enc{l}_block{r}", lv[l], train)
            skips.append(x)
        for l in reversed(range(LEVELS - 1)):
            w = p[f"up{l}_w"]
            y = torch.einsum("nc,ncd->nd", x[geo.parent[l]], w[geo.octant[l]])
            y = self.bn(y, p, f"up{l}_bn", train)
            x = torch.cat([y, skips[l]], 1)
            for r in range(L[7 - l]):
                x = self.block(x, p, f"dec{l}_block{r}", lv[l], train)
        logits = x @ p["head_w"] + p["head_b"]
        return logits[geo.voxel_site]


def events_of(blob: dict, rows: Optional[list] = None) -> list:
    rows = range(len(blob["n_voxels"])) if rows is None else rows
    return [(torch.as_tensor(blob["coords"][b, :int(blob["n_voxels"][b])]),
             torch.as_tensor(blob["values"][b, :int(blob["n_voxels"][b])]))
            for b in rows]


def voxel_rows(blob: dict, key: str) -> torch.Tensor:
    return torch.cat([torch.as_tensor(blob[key][b, :int(n)])
                      for b, n in enumerate(blob["n_voxels"])])


def logits(params, blob, spatial_size: int, num_class: int, eps: float,
           train: bool, layers=LAYERS) -> Tuple[torch.Tensor, MinkUNet]:
    """Per-voxel logits of the blob's valid voxels, events in order, and
    the net (its train-mode BN moments in `moments`), in the parameters'
    dtype (float32, or float64 for a witness of the float32 runs)."""
    net = MinkUNet(num_class, eps, layers)
    geo = Geometry(events_of(blob), spatial_size)
    geo.feats = geo.feats.to(params["stem.w"].dtype)
    return net.forward(geo, params, train), net


def masked_ce(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the voxels."""
    logp = torch.log_softmax(lg, -1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
