"""Plain float32 reference of MinkUNet34C, the benchmark's copy (the
configuration `minkunet34c_512` names this file).

The network of NVIDIA/MinkowskiEngine `examples/minkunet.py`, class
`MinkUNet34C` (`MinkUNetBase` with `BLOCK = BasicBlock`; Choy, Gwak and
Savarese, arXiv:1904.08755), computed from the events alone on
`reference/sparse.py`'s `Level`, `Geometry` and `_SubmConv`, with nothing
of the program imported:

- level 0 holds the events' voxels (duplicates summed), level l+1 the
  parents (coordinate // 2) of level l's sites: tensor strides 1 to 16;
- stem: a 5^3 submanifold conv from 1 channel to INIT_DIM, BN, ReLU; its
  own 125-offset neighbour table, offsets (d0, d1, d2) in {-2..2}^3 at
  index 25 (d0 + 2) + 5 (d1 + 2) + (d2 + 2);
- encoder, levels 1-4: the stride-2 conv (each parent sums its children's
  rows times the weight of the child's octant), BN, ReLU, then
  LAYERS[l-1] BasicBlocks at PLANES[l-1];
- decoder, levels 3-0: the transposed stride-2 conv (each child takes its
  parent's row times the weight of its octant) to PLANES[7-l], BN, ReLU,
  the concat (up, skip), then LAYERS[7-l] BasicBlocks;
- BasicBlock: relu(bn2(conv2(relu(bn1(conv1 x)))) + r), 3^3 submanifold
  convs, r the input or BN(x W) through a 1x1 weight where the width
  changes; head: a linear layer to the classes with a bias.
Every submanifold conv is computed offset by offset (`_SubmConv`, which
recomputes its gathers in backward), so that batch 8 of ~1e5-voxel events
fits on one card. Train mode takes BN moments over every active site of
the batch (biased variance); eval mode uses the running moments.

Departures from `examples/minkunet.py`: MinkowskiEngine orders a level's
rows by its coordinate hash, here by sorted key, which does not change the
mathematics; its BN eps and momentum are the configuration's; weights are
the benchmark's seeded tree, not MinkowskiEngine's Kaiming (fan-out)
initialization; the input and output channels (1 and 5) are the data
set's.

`work` counts a forward's sparse-ideal FLOPs and the least time of its
submanifold convs (the stem included) from the coordinates; `norm_bytes`
the bytes the batch-norm kernels must move in a training step.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.core.peaks import bound_s
from perfbench.reference.common import Quant, act, batch_norm, masked_ce
from perfbench.reference.sparse import (Geometry, Level, SparseUResNet,
                                        _key, _SubmConv, events_of,
                                        voxel_rows)

INIT_DIM = 32
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
LEVELS = 5
STEM = 5                       # the stem's kernel edge
BYTES = 2                      # bfloat16, the configuration's compute type

OFFSETS125 = list(itertools.product(range(-2, 3), repeat=3))


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------

def blocks(planes: Sequence[int] = PLANES, layers: Sequence[int] = LAYERS,
           init_dim: int = INIT_DIM) -> List[Tuple[str, int, int, int]]:
    """(name, level, Cin, Cout) of every BasicBlock, in forward order, and
    of the stem, the stride-2 convs and the head: kind is the name's
    prefix (`stem`, `down`, `enc`, `up`, `dec`, `head`)."""
    out = [("stem", 0, 1, init_dim)]
    width = [init_dim]
    for l in range(1, LEVELS):
        cin = width[-1]
        out.append((f"down{l - 1}", l, cin, cin))
        for r in range(layers[l - 1]):
            out.append((f"enc{l}_block{r}", l,
                        cin if r == 0 else planes[l - 1], planes[l - 1]))
        width.append(planes[l - 1])
    cin = width[-1]
    for l in reversed(range(LEVELS - 1)):
        f = planes[7 - l]
        out.append((f"up{l}", l, cin, f))
        for r in range(layers[7 - l]):
            out.append((f"dec{l}_block{r}", l, f + width[l] if r == 0 else f,
                        f))
        cin = f
    out.append(("head", 0, cin, None))
    return out


def param_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and running moment, with the
    program's names (`models/minkunet_tiled.py`). kind: conv (fan-in
    init), head, scale, bias, mean, var."""
    out = []

    def bn(prefix, c):
        b = f"{prefix}.MaskedBatchNorm_0"
        out.extend([(f"{b}.scale", (c,), "scale"), (f"{b}.bias", (c,), "bias"),
                    (f"{b}.mean", (c,), "mean"), (f"{b}.var", (c,), "var")])

    for name, _, cin, cout in blocks():
        if name == "stem":
            out.append(("stem.w", (STEM ** 3, cin, cout), "conv"))
            bn("stem_bn", cout)
        elif name.startswith(("down", "up")):
            out.append((f"{name}_w", (8, cin, cout), "conv"))
            bn(f"{name}_bn", cout)
        elif name == "head":
            out.extend([("head_w", (cin, model["num_class"]), "head"),
                        ("head_b", (model["num_class"],), "bias")])
        else:
            if cin != cout:
                out.append((f"{name}.w_shortcut", (1, cin, cout), "conv"))
                bn(f"{name}.bn_shortcut", cout)
            out.append((f"{name}.conv1.w", (27, cin, cout), "conv"))
            bn(f"{name}.bn1", cout)
            out.append((f"{name}.conv2.w", (27, cout, cout), "conv"))
            bn(f"{name}.bn2", cout)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def stem_neighbours(level: Level) -> torch.Tensor:
    """(125, n): each site's row at each offset of the 5^3 stencil, or n
    where there is none."""
    dev = level.keys.device
    return torch.stack([level.find(level.b, level.c + torch.tensor(
        o, device=dev)) for o in OFFSETS125])


class MinkUNet34C(SparseUResNet):
    """forward(geometry, params, train) -> per-voxel logits (rows in the
    order of the events' voxels, concatenated). The stride-2 convs and the
    3^3 convs are the sparse U-ResNet reference's."""

    def bn(self, x, p, name, train, relu: bool = True, r=None):
        """BN, plus r, then ReLU (or none), rounded as a stored
        activation."""
        b = f"{name}.MaskedBatchNorm_0"
        rec: list = []
        y = batch_norm(x, p[f"{b}.scale"], p[f"{b}.bias"], p[f"{b}.mean"],
                       p[f"{b}.var"], self.eps, train, rec)
        if rec:
            self.moments[b] = rec[0]
        if r is not None:
            y = y + r
        return self.quant(act(y, self.slope) if relu else y)

    def basic_block(self, x, p, name, level, train):
        if f"{name}.w_shortcut" in p:
            r = self.bn(self.quant(self.quant.mm(
                x, p[f"{name}.w_shortcut"][0])), p, f"{name}.bn_shortcut",
                train, relu=False)
        else:
            r = x
        y = self.conv(x, p[f"{name}.conv1.w"], level)
        y = self.bn(y, p, f"{name}.bn1", train)
        y = self.conv(y, p[f"{name}.conv2.w"], level)
        return self.bn(y, p, f"{name}.bn2", train, r=r)

    def forward(self, geo: Geometry, p: Dict[str, torch.Tensor],
                train: bool) -> torch.Tensor:
        self.moments = {}
        lv = geo.levels
        y = self.quant(_SubmConv.apply(geo.feats, p["stem.w"],
                                       stem_neighbours(lv[0]), self.quant))
        x = self.bn(y, p, "stem_bn", train)
        skips = [x]
        for name, l, _, _ in blocks()[1:-1]:
            if name.startswith("down"):
                if l > 1:          # level l-1's blocks are done: its skip
                    skips.append(x)
                x = self.bn(self.down(x, p[f"{name}_w"], geo, l - 1), p,
                            f"{name}_bn", train)
            elif name.startswith("up"):
                y = self.bn(self.up(x, p[f"{name}_w"], geo, l), p,
                            f"{name}_bn", train)
                x = torch.cat([y, skips[l]], 1)
            else:
                x = self.basic_block(x, p, name, lv[l], train)
        logits = self.quant.mm(x, p["head_w"]) + p["head_b"]
        return logits[geo.voxel_site]


def net(model: dict, quant: Optional[Quant] = None) -> MinkUNet34C:
    return MinkUNet34C(model, quant)


def _geometry(model: dict, params: dict, blob: dict, device,
              rows=None) -> Geometry:
    """The blob's levels, its input rows in the parameters' dtype (float32
    in the benchmark; a test may run the reference in float64)."""
    geo = Geometry(events_of(blob, device, rows), model["spatial_size"],
                   LEVELS)
    geo.feats = geo.feats.to(params["stem.w"].dtype)
    return geo


def infer(model: dict, params: dict, blob: dict, device,
          quant: Optional[Quant] = None) -> torch.Tensor:
    """Eval-mode logits of every valid voxel of the blob, events in
    order."""
    with torch.no_grad():
        return MinkUNet34C(model, quant).forward(
            _geometry(model, params, blob, device), params, train=False)


def loss_and_grads(net, model: dict, params: dict, blob: dict, device,
                   rows=None):
    """Train-mode loss of the blob's events (or of `rows` of them) and the
    gradient of every parameter."""
    geo = _geometry(model, params, blob, device, rows)
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


# ---------------------------------------------------------------------------
# the work of a forward, and the batch norm's bytes
# ---------------------------------------------------------------------------

def work(model: dict, coords: List[torch.Tensor]) -> dict:
    """A forward's sparse-ideal FLOPs over the events whose voxel
    coordinates are given, and the least time of its submanifold convs:

    - a submanifold conv 2 Cin Cout for each (site, active neighbour)
      pair, 125 offsets for the stem and 27 for the blocks' convs;
    - a stride-2 conv and a transposed one 2 Cin Cout for each fine site;
      a 1x1 projection 2 Cin Cout and the head 2 Cin classes for each
      site;
    - a submanifold conv's least time on the card from its FLOPs and its
      bytes (each active input and output row once, and the weights once,
      in bfloat16)."""
    from perfbench.core import flops      # flops counts sites with Level
    S = model["spatial_size"]
    sites, pairs = flops.level_counts(coords, S, LEVELS)
    b = torch.cat([torch.full((len(c),), i, dtype=torch.long,
                              device=c.device) for i, c in enumerate(coords)])
    c = torch.cat([c.long() for c in coords])
    lev0 = Level(torch.unique(_key(b, c, S)), S)
    pairs125 = int((stem_neighbours(lev0) < lev0.n).sum())
    total = sm_bound = 0.0

    def subm(cin, cout, l, taps, npairs):
        nonlocal total, sm_bound
        f = 2.0 * npairs * cin * cout
        nbytes = BYTES * (sites[l] * (cin + cout) + taps * cin * cout)
        total += f
        sm_bound += bound_s(f, nbytes)

    for name, l, cin, cout in blocks():
        if name == "stem":
            subm(cin, cout, 0, STEM ** 3, pairs125)
        elif name.startswith("down"):
            total += 2.0 * sites[l - 1] * cin * cout
        elif name.startswith("up"):
            total += 2.0 * sites[l] * cin * cout
        elif name == "head":
            total += 2.0 * sites[0] * cin * model["num_class"]
        else:
            if cin != cout:
                total += 2.0 * sites[l] * cin * cout
            subm(cin, cout, l, 27, pairs[l])
            subm(cout, cout, l, 27, pairs[l])
    return {"flops": total, "sm_bound_s": sm_bound,
            "dense_conv_bound_s": 0.0}


def norm_calls() -> List[Tuple[int, int, bool]]:
    """(level, channels, with a residual) of every batch-norm call of a
    forward: the stem's, each stride-2 and transposed conv's, and each
    block's bn1, bn2 (with the residual) and projection's BN."""
    out = []
    for name, l, cin, cout in blocks():
        if name == "head":
            continue
        if name in ("stem",) or name.startswith(("down", "up")):
            out.append((l, cout, False))
            continue
        if cin != cout:
            out.append((l, cout, False))
        out.extend([(l, cout, False), (l, cout, True)])
    return out


def norm_bytes(active_cells_by_level: Sequence[int]) -> float:
    """The bytes the batch-norm kernels must move in the training steps
    whose active cells (summed over the steps) are given by level: each
    active row once a pass, in bfloat16, over the passes of a step: stats
    read x; apply read x (and r), write y; the backward's reduce read x,
    dy (and r); its apply read x, dy (and r), write dx (and d_r). That is
    8 elements a channel of each active row, 12 with a residual. The
    recompute is not counted, nor the mask bytes and the zeros of the
    inactive rows, which a kernel that read only active rows would not
    move."""
    total = 0.0
    for l, c, residual in norm_calls():
        total += BYTES * c * float(active_cells_by_level[l]) * (
            12 if residual else 8)
    return total
