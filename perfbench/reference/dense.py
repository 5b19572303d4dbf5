"""Plain float32 reference of the dense U-ResNet.

Volumes are (B, C, S, S, S), the events' voxels summed into their cells.
Convolutions follow the configuration's source (flax's conventions):
- a 3^3 convolution with SAME padding is a correlation, out[p] =
  sum_k x[p + k - 1] w[k], w stored as (k0, k1, k2, Cin, Cout);
- the stride-2 down convolution, out[p] = sum_{k in {0,1}^3} x[2p + k]
  w[k];
- the stride-2 transposed convolution, out[2p + k] = x[p] w[1 - k] (flax's
  ConvTranspose, SAME padding, kernel 2);
- BN takes its moments over every cell of the volume, empty cells
  included; blocks are pre-activation with a 1x1 shortcut where the width
  changes; the head is BN, ReLU and a 1x1 convolution with a bias.
Each residual block is recomputed in backward (`torch.utils.checkpoint`)
so that the float32 activations of batch 8 at 128^3 fit on one card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Quant, act, batch_norm, masked_ce
from perfbench.reference.sparse import planes, voxel_rows


def param_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and running moment, with the
    program's names."""
    p = planes(model)
    reps, nlev, nc = model["reps"], model["uresnet_num_strides"], \
        model["num_class"]
    out = [("core.stem.kernel", (3, 3, 3, 1, p[0]), "conv")]

    def bn(prefix, c):
        b = f"{prefix}.BatchNorm_0"
        out.extend([(f"{b}.scale", (c,), "scale"), (f"{b}.bias", (c,), "bias"),
                    (f"{b}.mean", (c,), "mean"), (f"{b}.var", (c,), "var")])

    def block(prefix, cin, f):
        i = 0
        if cin != f:
            out.append((f"{prefix}.Conv_0.kernel", (1, 1, 1, cin, f), "conv"))
            i = 1
        bn(f"{prefix}.BNAct_0", cin)
        out.append((f"{prefix}.Conv_{i}.kernel", (3, 3, 3, cin, f), "conv"))
        bn(f"{prefix}.BNAct_1", f)
        out.append((f"{prefix}.Conv_{i + 1}.kernel", (3, 3, 3, f, f),
                    "conv"))

    for l in range(nlev):
        for r in range(reps):
            block(f"core.enc{l}_block{r}", p[l], p[l])
        if l < nlev - 1:
            bn(f"core.down{l}_bnact", p[l])
            out.append((f"core.down{l}_conv.kernel", (2, 2, 2, p[l], p[l + 1]),
                        "conv"))
    for l in reversed(range(nlev - 1)):
        bn(f"core.up{l}_bnact", p[l + 1])
        out.append((f"core.up{l}_deconv.kernel", (2, 2, 2, p[l + 1], p[l]),
                    "up"))
        for r in range(reps):
            block(f"core.dec{l}_block{r}", 2 * p[l] if r == 0 else p[l], p[l])
    bn("core.head_bnact", p[0])
    out.extend([("core.head.kernel", (1, 1, 1, p[0], nc), "conv"),
                ("core.head.bias", (nc,), "bias")])
    return out


class DenseUResNet:
    def __init__(self, model: dict, quant: Optional[Quant] = None):
        self.model = model
        self.quant = quant or Quant("none")
        self.eps = model.get("bn_eps", 1e-4)
        self.slope = model.get("leaky_relu_slope", 0.0)
        self.moments: Dict[str, tuple] = {}

    def bnact(self, x, p, name, train):
        b = f"{name}.BatchNorm_0"
        rec: list = []
        y = batch_norm(x, p[f"{b}.scale"], p[f"{b}.bias"], p[f"{b}.mean"],
                       p[f"{b}.var"], self.eps, train, rec)
        if rec:
            self.moments[b] = rec[0]
        return self.quant(act(y, self.slope))

    def conv(self, x, k, stride: int = 1, store: bool = True):
        """A convolution; `store` rounds its output as a stored activation
        (the float32 head's is not)."""
        q = self.quant
        w = q(k).permute(4, 3, 0, 1, 2)
        pad = k.shape[0] // 2 if stride == 1 else 0
        y = F.conv3d(q(x), w, stride=stride, padding=pad)
        return q(y) if store else y

    def deconv(self, x, k):
        """out[2p + k] = x[p] w[1 - k], written out per octant."""
        q = self.quant
        B, _, S = x.shape[:3]
        wf = q(k).flip(0, 1, 2)                     # wf[k] = w[1 - k]
        y = torch.einsum("bcxyz,ijkco->boxiyjzk", q(x), wf)
        return q(y.reshape(B, k.shape[4], 2 * S, 2 * S, 2 * S))

    def block(self, x, p, name, train):
        i = 0
        sc = x
        if f"{name}.Conv_0.kernel" in p and p[f"{name}.Conv_0.kernel"].shape[0] \
                == 1:
            sc = self.conv(x, p[f"{name}.Conv_0.kernel"])
            i = 1
        y = self.bnact(x, p, f"{name}.BNAct_0", train)
        y = self.conv(y, p[f"{name}.Conv_{i}.kernel"])
        y = self.bnact(y, p, f"{name}.BNAct_1", train)
        y = self.conv(y, p[f"{name}.Conv_{i + 1}.kernel"])
        return self.quant(sc + y)

    def run_block(self, x, p, name, train):
        if train and torch.is_grad_enabled():
            return checkpoint(self.block, x, p, name, train,
                              use_reentrant=False)
        return self.block(x, p, name, train)

    def forward(self, vol, p, train: bool) -> torch.Tensor:
        m = self.model
        nlev, reps = m["uresnet_num_strides"], m["reps"]
        self.moments = {}
        x = self.conv(vol, p["core.stem.kernel"])
        skips = []
        for l in range(nlev):
            for r in range(reps):
                x = self.run_block(x, p, f"core.enc{l}_block{r}", train)
            if l < nlev - 1:
                skips.append(x)
                y = self.bnact(x, p, f"core.down{l}_bnact", train)
                x = self.conv(y, p[f"core.down{l}_conv.kernel"], stride=2)
        for l in reversed(range(nlev - 1)):
            y = self.bnact(x, p, f"core.up{l}_bnact", train)
            y = self.deconv(y, p[f"core.up{l}_deconv.kernel"])
            x = torch.cat([y, skips[l]], 1)
            for r in range(reps):
                x = self.run_block(x, p, f"core.dec{l}_block{r}", train)
        y = self.bnact(x, p, "core.head_bnact", train)
        return self.conv(y, p["core.head.kernel"], store=False) \
            + p["core.head.bias"].view(1, -1, 1, 1, 1)


def _volume(blob: dict, S: int, device, rows) -> Tuple[torch.Tensor, list]:
    vol = torch.zeros(len(rows), S ** 3, device=device)
    flats = []
    for i, b in enumerate(rows):
        n = int(blob["n_voxels"][b])
        c = torch.as_tensor(blob["coords"][b, :n], device=device).long()
        flat = (c[:, 0] * S + c[:, 1]) * S + c[:, 2]
        vol[i].index_add_(0, flat, torch.as_tensor(blob["values"][b, :n],
                                                   device=device).float())
        flats.append(flat)
    return vol.reshape(len(rows), 1, S, S, S), flats


def _gather(logits: torch.Tensor, flats: list) -> torch.Tensor:
    C = logits.shape[1]
    per = logits.reshape(logits.shape[0], C, -1)
    return torch.cat([per[i][:, f].T for i, f in enumerate(flats)])


def net(model: dict, quant: Optional[Quant] = None) -> DenseUResNet:
    return DenseUResNet(model, quant)


def work(model: dict, coords: List[torch.Tensor]) -> dict:
    """A forward's FLOPs over as many dense events as `coords` holds, and
    the least time of its convolutions (`core/flops.py`)."""
    from perfbench.core import flops     # flops imports the sparse module
    d = flops.dense_work(model["spatial_size"], planes(model), model["reps"],
                         model["num_class"])
    n = len(coords)
    return {"flops": d["flops"] * n, "sm_bound_s": 0.0,
            "dense_conv_bound_s": d["conv_bound_s"] * n}


def infer(model: dict, params: dict, blob: dict, device,
          quant: Optional[Quant] = None) -> torch.Tensor:
    rows = range(len(blob["n_voxels"]))
    vol, flats = _volume(blob, model["spatial_size"], device, rows)
    with torch.no_grad():
        logits = DenseUResNet(model, quant).forward(vol, params, False)
    return _gather(logits, flats)


def loss_and_grads(net, model: dict, params: dict, blob: dict, device,
                   rows=None):
    rows = list(range(len(blob["n_voxels"]))) if rows is None else rows
    vol, flats = _volume(blob, model["spatial_size"], device, rows)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if not k.endswith((".mean", ".var"))}
    full = dict(params)
    full.update(leaves)
    logits = _gather(net.forward(vol, full, train=True), flats)
    w = voxel_rows(blob, "weight", device, rows) if "weight" in blob \
        else None
    loss = masked_ce(logits, voxel_rows(blob, "label", device, rows), w)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
