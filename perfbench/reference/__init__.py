"""Plain float32 references of the benchmark's models, and the training
steps they follow. They import nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import dense, sparse
from perfbench.reference.common import Adam, Quant


def module_of(model: dict):
    """The reference module for a configuration's model."""
    return {"uresnet_sparse": sparse,
            "uresnet_dense": dense}[model["model_name"]]


def net_of(model: dict, quant: Optional[Quant] = None):
    if model["model_name"] == "uresnet_sparse":
        return sparse.SparseUResNet(model, quant)
    return dense.DenseUResNet(model, quant)


def is_moment(name: str) -> bool:
    return name.endswith((".mean", ".var"))


def train_steps(model: dict, params: Dict[str, torch.Tensor], blobs: List,
                device, quant: Optional[Quant] = None,
                half_batch: bool = False) -> dict:
    """len(blobs) training steps from `params`: train-mode forward, masked
    cross-entropy, gradients, Adam, then the running moments. Returns each
    step's loss, the first step's gradients and the state after the last
    step. `half_batch` takes the loss over the first half of each batch
    only: a fault the comparison has to catch."""
    mod = module_of(model)
    net = net_of(model, quant)
    p = {k: v.detach().clone().float() for k, v in params.items()}
    opt = Adam({k: v for k, v in p.items() if not is_moment(k)},
               model["learning_rate"])
    mom = model.get("bn_momentum", 0.9)
    losses, first = [], None
    for blob in blobs:
        B = len(blob["n_voxels"])
        rows = list(range(B // 2)) if half_batch else None
        loss, grads = mod.loss_and_grads(net, model, p, blob, device, rows)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step({k: v for k, v in p.items() if not is_moment(k)}, grads)
        with torch.no_grad():
            for name, (mu, va) in net.moments.items():
                p[f"{name}.mean"].mul_(mom).add_((1.0 - mom) * mu)
                p[f"{name}.var"].mul_(mom).add_((1.0 - mom) * va)
        losses.append(float(loss))
        del grads
    return {"losses": losses, "grads": first, "state": p}


def infer(model: dict, params: Dict[str, torch.Tensor], blob: dict, device,
          quant: Optional[Quant] = None) -> torch.Tensor:
    """Eval-mode logits of every valid voxel of the blob, events in
    order."""
    return module_of(model).infer(model, params, blob, device, quant)
