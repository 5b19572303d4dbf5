"""Plain float32 references of the benchmark's models, and the training
steps they follow. They import nothing of the program.

A configuration's reference is a module with one interface:

- `param_spec(model)`: (name, shape, kind) of every parameter and running
  moment, with the program's names (`core/weights.py` makes them);
- `net(model, quant)`: the network, whose `moments` hold the BN batch
  moments of its last train-mode forward;
- `infer(model, params, blob, device, quant)`: eval-mode logits of every
  valid voxel of a blob, events in order;
- `loss_and_grads(net, model, params, blob, device, rows)`: the train-mode
  loss of the blob's events (or of `rows` of them) and every gradient;
- `work(model, coords)`: the model work of one forward over the events
  whose voxel coordinates are given: `flops`, and the least time on the
  card of the convolutions the roofline shares read (`sm_bound_s`,
  `dense_conv_bound_s`; 0 where the model has none).

A configuration file names its module with `"reference":
"perfbench/reference/<name>.py"`, a path from the root of the checkout;
without the key, the model's name picks one of the modules here.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.core.cells import load_module
from perfbench.reference import dense, sparse
from perfbench.reference.common import Adam, Quant

BY_MODEL = {"uresnet_sparse": sparse, "uresnet_dense": dense}


def module_of(config: dict, root: Path):
    """The reference module of a configuration file's contents: the file
    its `reference` key names under `root`, else the module of its
    model's name."""
    if "reference" in config:
        return load_module(root / config["reference"],
                           "perfbench_reference_")
    return BY_MODEL[config["model"]["model_name"]]


def is_moment(name: str) -> bool:
    return name.endswith((".mean", ".var"))


def train_steps(mod, model: dict, params: Dict[str, torch.Tensor],
                blobs: List, device, quant: Optional[Quant] = None,
                half_batch: bool = False) -> dict:
    """len(blobs) training steps of the reference module `mod` from
    `params`: train-mode forward, masked cross-entropy, gradients, Adam,
    then the running moments. Returns each step's loss, the first step's
    gradients and the state after the last step. `half_batch` takes the
    loss over the first half of each batch only: a fault the comparison
    has to catch."""
    net = mod.net(model, quant)
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
