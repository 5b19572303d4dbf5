"""Train/val core of the port.

Port of `uresnet_pytorch_tpu/trainval.py` on one device: `initialize()`,
`train_step(blob)` (train forward, masked segmentation loss, backward,
Adam, then the BN running moments), `forward(blob)` (eval, with softmax
and IoU counts) and `global_step`. Blobs are the reference's dicts of
numpy arrays (`coords`, `values`, `n_voxels`, `label`, optional `weight`).
The metrics dict carries the reference's keys, the tile-engine counters
`overflow`, `tile_spill` and `vox_spill` included, as tensors on the
device.

Adam equals the reference's `optax.adam(learning_rate)`: b1 0.9, b2 0.999,
eps 1e-8 added to the bias-corrected root, no eps inside the root. The
gradient allreduce over several cards and checkpoints come with the
port's CLI (ROADMAP, queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.losses import (iou_counts,
                                                     segmentation_loss)
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    resolve_device)
from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                     load_jax_variables)

_NOT_PORTED = ("checkpoints are not ported yet: they come with the port's "
               "CLI (ROADMAP, queue 1)")


def _batch_from_blob(blob: Mapping[str, np.ndarray],
                     use_weight: bool) -> Dict[str, np.ndarray]:
    batch = {
        "coords": blob["coords"],
        "values": blob["values"],
        "n_voxels": blob["n_voxels"],
    }
    if "label" in blob:
        batch["label"] = blob["label"]
    if use_weight and "weight" in blob:
        batch["weight"] = blob["weight"]
    return batch


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate): b1 0.9, b2 0.999, eps 1e-8 outside the
    root, bias-corrected."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


class TrainVal:
    def __init__(self, cfg: URESNetConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def initialize(self, variables: Optional[Mapping] = None) -> None:
        """Build the model and Adam. Parameters come from `variables` (a
        reference-style tree, see `utils/weights.py`) or else from
        `init_params` seeded with `cfg.seed`."""
        cfg = self.cfg
        if cfg.model_path or cfg.resume:
            raise NotImplementedError(_NOT_PORTED)
        self.model = construct("uresnet_sparse")(cfg, device=self.device)
        if variables is None:
            variables = init_params(cfg,
                                    torch.Generator().manual_seed(cfg.seed))
        load_jax_variables(self.model, variables)
        self.optimizer = adam(self.model.parameters(), cfg.learning_rate)
        self.step = 0

    def _batch(self, blob: Mapping[str, np.ndarray]) -> Dict[str, Any]:
        use_weight = bool(self.cfg.weight_key) or "weight" in blob
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in _batch_from_blob(blob, use_weight).items()}

    def _metrics(self, batch, train: bool) -> Dict[str, torch.Tensor]:
        logits, diag = self.model(batch["coords"], batch["values"],
                                  batch["n_voxels"], train=train)
        metrics = segmentation_loss(
            logits, batch["label"], batch["n_voxels"],
            weights=batch.get("weight"), num_class=self.cfg.num_class,
            return_softmax=not train)
        metrics.update(diag)
        return metrics

    def train_step(self, blob: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        batch = self._batch(blob)
        self.optimizer.zero_grad(set_to_none=True)
        metrics = self._metrics(batch, train=True)
        metrics["loss"].backward()
        self.optimizer.step()
        commit_batch_moments(self.model)
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def forward(self, blob: Mapping[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        batch = self._batch(blob)
        if "label" not in batch:      # pure inference without labels
            batch["label"] = torch.zeros(batch["values"].shape,
                                         dtype=torch.int32,
                                         device=self.device)
        metrics = self._metrics(batch, train=False)
        # iou_counts only argmaxes, so softmax stands in for logits
        metrics.update(iou_counts(metrics["softmax"], batch["label"],
                                  batch["n_voxels"]))
        return metrics

    @property
    def global_step(self) -> int:
        return self.step
