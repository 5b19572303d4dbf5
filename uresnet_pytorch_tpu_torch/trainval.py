"""Train/val core of the port.

Port of `uresnet_pytorch_tpu/trainval.py` on one device: `initialize()`,
`train_step(blob)` (train forward, masked segmentation loss, backward,
Adam, then the BN running moments), `forward(blob)` (eval, with softmax
and IoU counts), `save_state(iteration)`, `restore_state(path)` and
`global_step`. Blobs are the reference's dicts of numpy arrays (`coords`,
`values`, `n_voxels`, `label`, optional `weight`). The metrics dict
carries the reference's keys, the tile-engine counters `overflow`,
`tile_spill` and `vox_spill` included, as tensors on the device.

Adam equals the reference's `optax.adam(learning_rate)`: b1 0.9, b2 0.999,
eps 1e-8 added to the bias-corrected root, no eps inside the root.
Checkpoints are `utils/checkpoint.py`'s. `cfg.gpus` names one CUDA
ordinal; the gradient allreduce over several cards is not ported (ROADMAP,
queue 1: data parallel).
"""

from __future__ import annotations

import glob
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.losses import (iou_counts,
                                                     segmentation_loss)
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    resolve_device)
from uresnet_pytorch_tpu_torch.utils.checkpoint import (
    checkpoint_path, latest_checkpoint, load_train_state, restore_checkpoint,
    save_checkpoint, train_state)
from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                     load_jax_variables)


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


def _select_device(cfg: URESNetConfig, device) -> torch.device:
    """`device`, on the card `cfg.gpus` names when it is CUDA."""
    if len(cfg.gpus) > 1:
        raise NotImplementedError(
            f"gpus={cfg.gpus}: data parallel over several cards is not "
            "ported yet (ROADMAP, queue 1: data parallel)")
    device = resolve_device(device)
    if device.type == "cuda" and cfg.gpus:
        device = torch.device("cuda", cfg.gpus[0])
        # the kernels launch on the current device's stream
        torch.cuda.set_device(device)
    return device


class TrainVal:
    def __init__(self, cfg: URESNetConfig, device="cuda"):
        self.cfg = cfg
        self.device = _select_device(cfg, device)
        self.model = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def initialize(self, variables: Optional[Mapping] = None) -> None:
        """Build the model and Adam. Parameters come from `variables` (a
        reference-style tree, see `utils/weights.py`) or else from
        `init_params` seeded with `cfg.seed`; then `cfg.model_path` (a
        path or a glob: its last match in sorted order) or, with
        `cfg.resume`, the latest checkpoint under `cfg.weight_prefix` is
        restored."""
        cfg = self.cfg
        if cfg.minibatch_size > 0 and cfg.minibatch_size != cfg.batch_size:
            raise ValueError(
                f"minibatch_size*n_devices = {cfg.minibatch_size} "
                f"!= batch_size {cfg.batch_size}")
        self.model = construct(cfg.model_name)(cfg, device=self.device)
        if variables is None:
            variables = init_params(cfg,
                                    torch.Generator().manual_seed(cfg.seed))
        load_jax_variables(self.model, variables)
        self.optimizer = adam(self.model.parameters(), cfg.learning_rate)
        self.step = 0
        if cfg.model_path:
            matches = sorted(glob.glob(cfg.model_path))
            self.restore_state(matches[-1] if matches else cfg.model_path)
        elif cfg.resume:
            latest = latest_checkpoint(cfg.weight_prefix)
            if latest:
                self.restore_state(latest)

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

    def save_state(self, iteration: int) -> str:
        """Write `{weight_prefix}-{iteration}.ckpt`. Under torch.distributed
        only rank 0 writes; every rank returns the path."""
        path = checkpoint_path(self.cfg.weight_prefix, iteration)
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_rank() == 0:
            save_checkpoint(path, train_state(self.model, self.optimizer,
                                              self.step))
        return path

    def restore_state(self, path: str) -> None:
        """Load a checkpoint of either format (utils/checkpoint.py)."""
        self.step = load_train_state(self.model, self.optimizer,
                                     restore_checkpoint(path))
