"""Train/val core of the port.

Port of `uresnet_pytorch_tpu/trainval.py`: `initialize()`,
`train_step(blob)` (train forward, masked segmentation loss, backward,
Adam, then the BN running moments), `forward(blob)` (eval, with softmax
and IoU counts), `save_state(iteration)`, `restore_state(path)` and
`global_step`. Blobs are the reference's dicts of numpy arrays (`coords`,
`values`, `n_voxels`, `label`, optional `weight`). The metrics dict
carries the reference's keys, the tile-engine counters `overflow`,
`tile_spill` and `vox_spill` included, as tensors on the device.

Adam equals the reference's `optax.adam(learning_rate)`: b1 0.9, b2 0.999,
eps 1e-8 added to the bias-corrected root, no eps inside the root.
Checkpoints are `utils/checkpoint.py`'s.

Data parallel (the reference's `make_mesh` from `cfg.gpus` and its batch
checks): under a torch.distributed process group every rank builds a
`TrainVal` on the same configuration (`parallel.launch` starts them; rank r
on cuda:gpus[r]). `train_step` and `forward` take the global blob and run
on the rank's shard of it (a blob of batch_size / ranks events, as each
rank's loader gives it, is taken as that shard). The masked BN moments,
the loss's normalization and every metric are the global batch's
(models/norm.py, models/losses.py), the gradients are summed over the
ranks in one flat collective after `backward()` and before Adam, and rank
0's parameters and buffers are broadcast at `initialize()` and after a
restore. Gradients are summed by hand rather than by
`DistributedDataParallel`: under `stage_dots` the recompute issues BN's
collectives inside backward, and they must come in the same order on every
rank, which DDP's bucket hooks would interleave with.
"""

from __future__ import annotations

import glob
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.losses import (iou_counts,
                                                     reduce_counts,
                                                     segmentation_loss)
from uresnet_pytorch_tpu_torch.models.norm import (commit_batch_moments,
                                                   use_mesh)
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    resolve_device)
from uresnet_pytorch_tpu_torch.parallel.mesh import (DataMesh,
                                                     all_reduce_sum,
                                                     broadcast_, make_mesh,
                                                     shard_batch)
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


def _make_mesh(cfg: URESNetConfig, device) -> DataMesh:
    """The data mesh over the default process group, or a world of one:
    every rank on `device`, or with CUDA on the ordinals `cfg.gpus` names,
    rank r on cuda:gpus[r]."""
    device = resolve_device(device)
    on_card = device.type == "cuda" and device.index is None
    return make_mesh(devices=None if on_card else device,
                     device_ids=cfg.gpus)


class TrainVal:
    def __init__(self, cfg: URESNetConfig, device="cuda",
                 mesh: Optional[DataMesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else _make_mesh(cfg, device)
        self.device = self.mesh.device
        if self.device.type == "cuda":
            # the kernels launch on the current device's stream
            torch.cuda.set_device(self.device)
        self.model = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0

    def initialize(self, variables: Optional[Mapping] = None) -> None:
        """Build the model and Adam. Parameters come from `variables` (a
        reference-style tree, see `utils/weights.py`) or else from
        `init_params` seeded with `cfg.seed`; then `cfg.model_path` (a
        path or a glob: its last match in sorted order) or, with
        `cfg.resume`, the latest checkpoint under `cfg.weight_prefix` is
        restored. Under a data mesh, rank 0's state is then every rank's."""
        cfg, n = self.cfg, self.mesh.size
        if cfg.batch_size % n:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by {n} ranks "
                f"(set -bs to a multiple, or -mbs per-rank size)")
        if cfg.minibatch_size > 0 and cfg.minibatch_size * n != cfg.batch_size:
            raise ValueError(
                f"minibatch_size*n_devices = {cfg.minibatch_size * n} "
                f"!= batch_size {cfg.batch_size}")
        self.model = construct(cfg.model_name)(cfg, device=self.device)
        use_mesh(self.model, self.mesh)
        if variables is None:
            variables = init_params(cfg,
                                    torch.Generator().manual_seed(cfg.seed))
        load_jax_variables(self.model, variables)
        self.optimizer = adam(self.model.parameters(), cfg.learning_rate)
        self.step = 0
        path = None
        if cfg.model_path:
            matches = sorted(glob.glob(cfg.model_path))
            path = matches[-1] if matches else cfg.model_path
        elif cfg.resume:
            path = latest_checkpoint(cfg.weight_prefix)
        if path:
            self.restore_state(path)
        else:
            self._replicate()

    def _replicate(self) -> None:
        """Rank 0's parameters and buffers on every rank."""
        broadcast_(self.mesh, [*self.model.parameters(),
                               *self.model.buffers()])

    def _batch(self, blob: Mapping[str, np.ndarray]) -> Dict[str, Any]:
        """The rank's shard of a global blob (a blob of batch_size / ranks
        events is that shard already), as tensors on the device."""
        n = self.mesh.size
        if n > 1 and len(blob["n_voxels"]) != self.cfg.batch_size // n:
            blob = shard_batch(blob, self.mesh)
        use_weight = bool(self.cfg.weight_key) or "weight" in blob
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in _batch_from_blob(blob, use_weight).items()}

    def _metrics(self, batch, train: bool) -> Dict[str, torch.Tensor]:
        logits, diag = self.model(batch["coords"], batch["values"],
                                  batch["n_voxels"], train=train)
        metrics = segmentation_loss(
            logits, batch["label"], batch["n_voxels"],
            weights=batch.get("weight"), num_class=self.cfg.num_class,
            return_softmax=not train, mesh=self.mesh)
        metrics.update(reduce_counts(diag, self.mesh))
        return metrics

    def _sum_gradients(self) -> None:
        """Each gradient summed over the ranks, in one flat collective."""
        if self.mesh.group is None:
            return
        params = list(self.model.parameters())
        grads = all_reduce_sum(self.mesh, *[
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in params])
        for p, g in zip(params, grads):
            p.grad = g

    def train_step(self, blob: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        batch = self._batch(blob)
        self.optimizer.zero_grad(set_to_none=True)
        metrics = self._metrics(batch, train=True)
        metrics["loss"].backward()
        self._sum_gradients()
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
                                  batch["n_voxels"], self.mesh))
        return metrics

    @property
    def global_step(self) -> int:
        return self.step

    def save_state(self, iteration: int) -> str:
        """Write `{weight_prefix}-{iteration}.ckpt`. Under a data mesh only
        rank 0 writes; every rank returns the path."""
        path = checkpoint_path(self.cfg.weight_prefix, iteration)
        if self.mesh.rank == 0:
            save_checkpoint(path, train_state(self.model, self.optimizer,
                                              self.step))
        return path

    def restore_state(self, path: str) -> None:
        """Load a checkpoint of either format (utils/checkpoint.py); under
        a data mesh rank 0's copy is then every rank's."""
        self.step = load_train_state(self.model, self.optimizer,
                                     restore_checkpoint(path))
        self._replicate()
