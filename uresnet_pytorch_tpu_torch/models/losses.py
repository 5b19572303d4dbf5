"""Per-voxel segmentation loss and metrics.

Port of `uresnet_pytorch_tpu/models/losses.py`: softmax cross-entropy per
valid voxel against integer labels, times optional per-voxel weights,
averaged over the weight sum; argmax accuracy overall and per class; and
the per-class intersection/union counts for mIoU. Padded rows never
contribute. Same dict keys as the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from uresnet_pytorch_tpu_torch.ops.voxelize import valid_mask


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      n_voxels: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      num_class: int = 5,
                      return_softmax: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """logits (B, V, C); labels (B, V) int; n_voxels (B,); weights (B, V).

    Returns {loss, accuracy, count, per_class_accuracy (C,), class_count
    (C,)} and softmax (B, V, C) when asked. As in the reference, labels
    clip to the logits' C and `num_class` is unused."""
    B, V, C = logits.shape
    mask = valid_mask(n_voxels, V)
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    labels_safe = labels.long().clamp(0, C - 1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    w = mask.float()
    if weights is not None:
        w = w * weights
    count = w.sum().clamp(min=1.0)
    loss = (nll * w).sum() / count

    pred = logits.argmax(dim=-1)
    correct = (pred == labels_safe) & mask
    n_valid = mask.sum().clamp(min=1)
    accuracy = correct.sum() / n_valid

    onehot = F.one_hot(labels_safe, C).float() * mask[..., None]
    class_count = onehot.sum(dim=(0, 1))
    class_correct = (onehot * correct[..., None].float()).sum(dim=(0, 1))
    per_class_accuracy = class_correct / class_count.clamp(min=1.0)

    out = {
        "loss": loss,
        "accuracy": accuracy,
        "count": mask.sum().to(torch.int32),
        "per_class_accuracy": per_class_accuracy,
        "class_count": class_count,
    }
    if return_softmax:
        out["softmax"] = torch.softmax(logits, dim=-1)
    return out


def iou_counts(logits: torch.Tensor, labels: torch.Tensor,
               n_voxels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-class intersection/union counts for mIoU. Accumulate across
    batches, then iou = I / U."""
    B, V, C = logits.shape
    mask = valid_mask(n_voxels, V)[..., None]
    pred = logits.argmax(dim=-1)
    labels = labels.long().clamp(0, C - 1)
    p1 = F.one_hot(pred, C).float() * mask
    t1 = F.one_hot(labels, C).float() * mask
    return {"intersection": (p1 * t1).sum(dim=(0, 1)),
            "union": torch.maximum(p1, t1).sum(dim=(0, 1))}
