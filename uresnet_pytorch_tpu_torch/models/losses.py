"""Per-voxel segmentation loss and metrics.

Port of `uresnet_pytorch_tpu/models/losses.py`: softmax cross-entropy per
valid voxel against integer labels, times optional per-voxel weights,
averaged over the weight sum; argmax accuracy overall and per class; and
the per-class intersection/union counts for mIoU. Padded rows never
contribute. Same dict keys as the reference. Under a data mesh each rank
holds a shard and the numbers are the global batch's (`mesh`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from uresnet_pytorch_tpu_torch.ops.voxelize import valid_mask
from uresnet_pytorch_tpu_torch.parallel.mesh import all_reduce_sum


def reduce_counts(counts: Dict[str, torch.Tensor],
                  mesh=None) -> Dict[str, torch.Tensor]:
    """Each counter summed over the data mesh's ranks in one collective
    (in f64, exact for counts, then back to each counter's dtype): the
    global batch's counters. Unchanged without a process group."""
    if mesh is None or mesh.group is None:
        return counts
    names = list(counts)
    summed = all_reduce_sum(mesh, *[counts[k].detach().double()
                                    for k in names])
    return {k: v.to(counts[k].dtype) for k, v in zip(names, summed)}


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      n_voxels: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      num_class: int = 5,
                      return_softmax: bool = False,
                      mesh=None) -> Dict[str, torch.Tensor]:
    """logits (B, V, C); labels (B, V) int; n_voxels (B,); weights (B, V).

    Returns {loss, accuracy, count, per_class_accuracy (C,), class_count
    (C,)} and softmax (B, V, C) when asked. As in the reference, labels
    clip to the logits' C and `num_class` is unused.

    Under a data mesh (`mesh` with a process group) the rank holds a shard
    of the batch and every number describes the global batch: the sums
    behind the metrics and `sum(nll*w)` are summed over the ranks in one
    collective. The loss is normalized once, by the global `sum(w)`: its
    value is the global loss, and its gradient is that of this rank's
    `sum(nll*w) / global sum(w)`, so the sum of the ranks' gradients is
    the reference's gradient. The softmax stays the rank's."""
    B, V, C = logits.shape
    mask = valid_mask(n_voxels, V)
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    labels_safe = labels.long().clamp(0, C - 1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    w = mask.float()
    if weights is not None:
        w = w * weights
    pred = logits.argmax(dim=-1)
    correct = (pred == labels_safe) & mask
    onehot = F.one_hot(labels_safe, C).float() * mask[..., None]
    class_count = onehot.sum(dim=(0, 1))
    class_correct = (onehot * correct[..., None].float()).sum(dim=(0, 1))
    local = (nll * w).sum()
    g = reduce_counts({"nll": local, "w": w.sum(), "correct": correct.sum(),
                       "valid": mask.sum(), "class_count": class_count,
                       "class_correct": class_correct}, mesh)
    count = g["w"].clamp(min=1.0)
    part = local / count
    loss = part + (g["nll"] / count - part).detach()
    n_correct, n_valid = g["correct"], g["valid"]
    class_count, class_correct = g["class_count"], g["class_correct"]
    accuracy = n_correct / n_valid.clamp(min=1)
    per_class_accuracy = class_correct / class_count.clamp(min=1.0)

    out = {
        "loss": loss,
        "accuracy": accuracy,
        "count": n_valid.to(torch.int32),
        "per_class_accuracy": per_class_accuracy,
        "class_count": class_count,
    }
    if return_softmax:
        out["softmax"] = torch.softmax(logits, dim=-1)
    return out


def iou_counts(logits: torch.Tensor, labels: torch.Tensor,
               n_voxels: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
    """Per-class intersection/union counts for mIoU, of the global batch
    under a data mesh. Accumulate across batches, then iou = I / U."""
    B, V, C = logits.shape
    mask = valid_mask(n_voxels, V)[..., None]
    pred = logits.argmax(dim=-1)
    labels = labels.long().clamp(0, C - 1)
    p1 = F.one_hot(pred, C).float() * mask
    t1 = F.one_hot(labels, C).float() * mask
    return reduce_counts({"intersection": (p1 * t1).sum(dim=(0, 1)),
                          "union": torch.maximum(p1, t1).sum(dim=(0, 1))},
                         mesh)
