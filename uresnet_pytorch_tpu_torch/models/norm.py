"""Masked BatchNorm over active voxel rows.

Port of `uresnet_pytorch_tpu/models/norm.py`. Train mode takes the moments
in f32 (f64 for f64 input) over the cells where the mask is set, across
every event and row: `mean = sum(x*m) / count`, `var = sum((x*m)^2) /
count - mean^2` clamped at 0, `count = max(sum(m), 1)`. Eval mode uses the running moments. Either
way scale, bias and moments fold into one per-channel affine computed in
f32 and rounded once to the activation dtype; `affine` hands that affine
to a fused conv epilogue instead of applying it.

x may be a pair (x1, x2) standing for their channel concat (the decoder's
skip, never materialized): the moments and the affine are per channel, so
each half is normalized with its own slice and a pair comes back.

Running moments follow the reference's flax convention, not torch's
`nn.BatchNorm`: `running = momentum * running + (1 - momentum) * batch`
with momentum 0.9 and the biased batch variance. A train-mode forward only
records its batch moments; `commit_batch_moments` applies them once after
the step. Under recompute (torch.utils.checkpoint) the forward runs twice
and records the same moments twice, so an in-place update there would be
applied twice.

Under a data mesh of several ranks (`use_mesh`) the moments are the whole
sharded batch's, as in the reference, whose BN sums run over the sharded
batch axis under GSPMD: `sum(x*m)`, `sum((x*m)^2)` and `sum(m)` are summed
over the ranks in one differentiable collective (its backward sums the
cotangents over the ranks), so the running moments are the same on every
rank. The pair path reduces both halves in that one collective.

The models apply BN, its activation and the tile engine's re-mask through
`ops/cuda/norm_act.py:norm_act`, one operator with hand-written kernels
on the card; `forward` here is its plain chain's BN (`masked_bn_plain`),
for the layers that take BN alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uresnet_pytorch_tpu_torch.ops.cuda.norm_act import masked_bn_plain


class MaskedBatchNorm(nn.Module):
    def __init__(self, channels: int, epsilon: float = 1e-4,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.batch_moments = None   # (mean, var) of the last train forward
        self.mesh = None            # the data mesh the moments span

    def affine(self, dtype: torch.dtype, mean=None, var=None):
        """Folded (a, b) with x * a + b == BN(x), rounded once to dtype;
        the running moments unless others are given."""
        mean = self.mean if mean is None else mean
        var = self.var if var is None else var
        inv = torch.rsqrt(var + self.epsilon)
        a = (self.scale * inv).to(dtype)
        b = (self.bias - mean * self.scale * inv).to(dtype)
        return a, b

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                train: bool = False):
        """x (..., C) or a pair of (..., C1), (..., C2); mask (...) bool,
        read in train mode only. Returns BN(x) in x's dtype (a pair for a
        pair)."""
        pair = isinstance(x, tuple)
        out, moments = masked_bn_plain(x if pair else (x,), mask, self.scale,
                                       self.bias, self.mean, self.var,
                                       self.epsilon, self.mesh, train)
        if moments is not None:
            self.batch_moments = moments
        return out if pair else out[0]

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the recorded batch moments into the running ones, once."""
        if self.batch_moments is None:
            return
        mean, var = self.batch_moments
        self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
        self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        self.batch_moments = None


def use_mesh(module: nn.Module, mesh) -> None:
    """Every MaskedBatchNorm of `module` (the dense model's BatchNorm too)
    takes its train-mode moments over `mesh`'s whole batch."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.mesh = mesh


def commit_batch_moments(module: nn.Module) -> None:
    """Apply every MaskedBatchNorm's recorded train-mode moments once."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.commit()
