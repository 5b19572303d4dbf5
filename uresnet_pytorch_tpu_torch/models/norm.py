"""Masked BatchNorm over active voxel rows, eval form.

Port of `uresnet_pytorch_tpu/models/norm.py` in eval mode: the running
moments fold with scale and bias into one per-channel affine, computed in
f32 and rounded once to the activation dtype. `affine` is the reference's
`return_affine` form: it hands that affine to a fused conv epilogue
instead of applying it. Eval needs no mask (the moments are the running
ones); train-mode masked moments are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, channels: int, epsilon: float = 1e-4):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def affine(self, dtype: torch.dtype):
        """Folded (a, b) with x * a + b == BN(x), rounded once to dtype."""
        inv = torch.rsqrt(self.var + self.epsilon)
        a = (self.scale * inv).to(dtype)
        b = (self.bias - self.mean * self.scale * inv).to(dtype)
        return a, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., C) -> BN(x) in x's dtype."""
        a, b = self.affine(x.dtype)
        return x * a + b
