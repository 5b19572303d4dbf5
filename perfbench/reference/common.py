"""What the plain references share: the precision policy, masked
cross-entropy, and Adam.

Everything here is plain PyTorch in float32. A reference is run with TF32
off (`no_tf32`), so that a float32 product is a float32 product.

The precision policy `Quant` computes the model in a lower precision: the
control that has to come out as not correct. `fp8` rounds to float8 e4m3,
with one scale per tensor (its largest magnitude onto e4m3's largest
finite value, 448), the operands of every product and every stored
activation (convolution, BN and activation, residual sum, down and up
outputs), and in backward each of their gradients, where the program
rounds them to bfloat16, the configurations' compute type; products sum
in float32, as bfloat16's do. float8 is the step below bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

E4M3_MAX = 448.0


def _round_e4m3(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().max().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    """Rounds a stored activation to float8, and its gradient too, as a
    float8 training step stores both."""

    @staticmethod
    def forward(ctx, t):
        return _round_e4m3(t)

    @staticmethod
    def backward(ctx, g):
        return _round_e4m3(g)


class Quant:
    """Rounds a tensor: `none` (float32, the reference) or `fp8` (float8
    e4m3 with a scale per tensor, the control; in backward the tensor's
    gradient is rounded the same way)."""

    def __init__(self, mode: str = "none"):
        if mode not in ("none", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "none":
            return t
        if not torch.is_grad_enabled() or not t.requires_grad:
            return _round_e4m3(t.detach())
        return _Round.apply(t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)


@contextlib.contextmanager
def no_tf32():
    cuda = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    old = (cuda.allow_tf32, cudnn.allow_tf32)
    cuda.allow_tf32, cudnn.allow_tf32 = False, False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = old


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows given, weighted by
    `weights` and divided by their sum; labels clip to the classes."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab = labels.long().clamp(0, C - 1)
    nll = -logp.gather(-1, lab[:, None])[:, 0]
    w = torch.ones_like(nll) if weights is None else weights.float()
    return (nll * w).sum() / w.sum().clamp(min=1.0)


class Adam:
    """Adam as the configurations state it (b1 0.9, b2 0.999, eps 1e-8
    added to the bias-corrected root), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            mhat = self.m[k] / c1
            vhat = self.v[k] / c2
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def batch_norm(x: torch.Tensor, scale, bias, mean, var, eps: float,
               train: bool, moments: Optional[list] = None):
    """BN over rows (N, C) or over every cell of a volume (B, C, ...):
    batch moments in train (biased variance, recorded into `moments`),
    the running ones in eval."""
    red = (0,) if x.dim() == 2 else (0,) + tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        mu = x.mean(red)
        va = ((x - mu.view(shape)) ** 2).mean(red)
        if moments is not None:
            moments.append((mu.detach(), va.detach()))
    else:
        mu, va = mean, var
    inv = torch.rsqrt(va + eps)
    return (x - mu.view(shape)) * (inv * scale).view(shape) \
        + bias.view(shape)


def act(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x) if slope > 0 else torch.relu(x)
