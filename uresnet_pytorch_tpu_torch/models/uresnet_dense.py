"""Dense 2D/3D U-ResNet on cuDNN convolutions.

Port of `uresnet_pytorch_tpu/models/uresnet_dense.py`. Module and
parameter names follow the reference's flax tree letter for letter
(`core.stem.kernel`, `core.enc0_block0.Conv_0.kernel`,
`core.enc0_block0.BNAct_0.BatchNorm_0.scale`, `core.up0_deconv.kernel`,
`core.head.bias`, ...), so `utils/weights.load_jax_variables`, checkpoints
and the importers map one onto the other by name. As in flax, a block's
`Conv_i` are numbered in creation order: where the block changes width,
`Conv_0` is the 1x1 shortcut and the 3^d convs are `Conv_1` and `Conv_2`.

Kernels are stored in the reference's `(*k, I, O)` layout and permuted at
use: to `(O, I, *k)` for a convolution, and to `(I, O, *k)` with every
spatial axis flipped for flax's `ConvTranspose` (its kernel is a
correlation kernel over the dilated input, `F.conv_transpose*` a
convolution's transpose). Volumes are `(B, C, *S)` tensors in
channels-last memory, the reference's `(B, *S, C)` bytes, which cuDNN
takes without a copy.

BatchNorm is flax's, not `nn.BatchNorm3d`: moments in f32 over every cell
of the volume (empty cells included), the biased variance
`E[x^2] - E[x]^2` clamped at 0, `(x - mean) * (scale * rsqrt(var + eps)) +
bias` in f32, the activation, then one cast to the compute dtype. Train
mode records its batch moments and `norm.commit_batch_moments` folds them
into the running ones once after the step, as for the sparse models: each
residual block is recomputed in backward (`torch.utils.checkpoint`, train
mode only, as the reference's `nn.remat`), so an update in the forward
would be applied twice.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import register_model
from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    _DTYPES, _in_span, _lecun_normal, resolve_device)
from uresnet_pytorch_tpu_torch.ops.cuda.norm_act import norm_act
from uresnet_pytorch_tpu_torch.ops.voxelize import gather_voxels, voxelize
from uresnet_pytorch_tpu_torch.utils.timing import span


def _channels_last(dim: int) -> torch.memory_format:
    return torch.channels_last_3d if dim == 3 else torch.channels_last


class BNAct(nn.Module):
    """flax's `nn.BatchNorm(dtype=float32)` over (B, C, *S), every cell
    counting, on every rank of its data mesh; LeakyReLU (ReLU at slope 0);
    then the compute dtype: one operator (`ops/cuda/norm_act.py:norm_act`,
    `folded=False`: the plain chain on the CPU, the kernels on the card,
    which take the channels-last volume as rows of channels). Its
    parameters, buffers, mesh and commit are MaskedBatchNorm's."""

    def __init__(self, cfg: URESNetConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.BatchNorm_0 = MaskedBatchNorm(channels, epsilon=cfg.bn_eps,
                                           momentum=cfg.bn_momentum)

    def forward(self, x, train: bool = False):
        bn = self.BatchNorm_0
        with span("norm"):
            y, moments = norm_act(
                x, None, bn.scale, bn.bias, bn.mean, bn.var, train=train,
                remask=False, folded=False,
                slope=self.cfg.leaky_relu_slope, eps=bn.epsilon,
                dtype=_DTYPES[self.cfg.compute_dtype], mesh=bn.mesh, cdim=1)
        if moments is not None:
            bn.batch_moments = moments
        return y


class Conv(nn.Module):
    """flax's `nn.Conv` (SAME padding) or, with `transpose`,
    `nn.ConvTranspose`, on a kernel stored as (*k, I, O)."""

    def __init__(self, cfg: URESNetConfig, cin: int, cout: int, k: int,
                 stride: int = 1, bias: bool = False,
                 transpose: bool = False, dtype: Optional[str] = None):
        super().__init__()
        self.dim = cfg.data_dim
        self.stride = stride
        self.padding = k // 2 if stride == 1 else 0
        self.transpose = transpose
        self.dtype = _DTYPES[dtype or cfg.compute_dtype]
        self.kernel = nn.Parameter(torch.empty((k,) * self.dim + (cin, cout)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        nd = self.dim
        x = x.to(self.dtype).contiguous(memory_format=_channels_last(nd))
        w = self.kernel.to(self.dtype)
        if self.transpose:
            w = w.permute(nd, nd + 1, *range(nd)).flip(list(range(2, 2 + nd)))
            op = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
            return op(x, w, stride=self.stride)
        w = w.permute(nd + 1, nd, *range(nd))
        op = F.conv3d if nd == 3 else F.conv2d
        bias = self.bias.to(self.dtype) if hasattr(self, "bias") else None
        return op(x, w, bias, stride=self.stride, padding=self.padding)


class ResBlock(nn.Module):
    """Pre-activation residual block; a 1x1 projection shortcut when the
    width changes."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.project = cin != features
        i = int(self.project)
        if self.project:
            self.Conv_0 = Conv(cfg, cin, features, 1)
        self.BNAct_0 = BNAct(cfg, cin)
        self.add_module(f"Conv_{i}", Conv(cfg, cin, features, 3))
        self.BNAct_1 = BNAct(cfg, features)
        self.add_module(f"Conv_{i + 1}", Conv(cfg, features, features, 3))

    def forward(self, x, train: bool = False):
        i = int(self.project)
        shortcut = self.Conv_0(x) if self.project else x
        y = getattr(self, f"Conv_{i}")(self.BNAct_0(x, train))
        y = getattr(self, f"Conv_{i + 1}")(self.BNAct_1(y, train))
        return shortcut + y


class DenseUResNetCore(nn.Module):
    """Volume (B, 1, *S) -> per-cell logits (B, num_class, *S) in f32."""

    def __init__(self, cfg: URESNetConfig):
        super().__init__()
        self.cfg = cfg
        planes = cfg.n_planes
        nlev = len(planes)
        self.stem = Conv(cfg, 1, planes[0], 3)
        for level, width in enumerate(planes):
            for r in range(cfg.reps):
                self.add_module(f"enc{level}_block{r}",
                                ResBlock(cfg, width, width))
            if level < nlev - 1:
                self.add_module(f"down{level}_bnact", BNAct(cfg, width))
                self.add_module(f"down{level}_conv", Conv(
                    cfg, width, planes[level + 1], 2, stride=2))
        for level in reversed(range(nlev - 1)):
            self.add_module(f"up{level}_bnact", BNAct(cfg, planes[level + 1]))
            self.add_module(f"up{level}_deconv", Conv(
                cfg, planes[level + 1], planes[level], 2, stride=2,
                transpose=True))
            for r in range(cfg.reps):
                cin = 2 * planes[level] if r == 0 else planes[level]
                self.add_module(f"dec{level}_block{r}",
                                ResBlock(cfg, cin, planes[level]))
        self.head_bnact = BNAct(cfg, planes[0])
        self.head = Conv(cfg, planes[0], cfg.num_class, 1, bias=True,
                         dtype="float32")

    def _block(self, name: str, x, train: bool):
        """The block `name` in the span `stage.<name>`, recomputed in
        backward (span and all) in training, as the reference's remat."""
        run = functools.partial(_in_span, "stage." + name, getattr(self, name))
        if train and torch.is_grad_enabled():
            return checkpoint(run, x, train, use_reentrant=False)
        return run(x, train)

    def forward(self, vol, train: bool = False):
        cfg = self.cfg
        nlev = len(cfg.n_planes)
        with span("stage.stem"):
            x = self.stem(vol)
        skips = []
        for level in range(nlev):
            for r in range(cfg.reps):
                x = self._block(f"enc{level}_block{r}", x, train)
            if level < nlev - 1:
                skips.append(x)
                x = getattr(self, f"down{level}_bnact")(x, train)
                x = getattr(self, f"down{level}_conv")(x)
        for level in reversed(range(nlev - 1)):
            x = getattr(self, f"up{level}_bnact")(x, train)
            x = getattr(self, f"up{level}_deconv")(x)
            x = torch.cat([x, skips[level].to(x.dtype)], dim=1)
            for r in range(cfg.reps):
                x = self._block(f"dec{level}_block{r}", x, train)
        with span("stage.head"):
            return self.head(self.head_bnact(x, train).float())


class UResNetDense(nn.Module):
    """forward(coords (B,V,dim) int32, values (B,V) f32, n_voxels (B,)
    int32, train=False) -> (logits (B, V, num_class) f32, diag): the
    voxelized volume through the core, gathered back at the blob's rows
    (rows beyond n_voxels read cell 0, as in the reference). diag holds
    the zero `overflow`, `tile_spill` and `vox_spill` counters that the
    reference's TrainVal gives a model without them."""

    def __init__(self, cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.core = DenseUResNetCore(cfg)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's defaults: lecun_normal kernels over fan-in prod(k) * I,
        zero biases, BN scale 1."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                p.copy_(_lecun_normal(tuple(p.shape), generator))
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, coords, values, n_voxels, train: bool = False):
        S = self.cfg.spatial_size
        vol = voxelize(coords, values, n_voxels, S).movedim(-1, 1)
        logits = self.core(vol, train).movedim(1, -1)
        zero = torch.zeros((), dtype=torch.int32, device=coords.device)
        with span("reorder"):
            logits = gather_voxels(logits, coords, n_voxels, S)
        return logits, {"overflow": zero, "tile_spill": zero,
                        "vox_spill": zero}


@register_model("uresnet_dense")
def build_dense(cfg: URESNetConfig,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> UResNetDense:
    """The dense U-ResNet on `device` (initialized on the CPU from
    `generator`, then moved)."""
    device = resolve_device(device)
    return UResNetDense(cfg, generator=generator).to(device)
