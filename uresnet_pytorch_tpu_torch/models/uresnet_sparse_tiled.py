"""Submanifold-sparse U-ResNet on the tiled-dense engine, inference path.

Port of the eval forward of `uresnet_pytorch_tpu/models/
uresnet_sparse_tiled.py` (with `BNAct` and `_conv_init` from
`models/uresnet_sparse.py`). Module and parameter names follow the
reference's flax tree (`enc0_block0.conv_a.w`, `down0_w`, `head_w`, ...)
so `utils/weights.load_jax_variables` maps one onto the other by name.

Eval structure, as in the reference: every submanifold conv runs with its
epilogue fused (the stem and each block's conv_b with the occupancy mask,
conv_a with the following BN folded in), and the decoder concatenates the
skip before its first block.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import register_model
from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
from uresnet_pytorch_tpu_torch.ops.tile_conv import (
    downsample_conv_tiled, submanifold_conv_bn_act_tiled, upsample_conv_tiled)
from uresnet_pytorch_tpu_torch.ops.tile_graph import (
    build_tile_graph, graph_overflows, graph_spills, tile_size_at)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _conv_init(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """He-style normal over fan_in = K * Cin (the reference's _conv_init)."""
    K, cin, _ = shape
    return torch.randn(shape, generator=generator) * (2.0 / (K * cin)) ** 0.5


def _lecun_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal on [-2, 2], variance 1/fan_in."""
    std = (1.0 / shape[-2]) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class BNAct(nn.Module):
    """Masked BN then LeakyReLU (ReLU at slope 0), in the compute dtype."""

    def __init__(self, cfg: URESNetConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.MaskedBatchNorm_0 = MaskedBatchNorm(channels,
                                                 epsilon=cfg.bn_eps)

    def affine(self):
        """The folded eval affine for a fused conv epilogue."""
        return self.MaskedBatchNorm_0.affine(_DTYPES[self.cfg.compute_dtype])

    def forward(self, x):
        y = self.MaskedBatchNorm_0(x)
        s = self.cfg.leaky_relu_slope
        y = nn.functional.leaky_relu(y, s) if s > 0 else torch.relu(y)
        return y.to(_DTYPES[self.cfg.compute_dtype])


def _bn_flat(bnact: BNAct, y, mask):
    """BNAct, then re-zero inactive cells (the BN bias would leak nonzeros
    into the dense tile interior)."""
    out = bnact(y)
    return out * mask[..., None].to(out.dtype)


class SMConvTile(nn.Module):
    """Submanifold conv with its fused epilogue (a, b, alpha, mask)."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        self.w = nn.Parameter(torch.empty(3 ** cfg.data_dim, cin, features))

    def forward(self, x, level, t, epilogue):
        a, b, alpha, mask = epilogue
        dt = _DTYPES[self.cfg.compute_dtype]
        return submanifold_conv_bn_act_tiled(
            x.to(dt), level.occ, level.halo, t, self.cfg.data_dim, self.w,
            a, b, alpha, mask)


def _mask_epilogue(features: int, mask, device):
    """Identity affine: the epilogue only re-applies the occupancy mask."""
    return (torch.ones(features, device=device),
            torch.zeros(features, device=device), 1.0, mask)


class SparseResBlockTile(nn.Module):
    """Pre-activation residual block; per-row linear shortcut when the
    channel count changes."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        self.features = features
        if cin != features:
            self.w_shortcut = nn.Parameter(torch.empty(1, cin, features))
        self.bn_a = BNAct(cfg, cin)
        self.conv_a = SMConvTile(cfg, cin, features)
        self.bn_b = BNAct(cfg, features)
        self.conv_b = SMConvTile(cfg, features, features)

    def forward(self, x, level, mask, t):
        dt = _DTYPES[self.cfg.compute_dtype]
        shortcut = x
        if hasattr(self, "w_shortcut"):
            wc = self.w_shortcut[0].to(dt)
            shortcut = torch.matmul(x.to(dt).float(), wc.float()).to(dt)
        y = _bn_flat(self.bn_a, x, mask)
        # bn_b follows conv_a with nothing between: its folded affine,
        # activation and re-mask run in conv_a's epilogue
        a, b = self.bn_b.affine()
        y = self.conv_a(y, level, t, (a, b, self.cfg.leaky_relu_slope, mask))
        y = self.conv_b(y, level, t,
                        _mask_epilogue(self.features, mask, y.device))
        return shortcut + y


class UResNetSparseTiled(nn.Module):
    """forward(coords (B,V,dim) int32, values (B,V) f32, n_voxels (B,)
    int32) -> (logits (B, V, num_class) f32 in blob row order, diag), where
    diag holds the graph's `overflow`, `tile_spill` and `vox_spill` counts."""

    def __init__(self, cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dim, planes = cfg.data_dim, cfg.n_planes
        nlev = cfg.uresnet_num_strides
        self.stem = SMConvTile(cfg, 1, planes[0])
        for l in range(nlev):
            for r in range(cfg.reps):
                self.add_module(f"enc{l}_block{r}", SparseResBlockTile(
                    cfg, planes[l], planes[l]))
            if l < nlev - 1:
                self.add_module(f"down{l}_bnact", BNAct(cfg, planes[l]))
                self.register_parameter(f"down{l}_w", nn.Parameter(
                    torch.empty(2 ** dim, planes[l], planes[l + 1])))
        for l in reversed(range(nlev - 1)):
            self.add_module(f"up{l}_bnact", BNAct(cfg, planes[l + 1]))
            self.register_parameter(f"up{l}_w", nn.Parameter(
                torch.empty(2 ** dim, planes[l + 1], planes[l])))
            for r in range(cfg.reps):
                cin = 2 * planes[l] if r == 0 else planes[l]
                self.add_module(f"dec{l}_block{r}", SparseResBlockTile(
                    cfg, cin, planes[l]))
        self.head_bnact = BNAct(cfg, planes[0])
        self.head_w = nn.Parameter(torch.empty(planes[0], cfg.num_class))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_class))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initializers: _conv_init for conv stacks,
        lecun_normal for the head, zeros for biases, ones for BN scales."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf in ("bias", "head_b"):
                p.zero_()
            elif leaf == "head_w":
                p.copy_(_lecun_normal(tuple(p.shape), generator))
            else:
                p.copy_(_conv_init(tuple(p.shape), generator))

    @torch.no_grad()
    def forward(self, coords, values, n_voxels):
        cfg = self.cfg
        dim = cfg.data_dim
        dt = _DTYPES[cfg.compute_dtype]
        graph = build_tile_graph(coords, values, n_voxels, cfg)
        diag = {"overflow": graph_overflows(graph),
                "tile_spill": graph_spills(graph),
                "vox_spill": graph.vox_spill.sum()}
        levels, links = graph.levels, graph.links
        nlev = len(levels)
        tsz = [tile_size_at(cfg, l) for l in range(nlev)]

        def mask_of(lev):
            rows = torch.arange(lev.keys.shape[1], device=lev.keys.device)
            return lev.occ & (rows[None] < lev.num[:, None])[..., None]

        masks = [mask_of(lev) for lev in levels]

        x = self.stem(graph.feats0.to(dt), levels[0], tsz[0],
                      _mask_epilogue(cfg.n_planes[0], masks[0],
                                     coords.device))
        skips = []
        for l in range(nlev):
            for r in range(cfg.reps):
                x = getattr(self, f"enc{l}_block{r}")(
                    x, levels[l], masks[l], tsz[l])
            if l == nlev - 1:
                break
            skips.append(x)
            y = _bn_flat(getattr(self, f"down{l}_bnact"), x, masks[l])
            y = downsample_conv_tiled(y.to(dt), links[l], tsz[l], tsz[l + 1],
                                      dim, getattr(self, f"down{l}_w"))
            x = y * levels[l + 1].occ[..., None].to(y.dtype)

        for l in reversed(range(nlev - 1)):
            y = _bn_flat(getattr(self, f"up{l}_bnact"), x, masks[l + 1])
            y = upsample_conv_tiled(y.to(dt), links[l], levels[l].occ,
                                    tsz[l], tsz[l + 1], dim,
                                    getattr(self, f"up{l}_w"))
            y = torch.cat([y, skips[l].to(y.dtype)], dim=-1)
            for r in range(cfg.reps):
                y = getattr(self, f"dec{l}_block{r}")(
                    y, levels[l], masks[l], tsz[l])
            x = y

        y = _bn_flat(self.head_bnact, x, masks[0])
        logits_tiles = torch.matmul(y.float(), self.head_w) + self.head_b

        # back to blob row order; voxels of spilled tiles (vox_tile == T0)
        # index past the end and read the appended zero row
        B, T0, cells0, nc = logits_tiles.shape
        flat = torch.cat([logits_tiles.reshape(B, T0 * cells0, nc),
                          logits_tiles.new_zeros(B, 1, nc)], 1)
        vox = torch.where(graph.input_valid,
                          graph.vox_tile.long() * cells0 + graph.vox_cell,
                          0).clamp(max=T0 * cells0)
        logits = torch.gather(flat, 1, vox[..., None].expand(-1, -1, nc))
        return torch.where(graph.input_valid[..., None], logits, 0.0), diag


@register_model("uresnet_sparse")
def build_sparse(cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None):
    """The tile engine. The reference's row-gather engine is not ported."""
    if cfg.sparse_engine != "tile":
        raise NotImplementedError(
            f"sparse_engine={cfg.sparse_engine!r}: only the tile engine is "
            "ported")
    return UResNetSparseTiled(cfg, generator=generator)
