"""Submanifold-sparse U-ResNet on the row-gather engine, and the engine
dispatch.

Port of `uresnet_pytorch_tpu/models/uresnet_sparse.py`: the coordinate
graph (sorted keys, binary-search rulebooks, `ops/sparse_graph.py`) is
built per batch, and every convolution is a gather-GEMM over it
(`ops/sparse_conv.py`) on static (B, V_l, C) buffers. It computes the same
model as the tile engine by an independent algorithm, and is the
reference's oracle for it. The parameter tree is the tile engine's
(`SparseUResNetBase`), so one variables tree loads into either engine.

As in the reference, BN takes its moments over the active rows, training
recomputes each residual block in backward (`torch.utils.checkpoint`),
and the logits come back in blob row order with padding rows 0. No
kernel of the port runs here: the gathers are torch indexing and the
GEMMs `torch.matmul`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import register_model
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    _DTYPES, BNAct, SparseUResNetBase, UResNetSparseTiled, resolve_device)
from uresnet_pytorch_tpu_torch.ops.sparse_conv import (
    downsample_conv, submanifold_conv, upsample_conv)
from uresnet_pytorch_tpu_torch.ops.sparse_graph import (build_graph,
                                                        gather_rows)


class SMConv(nn.Module):
    """Submanifold convolution: the 3^d gather-GEMM, no bias."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        self.w = nn.Parameter(torch.empty(3 ** cfg.data_dim, cin, features))

    def forward(self, x, level):
        return submanifold_conv(x.to(_DTYPES[self.cfg.compute_dtype]),
                                level.nbr_idx, level.nbr_ok, self.w)


class SparseResBlock(nn.Module):
    """Pre-activation residual block; a per-row linear shortcut when the
    width changes."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        if cin != features:
            self.w_shortcut = nn.Parameter(torch.empty(1, cin, features))
        self.bn_a = BNAct(cfg, cin)
        self.conv_a = SMConv(cfg, cin, features)
        self.bn_b = BNAct(cfg, features)
        self.conv_b = SMConv(cfg, features, features)

    def forward(self, x, level, mask, train: bool = False):
        dt = _DTYPES[self.cfg.compute_dtype]
        shortcut = x
        if hasattr(self, "w_shortcut"):
            # bf16 products are exact in f32: the reference's einsum with
            # f32 accumulation, rounded once
            shortcut = torch.matmul(x.to(dt).float(),
                                    self.w_shortcut[0].to(dt).float()).to(dt)
        y = self.conv_a(self.bn_a(x, mask, train), level)
        y = self.conv_b(self.bn_b(y, mask, train), level)
        return shortcut + y


class UResNetSparse(SparseUResNetBase):
    """forward(coords (B,V,dim) int32, values (B,V) f32, n_voxels (B,)
    int32, train=False) -> (logits (B, V, num_class) f32 in blob row order,
    diag): diag holds zero `overflow`, `tile_spill` and `vox_spill`
    counters, as the reference's TrainVal gives this engine."""
    Conv = SMConv
    Block = SparseResBlock

    def _block(self, name: str, x, level, mask, train: bool):
        block = getattr(self, name)
        if train and torch.is_grad_enabled():
            return checkpoint(block, x, level, mask, train,
                              use_reentrant=False)
        return block(x, level, mask, train)

    def forward(self, coords, values, n_voxels, train: bool = False):
        cfg = self.cfg
        dt = _DTYPES[cfg.compute_dtype]
        graph, _ = build_graph(coords, values, n_voxels, cfg)
        levels, links = graph.levels, graph.links
        nlev = len(levels)

        def mask_of(lev):
            rows = torch.arange(lev.keys.shape[1], device=lev.keys.device)
            return rows[None] < lev.num[:, None]

        masks = [mask_of(lev) for lev in levels]
        x = self.stem(graph.feats0.to(dt), levels[0])
        skips = []
        for l in range(nlev):
            for r in range(cfg.reps):
                x = self._block(f"enc{l}_block{r}", x, levels[l], masks[l],
                                train)
            if l < nlev - 1:
                skips.append(x)
                x = getattr(self, f"down{l}_bnact")(x, masks[l], train)
                x = downsample_conv(x.to(dt), links[l].parent,
                                    links[l].offset, levels[l].num,
                                    levels[l + 1].keys.shape[1],
                                    getattr(self, f"down{l}_w"))
        for l in reversed(range(nlev - 1)):
            x = getattr(self, f"up{l}_bnact")(x, masks[l + 1], train)
            x = upsample_conv(x.to(dt), links[l].parent, links[l].offset,
                              levels[l + 1].keys.shape[1],
                              getattr(self, f"up{l}_w"))
            x = torch.cat([x, skips[l].to(x.dtype)], dim=-1)
            for r in range(cfg.reps):
                x = self._block(f"dec{l}_block{r}", x, levels[l], masks[l],
                                train)

        x = self.head_bnact(x, masks[0], train)
        logits0 = torch.matmul(x.float(), self.head_w) + self.head_b
        # SCN's OutputLayer: back to blob row order
        logits = gather_rows(logits0, graph.row_of_input)
        zero = torch.zeros((), dtype=torch.int32, device=coords.device)
        return (torch.where(graph.input_valid[..., None], logits, 0.0),
                {"overflow": zero, "tile_spill": zero, "vox_spill": zero})


@register_model("uresnet_sparse")
def build_sparse(cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> SparseUResNetBase:
    """Engine dispatch: "tile" is the tiled-dense engine on kernels A-E,
    "gather" the row-gather engine. Either is initialized on the CPU from
    `generator` (the same tree and draws), then moved to `device`."""
    device = resolve_device(device)
    cls = UResNetSparseTiled if cfg.sparse_engine == "tile" else \
        UResNetSparse
    return cls(cfg, generator=generator).to(device)
