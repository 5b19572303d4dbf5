"""MinkUNet34C on the tiled-dense engine.

The standard sparse 3D backbone of MinkowskiEngine (NVIDIA/MinkowskiEngine,
`examples/minkunet.py`, class `MinkUNet34C` on `MinkUNetBase` with
`BLOCK = BasicBlock`; Choy, Gwak and Savarese, arXiv:1904.08755), on the
same tile graph, kernels and BN operator as the sparse U-ResNet
(`models/uresnet_sparse_tiled.py`). Levels 0-4 are MinkowskiEngine's
tensor strides 1-16 (p1 ... p16):

- stem (level 0): a 5^dim submanifold conv from the input's 1 channel to
  INIT_DIM, BN, ReLU: the skip `out_p1`;
- encoder, level l = 1..4: a 2^dim conv of stride 2 (width unchanged),
  BN, ReLU, then LAYERS[l-1] BasicBlocks at PLANES[l-1]; levels 1-3 are
  the skips `out_b1p2`, `out_b2p4`, `out_b3p8`;
- decoder, level l = 3..0: a 2^dim transposed conv of stride 2 to
  PLANES[7-l], BN, ReLU, the concat (up, skip of level l), then
  LAYERS[7-l] BasicBlocks at PLANES[7-l];
- head: `final`, a 1x1 conv to the classes with a bias.

A BasicBlock is post-activation: `relu(bn2(conv2(relu(bn1(conv1(x))))) +
r)`, both convs 3^dim submanifold, `r` the input or, where the width
changes, a 1x1 conv with its own BN. Only the head has a bias. BN takes
the configuration's `bn_eps` and `bn_momentum` (MinkowskiEngine's eps
1e-5 and torch momentum 0.1 are `bn_eps=1e-5`, `bn_momentum=0.9`).

How it runs on the tile engine:
- every BN is the U-ResNet's `BNAct` (the operator `norm_act`) with the
  re-mask (`_bn_flat` for BN and ReLU); a block's second BN takes the
  residual inside the operator (`residual=r`), and a projection's BN is
  the operator at slope 1 (no activation);
- the 5^dim stem runs unfused: the halo extend at a halo of 2 (kernel D:
  two layers of the 26 neighbor tiles, since 2 <= t) and one cuDNN VALID
  conv; its weight is (5^dim, 1, INIT_DIM) and its input needs no
  gradient;
- the 3^dim convs take `ops.tile_conv`'s path as in the U-ResNet (kernel
  B, its gradient kernels B and C, or the unfused extend and conv);
- the stride-2 convs are `downsample_conv_tiled` / `upsample_conv_tiled`;
- the decoder hands its first block the (up, skip) pair, which conv1 and
  the projection take channel-separably, never concatenated in memory;
- the graph build, the stages' recompute under `cfg.remat_mode` and the
  reorder to blob rows are the U-ResNet's (`tile_graph`, `remat_stage`,
  `blob_order`; spans `stage.stem`, `stage.enc{l}`, `stage.dec{l}`,
  `stage.head`); the 1x1 projections with their BN run in the span
  `shortcut`.

Departures from `examples/minkunet.py`: weights are initialized as the
port's other models (He normal over fan-in K Cin for conv stacks,
`lecun_normal` for the head, BN scale 1 and bias 0), where MinkowskiEngine
uses Kaiming normal with fan-out; the coarse levels' sites are the
parents of the fine sites, MinkowskiEngine's stride-2 output map, held in
tiles rather than in its coordinate hash, whose row order does not change
the mathematics; eval uses the same raw convs as training.

The architecture's widths are class constants, as MinkowskiEngine defines
them; the constructor takes others for tests of a narrow copy
(`construct("minkunet34c")` passes none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models import register_model
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    _DTYPES, BNAct, SMConvTile, _bn_flat, blob_order, reference_init,
    remat_stage, resolve_device, tile_graph)
from uresnet_pytorch_tpu_torch.ops.tile_conv import (downsample_conv_tiled,
                                                     upsample_conv_tiled)
from uresnet_pytorch_tpu_torch.ops.tile_graph import tile_size_at
from uresnet_pytorch_tpu_torch.utils.timing import span

INIT_DIM = 32
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
STEM_KERNEL = 5
LEVELS = 5                      # p1 .. p16
TILE_SIZES = (4, 2, 2, 2, 2)    # the tile engine's schedule over them


class StemConvTile(SMConvTile):
    """The 5^dim submanifold stem conv (weight (5^dim, Cin, Cout)), which
    `ops.tile_conv` runs as the halo-2 extend and one VALID conv."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.w = nn.Parameter(torch.empty(STEM_KERNEL ** cfg.data_dim, cin,
                                          features))


class BasicBlockTile(nn.Module):
    """MinkowskiEngine's BasicBlock, post-activation, on tiles. x may be
    the decoder's (up, skip) pair, which conv1 and the projection take
    channel-separably."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        if cin != features:
            self.w_shortcut = nn.Parameter(torch.empty(1, cin, features))
            self.bn_shortcut = BNAct(cfg, features)
        self.conv1 = SMConvTile(cfg, cin, features)
        self.bn1 = BNAct(cfg, features)
        self.conv2 = SMConvTile(cfg, features, features)
        self.bn2 = BNAct(cfg, features)

    def shortcut(self, x, mask, train: bool):
        """BN(x W) at slope 1 (no activation), or x itself."""
        if not hasattr(self, "w_shortcut"):
            return x
        dt = _DTYPES[self.cfg.compute_dtype]
        with span("shortcut"):
            w = self.w_shortcut[0].to(dt)
            parts = x if isinstance(x, tuple) else (x,)
            lead = parts[0].shape[:-1]
            # products in the compute dtype (bf16's sum in f32 inside the
            # GEMM); a pair's second part adds onto the first's output
            s, lo = None, 0
            for p in parts:
                hi = lo + p.shape[-1]
                rows = p.to(dt).reshape(-1, hi - lo)
                s = (torch.mm(rows, w[lo:hi]) if s is None
                     else torch.addmm(s, rows, w[lo:hi]))
                lo = hi
            return self.bn_shortcut(s.reshape(*lead, -1), mask, train,
                                    remask=True, slope=1.0)

    def forward(self, x, level, mask, t, train: bool = False):
        r = self.shortcut(x, mask, train)
        y = self.conv1(x, level, t)
        y = _bn_flat(self.bn1, y, mask, train)
        y = self.conv2(y, level, t)
        return _bn_flat(self.bn2, y, mask, train, residual=r)


class MinkUNet34CTiled(nn.Module):
    """forward(coords (B,V,dim) int32, values (B,V) f32, n_voxels (B,)
    int32, train=False) -> (logits (B, V, num_class) f32 in blob row order,
    diag), as `UResNetSparseTiled`. Module and parameter names: `stem`,
    `stem_bn`, `down{l}_w` / `down{l}_bn` (level l to l+1),
    `enc{l}_block{r}`, `up{l}_w` / `up{l}_bn` (level l+1 to l),
    `dec{l}_block{r}`, `head_w`, `head_b`; a block's `conv1`, `bn1`,
    `conv2`, `bn2`, `w_shortcut`, `bn_shortcut`."""

    INIT_DIM, PLANES, LAYERS = INIT_DIM, PLANES, LAYERS

    def __init__(self, cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None,
                 planes: Optional[Sequence[int]] = None,
                 layers: Optional[Sequence[int]] = None,
                 init_dim: Optional[int] = None):
        super().__init__()
        if cfg.sparse_engine != "tile":
            raise ValueError("minkunet34c runs on the tile engine only "
                             f"(sparse_engine {cfg.sparse_engine!r})")
        if cfg.uresnet_num_strides != LEVELS:
            raise ValueError(f"minkunet34c has {LEVELS} levels (p1 to p16): "
                             f"uresnet_num_strides must be {LEVELS}, got "
                             f"{cfg.uresnet_num_strides}")
        tiles = tuple(tile_size_at(cfg, l) for l in range(LEVELS))
        if tiles != TILE_SIZES:
            raise ValueError(f"minkunet34c runs its levels on tiles of "
                             f"{TILE_SIZES}, got {tiles}")
        self.cfg = cfg
        self.planes = tuple(planes or self.PLANES)
        self.layers = tuple(layers or self.LAYERS)
        self.init_dim = init_dim or self.INIT_DIM
        P, L, dim = self.planes, self.layers, cfg.data_dim
        if len(P) != 8 or len(L) != 8:
            raise ValueError("planes and layers take 8 entries each")
        self.stem = StemConvTile(cfg, 1, self.init_dim)
        self.stem_bn = BNAct(cfg, self.init_dim)
        # the width of each level's skip (levels 0-3) and of the encoder's
        # output at each level
        width = [self.init_dim]
        for l in range(1, LEVELS):
            cin = width[l - 1]
            self.register_parameter(f"down{l - 1}_w", nn.Parameter(
                torch.empty(2 ** dim, cin, cin)))
            self.add_module(f"down{l - 1}_bn", BNAct(cfg, cin))
            for r in range(L[l - 1]):
                self.add_module(f"enc{l}_block{r}", BasicBlockTile(
                    cfg, cin if r == 0 else P[l - 1], P[l - 1]))
            width.append(P[l - 1])
        cin = width[LEVELS - 1]
        for l in reversed(range(LEVELS - 1)):
            f = P[7 - l]
            self.register_parameter(f"up{l}_w", nn.Parameter(
                torch.empty(2 ** dim, cin, f)))
            self.add_module(f"up{l}_bn", BNAct(cfg, f))
            for r in range(L[7 - l]):
                self.add_module(f"dec{l}_block{r}", BasicBlockTile(
                    cfg, f + width[l] if r == 0 else f, f))
            cin = f
        self.head_w = nn.Parameter(torch.empty(cin, cfg.num_class))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_class))
        reference_init(self, generator)

    def _blocks(self, prefix: str, n: int, x, level, mask, t, train):
        for r in range(n):
            x = getattr(self, f"{prefix}_block{r}")(x, level, mask, t, train)
        return x

    def _stem_stage(self, feats, level, mask, t, train):
        y = self.stem(feats, level, t)
        return _bn_flat(self.stem_bn, y, mask, train)

    def _enc_stage(self, x, l, link, level, mask, t_f, t, train):
        """Level l-1 to l: the stride-2 conv, BN and ReLU, then level l's
        blocks."""
        with span("resample"):
            y = downsample_conv_tiled(
                x.to(_DTYPES[self.cfg.compute_dtype]), link, t_f, t,
                self.cfg.data_dim, getattr(self, f"down{l - 1}_w"))
        y = _bn_flat(getattr(self, f"down{l - 1}_bn"), y, mask, train)
        return self._blocks(f"enc{l}", self.layers[l - 1], y, level, mask,
                            t, train)

    def _dec_stage(self, x, skip, l, link, level, mask, t, t_c, train):
        """Level l+1 to l: the transposed stride-2 conv, BN and ReLU, then
        level l's blocks on the (up, skip) pair."""
        with span("resample"):
            y = upsample_conv_tiled(
                x.to(_DTYPES[self.cfg.compute_dtype]), link, level.occ, t,
                t_c, self.cfg.data_dim, getattr(self, f"up{l}_w"))
        y = _bn_flat(getattr(self, f"up{l}_bn"), y, mask, train)
        return self._blocks(f"dec{l}", self.layers[7 - l],
                            (y, skip.to(y.dtype)), level, mask, t, train)

    def _head_stage(self, x):
        return torch.matmul(x.float(), self.head_w) + self.head_b

    def forward(self, coords, values, n_voxels, train: bool = False):
        cfg = self.cfg
        dt = _DTYPES[cfg.compute_dtype]
        graph, masks, tsz, diag = tile_graph(coords, values, n_voxels, cfg)
        levels, links = graph.levels, graph.links

        # the stem is never recomputed, as the U-ResNet's
        with span("stage.stem"):
            x = self._stem_stage(graph.feats0.to(dt), levels[0], masks[0],
                                 tsz[0], train)
        skips = [x]
        for l in range(1, LEVELS):
            x = remat_stage(cfg, f"enc{l}", self._enc_stage, train, False, x,
                            l, links[l - 1], levels[l], masks[l], tsz[l - 1],
                            tsz[l], train)
            if l < LEVELS - 1:
                skips.append(x)
        for l in reversed(range(LEVELS - 1)):
            x = remat_stage(cfg, f"dec{l}", self._dec_stage, train, l == 0,
                            x, skips[l], l, links[l], levels[l], masks[l],
                            tsz[l], tsz[l + 1], train)
        logits_tiles = remat_stage(cfg, "head", self._head_stage, train,
                                   True, x)
        return blob_order(logits_tiles, graph), diag


@register_model("minkunet34c")
def build_minkunet34c(cfg: URESNetConfig,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> MinkUNet34CTiled:
    """MinkUNet34C at its published widths, initialized on the CPU from
    `generator`, then moved to `device`."""
    device = resolve_device(device)
    return MinkUNet34CTiled(cfg, generator=generator).to(device)
