"""Submanifold-sparse U-ResNet on the tiled-dense engine.

Port of `uresnet_pytorch_tpu/models/uresnet_sparse_tiled.py` (with `BNAct`
and `_conv_init` from `models/uresnet_sparse.py`). Module and parameter
names follow the reference's flax tree (`enc0_block0.conv_a.w`, `down0_w`,
`head_w`, ...) so `utils/weights.load_jax_variables` maps one onto the other
by name.

Eval (`train=False`), as in the reference: every submanifold conv runs with
its epilogue fused (the stem and each block's conv_b with the occupancy
mask, conv_a with the following BN folded in), and the decoder
concatenates the skip before its first block. With `URESNET_EVAL_PAIR=1`
in the environment (read at each forward, as the reference reads it at
trace time) eval hands that block the unmaterialized (upsampled, skip)
pair instead, as train does, and the block runs raw: bn_a, raw conv_a (one
conv a half), bn_b, raw conv_b. That saves the concat's
(B, T, cells, 2C) copies at a decoder level for one launch more. The
caller turns autograd off (`torch.no_grad()`).

Train (`train=True`): every BN takes batch moments over the active cells
(recorded, then applied by `norm.commit_batch_moments` after the step),
every submanifold conv is the raw conv times occupancy, and the
decoder hands its first block the unmaterialized (upsampled, skip) pair.
`cfg.remat_mode` recomputes stages in backward with
`torch.utils.checkpoint` at the reference's boundaries (each encoder
stage, each decoder stage, the head; the stem stays outside): "stage"
recomputes everything, "stage_dots" saves the conv outputs and
recomputes the rest, "stage_dots_deep" does that except at level 0, which
recomputes everything, and "none" saves everything.

Both modes take the conv path `ops.tile_conv.USE_FUSED` selects: kernel B
(`halo_conv_op` in train), or the halo extend and a VALID conv.

While a profiler records, spans (`utils/timing.py:span`) mark the graph
build, each stage, every BN, submanifold conv and stride-2 conv, and the
reorder, and the graph build counts each level's live tiles, active
cells and capacity cells.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
from uresnet_pytorch_tpu_torch.ops.tile_conv import (
    downsample_conv_tiled, submanifold_conv_bn_act_tiled,
    submanifold_conv_tiled, upsample_conv_tiled)
from uresnet_pytorch_tpu_torch.ops.tile_graph import (
    build_tile_graph, graph_overflows, graph_spills, tile_size_at)
from uresnet_pytorch_tpu_torch.utils.timing import count, span, tracing

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _conv_init(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """He-style normal over fan_in = K * Cin (the reference's _conv_init)."""
    K, cin, _ = shape
    return torch.randn(shape, generator=generator) * (2.0 / (K * cin)) ** 0.5


def _lecun_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: truncated normal on [-2, 2], variance 1/fan_in,
    fan_in = prod(shape[:-1]) (a (*k, I, O) kernel or an (I, O) matrix)."""
    std = (1.0 / math.prod(shape[:-1])) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class BNAct(nn.Module):
    """Masked BN then LeakyReLU (ReLU at slope 0), in the compute dtype;
    pair-aware, as MaskedBatchNorm."""

    def __init__(self, cfg: URESNetConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.MaskedBatchNorm_0 = MaskedBatchNorm(
            channels, epsilon=cfg.bn_eps, momentum=cfg.bn_momentum)

    def affine(self):
        """The folded eval affine for a fused conv epilogue."""
        return self.MaskedBatchNorm_0.affine(_DTYPES[self.cfg.compute_dtype])

    def forward(self, x, mask=None, train: bool = False):
        y = self.MaskedBatchNorm_0(x, mask, train)
        s = self.cfg.leaky_relu_slope
        dt = _DTYPES[self.cfg.compute_dtype]

        def act(v):
            # the reference's where(v >= 0, v, s*v): its gradient at 0 is 1
            v = torch.where(v >= 0, v, s * v) if s > 0 else torch.relu(v)
            return v.to(dt)
        return tuple(act(p) for p in y) if isinstance(y, tuple) else act(y)


def _bn_flat(bnact: BNAct, y, mask, train: bool = False):
    """BNAct, then re-zero inactive cells (the BN bias would leak nonzeros
    into the dense tile interior)."""
    with span("norm"):
        out = bnact(y, mask, train)
        if isinstance(out, tuple):
            occ = mask[..., None].to(out[0].dtype)
            return tuple(p * occ for p in out)
        return out * mask[..., None].to(out.dtype)


class SMConvTile(nn.Module):
    """Submanifold conv: raw with a gradient (train), or with its fused
    epilogue (a, b, alpha, mask) (eval)."""

    def __init__(self, cfg: URESNetConfig, cin: int, features: int):
        super().__init__()
        self.cfg = cfg
        self.w = nn.Parameter(torch.empty(3 ** cfg.data_dim, cin, features))

    def forward(self, x, level, t, epilogue=None):
        dt = _DTYPES[self.cfg.compute_dtype]
        dim = self.cfg.data_dim
        with span("conv"):
            if epilogue is None:
                x = tuple(p.to(dt) for p in x) if isinstance(x, tuple) \
                    else x.to(dt)
                return submanifold_conv_tiled(x, level.occ, level.halo, t,
                                              dim, self.w)
            a, b, alpha, mask = epilogue
            return submanifold_conv_bn_act_tiled(
                x.to(dt), level.occ, level.halo, t, dim, self.w, a, b, alpha,
                mask)


def _mask_epilogue(features: int, mask, device):
    """Identity affine: the epilogue only re-applies the occupancy mask."""
    return (torch.ones(features, device=device),
            torch.zeros(features, device=device), 1.0, mask)


class SparseResBlockTile(nn.Module):
    """Pre-activation residual block; per-row linear shortcut when the
    channel count changes. x may be the decoder's (up, skip) pair (always
    in train, in eval under URESNET_EVAL_PAIR=1), which the shortcut, bn_a
    and conv_a each take channel-separably; a pair runs the raw convs in
    eval too."""

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

    def forward(self, x, level, mask, t, train: bool = False):
        dt = _DTYPES[self.cfg.compute_dtype]
        shortcut = x
        if hasattr(self, "w_shortcut"):
            wc = self.w_shortcut[0].to(dt).float()

            def nin(p, ws):
                return torch.matmul(p.to(dt).float(), ws)
            if isinstance(x, tuple):
                C1 = x[0].shape[-1]
                shortcut = (nin(x[0], wc[:C1]) + nin(x[1], wc[C1:])).to(dt)
            else:
                shortcut = nin(x, wc).to(dt)
        y = _bn_flat(self.bn_a, x, mask, train)
        if train or isinstance(x, tuple):
            y = self.conv_a(y, level, t)
            y = _bn_flat(self.bn_b, y, mask, train)
            y = self.conv_b(y, level, t)
        else:
            # bn_b follows conv_a with nothing between: its folded affine,
            # activation and re-mask run in conv_a's epilogue
            a, b = self.bn_b.affine()
            y = self.conv_a(y, level, t,
                            (a, b, self.cfg.leaky_relu_slope, mask))
            y = self.conv_b(y, level, t,
                            _mask_epilogue(self.features, mask, y.device))
        return shortcut + y


# stage_dots: keep the conv outputs, recompute everything else: kernel B's
# operator (registered by ops/cuda/halo_conv.py, which tile_conv imports) on
# the fused path, the VALID conv after the halo extend on the unfused one,
# whose extends are then recomputed in backward, as in the reference
_SAVE_CONV_OUTPUTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.uresnet_torch.halo_conv.default,
     torch.ops.aten.convolution.default])


def _in_span(name: str, fn, *args):
    with span(name):
        return fn(*args)


class SparseUResNetBase(nn.Module):
    """The parameter tree both sparse engines share, so that one variables
    tree loads into either: a subclass names its submanifold conv
    (`Conv(cfg, cin, features)`, a parameter `w`) and residual block
    (`Block(cfg, cin, features)`) and gives the forward."""
    Conv = SMConvTile
    Block = SparseResBlockTile

    def __init__(self, cfg: URESNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dim, planes = cfg.data_dim, cfg.n_planes
        nlev = cfg.uresnet_num_strides
        self.stem = self.Conv(cfg, 1, planes[0])
        for l in range(nlev):
            for r in range(cfg.reps):
                self.add_module(f"enc{l}_block{r}", self.Block(
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
                self.add_module(f"dec{l}_block{r}", self.Block(
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


class UResNetSparseTiled(SparseUResNetBase):
    """forward(coords (B,V,dim) int32, values (B,V) f32, n_voxels (B,)
    int32, train=False) -> (logits (B, V, num_class) f32 in blob row order,
    diag), where diag holds the graph's `overflow`, `tile_spill` and
    `vox_spill` counts."""

    def _enc_stage(self, x, l, level, mask, nxt_occ, link, t, t_next,
                   train):
        """Level l's blocks, then (below the bottom) BN and the stride-2
        conv to level l+1. Returns (skip, next level's input)."""
        cfg = self.cfg
        for r in range(cfg.reps):
            x = getattr(self, f"enc{l}_block{r}")(x, level, mask, t, train)
        if l == cfg.uresnet_num_strides - 1:
            return x, x
        y = _bn_flat(getattr(self, f"down{l}_bnact"), x, mask, train)
        with span("resample"):
            y = downsample_conv_tiled(y.to(_DTYPES[cfg.compute_dtype]), link,
                                      t, t_next, cfg.data_dim,
                                      getattr(self, f"down{l}_w"))
        return x, y * nxt_occ[..., None].to(y.dtype)

    def _dec_stage(self, x, skip, l, level, mask, mask_up, link, t, t_up,
                   train):
        """BN and the transposed stride-2 conv from level l+1, then level
        l's blocks on (up, skip): a pair in train or under
        URESNET_EVAL_PAIR=1, else a concat."""
        cfg = self.cfg
        y = _bn_flat(getattr(self, f"up{l}_bnact"), x, mask_up, train)
        with span("resample"):
            y = upsample_conv_tiled(y.to(_DTYPES[cfg.compute_dtype]), link,
                                    level.occ, t, t_up, cfg.data_dim,
                                    getattr(self, f"up{l}_w"))
        skip = skip.to(y.dtype)
        if train or os.environ.get("URESNET_EVAL_PAIR") == "1":
            y = (y, skip)
        else:
            y = torch.cat([y, skip], dim=-1)
        for r in range(cfg.reps):
            y = getattr(self, f"dec{l}_block{r}")(y, level, mask, t, train)
        return y

    def _head_stage(self, x, mask, train):
        y = _bn_flat(self.head_bnact, x, mask, train)
        return torch.matmul(y.float(), self.head_w) + self.head_b

    def _stage(self, name: str, fn, train: bool, level0: bool, *args):
        """fn(*args) in the span `stage.<name>`, recomputed in backward
        (span and all) as cfg.remat_mode says (train with autograd on only;
        inference never recomputes)."""
        fn = functools.partial(_in_span, "stage." + name, fn)
        mode = self.cfg.remat_mode
        if not train or mode == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if mode == "stage" or (mode == "stage_dots_deep" and level0):
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_SAVE_CONV_OUTPUTS)

    def forward(self, coords, values, n_voxels, train: bool = False):
        cfg = self.cfg
        dt = _DTYPES[cfg.compute_dtype]
        with span("graph_build"):
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
            if tracing():
                # live against capacity, per level: the padding that every
                # dense pass over the tiles carries
                count("live_tiles", torch.stack([lev.num.sum()
                                                 for lev in levels]))
                count("active_cells", torch.stack([m.sum() for m in masks]))
                count("capacity_cells", [m.numel() for m in masks])

        # eval fuses the stem's occupancy re-mask into its kernel epilogue
        with span("stage.stem"):
            x = self.stem(graph.feats0.to(dt), levels[0], tsz[0],
                          None if train else _mask_epilogue(
                              cfg.n_planes[0], masks[0], coords.device))
        skips = []
        for l in range(nlev):
            last = l == nlev - 1
            skip, x = self._stage(
                f"enc{l}", self._enc_stage, train, l == 0, x, l, levels[l],
                masks[l], levels[l if last else l + 1].occ,
                None if last else links[l], tsz[l],
                tsz[l if last else l + 1], train)
            if not last:
                skips.append(skip)

        for l in reversed(range(nlev - 1)):
            x = self._stage(f"dec{l}", self._dec_stage, train, l == 0, x,
                            skips[l], l, levels[l], masks[l], masks[l + 1],
                            links[l], tsz[l], tsz[l + 1], train)
        logits_tiles = self._stage("head", self._head_stage, train, True, x,
                                   masks[0], train)

        # back to blob row order; voxels of spilled tiles (vox_tile == T0)
        # index past the end and read the appended zero row
        with span("reorder"):
            B, T0, cells0, nc = logits_tiles.shape
            flat = torch.cat([logits_tiles.reshape(B, T0 * cells0, nc),
                              logits_tiles.new_zeros(B, 1, nc)], 1)
            vox = torch.where(graph.input_valid,
                              graph.vox_tile.long() * cells0 + graph.vox_cell,
                              0).clamp(max=T0 * cells0)
            logits = torch.gather(flat, 1, vox[..., None].expand(-1, -1, nc))
            return (torch.where(graph.input_valid[..., None], logits, 0.0),
                    diag)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises where CUDA is asked for and absent, rather than
    dropping to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "torch versions of the kernels on the CPU")
    return device
