"""SparseConvNet's layer vocabulary as torch modules over the port's engine
ops.

Port of `uresnet_pytorch_tpu/scn.py`: the SCN layers (InputLayer,
SubmanifoldConvolution, Convolution, Deconvolution, NetworkInNetwork,
MaxPooling, AveragePooling, UnPooling, BatchNormLeakyReLU, OutputLayer, the
tables and the tail of the surface), so that SCN model code maps onto the
port directly (the table in README.md). The convolutions are the row-gather
engine's (`ops/sparse_conv.py`: one gather and one f32 GEMM, rounded once),
the rules are `ops/sparse_graph.py`'s, the pools `ops/pooling.py`'s; no
layer launches a kernel of the tile engine.

Differences from SCN, as in the reference:

- :class:`SparseTensor` is an explicit NamedTuple, not SCN's opaque
  metadata handle. The layers that make a coarser level (Convolution,
  MaxPooling, AveragePooling) also return the :class:`LevelLink` that the
  way back (Deconvolution, UnPooling) takes.
- ``add_table`` / ``join_table`` are functions; a Sequential is ordinary
  module code.
- Rules are recomputed per call. The production models build a whole
  graph's rules once per batch (models/uresnet_sparse*.py).

Difference from the reference: a torch module is built before it sees its
input, so the layers take SCN's own signatures with ``nIn``
(``SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias)``),
where the flax layers infer it. Parameter names are the reference's (``w``,
``b``, ``MaskedBatchNorm_0.scale``, ...), so a flax tree of these layers
loads with `utils/weights.load_flax_compact`. Train-mode BN records its
batch moments; `models.norm.commit_batch_moments` applies them once after
the step.

Every layer is batched: features (B, V, C) over sentinel-padded sorted key
arrays (B, V).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn

from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
from uresnet_pytorch_tpu_torch.ops.coords import SENTINEL, decode, encode
from uresnet_pytorch_tpu_torch.ops.pooling import avg_pool, max_pool, unpool
from uresnet_pytorch_tpu_torch.ops.sparse_conv import (
    downsample_conv, submanifold_conv, sum_dtype, upsample_conv)
from uresnet_pytorch_tpu_torch.ops.sparse_graph import (
    build_input_level, downsample_link, gather_rows, submanifold_rules)


class SparseTensor(NamedTuple):
    """scn.SparseConvNetTensor equivalent (explicit, batched)."""
    features: torch.Tensor  # (B, V, C)
    keys: torch.Tensor      # (B, V) sorted int32, SENTINEL-padded
    num: torch.Tensor       # (B,) active count
    spatial_size: int


class LevelLink(NamedTuple):
    """Fine <-> coarse correspondence made by a strided layer; Deconvolution
    and UnPooling take it to restore the fine level exactly."""
    parent: torch.Tensor    # (B, Vf) coarse row per fine site
    corner: torch.Tensor    # (B, Vf) corner id in [0, 2^d)
    keys_f: torch.Tensor    # (B, Vf) the fine level's keys
    num_f: torch.Tensor     # (B,)
    cap_c: int


def _rows_below(num: torch.Tensor, V: int) -> torch.Tensor:
    return torch.arange(V, device=num.device)[None] < num[:, None]


def _mask(st: SparseTensor) -> torch.Tensor:
    return _rows_below(st.num, st.keys.shape[1])


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _weight(K: int, nIn: int, nOut: int) -> nn.Parameter:
    """The reference's init: normal with std sqrt(2 / (K * nIn))."""
    return nn.Parameter(torch.randn(K, nIn, nOut) * (2.0 / (K * nIn)) ** 0.5)


class _Biased(nn.Module):
    """A layer with an optional per-channel bias `b`, added on the active
    rows only."""

    def __init__(self, nOut: int, bias: bool):
        super().__init__()
        if bias:
            self.b = nn.Parameter(torch.zeros(nOut))

    def _bias(self, out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _masked(out + self.b, mask) if hasattr(self, "b") else out


# ---------------------------------------------------------------------------
# IO layers
# ---------------------------------------------------------------------------

class InputLayer(nn.Module):
    """scn.InputLayer(dimension, spatial_size, mode): dedupe and merge
    (coords, values) into a level-0 sparse tensor; mode 'sum', 'mean',
    'max' or 'last' (SCN's duplicate merges). Returns (SparseTensor,
    row_of_input); OutputLayer takes row_of_input back to input order."""

    def __init__(self, dimension: int, spatial_size: int, mode: str = "sum"):
        super().__init__()
        self.dimension, self.spatial_size, self.mode = (dimension,
                                                        spatial_size, mode)

    def forward(self, coords, values, n_voxels
                ) -> Tuple[SparseTensor, torch.Tensor]:
        keys, num, feats, row_of_input, _ = build_input_level(
            coords, values, n_voxels, self.spatial_size, coords.shape[1],
            self.mode)
        return (SparseTensor(feats[..., None], keys, num, self.spatial_size),
                row_of_input)


class OutputLayer(nn.Module):
    """scn.OutputLayer(dimension): back to input row order, (B, Vin, C)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, st: SparseTensor, row_of_input) -> torch.Tensor:
        return gather_rows(st.features, row_of_input)


class BLInputLayer(InputLayer):
    """scn.BLInputLayer(dimension, spatial_size, mode): InputLayer with
    multi-channel features ((B, V, dim) coords, (B, V, C) features);
    duplicate coordinates merge per channel."""

    def forward(self, coords, features, n_voxels
                ) -> Tuple[SparseTensor, torch.Tensor]:
        outs = [build_input_level(coords, features[..., c], n_voxels,
                                  self.spatial_size, coords.shape[1],
                                  self.mode)
                for c in range(features.shape[-1])]
        keys, num, _, row_of_input, _ = outs[0]
        feats = torch.stack([o[2] for o in outs], dim=-1)
        return SparseTensor(feats, keys, num, self.spatial_size), row_of_input


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

class SubmanifoldConvolution(_Biased):
    """scn.SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias):
    the active set is kept (arXiv:1711.10275 section 3)."""

    def __init__(self, dimension: int, nIn: int, nOut: int,
                 filter_size: int = 3, bias: bool = False):
        super().__init__(nOut, bias)
        self.dimension, self.filter_size = dimension, filter_size
        self.w = _weight(filter_size ** dimension, nIn, nOut)

    def forward(self, st: SparseTensor) -> SparseTensor:
        nbr_idx, nbr_ok = submanifold_rules(st.keys, st.spatial_size,
                                            self.dimension, self.filter_size)
        out = submanifold_conv(st.features, nbr_idx, nbr_ok, self.w)
        return st._replace(features=self._bias(out, _mask(st)))


class Convolution(_Biased):
    """scn.Convolution(dimension, nIn, nOut, 2, 2, bias): stride 2, makes
    the coarser level. Returns (coarse SparseTensor, LevelLink)."""

    def __init__(self, dimension: int, nIn: int, nOut: int,
                 bias: bool = False):
        super().__init__(nOut, bias)
        self.dimension = dimension
        self.w = _weight(2 ** dimension, nIn, nOut)

    def forward(self, st: SparseTensor) -> Tuple[SparseTensor, LevelLink]:
        cap_c = st.keys.shape[1]
        keys_c, num_c, parent, corner, _ = downsample_link(
            st.keys, st.spatial_size, self.dimension, cap_c)
        out = downsample_conv(st.features, parent, corner, st.num, cap_c,
                              self.w)
        out = self._bias(out, _rows_below(num_c, cap_c))
        link = LevelLink(parent, corner, st.keys, st.num, cap_c)
        return SparseTensor(out, keys_c, num_c, st.spatial_size // 2), link


class Deconvolution(_Biased):
    """scn.Deconvolution(dimension, nIn, nOut, 2, 2, bias): back to the
    link's fine sites exactly, so skip tables stay aligned."""

    def __init__(self, dimension: int, nIn: int, nOut: int,
                 bias: bool = False):
        super().__init__(nOut, bias)
        self.dimension = dimension
        self.w = _weight(2 ** dimension, nIn, nOut)

    def forward(self, st: SparseTensor, link: LevelLink) -> SparseTensor:
        out = upsample_conv(st.features, link.parent, link.corner,
                            link.cap_c, self.w)
        fine = SparseTensor(out, link.keys_f, link.num_f,
                            st.spatial_size * 2)
        return fine._replace(features=self._bias(out, _mask(fine)))


class NetworkInNetwork(_Biased):
    """scn.NetworkInNetwork(nIn, nOut, bias): a per-site linear map (a 1x1
    conv), summed in f32 (f64 for f64)."""

    def __init__(self, nIn: int, nOut: int, bias: bool = False):
        super().__init__(nOut, bias)
        self.w = _weight(1, nIn, nOut)

    def forward(self, st: SparseTensor) -> SparseTensor:
        x = st.features
        acc = sum_dtype(x.dtype)
        out = (x.to(acc) @ self.w[0].to(acc)).to(x.dtype)
        return st._replace(features=self._bias(out, _mask(st)))


class FullConvolution(_Biased):
    """scn.FullConvolution(dimension, nIn, nOut, 2, 2, bias): a stride-2
    transposed conv that makes every child of each active coarse site
    active (Deconvolution instead restores a recorded fine set). The output
    holds 2^dimension x the input's rows, its keys the sorted child
    keys."""

    def __init__(self, dimension: int, nIn: int, nOut: int,
                 bias: bool = False):
        super().__init__(nOut, bias)
        self.dimension = dimension
        self.w = _weight(2 ** dimension, nIn, nOut)

    def forward(self, st: SparseTensor) -> SparseTensor:
        dim, Kd = self.dimension, 2 ** self.dimension
        acc = sum_dtype(st.features.dtype)
        S_f = st.spatial_size * 2
        coords = decode(st.keys, st.spatial_size, dim)
        valid = st.keys != SENTINEL
        child_keys, child_feats = [], []
        for o in range(Kd):
            bits = torch.tensor([(o >> (dim - 1 - d)) & 1 for d in range(dim)],
                                dtype=coords.dtype, device=coords.device)
            child_keys.append(encode(coords * 2 + bits, valid, S_f))
            child_feats.append(st.features.to(acc) @ self.w[o].to(acc))
        keys_f, order = torch.sort(torch.cat(child_keys, 1), dim=1,
                                   stable=True)
        feats = torch.cat(child_feats, 1)
        feats = torch.gather(feats, 1, order[..., None].expand(
            -1, -1, feats.shape[-1])).to(st.features.dtype)
        num_f = st.num * Kd
        mask = _rows_below(num_f, keys_f.shape[1])
        feats = self._bias(_masked(feats, mask), mask)
        return SparseTensor(feats, keys_f, num_f, S_f)


class SparseToDense(nn.Module):
    """scn.SparseToDense(dimension, nPlanes): the dense (B, *spatial, C)
    volume, channels last as in the reference (SCN's is channels first)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, st: SparseTensor) -> torch.Tensor:
        dim, S = self.dimension, st.spatial_size
        B, V, C = st.features.shape
        coords = decode(st.keys, S, dim).long()
        valid = (st.keys != SENTINEL) & _mask(st)
        lin = torch.zeros((B, V), dtype=torch.long, device=coords.device)
        for d in range(dim):
            lin = lin * S + coords[..., d]
        lin = torch.where(valid, lin, S ** dim)
        flat = st.features.new_zeros((B, S ** dim + 1, C))
        flat = flat.scatter_add(1, lin[..., None].expand(B, V, C),
                                _masked(st.features, valid))
        return flat[:, :-1].reshape((B,) + (S,) * dim + (C,))


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

class _Pooling(nn.Module):
    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def _down(self, st: SparseTensor, pool) -> Tuple[SparseTensor, LevelLink]:
        cap_c = st.keys.shape[1]
        keys_c, num_c, parent, corner, _ = downsample_link(
            st.keys, st.spatial_size, self.dimension, cap_c)
        out = pool(st.features, parent, st.num, cap_c)
        link = LevelLink(parent, corner, st.keys, st.num, cap_c)
        return SparseTensor(out, keys_c, num_c, st.spatial_size // 2), link


class MaxPooling(_Pooling):
    """scn.MaxPooling(dimension, 2, 2). Returns (coarse, LevelLink)."""

    def forward(self, st: SparseTensor) -> Tuple[SparseTensor, LevelLink]:
        return self._down(st, max_pool)


class AveragePooling(_Pooling):
    """scn.AveragePooling(dimension, 2, 2): count_mode 'volume' divides by
    2^dim (SCN), 'active' by the active children. Returns (coarse,
    LevelLink)."""

    def __init__(self, dimension: int, count_mode: str = "volume"):
        super().__init__(dimension)
        self.count_mode = count_mode

    def forward(self, st: SparseTensor) -> Tuple[SparseTensor, LevelLink]:
        return self._down(st, lambda f, p, n, c: avg_pool(
            f, p, n, c, self.dimension, self.count_mode))


class UnPooling(_Pooling):
    """scn.UnPooling(dimension, 2, 2): each coarse value to the link's fine
    sites."""

    def forward(self, st: SparseTensor, link: LevelLink) -> SparseTensor:
        out = unpool(st.features, link.parent, link.cap_c)
        return SparseTensor(out, link.keys_f, link.num_f,
                            st.spatial_size * 2)


# ---------------------------------------------------------------------------
# normalization, activation, tables
# ---------------------------------------------------------------------------

class BatchNormLeakyReLU(nn.Module):
    """scn.BatchNormLeakyReLU(nIn, leakiness) (leakiness 0 is
    scn.BatchNormReLU): masked BN over the active sites, the activation,
    inactive rows 0."""

    def __init__(self, nIn: int, leakiness: float = 0.0,
                 momentum: float = 0.9, epsilon: float = 1e-4):
        super().__init__()
        self.leakiness = leakiness
        self.MaskedBatchNorm_0 = MaskedBatchNorm(nIn, epsilon=epsilon,
                                                 momentum=momentum)

    def forward(self, st: SparseTensor, train: bool = False) -> SparseTensor:
        mask = _mask(st)
        y = self.MaskedBatchNorm_0(st.features, mask, train)
        s = self.leakiness
        # flax's where(y >= 0, y, s*y): its gradient at 0 is 1
        y = torch.where(y >= 0, y, s * y) if s > 0 else torch.relu(y)
        return st._replace(features=_masked(y, mask))


def BatchNormReLU(nIn: int, momentum: float = 0.9, epsilon: float = 1e-4):
    """scn.BatchNormReLU(nIn)."""
    return BatchNormLeakyReLU(nIn, 0.0, momentum, epsilon)


def add_table(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """scn.AddTable: a residual add over one coordinate set."""
    return a._replace(features=a.features + b.features)


def join_table(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """scn.JoinTable: a channel concat over one coordinate set."""
    return a._replace(features=torch.cat([a.features, b.features], -1))


class FullyConvolutionalNet(nn.Module):
    """scn.FullyConvolutionalNet(dimension, reps, nPlanes, residual_blocks)
    with nIn: a U-shaped encoder whose every level is UnPooled back to full
    resolution and channel-joined (SCN's hypercolumn FCN); the output has
    sum(nPlanes) channels. Sublayers are made in the reference's order,
    so its flax tree loads by name."""

    def __init__(self, dimension: int, nIn: int, reps: int,
                 nPlanes: Sequence[int], residual_blocks: bool = False,
                 leakiness: float = 0.0):
        super().__init__()
        self.dimension, self.reps, self.nPlanes = dimension, reps, nPlanes
        self.residual_blocks = residual_blocks
        counts: dict = {}

        def add(layer):
            name = type(layer).__name__
            setattr(self, f"{name}_{counts.get(name, 0)}", layer)
            counts[name] = counts.get(name, 0) + 1
            return layer

        self.plan = []      # per level: a list of (residual, layers)
        c = nIn
        for li, planes in enumerate(nPlanes):
            blocks = []
            for _ in range(reps):
                if residual_blocks and c == planes:
                    blocks.append((True, [
                        add(BatchNormLeakyReLU(c, leakiness)),
                        add(SubmanifoldConvolution(dimension, c, planes)),
                        add(BatchNormLeakyReLU(planes, leakiness)),
                        add(SubmanifoldConvolution(dimension, planes,
                                                   planes))]))
                else:
                    blocks.append((False, [
                        add(SubmanifoldConvolution(dimension, c, planes)),
                        add(BatchNormLeakyReLU(planes, leakiness))]))
                c = planes
            down = (add(Convolution(dimension, c, nPlanes[li + 1]))
                    if li < len(nPlanes) - 1 else None)
            self.plan.append((blocks, down))
            if down is not None:
                c = nPlanes[li + 1]
        self.unpool = UnPooling(dimension)

    def forward(self, st: SparseTensor, train: bool = False) -> SparseTensor:
        outs, links = [], []
        for blocks, down in self.plan:
            for residual, layers in blocks:
                if residual:
                    y = layers[0](st, train)
                    y = layers[1](y)
                    y = layers[2](y, train)
                    st = add_table(st, layers[3](y))
                else:
                    st = layers[1](layers[0](st), train)
            outs.append(st)
            if down is not None:
                st, link = down(st)
                links.append(link)
        up = outs[-1]
        for li in reversed(range(len(self.nPlanes) - 1)):
            up = join_table(outs[li], self.unpool(up, links[li]))
        return up
