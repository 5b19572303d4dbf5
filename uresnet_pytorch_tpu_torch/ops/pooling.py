"""Sparse stride-2 pooling (SCN MaxPooling / AveragePooling / UnPooling).

Port of `uresnet_pytorch_tpu/ops/pooling.py`. The output sites are the
coarse cells that cover at least one active input site (the stride-2 link
of `ops/sparse_graph.downsample_link`); each pools over its active
children, by one scatter over the fine -> coarse parent map. Rows at or
past `num_f`, and rows whose parent is `cap_c` (dropped), go nowhere.

The average divides by the full pool volume 2^dim (`count_mode="volume"`,
SCN's convention) or by the number of active children (`"active"`).

Gradients are the reference's: at children tied for a cell's maximum the
gradient is split evenly among them, which is what JAX's scatter-max VJP
and torch's `scatter_reduce("amax")` backward both do.
"""

from __future__ import annotations

import torch

from uresnet_pytorch_tpu_torch.ops.sparse_conv import sum_dtype


def _targets(parent: torch.Tensor, num_f: torch.Tensor,
             cap_c: int) -> torch.Tensor:
    """(B, Vf) int64 coarse row per fine row, cap_c where it goes
    nowhere (past num_f, or dropped)."""
    rows = torch.arange(parent.shape[1], device=parent.device)
    valid = rows[None] < num_f[:, None]
    return torch.where(valid, parent.long(), cap_c)


def max_pool(feats_f: torch.Tensor, parent: torch.Tensor,
             num_f: torch.Tensor, cap_c: int) -> torch.Tensor:
    """feats_f (B, Vf, C), parent (B, Vf) coarse row (== cap_c if dropped)
    -> (B, cap_c, C): max over each coarse cell's active children, in f32
    (f64 for f64);
    0 where no child reached a cell (or the max is not finite)."""
    B, Vf, C = feats_f.shape
    tgt = _targets(parent, num_f, cap_c)
    acc = sum_dtype(feats_f.dtype)
    out = feats_f.new_full((B, cap_c + 1, C), -float("inf"), dtype=acc)
    out = out.scatter_reduce(1, tgt[..., None].expand(B, Vf, C),
                             feats_f.to(acc), "amax", include_self=False)
    out = out[:, :cap_c]
    return torch.where(torch.isfinite(out), out, 0.0).to(feats_f.dtype)


def avg_pool(feats_f: torch.Tensor, parent: torch.Tensor,
             num_f: torch.Tensor, cap_c: int, data_dim: int,
             count_mode: str = "volume") -> torch.Tensor:
    """Average over each coarse cell's children, summed in f32 (f64 for
    f64):
    count_mode="volume" divides by 2^dim (SCN), "active" by the
    active-child count."""
    if count_mode not in ("volume", "active"):
        raise ValueError(count_mode)
    B, Vf, C = feats_f.shape
    tgt = _targets(parent, num_f, cap_c)
    acc = sum_dtype(feats_f.dtype)
    ssum = feats_f.new_zeros((B, cap_c + 1, C), dtype=acc)
    ssum = ssum.scatter_add(1, tgt[..., None].expand(B, Vf, C),
                            feats_f.to(acc))[:, :cap_c]
    if count_mode == "volume":
        out = ssum / float(2 ** data_dim)
    else:
        cnt = torch.zeros((B, cap_c + 1), dtype=torch.float32,
                          device=feats_f.device)
        cnt = cnt.scatter_add(1, tgt, torch.ones(tgt.shape,
                                                 device=feats_f.device))
        out = ssum / cnt[:, :cap_c].clamp(min=1.0)[..., None]
    return out.to(feats_f.dtype)


def unpool(feats_c: torch.Tensor, parent: torch.Tensor,
           cap_c: int) -> torch.Tensor:
    """UnPooling (SCN unPooling.py): each coarse value back to its active
    fine children, 0 where the parent is cap_c (the pooling link
    transposed)."""
    B, Vf = parent.shape
    ok = parent < cap_c
    idx = torch.where(ok, parent, 0).long()
    g = torch.gather(feats_c, 1, idx[..., None].expand(B, Vf,
                                                        feats_c.shape[-1]))
    return torch.where(ok[..., None], g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
