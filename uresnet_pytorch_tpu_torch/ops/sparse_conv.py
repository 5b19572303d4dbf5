"""Sparse convolution of the row-gather engine: gather, then one GEMM.

Port of `uresnet_pytorch_tpu/ops/sparse_conv.py` (submanifold, stride-2
and transposed stride-2 convolutions over `ops/sparse_graph.py`'s rules).
Each is one gather-GEMM: every output row gathers its K input rows (a
zero row where the rule has none) into a (rows, K * Cin) f32 operand,
and one f32 matmul against the (K * Cin, Cout) weight stack sums all
offsets, rounded once to the activation dtype, as the reference's
per-offset einsums with f32 accumulation do. Inputs in bfloat16 are
exact in f32 (and in TF32), so the sum is the reference's up to order.
Inputs in f64 (a witness run of a model on the CPU) sum in f64.

The backward is gathers too, never a scatter-add (whose atomics pile onto
the zero row): each map is injective per offset, so the transpose of a
gather-GEMM is the gather-GEMM over the transposed map with the
transposed weights. The submanifold map is its own transpose with the
offsets reversed (the offset table is symmetric); the stride-2 conv and
its transpose swap their two maps.
"""

from __future__ import annotations

import torch


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the engine's sums run in: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N_out, K * C) in x's sum dtype: the rows of x (N_in, C) at idx
    (N_out, K), the zero row where idx == N_in."""
    acc = sum_dtype(x.dtype)
    xz = torch.cat([x.to(acc), x.new_zeros(1, x.shape[1], dtype=acc)])
    return torch.index_select(xz, 0, idx.reshape(-1)).view(idx.shape[0], -1)


def _gather_gemm(x, idx, w):
    K, Cin, Cout = w.shape
    return _rows(x, idx) @ w.to(sum_dtype(x.dtype)).reshape(K * Cin, Cout)


class _GatherGemm(torch.autograd.Function):
    """out[r] = sum_k x[fwd[r, k]] @ w[k] (x's rows, then a zero row at
    N_in). `bwd` is the transposed map: bwd[s, k] = r where fwd[r, k] = s,
    N_out where no r has it. Then dx[s] = sum_k dout[bwd[s, k]] @ w[k]^T
    and dw[k] = sum_r x[fwd[r, k]]^T dout[r]."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, w):
        ctx.save_for_backward(x, fwd, bwd, w)
        return _gather_gemm(x, fwd, w).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, fwd, bwd, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gather_gemm(dout, bwd, w.transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[3]:
            dw = (_rows(x, fwd).t() @ dout.to(sum_dtype(x.dtype))
                  ).view(w.shape).to(w.dtype)
        return dx, None, None, dw


def neighbor_rows(nbr_idx: torch.Tensor, nbr_ok: torch.Tensor) -> torch.Tensor:
    """(B, K, V) rules -> (B * V, K) int64 rows of the batch's flattened
    (B * V) rows; B * V (the zero row) where there is no neighbor."""
    B, K, V = nbr_idx.shape
    base = torch.arange(B, device=nbr_idx.device)[:, None, None] * V
    flat = torch.where(nbr_ok, nbr_idx.long() + base, B * V)
    return flat.permute(0, 2, 1).reshape(B * V, K)


def link_rows(parent: torch.Tensor, corner: torch.Tensor, cap_c: int,
              K: int):
    """A stride-2 link as two maps over flattened batch rows: `up`
    (B * Vf, K), each fine row's coarse row in its corner's column, and
    `down` (B * cap_c, K), each coarse row's child per corner; B * cap_c
    and B * Vf (the zero rows) elsewhere. Rows with parent == cap_c
    (padding, or dropped by capacity) are in neither."""
    B, Vf = parent.shape
    dev = parent.device
    ok = parent < cap_c
    b = torch.arange(B, device=dev)[:, None]
    coarse = torch.where(ok, b * cap_c + parent, B * cap_c).reshape(-1, 1)
    corner = corner.long().reshape(-1, 1)
    up = torch.full((B * Vf, K), B * cap_c, dtype=torch.long, device=dev)
    up.scatter_(1, corner, coarse)
    # per corner the map is injective, so each slot is written once; the
    # rows without a parent all land in the discarded last row
    down = torch.full(((B * cap_c + 1) * K,), B * Vf, dtype=torch.long,
                      device=dev)
    fine = (b * Vf + torch.arange(Vf, device=dev)).reshape(-1, 1)
    down.scatter_(0, (coarse * K + corner).reshape(-1), fine.reshape(-1))
    return up, down.view(B * cap_c + 1, K)[:-1]


def submanifold_conv(feats: torch.Tensor, nbr_idx: torch.Tensor,
                     nbr_ok: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """feats (B, V, Cin), nbr_idx/nbr_ok (B, K, V), w (K, Cin, Cout) ->
    (B, V, Cout) on the same sites (the submanifold property)."""
    B, V, Cin = feats.shape
    rows = neighbor_rows(nbr_idx, nbr_ok)
    out = _GatherGemm.apply(feats.reshape(B * V, Cin), rows, rows.flip(1),
                            w.to(feats.dtype))
    return out.view(B, V, -1)


def downsample_conv(feats_f: torch.Tensor, parent: torch.Tensor,
                    corner: torch.Tensor, num_f: torch.Tensor, cap_c: int,
                    w: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv: feats_f (B, Vf, Cin), parent/corner (B, Vf),
    w (2^d, Cin, Cout) -> (B, cap_c, Cout). Rows past num_f have parent
    == cap_c, as do rows dropped by capacity: they go nowhere."""
    del num_f   # implied by parent == cap_c
    B, Vf, Cin = feats_f.shape
    up, down = link_rows(parent, corner, cap_c, w.shape[0])
    out = _GatherGemm.apply(feats_f.reshape(B * Vf, Cin), down, up,
                            w.to(feats_f.dtype))
    return out.view(B, cap_c, -1)


def upsample_conv(feats_c: torch.Tensor, parent: torch.Tensor,
                  corner: torch.Tensor, cap_c: int,
                  w: torch.Tensor) -> torch.Tensor:
    """Transposed stride-2 conv, a pure gather: feats_c (B, cap_c, Cin) ->
    (B, Vf, Cout) on the encoder's exact fine sites."""
    B, Vf = parent.shape
    up, down = link_rows(parent, corner, cap_c, w.shape[0])
    out = _GatherGemm.apply(feats_c.reshape(B * cap_c, -1), up, down,
                            w.to(feats_c.dtype))
    return out.view(B, Vf, -1)
