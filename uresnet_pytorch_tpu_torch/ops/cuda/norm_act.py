"""Batch norm, its activation and its re-mask as one operator.

    y = act(BN(x) [+ r]) [* mask]     act(v) = where(v >= 0, v, slope * v)

over rows of C channels: the tile engine's (B, T, cells, C), a dense
(B, C, *S) volume in channels-last memory (`cdim=1`), or a pair of tensors
that stand for their channel concat (the decoder's (up, skip), never
materialized). Train mode takes the batch moments over the rows where the
mask is set (every row without one), summed over the ranks of a data mesh;
eval mode the running moments. Two flavours of the same algorithm:

- `folded` (the masked BN, `models/norm.py:MaskedBatchNorm`): scale,
  bias and moments fold into a per-channel affine `x * a + b` whose a, b
  are rounded to x's dtype; the variance's clamp is a `torch.maximum`;
- flax's `BatchNorm(dtype=float32)` (the dense model's): `(x - mean) *
  (rsqrt(var + eps) * scale) + bias` in f32; the clamp is a `clamp`.

`remask` multiplies the output by the mask (the tile engine's `_bn_flat`:
the bias would leak nonzeros into the inactive cells of the dense tile
interiors). Every output and input gradient of an inactive row is then 0,
which the kernels write without reading the row.

An optional residual `r` of x's shape and dtype (one tensor, no pair) is
added between the BN and the activation: a post-activation residual
block's `relu(bn2(conv2(.)) + shortcut)` (`models/minkunet_tiled.py`). The
forward's apply kernel reads it, and the backward's kernels read it too
(for act'(v)); the backward's apply writes its gradient d_r = dy act'(v)
[* mask]. A slope of 1 makes act the identity: the BN of a projection
shortcut. Without `r` the operator runs the same kernels as before.

`norm_act` is the entry point. For a CPU tensor it runs the plain torch
chain the models ran before this operator (`chain_plain`, bitwise), for a
CUDA tensor the registered operator `uresnet_torch::norm_act` or raises.
The operator's forward is two kernels in train mode (`stats`, `apply`)
and one in eval; its backward two (`bwd_reduce`, `bwd_apply`), each a
memory-bound pass (`csrc/norm_act.cu`, which says why they were added; no
TPU kernel stands behind them, XLA fused the JAX package's BN). Between
the two passes of either direction the per-channel sums are summed over
the mesh's ranks (SyncBN's mathematics, which the chain gets from the
autograd of `parallel.mesh.all_reduce_sum`). `stats_plain`, `apply_plain`,
`bwd_reduce_plain` and `bwd_apply_plain` are the four kernels in plain
torch; on a CPU tensor the operator runs them, which is how the tests hold
their math to the chain's autograd. As a registered operator it is one
node to selective checkpointing, which recomputes it under `stage_dots`.

The CPU path stays the chain, not the operator's plain versions, because
the tests hold the CPU models to the JAX package, whose bf16 BN rounds as
the chain does (the affine's a, b and then x a + b in bf16): with the
plain versions' f32 math, rounded once, two bf16 comparisons leave their
bounds (a step's down0_w gradient at cosine 0.969 against 0.97, the
row-gather engine's eval logits at p99 0.084 against 0.05).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.sparse_conv import sum_dtype
from uresnet_pytorch_tpu_torch.parallel.mesh import all_reduce_sum

launches_fwd = 0   # kernel launches of the forward (stats and apply)
launches_bwd = 0   # and of the backward (bwd reduce and bwd apply)

STATS, APPLY, BWD_REDUCE, BWD_APPLY = range(4)
_BLOCKS_PER_SM = 4   # the reducing kernels' blocks an SM (csrc: `launch`)

# process groups the operator's sums run over, by the int it is passed
# (an operator's arguments cannot hold a group); 0 is none
_GROUPS: List[Optional[object]] = [None]


def _group_id(mesh) -> int:
    if mesh is None or mesh.group is None:
        return 0
    for i, g in enumerate(_GROUPS):
        if g is mesh.group:
            return i
    _GROUPS.append(mesh.group)
    return len(_GROUPS) - 1


def _halves(x, x2) -> tuple:
    return (x,) if x2 is None else (x, x2)


def _act(v: torch.Tensor, slope: float) -> torch.Tensor:
    # the reference's where(v >= 0, v, s*v): its gradient at 0 is 1
    return torch.where(v >= 0, v, slope * v) if slope > 0 else torch.relu(v)


# -- the chain the models ran: the CPU path, bitwise ------------------------

def masked_bn_plain(parts: tuple, mask, scale, bias, mean, var, eps: float,
                    mesh, train: bool):
    """The masked BN of `MaskedBatchNorm`: parts, each (..., C_i), in their
    dtype, and the batch moments (train) or None."""
    moments = None
    if train:
        acc = sum_dtype(parts[0].dtype)
        m = mask[..., None].to(acc)
        red = tuple(range(parts[0].dim() - 1))
        xfs = [p.to(acc) * m for p in parts]
        s1 = torch.cat([xf.sum(red) for xf in xfs])
        s2 = torch.cat([(xf * xf).sum(red) for xf in xfs])
        s1, s2, n = all_reduce_sum(mesh, s1, s2, m.sum(), grad=True)
        count = n.clamp(min=1.0)
        mean = s1 / count
        var = torch.maximum(s2 / count - mean * mean, torch.zeros_like(mean))
        moments = (mean.detach(), var.detach())
    dtype = parts[0].dtype
    inv = torch.rsqrt(var + eps)
    a = (scale * inv).to(dtype)
    b = (bias - mean * scale * inv).to(dtype)
    out, lo = [], 0
    for p in parts:
        hi = lo + p.shape[-1]
        out.append(p * a[lo:hi] + b[lo:hi])
        lo = hi
    return tuple(out), moments


def flax_bn_plain(x, scale, bias, mean, var, eps: float, mesh, train: bool,
                  cdim: int = 1):
    """flax's `BatchNorm(dtype=float32)` over every cell, channels at
    `cdim`: f32 output and the batch moments (train) or None."""
    red = tuple(d for d in range(x.dim()) if d != cdim % x.dim())
    xf = x.float()
    moments = None
    if train:
        if mesh is None or mesh.group is None:
            mean = xf.mean(red)
            var = ((xf * xf).mean(red) - mean * mean).clamp(min=0.0)
        else:   # over the whole sharded batch, as flax's BN under GSPMD
            s1, s2, n = all_reduce_sum(
                mesh, xf.sum(red), (xf * xf).sum(red),
                torch.tensor(float(xf.numel() // xf.shape[cdim]),
                             device=x.device), grad=True)
            mean = s1 / n
            var = (s2 / n - mean * mean).clamp(min=0.0)
        moments = (mean.detach(), var.detach())
    shape = [1] * x.dim()
    shape[cdim] = -1
    mul = torch.rsqrt(var + eps) * scale
    return (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape), \
        moments


def chain_plain(x, mask, scale, bias, mean, var, *, train: bool,
                remask: bool, folded: bool, slope: float, eps: float,
                dtype: torch.dtype, mesh=None, cdim: int = -1,
                residual=None):
    """The plain torch chain: BN (`masked_bn_plain` or `flax_bn_plain`),
    plus the residual (in the BN's output dtype), the activation, the cast
    to `dtype`, the re-mask. Returns (y, the batch moments or None); y a
    pair for a pair."""
    pair = isinstance(x, tuple)
    if pair and residual is not None:
        raise ValueError("norm_act: a residual takes no pair")
    if folded:
        ys, moments = masked_bn_plain(x if pair else (x,), mask, scale,
                                      bias, mean, var, eps, mesh, train)
    else:
        if pair:
            raise ValueError("norm_act: the flax BN takes no pair")
        y, moments = flax_bn_plain(x, scale, bias, mean, var, eps, mesh,
                                   train, cdim)
        ys = (y,)
    if residual is not None:
        ys = (ys[0] + residual.to(ys[0].dtype),)
    ys = tuple(_act(y, slope).to(dtype) for y in ys)
    if remask:
        occ = mask[..., None].to(dtype)
        ys = tuple(y * occ for y in ys)
    return (ys if pair else ys[0]), moments


# -- the four kernels in plain torch -----------------------------------------

def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def stats_plain(x, x2, mask) -> torch.Tensor:
    """(3, C): per channel sum m x, sum m x^2 and (in every column) n =
    sum m, in f32 (f64 for f64 x), m the row's mask (1 without one)."""
    acc = sum_dtype(x.dtype)
    m = None if mask is None else mask.reshape(-1, 1).to(acc)
    s1, s2 = [], []
    for p in _halves(x, x2):
        xf = _rows(p).to(acc)
        if m is not None:
            xf = xf * m
        s1.append(xf.sum(0))
        s2.append((xf * xf).sum(0))
    s1, s2 = torch.cat(s1), torch.cat(s2)
    n = (torch.tensor(float(_rows(x).shape[0]), dtype=acc, device=x.device)
         if m is None else m.sum())
    return torch.stack([s1, s2, n.expand_as(s1)])


def moments_plain(stats, run_mean, run_var, train: bool):
    """(mean, var, var before its clamp, count) per channel."""
    if not train:
        return run_mean, run_var, run_var, torch.ones_like(run_mean)
    cnt = stats[2].clamp(min=1.0)
    mean = stats[0] / cnt
    raw = stats[1] / cnt - mean * mean
    return mean, torch.where(raw < 0, 0.0, raw), raw, cnt


def coef_plain(mean, var, scale, bias, eps: float, folded: bool,
               dtype: torch.dtype):
    """(sh, a, b, inv): the pre-activation is (x - sh) * a + b."""
    inv = torch.rsqrt(var + eps)
    if folded:
        a = (scale * inv).to(dtype).to(inv.dtype)
        b = (bias - mean * scale * inv).to(dtype).to(inv.dtype)
        return torch.zeros_like(a), a, b, inv
    return mean, inv * scale, bias, inv


def _dact(v: torch.Tensor, slope: float) -> torch.Tensor:
    one = (v > 0) | ((v == 0) & (slope > 0))
    return torch.where(one, v.new_ones(()), v.new_tensor(slope))


def _slices(x, x2, *vecs) -> list:
    """Each half's slices of the per-channel vecs."""
    out, lo = [], 0
    for p in _halves(x, x2):
        hi = lo + p.shape[-1]
        out.append(tuple(v[lo:hi] for v in vecs))
        lo = hi
    return out


def _pre(xf, sh, a, b, r):
    """The pre-activation (x - sh) a + b [+ r] in f32."""
    v = (xf - sh) * a + b
    return v if r is None else v + r.to(v.dtype)


def apply_plain(x, x2, mask, sh, a, b, slope: float, remask: bool,
                r=None) -> list:
    """act((x - sh) * a + b [+ r]) [* mask] per half, in x's dtype."""
    out = []
    for p, (sh_, a_, b_) in zip(_halves(x, x2), _slices(x, x2, sh, a, b)):
        y = _act(_pre(p.to(a.dtype), sh_, a_, b_, r), slope)
        if remask and mask is not None:
            y = y * mask[..., None].to(y.dtype)
        out.append(y.to(p.dtype))
    return out


def _grad_rows(dy, p, mask, sh, a, b, slope, remask, r=None):
    """g = dy act'(v) (times the mask under remask) and x - sh, in f32."""
    xf = p.to(a.dtype)
    g = dy.to(a.dtype) * _dact(_pre(xf, sh, a, b, r), slope)
    if remask and mask is not None:
        g = g * mask[..., None].to(g.dtype)
    return g, xf


def bwd_reduce_plain(dy, dy2, x, x2, mask, sh, a, b, scale, mean, inv,
                     slope: float, remask: bool, folded: bool, r=None):
    """(4, C): sum g, sum g (x - sh), then this rank's d_scale, d_bias."""
    sums = []
    for p, d, (sh_, a_, b_) in zip(_halves(x, x2), _halves(dy, dy2),
                                   _slices(x, x2, sh, a, b)):
        g, xf = _grad_rows(d, p, mask, sh_, a_, b_, slope, remask, r)
        sums.append(torch.stack([_rows(g).sum(0),
                                 _rows(g * (xf - sh_)).sum(0)]))
    gb, gx = torch.cat(sums, 1)
    d_scale = gx * inv + (-(gb * inv)) * mean if folded else gx * inv
    return torch.stack([gb, gx, d_scale, gb])


def stat_grads_plain(grads, scale, mean, raw, cnt, inv, train: bool,
                     folded: bool):
    """(c1, c2): d(loss)/d(s1) and 2 d(loss)/d(s2) from the backward's
    sums (summed over the mesh); 0 in eval."""
    if not train:
        return torch.zeros_like(scale), torch.zeros_like(scale)
    gb, gx = grads[0], grads[1]
    if folded:   # a = scale inv, b = bias - (mean scale) inv
        d_inv = gx * scale - gb * (mean * scale)
        d_mean = -(gb * inv) * scale
    else:        # (x - mean) (inv scale) + bias
        d_inv = gx * scale
        d_mean = -gb * (inv * scale)
    d_var = d_inv * (-0.5 * (inv * inv * inv))
    tie = 0.5 if folded else 1.0
    d_raw = torch.where(raw > 0, d_var,
                        torch.where(raw == 0, tie * d_var, 0.0))
    d_mean = d_mean - 2.0 * mean * d_raw
    return d_mean / cnt, 2.0 * (d_raw / cnt)


def bwd_apply_plain(dy, dy2, x, x2, mask, sh, a, b, c1, c2, slope: float,
                    remask: bool, r=None) -> list:
    """dx = g a + m (c1 + c2 x) per half, in x's dtype; with a residual r,
    then d_r = g in r's dtype."""
    out = []
    for p, d, (sh_, a_, b_, c1_, c2_) in zip(
            _halves(x, x2), _halves(dy, dy2),
            _slices(x, x2, sh, a, b, c1, c2)):
        g, xf = _grad_rows(d, p, mask, sh_, a_, b_, slope, remask, r)
        st = c1_ + c2_ * xf
        if mask is not None:
            st = st * mask[..., None].to(st.dtype)
        out.append((g * a_ + st).to(p.dtype))
        if r is not None:
            out.append(g.to(r.dtype))
    return out


# -- the kernels -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def vector(c0: int, c1: int, elem_bytes: int) -> int:
    """The kernels' vector width (elements) for halves of c0 and c1
    channels, or 0 where they take no such rows (`norm_act_vector` in
    csrc/norm_act.cu, the one statement of their limits)."""
    return cuda.library().norm_act_vector(c0, c1, elem_bytes)


@functools.lru_cache(maxsize=None)
def _part_blocks(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * _BLOCKS_PER_SM


_TICKETS = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The reducing kernels' last-block counter for launches on `stream`
    of `device`: zeroed once, each launch's last block sets it back to 0.
    Launches on one stream run in turn, so they can share it; two streams
    in flight at once each take their own."""
    t = _TICKETS.get((device, stream))
    if t is None:
        t = _TICKETS[device, stream] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
    return t


def _check(x, x2, mask, scale, bias, run_mean, run_var, r=None) -> None:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"norm_act: unsupported device {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"norm_act: the kernels take bfloat16 or float32, "
                        f"got {x.dtype}")
    halves = _halves(x, x2)
    for p in halves:
        if p.dtype != x.dtype or p.device != dev or not p.is_contiguous() \
                or p.shape[:-1] != x.shape[:-1]:
            raise ValueError(f"norm_act: x must be contiguous rows of "
                             f"channels on {dev}, each half alike "
                             f"({[tuple(h.shape) for h in halves]})")
    C = sum(p.shape[-1] for p in halves)
    if vector(x.shape[-1], 0 if x2 is None else x2.shape[-1],
              x.element_size()) == 0:
        raise ValueError(f"norm_act: no plan for channels "
                         f"{[p.shape[-1] for p in halves]} of {x.dtype}")
    if r is not None and (x2 is not None or r.dtype != x.dtype
                          or r.device != dev or r.shape != x.shape
                          or not r.is_contiguous()):
        raise ValueError(f"norm_act: the residual must be contiguous "
                         f"{tuple(x.shape)} {x.dtype} on {dev}, with no "
                         f"pair")
    if mask is not None and (mask.dtype != torch.bool or mask.device != dev
                             or mask.shape != x.shape[:-1]
                             or not mask.is_contiguous()):
        raise ValueError(f"norm_act: mask must be contiguous bool "
                         f"{tuple(x.shape[:-1])} on {dev}")
    for name, v in (("scale", scale), ("bias", bias), ("mean", run_mean),
                    ("var", run_var)):
        if v.shape != (C,) or v.dtype != torch.float32 or v.device != dev \
                or not v.is_contiguous():
            raise ValueError(f"norm_act: {name} must be contiguous float32 "
                             f"({C},) on {dev}, got {tuple(v.shape)} "
                             f"{v.dtype}")


def _launch(kernel: int, x, x2, dy, dy2, out, out2, mask, scale, bias,
            run_mean, run_var, stats, grads, slope, eps, train, folded,
            remask, r=None, dr=None) -> None:
    global launches_fwd, launches_bwd
    C = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
    blocks = _part_blocks(x.device)
    part = (torch.empty(blocks * (2 * C + 2), dtype=torch.float32,
                        device=x.device)
            if kernel in (STATS, BWD_REDUCE) else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = cuda.library().norm_act_launch(
        kernel, ptr(x), ptr(x2), ptr(dy), ptr(dy2), ptr(out), ptr(out2),
        ptr(r), ptr(dr), x.shape[-1], 0 if x2 is None else x2.shape[-1],
        rows, ptr(mask),
        ptr(scale), ptr(bias), ptr(run_mean), ptr(run_var), ptr(stats),
        ptr(grads), ptr(part), _ticket(x.device, stream).data_ptr(), blocks,
        float(slope), float(eps), int(train), int(folded), int(remask),
        int(x.dtype == torch.bfloat16), stream)
    cuda.check(err, "norm_act")
    if kernel in (STATS, APPLY):
        launches_fwd += 1
    else:
        launches_bwd += 1


def _all_reduce(t: torch.Tensor, group: int) -> None:
    if group:
        dist.all_reduce(t, group=_GROUPS[group])


def _forward_plain(x, x2, mask, scale, bias, run_mean, run_var, train,
                   remask, folded, slope, eps, group, r=None):
    """`_forward` by the kernels' plain versions, on any device."""
    stats = None
    if train:
        stats = stats_plain(x, x2, mask)
        _all_reduce(stats, group)
    mean, var, _, _ = moments_plain(stats, run_mean, run_var, train)
    sh, a, b, _ = coef_plain(mean, var, scale, bias, eps, folded, x.dtype)
    ys = apply_plain(x, x2, mask, sh, a, b, slope, remask, r)
    if train:
        stats = torch.cat([stats, torch.stack([mean, var])])
    return ys[0], ys[1] if x2 is not None else x.new_empty(0), \
        x.new_empty(0, dtype=sum_dtype(x.dtype)) if stats is None else stats


def _forward(x, x2, mask, scale, bias, run_mean, run_var, train, remask,
             folded, slope, eps, group, r=None):
    """(y, y2 or an empty tensor, stats (5, C) or an empty tensor): the
    kernels for a CUDA tensor, their plain versions for a CPU one."""
    if x.device.type == "cpu":
        return _forward_plain(x, x2, mask, scale, bias, run_mean, run_var,
                              train, remask, folded, slope, eps, group, r)
    C = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
    empty = x.new_empty(0)
    _check(x, x2, mask, scale, bias, run_mean, run_var, r)
    y, y2 = torch.empty_like(x), None if x2 is None else torch.empty_like(x2)
    stats = x.new_empty((5, C), dtype=torch.float32) if train else None
    with torch.cuda.device(x.device):
        if train:
            _launch(STATS, x, x2, None, None, None, None, mask, scale, bias,
                    run_mean, run_var, stats, None, slope, eps, train, folded,
                    remask)
            _all_reduce(stats[:3], group)
        _launch(APPLY, x, x2, None, None, y, y2, mask, scale, bias, run_mean,
                run_var, stats, None, slope, eps, train, folded, remask, r)
    return y, empty if y2 is None else y2, \
        x.new_empty(0, dtype=torch.float32) if stats is None else stats


def _backward_plain(dy, dy2, x, x2, mask, scale, bias, run_mean, run_var,
                    stats, train, remask, folded, slope, eps, group, r=None):
    """`_backward` by the kernels' plain versions, on any device."""
    mean, var, raw, cnt = moments_plain(stats, run_mean, run_var, train)
    sh, a, b, inv = coef_plain(mean, var, scale, bias, eps, folded, x.dtype)
    grads = bwd_reduce_plain(dy, dy2, x, x2, mask, sh, a, b, scale, mean,
                             inv, slope, remask, folded, r)
    _all_reduce(grads[:2], group)
    c1, c2 = stat_grads_plain(grads, scale, mean, raw, cnt, inv, train,
                              folded)
    dxs = bwd_apply_plain(dy, dy2, x, x2, mask, sh, a, b, c1, c2, slope,
                          remask, r)
    return (dxs[0], dxs[1] if x2 is not None else None, grads[2], grads[3],
            dxs[1] if r is not None else None)


def _backward(dy, dy2, x, x2, mask, scale, bias, run_mean, run_var, stats,
              train, remask, folded, slope, eps, group, r=None):
    """(dx, dx2 or None, d_scale, d_bias, d_r or None): the kernels for a
    CUDA tensor, their plain versions for a CPU one."""
    if x.device.type == "cpu":
        return _backward_plain(dy, dy2, x, x2, mask, scale, bias, run_mean,
                               run_var, stats, train, remask, folded, slope,
                               eps, group, r)
    C = scale.shape[0]
    grads = x.new_empty((4, C), dtype=torch.float32)
    dx, dx2 = torch.empty_like(x), None if x2 is None else torch.empty_like(x2)
    dr = None if r is None else torch.empty_like(r)
    st = stats if train else None
    with torch.cuda.device(x.device):
        _launch(BWD_REDUCE, x, x2, dy, dy2, None, None, mask, scale, bias,
                run_mean, run_var, st, grads, slope, eps, train, folded,
                remask, r)
        # the sums over the mesh; d_scale and d_bias stay this rank's
        _all_reduce(grads[:2], group)
        _launch(BWD_APPLY, x, x2, dy, dy2, dx, dx2, mask, scale, bias,
                run_mean, run_var, st, grads, slope, eps, train, folded,
                remask, r, dr)
    return dx, dx2, grads[2], grads[3], dr


@torch.library.custom_op("uresnet_torch::norm_act", mutates_args=())
def norm_act_op(x: torch.Tensor, x2: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], scale: torch.Tensor,
                bias: torch.Tensor, run_mean: torch.Tensor,
                run_var: torch.Tensor, train: bool, remask: bool,
                folded: bool, slope: float, eps: float, group: int,
                r: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, y2, stats): y2 empty without x2; stats (5, C) f32 in train (the
    mesh-wide s1, s2, n, then mean and var), empty in eval. x (and x2)
    contiguous (..., C_i), mask (...) bool or None; group a process group
    by `_group_id` (0: none); r None or a residual of x's shape, added
    before the activation."""
    return _forward(x, x2, mask, scale, bias, run_mean, run_var, train,
                    remask, folded, slope, eps, group, r)


def _setup_context(ctx, inputs, output):
    (x, x2, mask, scale, bias, run_mean, run_var, train, remask, folded,
     slope, eps, group, r) = inputs
    ctx.save_for_backward(x, x2, mask, scale, bias, run_mean, run_var,
                          output[2], r)
    ctx.flags = (train, remask, folded, slope, eps, group)
    ctx.mark_non_differentiable(output[2])


def _op_backward(ctx, dy, dy2, _):
    (x, x2, mask, scale, bias, run_mean, run_var, stats,
     r) = ctx.saved_tensors
    train, remask, folded, slope, eps, group = ctx.flags
    dy = dy.contiguous()
    dy2 = None if x2 is None else dy2.contiguous()
    dx, dx2, d_scale, d_bias, d_r = _backward(
        dy, dy2, x, x2, mask, scale, bias, run_mean, run_var, stats, train,
        remask, folded, slope, eps, group, r)
    need = ctx.needs_input_grad
    # the dispatcher drops a trailing r left at its default: one gradient
    # an input it passed
    return (dx if need[0] else None, dx2 if need[1] else None, None,
            d_scale if need[3] else None, d_bias if need[4] else None,
            None, None, None, None, None, None, None,
            None) + ((d_r if need[13] else None,) if len(need) > 13 else ())


norm_act_op.register_autograd(_op_backward, setup_context=_setup_context)


def norm_act(x, mask, scale, bias, run_mean, run_var, *, train: bool,
             remask: bool, folded: bool, slope: float, eps: float,
             dtype: torch.dtype, mesh=None, cdim: int = -1, residual=None):
    """y = act(BN(x) [+ residual]) in `dtype` [* mask] and the batch
    moments (train; None in eval). x (..., C), or a pair for a channel
    concat (y a pair then), or with `cdim` the channel axis of a
    channels-last volume; mask (...) bool, or None for every row (required
    for `remask`); residual None or a tensor of x's shape and dtype (not
    with a pair). The plain chain for a CPU tensor; the kernels for a CUDA
    tensor, or raises (on any layout but rows of contiguous channels too:
    the kernels copy nothing)."""
    if (x[0] if isinstance(x, tuple) else x).device.type == "cpu":
        return chain_plain(x, mask, scale, bias, run_mean, run_var,
                           train=train, remask=remask, folded=folded,
                           slope=slope, eps=eps, dtype=dtype, mesh=mesh,
                           cdim=cdim, residual=residual)
    return norm_act_via_op(x, mask, scale, bias, run_mean, run_var,
                           train=train, remask=remask, folded=folded,
                           slope=slope, eps=eps, dtype=dtype, mesh=mesh,
                           cdim=cdim, residual=residual)


def norm_act_via_op(x, mask, scale, bias, run_mean, run_var, *,
                    train: bool, remask: bool, folded: bool, slope: float,
                    eps: float, dtype: torch.dtype, mesh=None,
                    cdim: int = -1, residual=None):
    """`norm_act` through the operator on any device: the kernels on the
    card, their plain versions on the CPU (which the tests hold to the
    chain's autograd)."""
    pair = isinstance(x, tuple)
    if remask and mask is None:
        raise ValueError("norm_act: remask needs a mask")
    if pair and not folded:
        raise ValueError("norm_act: the flax BN takes no pair")
    if pair and residual is not None:
        raise ValueError("norm_act: a residual takes no pair")
    parts = x if pair else (x,)
    xs = tuple(p.movedim(cdim, -1) for p in parts)
    if not all(p.is_contiguous() for p in xs):
        raise ValueError(f"norm_act: x must hold its channels (axis {cdim}) "
                         f"contiguous, as channels-last memory does; got "
                         f"strides {[p.stride() for p in parts]}")
    r = None if residual is None else residual.movedim(cdim, -1)
    y, y2, stats = torch.ops.uresnet_torch.norm_act(
        xs[0], xs[1] if pair else None, mask, scale, bias, run_mean,
        run_var, train, remask, folded, float(slope), float(eps),
        _group_id(mesh), r)
    moments = (stats[3].detach(), stats[4].detach()) if train else None
    ys = tuple(p.movedim(-1, cdim).to(dtype) for p in
               ((y, y2) if pair else (y,)))
    return (ys if pair else ys[0]), moments
