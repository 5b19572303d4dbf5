"""Standalone halo extend of tiles and its transpose.

    halo26_fwd: x (B, T, t^dim, C) -> ext (B, T, (t+2)^dim, C)
    halo26_bwd: g (B, T, (t+2)^dim, C) -> d_x (B, T, t^dim, C)

ext holds each tile's own cells and the facing cells of its 3^dim - 1
neighbors (zeros where a neighbor is missing), through the `idx`/`ok` maps
of a `Halo26Spec`; the backward is its exact transpose, summed in the
working dtype. Both take bfloat16 or float32 (pure row movement, the
transpose adds in that dtype), t in {2, 4, 8} and any C.

Kernels D and E (`csrc/halo_extend.cu`) replace the TPU kernels
`halo26_fwd` and `halo26_bwd` of `uresnet_pytorch_tpu/ops/pallas/
halo_fused.py`, which move slabs as one-hot matmuls over windows with patch
rows and correction lists; the kernels read each source row by index
instead. Their plain versions are `ops/halo.py`'s `halo26_extend` and
`halo26_transpose`, which the kernels equal bitwise.

`halo26_extend_op` is the extend as a torch operator whose gradient is
the transpose: the port of the reference's custom VJP
(`ops/halo.py:halo26_extend`). It feeds the unfused tile conv
(`ops/tile_conv.py`, `USE_FUSED`).
"""

from __future__ import annotations

import torch

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.halo import (Halo26Spec, halo26_extend,
                                                halo26_transpose)

# kernel launches, for showing a run went through the kernels
launches_fwd = 0   # kernel D
launches_bwd = 0   # kernel E

TILE_SIZES = (2, 4, 8)   # the kernels' geometry tables


def _check(name, a, spec, t, dim, cells_in, cells_out):
    B, T, cells, C = a.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got "
                        f"{a.dtype}")
    if dim not in (2, 3) or t not in TILE_SIZES or cells != cells_in:
        raise ValueError(f"{name}: {tuple(a.shape)} does not fit t={t}, "
                         f"dim={dim} (the kernel takes t in {TILE_SIZES})")
    K = 3 ** dim - 1
    for key, v, dtype in (("idx", spec.idx, torch.int32),
                          ("ok", spec.ok, torch.bool)):
        if tuple(v.shape) != (B, K, T) or v.dtype != dtype:
            raise ValueError(f"{name}: {key} is {tuple(v.shape)} {v.dtype}, "
                             f"need {(B, K, T)} {dtype}")
    for key, v in (("input", a), ("idx", spec.idx), ("ok", spec.ok)):
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {dev}")
    return torch.empty(B, T, cells_out, C, dtype=a.dtype, device=dev)


def _vec_bytes(a: torch.Tensor, out: torch.Tensor) -> int:
    """The widest vector that divides a row of C channels and both base
    addresses."""
    row_bytes = a.shape[-1] * a.element_size()
    vec = 16
    while row_bytes % vec or a.data_ptr() % vec or out.data_ptr() % vec:
        vec //= 2
    return vec


def _launch(fn, a, spec, t, dim, out, *extra):
    B, T, _, C = a.shape
    with torch.cuda.device(a.device):
        return fn(a.data_ptr(), spec.idx.data_ptr(), spec.ok.data_ptr(),
                  out.data_ptr(), B, T, t, dim, C * a.element_size(),
                  _vec_bytes(a, out), *extra,
                  torch.cuda.current_stream().cuda_stream)


def halo26_fwd(x: torch.Tensor, spec: Halo26Spec, t: int,
               dim: int) -> torch.Tensor:
    """The extend on x's device: the plain version for a CPU tensor, kernel
    D for a CUDA tensor (raises if it cannot launch)."""
    if x.device.type == "cpu":
        return halo26_extend(x, spec, t, dim)
    global launches_fwd
    out = _check("halo26_fwd", x, spec, t, dim, t ** dim, (t + 2) ** dim)
    if out.numel() == 0:
        return out
    cuda.check(_launch(cuda.library().halo_extend, x, spec, t, dim, out),
               "halo26_fwd")
    launches_fwd += 1
    return out


def halo26_bwd(g: torch.Tensor, spec: Halo26Spec, t: int,
               dim: int) -> torch.Tensor:
    """The transpose on g's device: the plain version for a CPU tensor,
    kernel E for a CUDA tensor (raises if it cannot launch)."""
    if g.device.type == "cpu":
        return halo26_transpose(g, spec, t, dim)
    global launches_bwd
    out = _check("halo26_bwd", g, spec, t, dim, (t + 2) ** dim, t ** dim)
    if out.numel() == 0:
        return out
    cuda.check(_launch(cuda.library().halo_transpose, g, spec, t, dim, out,
                       int(g.dtype == torch.float32)), "halo26_bwd")
    launches_bwd += 1
    return out


@torch.library.custom_op("uresnet_torch::halo26_extend", mutates_args=())
def halo26_extend_op(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                     t: int, dim: int) -> torch.Tensor:
    """`halo26_fwd(x, Halo26Spec(idx, ok, ...), t, dim)` with the transpose
    as its gradient (x contiguous)."""
    return halo26_fwd(x, Halo26Spec(idx, ok, None, None), t, dim)


def _setup_context(ctx, inputs, output):
    _, idx, ok, t, dim = inputs
    ctx.save_for_backward(idx, ok)
    ctx.geometry = (t, dim)


def _backward(ctx, grad):
    idx, ok = ctx.saved_tensors
    t, dim = ctx.geometry
    d_x = None
    if ctx.needs_input_grad[0]:
        d_x = halo26_bwd(grad.contiguous(), Halo26Spec(idx, ok, None, None),
                         t, dim)
    return d_x, None, None, None, None


halo26_extend_op.register_autograd(_backward, setup_context=_setup_context)
