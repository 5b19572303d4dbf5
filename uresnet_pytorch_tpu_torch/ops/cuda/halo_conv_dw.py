"""Weight gradient of the submanifold 3^dim conv on halo'd tiles.

    d_W[k, ci, co] = sum over events, live tiles, cells p of
                     ext(x)[tile, p + delta_k, ci] * g[tile, p, co]

x (B, T, t^dim, Cin) and g (B, T, t^dim, Cout) channels last, neighbor rows
from a `Halo26Spec`, offsets k in the order of `halo_conv`'s weights. The
result is f32 (3^dim, Cin, Cout). Dead tile rows (`halo.blive` false)
contribute nothing: the conv writes zeros there whatever the weights. The
kernel takes bfloat16 x and g (bf16 x bf16 -> f32 tensor-core MMAs) and
Cout a multiple of 8 up to 128; the plain version takes any float dtype
and width.

Kernel C (`csrc/halo_conv_dw.cu`) replaces the TPU kernels
`halo_conv_dw` (v2 and v1) in `uresnet_pytorch_tpu/ops/pallas/
halo_conv.py` and the d_W half of `halo_conv_bwd` there. It stages the
extended tiles from plain rows as kernel B does, so one kernel serves
every (t, Cin). `halo_conv_dw_plain` is the same function in plain torch:
the exact halo extend in f32, then one f32 GEMM per offset over the
3^dim shifted slices, as the reference's `_dw_recompute` oracle.
"""

from __future__ import annotations

import torch

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec, halo26_extend

launches = 0   # kernel launches, for showing a run went through the kernel


def halo_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, halo: Halo26Spec,
                       t: int, dim: int) -> torch.Tensor:
    B, T, cells, Cin = x.shape
    Cout = g.shape[-1]
    e = t + 2
    ext = halo26_extend(x.float(), halo, t, dim).reshape(
        (B * T,) + (e,) * dim + (Cin,))
    gf = (g.float() * halo.blive[:, :, None, None]).reshape(-1, Cout)
    dws = []
    for k in range(3 ** dim):
        digits = [(k // 3 ** (dim - 1 - a)) % 3 for a in range(dim)]
        sl = (slice(None),) + tuple(slice(d, d + t) for d in digits)
        dws.append(ext[sl].reshape(-1, Cin).T @ gf)
    return torch.stack(dws)


def _check(x, g, halo, t, dim):
    B, T, cells, Cin = x.shape
    K, Cout = 3 ** dim, g.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"halo_conv_dw: unsupported device {dev}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"halo_conv_dw: the kernel takes bfloat16 x and g, "
                        f"got {x.dtype} / {g.dtype}")
    if dim not in (2, 3) or cells != t ** dim or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"halo_conv_dw: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)} do not fit t={t}, dim={dim}")
    if Cout % 8 or Cout > 128:
        raise ValueError(f"halo_conv_dw: the kernel takes Cout a multiple "
                         f"of 8 up to 128, got {Cout}")
    shapes = [("idx", halo.idx, (B, K - 1, T), torch.int32),
              ("ok", halo.ok, (B, K - 1, T), torch.bool),
              ("blive", halo.blive, (B, T), torch.bool)]
    for name, v, shape, dtype in shapes:
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"halo_conv_dw: {name} is {tuple(v.shape)} "
                             f"{v.dtype}, need {shape} {dtype}")
    for name, v in [("x", x), ("g", g)] + [(n, v) for n, v, _, _ in shapes]:
        if v.device != dev or not v.is_contiguous():
            raise ValueError(
                f"halo_conv_dw: {name} must be contiguous on {dev}")


def halo_conv_dw(x: torch.Tensor, g: torch.Tensor, halo: Halo26Spec, t: int,
                 dim: int) -> torch.Tensor:
    """d_W on x's device: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (raises if it cannot launch)."""
    if x.device.type == "cpu":
        return halo_conv_dw_plain(x, g, halo, t, dim)
    global launches
    _check(x, g, halo, t, dim)
    B, T, _, Cin = x.shape
    Cout = g.shape[-1]
    if g.data_ptr() % 16:          # the kernel stages g in 16-byte loads
        g = g.clone()
    dw = torch.zeros(3 ** dim, Cin, Cout, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = cuda.library().halo_conv_dw(
            x.data_ptr(), g.data_ptr(), halo.idx.data_ptr(),
            halo.ok.data_ptr(), halo.blive.data_ptr(), dw.data_ptr(),
            B, T, t, dim, Cin, Cout, torch.cuda.current_stream().cuda_stream)
    cuda.check(err, "halo_conv_dw")
    launches += 1
    return dw
