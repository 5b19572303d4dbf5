"""Weight gradient of the submanifold 3^dim conv on halo'd tiles.

    d_W[k, ci, co] = sum over events, live tiles, cells p of
                     ext(x)[tile, p + delta_k, ci] * g[tile, p, co]

x (B, T, t^dim, Cin) and g (B, T, t^dim, Cout) channels last, neighbor rows
from a `Halo26Spec`, offsets k in the order of `halo_conv`'s weights. The
result is f32 (3^dim, Cin, Cout). Dead tile rows (`halo.blive` false)
contribute nothing: the conv writes zeros there whatever the weights. The
kernel takes bfloat16 x and g (bf16 x bf16 -> f32 tensor-core MMAs) and
the shapes that `dw_plan` plans; the plain version takes any float dtype
and width.

Kernel C (`csrc/halo_conv_dw.cu`) replaces the TPU kernels
`halo_conv_dw` (v2 and v1) in `uresnet_pytorch_tpu/ops/pallas/
halo_conv.py` and the d_W half of `halo_conv_bwd` there. It stages the
extended tiles from plain rows, once per chunk for all offsets, so one
kernel serves every (t, Cin); `dw_plan` says how it splits the work.
`halo_conv_dw_plain` is the same function in plain torch: the exact halo
extend in f32, then one f32 GEMM per offset over the 3^dim shifted
slices, as the reference's `_dw_recompute` oracle.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional

import torch

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec, halo26_extend

launches = 0   # kernel launches, for showing a run went through the kernel
# the same launches by (t, Cin, Cout), for each shape's share of a step
launches_by_shape: collections.Counter = collections.Counter()


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


class DwPlan(NamedTuple):
    """How the kernel splits d_W, in the order its C entry point takes it
    (`make_plan` in csrc/halo_conv_dw.cu checks it). Blocks take
    16-channel Cin slices (Cin >= 16) or all of Cin, packed (Cin < 16),
    times Cout slices of `cs` channels. A block's M rows come in 16-row
    tiles: one per offset k (rows = the slice's channels), or the 3^dim x
    Cin (offset, channel) rows k * Cin + c packed, padded to a multiple of
    16. Its 9 warps form `wm` groups; group w takes the M tiles w, w + wm,
    ... (`mw` of them) and its 9 / wm warps split the 16-cell depth steps
    of its chunks (`tiles` whole tiles each)."""
    cs: int
    tiles: int
    wm: int
    mw: int


_CHUNK_CELLS = 256       # cells per chunk where tiles are smaller
_MAX_NBR = 3 * 288       # map entries a chunk may have: 3 per thread
_MAX_ACC = 120           # f32 accumulators a lane may hold
_MAX_SMEM = 232448       # dynamic shared memory a block may use


@functools.lru_cache(maxsize=None)
def dw_plan(t: int, dim: int, Cin: int, Cout: int) -> Optional[DwPlan]:
    """The kernel's plan for a shape, or None where the kernel takes no such
    d_W: the one place that chooses it, asked by the wrapper's check and by
    `ops/tile_conv.py`'s choice of path, and passed to the kernel, whose
    `make_plan` (csrc/halo_conv_dw.cu) only checks it against its compile-time
    limits. Cout is padded to a multiple of 8 on the MMA's N side; chunks are
    256 cells of whole tiles (one tile where a tile is larger); the Cout slice
    is the widest of at most 128 channels whose accumulators (mw x cs / 8 x 4
    f32 a lane) stay within 120 and whose buffer fits in 227 KB beside the
    tables."""
    if dim not in (2, 3) or t < 2 or Cin < 1 or Cout < 1:
        return None
    cells, ecells, K = t ** dim, (t + 2) ** dim, 3 ** dim
    if cells <= _CHUNK_CELLS and _CHUNK_CELLS % cells == 0:
        tiles = _CHUNK_CELLS // cells
    elif cells % 16 == 0:
        tiles = 1
    else:
        return None
    if tiles * K > _MAX_NBR:
        return None
    chunk = tiles * cells
    packed = Cin < 16
    sa = Cin if packed else 24
    mtiles = -(-K * Cin // 16) if packed else K
    wm = 9 if mtiles >= 9 else 3 if mtiles >= 3 else 1
    mw = -(-mtiles // wm)
    if mw > 3:
        return None
    ext = -(-tiles * ecells * sa // 8) * 8
    tables = -(-(ecells + chunk + tiles * K) * 4 // 16) * 16
    n = -(-Cout // 8)
    for d in range(min(n, 16), 0, -1):
        if n % d or mw * d * 4 > _MAX_ACC:
            continue
        if tables + (ext + chunk * (8 * d + 8)) * 2 <= _MAX_SMEM:
            return DwPlan(8 * d, tiles, wm, mw)
    return None


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
    if dw_plan(t, dim, Cin, Cout) is None:
        raise ValueError(f"halo_conv_dw: no plan for t={t}, dim={dim}, "
                         f"Cin={Cin}, Cout={Cout} (the kernel takes tiles of "
                         f"whole 16-cell depth steps, where its buffers "
                         f"fit)")
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


def launch_args(x, g, halo, t, dim, dw, plan: DwPlan) -> tuple:
    """The C entry point's arguments, stream excluded: the tensors'
    storage, the shape and the plan."""
    B, T, _, Cin = x.shape
    return (x.data_ptr(), g.data_ptr(), halo.idx.data_ptr(),
            halo.ok.data_ptr(), halo.blive.data_ptr(), dw.data_ptr(), B, T,
            t, dim, Cin, g.shape[-1], *plan)


def halo_conv_dw(x: torch.Tensor, g: torch.Tensor, halo: Halo26Spec, t: int,
                 dim: int) -> torch.Tensor:
    """d_W on x's device: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (raises if it cannot launch)."""
    if x.device.type == "cpu":
        return halo_conv_dw_plain(x, g, halo, t, dim)
    global launches
    _check(x, g, halo, t, dim)
    Cin, Cout = x.shape[-1], g.shape[-1]
    if Cout % 8 == 0 and g.data_ptr() % 16:   # g staged in 16-byte loads
        g = g.clone()
    dw = torch.zeros(3 ** dim, Cin, Cout, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = cuda.library().halo_conv_dw(
            *launch_args(x, g, halo, t, dim, dw, dw_plan(t, dim, Cin, Cout)),
            torch.cuda.current_stream().cuda_stream)
    cuda.check(err, "halo_conv_dw")
    launches += 1
    launches_by_shape[(t, Cin, Cout)] += 1
    return dw
