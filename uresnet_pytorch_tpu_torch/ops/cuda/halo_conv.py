"""Submanifold 3^dim conv on halo'd tiles, with an optional epilogue.

    raw:      y = conv(x)
    epilogue: y = mask * leaky_alpha(conv(x) * a + b)

x (B, T, t^dim, Cin) channels last, w (3^dim, Cin, Cout) with offset
k = (d0*3 + d1)*3 + d2 over {-1,0,1}^dim, neighbor rows from a
`Halo26Spec`. Sums run in f32 and round once to x's dtype; the affine
a, b (Cout,) is f32, the mask (B, T, t^dim) bool. Dead tile rows
(`halo.blive` false) are zero in both versions. The kernel takes bfloat16
(its tensor-core MMAs are bf16 x bf16 -> f32) and the shapes that
`kernel_plan` plans; the plain version takes any float dtype and width.

Kernel B (`csrc/halo_conv.cu`) replaces four TPU kernels in
`uresnet_pytorch_tpu/ops/pallas/halo_conv.py`: `fused_halo_conv_bn_act`
(v2 with epilogue), `halo_conv_fwd` (v2 and v1) and the `_preslice0`
lane repack that feeds them. It reads plain (B, T, cells, C) rows
through `idx`/`ok`, so no packed layout exists and one kernel serves
every (t, Cin), Cin = 1 included. `halo_conv_plain` is the same function
in plain torch: the exact halo extend then a VALID conv in f32.

`halo_conv_op` is the raw conv as a torch operator with a gradient, the
port of the reference's `fused_halo_conv` custom VJP (`_fhc_bwd`):
`d_x = conv(g, flip_weights(w))` on the same halo maps (kernel B again;
the adjoint of the stencil restricted to the live tiles is the flipped
stencil on the same tiles) and `d_W` by kernel C (`halo_conv_dw`). That
is the function of the TPU's combined backward `halo_conv_bwd` and of
its fallback (`halo_conv_fwd` on flipped weights + `halo_conv_dw`). As a
registered operator it is visible to selective checkpointing, which
saves its outputs under `remat_mode="stage_dots"`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv_dw import halo_conv_dw
from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec, halo26_extend

launches = 0   # kernel launches, for showing a run went through the kernel
launches_wide = 0   # of those, on the wide path (`kernel_plan`'s ring > 0)


def halo_conv_plain(x: torch.Tensor, w: torch.Tensor, halo: Halo26Spec,
                    t: int, dim: int, a=None, b=None, alpha: float = 1.0,
                    mask=None) -> torch.Tensor:
    B, T, cells, Cin = x.shape
    Cout = w.shape[-1]
    ext = halo26_extend(x.float(), halo, t, dim)
    xin = ext.reshape((B * T,) + (t + 2,) * dim + (Cin,)).movedim(-1, 1)
    kern = w.float().reshape((3,) * dim + (Cin, Cout))
    kern = kern.permute((dim + 1, dim) + tuple(range(dim)))
    conv = F.conv3d if dim == 3 else F.conv2d
    y = conv(xin, kern).movedim(1, -1).reshape(B, T, cells, Cout)
    if a is not None:
        z = y * a.float() + b.float()
        y = torch.where(z >= 0, z, alpha * z) * mask[..., None]
    y = y * halo.blive[:, :, None, None]
    return y.to(x.dtype)


def _check(x, w, halo, t, dim, a, b, mask):
    B, T, cells, Cin = x.shape
    K, Cout = 3 ** dim, w.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"halo_conv: unsupported device {dev}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"halo_conv: the kernel takes bfloat16 x and w, got "
                        f"{x.dtype} / {w.dtype}")
    if dim not in (2, 3) or cells != t ** dim or w.shape != (K, Cin, Cout):
        raise ValueError(f"halo_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not fit t={t}, dim={dim}")
    if kernel_plan(t, dim, Cin, Cout) is None:
        raise ValueError(f"halo_conv: no plan for t={t}, dim={dim}, Cin="
                         f"{Cin}, Cout={Cout} (the kernel takes tiles that "
                         f"64-row groups cut, of at most 1000 extended "
                         f"cells)")
    shapes = [("idx", halo.idx, (B, K - 1, T), torch.int32),
              ("ok", halo.ok, (B, K - 1, T), torch.bool),
              ("blive", halo.blive, (B, T), torch.bool)]
    if a is not None:
        shapes += [("a", a, (Cout,), torch.float32),
                   ("b", b, (Cout,), torch.float32),
                   ("mask", mask, (B, T, cells), torch.bool)]
    for name, v, shape, dtype in shapes:
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"halo_conv: {name} is {tuple(v.shape)} "
                             f"{v.dtype}, need {shape} {dtype}")
    for name, v in [("x", x), ("w", w)] + [(n, v) for n, v, _, _ in shapes]:
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"halo_conv: {name} must be contiguous on {dev}")


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> (round_up(Cout, 8), kp), zero-padded: the kernel's
    GEMM B operand, one row per output channel, the MMA's N side padded
    with zero rows. Depth kk = k * cpad + c with cpad = round_up(Cin, 16)
    (kp = K * cpad), or, for Cin < 16, kk = k * Cin + c with kp =
    round_up(K * Cin, 16): the offsets packed into the MMA depth (one small
    copy per call)."""
    K, Cin, Cout = w.shape
    coutp = -(-Cout // 8) * 8
    if Cin < 16:
        wt = w.new_zeros(coutp, -(-K * Cin // 16) * 16)
        wt[:Cout, :K * Cin] = w.reshape(K * Cin, Cout).t()
    else:
        wt = w.new_zeros(coutp, K, -(-Cin // 16) * 16)
        wt[:Cout, :, :Cin] = w.permute(2, 0, 1)
        wt = wt.reshape(coutp, -1)
    return wt


def wide_weights(w: torch.Tensor, n: int, cw: int) -> torch.Tensor:
    """(K, Cin, Cout) -> the wide path's weight tiles, (slices, chunks, K,
    cw / 8, n, 8) zero-padded: for Cout slice s (n channels, past Cout
    zero), channel chunk c (cw of the padded Cin) and offset k, one
    contiguous tile that holds w[k, c * cw + 8 u + e, s * n + j] at
    [u, j, e]: one bulk copy brings it, and its 8 x 8 blocks of 128 bytes
    are wgmma's K-major core matrices. The depth is `kernel_weights'`
    (offset-major, Cin padded to 16), cut into chunks."""
    K, Cin, Cout = w.shape
    cpad = -(-Cin // 16) * 16
    slices = -(-Cout // n)
    wt = w.new_zeros(K, cpad, slices * n)
    wt[:, :Cin, :Cout] = w
    return wt.reshape(K, cpad // cw, cw // 8, 8, slices, n).permute(
        4, 1, 0, 2, 5, 3).contiguous()


def staged_input(x: torch.Tensor, plan: "KernelPlan") -> torch.Tensor:
    """x as the kernel may read it: the wide path stages rows by 16-byte
    copies and refuses an x off a 16-byte boundary (a view at an odd
    offset), so such an x is copied to a fresh tensor first; the resident
    path stages it by scalar loads as it is."""
    return x.clone() if plan.ring and x.data_ptr() % 16 else x


class Groups(NamedTuple):
    """How the kernel cuts a level into groups of 64 output rows (its
    `kRows`; `make_plan` in csrc/halo_conv.cu derives the same from the
    shape): `tiles` whole tiles (t^dim <= 64),
    or, for a larger tile, `subs` slabs of whole slices along its first
    axis, each staging the ext cells [sub * zoff, sub * zoff + gcells) of
    its tile's (t+2)^dim block."""
    tiles: int
    subs: int
    gcells: int
    zoff: int


def groups(t: int, dim: int) -> Optional[Groups]:
    """The kernel's groups at tile size t, or None where 64-row groups do
    not cut the tile (or its extended block passes 1000 cells)."""
    cells, ecells = t ** dim, (t + 2) ** dim
    if ecells > 1000:
        return None
    if cells <= 64:
        return None if 64 % cells else Groups(64 // cells, 1, ecells, 0)
    slice_ = cells // t
    if 64 % slice_ or t % (64 // slice_):
        return None
    rows, plane = 64 // slice_, (t + 2) ** (dim - 1)
    return Groups(1, t // rows, (rows + 2) * plane, rows * plane)


class KernelPlan(NamedTuple):
    """Kernel B's plan of one conv, in the order its C entry points take
    it: `cs` output channels per block, `cw` channels per staged chunk,
    the wide path's `ring` weight stages and `kg` offsets per stage (both
    0 on the resident path, whose blocks hold their slice's weights), and
    `ahead`: 1 where the resident path stages channel chunks through two
    buffers, the next chunk's copies in flight while this one multiplies,
    0 where it stages a group's whole extended rows into one (and on the
    wide path, whose kernel always runs two)."""
    cs: int
    cw: int
    ring: int
    kg: int
    ahead: int


SMEM = 232448 - 8192     # dynamic shared memory a block may use: the static
#                          tables take at most 8 KB of the 227 KB


@functools.lru_cache(maxsize=None)
def kernel_plan(t: int, dim: int, Cin: int, Cout: int) -> Optional[KernelPlan]:
    """The kernel's plan, or None where the kernel takes no such conv: the
    one place that chooses it, asked by the wrapper's check and by
    `ops/tile_conv.py`'s choice of path, and passed to the kernel, whose
    `make_plan` (csrc/halo_conv.cu) only checks it against its
    compile-time limits. Output rows come in groups of 64 (`groups`).

    The resident path: Cout is padded to a multiple of 8 (`kernel_weights`'
    zero rows) and split into slices of at most 128. Each block holds its
    slice's weight rows in shared memory (`SMEM`) beside either one buffer
    of a group's extended rows (padded Cin at most 128), or two buffers of
    channel chunks (a multiple of 16 up to 128 dividing the padded Cin),
    pipelined: the latter where it takes fewer slices or Cin is wider, at
    Cin >= 16. Both take the fewest slices, then the widest chunk.

    The wide path, where that plan splits Cout and the input stages by
    16-byte vectors (Cin >= 16, Cin % 8 == 0): a block computes two groups
    (128 rows) by N = Cout rounded up to 32 (at most 256; wider Cout in
    slices of 128) and streams the weights through a ring of (offset,
    chunk) tiles (`wide_weights`) beside two buffers of both groups'
    extended rows: the widest chunk that leaves room for 4 tiles, stages
    of the most offsets (9, 3 or 1, dividing 3^dim) of which 4 fit, and as
    many stages as fit, up to 8: the stages in flight take long enough to
    cover the next stages' copies (at 256 wide, 16-channel chunks and 5
    stages of 3 offsets ran 1.12x faster on an H100 than 32-channel chunks
    and 3 stages of 1). Where nothing fits, the resident plan."""
    grp = groups(t, dim)
    K = 3 ** dim
    if Cin < 1 or Cout < 1 or grp is None or grp.tiles * K > 216:
        return None
    tiles, gcells = grp.tiles, grp.gcells
    packed = Cin < 16
    cpad = Cin if packed else -(-Cin // 16) * 16
    kp = -(-K * Cin // 16) * 16 if packed else K * cpad
    n = -(-Cout // 8)

    def ext_bytes(cw, n_groups=1):
        sa = cw if packed else cw + 8
        return -(-n_groups * tiles * gcells * sa * 2 // 16) * 16

    def fit(bufs, widths):
        for d in range(min(n, 16), 0, -1):
            for cw in widths:
                if n % d == 0 and d * 8 * (kp + 8) * 2 + bufs * ext_bytes(cw) \
                        <= SMEM:
                    return d, cw
        return 0, 0

    one = fit(1, [cpad]) if cpad <= 128 else (0, 0)
    two = (0, 0) if packed else fit(
        2, [c for c in range(min(cpad, 128), 0, -16) if cpad % c == 0])
    ahead = int(two[0] > one[0])
    d, cw = two if ahead else one
    if not d:
        return None
    if packed or Cin % 8 or d == n:
        return KernelPlan(8 * d, cw, 0, 0, ahead)
    wide_n = -(-Cout // 32) * 32 if Cout <= 256 else 128
    for wcw in range(min(cpad, 128), 0, -16):
        tile = wide_n * wcw * 2
        room = SMEM - 2 * ext_bytes(wcw, 2)
        if cpad % wcw == 0 and room >= 4 * tile:
            kg = next(g for g in (9, 3, 1)
                      if g == 1 or (K % g == 0 and room >= 4 * g * tile))
            return KernelPlan(wide_n, wcw, min(8, room // (kg * tile)), kg,
                              0)
    return KernelPlan(8 * d, cw, 0, 0, ahead)


def launch_args(x, wt, halo, t, dim, a, b, alpha, mask, out,
                plan: KernelPlan) -> tuple:
    """The C entry point's arguments, stream excluded: the tensors' own
    storage (the model's (B, T, cells, C) rows, no packed copy), the
    kernel-layout weights, the shape and the plan."""
    B, T, _, Cin = x.shape
    ptrs = [x.data_ptr(), wt.data_ptr(), halo.idx.data_ptr(),
            halo.ok.data_ptr(), halo.blive.data_ptr()]
    if a is not None:
        ptrs += [a.data_ptr(), b.data_ptr(), mask.data_ptr(), float(alpha)]
    return (*ptrs, out.data_ptr(), B, T, t, dim, Cin, out.shape[-1], *plan)


def halo_conv(x: torch.Tensor, w: torch.Tensor, halo: Halo26Spec, t: int,
              dim: int, a=None, b=None, alpha: float = 1.0,
              mask=None) -> torch.Tensor:
    """The conv on x's device: the plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor (raises if it cannot launch). Pass
    a, b and mask together for the epilogue, or none of them."""
    if (a is None) != (b is None) or (a is None) != (mask is None):
        raise ValueError("halo_conv: pass a, b and mask together")
    if x.device.type == "cpu":
        return halo_conv_plain(x, w, halo, t, dim, a, b, alpha, mask)
    global launches, launches_wide
    _check(x, w, halo, t, dim, a, b, mask)
    B, T, cells, _ = x.shape
    out = torch.empty(B, T, cells, w.shape[-1], dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = cuda.library()
    fn = lib.halo_conv_raw if a is None else lib.halo_conv_bn_act
    plan = kernel_plan(t, dim, x.shape[-1], w.shape[-1])
    x = staged_input(x, plan)
    with torch.cuda.device(x.device):
        wt = wide_weights(w, plan.cs, plan.cw) if plan.ring \
            else kernel_weights(w)
        err = fn(*launch_args(x, wt, halo, t, dim, a, b, alpha, mask, out,
                              plan),
                 torch.cuda.current_stream().cuda_stream)
    cuda.check(err, "halo_conv")
    launches += 1
    launches_wide += plan.ring > 0
    return out


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """(3^d, Cin, Cout) -> (3^d, Cout, Cin): the adjoint stencil. Reversing
    the lexicographic offset order negates every offset, and each offset's
    (Cin, Cout) slice transposes."""
    return w.flip(0).transpose(1, 2)


@torch.library.custom_op("uresnet_torch::halo_conv", mutates_args=())
def halo_conv_op(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                 ok: torch.Tensor, blive: torch.Tensor, t: int,
                 dim: int) -> torch.Tensor:
    """The raw conv `halo_conv(x, w, Halo26Spec(idx, ok, blive), t, dim)`
    with a gradient (x and w contiguous, w in x's dtype)."""
    return halo_conv(x, w, Halo26Spec(idx, ok, blive, None), t, dim)


def _setup_context(ctx, inputs, output):
    x, w, idx, ok, blive, t, dim = inputs
    ctx.save_for_backward(x, w, idx, ok, blive)
    ctx.geometry = (t, dim)


def _backward(ctx, grad):
    x, w, idx, ok, blive = ctx.saved_tensors
    t, dim = ctx.geometry
    halo = Halo26Spec(idx, ok, blive, None)
    g = grad.contiguous()
    d_x = d_w = None
    if ctx.needs_input_grad[0]:
        d_x = halo_conv(g, flip_weights(w).contiguous(), halo, t, dim)
    if ctx.needs_input_grad[1]:
        # in w's dtype, as the reference's `d_w.astype(w.dtype)`
        d_w = halo_conv_dw(x, g, halo, t, dim).to(w.dtype)
    return d_x, d_w, None, None, None, None, None


halo_conv_op.register_autograd(_backward, setup_context=_setup_context)
