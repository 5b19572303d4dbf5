"""Tiled-dense sparse convolutions: halo'd submanifold convs, tile-link
gathers and the space-to-depth fold of the stride-2 convs.

Port of `uresnet_pytorch_tpu/ops/tile_conv.py`. The hot ops are the
kernel wrappers of `ops/cuda/`: on a CPU tensor a wrapper runs its plain
torch version, on a CUDA tensor the hand-written kernel. `chip_smoke.py`
puts the plain versions in place of the wrappers to run the same model as
reference on the card.

Two conv paths, chosen per conv by `USE_FUSED` and a static shape rule.
The reference (`tile_conv.py:194-302`) sends every bfloat16 conv on the
TPU to its Pallas kernels, whatever the widths: its raw conv chunks any
Cin and takes any Cout, and where its epilogue-fused variant declines a
shape it runs that raw Pallas conv and the epilogue in XLA. Only float32
(or a backend other than the TPU) takes XLA's halo extend and conv. The
port follows it. Fused: inference runs a submanifold conv with its
epilogue in kernel B, and training runs the raw conv through
`halo_conv_op`, whose gradient is kernels B (d_x) and C (d_W). Kernels B
and C take bfloat16 and the shapes they plan for (`kernel_plan` in
`ops/cuda/halo_conv.py`, `dw_plan` in `ops/cuda/halo_conv_dw.py`). On
the card float32, and a shape with no plan, take the unfused path: the
halo extend (kernel D, gradient kernel E, any width), one VALID conv over
the extended tiles, and the epilogue in torch. Data moves between levels
through the two link gathers, each the other's transpose, so the
backward gathers too and never scatters. All ops keep the submanifold
invariant: inactive cells hold exact zeros.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv import (
    halo_conv, halo_conv_op, kernel_plan)
from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv_dw import dw_plan
from uresnet_pytorch_tpu_torch.ops.cuda.halo_extend import halo26_extend_op
from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
    link_assemble, link_parent)
from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec


# ---------------------------------------------------------------------------
# space-to-depth fold
# ---------------------------------------------------------------------------

def fold2(x: torch.Tensor) -> torch.Tensor:
    """(B, T, *spatial(even), C) -> (B, T, *spatial/2, 2^dim*C); block bits
    x-major over channels."""
    B, T = x.shape[:2]
    sp = x.shape[2:-1]
    C = x.shape[-1]
    dim = len(sp)
    shape = (B, T)
    for s in sp:
        shape += (s // 2, 2)
    x = x.reshape(shape + (C,))
    perm = [0, 1] + [2 + 2 * d for d in range(dim)] \
        + [3 + 2 * d for d in range(dim)] + [2 + 2 * dim]
    return x.permute(perm).reshape(
        (B, T) + tuple(s // 2 for s in sp) + (2 ** dim * C,))


def unfold2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fold2."""
    B, T = x.shape[:2]
    sp = x.shape[2:-1]
    dim = len(sp)
    C = x.shape[-1] // (2 ** dim)
    x = x.reshape((B, T) + tuple(sp) + (2,) * dim + (C,))
    perm = [0, 1]
    for d in range(dim):
        perm += [2 + d, 2 + dim + d]
    perm += [2 + 2 * dim]
    return x.permute(perm).reshape(
        (B, T) + tuple(2 * s for s in sp) + (C,))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

# None = auto: on the card, the fused path wherever its kernels plan the
# conv (`_fused`), else the unfused one, which takes every width and dtype
# (the reference's rule: f32 keeps its exact halo + conv path). On the CPU
# auto runs kernel B's plain version for every shape and dtype. Tests and
# chip_smoke.py force a path by setting this; forced True on a conv the
# kernels refuse raises in their wrappers.
USE_FUSED = None


def _fused(x: torch.Tensor, t: int, dim: int, Cout: int, dx: bool = False,
           dw: bool = False) -> bool:
    """Whether a conv of x (.., Cin) to Cout channels takes the fused path:
    on the card, where x is bfloat16 and kernel B plans the conv (Cin ->
    Cout), and, where a gradient flows, kernel B its d_x (the flipped
    stencil, Cout -> Cin) and kernel C its d_W: the reference's TPU rule,
    which sends every bfloat16 conv to its Pallas kernels. Decided from
    the shapes alone, before any launch."""
    if USE_FUSED is not None:
        return USE_FUSED
    if x.device.type != "cuda":
        return True
    Cin = x.shape[-1]
    return (x.dtype == torch.bfloat16
            and kernel_plan(t, dim, Cin, Cout) is not None
            and not (dx and kernel_plan(t, dim, Cout, Cin) is None)
            and not (dw and dw_plan(t, dim, Cin, Cout) is None))


def kernel_extent(w, dim: int) -> int:
    """The edge k of a stencil weight (k^dim, Cin, Cout): 3 for the
    submanifold convs, 5 for a 5^dim stem."""
    k = round(w.shape[0] ** (1.0 / dim))
    if k ** dim != w.shape[0] or k % 2 == 0:
        raise ValueError(f"a stencil weight of {w.shape[0]} offsets is no "
                         f"odd k^{dim}")
    return k


def _valid_conv(ext: torch.Tensor, w, t: int, dim: int,
                k: int = 3) -> torch.Tensor:
    """One k^dim VALID conv over halo-extended tiles (B, T, (t+k-1)^dim,
    Cin) -> (B, T, t^dim, Cout), in ext's dtype with f32 sums: the
    reference's `lax.conv_general_dilated` (`tile_conv.py:251`), here a
    torch conv on a channels-last view. w is (k^dim, Cin, Cout), offsets
    row-major over (-k//2 .. k//2)^dim. In float32 it runs without TF32,
    as the reference's f32 conv; the flag is set around this call only, so
    a backward through it follows the caller's setting."""
    B, T, _, Cin = ext.shape
    Cout = w.shape[-1]
    xin = ext.reshape((B * T,) + (t + k - 1,) * dim + (Cin,)).movedim(-1, 1)
    fmt = torch.channels_last_3d if dim == 3 else torch.channels_last
    kern = w.to(ext.dtype).reshape((k,) * dim + (Cin, Cout)).permute(
        (dim + 1, dim) + tuple(range(dim))).contiguous(memory_format=fmt)
    conv = F.conv3d if dim == 3 else F.conv2d
    cudnn = torch.backends.cudnn
    ctx = cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                      deterministic=cudnn.deterministic, allow_tf32=False) \
        if ext.dtype == torch.float32 else contextlib.nullcontext()
    with ctx:
        y = conv(xin, kern)
    return y.movedim(1, -1).reshape(B, T, t ** dim, Cout)


def submanifold_conv_tiled(x, occ, halo: Halo26Spec, t: int, dim: int,
                           w) -> torch.Tensor:
    """x (B,T,t^dim,Cin), occ (B,T,t^dim) -> (B,T,t^dim,Cout), masked by
    occupancy, with a gradient.

    Fused (`_fused`): `halo_conv_op`, kernel B with kernels B and C as
    its gradient. Unfused: the halo-extended tiles (`halo26_extend_op`,
    kernel D, whose gradient is kernel E), then one VALID conv over them.

    x may be a pair (x1, x2) standing for their channel concat (the
    decoder's skip): the conv is linear in Cin, so the pair runs as two
    convs against the matching row slices of w, summed in f32 and rounded
    once, with no (B, T, cells, C1 + C2) concat in memory.

    A stencil wider than 3^dim (w (5^dim, Cin, Cout): MinkUNet's stem)
    always takes the unfused path, its extend at a halo of 2: kernels B
    and C plan the 3^dim stencil only."""
    if isinstance(x, tuple):
        x1, x2 = x
        C1 = x1.shape[-1]
        o1 = submanifold_conv_tiled(x1, occ, halo, t, dim, w[:, :C1])
        o2 = submanifold_conv_tiled(x2, occ, halo, t, dim, w[:, C1:])
        return (o1.float() + o2.float()).to(o1.dtype)
    grad = torch.is_grad_enabled()
    k = kernel_extent(w, dim)
    if k != 3:
        ext = halo26_extend_op(x.contiguous(), halo.idx, halo.ok, t, dim,
                               k // 2)
        out = _valid_conv(ext, w, t, dim, k)
    elif _fused(x, t, dim, w.shape[-1], dx=grad and x.requires_grad,
                dw=grad and w.requires_grad):
        out = halo_conv_op(x.contiguous(), w.to(x.dtype).contiguous(),
                           halo.idx, halo.ok, halo.blive, t, dim)
    else:
        ext = halo26_extend_op(x.contiguous(), halo.idx, halo.ok, t, dim)
        out = _valid_conv(ext, w, t, dim)
    return out * occ[..., None].to(out.dtype)


def submanifold_conv_bn_act_tiled(x, occ, halo: Halo26Spec, t: int, dim: int,
                                  w, a, b, alpha: float, mask) -> torch.Tensor:
    """Inference: mask * leaky_alpha(conv(x) * a + b). An identity affine
    (a=1, b=0, alpha=1) gives conv + occupancy mask.

    Fused: one kernel (B with its epilogue); `occ` is unused there (the
    mask carries it). Unfused: `submanifold_conv_tiled`, then the
    reference's epilogue (`tile_conv.py:299-302`) in the conv's dtype."""
    if _fused(x, t, dim, w.shape[-1]):
        return halo_conv(x.contiguous(), w.to(x.dtype).contiguous(), halo, t,
                         dim, a=a.float().contiguous(),
                         b=b.float().contiguous(), alpha=alpha,
                         mask=mask.contiguous())
    y = submanifold_conv_tiled(x, occ, halo, t, dim, w)
    z = y * a.to(y.dtype) + b.to(y.dtype)
    # alpha in the conv's dtype, as the reference's asarray(alpha, z.dtype)
    z = torch.where(z >= 0, z, z.new_tensor(alpha) * z)
    return z * mask[..., None].to(z.dtype)


def _assemble_impl(blocks: torch.Tensor, link, t_c: int,
                   dim: int) -> torch.Tensor:
    """Per-fine-tile half-blocks (B, Tf, (t_c/2)^dim, C) -> coarse tiles
    (B, Tc, t_c^dim, C): each coarse tile pulls its children's blocks into
    its octants (kernel A, one launch for every octant)."""
    return link_assemble(blocks, link, t_c, dim)


def _parent_corner_impl(xc: torch.Tensor, link, t_c: int,
                        dim: int) -> torch.Tensor:
    """(B, Tc, t_c^dim, C) coarse tiles -> (B, Tf, (t_c/2)^dim, C): each
    fine tile pulls its corner of its parent (kernel A, one launch)."""
    return link_parent(xc, link, t_c, dim)


def assemble_children(blocks: torch.Tensor, link, t_c: int,
                      dim: int) -> torch.Tensor:
    """`_assemble_impl` over `link`; an identity link returns the blocks.
    No gradient: the graph build's occupancy."""
    if len(link.children) == 1:
        return blocks
    return _assemble_impl(blocks, link, t_c, dim)


class _AssembleChildrenLink(torch.autograd.Function):
    """`_assemble_impl` over a real link, whose transpose is the parent
    gather: a down link is injective (every fine tile has one (parent,
    octant)), so the adjoint of the children gather is the parent-corner
    gather, and the backward never scatters."""

    @staticmethod
    def forward(ctx, blocks, link, t_c, dim):
        ctx.link, ctx.t_c, ctx.dim = link, t_c, dim
        return _assemble_impl(blocks, link, t_c, dim)

    @staticmethod
    def backward(ctx, g):
        return (_parent_corner_impl(g.contiguous(), ctx.link, ctx.t_c,
                                    ctx.dim), None, None, None)


class _ParentCornerLink(torch.autograd.Function):
    """`_parent_corner_impl`, whose transpose is the children gather."""

    @staticmethod
    def forward(ctx, xc, link, t_c, dim):
        ctx.link, ctx.t_c, ctx.dim = link, t_c, dim
        return _parent_corner_impl(xc, link, t_c, dim)

    @staticmethod
    def backward(ctx, g):
        return (_assemble_impl(g.contiguous(), ctx.link, ctx.t_c, ctx.dim),
                None, None, None)


def downsample_conv_tiled(x, link, t_f: int, t_c: int, dim: int,
                          w) -> torch.Tensor:
    """Stride-2 kernel-2 conv between tile grids.

    x (B,Tf,t_f^dim,Cin), w (2^dim,Cin,Cout) -> (B,Tc,t_c^dim,Cout). The
    fold GEMM sums in f32 and rounds once, as the reference's einsum."""
    dt = x.dtype
    B, Tf = x.shape[:2]
    Cin, Cout = w.shape[1], w.shape[2]
    xs = x.reshape((B, Tf) + (t_f,) * dim + (Cin,))
    xf = fold2(xs).reshape(B, Tf, (t_f // 2) ** dim, 2 ** dim * Cin)
    wd = w.reshape(2 ** dim * Cin, Cout).to(dt)
    blocks = torch.matmul(xf.float(), wd.float()).to(dt)
    if len(link.children) == 1:
        return blocks
    return _AssembleChildrenLink.apply(blocks, link, t_c, dim)


def upsample_conv_tiled(xc, link, occ_f, t_f: int, t_c: int, dim: int,
                        w) -> torch.Tensor:
    """Stride-2 kernel-2 transposed conv (decoder) over the down link, so
    the encoder's exact sites come back.

    xc (B,Tc,t_c^dim,Cin) -> (B,Tf,t_f^dim,Cout), masked by fine occupancy."""
    dt = xc.dtype
    Cin, Cout = w.shape[1], w.shape[2]
    th = t_f // 2
    if len(link.children) == 1:
        # identity link: each whole coarse tile is the fine tile's half-block
        B, Tf = xc.shape[:2]
        blocks = xc.reshape(B, Tf, th ** dim, Cin)
    else:
        blocks = _ParentCornerLink.apply(xc, link, t_c, dim)
        B, Tf = blocks.shape[:2]
    wu = w.permute(1, 0, 2).reshape(Cin, 2 ** dim * Cout).to(dt)
    outf = torch.matmul(blocks.float(), wu.float()).to(dt)
    outf = outf.reshape((B, Tf) + (th,) * dim + (2 ** dim * Cout,))
    out = unfold2(outf).reshape(B, Tf, t_f ** dim, Cout)
    return out * occ_f[..., None].to(dt)
