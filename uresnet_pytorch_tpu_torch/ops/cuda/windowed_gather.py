"""The tile-link gathers: row gathers between tile grids.

    windowed_gather: out[b, i] = src[b, idx[b, i]] where ok[b, i], else 0
    link_assemble:   per-fine-tile half-blocks (B, Tf, (t_c/2)^dim, C) ->
                     coarse tiles (B, Tc, t_c^dim, C), each coarse tile
                     pulling its 2^dim children's blocks into its octants
    link_parent:     coarse tiles (B, Tc, t_c^dim, C) -> per-fine-tile
                     corners (B, Tf, (t_c/2)^dim, C), each fine tile
                     pulling its own corner of its parent

The two link directions are each other's transposes over a down link
(`ops/tile_graph.py:TileDownLink`). Kernel A (`csrc/windowed_gather.cu`)
replaces the TPU kernel
`uresnet_pytorch_tpu/ops/pallas/windowed_gather.py:gather_forward`, which
moves rows as block one-hot matmuls over windows plus an exact correction
list, and the per-octant loops that the reference runs around it
(`uresnet_pytorch_tpu/ops/tile_conv.py:_assemble_impl`,
`_parent_corner_impl`). Hopper has native indexed loads, so the kernel
reads each source vector directly: each link direction is one launch over
every octant, written straight into its output, and the single-spec
gather is the same kernel with one octant. The `*_plain` functions are
the reference's loops in plain torch, which the kernel equals (the
parent's sum of disjoint octants turns a -0.0 into +0.0 where the kernel
copies it: equal under `torch.equal`). Each wrapper takes its plain
version for a CPU tensor and launches the kernel for a CUDA tensor, or
raises.
"""

from __future__ import annotations

import torch

from uresnet_pytorch_tpu_torch.ops import cuda

launches = 0   # kernel A launches, every entry point: a run went through it
launches_by_op = {"windowed_gather": 0, "link_assemble": 0, "link_parent": 0}

TILE_SIZES = (2, 4, 8)   # t_c the link kernels take, with dim 1-3


def windowed_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                          ok: torch.Tensor) -> torch.Tensor:
    """src (B, S, F), idx (B, N) int32, ok (B, N) bool -> (B, N, F).
    Rows whose idx lies outside [0, S) read as zeros, as in the kernel."""
    B, S, F = src.shape
    ok = ok & (idx >= 0) & (idx < S)
    rows = torch.where(ok, idx, 0).long()
    out = torch.gather(src, 1, rows[..., None].expand(B, rows.shape[1], F))
    return out.masked_fill_(~ok[..., None], 0)


def corner_view(xc: torch.Tensor, tc: int, dim: int) -> torch.Tensor:
    """(B, Tc, tc^dim, C) -> (B, Tc*2^dim, (tc/2)^dim * C): contiguous corner
    half-regions, corner bits x-major (matches the parent spec rows)."""
    B, Tc = xc.shape[:2]
    C = xc.shape[-1]
    th = tc // 2
    x = xc.reshape((B, Tc) + (2, th) * dim + (C,))
    perm = [0, 1] + [2 + 2 * d for d in range(dim)] \
        + [3 + 2 * d for d in range(dim)] + [2 + 2 * dim]
    return x.permute(perm).reshape(B, Tc * 2 ** dim, th ** dim * C)


def link_assemble_plain(blocks: torch.Tensor, link, t_c: int,
                        dim: int) -> torch.Tensor:
    """The reference's assemble: one gather per octant spec of
    `link.children` into a zeroed output, each written into its octant."""
    B, Tf, cells_h, C = blocks.shape
    th = t_c // 2
    flat = blocks.reshape(B, Tf, cells_h * C)
    Tc = link.children[0].idx.shape[1]
    out = blocks.new_zeros((B, Tc) + (t_c,) * dim + (C,))
    for o, spec in enumerate(link.children):
        obits = [(o >> (dim - 1 - d)) & 1 for d in range(dim)]
        g = windowed_gather_plain(flat, spec.idx, spec.ok).reshape(
            (B, Tc) + (th,) * dim + (C,))
        sl = (slice(None), slice(None)) + tuple(
            slice(bit * th, (bit + 1) * th) for bit in obits)
        out[sl] = g
    return out.reshape(B, Tc, t_c ** dim, C)


def link_parent_plain(xc: torch.Tensor, link, t_c: int,
                      dim: int) -> torch.Tensor:
    """The reference's parent gather: one gather per octant spec of
    `link.parents` from the coarse corner view; the specs have disjoint
    valid rows, so their results sum."""
    th = t_c // 2
    C = xc.shape[-1]
    cv = corner_view(xc, t_c, dim)
    out = None
    for spec in link.parents:
        g = windowed_gather_plain(cv, spec.idx, spec.ok)
        out = g if out is None else out + g
    B, Tf = out.shape[:2]
    return out.reshape(B, Tf, th ** dim, C)


def _check(name: str, src: torch.Tensor, idx, ok, want: tuple) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {src.device}")
    if idx is None or ok is None:
        raise ValueError(f"{name}: the link carries no stacked maps (an "
                         f"identity link moves nothing)")
    if tuple(idx.shape) != want or tuple(ok.shape) != want:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} / ok "
                         f"{tuple(ok.shape)}, expected {want} for src "
                         f"{tuple(src.shape)}")
    if idx.dtype != torch.int32 or ok.dtype != torch.bool:
        raise TypeError(f"{name}: idx must be int32 and ok bool")
    for what, t in (("src", src), ("idx", idx), ("ok", ok)):
        if t.device != src.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{src.device}")


def _check_geometry(name: str, t_c: int, dim: int) -> None:
    if t_c not in TILE_SIZES or dim not in (1, 2, 3):
        raise ValueError(f"{name}: the kernel takes t_c in {TILE_SIZES} and "
                         f"dim 1-3, got t_c={t_c}, dim={dim}")


def _launch(op: str, src, idx, ok, out, N: int, S: int, t_c: int,
            dim: int, counted: str = None) -> torch.Tensor:
    global launches
    if out.numel():
        with torch.cuda.device(src.device):
            err = getattr(cuda.library(), op)(
                src.data_ptr(), idx.data_ptr(), ok.data_ptr(),
                out.data_ptr(), src.shape[0], N, S,
                src.shape[-1] * src.element_size(), t_c.bit_length() - 1,
                dim, torch.cuda.current_stream().cuda_stream)
        cuda.check(err, op)
        launches += 1
        launches_by_op[counted or op] += 1
    return out


def windowed_gather(src: torch.Tensor, idx: torch.Tensor,
                    ok: torch.Tensor) -> torch.Tensor:
    """The single-spec gather on `src`'s device: the plain version for a
    CPU tensor, kernel A with one octant for a CUDA tensor."""
    if src.device.type == "cpu":
        return windowed_gather_plain(src, idx, ok)
    B, S, F = src.shape
    N = idx.shape[1]
    _check("windowed_gather", src, idx, ok, (B, N))
    out = torch.empty(B, N, F, dtype=src.dtype, device=src.device)
    # dim 0: one octant of one cell (t_c is then unused)
    return _launch("link_assemble", src, idx, ok, out, N, S, 2, 0,
                   counted="windowed_gather")


def link_assemble(blocks: torch.Tensor, link, t_c: int,
                  dim: int) -> torch.Tensor:
    """Half-blocks (B, Tf, (t_c/2)^dim, C) -> coarse tiles (B, Tc, t_c^dim,
    C) over a real down link: the plain version for a CPU tensor, one
    kernel-A launch over `link.cidx`/`link.cok` (B, 2^dim, Tc) for a CUDA
    tensor."""
    if blocks.device.type == "cpu":
        return link_assemble_plain(blocks, link, t_c, dim)
    _check_geometry("link_assemble", t_c, dim)
    B, Tf, cells_h, C = blocks.shape
    if cells_h != (t_c // 2) ** dim:
        raise ValueError(f"link_assemble: blocks {tuple(blocks.shape)} are "
                         f"not half-blocks of t_c={t_c}, dim={dim}")
    Tc = link.cidx.shape[-1] if link.cidx is not None else 0
    _check("link_assemble", blocks, link.cidx, link.cok, (B, 2 ** dim, Tc))
    out = torch.empty((B, Tc, t_c ** dim, C), dtype=blocks.dtype,
                      device=blocks.device)
    return _launch("link_assemble", blocks, link.cidx, link.cok, out, Tc, Tf,
                   t_c, dim)


def link_parent(xc: torch.Tensor, link, t_c: int, dim: int) -> torch.Tensor:
    """Coarse tiles (B, Tc, t_c^dim, C) -> each fine tile's corner of its
    parent (B, Tf, (t_c/2)^dim, C) over a real down link: the plain version
    for a CPU tensor, one kernel-A launch over `link.idx2`/`link.pok` (B,
    Tf) for a CUDA tensor."""
    if xc.device.type == "cpu":
        return link_parent_plain(xc, link, t_c, dim)
    _check_geometry("link_parent", t_c, dim)
    B, Tc, cells, C = xc.shape
    if cells != t_c ** dim:
        raise ValueError(f"link_parent: xc {tuple(xc.shape)} are not tiles "
                         f"of t_c={t_c}, dim={dim}")
    Tf = link.idx2.shape[-1] if link.idx2 is not None else 0
    _check("link_parent", xc, link.idx2, link.pok, (B, Tf))
    out = torch.empty((B, Tf, (t_c // 2) ** dim, C), dtype=xc.dtype,
                      device=xc.device)
    return _launch("link_parent", xc, link.idx2, link.pok, out, Tf, Tc, t_c,
                   dim)
