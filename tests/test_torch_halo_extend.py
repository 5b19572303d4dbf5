"""The port's standalone halo extend and its transpose (plain torch
versions of kernels D and E, uresnet_pytorch_tpu_torch/ops/halo.py and
ops/cuda/halo_extend.py) against the JAX reference.

Specs come from the same sorted keys through both packages' build_halo26,
inputs from a numpy seed (B=2, T=64). The port's plain transpose equals
`halo26_transpose_xla` bitwise in f32 and within 1 bf16 ulp (of the summed
terms) in bf16. Both plain functions are held to the reference's Pallas
kernels `halo26_fwd` / `halo26_bwd` in interpret mode, as
tests/test_halo_kernel.py runs them (bf16 forward bitwise, f32 forward at
atol 1e-5, backward within 1 bf16 ulp), one case on a spec whose tiny
windows force the reference's correction path. The operator's gradient is
held to `jax.vjp` of the reference's custom-VJP `halo26_extend`. The CUDA
kernels themselves are checked against these plain versions, bitwise, on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_halo26 import _random_level, _zero_dead
from uresnet_pytorch_tpu.ops import halo as jhalo
from uresnet_pytorch_tpu.ops.pallas.halo_fused import (halo26_bwd as
                                                       j_halo26_bwd)
from uresnet_pytorch_tpu.ops.pallas.halo_fused import (halo26_fwd as
                                                       j_halo26_fwd)
from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he
from uresnet_pytorch_tpu_torch.ops.halo import (Halo26Spec, build_halo26,
                                                halo26_extend,
                                                halo26_transpose)
from tests.test_torch_model import one_torch_thread  # noqa: F401

B, T = 2, 64
_GRID = {2: 16, 3: 8}


def _case(dim, seed, live=40, **kw):
    """keys (B, T) with `live` tiles per event, the reference's and the
    port's specs of them."""
    rng = np.random.default_rng(seed)
    G = _GRID[dim]
    keys = np.stack([np.asarray(_random_level(rng, G, dim, T, live)[0])
                     for _ in range(B)])
    jspec = jax.vmap(lambda k: jhalo.build_halo26(k, G, dim, **kw))(
        jnp.asarray(keys))
    return rng, keys, jspec, build_halo26(torch.from_numpy(keys), G, dim)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significand bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _within_ulp(out, ref, g, spec, t, dim):
    """|out - ref| <= one bf16 ulp of the summed magnitudes of the terms
    (the transpose of |g|): where the sum cancels, a different order of
    rounded adds moves it by an ulp of its terms, not of the result."""
    scale = halo26_transpose(torch.from_numpy(np.abs(g)), spec, t,
                             dim).numpy()
    assert (np.abs(out - ref) <= _bf16_ulp(scale)).all()


def _bf16(v):
    """v rounded to bf16, as f32."""
    return torch.from_numpy(v).bfloat16().float().numpy()


SHAPES = [(dim, t, C) for dim in (2, 3) for t in (2, 4) for C in (1, 3, 16)]


@pytest.mark.parametrize("dim,t,C", SHAPES)
def test_plain_transpose_matches_xla(dim, t, C):
    rng, _, jspec, spec = _case(dim, seed=10 * dim + t + C)
    g = rng.normal(size=(B, T, (t + 2) ** dim, C)).astype(np.float32)
    ref = np.asarray(jhalo.halo26_transpose_xla(jnp.asarray(g), jspec, t,
                                                dim))
    out = halo26_transpose(torch.from_numpy(g), spec, t, dim)
    assert out.dtype == torch.float32 and out.shape == (B, T, t ** dim, C)
    np.testing.assert_array_equal(out.numpy(), ref)
    refb = np.asarray(jhalo.halo26_transpose_xla(
        jnp.asarray(g).astype(jnp.bfloat16), jspec, t, dim)
        .astype(jnp.float32))
    outb = halo26_transpose(torch.from_numpy(g).bfloat16(), spec, t, dim)
    assert outb.dtype == torch.bfloat16
    _within_ulp(outb.float().numpy(), refb, _bf16(g), spec, t, dim)


PALLAS = [  # dim, t, C, build_halo26 kwargs
    pytest.param(3, 4, 16, {}, id="t4-c16"),
    pytest.param(3, 2, 3, {}, id="t2-c3"),
    pytest.param(3, 4, 3, dict(block=8, win_mult=1), id="t4-c3-corrections"),
]


@pytest.mark.parametrize("dim,t,C,kw", PALLAS)
def test_plain_matches_pallas_interpret(dim, t, C, kw):
    rng, keys, jspec, spec = _case(dim, seed=t + C, live=48, **kw)
    if kw:
        # the reference's windows miss neighbors: its correction list runs
        assert int(np.asarray(jspec.corr_ok).sum()) > 0
        assert int(np.asarray(jspec.overflow).sum()) == 0
    # dead rows zero, the production invariant the reference's liveness
    # gate relies on (tests/test_halo_kernel.py)
    x = np.asarray(_zero_dead(jnp.asarray(rng.normal(
        size=(B, T, t ** dim, C)).astype(np.float32)), keys))
    g = np.asarray(_zero_dead(jnp.asarray(rng.normal(
        size=(B, T, (t + 2) ** dim, C)).astype(np.float32)), keys))
    ref = j_halo26_fwd(jnp.asarray(x).astype(jnp.bfloat16), jspec, t, dim,
                       interpret=True)
    out = halo26_extend(torch.from_numpy(x).bfloat16(), spec, t, dim)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    ref = j_halo26_fwd(jnp.asarray(x), jspec, t, dim, interpret=True)
    np.testing.assert_allclose(
        halo26_extend(torch.from_numpy(x), spec, t, dim).numpy(),
        np.asarray(ref), atol=1e-5, rtol=0)
    ref = j_halo26_bwd(jnp.asarray(g).astype(jnp.bfloat16), jspec, t, dim,
                       interpret=True)
    out = halo26_transpose(torch.from_numpy(g).bfloat16(), spec, t, dim)
    _within_ulp(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                _bf16(g), spec, t, dim)


@pytest.mark.parametrize("dim,t", [(2, 4), (3, 2), (3, 4)])
def test_transpose_is_the_adjoint(dim, t):
    """<D x, g> = <x, E g> in float64, dead rows included."""
    rng, _, _, spec = _case(dim, seed=7 + t)
    x = rng.normal(size=(B, T, t ** dim, 5))
    g = rng.normal(size=(B, T, (t + 2) ** dim, 5))
    lhs = float((halo26_extend(torch.from_numpy(x), spec, t, dim).numpy()
                 * g).sum())
    rhs = float((x * halo26_transpose(torch.from_numpy(g), spec, t,
                                      dim).numpy()).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("dim,t,C", [(3, 4, 3), (2, 2, 1)])
def test_extend_op_gradient_matches_jax_vjp(dim, t, C):
    """`halo26_extend_op` and its registered gradient (the transpose)
    against the reference's custom-VJP `halo26_extend`, f32."""
    rng, _, jspec, spec = _case(dim, seed=3 + C)
    x = rng.normal(size=(B, T, t ** dim, C)).astype(np.float32)
    ct = rng.normal(size=(B, T, (t + 2) ** dim, C)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jhalo.halo26_extend(v, jspec, t, dim),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = he.halo26_extend_op(xt, spec.idx, spec.ok, t, dim)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               rtol=1e-6, atol=1e-6)
    # an input that needs no gradient (the stem's) leaves no backward
    assert not he.halo26_extend_op(torch.from_numpy(x), spec.idx, spec.ok,
                                   t, dim).requires_grad


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the wrappers'
    checks without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("wrapper", [he.halo26_fwd, he.halo26_bwd])
def test_wrappers_refuse_bad_inputs(wrapper):
    """A tensor off the CPU goes to the kernel, which refuses a device mix,
    wrong shapes and types, and tile sizes it has no tables for; no case
    falls back to the plain version."""
    _, _, _, spec = _case(3, seed=1)
    t = 4
    cells = t ** 3 if wrapper is he.halo26_fwd else (t + 2) ** 3
    card = torch.zeros(B, T, cells, 8).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="idx must be contiguous on cuda"):
        wrapper(card, spec, t, 3)                        # maps on the CPU
    idx, ok = spec.idx.as_subclass(_OnCard), spec.ok.as_subclass(_OnCard)
    with pytest.raises(ValueError, match="does not fit"):
        wrapper(card, Halo26Spec(idx, ok, None, None), 2, 3)   # cells vs t
    with pytest.raises(ValueError, match="does not fit"):
        wrapper(torch.zeros(B, T, 3 ** 3, 8).as_subclass(_OnCard),
                Halo26Spec(idx, ok, None, None), 3, 3)   # no table for t=3
    with pytest.raises(ValueError, match="idx is"):
        wrapper(card, Halo26Spec(idx[:, 1:], ok, None, None), t, 3)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        wrapper(card.half(), Halo26Spec(idx, ok, None, None), t, 3)
    with pytest.raises(ValueError, match="unsupported device meta"):
        wrapper(torch.zeros(B, T, cells, 8, device="meta"), spec, t, 3)


# -- the kernels' work split (ops/cuda/halo_extend.py: extend_plan and
# extend_table), rebuilt in torch as csrc/halo_extend.cu runs it --------

def _nbr(spec, rows, k, T, dim):
    """The kernel's shared neighbor table: the absolute source row of full
    stencil offset k for each tile row (the row itself at the center), -1
    where the neighbor is missing."""
    center = 3 ** dim // 2
    b, j = rows // T, rows % T
    if k == center:
        return rows
    m = k if k < center else k - 1
    cand = spec.idx[b, m, j].long()
    live = spec.ok[b, m, j] & (cand >= 0) & (cand < T)
    return torch.where(live, b * T + cand, -1)


def _emulate(kernel, a, spec, t, dim, plan, h=1):
    """(output, stores of each output unit) of kernel D ("d", a = x) or E
    ("e", a = g) at halo width h following `plan` step by step: blocks of
    plan.tiles tile rows, THREADS threads each taking plan.pieces pieces
    THREADS apart per step, a piece's per_piece units of vec bytes, each
    unit's value from the table, the neighbor rows and the input (E: the
    body, then the table's terms in order, added in a's dtype)."""
    B, T, _, C = a.shape
    item = a.element_size()
    cells, ecells = t ** dim, (t + 2 * h) ** dim
    cells_out = ecells if kernel == "d" else cells
    nvec = C * item // plan.vec
    units = cells_out * nvec
    assert units % plan.per_piece == 0
    pieces = units // plan.per_piece
    assert pieces * plan.store == cells_out * C * item
    total = plan.tiles * pieces
    # the block's loop: p0 = tid, tid + THREADS * P, ...; piece p0 + q *
    # THREADS for q < P; p < total live
    steps = -(-total // (he.THREADS * plan.pieces))
    p = (torch.arange(he.THREADS)[:, None, None]
         + torch.arange(steps)[None, :, None] * he.THREADS * plan.pieces
         + torch.arange(plan.pieces)[None, None, :] * he.THREADS).flatten()
    p = p[p < total]
    blocks = -(-B * T // plan.tiles)
    row = (torch.arange(blocks)[:, None] * plan.tiles
           + p[None] // pieces).flatten()
    pc = (p % pieces).repeat(blocks)
    keep = row < B * T
    row, pc = row[keep], pc[keep]
    u = (pc[:, None] * plan.per_piece
         + torch.arange(plan.per_piece)[None]).flatten()
    row = row.repeat_interleave(plan.per_piece)
    cell, v = u // nvec, u % nvec
    per = plan.vec // item                     # values a unit
    src = a.reshape(B * T, -1, nvec, per)
    tab = torch.from_numpy(he.extend_table(kernel, t, dim, h).astype(
        np.int64))

    def unit(rows, c):
        got = src[rows.clamp(min=0), torch.where(rows >= 0, c, 0), v]
        return torch.where((rows >= 0)[:, None], got, torch.zeros_like(got))

    def nbr(k):
        return torch.stack([_nbr(spec, row, kk, T, dim)
                            for kk in range(3 ** dim)])[k, torch.arange(
                                len(row))]

    if kernel == "d":
        code = tab[cell]
        val = unit(nbr(code >> 10), code & 1023)
    else:
        w = tab[cell]                             # (units, width)
        val = unit(row, w[:, 0] & 1023)
        for k in range(1, tab.shape[1]):
            term = k <= w[:, 0] >> 10             # the unit's n slab terms
            r = torch.where(term, nbr(torch.where(term, w[:, k] >> 10, 0)),
                            -1)
            val = torch.where(term[:, None], val + unit(r, w[:, k] & 1023),
                              val)
    out = torch.zeros(B * T, cells_out, nvec, per, dtype=a.dtype)
    writes = torch.zeros(B * T, cells_out, nvec, dtype=torch.long)
    out[row, cell, v] = val
    writes.index_put_((row, cell, v), torch.ones_like(row), accumulate=True)
    return out.reshape(B, T, cells_out, C), writes


def _spec(dim, seed, live=40):
    rng = np.random.default_rng(seed)
    keys = np.stack([np.asarray(_random_level(rng, _GRID[dim], dim, T,
                                              live)[0]) for _ in range(B)])
    return rng, build_halo26(torch.from_numpy(keys), _GRID[dim], dim)


SPLITS = ([(t, dim, C, torch.bfloat16, 16) for t in (2, 4, 8)
           for dim in (2, 3) for C in (1, 2, 3, 12, 16, 48, 80)]
          + [(t, dim, C, torch.float32, 16) for t in (2, 4, 8)
             for dim in (2, 3) for C in (1, 3, 16)]
          # an input whose address allows only narrower loads
          + [(4, 3, 16, torch.bfloat16, 4), (2, 3, 80, torch.bfloat16, 2),
             (2, 2, 12, torch.float32, 8)])


@pytest.mark.parametrize("t,dim,C,dtype,align", SPLITS)
def test_work_split_writes_once_and_matches_plain(t, dim, C, dtype, align):
    """Kernels D and E as extend_plan splits them and extend_table maps
    them write every output element exactly once, with the plain
    versions' values bit for bit (dead rows included): E's terms come in
    the plain version's order, a missing neighbor adding +0.0."""
    rng, spec = _spec(dim, seed=t * 100 + dim * 10 + C)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    for kernel, cells_in, plain in (("d", t ** dim, halo26_extend),
                                    ("e", (t + 2) ** dim, halo26_transpose)):
        a = torch.from_numpy(rng.normal(
            size=(B, T, cells_in, C)).astype(np.float32)).to(dtype)
        a[a.abs() < 0.3] = -0.0        # -0.0 + 0.0 must give +0.0
        plan = he.extend_plan(kernel, t, dim, C * a.element_size(), align)
        assert plan.store <= 16 and plan.store % plan.vec == 0
        assert align % plan.vec == 0 and (C * a.element_size()) % plan.vec \
            == 0
        out, writes = _emulate(kernel, a, spec, t, dim, plan)
        assert bool((writes == 1).all()), f"{kernel}: {plan}"
        assert torch.equal(out.view(ints), plain(a, spec, t, dim).view(ints))


def _dispatched(kernel):
    """The (vec, per_piece) pairs csrc/halo_extend.cu instantiates for
    kernel D ("d") or E ("e", one unit a piece)."""
    import re
    from pathlib import Path
    src = (Path(he.__file__).parents[2] / "csrc" / "halo_extend.cu") \
        .read_text()
    body = src.split(f"#define {kernel.upper()}_PLANS(X)", 1)[1] \
        .split("\n\n", 1)[0].split("\n//", 1)[0]
    return {(int(m[0]), int(m[1] or 1)) for m in
            re.findall(r"X\((\d+)(?:, (\d+))?\)", body)}


@pytest.mark.parametrize("kernel", ["d", "e"])
def test_every_plan_has_a_kernel(kernel):
    """Each split extend_plan can return is one the kernel instantiates,
    with the pieces a thread its dispatch expects."""
    pairs = _dispatched(kernel)
    assert len(pairs) == (10 if kernel == "d" else 4)
    for h, t in [(h, t) for h, sizes in he.TILE_SIZES_BY_HALO.items()
                 for t in sizes]:
        for dim in (2, 3):
            for row_bytes in range(2, 330, 2):
                for align in (2, 4, 8, 16):
                    plan = he.extend_plan(kernel, t, dim, row_bytes, align,
                                          h=h)
                    assert (plan.vec, plan.per_piece) in pairs
                    m = plan.per_piece
                    want = max(1, 4 // m) if kernel == "d" else 1
                    assert plan.pieces == want
                    assert 1 <= plan.tiles <= he.MAX_TILES


# -- a halo of 2: the 5^dim stencil's extend (MinkUNet34C's stem) -----------

def _dense_level(dim, t, seed, live=40):
    """A level of `live` tiles among 64 (so most tiles have neighbors on
    every side), its spec and tile coordinates, and random rows on every
    cell of its live tiles (0 on dead rows)."""
    from uresnet_pytorch_tpu_torch.ops.coords import decode
    G = {2: 8, 3: 4}[dim]
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(np.stack([np.asarray(_random_level(
        rng, G, dim, T, live)[0]) for _ in range(B)]))
    spec = build_halo26(keys, G, dim)
    x = torch.from_numpy(rng.normal(size=(B, T, t ** dim, 3)))
    x[~spec.blive] = 0.0
    return spec, decode(keys, G, dim).long(), x


def _direct_map(spec, coords, t, dim, h):
    """(b, tile, ext cell) -> (b, tile, cell) by direct lookup: ext cell e
    of a live tile (offsets -h .. t+h-1 from its origin along each axis)
    shows the cell of whichever live tile covers that global position."""
    import itertools
    E = t + 2 * h
    pairs = []
    for b in range(B):
        live = spec.blive[b].nonzero()[:, 0].tolist()
        where = {tuple(coords[b, j].tolist()): j for j in live}
        for j in live:
            for ei, e in enumerate(itertools.product(range(E), repeat=dim)):
                g = [int(coords[b, j, a]) * t + e[a] - h for a in range(dim)]
                tile = tuple(v // t for v in g)
                if tile in where:
                    cell = 0
                    for v in g:
                        cell = cell * t + v % t
                    pairs.append((b, j, ei, where[tile], cell))
    return torch.tensor(pairs)


@pytest.mark.parametrize("dim,t", [(3, 2), (3, 4), (2, 2), (2, 4)])
def test_halo2_extend_and_transpose_against_a_direct_gather(dim, t):
    """At a halo of 2 every live tile's extended cells hold the cells 1 and
    2 deep into its face, edge and corner neighbors (2 <= t: the same 26
    neighbors), zeros where none is live; the transpose adds each extended
    cell's cotangent back to its source cell, exactly (f64)."""
    spec, coords, x = _dense_level(dim, t, seed=31 * t + dim)
    h = 2
    ext = halo26_extend(x, spec, t, dim, h)
    assert ext.shape == (B, T, (t + 2 * h) ** dim, 3)
    m = _direct_map(spec, coords, t, dim, h)
    want = torch.zeros_like(ext)
    want[m[:, 0], m[:, 1], m[:, 2]] = x[m[:, 0], m[:, 3], m[:, 4]]
    live = spec.blive
    assert torch.equal(ext[live], want[live])
    g = torch.from_numpy(np.random.default_rng(7).normal(size=ext.shape))
    g[~live] = 0.0
    d_x = halo26_transpose(g, spec, t, dim, h)
    want_dx = torch.zeros_like(x).index_put_(
        (m[:, 0], m[:, 3], m[:, 4]), g[m[:, 0], m[:, 1], m[:, 2]],
        accumulate=True)
    torch.testing.assert_close(d_x[live], want_dx[live], rtol=1e-12,
                               atol=1e-12)
    # the halo of 1 is unchanged: the default
    assert torch.equal(halo26_extend(x, spec, t, dim),
                       halo26_extend(x, spec, t, dim, 1))


SPLITS_H2 = ([(t, dim, C, torch.bfloat16) for t in (2, 4) for dim in (2, 3)
              for C in (1, 3, 32)]
             + [(t, dim, C, torch.float32) for t in (2, 4) for dim in (2, 3)
                for C in (1, 32)])


@pytest.mark.parametrize("t,dim,C,dtype", SPLITS_H2)
def test_halo2_work_split_writes_once_and_matches_plain(t, dim, C, dtype):
    """Kernels D and E at a halo of 2 as extend_plan splits them and
    extend_table maps them (E's table 32 entries a cell at t = 2, where a
    cell lies in all 26 slabs) write every output element once, bitwise
    the plain versions'."""
    h = 2
    rng, spec = _spec(dim, seed=200 + t * 10 + dim + C)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
    assert he.extend_table("e", t, dim, h).shape[1] == \
        he.table_width(t, dim, h) == (32 if t == 2 else 8)
    for kernel, cells_in, plain in (
            ("d", t ** dim, halo26_extend),
            ("e", (t + 2 * h) ** dim, halo26_transpose)):
        a = torch.from_numpy(rng.normal(
            size=(B, T, cells_in, C)).astype(np.float32)).to(dtype)
        a[a.abs() < 0.3] = -0.0
        plan = he.extend_plan(kernel, t, dim, C * a.element_size(), h=h)
        out, writes = _emulate(kernel, a, spec, t, dim, plan, h)
        assert bool((writes == 1).all()), f"{kernel}: {plan}"
        assert torch.equal(out.view(ints),
                           plain(a, spec, t, dim, h).view(ints))


def test_table_width_holds_every_slab():
    """E's table has room for each cell's body entry and all its slab
    terms at every tile size and halo the kernels take, and D's and E's
    tables at a halo of 1 are those of the default."""
    for h, sizes in he.TILE_SIZES_BY_HALO.items():
        for t in sizes:
            for dim in (2, 3):
                tab = he.extend_table("e", t, dim, h)
                n = tab[:, 0].astype(np.int64) >> 10
                assert tab.shape[1] == he.table_width(t, dim, h)
                assert int(n.max()) + 1 <= tab.shape[1]
                assert int(n.max()) == (3 ** dim - 1 if 2 * h > t
                                        else 2 ** dim - 1)
    for kernel in ("d", "e"):
        assert np.array_equal(he.extend_table(kernel, 4, 3),
                              he.extend_table(kernel, 4, 3, 1))


def test_5cubed_tiled_conv_matches_the_125_offset_conv():
    """A 5^3 submanifold conv on the tiles (the halo-2 extend and one VALID
    conv, `submanifold_conv_tiled` on a (125, Cin, Cout) weight) equals the
    plain reference's conv offset by offset over the active sites
    (tests/plain_minkunet.py), at every active cell, in f64 to 1e-12."""
    from tests import plain_minkunet as pm
    from tests.test_torch_train import _blob
    from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
    from uresnet_pytorch_tpu_torch.ops.coords import decode
    from uresnet_pytorch_tpu_torch.ops.tile_conv import \
        submanifold_conv_tiled
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    cfg = TConfig(spatial_size=32, uresnet_num_strides=2, max_voxels=512,
                  min_level_capacity=64, tile_size=4, tile_sizes=(4, 2),
                  compute_dtype="float32")
    blob = _blob(cfg, mean_voxels=400, seed=9, weight=False)
    graph = build_tile_graph(*(torch.from_numpy(blob[k]) for k in
                               ("coords", "values", "n_voxels")), cfg)
    lev, t = graph.levels[0], 4
    g = torch.Generator().manual_seed(3)
    x = torch.randn(lev.occ.shape + (3,), generator=g,
                    dtype=torch.float64) * lev.occ[..., None]
    w = torch.randn((125, 3, 4), generator=g, dtype=torch.float64)
    y = submanifold_conv_tiled(x, lev.occ, lev.halo, t, 3, w)
    b, j, c = lev.occ.nonzero(as_tuple=True)
    tile = decode(lev.keys, cfg.spatial_size // t, 3).long()[b, j]
    cell = torch.stack([c // 16, (c // 4) % 4, c % 4], 1)
    keys = pm._key(b, tile * t + cell, cfg.spatial_size)
    order = torch.argsort(keys)
    site = pm.Level(keys[order], cfg.spatial_size)
    ref = pm.MinkUNet.conv(x[b, j, c][order], w, site)
    torch.testing.assert_close(y[b, j, c][order], ref, rtol=1e-12,
                               atol=1e-12)
    # cells off the occupancy hold exact zeros
    assert not bool(y[~lev.occ].any())
