"""The port's halo conv (plain torch version of kernel B,
uresnet_pytorch_tpu_torch/ops/cuda/halo_conv.py) against the JAX reference.

f32: held to the reference's exact oracle (halo26_extend_xla + VALID
lax.conv, plus the epilogue composed in f32) at atol 1e-5.
bf16: held to the reference's Pallas kernels in interpret mode
(`halo_conv_fwd`, `fused_halo_conv_bn_act`) at 1e-2, the bound of
tests/test_halo_conv_fused.py. Cases: a v2-aligned shape, a v1 shape
(t=2, C=12), Cin=1 (the stem) and dead tile blocks. The CUDA kernel itself
is checked against this plain version on the card by chip_smoke.py; the
arguments the wrappers of kernels B and C pass it, their plans included,
are held here to the C entry points' definitions."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_halo26 import _random_level
from uresnet_pytorch_tpu.ops.halo import build_halo26 as j_build_halo26
from uresnet_pytorch_tpu.ops.halo import halo26_extend_xla
from uresnet_pytorch_tpu.ops.pallas.halo_conv import (
    fused_halo_conv_bn_act, halo_conv_fwd, toeplitz_weights)
from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as hcdw
from uresnet_pytorch_tpu_torch.ops.halo import (Halo26Spec, body_cells,
                                                build_halo26, halo26_extend)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_DN = ("NDHWC", "DHWIO", "NDHWC")
ALPHA = 0.1


def _case(t, Cin, Cout, live, seed, B=2, G=8, T=None):
    """Sorted keys with `live` tiles per event (rows past it are dead),
    x zero on dead rows and a mask inside the live occupancy: the
    production invariants the liveness gate relies on. T tiles per event:
    64, or 8 of t=8's 512 cells."""
    T = T or (64 if t < 8 else 8)
    rng = np.random.default_rng(seed)
    keys = np.stack([np.asarray(_random_level(rng, G, 3, T, live)[0])
                     for _ in range(B)])
    cells = t ** 3
    alive = (keys != np.iinfo(np.int32).max)[..., None, None]
    x = (rng.normal(size=(B, T, cells, Cin)) * alive).astype(np.float32)
    w = (rng.normal(size=(27, Cin, Cout)) * 0.3).astype(np.float32)
    a = (rng.normal(size=Cout) * 0.5 + 1.0).astype(np.float32)
    b = (rng.normal(size=Cout) * 0.2).astype(np.float32)
    mask = (rng.random((B, T, cells)) > 0.3) & alive[..., 0]
    return keys, x, w, a, b, mask


# jitted once per shape: eager dispatch of the reference's graph code
# costs seconds per call on the CPU
_j_spec = jax.jit(jax.vmap(lambda k: j_build_halo26(k, 8, 3, block=16)))


def _specs(keys):
    return _j_spec(jnp.asarray(keys)), build_halo26(torch.from_numpy(keys),
                                                    8, 3)


@jax.jit
def _j_oracle(x, jspec, w):
    B, T, cells, Cin = x.shape
    t = round(cells ** (1 / 3))
    ext = halo26_extend_xla(x, jspec, t, 3)
    out = jax.lax.conv_general_dilated(
        ext.reshape((B * T,) + (t + 2,) * 3 + (Cin,)),
        w.reshape(3, 3, 3, Cin, -1), (1, 1, 1), "VALID",
        dimension_numbers=_DN)
    return out.reshape(B, T, cells, -1)


def _oracle_f32(x, jspec, t, w):
    return np.asarray(_j_oracle(jnp.asarray(x), jspec, jnp.asarray(w)))


def _epilogue(y, a, b, mask):
    z = y * a + b
    return np.where(z >= 0, z, ALPHA * z) * mask[..., None]


def _port(x, w, spec, t, a=None, b=None, mask=None, dtype=torch.float32):
    ep = {} if a is None else dict(
        a=torch.from_numpy(a), b=torch.from_numpy(b), alpha=ALPHA,
        mask=torch.from_numpy(mask))
    out = hc.halo_conv(torch.from_numpy(x).to(dtype),
                       torch.from_numpy(w).to(dtype), spec, t, 3, **ep)
    assert out.dtype == dtype
    return out.float().numpy()


CASES = [  # t, Cin, Cout, live tiles of 64
    pytest.param(4, 16, 16, 40, id="v2-t4-c16"),
    pytest.param(2, 12, 12, 40, id="v1-t2-c12"),
    pytest.param(4, 1, 8, 40, id="stem-cin1"),
]
# the width configurations' shapes (uresnet_filters=12's Cout 60, no
# multiple of 8; width_ramp="geometric"'s 256 -> 256; tile_size=8's
# decoder conv after the concat at level 2), held to the reference's
# Pallas kernels in bf16
WIDE_CASES = [
    pytest.param(2, 60, 60, 40, id="v1-t2-c60"),
    pytest.param(2, 256, 256, 40, id="v1-t2-c256"),
    pytest.param(8, 96, 48, 6, id="t8-c96-48"),
]


@pytest.mark.parametrize("t,Cin,Cout,live", CASES)
def test_plain_f32_matches_xla_oracle(t, Cin, Cout, live):
    keys, x, w, a, b, mask = _case(t, Cin, Cout, live, seed=Cin + t)
    jspec, spec = _specs(keys)
    ref = _oracle_f32(x, jspec, t, w)
    np.testing.assert_allclose(_port(x, w, spec, t), ref, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_port(x, w, spec, t, a, b, mask),
                               _epilogue(ref, a, b, mask), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("t,Cin,Cout,live", CASES + WIDE_CASES)
def test_plain_bf16_matches_pallas_interpret(t, Cin, Cout, live):
    keys, x, w, a, b, mask = _case(t, Cin, Cout, live, seed=Cin + t)
    jspec, spec = _specs(keys)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    fused = fused_halo_conv_bn_act(xb, wb, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(mask), ALPHA, jspec, t, 3,
                                   interpret=True)
    if fused is None:
        # off the v2 layout (t=2, t=8, the stem's Cin < 8) the reference
        # declines its fused kernel and runs halo_conv_fwd + the epilogue
        # in XLA: hold the raw conv to that kernel too (each
        # interpret-mode call costs seconds, so the v2 case checks the
        # fused kernel only)
        assert t in (2, 8) or Cin < 8
        raw = halo_conv_fwd(xb, toeplitz_weights(wb, t, 3, jnp.bfloat16),
                            jspec, t, 3, interpret=True)
        raw = np.asarray(raw.astype(jnp.float32))
        np.testing.assert_allclose(
            _port(x, w, spec, t, dtype=torch.bfloat16), raw, rtol=1e-2,
            atol=1e-2)
        fused = _epilogue(raw, a, b, mask)
    else:
        fused = np.asarray(fused.astype(jnp.float32))
    np.testing.assert_allclose(
        _port(x, w, spec, t, a, b, mask, dtype=torch.bfloat16), fused,
        rtol=1e-2, atol=1e-2)


def test_dead_rows_are_exact_zeros():
    """Rows past the live prefix come out as exact zeros, whatever the
    epilogue's bias would give (the kernel skips them)."""
    keys, x, w, a, b, mask = _case(4, 8, 8, 20, seed=3)
    _, spec = _specs(keys)
    out = _port(x, w, spec, 4, a, b + 5.0, np.ones_like(mask))
    assert (out[:, 20:] == 0).all() and (out[:, :20] != 0).any()


def test_halo_extend_matches_reference_bitwise():
    keys, x, *_ = _case(4, 3, 3, 40, seed=9)
    jspec, spec = _specs(keys)
    ref = np.asarray(halo26_extend_xla(jnp.asarray(x), jspec, 4, 3))
    np.testing.assert_array_equal(
        halo26_extend(torch.from_numpy(x), spec, 4, 3).numpy(), ref)


def test_kernel_reads_model_rows_without_pack():
    """Kernel B takes the model's own (B, T, cells, C) activation storage:
    its C arguments point at x itself, where the TPU kernels first repack
    lanes (`_preslice0`) into a kernel-specific layout. The wrapper also
    refuses the epilogue unless a, b and mask come together."""
    keys, x, w, a, b, mask = _case(4, 16, 16, 40, seed=1)
    _, spec = _specs(keys)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    at, bt, mt = (torch.from_numpy(v) for v in (a, b, mask))
    out = torch.empty(2, 64, 64, 16)
    kw = hc.kernel_weights(wt)      # (Cout, 27 * 16): row n is w[:, :, n]
    assert kw.shape == (16, 27 * 16)
    np.testing.assert_array_equal(kw.numpy(),
                                  w.transpose(2, 0, 1).reshape(16, -1))
    plan = hc.kernel_plan(4, 3, 16, 16)
    args = hc.launch_args(xt, kw, spec, 4, 3, at, bt, 0.1, mt, out, plan)
    assert args[0] == xt.data_ptr() and args[1] == kw.data_ptr()
    assert args[-11:] == (2, 64, 4, 3, 16, 16, *plan)
    # Cin = 1: the 27 offsets packed into a depth of 32, not 27 x 16
    stem = hc.kernel_weights(torch.ones(27, 1, 8))
    assert stem.shape == (8, 32) and stem[:, :27].eq(1).all()
    assert stem[:, 27:].abs().sum() == 0
    with pytest.raises(ValueError):
        hc.halo_conv(xt, wt, spec, 4, 3, a=at)


@pytest.mark.parametrize("epilogue", [False, True])
def test_tiled_conv_dispatch_matches_reference(epilogue):
    """ops/tile_conv's submanifold_conv_tiled (raw entry, masked by
    occupancy) and submanifold_conv_bn_act_tiled (epilogue entry) against
    the reference's functions of the same names, f32."""
    from uresnet_pytorch_tpu.ops import tile_conv as jtc
    from uresnet_pytorch_tpu_torch.ops import tile_conv as ttc
    keys, x, w, a, b, mask = _case(4, 8, 8, 40, seed=5)
    jspec, spec = _specs(keys)
    occ = mask | (np.random.default_rng(6).random(mask.shape) > 0.5)
    occ &= mask.any(-1, keepdims=True)
    j = [jnp.asarray(v) for v in (x, occ, w, a, b, mask)]
    p = [torch.from_numpy(v) for v in (x, occ, w, a, b, mask)]
    if epilogue:
        ref = jtc.submanifold_conv_bn_act_tiled(
            j[0], j[1], jspec, 4, 3, j[2], j[3], j[4], ALPHA, j[5])
        out = ttc.submanifold_conv_bn_act_tiled(
            p[0], p[1], spec, 4, 3, p[2], p[3], p[4], ALPHA, p[5])
    else:
        ref = jtc.submanifold_conv_tiled(j[0], j[1], jspec, 4, 3, j[2])
        out = ttc.submanifold_conv_tiled(p[0], p[1], spec, 4, 3, p[2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _im2col(x, spec, t, kp):
    """(B, T, cells, kp): each cell's 27 neighbor rows from the plain
    extend, in the kernel's depth order (offset-major, channels padded to
    16; packed, offset-major over the true channels, for Cin < 16), read
    as the kernel reads them: from its group's staged ext rows
    (`hc.groups`: whole tiles, or one 64-cell slab of a t=8 tile, staged
    from ext cell sub * zoff on), which must hold every row the stencil
    of each of the group's cells reads."""
    B, T, cells, Cin = x.shape
    E = t + 2
    grp = hc.groups(t, 3)
    ext = halo26_extend(x, spec, t, 3)
    first = torch.arange(cells) // (cells // grp.subs) * grp.zoff
    body = torch.as_tensor(body_cells(t, 3))
    cpad = Cin if Cin < 16 else -(-Cin // 16) * 16
    cols = []
    for k in range(27):
        d0, d1, d2 = k // 9, k // 3 % 3, k % 3
        row = body - first + (d0 - 1) * E * E + (d1 - 1) * E + (d2 - 1)
        assert int(row.min()) >= 0 and int(row.max()) < grp.gcells
        cols.append(torch.nn.functional.pad(ext[:, :, first + row],
                                            (0, cpad - Cin)))
    a = torch.cat(cols, -1)
    return torch.nn.functional.pad(a, (0, kp - a.shape[-1]))


@pytest.mark.parametrize("t,Cin,Cout,plan", [
    pytest.param(4, 1, 128, (128, 1, 0, 0, 0), id="stem-128"),
    pytest.param(4, 12, 40, (40, 12, 0, 0, 0), id="packed-12"),
    pytest.param(4, 16, 128, (128, 16, 0, 0, 0), id="t4-16-128"),
    pytest.param(2, 24, 32, (32, 32, 0, 0, 0), id="t2-24-32"),
    pytest.param(2, 128, 64, (64, 32, 4, 3, 0), id="dec-L3-slices-chunks"),
    pytest.param(4, 12, 12, (16, 12, 0, 0, 0), id="cout12-pad16"),
    pytest.param(2, 36, 36, (40, 48, 0, 0, 0), id="cout36-pad40-cin-pad48"),
    pytest.param(2, 60, 60, (32, 64, 0, 0, 0), id="cout60-two-slices"),
    pytest.param(2, 72, 36, (40, 16, 0, 0, 1), id="cout36-chunks"),
    pytest.param(2, 160, 160, (160, 32, 5, 1, 0), id="cin160-ten-slices"),
    pytest.param(2, 256, 256, (256, 16, 5, 3, 0), id="cin256-32-slices"),
    pytest.param(8, 16, 16, (16, 16, 0, 0, 0), id="t8-slabs"),
    pytest.param(8, 96, 48, (64, 48, 4, 3, 0), id="t8-slabs-96-48"),
    pytest.param(8, 128, 64, (64, 64, 6, 1, 0), id="t8-slabs-128-64"),
    pytest.param(2, 384, 256, (256, 16, 5, 3, 0), id="wide-cin384"),
    pytest.param(4, 128, 96, (96, 64, 8, 1, 0), id="wide-t4-128-96"),
])
def test_kernel_weights_rebuild_the_conv(t, Cin, Cout, plan):
    """The kernel's GEMM, rebuilt in torch from its weight operand: the
    plain extend's im2col in the kernel's depth order times the weights,
    the pad's columns dropped, equals `halo_conv_plain` in f32. On the
    resident path the operand is `kernel_weights`' (round_up(Cout, 8), kp),
    taken one block's slice of output channels at a time and, within it,
    one staged chunk of channels after another; on the wide path (a ring,
    `kernel_plan`'s third field) it is `wide_weights`' tiles, one per
    (Cout slice, chunk, offset). Holds the packing's, the tiles' and the
    groups' index arithmetic where no card can run the kernel."""
    keys, x, w, *_ = _case(t, Cin, Cout, 40 if t < 8 else 6, seed=Cin)
    _, spec = _specs(keys)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert hc.kernel_plan(t, 3, Cin, Cout) == plan
    cs, cw, ring, _, _ = plan
    cpad = Cin if Cin < 16 else -(-Cin // 16) * 16
    ref = hc.halo_conv_plain(xt, wt, spec, t, 3).numpy()
    if ring:
        tiles = hc.wide_weights(wt, cs, cw)
        slices, nch = -(-Cout // cs), cpad // cw
        assert tiles.shape == (slices, nch, 27, cw // 8, cs, 8)
        # tile (s, c, k)[u, j, e] is w[k, c * cw + 8 u + e, s * cs + j]
        a = _im2col(xt, spec, t, 27 * cpad)
        a = a.reshape(*a.shape[:-1], 27, nch, cw // 8, 8)
        y = torch.einsum("btmkcue,sckuje->btmsj", a, tiles).flatten(-2)
        assert not y[..., Cout:].any()
        y = y[..., :Cout]
    else:
        kw = hc.kernel_weights(wt)
        coutp = -(-Cout // 8) * 8
        assert kw.shape[0] == coutp and not kw[Cout:].any()
        a = _im2col(xt, spec, t, kw.shape[1])
        chunk = torch.arange(kw.shape[1]) % cpad // cw   # depth kk's chunk
        assert int(chunk.max()) + 1 == cpad // cw
        y = torch.cat([sum(a[..., chunk == c] @ kw[n:n + cs, chunk == c].t()
                           for c in range(cpad // cw))
                       for n in range(0, coutp, cs)], -1)[..., :Cout]
    y = y * spec.blive[:, :, None, None]
    # f32 sums of up to 27 x 384 terms in two orders: 1e-5 of the scale
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# every 3^3 conv of MinkUNet34C (levels 1-4 at t=2, the decoder's level 0
# at t=4; a decoder's first conv as its up and skip halves) and of the
# sparse U-ResNet at uresnet_filters=16 (the stem and level 0 at t=4;
# eval's concat convs), with kernel B's path for the conv and for its d_x
# (Cout -> Cin on the flipped stencil): wide where the resident plan
# splits Cout and Cin stages by vectors
MODEL_CONVS = [
    pytest.param(2, 32, 32, "resident", "resident", id="mink-L1-32-32"),
    pytest.param(2, 32, 64, "resident", "resident", id="mink-L2-32-64"),
    pytest.param(2, 64, 64, "wide", "wide", id="mink-L2-64-64"),
    pytest.param(2, 64, 128, "wide", "wide", id="mink-L3-64-128"),
    pytest.param(2, 128, 128, "wide", "wide", id="mink-L3-128-128"),
    pytest.param(2, 128, 256, "wide", "wide", id="mink-L4-128-256"),
    pytest.param(2, 256, 256, "wide", "wide", id="mink-L4-256-256"),
    pytest.param(2, 96, 96, "wide", "wide", id="mink-dec-L1-96-96"),
    pytest.param(2, 32, 96, "resident", "resident", id="mink-dec-L1-32-96"),
    pytest.param(4, 96, 96, "wide", "wide", id="mink-dec-L0-96-96"),
    pytest.param(4, 32, 96, "resident", "resident", id="mink-dec-L0-32-96"),
    pytest.param(4, 1, 16, "resident", "resident", id="sparse-stem"),
    pytest.param(4, 16, 16, "resident", "resident", id="sparse-L0-16-16"),
    pytest.param(4, 32, 16, "resident", "resident", id="sparse-dec-L0-32-16"),
    pytest.param(2, 32, 32, "resident", "resident", id="sparse-L1-32-32"),
    pytest.param(2, 64, 32, "resident", "resident", id="sparse-dec-L1-64-32"),
    pytest.param(2, 48, 48, "resident", "resident", id="sparse-L2-48-48"),
    pytest.param(2, 96, 48, "wide", "wide", id="sparse-dec-L2-96-48"),
    pytest.param(2, 64, 64, "wide", "wide", id="sparse-L3-64-64"),
    pytest.param(2, 128, 64, "wide", "wide", id="sparse-dec-L3-128-64"),
    pytest.param(2, 80, 80, "wide", "wide", id="sparse-L4-80-80"),
]


@pytest.mark.parametrize("direction", ["forward", "d_x"])
@pytest.mark.parametrize("t,Cin,Cout,fwd_path,dx_path", MODEL_CONVS)
def test_model_convs_take_their_path(t, Cin, Cout, fwd_path, dx_path,
                                     direction):
    """`kernel_plan` at each conv of both models: a plan (none is left to
    another path), the path the shape rule gives (the table's: wide exactly
    where the resident plan splits Cout into slices and Cin >= 16, Cin % 8
    == 0), and a wide plan's shared memory within the 232,448 bytes a block may
    use: its ring of weight stages, two buffers of two groups' extended
    rows, and the static tables (under 8 KB)."""
    cin, cout, path = (Cin, Cout, fwd_path) if direction == "forward" \
        else (Cout, Cin, dx_path)
    plan = hc.kernel_plan(t, 3, cin, cout)
    assert plan is not None
    assert ("wide" if plan.ring else "resident") == path
    if not plan.ring:
        return
    grp = hc.groups(t, 3)
    ext = -(-2 * grp.tiles * grp.gcells * (plan.cw + 8) * 2 // 16) * 16
    stage = plan.kg * plan.cs * plan.cw * 2
    assert 27 % plan.kg == 0 and (-(-cin // 16) * 16) % plan.cw == 0
    assert plan.cs % 32 == 0 and plan.cs >= cout and 4 <= plan.ring <= 8
    assert plan.ring * stage + 2 * ext + 8192 <= 232448


@pytest.mark.parametrize("Cin,Cout,offset,copied", [
    pytest.param(256, 256, 0, False, id="wide-aligned"),
    pytest.param(256, 256, 1, True, id="wide-offset"),
    pytest.param(32, 32, 1, False, id="resident-offset"),
])
def test_staged_input_aligns_the_wide_path(Cin, Cout, offset, copied):
    """The wrapper and the kernel choose the wide path from the shape alone
    (`make_plan` refuses it an x off 16 bytes rather than reading its
    operand as the resident layout), so `staged_input` hands the wide path
    a 16-byte-aligned copy of an x viewed at an odd element offset, equal
    to x, and the resident path x itself, which it stages by scalars."""
    n = 2 * 3 * 8 * Cin
    base = torch.arange(n + offset, dtype=torch.float32).to(torch.bfloat16)
    x = base[offset:].view(2, 3, 8, Cin)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    plan = hc.kernel_plan(2, 3, Cin, Cout)
    assert bool(plan.ring) == (Cin == 256)
    got = hc.staged_input(x, plan)
    assert (got is not x) == copied
    assert got.data_ptr() % 16 == 0 or not plan.ring
    assert torch.equal(got, x) and got.is_contiguous()


def _c_entry(name: str) -> list:
    """(ctypes type, parameter name) of each parameter of the C entry
    point `name`, read from its definition in csrc/: a pointer is
    c_void_p, an int c_int, a float c_float."""
    for src in cuda.sources():
        m = re.search(r"\nint " + name + r"\(([^)]*)\)\s*\{", src.read_text())
        if m:
            break
    else:
        raise AssertionError(f"no C entry point {name}")
    params = []
    for decl in m.group(1).split(","):
        ctype, pname = decl.strip().rsplit(None, 1)
        kind = ctypes.c_void_p if "*" in ctype + pname else \
            {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]
        params.append((kind, pname.lstrip("*")))
    return params


@pytest.mark.parametrize("entry", ["halo_conv_raw", "halo_conv_bn_act",
                                   "halo_conv_dw"])
@pytest.mark.parametrize("t,Cin,Cout", [
    pytest.param(4, 16, 16, id="resident-t4-16-16"),
    pytest.param(2, 128, 128, id="wide-L3-128-128"),
    pytest.param(4, 1, 16, id="packed-stem-1-16"),
    pytest.param(8, 96, 48, id="t8-slabs-96-48"),
])
def test_launch_args_follow_the_c_entry(entry, t, Cin, Cout):
    """The arguments a wrapper builds for kernel B's raw or epilogue entry
    point, or for kernel C's, have the arity and ctypes types of
    `ops/cuda._SIGNATURES`, which are the C definition's, and carry the
    tensors, the shape and the host's plan (`kernel_plan` / `dw_plan`,
    which the kernels only check) field by field where the C entry takes
    each by name. Only the card could show a mismatch otherwise."""
    params = _c_entry(entry)
    assert [kind for kind, _ in params] == cuda._SIGNATURES[entry]
    B, T, cells = 2, 5, t ** 3
    x = torch.zeros(B, T, cells, Cin, dtype=torch.bfloat16)
    halo = Halo26Spec(torch.zeros(B, 26, T, dtype=torch.int32),
                      torch.zeros(B, 26, T, dtype=torch.bool),
                      torch.ones(B, T, dtype=torch.bool), None)
    tensors = {"x": x, "idx": halo.idx, "ok": halo.ok, "live": halo.blive}
    if entry == "halo_conv_dw":
        plan = hcdw.dw_plan(t, 3, Cin, Cout)
        g = torch.zeros(B, T, cells, Cout, dtype=torch.bfloat16)
        dw = torch.zeros(27, Cin, Cout)
        args = hcdw.launch_args(x, g, halo, t, 3, dw, plan)
        tensors.update(g=g, dw=dw)
    else:
        plan = hc.kernel_plan(t, 3, Cin, Cout)
        w = torch.zeros(27, Cin, Cout, dtype=torch.bfloat16)
        wt = hc.wide_weights(w, plan.cs, plan.cw) if plan.ring \
            else hc.kernel_weights(w)
        out = torch.empty(B, T, cells, Cout, dtype=torch.bfloat16)
        ep = (None,) * 4
        if entry == "halo_conv_bn_act":
            ep = (torch.ones(Cout), torch.zeros(Cout), 0.1,
                  torch.ones(B, T, cells, dtype=torch.bool))
            tensors.update(a=ep[0], b=ep[1], mask=ep[3])
        a, b, alpha, mask = ep
        args = hc.launch_args(x, wt, halo, t, 3, a, b, alpha, mask, out,
                              plan)
        tensors.update(wt=wt, out=out)
    assert plan is not None
    args = args + (0,)                      # the stream
    assert len(args) == len(params)
    for v, (kind, pname) in zip(args, params):
        assert isinstance(v, float if kind is ctypes.c_float else int), pname
        kind.from_param(v)
    by_name = dict(zip((pname for _, pname in params), args))
    assert {n for kind, n in params if kind is ctypes.c_void_p} == \
        set(tensors) | {"stream"}
    for n, v in tensors.items():
        assert by_name[n] == v.data_ptr(), n
    want = dict(B=B, T=T, t=t, dim=3, Cin=Cin, Cout=Cout, **plan._asdict())
    assert {n: v for n, v in by_name.items() if n in want} == want
    assert [n for kind, n in params if kind is ctypes.c_int] == list(want)
