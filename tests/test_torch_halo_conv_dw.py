"""The port's conv backward against the JAX reference, on the CPU.

Kernel C's plain version (`halo_conv_dw_plain`,
uresnet_pytorch_tpu_torch/ops/cuda/halo_conv_dw.py) against the reference's
d_W kernels in interpret mode (`_dw_impl`: the v2 layout at t=4, C=16 and
the v1 layout at t=2, C=12) and against autodiff through the XLA oracle.
The port's conv operator (`halo_conv_op`: d_x by the flipped-stencil conv,
d_W by kernel C's function) through `torch.autograd.grad` against the
reference's combined backward `_bwd_impl` in interpret mode, the channel
concat pair against autodiff of the reference's pair conv, and an input
that needs no gradient (the stem) skips the d_x conv. All f32, at 1e-4
(the bound of tests/test_halo_conv_fused.py). The kernel's plan
(`dw_plan`, which the wrapper passes to the kernel) is held to the plain
version by rebuilding d_W in torch slice by slice and warp by warp as the
plan splits it, and the wrapper's refusals to the kernel's limits. The
CUDA kernel itself is held to this plain version on the card by
chip_smoke.py."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_halo_conv import _case, _j_oracle, _specs
from tests.test_torch_halo_extend import _OnCard
from uresnet_pytorch_tpu.ops.pallas.halo_conv import _bwd_impl, _dw_impl
from uresnet_pytorch_tpu_torch.ops import tile_conv
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as hcdw
from uresnet_pytorch_tpu_torch.ops.halo import (Halo26Spec, body_cells,
                                                halo26_extend)
from tests.test_torch_model import one_torch_thread  # noqa: F401


def _dw_case(t, Cin, Cout, seed):
    """x and g zero on dead rows, as the model gives them."""
    keys, x, w, *_ = _case(t, Cin, Cout, 40, seed=seed)
    g = np.random.default_rng(seed + 1).normal(size=x.shape[:3] + (Cout,))
    alive = (keys != np.iinfo(np.int32).max)[..., None, None]
    return keys, x, (g * alive).astype(np.float32), w


def _oracle_vjp(x, w, g, jspec):
    _, vjp = jax.vjp(lambda xx, ww: _j_oracle(xx, jspec, ww),
                     jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("t,Cin,Cout", [
    pytest.param(4, 16, 16, id="v2-t4-c16"),
    pytest.param(2, 12, 12, id="v1-t2-c12"),
])
def test_dw_plain_matches_reference_kernels(t, Cin, Cout):
    keys, x, g, w = _dw_case(t, Cin, Cout, seed=t + Cin)
    jspec, spec = _specs(keys)
    ours = hcdw.halo_conv_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   spec, t, 3).numpy()
    assert ours.shape == (27, Cin, Cout) and ours.dtype == np.float32
    ref = np.asarray(_dw_impl(jnp.asarray(x), jnp.asarray(g), jspec, t, 3,
                              interpret=True))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
    _, ref_dw = _oracle_vjp(x, w, g, jspec)
    np.testing.assert_allclose(ours, ref_dw, atol=1e-4, rtol=1e-4)


def test_dw_ignores_dead_rows():
    """g on rows past the live prefix adds nothing: the conv writes zeros
    there whatever the weights."""
    keys, x, g, _ = _dw_case(4, 8, 8, seed=3)
    _, spec = _specs(keys)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    ref = hcdw.halo_conv_dw(xt, gt, spec, 4, 3)
    noisy = gt.clone()
    noisy[:, 40:] = 7.0
    torch.testing.assert_close(hcdw.halo_conv_dw(xt, noisy, spec, 4, 3), ref)


def test_flip_weights_is_the_references():
    from uresnet_pytorch_tpu.ops.pallas.halo_conv import flip_weights
    w = np.random.default_rng(0).normal(size=(27, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        hc.flip_weights(torch.from_numpy(w)).numpy(),
        np.asarray(flip_weights(jnp.asarray(w))))


def test_conv_op_backward_matches_combined_reference():
    keys, x, g, w = _dw_case(4, 16, 16, seed=31)
    jspec, spec = _specs(keys)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = hc.halo_conv_op(xt, wt, spec.idx, spec.ok, spec.blive, 4, 3)
    d_x, d_w = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g))
    ref_dx, ref_dw = _bwd_impl(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                               jspec, 4, 3, interpret=True)
    np.testing.assert_allclose(d_x.numpy(), np.asarray(ref_dx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_dw), atol=1e-4,
                               rtol=1e-4)


def test_pair_conv_backward_matches_reference():
    """The decoder's (up, skip) pair: two convs against w's row slices,
    summed; gradients of both halves and of w as the reference's pair
    conv."""
    from uresnet_pytorch_tpu.ops import tile_conv as jtc
    keys, x, g, w = _dw_case(2, 16, 8, seed=5)
    jspec, spec = _specs(keys)
    occ = (np.random.default_rng(6).random(x.shape[:3]) > 0.4) \
        & (keys != np.iinfo(np.int32).max)[..., None]
    x1, x2 = x[..., :10], x[..., 10:]
    parts = [torch.from_numpy(np.ascontiguousarray(p)).requires_grad_()
             for p in (x1, x2)]
    wt = torch.from_numpy(w).requires_grad_()
    out = tile_conv.submanifold_conv_tiled(
        tuple(parts), torch.from_numpy(occ), spec, 2, 3, wt)
    ours = torch.autograd.grad(out, (*parts, wt), torch.from_numpy(g))

    def ref_fn(a, b, ww):
        return jtc.submanifold_conv_tiled((a, b), jnp.asarray(occ), jspec, 2,
                                          3, ww)
    ref_out, vjp = jax.vjp(ref_fn, jnp.asarray(x1), jnp.asarray(x2),
                           jnp.asarray(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=1e-5)
    for o, r in zip(ours, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-4)


def test_input_without_grad_skips_the_dx_conv():
    """The stem: its input needs no gradient, so the backward runs the d_W
    function only (no flipped-stencil conv), and d_W is unchanged."""
    keys, x, g, w = _dw_case(4, 1, 8, seed=9)
    jspec, spec = _specs(keys)
    wt = torch.from_numpy(w).requires_grad_()
    out = hc.halo_conv_op(torch.from_numpy(x), wt, spec.idx, spec.ok,
                          spec.blive, 4, 3)
    with mock.patch.object(hc, "halo_conv",
                           side_effect=hc.halo_conv) as conv, \
            mock.patch.object(hc, "halo_conv_dw",
                              side_effect=hc.halo_conv_dw) as dw:
        (d_w,) = torch.autograd.grad(out, (wt,), torch.from_numpy(g))
    assert conv.call_count == 0 and dw.call_count == 1
    _, ref_dw = _oracle_vjp(x, w, g, jspec)
    np.testing.assert_allclose(d_w.numpy(), ref_dw, atol=1e-4, rtol=1e-4)


def test_dw_wrapper_refuses_what_the_kernel_cannot_take():
    """The kernel's limits, from `dw_plan`: every width has a plan (Cout
    12, 136 and 256 pad to a multiple of 8 and split into slices), and
    the geometry refuses a tile that is no whole number of 16-cell depth
    steps (27 cells at t=3) and a t=16 tile, whose 5832 extended cells
    fit no buffer. A tensor off the CPU goes to the kernel, which raises
    on them; nothing falls back."""
    keys, x, g, _ = _dw_case(4, 8, 8, seed=2)
    _, spec = _specs(keys)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    with pytest.raises(ValueError, match="unsupported device"):
        hcdw._check(xt, gt, spec, 4, 3)
    card = Halo26Spec(*(v.as_subclass(_OnCard) for v in spec[:3]), None)
    x16 = xt.to(torch.bfloat16).as_subclass(_OnCard)
    for cout in (12, 136, 256):
        assert hcdw.dw_plan(4, 3, 8, cout) is not None
        g16 = torch.zeros(x.shape[:3] + (cout,),
                          dtype=torch.bfloat16).as_subclass(_OnCard)
        hcdw._check(x16, g16, card, 4, 3)
    x27 = torch.zeros(x.shape[:2] + (27, 8),
                      dtype=torch.bfloat16).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="no plan for t=3"):
        hcdw._check(x27, x27, card, 3, 3)
    assert hcdw.dw_plan(3, 3, 8, 8) is None                  # 27 cells
    assert hcdw.dw_plan(16, 3, 8, 8) is None                 # 5832 cells
    assert hcdw.dw_plan(4, 3, 1, 128) is not None
    assert hcdw.dw_plan(8, 3, 128, 128) is not None
    hcdw._check(x16, gt.to(torch.bfloat16).as_subclass(_OnCard), card, 4, 3)


def _dw_by_plan(x, g, spec, t, plan):
    """d_W (f64) summed exactly as `dw_plan` splits it: per Cin slice of
    16 (or all of Cin, packed) and Cout slice of plan.cs, per warp w of 9
    (group w % wm with its M tiles, phase w // wm with every (9 / wm)-th
    16-cell depth step of the chunks in order), per M tile: an offset over
    the slice's 16 channels, or 16 packed (offset, channel) rows k * Cin +
    c, the padded ones (reading a real cell) dropped before the add."""
    B, T, cells, Cin = x.shape
    Cout, dim, K, E = g.shape[-1], 3, 27, t + 2
    per_event = -(-T // plan.tiles)
    pad = per_event * plan.tiles - T        # tiles past T: zero g
    ext = halo26_extend(x, spec, t, dim)
    ext = torch.cat([ext, ext.new_zeros(B, pad, E ** dim, Cin)], 1)
    g = g * spec.blive[:, :, None, None]
    g = torch.cat([g, g.new_zeros(B, pad, cells, Cout)], 1)
    ext, g = ext.reshape(-1, E ** dim, Cin), g.reshape(-1, Cout)
    n = g.shape[0]
    tile = torch.arange(n) // cells
    erow = torch.as_tensor(body_cells(t, dim))[torch.arange(n) % cells]
    shift = torch.tensor([sum(((k // 3 ** a) % 3 - 1) * E ** a
                              for a in range(dim)) for k in range(K)])
    packed = Cin < 16
    mtiles = -(-K * Cin // 16) if packed else K
    r = torch.arange(16)
    dw = torch.zeros(K * Cin, Cout, dtype=torch.float64)
    for c_lo in [0] if packed else range(0, Cin, 16):
        for co in range(0, Cout, plan.cs):
            for w in range(9):
                grp, ph = w % plan.wm, w // plan.wm
                cells_w = (torch.arange(n) // 16) % (9 // plan.wm) == ph
                for i in range(plan.mw):
                    mt = grp + i * plan.wm
                    if mt >= mtiles:
                        continue
                    if packed:
                        rows = mt * 16 + r
                        k, c = (rows // Cin).clamp(max=K - 1), rows % Cin
                        off = torch.where(rows < K * Cin, shift[k], 0)
                        c = torch.where(rows < K * Cin, c, 0)
                    else:
                        c = c_lo + r
                        rows = mt * Cin + c
                        off, c = shift[mt].expand(16), c.clamp(max=Cin - 1)
                    a = ext[tile[cells_w][None],
                            erow[cells_w][None] + off[:, None], c[:, None]]
                    acc = a @ g[cells_w, co:co + plan.cs]
                    keep = rows < K * Cin if packed else c_lo + r < Cin
                    dw[rows[keep], co:co + plan.cs] += acc[keep]
    return dw.reshape(K, Cin, Cout)


@pytest.mark.parametrize("t,Cin,Cout,plan", [
    pytest.param(4, 1, 16, (16, 4, 1, 2), id="stem-packed"),
    pytest.param(4, 16, 16, (16, 4, 9, 3), id="L0"),
    pytest.param(2, 80, 80, (80, 32, 9, 3), id="L4-five-Cin-slices"),
    pytest.param(4, 12, 16, (16, 4, 9, 3), id="packed-12-idle-tiles"),
    pytest.param(2, 128, 128, (64, 32, 9, 3), id="two-Cout-slices"),
    pytest.param(4, 12, 12, (16, 4, 9, 3), id="cout12-pad16"),
    pytest.param(2, 36, 36, (40, 32, 9, 3), id="cout36-pad40"),
    pytest.param(2, 60, 60, (64, 32, 9, 3), id="cout60-pad64"),
    pytest.param(2, 160, 160, (80, 32, 9, 3), id="cout160-two-slices"),
    pytest.param(2, 256, 256, (64, 32, 9, 3), id="cout256-four-slices"),
])
def test_dw_plan_rebuilds_the_gradient(t, Cin, Cout, plan):
    """The counterpart of test_kernel_weights_rebuild_the_conv: d_W
    rebuilt in torch as the kernel's plan splits it (Cin and Cout slices,
    offsets per warp, depth phases, the packed stem's rows) equals the
    plain version, so the plan covers every output once."""
    keys, x, g, _ = _dw_case(t, Cin, Cout, seed=t + Cin + Cout)
    _, spec = _specs(keys)
    assert tuple(hcdw.dw_plan(t, 3, Cin, Cout)) == plan
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    ref = hcdw.halo_conv_dw_plain(xt, gt, spec, t, 3).double()
    got = _dw_by_plan(xt.double(), gt.double(), spec, t,
                      hcdw.dw_plan(t, 3, Cin, Cout))
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
