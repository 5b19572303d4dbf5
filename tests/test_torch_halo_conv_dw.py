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
(the bound of tests/test_halo_conv_fused.py). The CUDA kernel itself is
held to this plain version on the card by chip_smoke.py."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_halo_conv import _case, _j_oracle, _specs
from uresnet_pytorch_tpu.ops.pallas.halo_conv import _bwd_impl, _dw_impl
from uresnet_pytorch_tpu_torch.ops import tile_conv
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as hcdw


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
    keys, x, g, _ = _dw_case(4, 8, 8, seed=2)
    _, spec = _specs(keys)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    with pytest.raises(ValueError, match="unsupported device"):
        hcdw._check(xt, gt, spec, 4, 3)
