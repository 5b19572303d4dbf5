"""The port's unfused tile conv (ops/tile_conv.py with USE_FUSED=False: the
halo extend of kernel D's plain version, one VALID conv, the epilogue in
torch) against the reference's functions of the same names on the CPU,
which take the reference's unfused XLA path (halo26_extend + one VALID
lax.conv). f32 outputs agree to rtol 1e-5, gradients (through kernel E's
plain version) to `jax.vjp` at 1e-4. Also pins the auto rule: on the card
float32 takes the unfused path and bfloat16 kernel B, by patching the
wrappers (a CPU tensor that reports a CUDA device)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_halo_conv import ALPHA, _case, _specs
from tests.test_torch_halo_extend import _OnCard
from uresnet_pytorch_tpu.ops import tile_conv as jtc
from uresnet_pytorch_tpu_torch.ops import tile_conv as ttc


def _inputs(pair, seed):
    """x (or the pair halves, 5 + 3 channels), occ, w and the epilogue,
    as numpy."""
    keys, x, w, a, b, mask = _case(4, 8, 8, 40, seed=seed)
    occ = mask | (np.random.default_rng(seed + 1).random(mask.shape) > 0.5)
    occ &= mask.any(-1, keepdims=True)
    xs = (x[..., :5], x[..., 5:]) if pair else (x,)
    return keys, xs, occ, w, a, b, mask


CASES = [pytest.param("conv", False, id="conv"),
         pytest.param("conv", True, id="conv-pair"),
         pytest.param("bn_act", False, id="bn_act")]


@pytest.mark.parametrize("entry,pair", CASES)
def test_unfused_matches_reference(monkeypatch, entry, pair):
    monkeypatch.setattr(ttc, "USE_FUSED", False)
    keys, xs, occ, w, a, b, mask = _inputs(pair, seed=11 + pair)
    jspec, spec = _specs(keys)
    ct = np.random.default_rng(2).normal(size=mask.shape + (8,)).astype(
        np.float32)

    def j_fn(xs, w):
        x = tuple(xs) if pair else xs[0]
        if entry == "conv":
            return jtc.submanifold_conv_tiled(x, jnp.asarray(occ), jspec, 4,
                                              3, w)
        return jtc.submanifold_conv_bn_act_tiled(
            x, jnp.asarray(occ), jspec, 4, 3, w, jnp.asarray(a),
            jnp.asarray(b), ALPHA, jnp.asarray(mask))

    ref, vjp = jax.vjp(j_fn, tuple(jnp.asarray(v) for v in xs),
                       jnp.asarray(w))
    ref_dxs, ref_dw = vjp(jnp.asarray(ct))

    txs = [torch.from_numpy(v).requires_grad_(True) for v in xs]
    tw = torch.from_numpy(w).requires_grad_(True)
    x = tuple(txs) if pair else txs[0]
    tocc, tmask = torch.from_numpy(occ), torch.from_numpy(mask)
    if entry == "conv":
        out = ttc.submanifold_conv_tiled(x, tocc, spec, 4, 3, tw)
    else:
        out = ttc.submanifold_conv_bn_act_tiled(
            x, tocc, spec, 4, 3, tw, torch.from_numpy(a),
            torch.from_numpy(b), ALPHA, tmask)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip([v.grad for v in txs] + [tw.grad],
                         list(ref_dxs) + [ref_dw]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_unfused_and_fused_agree(monkeypatch):
    """Both paths of the port compute one function: f32, plain versions."""
    keys, (x,), occ, w, a, b, mask = _inputs(False, seed=5)
    _, spec = _specs(keys)
    args = [torch.from_numpy(v) for v in (x, occ, w, a, b, mask)]
    outs = []
    for fused in (True, False):
        monkeypatch.setattr(ttc, "USE_FUSED", fused)
        outs.append(ttc.submanifold_conv_bn_act_tiled(
            args[0], args[1], spec, 4, 3, args[2], args[3], args[4], ALPHA,
            args[5]))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,on_card,fused", [
    (torch.float32, True, False),      # the repair: f32 on the card
    (torch.bfloat16, True, True),      # kernel B, as before
    (torch.float32, False, True),      # the CPU keeps kernel B's plain path
    (torch.bfloat16, False, True),
])
def test_auto_rule_picks_the_path(dtype, on_card, fused):
    """USE_FUSED=None on a tensor that reports a CUDA device: float32 takes
    the halo extend (kernel D), which takes both dtypes, where kernel B
    would refuse it; bfloat16 takes kernel B. The wrappers are patched, so
    nothing launches."""
    assert ttc.USE_FUSED is None
    keys, (x,), occ, w, a, b, mask = _inputs(False, seed=3)
    _, spec = _specs(keys)
    xt = torch.from_numpy(x).to(dtype)
    if on_card:
        xt = xt.as_subclass(_OnCard)
    B, T = x.shape[:2]
    ext = torch.zeros(B, T, 6 ** 3, 8, dtype=dtype)
    raw = torch.zeros(B, T, 64, 8, dtype=dtype)
    with mock.patch.object(ttc, "halo_conv_op", return_value=raw) as op, \
            mock.patch.object(ttc, "halo_conv", return_value=raw) as conv, \
            mock.patch.object(ttc, "halo26_extend_op",
                              return_value=ext) as extend:
        ttc.submanifold_conv_tiled(xt, torch.from_numpy(occ), spec, 4, 3,
                                   torch.from_numpy(w))
        ttc.submanifold_conv_bn_act_tiled(
            xt, torch.from_numpy(occ), spec, 4, 3, torch.from_numpy(w),
            torch.from_numpy(a), torch.from_numpy(b), ALPHA,
            torch.from_numpy(mask))
    assert (op.call_count, conv.call_count) == ((1, 1) if fused else (0, 0))
    assert extend.call_count == (0 if fused else 2)
