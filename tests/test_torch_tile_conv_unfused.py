"""The port's unfused tile conv (ops/tile_conv.py with USE_FUSED=False: the
halo extend of kernel D's plain version, one VALID conv, the epilogue in
torch) against the reference's functions of the same names on the CPU,
which take the reference's unfused XLA path (halo26_extend + one VALID
lax.conv). f32 outputs agree to rtol 1e-5, gradients (through kernel E's
plain version) to `jax.vjp` at 1e-4. Also pins the auto rule: on the card
float32 takes the unfused path and bfloat16 kernel B, by patching the
wrappers (a CPU tensor that reports a CUDA device); and the shape rule:
each conv of the model takes the fused path where kernels B and C plan
its widths, which is every bfloat16 conv of every configuration, decided
as on the card, with a uresnet_filters=12 forward and train step through
it against the reference's f32 XLA path at the bounds of
tests/test_torch_model.py and tests/test_torch_train.py."""

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
from tests.test_torch_model import one_torch_thread  # noqa: F401


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


def _card_rule(monkeypatch):
    """`ttc._fused` deciding every conv as it would for a bfloat16 tensor
    on the card, recording (dx, dw, Cin, Cout, fused) per call; the CPU
    then runs the chosen path's plain versions."""
    calls = []
    rule = ttc._fused

    def on_card(x, t, dim, Cout, dx=False, dw=False):
        card = torch.empty(0, x.shape[-1],
                           dtype=torch.bfloat16).as_subclass(_OnCard)
        fused = rule(card, t, dim, Cout, dx, dw)
        calls.append((dx, dw, x.shape[-1], Cout, fused))
        return fused
    monkeypatch.setattr(ttc, "_fused", on_card)
    return calls


def _rule_cfg(**kw):
    from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
    base = dict(num_class=5, uresnet_filters=16, uresnet_num_strides=5,
                spatial_size=64, data_dim=3, reps=1, max_voxels=512,
                min_level_capacity=64, tile_size=4, min_tiles=64,
                tile_sizes=(4, 2, 2, 2, 2), compute_dtype="float32")
    base.update(kw)
    return TConfig(**base)


# (config, which (Cin, Cout) convs the card must send to the unfused path
# in eval and in training); every other conv stays fused
RULE_CASES = [
    pytest.param({}, set(), set(), id="config3-4-widths"),
    pytest.param({"uresnet_filters": 12}, set(), set(), id="filters12"),
    pytest.param({"width_ramp": "geometric"}, set(), set(), id="geometric"),
    pytest.param({"uresnet_filters": 32}, set(), set(), id="filters32"),
    pytest.param({"tile_size": 8, "tile_sizes": None}, set(), set(),
                 id="tile8"),
]


@pytest.mark.parametrize("kw,eval_unfused,train_unfused", RULE_CASES)
def test_shape_rule_picks_the_path_per_conv(monkeypatch, kw, eval_unfused,
                                            train_unfused):
    """Every conv of one eval forward and one training forward/backward of
    the model, decided as on the card for bfloat16: the fused path exactly
    where kernel B takes the conv and, in training, kernel C its d_W and
    kernel B its d_x (the stem needs none), else the unfused one. Every
    configuration stays fused throughout: the benchmark configs (m=16,
    linear widths, tiles (4,2,2,2,2)) and the widths and tile size that
    once went unfused."""
    from tests.test_torch_model import _events
    from uresnet_pytorch_tpu_torch.models import construct
    cfg = _rule_cfg(**kw)
    calls = _card_rule(monkeypatch)
    model = construct("uresnet_sparse")(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    args = [torch.from_numpy(a) for a in _events(cfg, B=1)]
    with torch.no_grad():
        model(*args)
    n_eval = len(calls)
    logits, _ = model(*args, train=True)
    logits.square().sum().backward()
    assert n_eval > 0 and len(calls) > n_eval
    # eval asks for no gradient; training for d_W everywhere and d_x
    # everywhere but the stem (the first conv, Cin 1)
    assert not any(dx or dw for dx, dw, *_ in calls[:n_eval])
    assert [(dx, dw) for dx, dw, *_ in calls[n_eval:]] == \
        [(False, True)] + [(True, True)] * (len(calls) - n_eval - 1)
    for calls_of, want in ((calls[:n_eval], eval_unfused),
                           (calls[n_eval:], train_unfused)):
        got = {(ci, co) for _, _, ci, co, fused in calls_of if not fused}
        assert got == want, sorted(got)


@pytest.mark.parametrize("t,cin,cout,dx,dw,refuse_dw,use_fused,fused", [
    (4, 1, 16, False, True, False, None, True),     # the stem: no d_x
    (4, 1, 16, True, True, False, None, True),      # its d_x (16 -> 1)
    (4, 16, 16, True, True, True, None, False),     # kernel C refusing d_W
    (4, 16, 16, False, False, True, None, True),    # ... asked for no d_W
    (16, 16, 12, False, False, False, True, True),  # forced: the wrapper raises
    (4, 16, 16, False, False, False, False, False),
    (16, 16, 16, False, False, False, None, False),  # t=16: no plan
])
def test_rule_asks_the_gradients_kernels(monkeypatch, t, cin, cout, dx, dw,
                                         refuse_dw, use_fused, fused):
    """`_fused` on the card: kernel B's plan of the flipped shape where
    x needs a gradient, kernel C's where w does; `USE_FUSED` overrides the
    rule both ways. Every width has a plan (Cout 1 pads to 8); what remains
    refused is geometry: a t=16 tile's 5832 extended cells."""
    monkeypatch.setattr(ttc, "USE_FUSED", use_fused)
    if refuse_dw:
        monkeypatch.setattr(ttc, "dw_plan", lambda *a: None)
    x = torch.empty(0, cin, dtype=torch.bfloat16).as_subclass(_OnCard)
    assert ttc._fused(x, t, 3, cout, dx=dx, dw=dw) is fused
    if use_fused is None:     # float32 on the card: never fused
        assert not ttc._fused(x.float(), t, 3, cout, dx=dx, dw=dw)


@pytest.fixture(scope="module")
def filters12_case():
    """uresnet_filters=12 (widths 12, 24, 36) at the small size of
    tests/test_torch_model.py and tests/test_torch_train.py: variables,
    events, the reference's f32 eval logits (its XLA path) and its f32
    train step."""
    from tests.test_torch_model import _events
    from tests.test_torch_train import _blob, _reference_step, _variables
    from tests.test_torch_train import _KW as TRAIN_KW
    from uresnet_pytorch_tpu.config import URESNetConfig
    from uresnet_pytorch_tpu.models import construct as j_construct
    from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
    kw = {**TRAIN_KW, "uresnet_filters": 12}
    tcfg = TConfig(compute_dtype="float32", **kw)
    variables, args, blob = _variables(tcfg), _events(tcfg), _blob(tcfg)
    model = j_construct("uresnet_sparse")(
        URESNetConfig(compute_dtype="float32", **kw))
    logits = jax.jit(model.apply, static_argnames=("train",))(
        variables, *args, train=False)
    step = _reference_step("float32", variables, blob, uresnet_filters=12)
    return tcfg, variables, args, np.asarray(logits), blob, step


def test_filters12_forward_through_the_rule(filters12_case, monkeypatch):
    """One forward at uresnet_filters=12 with every conv on the path the
    card would take (every width fused: Cout 12 and 36 pad to 16 and 40),
    against the reference's f32 logits at the bound of
    tests/test_torch_model.py."""
    from tests.test_torch_model import _port
    tcfg, variables, args, ref, _, _ = filters12_case
    calls = _card_rule(monkeypatch)
    out = _port(tcfg, variables, args)
    assert all(fused for *_, fused in calls)
    assert {co for *_, co, fused in calls} == {12, 24, 36}
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_filters12_train_step_through_the_rule(filters12_case, monkeypatch):
    """One train step at uresnet_filters=12 through the rule, against the
    reference's f32 step at the bounds of tests/test_torch_train.py."""
    from tests.test_torch_train import _port_step
    _, variables, _, _, blob, (ref_loss, ref_grads, ref_stats) = \
        filters12_case
    calls = _card_rule(monkeypatch)
    loss, grads, stats = _port_step("float32", variables, blob,
                                    uresnet_filters=12)
    assert all(fused for *_, fused in calls)
    assert {co for *_, co, fused in calls} == {12, 24, 36}
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert sorted(grads) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(
            grads[name], ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(stats[name], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
