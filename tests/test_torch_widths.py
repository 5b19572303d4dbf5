"""The three width configurations the JAX package runs and the card's
shape rule mixes paths for, whole, against the reference, on the CPU:
`width_ramp="geometric"` (widths 16-256), `uresnet_filters=32` (32-160) and
`tile_size=8` with `tile_sizes=None`, each at five strides, reps 1, on
64^3 events of about a hundred voxels.

Every conv takes the path the card would take for bfloat16
(tests/test_torch_tile_conv_unfused.py's `_card_rule`): kernels B and C's
plain versions, since they plan every conv of these configurations (the
256 -> 256 convs at the bottom of the geometric ramp, the 160 -> 160
ones at filters 32 and, at t=8, the decoder's 96 -> 48 and 128 -> 64
concat convs in eval among them). On that path, from one variables tree (BN moments and affines
randomized): the f32 eval logits against the reference's at
tests/test_torch_model.py's bound (rtol = atol = 1e-4), and one f32 train
step's loss, gradients and new moments against the reference's at
tests/test_torch_train.py's (loss 1e-5; gradients rtol 1e-4 with atol
1e-4 * max|ref|; moments 1e-5)."""

import jax
import numpy as np
import pytest

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from tests.test_torch_model import _events, _port
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_tile_conv_unfused import _card_rule
from tests.test_torch_train import (_blob, _port_step, _reference_step,
                                    _variables)
from tests.test_torch_train import _KW as TRAIN_KW

_BASE = dict(TRAIN_KW, uresnet_filters=16, uresnet_num_strides=5,
             spatial_size=64, max_voxels=384, min_level_capacity=64,
             tile_sizes=(4, 2, 2, 2, 2), batch_size=1)

# (overrides, the (Cin, Cout) convs the card sends to the unfused path in
# eval and in the train step: none)
WIDTHS = {
    "geometric": ({"width_ramp": "geometric"}, set(), set()),
    "filters32": ({"uresnet_filters": 32}, set(), set()),
    "tile8": ({"tile_size": 8, "tile_sizes": None}, set(), set()),
}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def width_case(request):
    """The configuration's overrides, variables, events, the reference's
    f32 eval logits and its f32 train step."""
    kw, eval_unfused, train_unfused = WIDTHS[request.param]
    kw = {**_BASE, **kw}
    tcfg = TConfig(compute_dtype="float32", **kw)
    variables, args = _variables(tcfg), _events(tcfg, B=1)
    blob = _blob(tcfg, B=1)
    model = j_construct("uresnet_sparse")(
        URESNetConfig(compute_dtype="float32", **kw))
    logits = jax.jit(model.apply, static_argnames=("train",))(
        variables, *args, train=False)
    step = _reference_step("float32", variables, blob, **kw)
    return (kw, eval_unfused, train_unfused, variables, args,
            np.asarray(logits), blob, step)


def test_forward_matches_reference(width_case, monkeypatch):
    kw, eval_unfused, _, variables, args, ref, _, _ = width_case
    calls = _card_rule(monkeypatch)
    out = _port(TConfig(compute_dtype="float32", **kw), variables, args)
    assert {(ci, co) for *_, ci, co, fused in calls if not fused} \
        == eval_unfused
    assert any(fused for *_, fused in calls)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_train_step_matches_reference(width_case, monkeypatch):
    kw, _, train_unfused, variables, _, _, blob, ref_step = width_case
    ref_loss, ref_grads, ref_stats = ref_step
    calls = _card_rule(monkeypatch)
    loss, grads, stats = _port_step("float32", variables, blob, **kw)
    assert {(ci, co) for *_, ci, co, fused in calls if not fused} \
        == train_unfused
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert sorted(grads) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(
            grads[name], ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
    assert sorted(stats) == sorted(ref_stats)
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(stats[name], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
