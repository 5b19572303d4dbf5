"""The port's eval pair (`URESNET_EVAL_PAIR=1`) against the JAX reference's,
on the CPU, where the port runs the plain torch versions of its kernels.

With the knob set, eval hands each decoder stage's first block the
unmaterialized (upsampled, skip) pair, as train does, and that block runs
its raw convs (tests/test_sparse_model.py::test_eval_pair_path_matches_concat
pins the reference's side). From one variables tree (BN moments and
affines randomized, tests/test_torch_model.py's `_reference`):

- the port's f32 pair logits against the reference's f32 pair logits, and
  against the port's own concat eval, both at the reference's bound
  (rtol 2e-4, atol 2e-5);
- the port's bf16 pair against the reference's bf16 pair on the class of
  nearly every voxel;
- kernel B's calls with and without the knob, counted at the wrapper: the
  concat eval makes every conv one call with its epilogue, as before the
  knob existed; the pair makes each decoder stage's first conv_a two raw
  calls and its conv_b one raw call. At config 3's structure (5 strides,
  reps 2) that is 37 and 41, the counts chip_smoke.py asserts on the card.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.ops import tile_conv
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
from uresnet_pytorch_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_model import (_cfg, _events, _port, _reference,
                                    _tcfg, one_torch_thread)  # noqa: F401

PAIR = "URESNET_EVAL_PAIR"


def _jax_eval(cfg, variables, args):
    """The reference's eval logits, traced anew so that the knob is read
    as the environment holds it now."""
    model = j_construct("uresnet_sparse")(cfg)
    fn = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
    return np.asarray(fn(variables, *args))


@pytest.fixture(scope="module")
def case():
    """Variables, events, the reference's f32 concat logits and its f32
    and bf16 pair logits."""
    cfg = _cfg("float32")
    args = _events(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(PAIR, raising=False)
        variables, concat = _reference(cfg, args)
        mp.setenv(PAIR, "1")
        pair = _jax_eval(cfg, variables, args)
        pair_bf16 = _jax_eval(_cfg("bfloat16"), variables, args)
    return variables, args, concat, pair, pair_bf16


def test_reference_pair_is_its_concat(case):
    """The two reference forwards differ only in the knob (a witness that
    the knob reached the reference: its pair is not bit-identical)."""
    _, _, concat, pair, _ = case
    assert not np.array_equal(pair, concat)
    np.testing.assert_allclose(pair, concat, rtol=2e-4, atol=2e-5)


def test_eval_pair_matches_reference(case, monkeypatch):
    variables, args, _, ref, _ = case
    monkeypatch.setenv(PAIR, "1")
    out = _port(_tcfg("float32"), variables, args)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    for b, n in enumerate(args[2]):
        assert (out[b, n:] == 0).all()


def test_eval_pair_matches_concat(case, monkeypatch):
    """The port's pair against its own concat eval, the knob read at each
    forward of one model."""
    variables, args, _, _, _ = case
    model = construct("uresnet_sparse")(_tcfg("float32"), device="cpu")
    load_jax_variables(model, variables)
    inputs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        monkeypatch.delenv(PAIR, raising=False)
        concat = model(*inputs)[0].numpy()
        monkeypatch.setenv(PAIR, "1")
        pair = model(*inputs)[0].numpy()
    assert not np.array_equal(pair, concat)
    np.testing.assert_allclose(pair, concat, rtol=2e-4, atol=2e-5)


def test_eval_pair_bf16_class_agreement(case, monkeypatch):
    """bf16, the card's compute dtype: the port's pair classifies nearly
    every voxel as the reference's bf16 pair does."""
    variables, args, _, _, ref = case
    monkeypatch.setenv(PAIR, "1")
    out = _port(_tcfg("bfloat16"), variables, args)
    nv = args[2]
    agree = sum((out[b, :n].argmax(-1) == ref[b, :n].argmax(-1)).sum()
                for b, n in enumerate(nv))
    assert agree / nv.sum() >= 0.995, agree / nv.sum()


def _calls(cfg, args, monkeypatch, knob: bool):
    """(calls with the epilogue, raw calls) of kernel B's wrapper in one
    eval forward: tile_conv's fused epilogue conv, and halo_conv_op's raw
    conv."""
    if knob:
        monkeypatch.setenv(PAIR, "1")
    else:
        monkeypatch.delenv(PAIR, raising=False)
    model = construct("uresnet_sparse")(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    with mock.patch.object(tile_conv, "halo_conv",
                           side_effect=tile_conv.halo_conv) as epi, \
            mock.patch.object(hc, "halo_conv",
                              side_effect=hc.halo_conv) as raw, \
            torch.no_grad():
        model(*(torch.from_numpy(a) for a in args))
    return epi.call_count, raw.call_count


@pytest.mark.parametrize("knob,want", [(False, (11, 0)), (True, (7, 6))])
def test_kernel_b_calls_small(case, monkeypatch, knob, want):
    """At 3 levels and reps=1: stem 1 + encoder 3 x 2 + decoder 2 x 2 = 11
    convs; the pair makes each decoder block's 2 convs 3 raw ones."""
    _, args, _, _, _ = case
    assert _calls(_tcfg("float32"), args, monkeypatch, knob) == want


@pytest.mark.parametrize("knob,want", [(False, (37, 0)), (True, (29, 12))])
def test_kernel_b_calls_config3_structure(monkeypatch, knob, want):
    """Config 3's structure (5 strides, reps 2, tiles (4,2,2,2,2)) at a
    small size: 37 calls a forward with concat, 41 with the pair (the four
    decoder stages' block0 conv_a becomes two raw calls, and its conv_b
    runs raw)."""
    cfg = TConfig(num_class=5, uresnet_filters=16, uresnet_num_strides=5,
                  spatial_size=32, data_dim=3, reps=2, max_voxels=256,
                  min_level_capacity=32, tile_size=4, min_tiles=64,
                  tile_sizes=(4, 2, 2, 2, 2), compute_dtype="bfloat16")
    assert _calls(cfg, _events(cfg, B=1), monkeypatch, knob) == want
    assert sum(want) == (41 if knob else 37)

