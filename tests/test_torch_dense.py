"""The port's dense U-ResNet against the JAX reference's, on the CPU.

- `voxelize`, `gather_voxels` and `_flat_indices` bitwise, in 2D and 3D;
- each conv kind's layout mapping against the flax layer it mirrors (the
  3^d SAME conv, the 2^d stride-2 conv, the 1x1 head with bias, and the
  transposed stride-2 conv, whose kernel the port flips): f32 to 1e-5
  absolute;
- `init_params` gives the reference's tree, letter for letter;
- the eval forward from the same variables (BN moments and affines
  randomized): f32 to 1e-4 * max|ref|, and the port's bf16 against the
  reference's f32 at the bf16 bound of tests/test_torch_model.py (p99 of
  the error over max(|ref|, 1) below 5e-2) with class agreement above
  0.995;
- one f32 train step (forward, backward, Adam, the BN moments) against the
  reference's loss, gradients and optax update, in 2D at three levels:
  loss to 1e-5 relative,
  gradients to rtol 1e-4 with atol 1e-4 * max|ref| per leaf, the running
  moments to 1e-5 (a moment applied twice under the recompute would miss
  by ~0.1), the new parameters to 1e-4 * max|ref| per leaf wherever the
  gradient is above 1e-3 of its leaf's largest (Adam's first step moves
  each element by lr * sign(g), so a gradient within rounding of 0 may
  round either way). In 3D at 16^3 and three levels the reference's own
  f32 gradients sit up to 8e-2 (relative to their leaf's largest) from
  the port's, while the port's f32 step agrees with the same step in f64
  to 2e-6: flax's BN takes the variance as E[x^2] - E[x]^2 over volumes
  whose empty cells hold one near-constant value, and XLA's CPU sums
  accumulate in f32 where torch's CPU sums accumulate in f64. In this 2D
  configuration the two agree to 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu.ops import voxelize as j_vox
from uresnet_pytorch_tpu.trainval import TrainVal as JTrainVal
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.uresnet_dense import Conv
from uresnet_pytorch_tpu_torch.ops import voxelize as t_vox
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils.weights import (export_variables,
                                                     init_params,
                                                     load_jax_variables)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_KW = dict(model_name="uresnet_dense", num_class=5, uresnet_filters=4,
           uresnet_num_strides=3, spatial_size=16, data_dim=3, reps=1,
           max_voxels=256, leaky_relu_slope=0.1, batch_size=2,
           learning_rate=0.01)


def _blob(B=2, S=16, dim=3, V=256, mean_voxels=120):
    blob = {"coords": np.zeros((B, V, dim), np.int32),
            "values": np.zeros((B, V), np.float32),
            "label": np.zeros((B, V), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b in range(B):
        c, v, l = generate_event(4, b, S, dim, mean_voxels)
        n = min(len(c), V)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    blob["weight"] = np.where(blob["label"] > 0, 1.0, 0.5).astype(np.float32)
    return blob


def _args(blob):
    return blob["coords"], blob["values"], blob["n_voxels"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("dim,S", [(2, 32), (3, 16)])
def test_voxelize_and_gather_bitwise(dim, S):
    """Padding rows (coordinate 0, value 0) land in cell 0, which an
    event's voxel also occupies here, and rows past n_voxels read cell 0."""
    blob = _blob(S=S, dim=dim, V=128, mean_voxels=60)
    blob["coords"][0, 0] = 0
    blob["values"][1, blob["n_voxels"][1]:] = 7.0   # masked: must not land
    coords, values, nv = _args(blob)
    valid = np.arange(128)[None] < nv[:, None]
    np.testing.assert_array_equal(
        t_vox._flat_indices(torch.from_numpy(coords),
                            torch.from_numpy(valid), S).numpy(),
        np.asarray(j_vox._flat_indices(jnp.asarray(coords),
                                       jnp.asarray(valid), S)))
    ref = np.asarray(j_vox.voxelize(coords, values, nv, S))
    vol = t_vox.voxelize(*map(torch.from_numpy, (coords, values, nv)), S)
    assert vol.shape == ref.shape == (2,) + (S,) * dim + (1,)
    np.testing.assert_array_equal(vol.numpy(), ref)
    feat = np.random.default_rng(1).normal(
        size=(2,) + (S,) * dim + (3,)).astype(np.float32)
    np.testing.assert_array_equal(
        t_vox.gather_voxels(torch.from_numpy(feat),
                            *map(torch.from_numpy, (coords, nv)), S).numpy(),
        np.asarray(j_vox.gather_voxels(feat, coords, nv, S)))


@pytest.mark.parametrize("kind", ["conv3", "down", "head", "deconv"])
def test_conv_layout_matches_flax(kind):
    """The port's Conv on the flax layer's own (*k, I, O) kernel."""
    cfg = TConfig(compute_dtype="float32", data_dim=3, spatial_size=16,
                  uresnet_num_strides=2)
    cin, cout = 3, 5
    k, stride, bias, layer = {
        "conv3": (3, 1, False, fnn.Conv(cout, (3,) * 3, use_bias=False)),
        "down": (2, 2, False, fnn.Conv(cout, (2,) * 3, strides=(2,) * 3,
                                       use_bias=False)),
        "head": (1, 1, True, fnn.Conv(cout, (1,) * 3, use_bias=True)),
        "deconv": (2, 2, False, fnn.ConvTranspose(
            cout, (2,) * 3, strides=(2,) * 3, use_bias=False)),
    }[kind]
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 6, cin)).astype(
        np.float32)
    variables = layer.init(jax.random.PRNGKey(1), x)
    ref = np.asarray(layer.apply(variables, x))
    ours = Conv(cfg, cin, cout, k, stride=stride, bias=bias,
                transpose=kind == "deconv")
    load_jax_variables(ours, {"params": variables["params"]})
    with torch.no_grad():
        out = ours(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_init_params_follows_reference_tree():
    """The same names and shapes as the reference's `model.init`, under
    `core/` (Conv_0 the shortcut where a block changes width), drawn from
    flax's lecun_normal."""
    cfg = URESNetConfig(**_KW)
    ref = jax.eval_shape(
        lambda *a: j_construct("uresnet_dense")(cfg).init(
            jax.random.PRNGKey(0), *a, train=False), *_args(_blob()))
    ours = init_params(TConfig(**_KW), torch.Generator().manual_seed(1))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    for coll in ("params", "batch_stats"):
        assert shapes(ours[coll]) == shapes(dict(ref[coll]))
    core = ours["params"]["core"]
    assert sorted(core["dec0_block0"]) == ["BNAct_0", "BNAct_1", "Conv_0",
                                           "Conv_1", "Conv_2"]
    assert core["dec0_block0"]["Conv_0"]["kernel"].shape == (1, 1, 1, 8, 4)
    w = core["enc1_block0"]["Conv_0"]["kernel"]
    assert abs(w.std() - (1.0 / (27 * 8)) ** 0.5) < 0.01
    assert np.abs(w).max() <= 2.0 * (1.0 / (27 * 8)) ** 0.5 / 0.8796 + 1e-6
    assert (core["head"]["bias"] == 0).all()


def _variables(cfg):
    """init_params with BN affines and running moments randomized."""
    variables = init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "BatchNorm_0" not in name:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return np.abs(leaf + noise) if "'var'" in name else leaf + noise
    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def case():
    """Variables, a blob and the reference's f32 eval logits."""
    variables, blob = _variables(TConfig(**_KW)), _blob()
    model = j_construct("uresnet_dense")(
        URESNetConfig(compute_dtype="float32", **_KW))
    ref = jax.jit(model.apply, static_argnames=("train",))(
        variables, *_args(blob), train=False)
    return variables, blob, np.asarray(ref)


def _port_forward(dtype, variables, blob):
    model = construct("uresnet_dense")(TConfig(compute_dtype=dtype, **_KW),
                                       device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        logits, diag = model(*map(torch.from_numpy, _args(blob)))
    assert {k: int(v) for k, v in diag.items()} == {
        "overflow": 0, "tile_spill": 0, "vox_spill": 0}
    return logits.numpy()


def test_eval_forward_f32_matches_reference(case):
    variables, blob, ref = case
    out = _port_forward("float32", variables, blob)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_eval_forward_bf16_class_agreement(case):
    variables, blob, ref = case
    out = _port_forward("bfloat16", variables, blob)
    nv = blob["n_voxels"]
    agree = sum((out[b, :n].argmax(-1) == ref[b, :n].argmax(-1)).sum()
                for b, n in enumerate(nv)) / nv.sum()
    assert agree > 0.995, agree
    for b, n in enumerate(nv):
        scale = np.maximum(np.abs(ref[b, :n]), 1.0)
        assert np.quantile(np.abs(out[b, :n] - ref[b, :n]) / scale,
                           0.99) < 5e-2


def test_train_step_f32_matches_reference():
    kw = dict(_KW, data_dim=2, spatial_size=32, max_voxels=512)
    variables = _variables(TConfig(**kw))
    blob = _blob(S=32, dim=2, V=512, mean_voxels=300)
    cfg = URESNetConfig(compute_dtype="float32", **kw)
    jtv = JTrainVal(cfg)
    jtv.model = j_construct("uresnet_dense")(cfg)
    batch = {k: jnp.asarray(v) for k, v in blob.items()}
    (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jtv._loss_fn(p, s, b, True), has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    tx = optax.adam(cfg.learning_rate)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    new_params = _flat(optax.apply_updates(variables["params"], updates))
    ref_grads, ref_stats = _flat(grads), _flat(stats)

    tv = TrainVal(TConfig(compute_dtype="float32", **kw), device="cpu")
    tv.initialize(variables)
    metrics = tv.train_step(blob)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in tv.model.named_parameters()}
    assert sorted(got) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(
            got[name], ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
    state = export_variables(tv.model)
    stats_now = _flat(state["batch_stats"])
    assert sorted(stats_now) == sorted(ref_stats)
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(stats_now[name], ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    params_now = _flat(state["params"])
    for name, ref in new_params.items():
        moved = np.abs(ref_grads[name]) > 1e-3 * np.abs(ref_grads[name]).max()
        np.testing.assert_allclose(
            params_now[name][moved], ref[moved], rtol=0,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
