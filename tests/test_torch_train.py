"""The port's training slice against the JAX reference, on the CPU, where the
port runs the plain torch versions of its kernels.

One train step from the same variables and batch: the reference side is
`jax.value_and_grad` of its `TrainVal._loss_fn` on one CPU device, the port
side `TrainVal` with `device="cpu"`. In f32 the loss agrees to rtol 1e-5,
every gradient to rtol 1e-4 with atol 1e-4 * max|ref|, and the new BN
running moments to 1e-5, on either tile conv path. In bf16 the loss agrees
to 1e-2 and the whole gradient's cosine to the reference's is at least
0.99 (per leaf, see test_bf16_step_matches_reference). Adam is held to
optax.adam on identical gradients, the four remat modes to each other, and
the counts of conv calls per step (both paths) to the formulas
chip_smoke.py asserts on the card. Port
counterparts of tests/test_tile_engine.py's training tests close the
file."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu.trainval import TrainVal as JTrainVal
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.ops import tile_conv
from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he
from uresnet_pytorch_tpu_torch.trainval import TrainVal, adam
from uresnet_pytorch_tpu_torch.utils.weights import (export_variables,
                                                     init_params)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_KW = dict(num_class=5, uresnet_filters=4, uresnet_num_strides=3,
           spatial_size=16, data_dim=3, reps=1, max_voxels=256,
           min_level_capacity=32, tile_size=4, min_tiles=64,
           tile_sizes=(4, 2, 2), leaky_relu_slope=0.1, batch_size=2)


def _blob(cfg, B=2, mean_voxels=120, seed=4, weight=True):
    blob = {"coords": np.zeros((B, cfg.max_voxels, 3), np.int32),
            "values": np.zeros((B, cfg.max_voxels), np.float32),
            "label": np.zeros((B, cfg.max_voxels), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b in range(B):
        c, v, l = generate_event(seed, b, cfg.spatial_size, 3, mean_voxels)
        n = min(len(c), cfg.max_voxels)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    if weight:
        blob["weight"] = np.where(blob["label"] > 0, 1.0,
                                  0.5).astype(np.float32)
    return blob


def _variables(cfg):
    """init_params with the BN affines and running moments randomized, so
    every BN term and the moment update are non-trivial."""
    variables = init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "MaskedBatchNorm_0" not in name:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return np.abs(leaf + noise) if "'var'" in name else leaf + noise
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


def _reference_step(dtype, variables, blob, remat_mode="none", **kw):
    """(loss, grads, new batch stats) of the reference's train step (kw
    overrides _KW). Its remat mode changes no value and "none" compiles
    fastest."""
    cfg = URESNetConfig(compute_dtype=dtype, remat_mode=remat_mode,
                        **{**_KW, **kw})
    tv = JTrainVal(cfg)
    tv.model = j_construct("uresnet_sparse")(cfg)
    batch = {k: jnp.asarray(v) for k, v in blob.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, s, b: tv._loss_fn(p, s, b, True), has_aux=True))
    (loss, (stats, _)), grads = fn(variables["params"],
                                   variables["batch_stats"], batch)
    return float(loss), _flat(grads), _flat(stats)


def _port_step(dtype, variables, blob, remat_mode="stage_dots", **kw):
    """(loss, grads, new batch stats) of the port's train step, before
    Adam (kw overrides _KW)."""
    tv = TrainVal(TConfig(compute_dtype=dtype, remat_mode=remat_mode,
                          **{**_KW, **kw}), device="cpu")
    tv.initialize(variables)
    metrics = tv._metrics(tv._batch(blob), train=True)
    metrics["loss"].backward()
    commit_batch_moments(tv.model)
    grads = {n: p.grad.numpy() for n, p in tv.model.named_parameters()}
    return (float(metrics["loss"].detach()), grads,
            _flat(export_variables(tv.model)["batch_stats"]))


@pytest.fixture(scope="module")
def f32_case():
    cfg = TConfig(compute_dtype="float32", **_KW)
    variables, blob = _variables(cfg), _blob(cfg)
    return variables, blob, _reference_step("float32", variables, blob)


@pytest.mark.parametrize("use_fused", [None, False])
def test_f32_step_matches_reference(f32_case, monkeypatch, use_fused):
    """Auto (kernels B and C's plain versions on the CPU) and the unfused
    tile conv (kernels D and E's plain versions around a VALID conv)."""
    monkeypatch.setattr(tile_conv, "USE_FUSED", use_fused)
    variables, blob, (ref_loss, ref_grads, ref_stats) = f32_case
    loss, grads, stats = _port_step("float32", variables, blob)
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


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


def test_bf16_step_matches_reference(f32_case):
    """At this width (4 filters) bf16 rounding alone moves single gradient
    leaves far: the reference's own bf16 gradients have cosines down to
    0.955 against its f32 ones (BN scales and biases, sums with heavy
    cancellation). So the whole gradient is held at 0.99, each weight
    stack (`*.w`, `*_w`: the convs' come from kernel C's function) at 0.97
    and every other leaf at 0.9."""
    variables, blob, _ = f32_case
    ref_loss, ref_grads, _ = _reference_step("bfloat16", variables, blob)
    loss, grads, _ = _port_step("bfloat16", variables, blob)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    names = sorted(ref_grads)
    assert _cos(np.concatenate([grads[n].ravel() for n in names]),
                np.concatenate([ref_grads[n].ravel() for n in names])) >= 0.99
    for name in names:
        floor = 0.97 if name.endswith("w") else 0.9
        assert _cos(grads[name], ref_grads[name]) >= floor, name


def test_remat_modes_agree(f32_case):
    """Every remat mode gives the same loss, gradients and running moments:
    the recompute records the BN moments again but they are applied once."""
    variables, blob, _ = f32_case
    ref = _port_step("float32", variables, blob, remat_mode="none")
    for mode in ("stage", "stage_dots", "stage_dots_deep"):
        loss, grads, stats = _port_step("float32", variables, blob,
                                        remat_mode=mode)
        assert loss == ref[0], mode
        for name in grads:
            np.testing.assert_array_equal(grads[name], ref[1][name],
                                          err_msg=f"{mode} {name}")
        for name in stats:
            np.testing.assert_array_equal(stats[name], ref[2][name],
                                          err_msg=f"{mode} {name}")


@pytest.mark.parametrize("mode,forward_convs", [
    ("stage_dots", 13),     # conv outputs saved: each conv runs once
    ("stage", 25),          # all but the stem's 13 - 1 run again
])
def test_conv_calls_per_step(f32_case, mode, forward_convs):
    """At 3 levels and reps=1: stem 1 + encoder 3 x 2 + decoder 2 x 3 (the
    first conv_a a pair of two) = 13 forward convs, 12 d_x convs (the stem
    needs none) and 13 d_W. chip_smoke.py asserts the same formula at
    config 4 (41, 40, 41) against the kernels' launch counters."""
    variables, blob, _ = f32_case
    tv = TrainVal(TConfig(compute_dtype="float32", remat_mode=mode, **_KW),
                  device="cpu")
    tv.initialize(variables)
    with mock.patch.object(hc, "halo_conv",
                           side_effect=hc.halo_conv) as conv, \
            mock.patch.object(hc, "halo_conv_dw",
                              side_effect=hc.halo_conv_dw) as dw:
        tv.train_step(blob)
    assert conv.call_count == forward_convs + 12
    assert dw.call_count == 13


@pytest.mark.parametrize("mode,extends", [
    ("none", 13),           # one extend per forward conv
    ("stage_dots", 25),     # the conv outputs are saved, the extends not:
    #                         all but the stem's 13 - 1 run again
])
def test_unfused_calls_per_step(f32_case, monkeypatch, mode, extends):
    """With USE_FUSED=False every conv is an extend and a VALID conv: 13
    forward extends, recomputed under stage_dots as in the reference, 12
    transposes (the stem's input needs none) and no call of kernel B or C.
    chip_smoke.py asserts the same formula at config 4 (81 D, 40 E)."""
    monkeypatch.setattr(tile_conv, "USE_FUSED", False)
    variables, blob, _ = f32_case
    tv = TrainVal(TConfig(compute_dtype="float32", remat_mode=mode, **_KW),
                  device="cpu")
    tv.initialize(variables)
    with mock.patch.object(he, "halo26_fwd",
                           side_effect=he.halo26_fwd) as fwd, \
            mock.patch.object(he, "halo26_bwd",
                              side_effect=he.halo26_bwd) as bwd, \
            mock.patch.object(hc, "halo_conv",
                              side_effect=hc.halo_conv) as conv, \
            mock.patch.object(hc, "halo_conv_dw",
                              side_effect=hc.halo_conv_dw) as dw:
        metrics = tv.train_step(blob)
    assert np.isfinite(float(metrics["loss"]))
    assert (fwd.call_count, bwd.call_count) == (extends, 12)
    assert (conv.call_count, dw.call_count) == (0, 0)


def test_adam_matches_optax():
    """Three updates of the port's optimizer and of optax.adam from the same
    parameters and identical gradients, in float64: in float32 optax rounds
    1 - 0.999^t to f32 (relative error ~1e-5) where torch keeps it in
    double, which alone moves parameters by more than 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"w": (27, 4, 8), "scale": (8,), "bias": (8,)}
    params = {n: rng.normal(size=s) * 0.3 for n, s in shapes.items()}
    ours = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    opt = adam(list(ours.values()), 0.01)
    with jax.enable_x64(True):
        tx = optax.adam(0.01)
        ref = {n: jnp.asarray(v) for n, v in params.items()}
        state = tx.init(ref)
        for _ in range(3):
            # gradients over four decades, as the model's are
            grads = {n: rng.normal(size=s) * 10.0 ** rng.integers(-4, 1, s)
                     for n, s in shapes.items()}
            for n, p in ours.items():
                p.grad = torch.from_numpy(grads[n])
            opt.step()
            updates, state = tx.update(
                {n: jnp.asarray(g) for n, g in grads.items()}, state, ref)
            ref = optax.apply_updates(ref, updates)
        ref = {n: np.asarray(v) for n, v in ref.items()}
    for n, p in ours.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n], rtol=1e-6,
                                   err_msg=n)


def _engine_cfg(**kw):
    """tests/test_tile_engine.py's `_cfg("tile")`."""
    base = dict(num_class=5, uresnet_filters=4, uresnet_num_strides=3,
                spatial_size=16, data_dim=3, reps=1, max_voxels=256,
                min_level_capacity=32, batch_size=2, learning_rate=0.01,
                compute_dtype="float32", tile_size=4, min_tiles=64)
    base.update(kw)
    return TConfig(**base)


def test_tile_engine_trains():
    cfg = _engine_cfg()
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    blob = _blob(cfg, mean_voxels=100, seed=0, weight=False)
    losses = [float(tv.train_step(blob)["loss"]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    assert tv.global_step == 12


def test_capacity_spill_keeps_loss_finite():
    """Voxels whose tile is dropped by capacity give zero logits, not NaN,
    and the spill is counted."""
    cfg = _engine_cfg(spatial_size=32, uresnet_num_strides=2,
                      max_voxels=512, min_tiles=8, tile_occupancy=64.0,
                      batch_size=1)
    rng = np.random.default_rng(0)
    flat = rng.choice(32 ** 3, size=400, replace=False)
    blob = {"coords": np.zeros((1, 512, 3), np.int32),
            "values": np.zeros((1, 512), np.float32),
            "label": np.zeros((1, 512), np.int32),
            "n_voxels": np.array([400], np.int32)}
    blob["coords"][0, :400] = np.stack(
        [flat // 1024, (flat // 32) % 32, flat % 32], -1)
    blob["values"][0, :400] = 1.0
    blob["label"][0, :400] = rng.integers(0, 5, 400)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    for _ in range(2):
        m = tv.train_step(blob)
        assert np.isfinite(float(m["loss"])), "spill produced NaN loss"
    assert int(m["tile_spill"]) > 0 and int(m["vox_spill"]) > 0


def test_tile_padding_invariance():
    cfg = _engine_cfg()
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    blob = _blob(cfg, mean_voxels=100, seed=0, weight=False)
    res1 = tv.forward(blob)
    blob2 = {k: v.copy() for k, v in blob.items()}
    for b in range(2):
        n = int(blob2["n_voxels"][b])
        blob2["values"][b, n:] = 55.0
        blob2["coords"][b, n:] = 3
    res2 = tv.forward(blob2)
    for b in range(2):
        n = int(blob["n_voxels"][b])
        np.testing.assert_allclose(res1["softmax"][b, :n].numpy(),
                                   res2["softmax"][b, :n].numpy(), atol=1e-5)
    for key in ("intersection", "union"):
        np.testing.assert_array_equal(res1[key].numpy(), res2[key].numpy())


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without device="cpu" the model, TrainVal, the CLI's train and
    inference and bin/uresnet_torch.py ask for CUDA, and raise where it is
    absent rather than dropping to the CPU."""
    import importlib.util
    import pathlib
    from uresnet_pytorch_tpu_torch import main_funcs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _engine_cfg(io_type="synthetic", log_dir=str(tmp_path))
    for other in (cfg, cfg.replace(sparse_engine="gather"),
                  cfg.replace(model_name="uresnet_dense")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            construct(other.model_name)(other)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainVal(cfg)
    for run in (main_funcs.train, main_funcs.inference):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(cfg)
    spec = importlib.util.spec_from_file_location(
        "uresnet_torch", pathlib.Path(__file__).resolve().parents[1]
        / "bin" / "uresnet_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(["train", "-io", "synthetic", "-ss", "16", "-uns", "3",
                     "-ld", str(tmp_path)])
    model = construct("uresnet_sparse")(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
