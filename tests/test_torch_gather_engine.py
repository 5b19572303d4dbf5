"""The port's row-gather engine against the JAX reference's, on the CPU.

- `build_graph` bitwise: every level's keys, counts, rules (`nbr_idx`
  only where `nbr_ok`: the reference's lookup leaves garbage elsewhere)
  and every link's parents, corners and overflow counts, `row_of_input`,
  `input_valid` and the representative rows, in 3D and 2D and with
  capacities small enough that the coarse levels drop sites;
- `feats0` under each duplicate-merge mode, on events with repeated
  coordinates, with and without a level-0 capacity overflow (to 1e-6
  relative: duplicate sums may add in another order);
- the three conv ops and their gradients (the port's backward is gathers,
  not the reference's scatter-adds) in f32 to 1e-5 * max|ref|;
- the eval forward in f32 to 1e-4 * max|ref|, the port's bf16 against the
  reference's bf16 (p99 of the error over max(|ref|, 1) below 5e-2) with
  class agreement above 0.995 (against the reference's f32, the
  reference's own bf16 run agrees on 0.989 of these voxels: random
  weights at 4 filters leave near-ties), and one f32 train
  step (loss 1e-5 relative, gradients rtol 1e-4 with atol 1e-4 * max|ref|
  per leaf, the running moments 1e-5), in 2D at three levels, whose
  reference programs compile in a third of the 3D ones' time;
- one variables tree loads into both port engines, and the tile engine
  agrees with the gather engine to 1e-4 * max in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu.ops import sparse_conv as j_conv
from uresnet_pytorch_tpu.ops import sparse_graph as j_graph
from uresnet_pytorch_tpu.trainval import TrainVal as JTrainVal
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.models.uresnet_sparse import UResNetSparse
from uresnet_pytorch_tpu_torch.models.uresnet_sparse_tiled import (
    UResNetSparseTiled)
from uresnet_pytorch_tpu_torch.ops import sparse_conv as t_conv
from uresnet_pytorch_tpu_torch.ops import sparse_graph as t_graph
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils.weights import (export_variables,
                                                     init_params,
                                                     load_jax_variables)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_KW = dict(model_name="uresnet_sparse", sparse_engine="gather", num_class=5,
           uresnet_filters=4, uresnet_num_strides=3, spatial_size=16,
           data_dim=3, reps=1, max_voxels=256, min_level_capacity=32,
           leaky_relu_slope=0.1, batch_size=2)
_KW2 = dict(_KW, data_dim=2, spatial_size=32, max_voxels=512)


def _blob(cfg, B=2, mean_voxels=120, seed=4):
    V, dim = cfg.max_voxels, cfg.data_dim
    blob = {"coords": np.zeros((B, V, dim), np.int32),
            "values": np.zeros((B, V), np.float32),
            "label": np.zeros((B, V), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b in range(B):
        c, v, l = generate_event(seed, b, cfg.spatial_size, dim, mean_voxels)
        n = min(len(c), V)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    blob["weight"] = np.where(blob["label"] > 0, 1.0, 0.5).astype(np.float32)
    return blob


def _args(blob):
    return blob["coords"], blob["values"], blob["n_voxels"]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


@pytest.mark.parametrize("kw", [
    dict(_KW),
    dict(_KW2),
    # levels 1-2 hold fewer rows than their parents have sites (level 0
    # holds max_voxels rows: test_input_merge_modes overflows it)
    dict(_KW, max_voxels=256, min_level_capacity=8, capacity_factor=0.1),
], ids=["3d", "2d", "overflow"])
def test_build_graph_bitwise(kw):
    cfg = URESNetConfig(compute_dtype="float32", **kw)
    blob = _blob(cfg, mean_voxels=400 if kw["min_level_capacity"] == 8
                 else 120)
    ref, ref_rep = jax.jit(lambda *a: j_graph.build_graph(*a, cfg))(
        *_args(blob))
    ours, rep = t_graph.build_graph(*_torch(*_args(blob)),
                                    TConfig(compute_dtype="float32", **kw))
    assert len(ours.levels) == len(ref.levels) == 3
    for l, (a, b) in enumerate(zip(ref.levels, ours.levels)):
        _eq(a.keys, b.keys, f"keys {l}")
        _eq(a.num, b.num, f"num {l}")
        _eq(a.nbr_ok, b.nbr_ok, f"nbr_ok {l}")
        ok = np.asarray(a.nbr_ok)
        np.testing.assert_array_equal(np.asarray(a.nbr_idx)[ok],
                                      b.nbr_idx.numpy()[ok], f"nbr_idx {l}")
    for l, (a, b) in enumerate(zip(ref.links, ours.links)):
        _eq(a.parent, b.parent, f"parent {l}")
        _eq(a.offset, b.offset, f"offset {l}")
        _eq(a.overflow, b.overflow, f"overflow {l}")
    for name in ("row_of_input", "input_valid", "feats0"):
        _eq(getattr(ref, name), getattr(ours, name), name)
    _eq(ref_rep, rep, "rep")
    dropped = sum(int(np.asarray(k.overflow).sum()) for k in ref.links)
    if kw["min_level_capacity"] == 8:
        assert dropped > 0


@pytest.mark.parametrize("cap", [256, 32], ids=["fits", "overflow"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max", "last"])
def test_input_merge_modes(mode, cap):
    """Events whose rows repeat coordinates (each voxel of the first half
    appears again, later and with another value)."""
    cfg = URESNetConfig(**_KW)
    blob = _blob(cfg, mean_voxels=60)
    coords, values, nv = (a.copy() for a in _args(blob))
    for b in range(2):
        n = int(nv[b])
        h = n // 2
        coords[b, n:n + h] = coords[b, :h]
        values[b, n:n + h] = -2.0 * values[b, :h] + 0.5
        nv[b] = n + h
    ref = jax.jit(jax.vmap(lambda c, v, n: j_graph.build_input_level(
        c, v, n, 16, cap, mode)))(coords, values, nv)
    ours = t_graph.build_input_level(*_torch(coords, values, nv), 16, cap,
                                     mode)
    for name, a, b in zip(("keys", "num", "feats", "row_of_input", "rep"),
                          ref, ours):
        if name == "feats":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)
        else:
            _eq(a, b, name)
    if cap == 32:
        assert (np.asarray(ref[1]) == cap).all()


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _vjp_check(j_fn, t_fn, inputs, seed):
    """Outputs and the gradients of <out, g> for a random g, w.r.t. every
    input, reference against port."""
    out, vjp = jax.vjp(j_fn, *inputs)
    g = _rand(out.shape, seed)
    ref_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = t_fn(*ts)
    (got * torch.from_numpy(g)).sum().backward()
    for a, b in ((out, got.detach()),
                 *((r, t.grad) for r, t in zip(ref_grads, ts))):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()))


@pytest.fixture(scope="module")
def graph3():
    cfg = URESNetConfig(compute_dtype="float32", **_KW)
    blob = _blob(cfg)
    ref, _ = jax.jit(lambda *a: j_graph.build_graph(*a, cfg))(*_args(blob))
    return ref, blob


def test_submanifold_conv(graph3):
    ref, _ = graph3
    lv = ref.levels[1]
    nbr_idx, nbr_ok = np.asarray(lv.nbr_idx), np.asarray(lv.nbr_ok)
    x, w = _rand(lv.keys.shape + (6,), 0), _rand((27, 6, 5), 1)
    _vjp_check(lambda a, b: j_conv.submanifold_conv(a, nbr_idx, nbr_ok, b),
               lambda a, b: t_conv.submanifold_conv(
                   a, *_torch(nbr_idx, nbr_ok), b), [x, w], 2)


def test_downsample_and_upsample_conv(graph3):
    ref, _ = graph3
    link, fine, coarse = ref.links[0], ref.levels[0], ref.levels[1]
    parent, corner = np.asarray(link.parent), np.asarray(link.offset)
    num_f, cap_c = np.asarray(fine.num), coarse.keys.shape[1]
    xf, wd = _rand(fine.keys.shape + (4,), 3), _rand((8, 4, 6), 4)
    _vjp_check(
        lambda a, b: j_conv.downsample_conv(a, parent, corner, num_f, cap_c,
                                            b),
        lambda a, b: t_conv.downsample_conv(
            a, *_torch(parent, corner, num_f), cap_c, b), [xf, wd], 5)
    xc, wu = _rand(coarse.keys.shape + (6,), 6), _rand((8, 6, 4), 7)
    _vjp_check(
        lambda a, b: j_conv.upsample_conv(a, parent, corner, cap_c, b),
        lambda a, b: t_conv.upsample_conv(a, *_torch(parent, corner), cap_c,
                                          b), [xc, wu], 8)


def _variables(cfg, seed=3):
    """init_params with the BN affines and running moments randomized."""
    variables = init_params(cfg, torch.Generator().manual_seed(seed))
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


@pytest.fixture(scope="module")
def case2d():
    """2D variables, a blob, and the reference's eval logits by dtype."""
    variables = _variables(TConfig(**_KW2))
    blob = _blob(URESNetConfig(**_KW2), mean_voxels=300)
    ref = {}
    for dtype in ("float32", "bfloat16"):
        cfg = URESNetConfig(compute_dtype=dtype, **_KW2)
        ref[dtype] = np.asarray(jax.jit(
            j_construct("uresnet_sparse")(cfg).apply,
            static_argnames=("train",))(variables, *_args(blob),
                                        train=False))
    return variables, blob, ref


def _port_forward(dtype, variables, blob, **kw):
    model = construct("uresnet_sparse")(
        TConfig(compute_dtype=dtype, **{**_KW2, **kw}), device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        logits, diag = model(*_torch(*_args(blob)))
    assert int(diag["overflow"]) == 0
    return model, logits.numpy()


def test_eval_forward_matches_reference(case2d):
    variables, blob, refs = case2d
    ref = refs["float32"]
    model, out = _port_forward("float32", variables, blob)
    assert isinstance(model, UResNetSparse)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
    for b, n in enumerate(blob["n_voxels"]):
        assert (out[b, n:] == 0).all()
    _, out = _port_forward("bfloat16", variables, blob)
    ref = refs["bfloat16"].astype(np.float32)
    nv = blob["n_voxels"]
    agree = sum((out[b, :n].argmax(-1) == ref[b, :n].argmax(-1)).sum()
                for b, n in enumerate(nv)) / nv.sum()
    assert agree > 0.995, agree
    for b, n in enumerate(nv):
        scale = np.maximum(np.abs(ref[b, :n]), 1.0)
        assert np.quantile(np.abs(out[b, :n] - ref[b, :n]) / scale,
                           0.99) < 5e-2


def test_train_step_matches_reference(case2d):
    variables, blob, _ = case2d
    cfg = URESNetConfig(compute_dtype="float32", **_KW2)
    jtv = JTrainVal(cfg)
    jtv.model = j_construct("uresnet_sparse")(cfg)
    batch = {k: jnp.asarray(v) for k, v in blob.items()}
    (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jtv._loss_fn(p, s, b, True), has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    tv = TrainVal(TConfig(compute_dtype="float32", **_KW2), device="cpu")
    tv.initialize(variables)
    metrics = tv._metrics(tv._batch(blob), train=True)
    metrics["loss"].backward()
    commit_batch_moments(tv.model)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in tv.model.named_parameters()}
    ref_grads = _flat(grads)
    assert sorted(got) == sorted(ref_grads)
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(
            got[name], ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
    ours = _flat(export_variables(tv.model)["batch_stats"])
    for name, ref in _flat(stats).items():
        np.testing.assert_allclose(ours[name], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_one_tree_loads_into_both_engines():
    """Both engines draw the same tree from one generator, and the tile
    engine's logits agree with the gather engine's from one tree."""
    kw = dict(_KW, tile_size=4, min_tiles=64, tile_sizes=(4, 2, 2))
    cfg = TConfig(compute_dtype="float32", **kw)
    trees = [init_params(c, torch.Generator().manual_seed(5)) for c in
             (cfg, cfg.replace(sparse_engine="tile"))]
    flat = [_flat(t["params"]) for t in trees]
    assert sorted(flat[0]) == sorted(flat[1])
    for name in flat[0]:
        np.testing.assert_array_equal(flat[0][name], flat[1][name])
    variables = _variables(cfg)
    blob = _blob(URESNetConfig(**_KW))
    outs = []
    for engine, cls in (("gather", UResNetSparse),
                        ("tile", UResNetSparseTiled)):
        model, out = _port_forward("float32", variables, blob,
                                   **dict(kw, sparse_engine=engine))
        assert type(model) is cls
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0,
                               atol=1e-4 * float(np.abs(outs[0]).max()))
