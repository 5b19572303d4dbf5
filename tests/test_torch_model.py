"""The port's whole inference slice against the JAX reference: the same
weights (loaded by name with load_jax_variables) and the same events through
uresnet_pytorch_tpu_torch's UResNetSparseTiled and the reference's, on the
CPU, where the port runs the plain torch versions of its kernels.

f32 logits agree to rtol = atol = 1e-4 (the cross-engine bound of
tests/test_tile_engine.py), on either tile conv path; the port's bf16 run
must agree with them on the class of nearly every voxel. A subprocess pins
that the port imports neither jax, flax nor the reference package and
builds no CUDA kernel when it runs on CPU tensors; a scan of the sources
pins the same for chip_smoke.py, which runs where there is no JAX."""

import ast
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.ops import tile_conv
from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                     load_jax_variables)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a test module. The suite runs in six
    workers on a few cores, and torch's threads spin while they wait: with
    one per core in every worker a small CPU step takes tens of times its
    time alone (test_shape_rule_picks_the_path_per_conv: 3.5 s alone, 169 s
    in the suite). The port's test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_KW = dict(num_class=5, uresnet_filters=4, uresnet_num_strides=3,
           spatial_size=16, data_dim=3, reps=1, max_voxels=256,
           min_level_capacity=32, tile_size=4, min_tiles=64,
           tile_sizes=(4, 2, 2), leaky_relu_slope=0.1)


def _cfg(dtype):
    """The reference's configuration."""
    return URESNetConfig(compute_dtype=dtype, **_KW)


def _tcfg(dtype):
    """The same configuration in the port."""
    return TConfig(compute_dtype=dtype, **_KW)


def _events(cfg, B=2):
    coords = np.zeros((B, cfg.max_voxels, 3), np.int32)
    values = np.zeros((B, cfg.max_voxels), np.float32)
    nv = np.zeros((B,), np.int32)
    for b in range(B):
        c, v, _ = generate_event(4, b, cfg.spatial_size, 3, 120)
        n = min(len(c), cfg.max_voxels)
        coords[b, :n], values[b, :n], nv[b] = c[:n], v[:n], n
    return coords, values, nv


def _reference(cfg, args):
    """Variables (BN stats and affines randomized so every fold is
    non-trivial) and the reference's eval logits with them. The tree comes
    from init_params, whose layout test_init_params_follows_reference_tree
    pins: it saves compiling the reference's init."""
    model = j_construct("uresnet_sparse")(cfg)
    variables = init_params(_tcfg(cfg.compute_dtype),
                            torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "MaskedBatchNorm_0" not in name:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return np.abs(leaf + noise) if "'var'" in name else leaf + noise
    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    out = jax.jit(model.apply, static_argnames=("train",))(
        variables, *args, train=False)
    return variables, np.asarray(out)


def _port(cfg, variables, args):
    model = construct("uresnet_sparse")(cfg, device="cpu")
    load_jax_variables(model, variables)
    with torch.no_grad():
        logits, diag = model(*(torch.from_numpy(a) for a in args))
    assert int(diag["overflow"]) == 0
    assert int(diag["tile_spill"]) == 0 and int(diag["vox_spill"]) == 0
    return logits.numpy()


@pytest.fixture(scope="module")
def f32_reference():
    cfg = _cfg("float32")
    args = _events(cfg)
    variables, ref = _reference(cfg, args)
    return variables, args, ref


@pytest.mark.parametrize("use_fused", [None, False])
def test_slice_f32_matches_reference(f32_reference, monkeypatch, use_fused):
    """Auto (kernel B's plain version on the CPU) and the unfused tile conv
    (kernel D's plain extend, a VALID conv, the epilogue in torch)."""
    monkeypatch.setattr(tile_conv, "USE_FUSED", use_fused)
    variables, args, ref = f32_reference
    out = _port(_tcfg("float32"), variables, args)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    for b, n in enumerate(args[2]):
        assert (out[b, n:] == 0).all()


def test_slice_bf16_class_agreement(f32_reference):
    """The port in bf16 (the card's compute dtype) classifies nearly every
    voxel as the f32 reference does, with bf16-sized logit errors."""
    variables, args, ref = f32_reference
    out = _port(_tcfg("bfloat16"), variables, args)
    nv = args[2]
    agree = sum((out[b, :n].argmax(-1) == ref[b, :n].argmax(-1)).sum()
                for b, n in enumerate(nv))
    # random weights leave near-ties between classes: over these ~185
    # voxels 0.98 allows three flips
    assert agree / nv.sum() > 0.98, agree / nv.sum()
    for b, n in enumerate(nv):
        scale = np.maximum(np.abs(ref[b, :n]), 1.0)
        assert np.quantile(np.abs(out[b, :n] - ref[b, :n]) / scale,
                           0.99) < 5e-2


def test_load_jax_variables_rejects_bad_trees():
    cfg = _tcfg("float32")
    model = construct("uresnet_sparse")(cfg, device="cpu")
    good = init_params(cfg, torch.Generator().manual_seed(0))
    load_jax_variables(model, good)
    bad = init_params(cfg, torch.Generator().manual_seed(0))
    bad["params"]["head_w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_jax_variables(model, bad)
    del bad["params"]["head_w"]
    with pytest.raises(KeyError):
        load_jax_variables(model, bad)
    bad = init_params(cfg, torch.Generator().manual_seed(0))
    bad["batch_stats"]["stem"] = {"mean": np.zeros(4, np.float32)}
    with pytest.raises(KeyError):
        load_jax_variables(model, bad)


def test_init_params_follows_reference_tree():
    """init_params gives the reference's tree: same names and shapes as
    flax's init, seeded by the generator."""
    cfg = _cfg("float32")
    args = _events(cfg)
    ref = jax.eval_shape(
        lambda *a: j_construct("uresnet_sparse")(cfg).init(
            jax.random.PRNGKey(0), *a, train=False), *args)
    ours = init_params(_tcfg("float32"), torch.Generator().manual_seed(1))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    for coll in ("params", "batch_stats"):
        assert shapes(ours[coll]) == shapes(dict(ref[coll]))
    again = init_params(_tcfg("float32"), torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(ours["params"]["stem"]["w"],
                                  again["params"]["stem"]["w"])
    w = ours["params"]["enc1_block0"]["conv_a"]["w"]
    assert abs(w.std() - (2.0 / (27 * 8)) ** 0.5) < 0.03


_IMPORT_CHECK = """
import sys
import torch
import uresnet_pytorch_tpu_torch, uresnet_pytorch_tpu_torch.models
import uresnet_pytorch_tpu_torch.trainval
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.ops import cuda
from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                     load_jax_variables)
from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
cfg = URESNetConfig(uresnet_filters=4, uresnet_num_strides=2, spatial_size=16,
                    max_voxels=64, min_level_capacity=16, reps=1,
                    compute_dtype="float32")
model = construct("uresnet_sparse")(cfg, device="cpu")
load_jax_variables(model, init_params(cfg, torch.Generator().manual_seed(0)))
coords = torch.randint(0, 16, (1, 64, 3), dtype=torch.int32)
with torch.no_grad():
    logits, _ = model(coords, torch.ones(1, 64),
                      torch.tensor([64], dtype=torch.int32))
assert logits.shape == (1, 64, 5) and torch.isfinite(logits).all()
import uresnet_pytorch_tpu_torch.utils.scn_import
import uresnet_pytorch_tpu_torch.utils.torch_import
import uresnet_pytorch_tpu_torch.scn
import uresnet_pytorch_tpu_torch.parallel.dryrun
for other in (cfg.replace(sparse_engine="gather"),
              cfg.replace(model_name="uresnet_dense")):
    model = construct(other.model_name)(other, device="cpu")
    with torch.no_grad():
        logits, _ = model(coords, torch.ones(1, 64),
                          torch.tensor([64], dtype=torch.int32))
    assert logits.shape == (1, 64, 5) and torch.isfinite(logits).all()
assert cuda._lib is None, "a CUDA kernel library was built or loaded"
assert len(generate_event(0, 0, 16, 3, 64)[0]) > 0
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "flax", "uresnet_pytorch_tpu")))
"""


def test_port_imports_no_jax_and_builds_nothing():
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("path", ["chip_smoke.py", "uresnet_pytorch_tpu_torch",
                                  "bin/uresnet_torch.py"])
def test_sources_import_nothing_of_jax_or_the_reference(path):
    """Every import statement, at any depth (chip_smoke imports inside
    main), names neither jax, flax nor the reference package."""
    root = _ROOT / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "flax", "uresnet_pytorch_tpu"), (f, name)
