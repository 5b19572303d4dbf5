"""The port's upstream-checkpoint importers against the JAX reference's, on
synthetic state dicts built as tests/test_torch_import.py and
tests/test_scn_import.py build them (the repository holds no upstream
checkpoint).

Trees and state dicts must be equal to the reference's, array for array;
a torch file written with `module.` prefixes round-trips; mismatches
raise; and a gather-engine model loaded with an imported tree gives the
logits of the tree that was exported, to 1e-6.
"""

import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.utils import scn_import as j_scn
from uresnet_pytorch_tpu.utils import torch_import as j_ti
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.utils import scn_import as t_scn
from uresnet_pytorch_tpu_torch.utils import torch_import as t_ti
from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                     load_jax_variables)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_SPARSE = dict(model_name="uresnet_sparse", sparse_engine="gather",
               num_class=5, uresnet_filters=4, uresnet_num_strides=3,
               spatial_size=16, data_dim=3, reps=2, max_voxels=256,
               min_level_capacity=32, batch_size=1, compute_dtype="float32")
_DENSE = dict(model_name="uresnet_dense", num_class=5, uresnet_filters=2,
              uresnet_num_strides=2, spatial_size=8, data_dim=3, reps=1,
              max_voxels=32, batch_size=1, compute_dtype="float32")


def _tree(kw, seed):
    return init_params(TConfig(**kw), torch.Generator().manual_seed(seed))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name)
        else:
            yield name, np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        np.testing.assert_array_equal(la[name], lb[name], err_msg=name)


def _assert_dicts_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_dense_kernel_layouts():
    w = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6)
    f = t_ti.dense_kernel_to_flax(w)
    np.testing.assert_array_equal(f, j_ti.dense_kernel_to_flax(w))
    np.testing.assert_array_equal(t_ti.dense_kernel_to_torch(f), w)
    assert w[1, 2, 3, 4, 5] == f[3, 4, 5, 2, 1]
    s = np.zeros((27, 3, 4), np.float32)
    assert t_ti.scn_kernel_to_stack(s, 3).shape == (27, 3, 4)
    for bad in (np.zeros((81, 4)), np.zeros((3, 3, 3, 4))):
        with pytest.raises(ValueError):
            t_ti.scn_kernel_to_stack(bad, 3)
    bn = {f"bn.{k}": np.full(3, i, np.float32) for i, k in enumerate(
        ("weight", "bias", "running_mean", "running_var"))}
    for ours, ref in zip(t_ti.bn_to_flax("bn", bn),
                         j_ti.bn_to_flax("bn", bn)):
        _assert_trees_equal(ours, ref)


@pytest.mark.parametrize("kw", [_SPARSE, _DENSE], ids=["sparse", "dense"])
def test_export_import_roundtrip_through_torch_file(kw, tmp_path):
    """The dense tree takes the kernel transpose, the `up0_deconv` kernel
    included (the reference's treatment, which the port keeps)."""
    src, dst = _tree(kw, 0), _tree(kw, 1)
    sd = t_ti.export_state_dict(src["params"], src["batch_stats"])
    _assert_dicts_equal(sd, j_ti.export_state_dict(src["params"],
                                                   src["batch_stats"]))
    assert any(k.endswith("running_mean") for k in sd)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"global_step": 7,
                "state_dict": {"module." + k: torch.from_numpy(
                    np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    sd2 = t_ti.load_torch_state_dict(path)
    assert set(sd2) == set(sd) and t_ti.global_step_of(path) == 7
    _assert_dicts_equal({k: sd2[k] for k in sd}, sd)
    ours = t_ti.import_state_dict(dst["params"], dst["batch_stats"], sd2)
    ref = j_ti.import_state_dict(dst["params"], dst["batch_stats"], sd2)
    for a, b, c in zip(ours, ref, (src["params"], src["batch_stats"])):
        _assert_trees_equal(a, b)
        _assert_trees_equal(a, c)
    if kw is _DENSE:
        k = sd["core.up0_deconv.kernel"]
        assert k.shape == (2, 4, 2, 2, 2)   # (O, I, *k) as for a conv


def test_import_mismatch_raises():
    params = {"layer": {"w": np.zeros((2, 3), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        t_ti.import_state_dict(params, {},
                               {"layer.w": np.zeros((3, 2), np.float32)})
    with pytest.raises(KeyError):
        t_ti.import_state_dict(params, {}, {})


@pytest.mark.parametrize("reps", [1, 2])
def test_scn_slots_groups_and_export_match_reference(reps):
    kw = dict(_SPARSE, reps=reps)
    tree = _tree(kw, 0)
    tcfg, jcfg = TConfig(**kw), URESNetConfig(**kw)
    slots = t_scn.reference_slot_sequence(tcfg)
    assert slots == j_scn.reference_slot_sequence(jcfg)
    sd = t_scn.export_reference_style(tcfg, tree["params"],
                                      tree["batch_stats"])
    _assert_dicts_equal(sd, j_scn.export_reference_style(
        jcfg, tree["params"], tree["batch_stats"]))
    assert "linear.weight" in sd and "linear.bias" in sd
    kinds = [g["kind"] for g in t_scn.classify_groups(sd, 3)]
    assert kinds == [g["kind"] for g in j_scn.classify_groups(sd, 3)]
    assert kinds == [s["kind"] for s in slots]
    assert kinds[0] == "smconv" and kinds[-1] == "linear" and "nin" in kinds


def _events(cfg):
    coords = np.zeros((1, cfg.max_voxels, 3), np.int32)
    values = np.zeros((1, cfg.max_voxels), np.float32)
    c, v, _ = generate_event(3, 0, cfg.spatial_size, 3, 120)
    n = min(len(c), cfg.max_voxels)
    coords[0, :n], values[0, :n] = c[:n], v[:n]
    return [torch.from_numpy(a) for a in
            (coords, values, np.array([n], np.int32))]


def test_scn_import_matches_reference_and_keeps_the_forward():
    cfg = TConfig(**_SPARSE)
    src, dst = _tree(_SPARSE, 0), _tree(_SPARSE, 7)
    sd = t_scn.export_reference_style(cfg, src["params"], src["batch_stats"])
    p, s = t_scn.import_reference_state_dict(cfg, dst["params"],
                                             dst["batch_stats"], sd)
    rp, rs = j_scn.import_reference_state_dict(
        URESNetConfig(**_SPARSE), dst["params"], dst["batch_stats"], sd)
    _assert_trees_equal(p, rp)
    _assert_trees_equal(s, rs)
    model = construct("uresnet_sparse")(cfg, device="cpu")
    args = _events(cfg)
    outs = []
    for variables in (src, {"params": p, "batch_stats": s}):
        load_jax_variables(model, variables)
        with torch.no_grad():
            outs.append(model(*args)[0].numpy())
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)


def test_scn_mismatch_fails_loud():
    kw = dict(_SPARSE, reps=1)
    cfg = TConfig(**kw)
    tree = _tree(kw, 0)
    sd = t_scn.export_reference_style(cfg, tree["params"],
                                      tree["batch_stats"])
    short = dict(sd)
    short.pop("sparseModel.0.weight")
    with pytest.raises(ValueError, match="mismatch"):
        t_scn.import_reference_state_dict(cfg, tree["params"],
                                          tree["batch_stats"], short)
    wrong = dict(sd)
    wrong["linear.weight"] = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError, match="linear"):
        t_scn.import_reference_state_dict(cfg, tree["params"],
                                          tree["batch_stats"], wrong)
