"""The port's checkpoints: its own files round-trip bitwise, and a
checkpoint the JAX reference wrote (flax msgpack) restores into the port.

The reference's side is built once, in a module fixture, at a tiny f32
size on one CPU device: initialize, one train step, `save_state(1)`, its
eval forward, then a second train step. The configuration is the one
tests/test_torch_cli.py's flags give (two levels), so the reference
compiles the same three programs there and the persistent JAX cache can
serve one file's from the other's. The port restores that file: its eval
forward agrees (loss at rtol 1e-5, softmax at 1e-4 * max|ref|), and its
own second step agrees on every parameter at rtol 1e-4 with atol 1e-4 *
max|ref| of the leaf, which holds only if optax's `count`, `mu` and `nu`
came across as torch's `step`, `exp_avg` and `exp_avg_sq`."""

import os
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.trainval import TrainVal as JTrainVal
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                        latest_checkpoint,
                                                        restore_checkpoint,
                                                        save_checkpoint)
from uresnet_pytorch_tpu_torch.utils.weights import _flatten
from tests.test_torch_model import one_torch_thread  # noqa: F401

# tests/test_torch_cli.py's flags: `-bs 2 -ss 16 -uns 2 -uf 4 --reps 1
# --max-voxels 256 --compute-dtype float32 -lr 0.01 --remat-mode none`
_KW = dict(uresnet_filters=4, uresnet_num_strides=2, spatial_size=16,
           reps=1, max_voxels=256, batch_size=2, compute_dtype="float32",
           learning_rate=0.01, remat_mode="none")


def _blob(seed, B=2, max_voxels=256):
    blob = {"coords": np.zeros((B, max_voxels, 3), np.int32),
            "values": np.zeros((B, max_voxels), np.float32),
            "label": np.zeros((B, max_voxels), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b in range(B):
        c, v, l = generate_event(seed, b, 16, 3, 120)
        n = min(len(c), max_voxels)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    return blob


def _flat_np(tree):
    return {n: np.asarray(v) for n, v in _flatten(tree)}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several workers at once: one intra-op thread keeps
    this file's tiny torch steps from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(checkpoint path, eval forward after step 1, params after step 2)
    of the reference, and the two blobs it trained on."""
    tmp = tmp_path_factory.mktemp("ref_ckpt")
    cfg = URESNetConfig(gpus=(0,), weight_prefix=str(tmp / "snap"), **_KW)
    tv = JTrainVal(cfg)
    tv.initialize()
    b1, b2 = _blob(4), _blob(5)
    tv.train_step(b1)
    path = tv.save_state(1)
    res = jax.device_get(tv.forward(b1))
    tv.train_step(b2)
    params = _flat_np(jax.device_get(tv.state["params"]))
    return path, res, params, b1, b2


def test_reference_checkpoint_restores_into_the_port(reference):
    path, ref, _, b1, _ = reference
    with open(path, "rb") as f:
        assert f.read(2) != b"PK"          # flax msgpack, not a torch zip
    tv = TrainVal(TConfig(model_path=path, **_KW), device="cpu")
    tv.initialize()
    assert tv.global_step == 1
    res = tv.forward(b1)
    np.testing.assert_allclose(float(res["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    sm = np.asarray(ref["softmax"])
    np.testing.assert_allclose(res["softmax"].numpy(), sm, rtol=0,
                               atol=1e-4 * np.abs(sm).max())


def test_reference_adam_state_carries_over(reference):
    path, _, ref_params, _, b2 = reference
    tv = TrainVal(TConfig(model_path=path, **_KW), device="cpu")
    tv.initialize()
    tv.train_step(b2)
    assert tv.global_step == 2
    ours = {n: p.detach().numpy() for n, p in tv.model.named_parameters()}
    assert sorted(ours) == sorted(ref_params)
    for name, ref in ref_params.items():
        np.testing.assert_allclose(ours[name], ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=name)


def _state(tv):
    params = {n: p.detach().clone() for n, p in tv.model.named_parameters()}
    buffers = {n: b.clone() for n, b in tv.model.named_buffers()}
    adam = {n: {k: v.clone() for k, v in tv.optimizer.state[p].items()}
            for n, p in tv.model.named_parameters()}
    return params, buffers, adam


def test_port_checkpoint_resumes_bitwise(tmp_path):
    """2 steps, save, restore into a fresh TrainVal, 1 more step: params,
    BN moments and Adam state equal 3 uninterrupted steps bitwise."""
    cfg = TConfig(weight_prefix=str(tmp_path / "snap"), **_KW)
    blobs = [_blob(s) for s in (4, 5, 6)]
    straight = TrainVal(cfg, device="cpu")
    straight.initialize()
    for b in blobs:
        straight.train_step(b)
    first = TrainVal(cfg, device="cpu")
    first.initialize()
    for b in blobs[:2]:
        first.train_step(b)
    path = first.save_state(2)
    assert path == checkpoint_path(cfg.weight_prefix, 2)
    assert sorted(os.listdir(tmp_path)) == ["snap-2.ckpt"]   # no .tmp left
    resumed = TrainVal(cfg.replace(model_path=path), device="cpu")
    resumed.initialize()
    assert resumed.global_step == 2
    resumed.train_step(blobs[2])
    assert resumed.global_step == straight.global_step == 3
    for want, got in zip(_state(straight), _state(resumed)):
        assert sorted(want) == sorted(got)
        for name in want:
            w, g = want[name], got[name]
            if isinstance(w, dict):
                assert sorted(w) == sorted(g)
                for k in w:
                    assert torch.equal(w[k], g[k]), (name, k)
            else:
                assert torch.equal(w, g), name


def test_checkpoint_tree_is_the_references(tmp_path):
    """The port writes the reference's tree and names: step, params,
    batch_stats and optax's {"0": {count, mu, nu}, "1": {}}."""
    cfg = TConfig(weight_prefix=str(tmp_path / "snap"), **_KW)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    tv.train_step(_blob(4))
    tree = restore_checkpoint(tv.save_state(1))
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "step"]
    assert int(tree["step"]) == 1
    assert sorted(tree["opt_state"]) == ["0", "1"] and tree["opt_state"]["1"] == {}
    adam = tree["opt_state"]["0"]
    assert int(adam["count"]) == 1
    names = sorted(_flat_np(tree["params"]))
    assert sorted(_flat_np(adam["mu"])) == names == sorted(_flat_np(adam["nu"]))


def test_resume_and_latest_pick_the_highest_iteration(tmp_path):
    """--resume takes the highest iteration (snap-10); a model_path glob
    takes the last match in sorted order (snap-2), as in the reference."""
    prefix = str(tmp_path / "snap")
    cfg = TConfig(weight_prefix=prefix, **_KW)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    for it in (2, 10):
        tv.step = it
        tv.save_state(it)
    assert latest_checkpoint(prefix) == f"{prefix}-10.ckpt"
    assert latest_checkpoint(str(tmp_path / "none")) is None
    resumed = TrainVal(cfg.replace(resume=True), device="cpu")
    resumed.initialize()
    assert resumed.global_step == 10
    globbed = TrainVal(cfg.replace(model_path=f"{prefix}-*.ckpt"),
                       device="cpu")
    globbed.initialize()
    assert globbed.global_step == 2
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_flax_array_extensions_decode(tmp_path):
    """bfloat16 arrays (ext 1, dtype named "bfloat16") widen exactly to
    f32; numpy scalars (ext 3) and int arrays keep their values."""
    vals = np.array([[1.5, -2.0, 3.0e-3], [0.0, 7.0, -1e4]], np.float32)
    tree = {"a": jnp.asarray(vals, jnp.bfloat16), "n": np.float32(2.5),
            "i": np.arange(4, dtype=np.int32), "d": {"x": jnp.zeros(())}}
    path = tmp_path / "ref.ckpt"
    path.write_bytes(flax.serialization.to_bytes(tree))
    got = restore_checkpoint(str(path))
    np.testing.assert_array_equal(
        got["a"], np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float32))
    assert got["a"].dtype == np.float32
    assert float(got["n"]) == 2.5
    np.testing.assert_array_equal(got["i"], np.arange(4))
    assert got["d"]["x"].shape == ()


def test_reading_the_reference_format_names_msgpack(tmp_path, monkeypatch):
    path = tmp_path / "ref.ckpt"
    path.write_bytes(flax.serialization.to_bytes({"a": np.zeros(2)}))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        restore_checkpoint(str(path))
    # the port's own format needs no msgpack
    own = save_checkpoint(str(tmp_path / "own.ckpt"),
                          {"a": torch.arange(3)})
    np.testing.assert_array_equal(restore_checkpoint(own)["a"],
                                  np.arange(3))
