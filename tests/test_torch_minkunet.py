"""MinkUNet34C on the tile engine (`models/minkunet_tiled.py`) against the
plain float32 reference `tests/plain_minkunet.py`, on the CPU, where the
port runs the plain torch versions of its kernels.

Two events of about 300 voxels at 32^3 over the model's five levels, one
seeded tree handed to both: at the published widths (PLANES, LAYERS,
INIT_DIM) and at a narrow copy. The port's eval logits, then one train
step as `TrainVal.train_step` takes it (f32, stage_dots: the loss, every
gradient, and the BN running moments committed after the step). The
bounds and why (f32 readings at the published widths; the same run in
bf16 reads each in brackets, so each bound fails bf16 where f32 is
stated):

- eval logits: max |d| over max |ref| <= 1e-5 (1.3e-7; bf16 6.2e-3);
- train loss: relative <= 1e-5 (0; bf16 7.2e-5);
- gradient, against the reference run in f64: 1 - cosine of the whole
  gradient <= 1e-4 (1.1e-6; bf16 0.12), the median leaf's gap of the
  difference's norm over the reference's <= 1e-4 (5e-6; bf16 0.56), and
  every leaf's <= 2e-2 (5e-3 at `enc1_block0.conv1.w`; bf16 reads ~1).
  With 12 sites at level 4 under 256-wide BNs the network amplifies
  round-off into the gradient: the plain reference's own f32 run sits
  3.3e-4 from its f64 run at that leaf, so an f32 reference would hold the
  port to the sum of two such errors; the f64 run is the witness;
- BN running moments after the step: relative <= 1e-4 (4.7e-6; bf16
  4.2e-2).

Also: the benchmark's copy of the reference (`perfbench/reference/
minkunet34c.py`) against this one, the configuration's checks, and
`TrainVal` steps, a checkpoint round trip and the CLI's training of the
registered model."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import plain_minkunet as pm
from tests.test_torch_model import one_torch_thread  # noqa: F401
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.models import construct
from uresnet_pytorch_tpu_torch.models import minkunet_tiled as mt
from uresnet_pytorch_tpu_torch.models.losses import segmentation_loss
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils.weights import _nest, load_jax_variables

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-5
_KW = dict(model_name="minkunet34c", num_class=5, spatial_size=32,
           uresnet_num_strides=5, max_voxels=512, min_level_capacity=64,
           tile_size=4, tile_sizes=(4, 2, 2, 2, 2), compute_dtype="float32",
           bn_eps=EPS, bn_momentum=0.9, remat_mode="stage_dots",
           batch_size=2, learning_rate=1e-3)
WIDTHS = {"published": (pm.PLANES, pm.LAYERS, pm.INIT_DIM),
          "narrow": ((8, 8, 16, 16, 16, 8, 8, 8), (1, 1, 2, 1, 1, 1, 1, 1),
                     8)}


def _blob(seed=7, B=2, V=512):
    blob = {"coords": np.zeros((B, V, 3), np.int32),
            "values": np.zeros((B, V), np.float32),
            "label": np.zeros((B, V), np.int32),
            "n_voxels": np.zeros((B,), np.int32)}
    for b in range(B):
        c, v, lab = generate_event(seed, b, 32, 3, mean_voxels=450)
        n = min(len(c), V)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = lab[:n], n
    return blob


def _tree(params):
    def coll(stats):
        return _nest({k: v.numpy() for k, v in params.items()
                      if k.endswith((".mean", ".var")) == stats})
    return {"params": coll(False), "batch_stats": coll(True)}


def _grads(params, blob, layers, dtype, ref=pm) -> dict:
    """The plain reference's train-mode gradients in `dtype`."""
    p = {k: v.to(dtype) for k, v in params.items()}
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()
              if not k.endswith((".mean", ".var"))}
    lg, _ = ref.logits(dict(p, **leaves), blob, 32, 5, EPS, True, layers)
    loss = ref.masked_ce(lg, ref.voxel_rows(blob, "label"))
    return dict(zip(leaves, torch.autograd.grad(loss,
                                                list(leaves.values()))))


_RUNS: dict = {}


def _run(widths: str) -> dict:
    """The port's and the reference's readings at `widths`, computed once:
    the port's eval logits, then one train step as `TrainVal.train_step`
    takes it (train forward, the masked loss, backward, the BN moments
    committed)."""
    if widths in _RUNS:
        return _RUNS[widths]
    planes, layers, init_dim = WIDTHS[widths]
    cfg = TConfig(**_KW)
    blob = _blob()
    args = [torch.from_numpy(blob[k]) for k in ("coords", "values",
                                                 "n_voxels")]
    params = pm.make_params(pm.param_spec(5, planes, layers, init_dim), 11)
    model = mt.MinkUNet34CTiled(cfg, planes=planes, layers=layers,
                                init_dim=init_dim)
    load_jax_variables(model, _tree(params))
    n = blob["n_voxels"]
    with torch.no_grad():
        eval_logits, _ = model(*args)
    eval_logits = torch.cat([eval_logits[b, :n[b]] for b in range(len(n))])
    logits, _ = model(*args, train=True)
    loss = segmentation_loss(logits, torch.from_numpy(blob["label"]),
                             args[2])["loss"]
    loss.backward()
    commit_batch_moments(model)
    grads = {k: p.grad for k, p in model.named_parameters()}
    moments = dict(model.named_buffers())
    # the reference: eval, one train-mode forward, and its gradients in
    # f64 (see the module's docstring)
    ref_eval, _ = pm.logits(params, blob, 32, 5, EPS, False, layers)
    ref_logits, net = pm.logits(params, blob, 32, 5, EPS, True, layers)
    ref_loss = pm.masked_ce(ref_logits, pm.voxel_rows(blob, "label"))
    ref_grads = _grads(params, blob, layers, torch.float64)
    ref_moments = {}
    for name, (mu, va) in net.moments.items():
        ref_moments[f"{name}.mean"] = 0.9 * params[f"{name}.mean"] + 0.1 * mu
        ref_moments[f"{name}.var"] = 0.9 * params[f"{name}.var"] + 0.1 * va
    _RUNS[widths] = dict(
        eval=(eval_logits, ref_eval),
        loss=(float(loss.detach()), float(ref_loss)),
        grads=(grads, ref_grads), moments=(moments, ref_moments))
    return _RUNS[widths]


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_eval_logits_match_plain(widths):
    got, ref = _run(widths)["eval"]
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_train_loss_matches_plain(widths):
    got, ref = _run(widths)["loss"]
    assert abs(got - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_every_gradient_matches_plain(widths):
    got, ref = _run(widths)["grads"]
    assert set(got) == set(ref)
    gaps = {k: float((got[k].double() - ref[k].double()).norm()
                     / ref[k].double().norm().clamp(min=1e-30)) for k in ref}
    assert max(gaps.values()) <= 2e-2, max(gaps.items(), key=lambda kv:
                                           kv[1])
    assert float(np.median(list(gaps.values()))) <= 1e-4
    a = torch.cat([got[k].double().flatten() for k in ref])
    b = torch.cat([ref[k].double().flatten() for k in ref])
    assert 1.0 - float(a @ b / (a.norm() * b.norm())) <= 1e-4


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_bn_moments_after_one_step_match_plain(widths):
    got, ref = _run(widths)["moments"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert float((got[k] - v).abs().max()) <= 1e-4 * float(
            v.abs().max()), k


def test_benchmark_reference_is_this_reference():
    """The benchmark's copy (`perfbench/reference/minkunet34c.py`, built on
    `perfbench/reference/sparse.py`) and this one have the same tree and
    give the same eval logits (f32, 1e-6 of the largest) and train-mode
    gradients, run in f64 to 1e-6 of each leaf's norm (the benchmark's
    loss takes its softmax in f32; in f32 the two orders of summation
    differ by up to 3% on a level-4 leaf of this tiny case, the network's
    amplification of round-off, see the module's docstring)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_minkunet34c",
        ROOT / "perfbench" / "reference" / "minkunet34c.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    model = dict(num_class=5, spatial_size=32, bn_eps=EPS,
                 leaky_relu_slope=0.0)
    assert {n: s for n, s, _ in bench.param_spec(model)} == \
        {n: s for n, s, _ in pm.param_spec(5)}
    params = pm.make_params(pm.param_spec(5), 13)
    blob = _blob(seed=8)
    got = bench.infer(model, params, blob, "cpu")
    ref, _ = pm.logits(params, blob, 32, 5, EPS, False)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6
    p64 = {k: v.double() for k, v in params.items()}
    _, g_bench = bench.loss_and_grads(bench.net(model), model, p64, blob,
                                      "cpu")
    for k, g in _grads(params, blob, pm.LAYERS, torch.float64).items():
        assert float((g_bench[k] - g).norm()) <= 1e-6 * float(g.norm()), k


def test_config_takes_the_name_and_the_model_its_levels():
    """The name is a value of `model_name`, no new field; the model needs
    its five levels on tiles of (4, 2, 2, 2, 2) and the tile engine."""
    cfg = TConfig(**_KW)
    assert cfg.model_name == "minkunet34c"
    model = construct("minkunet34c")(cfg, device="cpu")
    assert (model.planes, model.layers, model.init_dim) == (
        mt.PLANES, mt.LAYERS, mt.INIT_DIM)
    assert tuple(model.stem.w.shape) == (125, 1, 32)
    assert tuple(model.head_w.shape) == (96, 5)
    for bad in (dict(uresnet_num_strides=4, tile_sizes=(4, 2, 2, 2)),
                dict(tile_sizes=(4, 4, 2, 2, 2)),
                dict(sparse_engine="gather")):
        with pytest.raises(ValueError):
            construct("minkunet34c")(TConfig(**dict(_KW, **bad)),
                                     device="cpu")
    with pytest.raises(ValueError, match="model_name"):
        TConfig(**dict(_KW, model_name="minkunet18"))


def test_trainval_steps_and_checkpoint_round_trip(tmp_path):
    """Two CPU steps of the registered model through `TrainVal` (falling
    loss on one batch), a checkpoint, and a fresh `TrainVal` restored from
    it that gives the same eval logits."""
    cfg = TConfig(**dict(_KW, weight_prefix=str(tmp_path / "snap")))
    blob = _blob(seed=5)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    losses = [float(tv.train_step(blob)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    path = tv.save_state(2)
    tv2 = TrainVal(cfg.replace(model_path=path), device="cpu")
    tv2.initialize()
    assert tv2.global_step == 2
    a, b = tv.forward(blob)["softmax"], tv2.forward(blob)["softmax"]
    assert torch.equal(a, b)


def test_cli_trains_the_model(tmp_path):
    """`-mn minkunet34c` through the CLI: two training iterations on
    synthetic events, a checkpoint each, on the tile engine."""
    from uresnet_pytorch_tpu_torch import main_funcs
    from uresnet_pytorch_tpu_torch.flags import parse_args
    _, cfg = parse_args(["train", "-io", "synthetic", "-mn", "minkunet34c",
                         "-ss", "32", "-uns", "5", "--max-voxels", "512",
                         "--tile-sizes", "4,2,2,2,2", "--compute-dtype",
                         "float32", "-bs", "2", "-it", "2", "-chks", "1",
                         "-wp", str(tmp_path / "snap"),
                         "-ld", str(tmp_path / "log")])
    assert cfg.model_name == "minkunet34c"
    tv = main_funcs.train(cfg, device="cpu")
    assert isinstance(tv.model, mt.MinkUNet34CTiled)
    assert tv.global_step == 2
    assert sorted(p.name for p in tmp_path.glob("snap-*.ckpt")) == [
        "snap-1.ckpt", "snap-2.ckpt"]
