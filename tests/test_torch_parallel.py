"""The port's data parallel (uresnet_pytorch_tpu_torch/parallel/, the mesh
part of trainval.py, the global BN moments, loss and metrics) against the
reference's, on the CPU, with two gloo ranks.

The four cases of tests/test_parallel.py (the mesh, data parallel = the
reference, the batch divisibility and minibatch checks) on the port; the
two checks need no ranks: a DataMesh of two built without a process group
fails in `initialize()` before any collective. One module fixture spawns
two ranks once (`parallel.launch`), which write their results to a
temporary directory:

- the tile engine's f32 step on tests/test_parallel.py's configuration and
  events (8 events, each gloo rank one half), from one variables tree (BN
  moments and affines randomized): step 1's loss, summed gradients and new
  moments against the reference's TrainVal on a two-device mesh, whose
  step takes `value_and_grad` of the whole batch, at
  tests/test_torch_train.py's bounds (loss rtol 1e-5, gradients rtol 1e-4
  with atol 1e-4 * max|ref|, moments 1e-5), and three steps' losses at
  rtol 1e-4; parameters bitwise equal across the ranks;
- MaskedBatchNorm alone (and on a pair) against one process on the
  concatenated batch: output, input gradient and moments at 1e-6; the
  same for the BN operator's path (`ops/cuda/norm_act.py`, its kernels'
  plain versions, the sums over the group inside the operator), whose
  ranks' parameter gradients sum to the one process's;
- the dense model's and the gather engine's DP step against the port's own
  one-process step, at the same bounds as the tile engine's.

- `gather_rows` on tensors of four dtypes packed at unaligned offsets:
  rank 0 receives both ranks' copies, rank 1 nothing.

Then the dry run `dryrun_multichip(2)`, the CLI's `train --gpus 0,1` (two
gloo ranks on the CPU: rank 0 alone writes the CSV and the checkpoints),
its `inference -of --gpus 0,1` (rank 0 alone writes the prediction file,
which equals the one-process file), and the loader's per-rank share of a
batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools import io_factory as j_io_factory
from uresnet_pytorch_tpu.models import construct as j_construct
from uresnet_pytorch_tpu.parallel import make_mesh as j_make_mesh
from uresnet_pytorch_tpu.trainval import TrainVal as JTrainVal
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools import io_factory
from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
from uresnet_pytorch_tpu_torch.ops.cuda.norm_act import norm_act_via_op
from uresnet_pytorch_tpu_torch.parallel import (DataMesh, gather_rows,
                                                launch, make_mesh,
                                                shard_batch)
from uresnet_pytorch_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                       example_blob,
                                                       step_result)
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils.weights import init_params
from tests.test_torch_model import one_torch_thread  # noqa: F401

# tests/test_parallel.py's _cfg()
_KW = dict(model_name="uresnet_sparse", num_class=5, uresnet_filters=4,
           uresnet_num_strides=2, spatial_size=16, data_dim=3, reps=1,
           max_voxels=128, min_level_capacity=32, batch_size=8,
           io_type="synthetic", learning_rate=0.01, compute_dtype="float32",
           shuffle=False)
# the other two models, one event a rank
_DENSE = dict(model_name="uresnet_dense", num_class=5, uresnet_filters=4,
              uresnet_num_strides=3, spatial_size=16, data_dim=2, reps=1,
              max_voxels=128, leaky_relu_slope=0.1, batch_size=2,
              compute_dtype="float32")
_GATHER = dict(_KW, sparse_engine="gather", uresnet_num_strides=3,
               batch_size=2, leaky_relu_slope=0.1)


def _blob(io_factory_fn, cfg):
    """tests/test_parallel.py's _blob: the synthetic loader's first batch."""
    io = io_factory_fn(cfg, n_events=8, mean_voxels=60)
    io.initialize()
    blob = io.next()
    io.finalize()
    return blob


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v, np.float32)
    return out


def _bn_inputs():
    """(x, x2, mask, cotangents) of a masked BN over 4 events: f32, with a
    channel offset so that the moments are not trivial."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4, 30, 5)) * 2 + 1).astype(np.float32)
    x2 = rng.normal(size=(4, 30, 3)).astype(np.float32)
    mask = rng.random((4, 30)) > 0.3
    ct = rng.normal(size=(4, 30, 8)).astype(np.float32)
    return x, x2, mask, ct


def _bn_run(x, x2, mask, ct):
    """MaskedBatchNorm in train mode on x and on the pair (x, x2): the
    outputs, the input gradients and the moments of each, as numpy."""
    out = {}
    for name, parts in (("single", (x,)), ("pair", (x, x2))):
        bn = MaskedBatchNorm(sum(p.shape[-1] for p in parts))
        bn.mesh = make_mesh(devices="cpu")
        with torch.no_grad():
            bn.scale.copy_(torch.linspace(0.5, 1.5, bn.scale.numel()))
            bn.bias.copy_(torch.linspace(-1, 1, bn.bias.numel()))
        ts = [torch.from_numpy(p).requires_grad_(True) for p in parts]
        y = bn(tuple(ts) if len(ts) > 1 else ts[0], torch.from_numpy(mask),
               train=True)
        y = torch.cat(y, -1) if isinstance(y, tuple) else y
        (y * torch.from_numpy(ct[..., :y.shape[-1]])).sum().backward()
        out[name] = {"y": y.detach().numpy(),
                     "dx": [t.grad.numpy() for t in ts],
                     "moments": [m.numpy() for m in bn.batch_moments]}
    # the BN operator's path (its kernels' plain versions on the CPU), its
    # sums over the process group inside the operator, with the
    # activation and the re-mask; each rank's d_scale and d_bias its own
    for name, parts in (("op single", (x,)), ("op pair", (x, x2))):
        C = sum(p.shape[-1] for p in parts)
        scale = torch.linspace(0.5, 1.5, C).requires_grad_(True)
        bias = torch.linspace(-1, 1, C).requires_grad_(True)
        ts = [torch.from_numpy(p).requires_grad_(True) for p in parts]
        y, moments = norm_act_via_op(
            tuple(ts) if len(ts) > 1 else ts[0], torch.from_numpy(mask),
            scale, bias, torch.zeros(C), torch.ones(C), train=True,
            remask=True, folded=True, slope=0.1, eps=1e-4,
            dtype=torch.float32, mesh=make_mesh(devices="cpu"))
        y = torch.cat(y, -1) if isinstance(y, tuple) else y
        (y * torch.from_numpy(ct[..., :y.shape[-1]])).sum().backward()
        out[name] = {"y": y.detach().numpy(),
                     "dx": [t.grad.numpy() for t in ts],
                     "moments": [m.numpy() for m in moments],
                     "dparams": [scale.grad.numpy(), bias.grad.numpy()]}
    return out


def _dp_step(kw, variables, blob, steps=1):
    """Steps of a `TrainVal` on the CPU (under a process group: data
    parallel): step 1's loss, gradients and moments, every step's loss
    and the parameters after the last."""
    tv = TrainVal(TConfig(**kw), device="cpu")
    tv.initialize(variables)
    first = step_result(tv, blob)
    losses = [first["loss"]] + [float(tv.train_step(blob)["loss"])
                                for _ in range(steps - 1)]
    params = {k: p.detach().numpy().copy()
              for k, p in tv.model.named_parameters()}
    return dict(first, losses=losses, params=params)


def _ranks(out_dir, variables, blob, dense, gather, bn):
    """Each rank's work in the module's one spawn (data parallel over the
    process group that `launch` made)."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    res = {"tile": _dp_step(_KW, variables, blob, steps=3),
           "dense": _dp_step(_DENSE, *dense),
           "gather": _dp_step(_GATHER, *gather)}
    x, x2, mask, ct = bn
    half = slice(2 * rank, 2 * rank + 2)
    res["bn"] = _bn_run(x[half], x2[half], mask[half], ct[half])
    res["gathered"] = gather_rows(make_mesh(devices="cpu"),
                                  *_gather_inputs(rank))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _gather_inputs(rank):
    """Rank r's tensors for gather_rows: 12 bytes of int32 ahead of an
    int64, so the int64 starts at an offset that is no multiple of 8."""
    return (torch.arange(3, dtype=torch.int32) + 10 * rank,
            torch.tensor([2 ** 40 + rank, -rank], dtype=torch.int64),
            torch.full((2, 3), 0.5 + rank, dtype=torch.float32),
            torch.tensor([rank == 1, True]))


def _variables(kw, seed):
    """init_params with the BN affines and running moments randomized, so
    every BN term and the moment update are non-trivial."""
    variables = init_params(TConfig(**kw), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "MaskedBatchNorm_0" not in name and "BatchNorm_0" not in name:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return np.abs(leaf + noise) if "'var'" in name else leaf + noise
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _reference_steps(variables, blob, steps):
    """The reference's TrainVal on a 2-device mesh from `variables`: every
    step's loss, and step 1's gradient and new moments. The gradient is the
    one its jitted `value_and_grad` of the whole sharded batch handed to
    Adam, read back from Adam's first moment (mu = (1 - b1) * g after one
    step). The reference runs remat "none" (remat changes no value and
    "none" compiles fastest); its parameters come from `variables`, so
    `initialize()`'s init program is not compiled."""
    cfg = URESNetConfig(**dict(_KW, remat_mode="none"))
    tv = JTrainVal(cfg, mesh=j_make_mesh(device_ids=[0, 1]))
    tv.model = j_construct("uresnet_sparse")(cfg)
    tv.tx = optax.adam(cfg.learning_rate)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tv.state = {"step": jnp.zeros((), jnp.int32), "params": params,
                "batch_stats": jax.tree_util.tree_map(
                    jnp.asarray, variables["batch_stats"]),
                "opt_state": tv.tx.init(params)}
    tv._build_steps()
    losses = [float(tv.train_step(blob)["loss"])]
    state = jax.device_get(tv.state)
    mu = state["opt_state"][0].mu
    grads = _flat(jax.tree_util.tree_map(lambda m: m / 0.1, mu))
    losses += [float(tv.train_step(blob)["loss"]) for _ in range(steps - 1)]
    return losses, grads, _flat(state["batch_stats"])


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks' results, with what they are held to: the reference's
    2-device steps, and the port's one-process dense and gather steps and
    BN."""
    blob = _blob(j_io_factory, URESNetConfig(**_KW))
    port_blob = _blob(io_factory, TConfig(**_KW))
    variables = _variables(_KW, 3)
    dense = (_variables(_DENSE, 1), example_blob(TConfig(**_DENSE), 2, 120))
    gather = (_variables(_GATHER, 2), example_blob(TConfig(**_GATHER), 2, 60))
    bn = _bn_inputs()
    out_dir = str(tmp_path_factory.mktemp("dp"))
    launch(_ranks, 2, args=(out_dir, variables, port_blob, dense, gather,
                            bn))
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    losses, grads, stats = _reference_steps(variables, blob, 3)
    return {"blob": blob, "port_blob": port_blob, "ranks": ranks,
            "ref": (losses[0], grads, stats), "ref_losses": losses,
            "dense": _dp_step(_DENSE, *dense),
            "gather": _dp_step(_GATHER, *gather),
            "bn": _bn_run(*bn)}


def _hold_step(got, loss, grads, stats):
    """tests/test_torch_train.py's f32 bounds."""
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert sorted(got["grads"]) == sorted(grads)
    for name, ref in grads.items():
        np.testing.assert_allclose(
            got["grads"][name], ref, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
    assert sorted(got["stats"]) == sorted(stats)
    for name, ref in stats.items():
        np.testing.assert_allclose(got["stats"][name], ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_mesh_construction():
    """Without a process group: a world of one, its device as asked; one
    ordinal picks that card; a mesh's shard of a blob is its rows."""
    mesh = make_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.group) == (
        1, 0, torch.device("cpu"), None)
    assert make_mesh(device_ids=[3]).device == torch.device("cuda", 3)
    blob = {"n_voxels": np.arange(8), "values": np.arange(16).reshape(8, 2)}
    shard = shard_batch(blob, DataMesh(size=4, rank=2))
    np.testing.assert_array_equal(shard["n_voxels"], [4, 5])
    np.testing.assert_array_equal(shard["values"], [[8, 9], [10, 11]])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"n_voxels": np.arange(6)}, DataMesh(size=4))


def test_dp_matches_reference(dp):
    """Two gloo ranks' step 1 against the reference's full-batch gradient
    and moments, and three steps' losses, from its 2-device TrainVal."""
    for k in dp["blob"]:
        np.testing.assert_array_equal(dp["port_blob"][k], dp["blob"][k])
    for r, got in enumerate(dp["ranks"]):
        _hold_step(got["tile"], *dp["ref"])
        np.testing.assert_allclose(got["tile"]["losses"], dp["ref_losses"],
                                   rtol=1e-4, err_msg=f"rank {r}")


def test_ranks_agree_bitwise(dp):
    a, b = (r["tile"] for r in dp["ranks"])
    assert a["losses"] == b["losses"]
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name],
                                      err_msg=name)


@pytest.mark.parametrize("case", ["single", "pair", "op single", "op pair"])
def test_batch_norm_moments_span_the_ranks(dp, case):
    """Each rank's half against one process on the whole batch (the
    operator's parameter gradients: the ranks' sum)."""
    want = dp["bn"][case]
    if "dparams" in want:
        for i, w in enumerate(want["dparams"]):
            got = sum(r["bn"][case]["dparams"][i] for r in dp["ranks"])
            np.testing.assert_allclose(got, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())
    for r, got in enumerate(dp["ranks"]):
        got = got["bn"][case]
        half = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], want["y"][half], rtol=1e-6,
                                   atol=1e-6)
        for g, w in zip(got["dx"], want["dx"]):
            np.testing.assert_allclose(g, w[half], rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
        for g, w in zip(got["moments"], want["moments"]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_gather_rows_hands_rank0_every_rank(dp):
    got = dp["ranks"][0]["gathered"]
    assert dp["ranks"][1]["gathered"] is None
    want = [torch.stack(t) for t in zip(*map(_gather_inputs, range(2)))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # without a process group: each tensor as it is, under an axis of one
    one = gather_rows(make_mesh(devices="cpu"), *_gather_inputs(0))
    assert all(torch.equal(g, t[None])
               for g, t in zip(one, _gather_inputs(0)))


@pytest.mark.parametrize("model", ["dense", "gather"])
def test_other_models_take_a_dp_step(dp, model):
    want = dp[model]
    for got in dp["ranks"]:
        _hold_step(got[model], want["loss"], want["grads"], want["stats"])


def test_batch_divisibility_enforced():
    tv = TrainVal(TConfig(**dict(_KW, batch_size=3)),
                  mesh=DataMesh(size=2))
    with pytest.raises(ValueError, match="not divisible"):
        tv.initialize()


def test_minibatch_size_semantics():
    TrainVal(TConfig(**dict(_KW, minibatch_size=4)),
             mesh=DataMesh(size=2)).initialize()   # 4 a rank x 2 == 8: ok
    tv = TrainVal(TConfig(**dict(_KW, minibatch_size=2)),
                  mesh=DataMesh(size=2))
    with pytest.raises(ValueError, match="minibatch"):
        tv.initialize()


def test_dryrun_multichip(capsys):
    dryrun_multichip(2)
    assert "dryrun_multichip(2): ok, loss=" in capsys.readouterr().out


def _cli():
    """bin/uresnet_torch.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "uresnet_torch_cli", os.path.join(os.path.dirname(__file__), "..",
                                          "bin", "uresnet_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def test_cli_trains_on_two_ranks(tmp_path, monkeypatch):
    """`bin/uresnet_torch.py train --gpus 0,1` on the CPU: two gloo ranks;
    rank 0 alone writes the log and the checkpoints, which hold the
    replicated state, and a fresh process restores it."""
    cli = _cli()
    argv = ["train", "-io", "synthetic", "-bs", "2", "-it", "2", "-rs", "1",
            "-chks", "2", "-mn", "uresnet_sparse", "-ss", "16", "-uns", "2",
            "-uf", "4", "--max-voxels", "128", "-nt", "1", "--gpus", "0,1",
            "-wp", str(tmp_path / "w" / "snap"), "-ld", str(tmp_path / "log")]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the ranks inherit it
    cli.main(argv, device="cpu")
    rows = (tmp_path / "log" / "train_log.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("iter,epoch,loss")
    assert sorted(os.listdir(tmp_path / "w")) == ["snap-2.ckpt"]


def test_cli_inference_writes_on_two_ranks(tmp_path, monkeypatch):
    """`bin/uresnet_torch.py inference -of ... --gpus 0,1` on the CPU: two
    gloo ranks over two checkpoints of 10 shuffled events at batch 4, so
    the second pass wraps an epoch inside a batch (each rank's strided
    share holds 5). Rank 0 alone writes the file, and it is the
    one-process run's: entries, row_splits, coords and values bitwise,
    softmax within 1e-6 of its largest magnitude."""
    import h5py
    from uresnet_pytorch_tpu_torch.iotools.h5_io import generate_h5_file
    cli = _cli()
    h5 = generate_h5_file(str(tmp_path / "events.h5"), n_events=10,
                          spatial_size=16, data_dim=3, seed=7,
                          mean_voxels=120)
    base = ["-io", "h5", "-if", h5, "-bs", "4", "-ss", "16", "-uns", "2",
            "-uf", "4", "--reps", "1", "--max-voxels", "256",
            "--compute-dtype", "float32", "-nt", "1"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the ranks inherit it
    cli.main(["train", *base, "-it", "2", "-chks", "1", "-rs", "1",
              "-wp", str(tmp_path / "w" / "snap"),
              "-ld", str(tmp_path / "train")], device="cpu")
    files = {}
    for name, gpus in (("one", []), ("two", ["--gpus", "0,1"])):
        files[name] = tmp_path / f"{name}.h5"
        cli.main(["inference", *base, *gpus,
                  "-mp", str(tmp_path / "w" / "snap-*.ckpt"),
                  "-of", str(files[name]), "-ld", str(tmp_path / name)],
                 device="cpu")
    with h5py.File(files["two"]) as a, h5py.File(files["one"]) as b:
        pa, pb = a["prediction"], b["prediction"]
        assert len(pb["entries"]) == 16            # 2 checkpoints x 2 x 4
        for key in ("entries", "row_splits", "coords", "values"):
            assert pa[key].dtype == pb[key].dtype, key
            np.testing.assert_array_equal(pa[key][()], pb[key][()],
                                          err_msg=key)
        sa, sb = pa["softmax"][()], pb["softmax"][()]
        assert sa.dtype == sb.dtype == np.float32
        np.testing.assert_allclose(sa, sb, rtol=0,
                                   atol=1e-6 * np.abs(sb).max())
        # the second pass's first batch crosses the epoch: the two events
        # the first pass left, then the next epoch's
        entries = pb["entries"][()]
        assert set(entries[8:10]) == set(range(10)) - set(entries[:8])


def test_loader_ranks_share_the_batch():
    """Under two ranks each loader draws batch_size / 2 events of its
    strided share; a step's two batches are the one-process batch's
    events."""
    cfg = TConfig(**dict(_KW, shuffle=True, seed=5))
    one = io_factory(cfg, n_events=16, mean_voxels=20)
    shares = [io_factory(cfg, n_events=16, mean_voxels=20) for _ in range(2)]
    for r, io in enumerate(shares):
        io.sampler_stride, io.sampler_offset = 2, r
    for _ in range(3):
        want = one._next_indices()
        got = [io._next_indices() for io in shares]
        assert [len(g) for g in got] == [4, 4]
        assert sorted(np.concatenate(got)) == sorted(want)

