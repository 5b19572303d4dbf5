"""The port's CLI against the reference's: the same argv parses into the
same configuration; over the same checkpoints (written by the reference's
`main_funcs.train`) and the same h5 file, the port's `main_funcs.inference`
writes the reference's `inference_log.csv` rows and prediction file, on
the CPU in f32.

Tolerances: CSV values to 1e-4 relative (atol 1e-6 for the six decimals
the CSV keeps of a Python float), softmax to 1e-4, argmax agreement at
least 0.999, and coords, row_splits and entries exactly. The reference
runs on one CPU device (`--gpus 0`) at two levels, whose programs compile
in half the time of three, and in the configuration of
tests/test_torch_checkpoint.py, so either file's reference programs can
come from the persistent JAX cache the other filled."""

import csv
import importlib.util
import os
import pathlib

import h5py
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu import main_funcs as j_main_funcs
from uresnet_pytorch_tpu.flags import parse_args as j_parse_args
from uresnet_pytorch_tpu.iotools.h5_io import generate_h5_file
from uresnet_pytorch_tpu_torch import main_funcs
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.flags import URESNET_FLAGS, parse_args
from tests.test_torch_model import one_torch_thread  # noqa: F401

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _base(h5):
    return ["-io", "h5", "-if", h5, "-bs", "2", "-ss", "16", "-uns", "2",
            "-uf", "4", "--reps", "1", "--max-voxels", "256",
            "--compute-dtype", "float32", "-nt", "1", "--gpus", "0",
            "-lr", "0.01", "--remat-mode", "none"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several workers at once: one intra-op thread keeps
    this file's tiny torch steps from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_then_both(tmp, base):
    """The reference trains 2 iterations (a checkpoint each), then both
    packages run inference over the checkpoint glob with -of: {"ref" /
    "ours": (summary, inference_log.csv rows, prediction file)}."""
    _, cfg = j_parse_args(["train", *base, "-it", "2", "-chks", "1", "-rs",
                           "1", "-wp", str(tmp / "w" / "snap"),
                           "-ld", str(tmp / "train_log")])
    j_main_funcs.train(cfg)
    out = {}
    for name, parse, run, kw in (
            ("ref", j_parse_args, j_main_funcs.inference, {}),
            ("ours", parse_args, main_funcs.inference, {"device": "cpu"})):
        _, cfg = parse(["inference", *base,
                        "-mp", str(tmp / "w" / "snap-*.ckpt"),
                        "-of", str(tmp / f"{name}_pred.h5"),
                        "-ld", str(tmp / f"{name}_log")])
        summary = run(cfg, **kw)
        out[name] = (summary, _rows(tmp / f"{name}_log" / "inference_log.csv"),
                     str(tmp / f"{name}_pred.h5"))
    return out


def _events_h5(tmp):
    return generate_h5_file(str(tmp / "events.h5"), n_events=8,
                            spatial_size=16, data_dim=3, seed=7,
                            mean_voxels=120)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sparse model (tile engine) through _reference_then_both."""
    tmp = tmp_path_factory.mktemp("cli")
    return tmp, _reference_then_both(tmp, _base(_events_h5(tmp)))


def _dense_base(h5):
    return [*_base(h5), "-mn", "uresnet_dense"]


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """The dense model through _reference_then_both."""
    tmp = tmp_path_factory.mktemp("dense_cli")
    return tmp, _reference_then_both(tmp, _dense_base(_events_h5(tmp)))


def test_inference_csv_matches_reference(runs):
    _, out = runs
    _check_csv_rows(out)


def _check_csv_rows(out):
    ours, ref = out["ours"][1], out["ref"][1]
    assert [r["ckpt"] for r in ours] == [r["ckpt"] for r in ref] == [
        "snap-1.ckpt", "snap-2.ckpt"]
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for key in b:
            if key in ("ckpt", "events_per_sec"):
                continue
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
        assert float(a["events_per_sec"]) > 0
    assert out["ours"][0]["ckpt"] == "snap-2.ckpt"


def test_prediction_file_matches_reference(runs):
    _, out = runs
    _check_prediction_files(out)


def _check_prediction_files(out):
    with h5py.File(out["ours"][2]) as a, h5py.File(out["ref"][2]) as b:
        pa, pb = a["prediction"], b["prediction"]
        for key in ("coords", "row_splits", "entries"):
            np.testing.assert_array_equal(pa[key][()], pb[key][()],
                                          err_msg=key)
        np.testing.assert_allclose(pa["softmax"][()], pb["softmax"][()],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(pa["values"][()],
                                      pa["softmax"][()].argmax(-1))
        agree = (pa["values"][()] == pb["values"][()]).mean()
        assert agree >= 0.999, agree
        assert len(pa["entries"]) == 16          # 2 checkpoints x 8 events


@pytest.mark.parametrize("argv", [
    ["train", "-io", "synthetic", "-bs", "4", "-it", "7", "-rs", "2",
     "-chks", "3", "-wp", "w/s", "-ld", "l", "--tile-sizes", "4,2,2,2,2",
     "--remat-mode", "stage_dots", "-lr", "1e-3", "--capacity-factor", "0.5",
     "-uf", "16", "-uns", "5", "-ss", "512", "--gpus", "1", "--resume"],
    ["inference", "-io", "h5", "-if", "a.h5,b.h5", "-of", "p.h5", "-mp",
     "w/s-*.ckpt", "-dkeys", "data,label,weight", "-wk", "weight", "-sh",
     "0", "-lnf", "1", "-nt", "3", "-mbs", "2", "-bs", "2",
     "--compute-dtype", "float32", "--profile-dir", "prof", "-mn",
     "uresnet_dense", "--width-ramp", "geometric", "-dd", "2", "-nc", "3",
     "-ss", "64"],
    ["iotest", "-io", "synthetic", "-bs", "8", "-it", "5", "--seed", "3",
     "--max-voxels", "4096", "--reps", "1", "-ss", "64"],
])
def test_parse_args_gives_the_references_fields(argv):
    mode, ours = parse_args(argv)
    ref_mode, ref = j_parse_args(argv)
    assert mode == ref_mode == argv[0]
    for field in ours.__dataclass_fields__:
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.train == (mode == "train")
    assert ours.BATCH_SIZE == ours.batch_size and ours.dim == ours.data_dim
    assert URESNET_FLAGS().parse_args(argv) == ours
    assert ours.replace(seed=9).seed == 9


def test_script_trains_and_profiles(tmp_path, runs):
    """bin/uresnet_torch.py's main: 2 iterations on the CPU, a checkpoint
    and a CSV row each, and a Chrome trace in --profile-dir."""
    spec = importlib.util.spec_from_file_location(
        "uresnet_torch", _ROOT / "bin" / "uresnet_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    h5 = str(runs[0] / "events.h5")
    script.main(["train", *_base(h5), "-it", "2", "-chks", "1", "-rs", "1",
                 "-wp", str(tmp_path / "w" / "snap"),
                 "-ld", str(tmp_path / "log"),
                 "--profile-dir", str(tmp_path / "prof")], device="cpu")
    assert sorted(os.listdir(tmp_path / "w")) == ["snap-1.ckpt",
                                                  "snap-2.ckpt"]
    rows = _rows(tmp_path / "log" / "train_log.csv")
    assert [r["iter"] for r in rows] == ["1", "2"]
    assert list(rows[0]) == [
        "iter", "epoch", "loss", "accuracy", "titer", "tio", "tforward",
        "tbackward", "tsave", "lr", "overflow", "tile_spill"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_resumed_training_continues_the_count(tmp_path, runs):
    """--resume picks up the reference's snap-2 and trains to -it 3: one
    more row and a checkpoint at 3."""
    tmp, _ = runs
    h5 = str(tmp / "events.h5")
    w = tmp_path / "w"
    w.mkdir()
    (w / "snap-2.ckpt").write_bytes((tmp / "w" / "snap-2.ckpt").read_bytes())
    _, cfg = parse_args(["train", *_base(h5), "-it", "3", "-chks", "5",
                         "-rs", "1", "--resume", "-wp", str(w / "snap"),
                         "-ld", str(tmp_path / "log")])
    tv = main_funcs.train(cfg, device="cpu")
    assert tv.global_step == 3
    assert [r["iter"] for r in _rows(tmp_path / "log" / "train_log.csv")] \
        == ["3"]
    assert sorted(os.listdir(w)) == ["snap-2.ckpt", "snap-3.ckpt"]


def test_iotest_reports_a_positive_rate(runs):
    _, cfg = parse_args(["iotest", *_base(str(runs[0] / "events.h5")),
                         "-it", "3"])
    assert main_funcs.iotest(cfg) > 0


def test_dense_inference_matches_reference(dense_runs):
    """`-mn uresnet_dense` over the reference's dense checkpoints: the
    reference's CSV rows and prediction file."""
    _, out = dense_runs
    _check_csv_rows(out)
    _check_prediction_files(out)


def test_dense_train_then_inference(tmp_path, dense_runs):
    """The port trains the dense model through the CLI (3 iterations, a
    checkpoint at 3, a CSV row each), then infers over its checkpoint
    with -of (tests/test_dense.py's end-to-end run)."""
    h5 = str(dense_runs[0] / "events.h5")
    _, cfg = parse_args(["train", *_dense_base(h5), "-it", "3", "-chks",
                         "3", "-rs", "1", "-wp", str(tmp_path / "w" / "snap"),
                         "-ld", str(tmp_path / "log")])
    tv = main_funcs.train(cfg, device="cpu")
    assert tv.global_step == 3
    assert sorted(os.listdir(tmp_path / "w")) == ["snap-3.ckpt"]
    rows = _rows(tmp_path / "log" / "train_log.csv")
    assert [r["iter"] for r in rows] == ["1", "2", "3"]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert {r["overflow"] for r in rows} == {r["tile_spill"] for r in rows} \
        == {"0"}
    _, icfg = parse_args(["inference", *_dense_base(h5),
                          "-mp", str(tmp_path / "w" / "snap-*.ckpt"),
                          "-of", str(tmp_path / "pred.h5"), "-it", "2",
                          "-ld", str(tmp_path / "log")])
    summary = main_funcs.inference(icfg, device="cpu")
    assert summary["ckpt"] == "snap-3.ckpt" and "accuracy" in summary
    with h5py.File(tmp_path / "pred.h5") as f:
        g = f["prediction"]
        assert g["softmax"].shape[1] == 5
        assert g["coords"].shape[0] == g["softmax"].shape[0] > 0
        assert g["row_splits"][-1] == g["coords"].shape[0]


def test_dense_iotest(dense_runs):
    _, cfg = parse_args(["iotest", *_dense_base(
        str(dense_runs[0] / "events.h5")), "-it", "3"])
    assert cfg.model_name == "uresnet_dense"
    assert main_funcs.iotest(cfg) > 0


def test_several_gpus_need_a_process_group():
    """Several ordinals in one process: the ranks are started by
    parallel.launch (bin/uresnet_torch.py does so for --gpus 0,1)."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    with pytest.raises(ValueError, match="parallel.launch"):
        TrainVal(TConfig(gpus=(0, 1), spatial_size=32), device="cpu")


def test_minibatch_size_must_be_the_batch_on_one_card():
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    cfg = TConfig(batch_size=2, minibatch_size=1, spatial_size=32)
    with pytest.raises(ValueError, match="minibatch_size"):
        TrainVal(cfg, device="cpu").initialize()
    tv = TrainVal(cfg.replace(minibatch_size=2, uresnet_num_strides=2,
                              max_voxels=256), device="cpu")
    tv.initialize()
    assert tv.global_step == 0
