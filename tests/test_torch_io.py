"""The port's IO against the reference's: the same h5 files and synthetic
events give bitwise-equal blobs in the same order, collation agrees on
both of the port's paths (native and NumPy) and with the reference, and
the prediction writer writes the same file. Everything here is host code,
so every comparison is exact."""

import subprocess
import sys

import h5py
import numpy as np
import pytest

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools import io_factory as j_io_factory
from uresnet_pytorch_tpu.iotools.h5_io import generate_h5_file
from uresnet_pytorch_tpu.iotools.pointcloud import (
    blob_to_pointcloud as j_blob_to_pointcloud,
    pointcloud_to_blob as j_pointcloud_to_blob)
from uresnet_pytorch_tpu.iotools.writer import (
    PredictionWriter as JPredictionWriter)
from uresnet_pytorch_tpu.utils import native as j_native
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools import io_factory
from uresnet_pytorch_tpu_torch.iotools import h5_io as t_h5_io
from uresnet_pytorch_tpu_torch.iotools.pointcloud import (blob_to_pointcloud,
                                                          pointcloud_to_blob)
from uresnet_pytorch_tpu_torch.iotools.writer import PredictionWriter
from uresnet_pytorch_tpu_torch.utils import native
from tests.test_torch_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """Events of very different sizes (mean 300 voxels) in the reference's
    file, with a weight key."""
    path = str(tmp_path_factory.mktemp("io") / "events.h5")
    return generate_h5_file(path, n_events=10, spatial_size=32, data_dim=3,
                            seed=7, mean_voxels=300,
                            keys=("data", "label", "weight"))


def _kw(h5_path, **kw):
    base = dict(io_type="h5", input_file=(h5_path,), spatial_size=32,
                data_dim=3, max_voxels=512, batch_size=3, num_threads=1,
                data_keys=("data", "label", "weight"), seed=3)
    base.update(kw)
    return base


def _blobs(factory, cfg, n, **kwargs):
    io = factory(cfg, **kwargs)
    io.initialize()
    try:
        return [io.next() for _ in range(n)]
    finally:
        io.finalize()


def _assert_blobs_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(),                                   # shuffled, h5
    dict(shuffle=False, max_voxels=256),      # in order, events truncated
    dict(io_type="synthetic", weight_key="weight"),
])
def test_blobs_equal_the_references_over_two_epochs(h5_file, kw):
    """Ten events at batch 3: seven batches cross two epoch boundaries, so
    the (seed, epoch) order and the cursor's wrap are both compared. (The
    truncation counter depends on how far the producer ran ahead; the
    collate test compares it.)"""
    kw = _kw(h5_file, **kw)
    extra = ({"n_events": 10, "mean_voxels": 300}
             if kw["io_type"] == "synthetic" else {})
    ours = _blobs(io_factory, TConfig(**kw), 7, **extra)
    ref = _blobs(j_io_factory, URESNetConfig(**kw), 7, **extra)
    _assert_blobs_equal(ours, ref)
    # the first nine events are nine distinct ones of epoch 0
    assert len(set(np.concatenate([b["index"] for b in ours[:3]]))) == 9


@pytest.mark.parametrize("max_voxels", [512, 200])
def test_native_and_numpy_collate_equal_the_references(h5_file, max_voxels):
    """The port's native collate, its NumPy collate and the reference's
    give the same blob and the same truncation count."""
    assert native.available() and j_native.available()
    kw = _kw(h5_file, max_voxels=max_voxels)
    io = io_factory(TConfig(**kw))
    events = [io._read_event(i) for i in range(4)]
    idx = np.arange(4)
    n_cut = sum(len(ev["data"][0]) > max_voxels for ev in events)
    got = {}
    for path in ("native", "python"):
        io.truncated = 0
        got[path] = getattr(io, f"_collate_{path}")(events, idx, 4,
                                                    max_voxels, 3)
        assert io.truncated == n_cut, path
    ref_io = j_io_factory(URESNetConfig(**kw))
    ref = ref_io.collate(events, idx)
    assert ref_io.truncated == n_cut
    if max_voxels == 200:
        assert n_cut > 0
    _assert_blobs_equal([got["native"], got["python"]], [ref, ref])
    io.finalize()
    ref_io.finalize()


def test_native_keys_and_dedup_equal_the_references():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2, 34, size=(300, 3)).astype(np.int32)
    np.testing.assert_array_equal(native.encode_keys(coords, 32),
                                  j_native.encode_keys(coords, 32))
    coords = rng.integers(0, 6, size=(300, 3)).astype(np.int32)
    values = rng.normal(size=300).astype(np.float32)
    for mode in ("sum", "mean", "max", "last"):
        for a, b in zip(native.dedup(coords, values, 8, mode),
                        j_native.dedup(coords, values, 8, mode)):
            np.testing.assert_array_equal(a, b, err_msg=mode)


def test_native_library_builds_outside_the_kernel_sources():
    """The host library builds under build/torch_native/, and its source
    lies outside csrc/, whose every file feeds the CUDA library's hash."""
    from uresnet_pytorch_tpu_torch.ops import cuda
    assert native.available()
    assert native.library_path().parent.name == "torch_native"
    assert native.library_path().exists()
    assert not any(p.name == "uresnet_native.cpp"
                   for p in cuda.CSRC.rglob("*"))


def test_h5_reader_and_writer_round_trip(tmp_path, h5_file):
    """The port's write_events writes what the reference reads, and its
    reader reads the reference's file, through the memmap fast path."""
    ref = t_h5_io.H5Reader([h5_file], ["data", "label"])
    events = {k: [ref.read(i)[k] for i in range(len(ref))]
              for k in ("data", "label")}
    path = str(tmp_path / "copy.h5")
    t_h5_io.write_events(path, events, 32, 3)
    from uresnet_pytorch_tpu.iotools.h5_io import H5Reader as JH5Reader
    back = JH5Reader([path], ["data", "label"])
    assert len(back) == len(ref) == 10
    assert all(m is not None for m in ref._mmaps[0]["data"])
    for i in range(10):
        for k in ("data", "label"):
            for a, b in zip(back.read(i)[k], events[k][i]):
                np.testing.assert_array_equal(a, b)
    ref.close()
    back.close()


def test_pointcloud_round_trip(h5_file):
    blob = _blobs(io_factory, TConfig(**_kw(h5_file)), 1)[0]
    pc = blob_to_pointcloud(blob)
    np.testing.assert_array_equal(pc, j_blob_to_pointcloud(blob))
    lab = blob_to_pointcloud(blob, key="label")
    back = pointcloud_to_blob(pc, 512, 3, label_pc=lab)
    ref = j_pointcloud_to_blob(pc, 512, 3, label_pc=lab)
    _assert_blobs_equal([back], [ref])
    for k in ("coords", "values", "n_voxels", "label"):
        np.testing.assert_array_equal(back[k], blob[k], err_msg=k)


def test_prediction_writer_writes_the_references_file(tmp_path, h5_file):
    """Three batches through writers that flush every ~600 rows: the same
    datasets, bitwise."""
    blobs = _blobs(io_factory, TConfig(**_kw(h5_file)), 3)
    rng = np.random.default_rng(1)
    files = {}
    for name, cls, cfg_cls in (("ours", PredictionWriter, TConfig),
                               ("ref", JPredictionWriter, URESNetConfig)):
        files[name] = str(tmp_path / f"{name}.h5")
        w = cls(cfg_cls(**_kw(h5_file, output_file=files[name])),
                flush_rows=600)
        for blob in blobs:
            sm = rng.dirichlet(np.ones(5), size=(3, 512)).astype(np.float32)
            w.store_segment(blob["index"], blob, sm)
        w.close()
        rng = np.random.default_rng(1)
    with h5py.File(files["ours"]) as a, h5py.File(files["ref"]) as b:
        assert dict(a["meta"].attrs) == dict(b["meta"].attrs)
        assert sorted(a["prediction"]) == sorted(b["prediction"]) == [
            "coords", "entries", "row_splits", "softmax", "values"]
        for k in b["prediction"]:
            x, y = a["prediction"][k][()], b["prediction"][k][()]
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert len(a["prediction/entries"]) == 9


def test_io_factory_types():
    with pytest.raises(NotImplementedError, match="larcv"):
        io_factory(TConfig(io_type="larcv_sparse", spatial_size=32))
    with pytest.raises(ValueError, match="unknown io_type"):
        io_factory(TConfig(io_type="root", spatial_size=32))


_SYNTHETIC_ONLY = """
import sys
from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools import io_factory
io = io_factory(URESNetConfig(io_type="synthetic", spatial_size=32,
                              max_voxels=256, batch_size=2), n_events=4,
                mean_voxels=50)
io.initialize()
assert io.next()["coords"].shape == (2, 256, 3)
io.finalize()
print("h5py" in sys.modules)
"""


def test_synthetic_io_never_imports_h5py():
    """The card is not known to have h5py: `-io synthetic` must not need
    it."""
    res = subprocess.run([sys.executable, "-c", _SYNTHETIC_ONLY],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
