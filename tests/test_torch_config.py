"""The port's own configuration and event generator against the
reference's: the port may import nothing of the JAX package, so it carries
copies of both, and these tests hold the copies to the originals."""

import dataclasses
import warnings

import numpy as np
import pytest

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import (
    generate_event as t_generate_event)
from tests.test_torch_model import one_torch_thread  # noqa: F401

_CONFIG3 = dict(uresnet_filters=16, uresnet_num_strides=5, spatial_size=512,
                reps=2, max_voxels=131072, capacity_factor=0.5,
                min_level_capacity=2048, tile_size=4, tile_occupancy=4.5,
                tile_sizes=(4, 2, 2, 2, 2), compute_dtype="bfloat16")
# config 4 as benchmarks/run_all.py's _sparse_cfg(False, 2) builds it
_CONFIG4 = dict(_CONFIG3, batch_size=2, remat_mode="stage_dots",
                learning_rate=0.001)
_TRAINING_FIELDS = ("bn_momentum", "remat_mode", "batch_size",
                    "learning_rate", "seed", "weight_key", "model_path",
                    "resume", "param_dtype")


def test_fields_are_the_references_with_its_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(URESNetConfig)}
    ours = dataclasses.fields(TConfig)
    assert len(ours) > 0
    for f in ours:
        assert f.name in ref, f.name
        assert f.default == ref[f.name], f.name
    names = {f.name for f in ours}
    assert all(name in names for name in _TRAINING_FIELDS)


@pytest.mark.parametrize("kw", [
    {},                                              # defaults, auto capacity
    _CONFIG3,                                        # config 3
    _CONFIG4,                                        # config 4
    dict(uresnet_filters=4, uresnet_num_strides=3, spatial_size=16,
         max_voxels=256, min_level_capacity=32, tile_sizes=(4, 2, 2)),
    dict(data_dim=2, spatial_size=64, uresnet_num_strides=4,
         width_ramp="geometric", tile_occupancies=(3.0, 3.0, 2.0, 2.0)),
    dict(spatial_size=100, uresnet_num_strides=3),   # padded to 128
])
def test_derived_sizes_match_reference(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, ours = URESNetConfig(**kw), TConfig(**kw)
    for f in dataclasses.fields(TConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.n_planes == ref.n_planes
    for l in range(ref.uresnet_num_strides):
        assert ours.level_spatial_size(l) == ref.level_spatial_size(l)
        assert ours.level_capacity(l) == ref.level_capacity(l)
        assert ours.tile_occupancy_at(l) == ref.tile_occupancy_at(l)


@pytest.mark.parametrize("kw", [
    dict(data_dim=4),
    dict(width_ramp="cubic"),
    dict(input_merge_mode="median"),
    dict(tile_size=3),
    dict(tile_sizes=(4, 4)),
    dict(tile_sizes=(4, 8, 4, 2, 2)),
    dict(tile_occupancies=(1.0,)),
    dict(spatial_size=16, uresnet_num_strides=5),
    dict(remat_mode="full"),
])
def test_rejects_what_the_reference_rejects(kw):
    kw = {"spatial_size": 64, **kw}
    with pytest.raises(ValueError):
        URESNetConfig(**kw)
    with pytest.raises(ValueError):
        TConfig(**kw)


@pytest.mark.parametrize("seed,index,size,dim,mean", [
    (0, 0, 512, 3, 2048),
    (0, 5, 512, 3, 30000),       # several particles of each kind
    (4, 1, 16, 3, 120),          # the model tests' events
    (7, 3, 64, 2, 500),
])
def test_generate_event_matches_reference(seed, index, size, dim, mean):
    ref = generate_event(seed, index, size, dim, mean)
    ours = t_generate_event(seed, index, size, dim, mean)
    for r, o in zip(ref, ours):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
