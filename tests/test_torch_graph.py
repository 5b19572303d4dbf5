"""The port's tile graph (uresnet_pytorch_tpu_torch/ops/tile_graph.py) against
the JAX reference's build_tile_graph, on the same synthetic events.

Integer graph data must match bitwise: keys, counts, occupancy, voxel maps,
spills, halo neighbor maps, and the link gathers. The reference splits a
link's rows into an in-window `ok` plus a correction list; the port keeps
the full `ok`, so it is held to the union of the two."""

import jax
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu.ops import tile_graph as jtg
from uresnet_pytorch_tpu_torch.ops import tile_graph as ttg
from tests.test_torch_model import one_torch_thread  # noqa: F401


def _cfgs(**kw):
    """The same configuration in the reference and in the port."""
    base = dict(num_class=5, uresnet_filters=4,
                uresnet_num_strides=3, spatial_size=16, data_dim=3, reps=1,
                max_voxels=256, min_level_capacity=32,
                compute_dtype="float32", tile_size=4, min_tiles=64)
    base.update(kw)
    return URESNetConfig(**base), TConfig(**base)


def _events(cfg, mean_voxels, seed=0, B=2):
    coords = np.zeros((B, cfg.max_voxels, cfg.data_dim), np.int32)
    values = np.zeros((B, cfg.max_voxels), np.float32)
    nv = np.zeros((B,), np.int32)
    for b in range(B):
        c, v, _ = generate_event(seed, b, cfg.spatial_size, cfg.data_dim,
                                 mean_voxels)
        n = min(len(c), cfg.max_voxels)
        coords[b, :n], values[b, :n], nv[b] = c[:n], v[:n], n
    return coords, values, nv


def _full_ok(spec):
    """Reference GatherSpec rows served: in-window ok + corrected rows."""
    ok = np.asarray(spec.ok).copy()
    dst, cok = np.asarray(spec.corr_dst), np.asarray(spec.corr_ok)
    for b in range(ok.shape[0]):
        ok[b, dst[b][cok[b]]] = True
    return ok


def _eq(port, ref, what):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref),
                                  err_msg=what)


def _eq_where(port, ref, ok, what):
    np.testing.assert_array_equal(port.cpu().numpy()[ok], np.asarray(ref)[ok],
                                  err_msg=what)


@pytest.mark.parametrize("kw,mean_voxels", [
    (dict(tile_sizes=(4, 2, 2)), 100),     # identity link, then a real one
    (dict(), 100),                         # global t=4, 3 strides
])
def test_tile_graph_matches_reference(kw, mean_voxels):
    cfg, tcfg = _cfgs(**kw)
    coords, values, nv = _events(cfg, mean_voxels)
    ref = jax.jit(lambda c, v, n: jtg.build_tile_graph(c, v, n, cfg))(
        coords, values, nv)
    assert int(jtg.graph_overflows(ref)) == 0
    port = ttg.build_tile_graph(torch.from_numpy(coords),
                                torch.from_numpy(values),
                                torch.from_numpy(nv), tcfg)
    assert int(ttg.graph_overflows(port)) == 0
    assert int(ttg.graph_spills(port)) == int(jtg.graph_spills(ref))
    for name in ("vox_tile", "vox_cell", "input_valid", "tile_spill",
                 "vox_spill", "feats0"):
        _eq(getattr(port, name), getattr(ref, name), name)
    assert len(port.levels) == len(ref.levels)
    for l, (pl, rl) in enumerate(zip(port.levels, ref.levels)):
        _eq(pl.keys, rl.keys, f"L{l} keys")
        _eq(pl.num, rl.num, f"L{l} num")
        _eq(pl.occ, rl.occ, f"L{l} occ")
        ok = np.asarray(rl.halo.ok)
        _eq(pl.halo.ok, ok, f"L{l} halo ok")
        _eq_where(pl.halo.idx, rl.halo.idx, ok, f"L{l} halo idx")
        # the port's per-row liveness, sampled at the reference's block
        # starts, is the reference's per-block liveness
        B, T = pl.keys.shape
        nb = np.asarray(rl.halo.blive).shape[1]
        _eq(pl.halo.blive.reshape(B, nb, T // nb)[..., 0].int(),
            rl.halo.blive, f"L{l} blive")
        rows = torch.arange(T)[None]
        _eq(pl.halo.blive, (rows < pl.num[:, None]).numpy(),
            f"L{l} blive prefix")
    kinds = set()
    for l, (pk, rk) in enumerate(zip(port.links, ref.links)):
        kinds.add(len(rk.children))
        for side in ("children", "parents"):
            for o, (ps, rs) in enumerate(zip(getattr(pk, side),
                                             getattr(rk, side))):
                ok = _full_ok(rs)
                _eq(ps.ok, ok, f"link {l} {side}[{o}] ok")
                _eq_where(ps.idx, rs.idx, ok, f"link {l} {side}[{o}] idx")
    assert kinds == ({1, 8} if cfg.tile_sizes else {8})


def test_tile_capacity_matches_reference():
    """Static capacities, quirks included, at config 3's full shape."""
    kw = dict(
        num_class=5, uresnet_filters=16,
        uresnet_num_strides=5, spatial_size=512, data_dim=3, reps=2,
        max_voxels=131072, capacity_factor=0.5, min_level_capacity=2048,
        tile_size=4, tile_occupancy=4.5, tile_sizes=(4, 2, 2, 2, 2),
        compute_dtype="bfloat16")
    cfg, tcfg = URESNetConfig(**kw), TConfig(**kw)
    for l in range(5):
        assert ttg.tile_size_at(tcfg, l) == jtg.tile_size_at(cfg, l)
        assert ttg.tile_capacity_at(tcfg, l) == jtg.tile_capacity_at(cfg, l)
    assert [ttg.tile_capacity_at(tcfg, l) for l in range(5)] == [
        29184, 29184, 14592, 7424, 3840]
